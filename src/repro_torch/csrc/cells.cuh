// What the stencil kernels (advect_fused.cuh, advect_blocked.cu,
// advect_dataflow.cu, finite_guard.cu) share of their storage types: a cell
// is a float (f32 fields) or an __nv_bfloat16 (bf16 fields), and every
// kernel computes in f32 registers, or in bf16 pairs (below).
//
// The rounding contract of bf16 fields is the reference's: JAX promotes a
// bf16 op's operands and rounds its result to bf16, so a bf16 op here is the
// f32 op, rounded to nearest even (`rnd<true>`). A product of a bf16 value
// and an f32 coefficient is an f32 op (`rnd<false>`, the identity). Loads
// widen a bf16 cell exactly; stores round (the values stored are already
// bf16 values, so the store is exact).
//
// `rnd` rounds by `__float2bfloat16_rn`, which the card runs as
// `F2F.BF16.F32` on its conversion unit, 16 a clock per SM: a ring with a
// round in every op queues on it. The kernels round by `rpk` instead, which
// gives the same value by another instruction: one `cvt.rn.bf16x2.f32` of
// the value and 0.0f (`F2FP.BF16.F32.PACK_AB`), whose 32-bit result holds
// the value's bf16 in its high half and zero in its low half, and so is
// that bf16 value as an f32, with no widening after it. The v1-v3 rungs
// (pw_source.cuh) compute two cells a 32-bit word where they can, each bf16
// op of both by one bf16x2 instruction (`b2_add`, `b2_sub`, `b2_mul`), and
// round by `rpk` elsewhere. `csrc/bf16_round.cu` measures these and the
// other routes, and checks each rounding route on all 2^32 f32 bit patterns
// and each bf16x2 op on all 2^32 pairs of bf16 operands.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

template <typename E>
struct CellOf;
template <>
struct CellOf<float> {
  static constexpr bool bf16 = false;
};
template <>
struct CellOf<__nv_bfloat16> {
  static constexpr bool bf16 = true;
};

// x rounded to bf16 (and widened back) where R, else x
template <bool R>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (R)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

__device__ __forceinline__ float ld_cell(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_cell(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ void st_cell(float* p, float x) { *p = x; }
__device__ __forceinline__ void st_cell(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// the two bf16 cells of a 32-bit word, widened (element 0 is the low half)
__device__ __forceinline__ float bf16_lo(unsigned word) {
  return __uint_as_float(word << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned word) {
  return __uint_as_float(word & 0xffff0000u);
}

// two floats rounded to bf16 as one 32-bit word, lo in the low half (exact
// where they are bf16 values already, as every value a kernel stores is)
__device__ __forceinline__ unsigned bf16_pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// x rounded to bf16 (and widened back) where R, else x: `rnd`'s value by
// one paired convert whose low lane is 0.0f, round to nearest even (NaN to
// NaN), off the conversion unit
template <bool R>
__device__ __forceinline__ float rpk(float x) {
  if constexpr (R)
    return __uint_as_float(bf16_pack(0.0f, x));
  else
    return x;
}

// ---------------------------------------------------------------------------
// bf16 pairs: two bf16 values a 32-bit word, the low half first
// ---------------------------------------------------------------------------
//
// One bf16x2 instruction computes both lanes' exact results, each rounded
// once to bf16, nearest even. Where the f32 op rounds first, the double
// rounding is innocuous for +, - and * of bf16 operands (f32's 24 bits are
// at least 2 * 8 + 2), so each lane equals `rpk<true>` of the f32 op: the
// reference's bf16 op. `csrc/bf16_round.cu` checks that on all 2^32 operand
// pairs, the sign of zero included and NaN as NaN. The `_rn` intrinsics
// (`add.rn.bf16x2`, `sub.rn.bf16x2`, `mul.rn.bf16x2` on sm_90) are never
// contracted into a fused multiply-add, whatever --fmad says.

__device__ __forceinline__ __nv_bfloat162 b2_of(unsigned word) {
  return *reinterpret_cast<const __nv_bfloat162*>(&word);
}

__device__ __forceinline__ unsigned word_of(__nv_bfloat162 h) {
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ unsigned b2_add(unsigned a, unsigned b) {
  return word_of(__hadd2_rn(b2_of(a), b2_of(b)));
}

__device__ __forceinline__ unsigned b2_sub(unsigned a, unsigned b) {
  return word_of(__hsub2_rn(b2_of(a), b2_of(b)));
}

__device__ __forceinline__ unsigned b2_mul(unsigned a, unsigned b) {
  return word_of(__hmul2_rn(b2_of(a), b2_of(b)));
}
