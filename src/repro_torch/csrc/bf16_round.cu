// The routes by which a bf16 ring can round an f32 result to bf16, each
// alone: an exhaustive check against `__float2bfloat16_rn` and a throughput
// kernel per route. K1/K5 (advect_fused.cuh), K6 (stencil_fused.cuh) and
// the v1-v3 rungs' one-cell build (pw_source.cuh) round by route 6,
// cells.cuh's `rpk<true>`, which the route below calls; the others are
// measured here and used nowhere.
//
// And the bf16x2 ops the rungs' pair build computes with (cells.cuh's
// `b2_add`, `b2_sub`, `b2_mul`, `op` of the pair entry points 0, 1, 2):
// each checked on all 2^32 pairs of bf16 operands against `rpk<true>` of
// the f32 op, the sign of zero included and NaN as NaN, and timed alone.
//
// Routes (`route` of the entry points):
//   0 cvt         `__float2bfloat16_rn`, widened: one `F2F.BF16.F32` a
//                 value, on the conversion unit (`rnd<true>`)
//   1 pair        `__floats2bfloat162_rn` of two values (one
//                 `cvt.rn.bf16x2.f32`) and the two widenings (`bf16_lo`,
//                 `bf16_hi`, integer ops)
//   2 split_round the FP32 split h = c - (c - x), c = x * 65537 (`__fmul_rn`
//                 / `__fsub_rn`, never contracted), exact for every normal
//                 |x| < 2^111; a per-round unsigned compare on the bits sends
//                 zero, subnormals, |x| >= 2^111, Inf and NaN to the convert
//   3 split_cell  the split on every value of a cell, with one unsigned max a
//                 value keeping the worst exponent seen; a cell that held a
//                 value out of the split's range (zero included) is
//                 recomputed by converts
//   4 int_rne     round to nearest even on the bits: add 0x7fff plus the
//                 kept lowest bit, mask; a NaN kept a quiet NaN
//   5 mix         pairs on the convert unit and split_cell on the FP32 pipe,
//                 half the values each
//   6 pack_hi     one value a `cvt.rn.bf16x2.f32` whose low lane is zero:
//                 the word is the value's bf16 in its high half, which is
//                 that value as an f32, so no widening follows (`rpk<true>`)
//
// The throughput kernel: each thread runs NCH independent chains, each step
// v = round(v + d) (one FADD and one round), `iters` steps; thread 0 of
// block 0 reads the SM clock and the global timer at its start and end, so
// that the caller turns the launch's time into rounds a clock per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cells.cuh"

namespace {

constexpr int NCH = 8;   // chains a thread (pairs: 4 pairs)

__device__ __forceinline__ float r_cvt(float x) { return rnd<true>(x); }

__device__ __forceinline__ float split(float x) {
  const float c = __fmul_rn(x, 65537.0f);
  return __fsub_rn(c, __fsub_rn(c, x));
}

// (bits << 1) - 2^24: biased exponent e - 1 in the top 8 bits, so that
// normal |x| < 2^111 (e in 1..237) lies below kSplitTop and zero,
// subnormals (wrapping) and |x| >= 2^111, Inf and NaN do not
__device__ __forceinline__ unsigned split_key(float x) {
  const unsigned u = __float_as_uint(x);
  return u + u - 0x01000000u;
}
constexpr unsigned kSplitTop = 237u << 24;

__device__ __forceinline__ float r_split_round(float x) {
  return split_key(x) < kSplitTop ? split(x) : r_cvt(x);
}

__device__ __forceinline__ void r_pair(float& a, float& b) {
  const unsigned w = bf16_pack(a, b);
  a = bf16_lo(w);
  b = bf16_hi(w);
}

__device__ __forceinline__ float r_pack_hi(float x) { return rpk<true>(x); }

__device__ __forceinline__ float r_int(float x) {
  const unsigned u = __float_as_uint(x);
  const unsigned r = (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
  return __uint_as_float(x != x ? (u | 0x00400000u) & 0xffff0000u : r);
}

// one "cell" of n values by the split, flagged and recomputed by converts
template <int N>
__device__ __forceinline__ void r_split_cell(float (&v)[N]) {
  float h[N];
  unsigned worst = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    h[i] = split(v[i]);
    worst = max(worst, split_key(v[i]));
  }
  if (worst >= kSplitTop) {
#pragma unroll
    for (int i = 0; i < N; ++i) h[i] = r_cvt(v[i]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = h[i];
}

// the NCH values of one step rounded by route R
template <int R>
__device__ __forceinline__ void round_all(float (&v)[NCH]) {
  if constexpr (R == 0 || R == 2 || R == 4 || R == 6) {
#pragma unroll
    for (int i = 0; i < NCH; ++i)
      v[i] = R == 0   ? r_cvt(v[i])
             : R == 2 ? r_split_round(v[i])
             : R == 4 ? r_int(v[i])
                      : r_pack_hi(v[i]);
  } else if constexpr (R == 1) {
#pragma unroll
    for (int i = 0; i < NCH; i += 2) r_pair(v[i], v[i + 1]);
  } else if constexpr (R == 3) {
    r_split_cell(v);
  } else {
    float s[NCH / 2];
#pragma unroll
    for (int i = 0; i < NCH / 2; i += 2) r_pair(v[i], v[i + 1]);
#pragma unroll
    for (int i = 0; i < NCH / 2; ++i) s[i] = v[NCH / 2 + i];
    r_split_cell(s);
#pragma unroll
    for (int i = 0; i < NCH / 2; ++i) v[NCH / 2 + i] = s[i];
  }
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <int R>
__global__ void rate_kernel(int iters, float d, float* __restrict__ sink,
                            unsigned long long* __restrict__ clk) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const bool timer = g == 0;
  unsigned long long c0 = 0, t0 = 0;
  if (timer) {
    c0 = clock64();
    t0 = global_ns();
  }
  float v[NCH];
#pragma unroll
  for (int i = 0; i < NCH; ++i)
    v[i] = 1.0f + (float)((g * NCH + i) & 1023) * 0x1p-10f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < NCH; ++i) v[i] = v[i] + d;
    round_all<R>(v);
  }
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < NCH; ++i) s += v[i];
  sink[g] = s;
  if (timer) {
    clk[0] = clock64() - c0;
    clk[1] = global_ns() - t0;
  }
}

// x's route-R value and whether it equals the convert's: the same bits,
// or NaN where the convert gives NaN
__device__ __forceinline__ bool agrees(float got, float x) {
  const float want = r_cvt(x);
  return want != want ? got != got
                      : __float_as_uint(got) == __float_as_uint(want);
}

// every 32-bit pattern once: pattern p and p | 2^31 (its negative) in each
// step, p in [0, 2^31); a pair route takes them as its two lanes, a cell
// route as a cell of two values (the mix checks both of its routes)
template <int R>
__global__ void check_kernel(unsigned long long* __restrict__ count) {
  unsigned long long n = 0;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned p = blockIdx.x * blockDim.x + threadIdx.x; p < 0x80000000u;
       p += stride) {
    const float x = __uint_as_float(p);
    const float y = __uint_as_float(p | 0x80000000u);
    float gx, gy;
    bool extra = true;   // the mix's split_cell lanes
    if constexpr (R == 0) {
      gx = r_cvt(x);
      gy = r_cvt(y);
    } else if constexpr (R == 1 || R == 5) {
      gx = x;
      gy = y;
      r_pair(gx, gy);
      if constexpr (R == 5) {
        float c[2] = {x, y};
        r_split_cell(c);
        extra = agrees(c[0], x) && agrees(c[1], y);
      }
    } else if constexpr (R == 2) {
      gx = r_split_round(x);
      gy = r_split_round(y);
    } else if constexpr (R == 3) {
      float c[2] = {x, y};
      r_split_cell(c);
      gx = c[0];
      gy = c[1];
    } else if constexpr (R == 4) {
      gx = r_int(x);
      gy = r_int(y);
    } else {
      gx = r_pack_hi(x);
      gy = r_pack_hi(y);
    }
    n += (agrees(gx, x) && extra) + (agrees(gy, y) && extra);
  }
  for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(0xffffffffu, n, o);
  if ((threadIdx.x & 31) == 0) atomicAdd(count, n);
}

// ---------------------------------------------------------------------------
// the bf16x2 ops
// ---------------------------------------------------------------------------

template <int OP>
__device__ __forceinline__ unsigned pair_op(unsigned a, unsigned b) {
  return OP == 0 ? b2_add(a, b) : OP == 1 ? b2_sub(a, b) : b2_mul(a, b);
}

// the reference's bf16 op: the f32 op of the widened operands, rounded
template <int OP>
__device__ __forceinline__ float f32_op(float a, float b) {
  return rpk<true>(OP == 0   ? __fadd_rn(a, b)
                   : OP == 1 ? __fsub_rn(a, b)
                             : __fmul_rn(a, b));
}

// lane `half` (a bf16 in the low 16 bits) equals the reference's op of the
// bf16 patterns a and b: the same bits, or NaN where it gives NaN
template <int OP>
__device__ __forceinline__ bool pair_agrees(unsigned half, unsigned a,
                                            unsigned b) {
  const float want = f32_op<OP>(__uint_as_float(a << 16),
                                __uint_as_float(b << 16));
  const float got = __uint_as_float(half << 16);
  return want != want ? got != got
                      : __float_as_uint(got) == __float_as_uint(want);
}

// every pair of bf16 patterns once: step p in [0, 2^31) puts a = p >> 15
// in both lanes and b = p & 0x7fff, b | 0x8000 (its negative) in the low
// and high lanes of one instruction
template <int OP>
__global__ void pair_check_kernel(unsigned long long* __restrict__ count) {
  unsigned long long n = 0;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned p = blockIdx.x * blockDim.x + threadIdx.x; p < 0x80000000u;
       p += stride) {
    const unsigned a = p >> 15, b = p & 0x7fffu, nb = b | 0x8000u;
    const unsigned got = pair_op<OP>(a | (a << 16), b | (nb << 16));
    n += pair_agrees<OP>(got & 0xffffu, a, b) +
         pair_agrees<OP>(got >> 16, a, nb);
  }
  for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(0xffffffffu, n, o);
  if ((threadIdx.x & 31) == 0) atomicAdd(count, n);
}

// NCH independent chains of words a thread, each step v = op(v, d): one
// instruction, two ops
template <int OP>
__global__ void pair_rate_kernel(int iters, float d, float* __restrict__ sink,
                                 unsigned long long* __restrict__ clk) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const bool timer = g == 0;
  unsigned long long c0 = 0, t0 = 0;
  if (timer) {
    c0 = clock64();
    t0 = global_ns();
  }
  const unsigned dd = bf16_pack(d, d);
  unsigned v[NCH];
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const float x = 1.0f + (float)((g * NCH + i) & 1023) * 0x1p-10f;
    v[i] = bf16_pack(x, x);
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < NCH; ++i) v[i] = pair_op<OP>(v[i], dd);
  }
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < NCH; ++i) s += bf16_lo(v[i]) + bf16_hi(v[i]);
  sink[g] = s;
  if (timer) {
    clk[0] = clock64() - c0;
    clk[1] = global_ns() - t0;
  }
}

using RateFn = void (*)(int, float, float*, unsigned long long*);
using CheckFn = void (*)(unsigned long long*);
constexpr int kRoutes = 7;
const RateFn kRate[kRoutes] = {rate_kernel<0>, rate_kernel<1>, rate_kernel<2>,
                               rate_kernel<3>, rate_kernel<4>, rate_kernel<5>,
                               rate_kernel<6>};
const CheckFn kCheck[kRoutes] = {check_kernel<0>, check_kernel<1>,
                                 check_kernel<2>, check_kernel<3>,
                                 check_kernel<4>, check_kernel<5>,
                                 check_kernel<6>};

constexpr int kPairOps = 3;
const RateFn kPairRate[kPairOps] = {pair_rate_kernel<0>, pair_rate_kernel<1>,
                                    pair_rate_kernel<2>};
const CheckFn kPairCheck[kPairOps] = {pair_check_kernel<0>,
                                      pair_check_kernel<1>,
                                      pair_check_kernel<2>};

}  // namespace

// Adds to *count (device, zeroed by the caller) the f32 bit patterns of all
// 2^32 that route `route` rounds as `__float2bfloat16_rn` does (NaN to NaN).
extern "C" int bf16_round_check(int route, unsigned long long* count,
                                int blocks, void* stream) {
  if (route < 0 || route >= kRoutes || blocks < 1)
    return (int)cudaErrorInvalidValue;
  kCheck[route]<<<blocks, 256, 0, (cudaStream_t)stream>>>(count);
  return (int)cudaGetLastError();
}

// blocks x threads threads, each NCH chains of `iters` steps of route
// `route`; sink: one float a thread; clk[2] (device): SM clocks and
// nanoseconds of thread 0's run.
extern "C" int bf16_round_rate(int route, int blocks, int threads, int iters,
                               float d, float* sink, unsigned long long* clk,
                               void* stream) {
  if (route < 0 || route >= kRoutes || blocks < 1 || threads < 32 ||
      threads > 1024)
    return (int)cudaErrorInvalidValue;
  kRate[route]<<<blocks, threads, 0, (cudaStream_t)stream>>>(iters, d, sink,
                                                             clk);
  return (int)cudaGetLastError();
}

// rounds of one step of each chain a thread
extern "C" int bf16_round_chains() { return NCH; }

// Adds to *count (device, zeroed by the caller) the pairs of bf16 operands
// of all 2^32 whose bf16x2 op `op` (0 add, 1 sub, 2 mul) equals `rpk<true>`
// of the f32 op (NaN as NaN).
extern "C" int bf16_pair_check(int op, unsigned long long* count, int blocks,
                               void* stream) {
  if (op < 0 || op >= kPairOps || blocks < 1)
    return (int)cudaErrorInvalidValue;
  kPairCheck[op]<<<blocks, 256, 0, (cudaStream_t)stream>>>(count);
  return (int)cudaGetLastError();
}

// blocks x threads threads, each NCH chains of `iters` bf16x2 ops `op` (two
// ops an instruction) by d; sink and clk as bf16_round_rate's.
extern "C" int bf16_pair_rate(int op, int blocks, int threads, int iters,
                              float d, float* sink, unsigned long long* clk,
                              void* stream) {
  if (op < 0 || op >= kPairOps || blocks < 1 || threads < 32 ||
      threads > 1024)
    return (int)cudaErrorInvalidValue;
  kPairRate[op]<<<blocks, threads, 0, (cudaStream_t)stream>>>(iters, d, sink,
                                                              clk);
  return (int)cudaGetLastError();
}
