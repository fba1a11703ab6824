// Per-cell source functors of the spec ring kernel (stencil_fused.cuh), one
// per shipped StencilSpec operator of src/repro_torch/stencil/spec.py; a
// user's radius-1 spec gets one of the same form, generated from its
// callback by `repro_torch.stencil.spec_cuda`.
//
// Each functor mirrors its Python callback term by term, operand order
// included: `_pw_flux_source` (PwFluxOp<3> for the PW spec, PwFluxOp<4> for
// the tracer, which advects a fourth field q by u, v, w) and `_diff_source`
// (DiffusionOp). Built with --fmad=false, every product and sum rounds on
// its own, as PyTorch's elementwise ops round them in the plain version, so
// the kernel equals the plain version bitwise. With bf16 fields an op
// rounds to bf16 where torch's promotion makes it a bf16 op (cells.cuh):
// `rnd<RF>` where its operands are field values or Python scalars (weak),
// `rnd<RC>` where a coefficient takes part (RC is set only when the
// coefficients are bf16 too: a bf16 field times an f32 coefficient is an
// f32 op). The coefficients reach the callback dimensioned (a 0-d one
// would not take part in torch's promotion), as the reference's do in JAX.
//
// A functor's interface: kFields, kVectors (the z-coefficient vectors it
// stages per window cell, `zc[p]`: element zoff(p) + z of parameter vector
// zvec(p) at cell z), Coef and coef(pv, p_len) (its scalar coefficients,
// element j of vector i at pv[i * p_len + j]), and source<FI, RF, RC>.
//
// The callbacks' accessor `sh(f, dx, dy, dz)` is `at<F, DX, DY, DZ>(cell)`,
// its offsets compile-time: dx = +-1 resolves to the thread's registers
// (the ring's x - 1 and x + 1), (0, 0, 0) to its centre register, and
// dy, dz = +-1 (the y-z diagonals too) to the level's centre plane in
// shared memory. The ring holds no x neighbour's plane, so a read at
// x +- 1 with a nonzero dy or dz has no operand here: `at` refuses one at
// compile time, and the tracer before any build.
#pragma once

#include "cells.cuh"

// One cell of one ring level, as the operators read it: field f's values
// at x - 1, x and x + 1 (copies of the thread's ring registers), each
// field's centre plane of the level, the cell's index in a plane and the
// planes' row pitch, and the cell's z coefficients (one per vector the
// operator stages).
template <int NF, int NP>
struct RingCell {
  float xm[NF], xc[NF], xp[NF];
  const float* pl[NF];
  int c, P;
  float zc[NP];
};

template <int F, int DX, int DY, int DZ, class Cell>
__device__ __forceinline__ float at(const Cell& sh) {
  static_assert(DX >= -1 && DX <= 1 && DY >= -1 && DY <= 1 && DZ >= -1 &&
                    DZ <= 1,
                "the CUDA ring is built for radius 1");
  static_assert(DX == 0 || (DY == 0 && DZ == 0),
                "an x neighbour comes from registers: no diagonal reads");
  if constexpr (DX == -1) {
    return sh.xm[F];
  } else if constexpr (DX == 1) {
    return sh.xp[F];
  } else if constexpr (DY == 0 && DZ == 0) {
    return sh.xc[F];
  } else {
    return sh.pl[F][sh.c + DY * sh.P + DZ];
  }
}

// PW flux-form source of field FI advected by fields 0/1/2 (u, v, w).
// `_pw_pack`'s two vectors are [tcx, tcy, tzc1(Z)] and [tcx, tcy,
// tzc2(Z)]; the callback's `t1[2:][1:-1]` at interior z (radius 1) is
// t1[2 + z], staged per window cell as zc[0] and zc[1].
template <int NOUT>
struct PwFluxOp {
  static constexpr int kFields = NOUT;
  static constexpr int kVectors = 2;
  __device__ static constexpr int zvec(int p) { return p; }
  __device__ static constexpr int zoff(int) { return 2; }
  struct Coef {
    float tcx, tcy;
  };
  __device__ __forceinline__ static Coef coef(const float* pv, int) {
    return {0.0f + pv[0], pv[1]};  // the callback's `0.0 + t1[0]` (exact)
  }
  template <int FI, bool RF, bool RC, class Cell>
  __device__ __forceinline__ static float source(const Cell& sh,
                                                 const Coef& k) {
    const float tzc1 = sh.zc[0];
    const float tzc2 = sh.zc[1];
    const float fc = at<FI, 0, 0, 0>(sh);
    const float fx = rnd<RC>(
        k.tcx * rnd<RF>(rnd<RF>(at<0, -1, 0, 0>(sh) *
                                rnd<RF>(fc + at<FI, -1, 0, 0>(sh)))
                        - rnd<RF>(at<0, 1, 0, 0>(sh) *
                                  rnd<RF>(fc + at<FI, 1, 0, 0>(sh)))));
    const float fy = rnd<RC>(
        k.tcy * rnd<RF>(rnd<RF>(at<1, 0, -1, 0>(sh) *
                                rnd<RF>(fc + at<FI, 0, -1, 0>(sh)))
                        - rnd<RF>(at<1, 0, 1, 0>(sh) *
                                  rnd<RF>(fc + at<FI, 0, 1, 0>(sh)))));
    const float fz = rnd<RC>(
        rnd<RC>(rnd<RC>(tzc1 * at<2, 0, 0, -1>(sh)) *
                rnd<RF>(fc + at<FI, 0, 0, -1>(sh)))
        - rnd<RC>(rnd<RC>(tzc2 * at<2, 0, 0, 1>(sh)) *
                  rnd<RF>(fc + at<FI, 0, 0, 1>(sh))));
    return rnd<RC>(rnd<RC>(fx + fy) + fz);
  }
};

// 7-point Laplacian with a per-level z metric, one field. `_diff_pack`'s
// vector is [kx, ky, kz(Z)]; kz at window cell z is zc[0].
struct DiffusionOp {
  static constexpr int kFields = 1;
  static constexpr int kVectors = 1;
  __device__ static constexpr int zvec(int) { return 0; }
  __device__ static constexpr int zoff(int) { return 2; }
  struct Coef {
    float kx, ky;
  };
  __device__ __forceinline__ static Coef coef(const float* pv, int) {
    return {pv[0], pv[1]};
  }
  template <int FI, bool RF, bool RC, class Cell>
  __device__ __forceinline__ static float source(const Cell& sh,
                                                 const Coef& k) {
    const float kz = sh.zc[0];
    const float c = at<0, 0, 0, 0>(sh);
    return rnd<RC>(
        rnd<RC>(rnd<RC>(k.kx * rnd<RF>(rnd<RF>(at<0, -1, 0, 0>(sh)
                                               - rnd<RF>(2.0f * c))
                                       + at<0, 1, 0, 0>(sh)))
                + rnd<RC>(k.ky * rnd<RF>(rnd<RF>(at<0, 0, -1, 0>(sh)
                                                 - rnd<RF>(2.0f * c))
                                         + at<0, 0, 1, 0>(sh))))
        + rnd<RC>(kz * rnd<RF>(rnd<RF>(at<0, 0, 0, -1>(sh)
                                       - rnd<RF>(2.0f * c))
                               + at<0, 0, 0, 1>(sh))));
  }
};
