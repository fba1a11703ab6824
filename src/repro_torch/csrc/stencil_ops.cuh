// Per-cell source functors of the spec ring kernel (stencil_fused.cuh), one
// per shipped StencilSpec operator of src/repro_torch/stencil/spec.py; a
// user's spec gets one of the same form, generated from its callback by
// `repro_torch.stencil.spec_cuda`.
//
// Each functor mirrors its Python callback term by term, operand order
// included: `_pw_flux_source` (PwFluxOp<3> for the PW spec, PwFluxOp<4> for
// the tracer, which advects a fourth field q by u, v, w) and `_diff_source`
// (DiffusionOp). Built with --fmad=false, every product and sum rounds on
// its own, as PyTorch's elementwise ops round them in the plain version, so
// the kernel equals the plain version bitwise. With bf16 fields an op
// rounds to bf16 where torch's promotion makes it a bf16 op (cells.cuh's
// `rpk`): `rpk<RF>` where its operands are field values or Python scalars
// (weak), `rpk<RC>` where a coefficient takes part (RC is set only when the
// coefficients are bf16 too: a bf16 field times an f32 coefficient is an
// f32 op). An op exact in bf16 by construction takes no round: 2 * c of a
// bf16 value c is one (or Inf in f32 too). The coefficients reach the
// callback dimensioned (a 0-d one would not take part in torch's
// promotion), as the reference's do in JAX.
//
// A functor's interface: kFields, kVectors (the z-coefficient vectors it
// stages per window cell, `zc[p]`: element zoff(p) + z of parameter vector
// zvec(p) at cell z), Coef and coef(pv, p_len) (its scalar coefficients,
// element j of vector i at pv[i * p_len + j]), source<FI, RF, RC>, and the
// ring's shape: kRadius (R, the reach of its reads on every axis),
// kPlaneLo / kPlaneHi (the x offsets of its reads off the centre row, 0 / 0
// where it reads none at an x neighbour) and kHead (floats the ring lays
// before its shared memory so that a read at dy = -R, dz < 0 of the first
// row stays inside it; 0 wherever z coefficients lie there).
//
// The callbacks' accessor `sh(f, dx, dy, dz)` is `at<F, DX, DY, DZ>(cell)`,
// its offsets compile-time: (dx, 0, 0) resolves to the thread's registers
// (the ring keeps each level's slices x - R .. x + R there), and a read
// with a nonzero dy or dz to the shared plane of slice x + dx of the level,
// y-z diagonals and x-diagonals alike.
#pragma once

#include "cells.cuh"

// One cell of one ring level, as the operators read it: field f's values
// at x + d, d = -R..R, as xv[d + R][f] (copies of the thread's ring
// registers), the planes of slices x + d, d = XLO..XLO + NX - 1, as
// pl[d - XLO][f], the cell's index in a plane and the planes' row pitch,
// and the cell's z coefficients (one per vector the operator stages).
template <int NF, int NP, int R, int NX, int XLO>
struct RingCell {
  static constexpr int kRadius = R;
  static constexpr int kPlaneLo = XLO;
  static constexpr int kPlanes = NX;
  float xv[2 * R + 1][NF];
  const float* pl[NX][NF];
  int c, P;
  float zc[NP];
};

template <int F, int DX, int DY, int DZ, class Cell>
__device__ __forceinline__ float at(const Cell& sh) {
  constexpr int R = Cell::kRadius;
  static_assert(DX >= -R && DX <= R && DY >= -R && DY <= R && DZ >= -R &&
                    DZ <= R,
                "a read beyond the functor's radius");
  if constexpr (DY == 0 && DZ == 0) {
    return sh.xv[DX + R][F];
  } else {
    static_assert(DX >= Cell::kPlaneLo &&
                      DX < Cell::kPlaneLo + Cell::kPlanes,
                  "an off-row read at an x offset the ring keeps no plane of");
    return sh.pl[DX - Cell::kPlaneLo][F][sh.c + DY * sh.P + DZ];
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
  static constexpr int kRadius = 1, kPlaneLo = 0, kPlaneHi = 0, kHead = 0;
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
    const float fx = rpk<RC>(
        k.tcx * rpk<RF>(rpk<RF>(at<0, -1, 0, 0>(sh) *
                                rpk<RF>(fc + at<FI, -1, 0, 0>(sh)))
                        - rpk<RF>(at<0, 1, 0, 0>(sh) *
                                  rpk<RF>(fc + at<FI, 1, 0, 0>(sh)))));
    const float fy = rpk<RC>(
        k.tcy * rpk<RF>(rpk<RF>(at<1, 0, -1, 0>(sh) *
                                rpk<RF>(fc + at<FI, 0, -1, 0>(sh)))
                        - rpk<RF>(at<1, 0, 1, 0>(sh) *
                                  rpk<RF>(fc + at<FI, 0, 1, 0>(sh)))));
    const float fz = rpk<RC>(
        rpk<RC>(rpk<RC>(tzc1 * at<2, 0, 0, -1>(sh)) *
                rpk<RF>(fc + at<FI, 0, 0, -1>(sh)))
        - rpk<RC>(rpk<RC>(tzc2 * at<2, 0, 0, 1>(sh)) *
                  rpk<RF>(fc + at<FI, 0, 0, 1>(sh))));
    return rpk<RC>(rpk<RC>(fx + fy) + fz);
  }
};

// 7-point Laplacian with a per-level z metric, one field. `_diff_pack`'s
// vector is [kx, ky, kz(Z)]; kz at window cell z is zc[0].
struct DiffusionOp {
  static constexpr int kFields = 1;
  static constexpr int kVectors = 1;
  static constexpr int kRadius = 1, kPlaneLo = 0, kPlaneHi = 0, kHead = 0;
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
    const float c2 = 2.0f * at<0, 0, 0, 0>(sh);
    return rpk<RC>(
        rpk<RC>(rpk<RC>(k.kx * rpk<RF>(rpk<RF>(at<0, -1, 0, 0>(sh) - c2)
                                       + at<0, 1, 0, 0>(sh)))
                + rpk<RC>(k.ky * rpk<RF>(rpk<RF>(at<0, 0, -1, 0>(sh) - c2)
                                         + at<0, 0, 1, 0>(sh))))
        + rpk<RC>(kz * rpk<RF>(rpk<RF>(at<0, 0, 0, -1>(sh) - c2)
                               + at<0, 0, 0, 1>(sh))));
  }
};
