// Per-cell source functors of the spec ring kernel (stencil_fused.cu), one
// per shipped StencilSpec operator of src/repro_torch/stencil/spec.py.
//
// Each functor mirrors its Python callback term by term, operand order
// included: `_pw_flux_source` (PwFluxOp<3> for the PW spec, PwFluxOp<4> for
// the tracer, which advects a fourth field q by u, v, w) and `_diff_source`
// (DiffusionOp). Built with --fmad=false, every product and sum rounds on
// its own, as PyTorch's elementwise ops round them in the plain version, so
// the kernel equals the plain version bitwise. A spec with any other source
// callback has no functor here and the wrapper refuses it on the card.
//
// The callbacks' accessor `sh(f, dx, dy, dz)` is `at<F, DX, DY, DZ>(cell)`,
// its offsets compile-time: dx = +-1 resolves to the thread's registers
// (the ring's x - 1 and x + 1), (0, 0, 0) to its centre register, and
// dy, dz = +-1 to the level's centre plane in shared memory. No shipped
// operator reads a diagonal neighbour across x, and `at` refuses one at
// compile time.
#pragma once

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
  struct Coef {
    float tcx, tcy;
  };
  __device__ __forceinline__ static Coef coef(const float* pv) {
    return {0.0f + pv[0], pv[1]};  // the callback's `0.0 + t1[0]`
  }
  template <int FI, class Cell>
  __device__ __forceinline__ static float source(const Cell& sh,
                                                 const Coef& k) {
    const float tzc1 = sh.zc[0];
    const float tzc2 = sh.zc[1];
    const float fx = k.tcx * (at<0, -1, 0, 0>(sh) * (at<FI, 0, 0, 0>(sh)
                                                     + at<FI, -1, 0, 0>(sh))
                              - at<0, 1, 0, 0>(sh) * (at<FI, 0, 0, 0>(sh)
                                                      + at<FI, 1, 0, 0>(sh)));
    const float fy = k.tcy * (at<1, 0, -1, 0>(sh) * (at<FI, 0, 0, 0>(sh)
                                                     + at<FI, 0, -1, 0>(sh))
                              - at<1, 0, 1, 0>(sh) * (at<FI, 0, 0, 0>(sh)
                                                      + at<FI, 0, 1, 0>(sh)));
    const float fz = tzc1 * at<2, 0, 0, -1>(sh) * (at<FI, 0, 0, 0>(sh)
                                                   + at<FI, 0, 0, -1>(sh))
                     - tzc2 * at<2, 0, 0, 1>(sh) * (at<FI, 0, 0, 0>(sh)
                                                    + at<FI, 0, 0, 1>(sh));
    return fx + fy + fz;
  }
};

// 7-point Laplacian with a per-level z metric, one field. `_diff_pack`'s
// vector is [kx, ky, kz(Z)]; kz at window cell z is zc[0].
struct DiffusionOp {
  static constexpr int kFields = 1;
  static constexpr int kVectors = 1;
  struct Coef {
    float kx, ky;
  };
  __device__ __forceinline__ static Coef coef(const float* pv) {
    return {pv[0], pv[1]};
  }
  template <int FI, class Cell>
  __device__ __forceinline__ static float source(const Cell& sh,
                                                 const Coef& k) {
    const float kz = sh.zc[0];
    const float c = at<0, 0, 0, 0>(sh);
    return k.kx * (at<0, -1, 0, 0>(sh) - 2.0f * c + at<0, 1, 0, 0>(sh))
           + k.ky * (at<0, 0, -1, 0>(sh) - 2.0f * c + at<0, 0, 1, 0>(sh))
           + kz * (at<0, 0, 0, -1>(sh) - 2.0f * c + at<0, 0, 0, 1>(sh));
  }
};
