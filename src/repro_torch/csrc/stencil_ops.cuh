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
#pragma once

#include <stddef.h>

// The accessor `sh(f, dx, dy, dz)` of the callbacks, over one ring level in
// shared memory: field f's slice x + dx at slab cell c + dy*Z + dz. The slot
// offsets are 32-bit float offsets into the ring, set once per level, so a
// neighbour read costs one integer add and a shared load. Only interior
// cells read through it, so every neighbour lies inside the slab.
template <int R, int NF>
struct RingAccessor {
  const float* ring;          // the block's shared memory
  int slot[NF][2 * R + 1];    // offset of field f's plane holding slice x+dx
  int Z;
  int c;                      // slab cell r*Z + z
  __device__ __forceinline__ float operator()(int f, int dx, int dy,
                                              int dz) const {
    return ring[slot[f][dx + R] + c + dy * Z + dz];
  }
};

// PW flux-form source of field fi advected by fields 0/1/2 (u, v, w).
// pv holds `_pw_pack`'s two vectors back to back, each p_len = Z + 2 long:
// [tcx, tcy, tzc1(Z)] and [tcx, tcy, tzc2(Z)]; the callback's
// `t1[2:][1:-1]` at interior z (radius 1) is t1[2 + z].
template <int NOUT>
struct PwFluxOp {
  static constexpr int kFields = NOUT;
  template <class Sh>
  __device__ __forceinline__ static float source(const Sh& sh, int fi,
                                                 const float* pv, int p_len,
                                                 int z) {
    const float* t1 = pv;
    const float* t2 = pv + p_len;
    const float tcx = 0.0f + t1[0];  // the callback's `0.0 + t1[0]`
    const float tcy = t1[1];
    const float tzc1 = t1[2 + z];
    const float tzc2 = t2[2 + z];
    const float fx = tcx * (sh(0, -1, 0, 0) * (sh(fi, 0, 0, 0)
                                               + sh(fi, -1, 0, 0))
                            - sh(0, 1, 0, 0) * (sh(fi, 0, 0, 0)
                                                + sh(fi, 1, 0, 0)));
    const float fy = tcy * (sh(1, 0, -1, 0) * (sh(fi, 0, 0, 0)
                                               + sh(fi, 0, -1, 0))
                            - sh(1, 0, 1, 0) * (sh(fi, 0, 0, 0)
                                                + sh(fi, 0, 1, 0)));
    const float fz = tzc1 * sh(2, 0, 0, -1) * (sh(fi, 0, 0, 0)
                                               + sh(fi, 0, 0, -1))
                     - tzc2 * sh(2, 0, 0, 1) * (sh(fi, 0, 0, 0)
                                                + sh(fi, 0, 0, 1));
    return fx + fy + fz;
  }
};

// 7-point Laplacian with a per-level z metric, one field. pv is
// `_diff_pack`'s vector [kx, ky, kz(Z)].
struct DiffusionOp {
  static constexpr int kFields = 1;
  template <class Sh>
  __device__ __forceinline__ static float source(const Sh& sh, int,
                                                 const float* pv, int,
                                                 int z) {
    const float kx = pv[0];
    const float ky = pv[1];
    const float kz = pv[2 + z];
    const float c = sh(0, 0, 0, 0);
    return kx * (sh(0, -1, 0, 0) - 2.0f * c + sh(0, 1, 0, 0))
           + ky * (sh(0, 0, -1, 0) - 2.0f * c + sh(0, 0, 1, 0))
           + kz * (sh(0, 0, 0, -1) - 2.0f * c + sh(0, 0, 0, 1));
  }
};
