// K1/K5's f32 build: the entry points of the ring in advect_fused.cuh on
// f32 fields and coefficients.
//
// u, v, w, ou, ov, ow: (B, X, Y, Z) f32, contiguous.
// params: rows of [tcx, tcy, tzc1(Z), tzc2(Z)] f32, slot stride p_stride
// (0 = one row shared by every slot, else 2 + 2Z).
// xm: rows of X, ym: rows of Y, slot strides 0 (shared) or X / Y.
// The plan (TY, S, n_ty, CZ, W, n_cz, CX, n_cx, C cells per thread, threads,
// the planes' row pitch P, smem_bytes) comes from the wrapper's
// `fused_launch_plan`.
// Returns the cudaError_t of the attribute call or of the launch;
// cudaErrorInvalidValue for a (T, C) the library was not built for.
#include "advect_fused.cuh"

extern "C" int advect_fused_f32(const float* u, const float* v,
                                const float* w, float* ou, float* ov,
                                float* ow, const float* params,
                                const float* xm, const float* ym, int B,
                                int X, int Y, int Z, int T, int TY, int S,
                                int n_ty, int CZ, int W, int n_cz, int CX,
                                int n_cx, int C, int threads, int P,
                                int p_stride, int xm_stride, int ym_stride,
                                float dt, size_t smem_bytes, void* stream) {
  const Args a{u, v, w, ou, ov, ow, params, xm, ym, B, X, Y, Z, T, TY, S,
               n_ty, CZ, W, n_cz, CX, n_cx, threads, P, p_stride, xm_stride,
               ym_stride, dt, smem_bytes, (cudaStream_t)stream};
  return launch_build<float, false>(a, C);
}

// out[4]: registers, local bytes per thread, max threads per block and
// resident blocks per SM of the (T, C) build at (threads, smem).
extern "C" int advect_fused_attrs(int T, int C, int threads,
                                  size_t smem_bytes, int* out) {
  return attrs_build<float, false>(T, C, threads, smem_bytes, out);
}
