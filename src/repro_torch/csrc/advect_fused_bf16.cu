// K1/K5's bf16 build with f32 coefficients (the reference's kernel tests):
// advect_fused.cu's entry points on bf16 fields, (B, X, Y, Z) contiguous,
// where dt is the bf16 value of the domain's dt. A product with a
// coefficient is an f32 op; every other op of the ring rounds to bf16.
#include "advect_fused.cuh"

extern "C" int advect_fused_bf16(const void* u, const void* v, const void* w,
                                 void* ou, void* ov, void* ow,
                                 const float* params, const float* xm,
                                 const float* ym, int B, int X, int Y, int Z,
                                 int T, int TY, int S, int n_ty, int CZ,
                                 int W, int n_cz, int CX, int n_cx, int C,
                                 int threads, int P, int p_stride,
                                 int xm_stride, int ym_stride, float dt,
                                 size_t smem_bytes, void* stream) {
  const Args a{u, v, w, ou, ov, ow, params, xm, ym, B, X, Y, Z, T, TY, S,
               n_ty, CZ, W, n_cz, CX, n_cx, threads, P, p_stride, xm_stride,
               ym_stride, dt, smem_bytes, (cudaStream_t)stream};
  return launch_build<__nv_bfloat16, false>(a, C);
}

extern "C" int advect_fused_bf16_attrs(int T, int C, int threads,
                                       size_t smem_bytes, int* out) {
  return attrs_build<__nv_bfloat16, false>(T, C, threads, smem_bytes, out);
}
