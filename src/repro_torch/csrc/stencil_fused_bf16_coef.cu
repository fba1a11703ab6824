// K6's bf16 build with bf16 coefficients (vectors that hold bf16 values):
// the entry points of stencil_fused_bf16.cu, where every op of the ring
// rounds to bf16. Arguments: the entry points' comment at the end
// of stencil_fused.cuh.
#include "stencil_fused.cuh"

extern "C" int stencil_fused_bf16_coef(int op, int stages, const K6Call* call) {
  const Entry* e = find_shipped<__nv_bfloat16, true>(op, stages, call->T, call->C);
  return k6_launch(e, call);
}

extern "C" int stencil_fused_bf16_coef_attrs(int op, int stages, int T,
                                             int C, int threads,
                                             size_t smem_bytes, int* out) {
  const Entry* e = find_shipped<__nv_bfloat16, true>(op, stages, T, C);
  return k6_attrs(e, threads, smem_bytes, out);
}
