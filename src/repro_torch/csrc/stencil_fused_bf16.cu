// K6's bf16 build with f32 coefficients: the entry points of
// stencil_fused.cu on bf16 fields, where a product with a coefficient is an
// f32 op and every other op of the ring rounds to bf16, and dt is the bf16
// value of the caller's dt. Arguments: the entry points' comment at the end
// of stencil_fused.cuh.
#include "stencil_fused.cuh"

extern "C" int stencil_fused_bf16(int op, int stages, const K6Call* call) {
  const Entry* e = find_shipped<__nv_bfloat16, false>(op, stages, call->T, call->C);
  return k6_launch(e, call);
}

extern "C" int stencil_fused_bf16_attrs(int op, int stages, int T, int C,
                                        int threads, size_t smem_bytes,
                                        int* out) {
  const Entry* e = find_shipped<__nv_bfloat16, false>(op, stages, T, C);
  return k6_attrs(e, threads, smem_bytes, out);
}
