// K6's f32 build: the entry points of the spec ring (stencil_fused.cuh)
// with the shipped functors (stencil_ops.cuh) on f32 fields and
// coefficients. Arguments: the entry points' comment at the end
// of stencil_fused.cuh.
#include "stencil_fused.cuh"

extern "C" int stencil_fused_f32(int op, int stages, const K6Call* call) {
  const Entry* e = find_shipped<float, false>(op, stages, call->T, call->C);
  return k6_launch(e, call);
}

extern "C" int stencil_fused_attrs(int op, int stages, int T, int C,
                                   int threads, size_t smem_bytes, int* out) {
  const Entry* e = find_shipped<float, false>(op, stages, T, C);
  return k6_attrs(e, threads, smem_bytes, out);
}
