// K6's f32 build: the entry points of the spec ring (stencil_fused.cuh)
// with the shipped functors (stencil_ops.cuh) on f32 fields and
// coefficients. Arguments: `K6_ENTRY_ARGS` in stencil_fused.cuh.
#include "stencil_fused.cuh"

extern "C" int stencil_fused_f32(K6_ENTRY_ARGS) {
  const Entry* e = find_shipped<float, false>(op, stages, T, C);
  return K6_LAUNCH(e);
}

extern "C" int stencil_fused_attrs(int op, int stages, int T, int C,
                                   int threads, size_t smem_bytes, int* out) {
  const Entry* e = find_shipped<float, false>(op, stages, T, C);
  return K6_ATTRS(e);
}
