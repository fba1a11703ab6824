// K6 for one user-written spec: the spec ring (stencil_fused.cuh) with the
// functor `GeneratedOp` that `repro_torch.stencil.spec_cuda` generated from
// the spec's source callback, in one storage build and one integrator.
//
// Built at first use by `_build.load_generated`, apart from the library of
// shipped kernels, with the generated header `k6_generated_op.cuh` and the
// flags K6G_STAGES (1 euler, 2 rk2), K6G_BF16 and K6G_COEF_BF16 (the
// storage: f32, bf16 fields with f32 coefficients, or both bf16) and
// K6G_THREADS_C2 / K6G_THREADS_C4 (the launch bound of its 2- and 4-cell
// builds, 0 for none; the shipped builds' of its field count). Arguments:
// `K6_ENTRY_ARGS` in stencil_fused.cuh; `op` must be 0 and `stages`
// K6G_STAGES.
#include "stencil_fused.cuh"
#include "k6_generated_op.cuh"

#if !defined(K6G_STAGES) || !defined(K6G_BF16) || !defined(K6G_COEF_BF16) \
    || !defined(K6G_THREADS_C2) || !defined(K6G_THREADS_C4)
#error "a generated K6 build takes its flags from _build.load_generated"
#endif

namespace {

using GenE = std::conditional_t<K6G_BF16 != 0, __nv_bfloat16, float>;
constexpr bool kGenCoef = K6G_BF16 != 0 && K6G_COEF_BF16 != 0;

// the builds at S stages: only K6G_STAGES' are instantiated
template <int S>
constexpr Table gen_table() {
  if constexpr (S == K6G_STAGES)
    return table<GeneratedOp, S, K6G_THREADS_C2, K6G_THREADS_C4, GenE,
                 kGenCoef>(kLevels);
  else
    return Table{};
}

const Entry* find_generated(int op, int stages, int T, int C) {
  static const Table kTables[2] = {gen_table<1>(), gen_table<2>()};
  if (op != 0 || stages != K6G_STAGES) return nullptr;
  return pick(kTables, stages, T, C);
}

}  // namespace

extern "C" int k6_generated(K6_ENTRY_ARGS) {
  const Entry* e = find_generated(op, stages, T, C);
  return K6_LAUNCH(e);
}

extern "C" int k6_generated_attrs(int op, int stages, int T, int C,
                                  int threads, size_t smem_bytes, int* out) {
  const Entry* e = find_generated(op, stages, T, C);
  return K6_ATTRS(e);
}
