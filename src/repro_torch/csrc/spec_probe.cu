// The probe of a generated K6 functor's nodes (repro_torch.stencil.
// spec_cuda.probe_cases): each case is a one-node functor that the tracer
// emitted from a one-line spec, exactly as it emits that node inside a
// spec's functor, applied elementwise to one or two tensors of f32 or bf16
// cells, so that `chip_smoke.py` phase 54 can hold each node's device code
// against torch's op on the card over every input it names.
//
// Built at first use by `_build.load_probe` (never with the library), with
// the generated header `k6_probe_cases.cuh`: each case's `GeneratedOp` in
// namespace k6p<case>, and K6_PROBE_CASES(X), one X(case) each.
//
// k6_probe(case, bf16, a, b, out, n, stream): out[i] = the case's node of
// (a[i], b[i]) (b is a where the case reads one field), rounded to the
// cells' storage as the ring rounds a source; bf16 cells where `bf16`
// (the functor's RF set), else f32. Returns a cudaError_t (-1: no such
// case).
#include <cuda_runtime.h>

#include "cells.cuh"
#include "spec_math.cuh"

// the one cell a probe's functor reads: field F at the centre
struct ProbeCell {
  float v[2];
  float zc[1];
};

template <int F, int DX, int DY, int DZ>
__device__ __forceinline__ float at(const ProbeCell& c) {
  return c.v[F];
}

#include "k6_probe_cases.cuh"

namespace {

template <class Op, typename E>
__global__ void probe_kernel(const E* a, const E* b, E* out, long long n) {
  constexpr bool RF = CellOf<E>::bf16;
  const typename Op::Coef k = Op::coef(nullptr, 0);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const ProbeCell c{{ld_cell(a + i), ld_cell(b + i)}, {0.0f}};
    st_cell(out + i, rpk<RF>(Op::template source<0, RF, false>(c, k)));
  }
}

template <class Op>
int probe_launch(int bf16, const void* a, const void* b, void* out,
                 long long n, void* stream) {
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 32 ? (want > 0 ? want : 1)
                                           : 132 * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    probe_kernel<Op, __nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(out), n);
  else
    probe_kernel<Op, float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int k6_probe(int c, int bf16, const void* a, const void* b,
                        void* out, long long n, void* stream) {
  switch (c) {
#define K6_PROBE_CASE(C) \
  case C:                \
    return probe_launch<k6p##C::GeneratedOp>(bf16, a, b, out, n, stream);
    K6_PROBE_CASES(K6_PROBE_CASE)
#undef K6_PROBE_CASE
  }
  return -1;
}
