// Per-x-slice finite guard for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/advection/advection.py `finite_guard` ->
// `_kernel_finite_guard` (the Pallas TPU kernel).
//
// What it computes: flags[b, x] = 1.0f iff the (Y, Z) slices x of u, v and
// w in slot b are all finite, else 0.0f. One block per (x, slot) reduces its
// three slices with isfinite and a block-wide AND. It stays a separate
// launch after the fused kernel, so the fused outputs are the same bits
// whether or not the caller asked for the guard.
//
// Bound on one H100 SXM: memory. It reads the three fields once and writes
// X flag words: 3*X*Y*Z*4 bytes, 805 MB at (1024, 1024, 64), 0.24 ms at
// 3.35 TB/s. The design reads 16 bytes per thread per load where the slice
// is a multiple of four floats, neighbouring threads on neighbouring
// addresses, and does no other work per byte. Built without fast math,
// which could compile isfinite away.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ int finite4(float4 a) {
  return isfinite(a.x) & isfinite(a.y) & isfinite(a.z) & isfinite(a.w);
}

__global__ void __launch_bounds__(kThreads) finite_guard_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ w, float* __restrict__ flags, int X,
    long long YZ, int vec4) {
  const int x = blockIdx.x;
  const int b = blockIdx.y;
  const size_t base = ((size_t)b * X + x) * (size_t)YZ;
  int ok = 1;
  if (vec4) {
    const float4* u4 = reinterpret_cast<const float4*>(u + base);
    const float4* v4 = reinterpret_cast<const float4*>(v + base);
    const float4* w4 = reinterpret_cast<const float4*>(w + base);
    for (long long i = threadIdx.x; i < YZ / 4; i += kThreads)
      ok &= finite4(u4[i]) & finite4(v4[i]) & finite4(w4[i]);
  } else {
    for (long long i = threadIdx.x; i < YZ; i += kThreads)
      ok &= isfinite(u[base + i]) & isfinite(v[base + i]) &
            isfinite(w[base + i]);
  }
  ok = __syncthreads_and(ok);
  if (threadIdx.x == 0) flags[(size_t)b * X + x] = ok ? 1.0f : 0.0f;
}

}  // namespace

// u, v, w: (B, X, Y, Z) f32, contiguous; flags: (B, X) f32. vec4 != 0 says
// that YZ is a multiple of 4 and the three fields are 16-byte aligned.
// Returns the cudaError_t of the launch.
extern "C" int finite_guard_f32(const float* u, const float* v,
                                const float* w, float* flags, int B, int X,
                                long long YZ, int vec4, void* stream) {
  dim3 grid(X, B);
  finite_guard_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      u, v, w, flags, X, YZ, vec4);
  return (int)cudaGetLastError();
}
