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
// 3.35 TB/s (half that for bf16 fields). The design reads 16 bytes per
// thread per load where the slice is a whole number of 16-byte words (four
// f32 or eight bf16 cells), neighbouring threads on neighbouring addresses,
// and does no other work per byte. A bf16 cell is tested on its f32
// widening, which is exact (the flags stay f32, as the reference's do).
// Built without fast math, which could compile isfinite away.
#include <cuda_runtime.h>
#include <stddef.h>

#include "cells.cuh"

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ int finite4(float4 a) {
  return isfinite(a.x) & isfinite(a.y) & isfinite(a.z) & isfinite(a.w);
}

// the eight bf16 cells of a 16-byte word, each widened to f32
__device__ __forceinline__ int finite8(uint4 a) {
  int ok = 1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned word = k == 0 ? a.x : k == 1 ? a.y : k == 2 ? a.z : a.w;
    ok &= isfinite(bf16_lo(word)) & isfinite(bf16_hi(word));
  }
  return ok;
}

// the bf16 build: 16-byte loads of eight cells where vec8
__global__ void __launch_bounds__(kThreads) finite_guard_bf16_kernel(
    const __nv_bfloat16* __restrict__ u, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ w, float* __restrict__ flags, int X,
    long long YZ, int vec8) {
  const int x = blockIdx.x;
  const int b = blockIdx.y;
  const size_t base = ((size_t)b * X + x) * (size_t)YZ;
  int ok = 1;
  if (vec8) {
    const uint4* u8 = reinterpret_cast<const uint4*>(u + base);
    const uint4* v8 = reinterpret_cast<const uint4*>(v + base);
    const uint4* w8 = reinterpret_cast<const uint4*>(w + base);
    for (long long i = threadIdx.x; i < YZ / 8; i += kThreads)
      ok &= finite8(u8[i]) & finite8(v8[i]) & finite8(w8[i]);
  } else {
    for (long long i = threadIdx.x; i < YZ; i += kThreads)
      ok &= isfinite(__bfloat162float(u[base + i])) &
            isfinite(__bfloat162float(v[base + i])) &
            isfinite(__bfloat162float(w[base + i]));
  }
  ok = __syncthreads_and(ok);
  if (threadIdx.x == 0) flags[(size_t)b * X + x] = ok ? 1.0f : 0.0f;
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

// finite_guard_f32 on bf16 fields: vec8 != 0 says that YZ is a multiple of
// 8 and the three fields are 16-byte aligned. flags stay f32.
extern "C" int finite_guard_bf16(const void* u, const void* v, const void* w,
                                 float* flags, int B, int X, long long YZ,
                                 int vec8, void* stream) {
  dim3 grid(X, B);
  finite_guard_bf16_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(u),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(w), flags, X, YZ, vec8);
  return (int)cudaGetLastError();
}
