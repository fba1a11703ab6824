// PW advection, v2 `dataflow` and v3 `wide`, for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/advection/advection.py `advect_dataflow` ->
// `_kernel_dataflow` (the Pallas TPU kernel, :272), and `advect_wide` (:367),
// which runs the same kernel under a layout contract.
//
// What it computes: the same values as advect_blocked.cu, bitwise: the PW
// sources of u, v, w, or with `fuse` the advanced fields
// cen + dt * (interior ? src : 0). Each field has a 3-slot ring of (S, Z)
// slices in dynamic shared memory, S = TY + 2 rows clipped flush into the
// domain: 9 * S * Z * 4 bytes. Step i loads slice i into slot i % 3 and emits
// x = i - 1 from slots ((i+1)%3, (i+2)%3, i%3) = (x-1, x, x+1), as in the
// Pallas kernel, so every slice is read once per pass over it.
//
// The Pallas grid walks all of x in order on one core; here blocks run
// concurrently, so x is cut into chunks of L slices and each block owns one
// (x-chunk, y-tile) pair. It streams its chunk's slices plus one halo slice
// on each side (L + 2 loads for L outputs) and writes each owned row of each
// of its slices exactly once. x = 0 and x = X-1 are not interior: they get
// cen (fuse) or 0. The ring is zero-filled first; a slot that is never loaded
// (x = -1, x = X) is read only by those boundary slices, which the select
// walls off.
//
// VEC = 4 is v3 `wide`: 16-byte (float4) loads and stores in place of 4-byte
// ones, the card's counterpart of the paper's 64 -> 256-bit port widening.
// It needs Z % 4 == 0 and 16-byte-aligned fields, which the wrapper checks.
//
// Launch at (1024, 1024, 64) with TY = 64 and L = 32: 16 y-tiles x 32
// x-chunks = 512 blocks of 152,064 B, one per SM at a time on 132 SMs; each
// slice is read (L + 2) / L = 1.0625 times.
//
// Bound on one H100 SXM: memory. The function reads the three fields and
// writes three: 6*X*Y*Z*4 bytes, 1.61 GB at (1024, 1024, 64), 0.48 ms at
// 3.35 TB/s; its arithmetic (63 ops per interior cell, plus 6 per cell with
// `fuse`) takes 0.06-0.07 ms at 67 TFLOP/s. Known limits, left for later
// work: loads are synchronous (no cp.async/TMA double buffering), two
// barriers per slice, and one block per SM.
#include <cuda_runtime.h>
#include <stddef.h>

#include "pw_source.cuh"

namespace {

constexpr int kThreads = 512;

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static void store(float* p, const float (&a)[1]) { *p = a[0]; }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static void store(float* p, const float (&a)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  }
};

template <int VEC>
__global__ void __launch_bounds__(kThreads) advect_dataflow_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ w, float* __restrict__ ou,
    float* __restrict__ ov, float* __restrict__ ow,
    const float* __restrict__ params, int X, int Y, int Z, int TY, int S,
    int L, int fuse, float dt) {
  using VT = typename Vec<VEC>::T;
  extern __shared__ __align__(16) float smem[];
  const int x0 = blockIdx.x * L;
  const int x1 = min(x0 + L, X);
  const int t = blockIdx.y;
  const int slab_lo = min(max(t * TY - 1, 0), Y - S);
  const int own_lo = t * TY;
  const int own_rows = min(TY, Y - own_lo);
  const int own_r0 = own_lo - slab_lo;
  const size_t slice = (size_t)Y * Z;
  const int plane = S * Z;
  const float* in[3] = {u, v, w};
  float* out[3] = {ou, ov, ow};
  const float tcx = params[0];
  const float tcy = params[1];
  const float* tzc1 = params + 2;
  const float* tzc2 = params + 2 + Z;

  for (int idx = threadIdx.x; idx < 9 * plane; idx += kThreads)
    smem[idx] = 0.0f;
  __syncthreads();

  for (int i = x0 - 1; i <= x1; ++i) {
    const int s0 = (i + 3) % 3;  // i >= -1
    if (i >= 0 && i <= X - 1) {
      const size_t src_off = (size_t)i * slice + (size_t)slab_lo * Z;
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        VT* dst = reinterpret_cast<VT*>(smem + (size_t)(f * 3 + s0) * plane);
        const VT* src = reinterpret_cast<const VT*>(in[f] + src_off);
        for (int k = threadIdx.x; k < plane / VEC; k += kThreads)
          dst[k] = src[k];
      }
    }
    __syncthreads();
    const int x = i - 1;
    if (x >= x0) {
      const int sm = (i + 4) % 3, sc = (i + 5) % 3;  // (i+1)%3, (i+2)%3
      RungSlices sl;
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        sl.s[f][0] = smem + (size_t)(f * 3 + sm) * plane;
        sl.s[f][1] = smem + (size_t)(f * 3 + sc) * plane;
        sl.s[f][2] = smem + (size_t)(f * 3 + s0) * plane;
      }
      const bool x_ok = x >= 1 && x <= X - 2;
      const size_t dst_off = (size_t)x * slice + (size_t)own_lo * Z;
      for (int k = threadIdx.x; k < own_rows * Z / VEC; k += kThreads) {
        const int c0 = own_r0 * Z + k * VEC;  // a row holds whole vectors
        const int r = c0 / Z, z0 = c0 - r * Z;
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          float vals[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int z = z0 + e;
            vals[e] = rung_value(sl, f, c0 + e, Z,
                                 rung_interior(x_ok, r, z, S, Z), tcx, tcy,
                                 tzc1[z], tzc2[z], fuse != 0, dt);
          }
          Vec<VEC>::store(out[f] + dst_off + (size_t)k * VEC, vals);
        }
      }
    }
    __syncthreads();
  }
}

template <int VEC>
int launch(const float* u, const float* v, const float* w, float* ou,
           float* ov, float* ow, const float* params, int X, int Y, int Z,
           int TY, int S, int n_ty, int L, int fuse, float dt,
           size_t smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      advect_dataflow_kernel<VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((X + L - 1) / L, n_ty);
  advect_dataflow_kernel<VEC><<<grid, kThreads, smem_bytes, stream>>>(
      u, v, w, ou, ov, ow, params, X, Y, Z, TY, S, L, fuse, dt);
  return (int)cudaGetLastError();
}

}  // namespace

// u, v, w, ou, ov, ow: (X, Y, Z) f32, contiguous (16-byte aligned and
// Z % 4 == 0 when vec4). params: one row [tcx, tcy, tzc1(Z), tzc2(Z)].
// Geometry (TY, S, n_ty) and the x-chunk length L come from the wrapper;
// smem_bytes = 9 * S * Z * 4. Returns the cudaError_t of the attribute call
// or of the launch.
extern "C" int advect_dataflow_f32(const float* u, const float* v,
                                   const float* w, float* ou, float* ov,
                                   float* ow, const float* params, int X,
                                   int Y, int Z, int TY, int S, int n_ty,
                                   int L, int vec4, int fuse, float dt,
                                   size_t smem_bytes, void* stream) {
  auto s = (cudaStream_t)stream;
  if (vec4)
    return launch<4>(u, v, w, ou, ov, ow, params, X, Y, Z, TY, S, n_ty, L,
                     fuse, dt, smem_bytes, s);
  return launch<1>(u, v, w, ou, ov, ow, params, X, Y, Z, TY, S, n_ty, L, fuse,
                   dt, smem_bytes, s);
}
