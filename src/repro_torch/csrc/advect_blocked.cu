// PW advection, v1 `blocked`, for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/advection/advection.py `advect_blocked` ->
// `_kernel_blocked` (the Pallas TPU kernel, :214).
//
// What it computes: the PW sources of u, v, w, zero on every boundary cell,
// or with `fuse` the advanced fields cen + dt * (interior ? src : 0). One
// block per (x, y-tile) pair, x the fast grid dimension as in the Pallas grid
// (n_ty, X). Each block stages the x-1, x and x+1 slices (the index clipped
// at 0 and X-1) of its slab, S = TY + 2 rows clipped flush into the domain,
// of all three fields into dynamic shared memory: 9 * S * Z * 4 bytes. It
// then computes and writes its owned rows [t*TY, min((t+1)*TY, Y)) only, so
// no block writes a row another block owns.
//
// The triple read is this rung's point: every slice is fetched by the blocks
// of x-1, x and x+1, the paper's v1 re-reads. Nothing is reused across x on
// purpose. What the card's 50 MB L2 makes of the re-reads is what the rung
// measures.
//
// Bound on one H100 SXM: memory. The function reads the three fields and
// writes three: 6*X*Y*Z*4 bytes, 1.61 GB at (1024, 1024, 64), 0.48 ms at
// 3.35 TB/s. Its arithmetic, 63 ops per interior cell (plus 6 per cell with
// `fuse`), takes 0.06-0.07 ms at 67 TFLOP/s. The kernel asks the memory
// system for 3 * (TY + 2) / TY times the compulsory reads; loads are
// synchronous and, with one 152 KB slab per block at TY = 64, one block runs
// per SM, so a block's load, compute and store do not overlap.
#include <cuda_runtime.h>
#include <stddef.h>

#include "pw_source.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads) advect_blocked_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ w, float* __restrict__ ou,
    float* __restrict__ ov, float* __restrict__ ow,
    const float* __restrict__ params, int X, int Y, int Z, int TY, int S,
    int fuse, float dt) {
  extern __shared__ float smem[];
  const int x = blockIdx.x;
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

  RungSlices sl;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float* dst = smem + (size_t)(f * 3 + k) * plane;
      const int xs = min(max(x + k - 1, 0), X - 1);
      const float* src = in[f] + (size_t)xs * slice + (size_t)slab_lo * Z;
      for (int idx = threadIdx.x; idx < plane; idx += kThreads)
        dst[idx] = src[idx];
      sl.s[f][k] = dst;
    }
  }
  __syncthreads();

  const bool x_ok = x >= 1 && x <= X - 2;
  const size_t dst_off = (size_t)x * slice + (size_t)own_lo * Z;
  for (int idx = threadIdx.x; idx < own_rows * Z; idx += kThreads) {
    const int c = own_r0 * Z + idx;
    const int r = c / Z, z = c - r * Z;
    const bool interior = rung_interior(x_ok, r, z, S, Z);
#pragma unroll
    for (int f = 0; f < 3; ++f)
      out[f][dst_off + idx] = rung_value(sl, f, c, Z, interior, tcx, tcy,
                                         tzc1[z], tzc2[z], fuse != 0, dt);
  }
}

}  // namespace

// u, v, w, ou, ov, ow: (X, Y, Z) f32, contiguous. params: one row
// [tcx, tcy, tzc1(Z), tzc2(Z)]. Geometry (TY, S, n_ty) comes from the
// wrapper; smem_bytes = 9 * S * Z * 4. Returns the cudaError_t of the
// attribute call or of the launch.
extern "C" int advect_blocked_f32(const float* u, const float* v,
                                  const float* w, float* ou, float* ov,
                                  float* ow, const float* params, int X,
                                  int Y, int Z, int TY, int S, int n_ty,
                                  int fuse, float dt, size_t smem_bytes,
                                  void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      advect_blocked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(X, n_ty);
  advect_blocked_kernel<<<grid, kThreads, smem_bytes,
                          (cudaStream_t)stream>>>(u, v, w, ou, ov, ow, params,
                                                  X, Y, Z, TY, S, fuse, dt);
  return (int)cudaGetLastError();
}
