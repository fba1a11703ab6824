// PW advection, v1 `blocked`, for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/advection/advection.py `advect_blocked` ->
// `_kernel_blocked` (the Pallas TPU kernel, :214).
//
// What it computes: the PW sources of u, v, w, zero on every boundary cell,
// or with `fuse` the advanced fields cen + dt * (interior ? src : 0).
//
// What bounds it on one H100 SXM: memory. The function reads the three
// fields and writes three, 6 * X * Y * Z * 4 bytes: 1.61 GB and 0.4808 ms at
// 3.35 TB/s at (1024, 1024, 64). Its arithmetic, 63 ops per interior cell
// (plus 6 per cell with `fuse`), takes 0.06-0.07 ms at 67 TFLOP/s.
//
// The rung's data movement, which the design keeps: the triple read. For
// every output slice x, its block fetches the x-1, x and x+1 slices (the
// index clipped at 0 and X-1) of its slab, S = TY + 2 rows clipped flush
// into the domain, of all three fields from device memory into a stage of
// 9 * S * Z * 4 bytes of dynamic shared memory: nine slab copies an x,
// 3 * S / TY times the compulsory reads asked of the memory system. Nothing
// is reused across x inside a block, on purpose: every slice is fetched for
// x-1, x and x+1, the paper's v1 re-reads, and what the card's 50 MB L2
// makes of them is what the rung measures. Moves are 4-byte words a thread
// (cp.async.ca); no bulk (TMA) copy. A block computes and writes its owned
// rows [t*TY, min((t+1)*TY, Y)) only, so no block writes a row another block
// owns.
//
// What the design does about the bound: blocks that hide each other's
// loads. A block stages the nine slabs of its x with cp.async, waits for
// them, computes and stores. The plan (`rung_launch_plan` in
// kernels/advection/advection.py) takes the tallest y-tile whose stage lets
// four blocks share an SM and sizes the threads to it (4 cells a thread); at
// (1024, 1024, 64): TY = 16, 41,472 B, 256 threads, five blocks an SM, x the
// fast grid dimension, so the blocks at work are x-neighbours and their
// re-reads meet in L2. A block that walked a run of x and loaded x+1 into a
// second stage while it computed x, at two blocks an SM, took 1.04-1.05 ms
// of device time there against this design's 0.85-0.88 in one call
// (PERF.md) and is gone. Given a run of x (an explicit x chunk), a block
// walks it one x at a time.
//
// bf16 fields (E = __nv_bfloat16): the stage holds 2-byte cells as
// cp.async lands them (pairs of cells a 4-byte move), so its bytes halve,
// and the plan (`rung_launch_plan` at itemsize 2) takes the tile for that.
// The arithmetic rounds as pw_source.cuh says, with f32 or bf16
// coefficients (CB). Where Z is even and every field starts on a 4-byte
// boundary (the wrapper's choice, before the launch) a thread computes the
// two cells of a 32-bit word of the stage at once (VEC = 2), each bf16 op of
// both one bf16x2 instruction; elsewhere it computes one cell (VEC = 1),
// each bf16 op an f32 op rounded by `rpk`. Both still move 4-byte words.
#include <cuda_runtime.h>
#include <stddef.h>

#include "pw_source.cuh"

namespace {

constexpr int kMaxThreads = 512;

template <typename E, bool CB, int VEC>
__global__ void __launch_bounds__(kMaxThreads, 2) advect_blocked_kernel(
    const E* __restrict__ u, const E* __restrict__ v,
    const E* __restrict__ w, E* __restrict__ ou, E* __restrict__ ov,
    E* __restrict__ ow, const float* __restrict__ params, int X, int Y,
    int Z, int TY, int S, int L, int fuse, float dt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* smem = reinterpret_cast<E*>(smem_raw);
  const int x0 = blockIdx.x * L;
  const int x1 = min(x0 + L, X);
  const int t = blockIdx.y;
  const int slab_lo = min(max(t * TY - 1, 0), Y - S);
  const int own_lo = t * TY;
  const int own_r0 = own_lo - slab_lo;
  const int n_vec = min(TY, Y - own_lo) * Z / VEC;  // runs of VEC cells
  const size_t slice = (size_t)Y * Z;
  const int plane = S * Z;
  const E* in[3] = {u, v, w};
  E* const out[3] = {ou, ov, ow};
  const RungParams pr = rung_params<1>(params, Z);

  // the nine slabs of output slice x: plane (f * 3 + k) holds field f at
  // x + k - 1, clipped
  for (int x = x0; x < x1; ++x) {
    if (x > x0) __syncthreads();  // the slabs of x - 1 are read
#pragma unroll
    for (int f = 0; f < 3; ++f)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int xs = min(max(x + k - 1, 0), X - 1);
        cp_async_plane<E, VEC>(
            smem + (size_t)(f * 3 + k) * plane,
            in[f] + (size_t)xs * slice + (size_t)slab_lo * Z, plane);
      }
    cp_async_commit();
    cp_async_wait(0);
    __syncthreads();
    RungSlices<E> sl;
#pragma unroll
    for (int f = 0; f < 3; ++f)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        sl.s[f][k] = smem + (size_t)(f * 3 + k) * plane;
    const bool x_ok = x >= 1 && x <= X - 2;
    const size_t dst_off = (size_t)x * slice + (size_t)own_lo * Z;
    for (int k = threadIdx.x; k < n_vec; k += blockDim.x) {
      const int c = own_r0 * Z + k * VEC;
      const int r = c / Z;
      rung_run<E, CB, VEC>(sl, c, c - r * Z, x_ok && r >= 1 && r <= S - 2,
                           Z, pr, fuse != 0, dt, out,
                           dst_off + (size_t)k * VEC);
    }
  }
}

template <typename E, bool CB, int VEC>
int launch(const void* u, const void* v, const void* w, void* ou, void* ov,
           void* ow, const float* params, int X, int Y, int Z, int TY, int S,
           int n_ty, int L, int threads, int fuse, float dt,
           size_t smem_bytes, cudaStream_t stream) {
  // the kernel stages nine slabs: 3 fields x slices x-1, x, x+1
  if (smem_bytes < (size_t)9 * S * Z * sizeof(E))
    return (int)cudaErrorInvalidValue;
  auto kern = advect_blocked_kernel<E, CB, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((X + L - 1) / L, n_ty);
  kern<<<grid, threads, smem_bytes, stream>>>(
      static_cast<const E*>(u), static_cast<const E*>(v),
      static_cast<const E*>(w), static_cast<E*>(ou), static_cast<E*>(ov),
      static_cast<E*>(ow), params, X, Y, Z, TY, S, L, fuse, dt);
  return (int)cudaGetLastError();
}

template <typename E, bool CB, int VEC>
int attrs(int threads, size_t smem_bytes, int* out) {
  const void* fn = (const void*)advect_blocked_kernel<E, CB, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = per_sm;
  return 0;
}

}  // namespace

// u, v, w, ou, ov, ow: (X, Y, Z) f32, contiguous. params: one row
// [tcx, tcy, 0, 0, tzc1(Z), tzc2(Z)]. The plan (y-tile TY, slab S, n_ty
// tiles, runs of L slices, `threads` per block) comes from the wrapper;
// smem_bytes = 9 * S * Z * 4. Returns the cudaError_t of the attribute call
// or of the launch.
extern "C" int advect_blocked_f32(const float* u, const float* v,
                                  const float* w, float* ou, float* ov,
                                  float* ow, const float* params, int X,
                                  int Y, int Z, int TY, int S, int n_ty,
                                  int L, int threads, int fuse, float dt,
                                  size_t smem_bytes, void* stream) {
  return launch<float, false, 1>(u, v, w, ou, ov, ow, params, X, Y, Z, TY, S,
                                 n_ty, L, threads, fuse, dt, smem_bytes,
                                 (cudaStream_t)stream);
}

// advect_blocked_f32 on bf16 fields (smem_bytes = 9 * S * Z * 2), with
// coef_bf16 nonzero where the coefficients in the f32 row are bf16 values
// (each product with one rounds to bf16); dt is the bf16 value of dt. pairs
// nonzero runs the pair build (two cells a 32-bit word: Z even, every field
// on a 4-byte boundary), else the one-cell build.
extern "C" int advect_blocked_bf16(const void* u, const void* v,
                                   const void* w, void* ou, void* ov,
                                   void* ow, const float* params, int X,
                                   int Y, int Z, int TY, int S, int n_ty,
                                   int L, int threads, int pairs, int fuse,
                                   int coef_bf16, float dt,
                                   size_t smem_bytes, void* stream) {
  using B = __nv_bfloat16;
  if (pairs && Z % 2) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto run = [&](auto fn) {
    return fn(u, v, w, ou, ov, ow, params, X, Y, Z, TY, S, n_ty, L, threads,
              fuse, dt, smem_bytes, s);
  };
  if (pairs)
    return coef_bf16 ? run(launch<B, true, 2>) : run(launch<B, false, 2>);
  return coef_bf16 ? run(launch<B, true, 1>) : run(launch<B, false, 1>);
}

// What the card says of the kernel at `threads` and `smem_bytes`: out =
// [registers per thread, local (spill) bytes per thread, most threads per
// block, resident blocks per SM]. Returns a cudaError_t.
extern "C" int advect_blocked_attrs(int threads, size_t smem_bytes, int* out) {
  return attrs<float, false, 1>(threads, smem_bytes, out);
}

// advect_blocked_attrs of the bf16 builds: f32 (coef_bf16 = 0) or bf16
// coefficients, the pair or the one-cell build.
extern "C" int advect_blocked_bf16_attrs(int coef_bf16, int pairs,
                                         int threads, size_t smem_bytes,
                                         int* out) {
  using B = __nv_bfloat16;
  if (pairs)
    return coef_bf16 ? attrs<B, true, 2>(threads, smem_bytes, out)
                     : attrs<B, false, 2>(threads, smem_bytes, out);
  return coef_bf16 ? attrs<B, true, 1>(threads, smem_bytes, out)
                   : attrs<B, false, 1>(threads, smem_bytes, out);
}
