// PW advection, v2 `dataflow` and v3 `wide`, for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/advection/advection.py `advect_dataflow` ->
// `_kernel_dataflow` (the Pallas TPU kernel, :272), and `advect_wide` (:367),
// which runs the same kernel under a layout contract.
//
// What it computes: the same values as advect_blocked.cu, bitwise: the PW
// sources of u, v, w, or with `fuse` the advanced fields
// cen + dt * (interior ? src : 0).
//
// What bounds it on one H100 SXM: memory. The function reads the three
// fields and writes three, 6 * X * Y * Z * 4 bytes: 1.61 GB and 0.4808 ms at
// 3.35 TB/s at (1024, 1024, 64). Its arithmetic, 63 ops per interior cell
// (plus 6 per cell with `fuse`), takes 0.06-0.07 ms at 67 TFLOP/s.
//
// The rung's data movement, which the design keeps: the Pallas grid walks
// x in order on one core through a 3-slot shift register per field. Here
// blocks run at once, so x is cut into chunks of L slices and each block
// owns one (x-chunk, y-tile) pair. It streams the slab of each slice of its
// chunk, S = TY + 2 rows clipped flush into the domain, plus one halo slice
// on each side, from device memory into a ring of R slots a field in
// dynamic shared memory (3 * R * S * Z * 4 bytes), so every slice is read
// once a chunk: (L + 2) / L times the compulsory reads, and S / TY for the
// y halo. It writes each owned row of each slice of its chunk once.
// VEC = 4 is v3 `wide`: every move a thread makes is 16 bytes, the global
// loads (cp.async.cg), the shared reads and the global stores, the card's
// counterpart of the paper's 64 -> 256-bit port widening. It needs Z % 4 == 0
// and 16-byte-aligned fields, which the wrapper checks. VEC = 1 moves 4-byte
// words (cp.async.ca). Neither uses a bulk (TMA) copy, which would move
// either rung's slabs at the copy engine's width and erase the v2 -> v3 step.
//
// What the design does about the bound:
// - Loads ahead. The ring has R = 3 + A slots. While a block computes slice
//   x from the slots of x-1, x and x+1, the loads of x+1+A are in flight
//   (cp.async, one commit group a slice), into the slot that x-2 left. One
//   barrier a slice: it publishes x+1 and frees x-2's slot at once.
// - Several blocks an SM. The plan (`rung_launch_plan` in
//   kernels/advection/advection.py) takes the tallest y-tile whose ring
//   lets two blocks share an SM, sizes the threads to the tile (4 cells a
//   thread) and the x-chunks to whole waves of the card's resident blocks.
//   At (1024, 1024, 64): TY = 32, R = 4, 104,448 B, 512 threads, chunks of
//   64 slices: 512 blocks, two an SM.
// - No zero fill. A slot that is never loaded (x = -1, x = X) is read only
//   by the boundary slices, whose cells read nothing but their own value.
// - No bank conflicts. A warp's 4-byte reads fall on 32 consecutive
//   words; `wide` reads its four cells with one 16-byte load and their z
//   neighbours from the 16-byte words on each side.
//
// bf16 fields (E = __nv_bfloat16): the ring holds 2-byte cells as cp.async
// lands them, so its bytes halve and the plan (`rung_launch_plan` at
// itemsize 2) takes the tile for that. The arithmetic rounds as
// pw_source.cuh says, with f32 or bf16 coefficients (CB). `wide` moves
// 16-byte vectors of 8 cells (Z % 8 == 0) and computes them as four 32-bit
// words of two cells, each bf16 op of a word one bf16x2 instruction. The
// 4-byte build does the same for one word (VEC = 2) where Z is even and
// every field starts on a 4-byte boundary (the wrapper's choice, before the
// launch), and elsewhere computes one cell (VEC = 1), each bf16 op an f32
// op rounded by `rpk`; both move 4-byte words.
#include <cuda_runtime.h>
#include <stddef.h>

#include "pw_source.cuh"

namespace {

constexpr int kMaxThreads = 512;

template <typename E, bool CB, int VEC>
__global__ void __launch_bounds__(kMaxThreads, 2) advect_dataflow_kernel(
    const E* __restrict__ u, const E* __restrict__ v,
    const E* __restrict__ w, E* __restrict__ ou, E* __restrict__ ov,
    E* __restrict__ ow, const float* __restrict__ params, int X, int Y,
    int Z, int TY, int S, int L, int R, int fuse, float dt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* smem = reinterpret_cast<E*>(smem_raw);
  const int x0 = blockIdx.x * L;
  const int x1 = min(x0 + L, X);
  const int t = blockIdx.y;
  const int slab_lo = min(max(t * TY - 1, 0), Y - S);
  const int own_lo = t * TY;
  const int own_r0 = own_lo - slab_lo;
  const int n_vec = min(TY, Y - own_lo) * Z / VEC;  // rows of whole vectors
  const size_t slice = (size_t)Y * Z;
  const int plane = S * Z;
  const E* in[3] = {u, v, w};
  E* const out[3] = {ou, ov, ow};
  const RungParams pr = rung_params<VEC>(params, Z);
  const int ahead = R - 3;
  const int n_walk = x1 - x0 + 2;  // slices x0 - 1 .. x1

  // slice j of the walk (x = x0 - 1 + j) goes to slot j % R of each field,
  // one commit group a slice, empty where the slice lies outside the walk or
  // the domain
  auto issue = [&](int j) {
    const int i = x0 - 1 + j;
    if (j < n_walk && i >= 0 && i < X) {
      const size_t src_off = (size_t)i * slice + (size_t)slab_lo * Z;
#pragma unroll
      for (int f = 0; f < 3; ++f)
        cp_async_plane<E, VEC>(smem + (size_t)(f * R + j % R) * plane,
                            in[f] + src_off, plane);
    }
    cp_async_commit();
  };

  for (int j = 0; j < ahead + 2; ++j) issue(j);
  for (int x = x0; x < x1; ++x) {
    const int j = x - x0 + 1;  // the walk's slice x; x + 1 is j + 1
    cp_async_wait(ahead - 1);  // this thread's copies of x + 1 have landed
    __syncthreads();           // everyone's have, and x - 2's slot is free
    issue(j + 1 + ahead);
    RungSlices<E> sl;
#pragma unroll
    for (int f = 0; f < 3; ++f)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        sl.s[f][k] = smem + (size_t)(f * R + (j - 1 + k) % R) * plane;
    const bool x_ok = x >= 1 && x <= X - 2;
    const size_t dst_off = (size_t)x * slice + (size_t)own_lo * Z;
    for (int k = threadIdx.x; k < n_vec; k += blockDim.x) {
      const int c0 = own_r0 * Z + k * VEC;
      const int r = c0 / Z;
      rung_run<E, CB, VEC>(sl, c0, c0 - r * Z,
                             x_ok && r >= 1 && r <= S - 2, Z, pr, fuse != 0,
                             dt, out, dst_off + (size_t)k * VEC);
    }
  }
  cp_async_wait(0);
}

template <typename E, bool CB, int VEC>
int launch(const void* u, const void* v, const void* w, void* ou, void* ov,
           void* ow, const float* params, int X, int Y, int Z, int TY, int S,
           int n_ty, int L, int R, int threads, int fuse, float dt,
           size_t smem_bytes, cudaStream_t stream) {
  // a ring of 3 slots has no slot to load ahead into (the wait would let
  // the compute read x+1 before it lands); shared memory must hold R slots
  if (R < 4 || R > 5 || smem_bytes < (size_t)3 * R * S * Z * sizeof(E))
    return (int)cudaErrorInvalidValue;
  auto kern = advect_dataflow_kernel<E, CB, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((X + L - 1) / L, n_ty);
  kern<<<grid, threads, smem_bytes, stream>>>(
      static_cast<const E*>(u), static_cast<const E*>(v),
      static_cast<const E*>(w), static_cast<E*>(ou), static_cast<E*>(ov),
      static_cast<E*>(ow), params, X, Y, Z, TY, S, L, R, fuse, dt);
  return (int)cudaGetLastError();
}

template <typename E, bool CB, int VEC>
int attrs(int threads, size_t smem_bytes, int* out) {
  const void* fn = (const void*)advect_dataflow_kernel<E, CB, VEC>;
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

constexpr int kBf16Vec = 8;   // bf16 cells in a 16-byte vector

}  // namespace

// u, v, w, ou, ov, ow: (X, Y, Z) f32, contiguous (16-byte aligned and
// Z % 4 == 0 when vec4). params: one 16-byte-aligned row
// [tcx, tcy, 0, 0, tzc1(Z), tzc2(Z)]. The plan (y-tile TY, slab S, n_ty
// tiles, chunks of L slices, a ring of R slots in 4..5, `threads` per block)
// comes from the wrapper; smem_bytes = 3 * R * S * Z * 4. Returns the
// cudaError_t of the attribute call or of the launch.
extern "C" int advect_dataflow_f32(const float* u, const float* v,
                                   const float* w, float* ou, float* ov,
                                   float* ow, const float* params, int X,
                                   int Y, int Z, int TY, int S, int n_ty,
                                   int L, int R, int threads, int vec4,
                                   int fuse, float dt, size_t smem_bytes,
                                   void* stream) {
  auto s = (cudaStream_t)stream;
  if (vec4)
    return launch<float, false, 4>(u, v, w, ou, ov, ow, params, X, Y, Z, TY,
                                   S, n_ty, L, R, threads, fuse, dt,
                                   smem_bytes, s);
  return launch<float, false, 1>(u, v, w, ou, ov, ow, params, X, Y, Z, TY, S,
                                 n_ty, L, R, threads, fuse, dt, smem_bytes,
                                 s);
}

// advect_dataflow_f32 on bf16 fields (smem_bytes = 3 * R * S * Z * 2): vec
// nonzero is `wide`, 16-byte moves of 8 cells, four pairs (Z % 8 == 0,
// 16-byte-aligned fields); else pairs nonzero runs the pair build (two cells
// a 32-bit word: Z even, every field on a 4-byte boundary), pairs zero the
// one-cell build. coef_bf16 nonzero where the coefficients in the f32 row
// are bf16 values (each product with one rounds to bf16); dt is the bf16
// value of dt.
extern "C" int advect_dataflow_bf16(const void* u, const void* v,
                                    const void* w, void* ou, void* ov,
                                    void* ow, const float* params, int X,
                                    int Y, int Z, int TY, int S, int n_ty,
                                    int L, int R, int threads, int vec,
                                    int pairs, int fuse, int coef_bf16,
                                    float dt, size_t smem_bytes,
                                    void* stream) {
  using B = __nv_bfloat16;
  if ((vec && !pairs) || (pairs && Z % 2)) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto run = [&](auto fn) {
    return fn(u, v, w, ou, ov, ow, params, X, Y, Z, TY, S, n_ty, L, R,
              threads, fuse, dt, smem_bytes, s);
  };
  if (vec)
    return coef_bf16 ? run(launch<B, true, kBf16Vec>)
                     : run(launch<B, false, kBf16Vec>);
  if (pairs)
    return coef_bf16 ? run(launch<B, true, 2>) : run(launch<B, false, 2>);
  return coef_bf16 ? run(launch<B, true, 1>) : run(launch<B, false, 1>);
}

// What the card says of the build (vec4 or not) at `threads` and
// `smem_bytes`: out = [registers per thread, local (spill) bytes per thread,
// most threads per block, resident blocks per SM]. Returns a cudaError_t.
extern "C" int advect_dataflow_attrs(int vec4, int threads, size_t smem_bytes,
                                     int* out) {
  return vec4 ? attrs<float, false, 4>(threads, smem_bytes, out)
              : attrs<float, false, 1>(threads, smem_bytes, out);
}

// advect_dataflow_attrs of the bf16 builds (vec: `wide`, four pairs a
// thread; else pairs or one cell), with f32 (coef_bf16 = 0) or bf16
// coefficients.
extern "C" int advect_dataflow_bf16_attrs(int vec, int pairs, int coef_bf16,
                                          int threads, size_t smem_bytes,
                                          int* out) {
  using B = __nv_bfloat16;
  if (vec)
    return coef_bf16 ? attrs<B, true, kBf16Vec>(threads, smem_bytes, out)
                     : attrs<B, false, kBf16Vec>(threads, smem_bytes, out);
  if (pairs)
    return coef_bf16 ? attrs<B, true, 2>(threads, smem_bytes, out)
                     : attrs<B, false, 2>(threads, smem_bytes, out);
  return coef_bf16 ? attrs<B, true, 1>(threads, smem_bytes, out)
                   : attrs<B, false, 1>(threads, smem_bytes, out);
}
