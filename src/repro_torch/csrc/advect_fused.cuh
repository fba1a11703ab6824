// Fused PW advection ring (v4 temporal blocking) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/advection/advection.py `advect_fused` ->
// `_kernel_fused` (the Pallas TPU kernel), and its vmap over slots,
// `advect_fused_batched`.
//
// What it computes: T masked explicit-Euler PW steps of u, v, w in one pass
// over device memory. A block owns one (y-tile, z-chunk, x-chunk, slot): rows
// [t*TY, min((t+1)*TY, Y)) of a slab of S = TY + 2T rows clipped flush into
// the domain, cells [z0, z1) of a z window of W = CZ + 2T cells clipped the
// same way (W = Z, one chunk, wherever a slab row fits a block), and slices
// [x0, x1) of a chunk of CX. It walks x from max(x0 - T, 0) to x1 - 1 + T;
// at step i slice min(i, X-1) enters level 0 and level k computes slice
// j = i - k from level k-1's slices j-1, j, j+1. Level k is exact from slice
// x0 - T + k on, so the output (level T, slices [x0, x1), owned rows and
// cells) sees only exact operands: the T-deep x halo is the x analogue of
// the y and z halos, and tiled and chunked results equal the untiled ones
// bitwise. A slab's or window's cut edge is a wall (no source), as the
// domain's edges are. No block writes a cell another block owns.
//
// Update: new = cen + dt * (interior ? src : 0.0f), a select and never a
// multiply. src keeps the reference's operation order, fx + fy + fz, each
// parenthesised as in `_source_slices`; with --fmad=false every product and
// sum rounds on its own, as in the plain PyTorch version.
//
// Storage: f32 or bf16 fields (E), and f32 or bf16 coefficients (CB). With
// bf16 fields every op of the reference's ring that JAX runs in bf16 rounds
// to bf16 here, each by one paired convert with a zero lane (`rpk`,
// cells.cuh; a `__float2bfloat16_rn` a round would queue on the conversion
// unit): the ring is `u.dtype`, so each level is a bf16 value; a sum or
// product of two field values is a bf16 op; a product with a coefficient
// is a bf16 op only where the coefficients are bf16 too (a bf16 domain's),
// else an f32 op, and the source is rounded to bf16 before the update,
// whose dt the wrapper passes rounded to bf16. The registers
// and shared planes hold f32 words of bf16 values, so the plan and its
// shared bytes are the f32 build's; only device memory moves 2-byte cells.
//
// Bound on one H100 SXM: memory. One pass reads and writes the three fields
// once: 6*X*Y*Z*4 bytes, 1.61 GB at (1024, 1024, 64), 0.48 ms at 3.35 TB/s.
// Its arithmetic without FMA (about 67 operations per cell and level) needs
// about 0.54 ms at 128 f32 lanes per SM, before any halo recomputation. The
// design:
// - A register ring. A thread owns C cells of one slab row, z = zt + q*ZS
//   (ZS = ceil(W / C)), and keeps, per level below T, each field's value at
//   x - 1 and x in registers; x + 1 is the value the level below just
//   computed. Only the centre slice of each level is seen by neighbours:
//   y +- 1 and z +- 1 come from one shared plane per level and field,
//   double-buffered, so a slice costs one barrier. Shared memory: 2 * T * 3
//   * S rows of P floats (P >= W pads the row so that the rows a warp
//   covers when ZS divides 32 fall on different banks).
// - One branch per thread and level. A row is computed at level k only if
//   it feeds an owned row (d rows outside the owned rows: levels 1..T-d),
//   so the test is the same for all of a thread's cells and their loads
//   and arithmetic interleave; z walls are a select. Cells of a z window
//   outside the owned cells are computed at every level: the ones past
//   T - k are inexact, but no owned cell reads them.
// - Chunks. The grid is (n_ty * n_cz * n_cx, B): the launch planner
//   (`fused_launch_plan`) sizes TY, CZ and CX from the builds' threads, the
//   SM count, the kernel's resident blocks per SM and a model of waves times
//   slices walked.
// - Loads ahead of compute: slice i + 1 is loaded (coalesced along z) into
//   registers before slice i's levels compute, and lands in level 0 after.
//
// The builds: T in 1..K1_MAX_T by C in {2, 4, 8} cells per thread, each C at
// K1_THREADS_C<C> threads per block (__launch_bounds__). Both come from the
// build's flags (`_build.py`'s K1_MAX_T and K1_BUILDS), which the launch
// planner reads too; the wrapper runs a deeper T as several passes. Each
// storage build (E, CB) has a source of its own, so that nvcc compiles them
// in parallel: advect_fused.cu (f32), advect_fused_bf16.cu (bf16 fields, f32
// coefficients) and advect_fused_bf16_coef.cu (bf16 fields and
// coefficients), each exporting its entry points over `launch_build` and
// `attrs_build` below.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <array>
#include <utility>

#include "cells.cuh"

#if !defined(K1_MAX_T) || !defined(K1_THREADS_C2) || \
    !defined(K1_THREADS_C4) || !defined(K1_THREADS_C8)
#error "K1's builds come from _build.py: -DK1_MAX_T, -DK1_THREADS_C<C>"
#endif

namespace {

template <int C>
struct Bounds;
template <>
struct Bounds<2> { static constexpr int threads = K1_THREADS_C2; };
template <>
struct Bounds<4> { static constexpr int threads = K1_THREADS_C4; };
template <>
struct Bounds<8> { static constexpr int threads = K1_THREADS_C8; };

template <typename E, bool CB, int T, int C>
__global__ void __launch_bounds__(Bounds<C>::threads) advect_ring_kernel(
    const E* __restrict__ u, const E* __restrict__ v,
    const E* __restrict__ w, E* __restrict__ ou,
    E* __restrict__ ov, E* __restrict__ ow,
    const float* __restrict__ params, const float* __restrict__ xm,
    const float* __restrict__ ym, int X, int Y, int Z, int TY, int S,
    int n_ty, int CZ, int W, int n_cz, int CX, int P, int p_stride,
    int xm_stride, int ym_stride, float dt) {
  constexpr bool RF = CellOf<E>::bf16;  // a field op rounds to bf16
  constexpr bool RC = RF && CB;         // so does a coefficient's
  extern __shared__ float smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int t = blockIdx.x % n_ty;
  const int rest = blockIdx.x / n_ty;
  const int cz = rest % n_cz;
  const int cx = rest / n_cz;
  const int b = blockIdx.y;
  const int slab_lo = min(max(t * TY - T, 0), Y - S);
  const int own_lo = t * TY - slab_lo;               // slab rows owned:
  const int own_hi = own_lo + min(TY, Y - t * TY);   // [own_lo, own_hi)
  const int z0 = cz * CZ;
  const int z1 = min(z0 + CZ, Z);
  const int zlo = min(max(z0 - T, 0), Z - W);        // the window's first z
  const int x0 = cx * CX;
  const int x1 = min(x0 + CX, X);
  const int xs = max(x0 - T, 0);
  const int xe = x1 - 1 + T;
  const int plane = S * P;
  const size_t slice = (size_t)Y * Z;
  const size_t base = (size_t)b * X * slice + (size_t)slab_lo * Z + zlo;
  const E* in[3] = {u + base, v + base, w + base};
  E* out[3] = {ou + base, ov + base, ow + base};
  // this slot's row of [tcx, tcy, tzc1(Z), tzc2(Z)]
  const float* prow = params + (size_t)b * p_stride;
  const float tcx = prow[0];
  const float tcy = prow[1];
  const float* xmb = xm + (size_t)b * xm_stride;
  const float* ymb = ym + (size_t)b * ym_stride + slab_lo;
  float* tz = smem;                       // the window's tzc1, then tzc2
  float* planes = smem + 2 * W;           // [2][T][3][S][P]
  const size_t buf_sz = (size_t)T * 3 * plane;
  for (int i = tid; i < 2 * W; i += nt)
    tz[i] = prow[2 + zlo + (i < W ? i : Z + i - W)];

  // this thread's slab row r and window cells z = zt + q*ZS, worked out once
  const int ZS = (W + C - 1) / C;
  const int r = tid / ZS;
  const int zt = tid - r * ZS;
  const bool row_ok = r < S;
  const int dist = r < own_lo ? own_lo - r
                              : (r >= own_hi ? r - own_hi + 1 : 0);
  const bool owned = row_ok && dist == 0;
  // the levels 1..levels at which the row takes a source
  const int levels = row_ok && r >= 1 && r <= S - 2 && ymb[r] > 0.0f
                         ? max(T - dist, 0) : 0;
  // bit q: z in the window; z takes a source; z owned
  unsigned zcell = 0, zsrc = 0, zown = 0;
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int z = zt + q * ZS;
    if (row_ok && z < W) zcell |= 1u << q;
    if (z >= 1 && z <= W - 2) zsrc |= 1u << q;
    if (owned && z < W && zlo + z >= z0 && zlo + z < z1) zown |= 1u << q;
  }
  const int c0 = r * P + zt;   // plane index of cell 0
  const int g0 = r * Z + zt;   // its offset in a slice of the slab window

  // the ring: per level below T, each field at x - 1 (prv) and x (cur);
  // nxt is level 0's newest slice, pf the slice loaded ahead
  float prv[T][3][C], cur[T][3][C], nxt[3][C], pf[3][C];
#pragma unroll
  for (int q = 0; q < C; ++q) {
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      pf[f][q] = 0.0f;
#pragma unroll
      for (int m = 0; m < T; ++m) prv[m][f][q] = cur[m][f][q] = 0.0f;
    }
  }
#pragma unroll
  for (int q = 0; q < C; ++q) {
    if (zcell >> q & 1u) {
      const size_t off = (size_t)xs * slice + g0 + q * ZS;
#pragma unroll
      for (int f = 0; f < 3; ++f) pf[f][q] = ld_cell(in[f] + off);
    }
  }
  __syncthreads();

  int rd = 0;
  for (int i = xs; i <= xe; ++i) {
#pragma unroll
    for (int q = 0; q < C; ++q) {
#pragma unroll
      for (int f = 0; f < 3; ++f) nxt[f][q] = pf[f][q];
    }
    if (i < xe) {
      const size_t off = (size_t)min(i + 1, X - 1) * slice + g0;
#pragma unroll
      for (int q = 0; q < C; ++q) {
        if (zcell >> q & 1u) {
#pragma unroll
          for (int f = 0; f < 3; ++f)
            pf[f][q] = ld_cell(in[f] + off + q * ZS);
        }
      }
    }
    const float* prd = planes + rd * buf_sz;
    float* pwr = planes + (rd ^ 1) * buf_sz;
#pragma unroll
    for (int k = 1; k <= T; ++k) {
      const int j = i - k;
      const bool x_ok = j >= 1 && j <= X - 2 && j >= x0 - T + k &&
                        xmb[j] > 0.0f;
      const float* pu = prd + (size_t)(k - 1) * 3 * plane;
      const float* pl[3] = {pu, pu + plane, pu + 2 * plane};
      float* wl = pwr + (size_t)(k - 1) * 3 * plane;
      float src[3][C];
#pragma unroll
      for (int q = 0; q < C; ++q) {
#pragma unroll
        for (int f = 0; f < 3; ++f) src[f][q] = 0.0f;
      }
      // an interior row: its neighbour rows and z +- 1 lie in the planes
      // (the z walls' reads too, into the pitch's pad or the next row)
      if (x_ok && k <= levels) {
#pragma unroll
        for (int q = 0; q < C; ++q) {
          const int c = c0 + q * ZS;
          const int z = zt + q * ZS;
          const float t1 = tz[z];
          const float t2 = tz[W + z];
          const float um = prv[k - 1][0][q];
          const float up = nxt[0][q];
#pragma unroll
          for (int f = 0; f < 3; ++f) {
            const float fc = cur[k - 1][f][q];
            const float* fs = pl[f];
            const float fx = rpk<RC>(
                tcx * rpk<RF>(rpk<RF>(um * rpk<RF>(fc + prv[k - 1][f][q]))
                              - rpk<RF>(up * rpk<RF>(fc + nxt[f][q]))));
            const float fy = rpk<RC>(
                tcy * rpk<RF>(rpk<RF>(pl[1][c - P] * rpk<RF>(fc + fs[c - P]))
                              - rpk<RF>(pl[1][c + P] *
                                        rpk<RF>(fc + fs[c + P]))));
            const float fz = rpk<RC>(
                rpk<RC>(rpk<RC>(t1 * pl[2][c - 1]) * rpk<RF>(fc + fs[c - 1]))
                - rpk<RC>(rpk<RC>(t2 * pl[2][c + 1]) *
                          rpk<RF>(fc + fs[c + 1])));
            src[f][q] = zsrc >> q & 1u
                            ? rpk<RF>(rpk<RC>(rpk<RC>(fx + fy) + fz))
                            : 0.0f;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < C; ++q) {
        // level k-1's newest slice becomes its centre plane for the next
        // step (the other buffer), and its ring moves one slice on
        if (zcell >> q & 1u) {
#pragma unroll
          for (int f = 0; f < 3; ++f)
            wl[f * plane + c0 + q * ZS] = nxt[f][q];
        }
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          const float res =
              rpk<RF>(cur[k - 1][f][q] + rpk<RF>(dt * src[f][q]));
          prv[k - 1][f][q] = cur[k - 1][f][q];
          cur[k - 1][f][q] = nxt[f][q];
          nxt[f][q] = res;
        }
      }
    }
    // nxt now holds level T at slice i - T
    const int j = i - T;
    if (j >= x0 && zown) {
      const size_t off = (size_t)j * slice + g0;
#pragma unroll
      for (int q = 0; q < C; ++q) {
        if (zown >> q & 1u) {
#pragma unroll
          for (int f = 0; f < 3; ++f) st_cell(out[f] + off + q * ZS, nxt[f][q]);
        }
      }
    }
    __syncthreads();
    rd ^= 1;
  }
}

struct Args {
  const void *u, *v, *w;
  void *ou, *ov, *ow;
  const float *params, *xm, *ym;
  int B, X, Y, Z, T, TY, S, n_ty, CZ, W, n_cz, CX, n_cx, threads, P,
      p_stride, xm_stride, ym_stride;
  float dt;
  size_t smem;
  cudaStream_t stream;
};

template <typename E, bool CB, int T, int C>
int launch(const Args& a) {
  auto kern = advect_ring_kernel<E, CB, T, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.n_ty * a.n_cz * a.n_cx, a.B);
  kern<<<grid, a.threads, a.smem, a.stream>>>(
      static_cast<const E*>(a.u), static_cast<const E*>(a.v),
      static_cast<const E*>(a.w), static_cast<E*>(a.ou),
      static_cast<E*>(a.ov), static_cast<E*>(a.ow), a.params, a.xm, a.ym,
      a.X, a.Y, a.Z, a.TY, a.S, a.n_ty, a.CZ, a.W, a.n_cz, a.CX, a.P,
      a.p_stride, a.xm_stride, a.ym_stride, a.dt);
  return (int)cudaGetLastError();
}

// out: registers per thread, local (spill) bytes per thread, the most
// threads a block can have, and resident blocks per SM at (threads, smem)
template <typename E, bool CB, int T, int C>
int attrs(int threads, size_t smem, int* out) {
  auto kern = advect_ring_kernel<E, CB, T, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = fa.maxThreadsPerBlock;
  out[3] = per_sm;
  return 0;
}

using LaunchFn = int (*)(const Args&);
using AttrsFn = int (*)(int, size_t, int*);

// row T - 1 of each table: the builds of depth T for C = 2, 4, 8
template <typename E, bool CB, int... I>
std::array<std::array<LaunchFn, 3>, sizeof...(I)> launch_table(
    std::integer_sequence<int, I...>) {
  return {{std::array<LaunchFn, 3>{{launch<E, CB, I + 1, 2>,
                                    launch<E, CB, I + 1, 4>,
                                    launch<E, CB, I + 1, 8>}}...}};
}
template <typename E, bool CB, int... I>
std::array<std::array<AttrsFn, 3>, sizeof...(I)> attrs_table(
    std::integer_sequence<int, I...>) {
  return {{std::array<AttrsFn, 3>{{attrs<E, CB, I + 1, 2>,
                                   attrs<E, CB, I + 1, 4>,
                                   attrs<E, CB, I + 1, 8>}}...}};
}
using Depths = std::make_integer_sequence<int, K1_MAX_T>;

// column of C in the tables above, or -1
int c_index(int C) { return C == 2 ? 0 : C == 4 ? 1 : C == 8 ? 2 : -1; }

// The entry points' bodies on the tables of one storage build (E, CB): the
// (T, C) build's launch or attributes, or cudaErrorInvalidValue for a (T, C)
// the library was not built for.
template <typename E, bool CB>
int launch_build(const Args& a, int C) {
  static const auto table = launch_table<E, CB>(Depths{});
  const int ci = c_index(C);
  if (a.T < 1 || a.T > K1_MAX_T || ci < 0) return (int)cudaErrorInvalidValue;
  return table[a.T - 1][ci](a);
}

template <typename E, bool CB>
int attrs_build(int T, int C, int threads, size_t smem, int* out) {
  static const auto table = attrs_table<E, CB>(Depths{});
  const int ci = c_index(C);
  if (T < 1 || T > K1_MAX_T || ci < 0) return (int)cudaErrorInvalidValue;
  return table[T - 1][ci](threads, smem, out);
}

}  // namespace
