// Spec-driven fused ring (the stencil-spec frontend's engine) for Hopper,
// sm_90a, on K1's design (advect_fused.cuh).
//
// Replaces: src/repro/kernels/advection/advection.py `stencil_fused` ->
// `_kernel_stencil_fused` (the Pallas TPU kernel), and its vmap over slots,
// `stencil_fused_batched`.
//
// What it computes: T steps of a StencilSpec's integrator over its NF fields
// in one pass over device memory, through L = STAGES * T ring levels of a
// functor of radius R, so the dependence cone is D = R * L cells deep on x,
// y and z (`spec.halo(T)`). Euler spends one level per step (cen +
// dt*src). Midpoint RK2 spends two: odd levels hold g = cen + (dt/2)*src,
// even levels write base + dt*src(g), base being level k-2's slice j. A
// block owns one (y-tile, z-chunk, x-chunk, slot): rows [t*TY, min((t+1)*TY,
// Y)) of a slab of S = TY + 2D rows clipped flush into the domain, cells
// [z0, z1) of a window of W = CZ + 2D cells clipped the same way (W = Z, one
// chunk, wherever a slab row fits a block), and slices [x0, x1) of a chunk
// of CX. It walks x from max(x0 - D, 0) to x1 - 1 + LAG * L; at step i slice
// min(i, X-1) enters level 0 and level k computes slice j = i - k * LAG
// from level k-1's slices j-R .. j+R, LAG being R, or one more than the
// largest x offset the functor reads off the centre row where that is more
// (below). Level k is exact from slice x0 - D + k*R on, so the output (level
// L, owned slices, rows and cells) sees only exact operands, and tiled and
// chunked results equal the untiled ones bitwise. A slab's or window's cut
// edge is a wall R cells wide (no source), as the domain's edges are. No
// block writes a cell another block owns.
//
// Update: new = base + step_dt * (interior ? src : 0.0f), a select and never
// a multiply: startup slices and cut edges hold values that only the select
// walls off, and masked slices copy through (g = cen, new = base). interior
// = R <= j <= X-1-R, x_mask[j], the row mask and the slab's and window's
// edges. The source is an operator functor (stencil_ops.cuh, or one that
// `repro_torch.stencil.spec_cuda` generated from a spec's callback), the
// callback's arithmetic term by term; with --fmad=false every product and
// sum rounds on its own, as in the plain PyTorch version. The parameter
// vectors are shared by every slot (the reference's batched kernel shares
// them too); the masks may be per slot.
//
// Storage: f32 or bf16 fields (E), and f32 or bf16 coefficients (CB), as
// K1's (cells.cuh). The reference's ring is `fields[0].dtype`: with bf16
// fields each level is a bf16 value, every op of the source that torch's
// promotion runs in bf16 rounds to bf16 (`rpk`, one paired convert with a
// zero lane; the functor's `rpk<RF>` where its operands are field values
// or weak scalars, `rpk<RC>` where a coefficient takes part, RC being set
// only when the coefficients are bf16 too), the source is rounded to the
// field's dtype before the update, and the update
// is two bf16 ops on dt rounded to bf16 by the wrapper. Registers and shared
// planes hold f32 words of bf16 values, so the plan and its shared bytes
// are the f32 build's; only device memory moves 2-byte cells.
//
// Bound on one H100 SXM: memory. One pass reads and writes the NF fields
// once: 2*NF*X*Y*Z*itemsize bytes, 1.61 GB for PW in f32 at (1024, 1024,
// 64), 0.48 ms at 3.35 TB/s (tracer 0.64, diffusion 0.16; half in bf16);
// the arithmetic, L source passes of 64 (PW), 85 (tracer) or 14
// (diffusion) operations per interior cell plus the 2-op update of each
// field, is below that at 67 TFLOP/s. The design, K1's with D in place of T:
// - A register ring. A thread owns C cells of one slab row, z = zt + q*ZS
//   (ZS = ceil(W / C)), and keeps, per level below L, each field's slices
//   j-R .. j+LAG-1 in registers (at R = 1 without x-diagonal reads, x - 1
//   and x); j + LAG is the value the level below has just computed, so the
//   operators' reads along x are registers. Reads off the centre row (y and
//   z offsets, the y-z diagonals too) come from shared planes: each level
//   and field keeps a ring of SLOTS = NX + 1 planes, NX being the x offsets
//   XLO..XHI its functor reads off the centre row (one, x itself, where it
//   reads no x-diagonal), and each step writes one slice into the slot the
//   oldest slice leaves, so a slice costs one barrier and no plane is
//   copied. A read at x + XHI off the row needs that slice in a plane a
//   step before: the level trails the one below by LAG = max(R, XHI + 1)
//   slices. Shared memory: kHead floats, the window's z coefficients and
//   SLOTS * L * NF planes of S rows of P floats (`fused_shared_bytes`).
// - RK2's full level k reads its base, level k-2's slice j, which level
//   k-1 shifted out of level k-2's ring LAG - R steps before; a FIFO of
//   LAG - R + 1 registers per field and cell (`hold`) keeps it until level
//   k has read it (one register, read in the step it is shifted out, at
//   LAG = R). This is the one place the ring differs from K1's.
// - One branch per thread and level. A row is computed at level k only if
//   it feeds an owned row (d rows outside the owned rows: levels
//   1..L-ceil(d/R)), so the test is the same for all of a thread's cells; z
//   walls are a select. Cells of a window outside the owned cells are
//   computed at every level: the ones past D - k*R are inexact, but no
//   owned cell reads them.
// - Chunks. The grid is (n_ty * n_cz * n_cx, B): the launch planner
//   (`spec_launch_plan`, K1's planner at D) sizes TY, CZ and CX from the
//   builds' threads, the SM count, the build's resident blocks per SM and
//   a model of waves times slices walked.
// - Loads ahead of compute: slice i + 1 is loaded (coalesced along z) into
//   registers before slice i's levels compute, and lands in level 0 after.
// - Fields: the kernel takes NF typed pointers (`RingArgs<E, NF>`, by
//   value), the C entry points an array of them (`K6Call`), so a functor of
//   any field count runs through one interface.
//
// The builds: L in 1..LMAX (K6_MAX_LEVELS for the shipped functors, a
// generated functor's own) (even L for rk2) by C in {2, 4} cells per thread,
// each at the threads per block its table gives it (__launch_bounds__; 0:
// not built). The shipped functors' table is the header `k6_table.cuh` that
// `_build.py` writes into the build from its K6_MAX_LEVELS, K6_BUILDS and
// K6_COEF_VECTORS, which the launch planner reads too; each storage build
// (E, CB) of them has an entry source of its own (stencil_fused.cu,
// stencil_fused_bf16.cu, stencil_fused_bf16_coef.cu) so that nvcc compiles
// them in parallel. A generated functor is built on its own
// (stencil_generated.cu). The wrapper runs a deeper T as several passes of
// whole steps.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <array>
#include <type_traits>
#include <utility>

#include "cells.cuh"
#include "k6_table.cuh"
#include "stencil_ops.cuh"

// The arguments of every K6 entry point (a host struct the wrapper lays
// out with ctypes, `advection._K6Call`): in/out: `nf` pointers each to
// (B, X, Y, Z) fields of the build's storage, contiguous; pv: the spec's
// parameter vectors, p_len apart, as f32 (bf16 ones as their exact f32
// values), shared by every slot; xm: rows of X, ym: rows of Y, slot strides
// 0 (shared) or X / Y; T steps in one pass (stages * T levels); the plan
// (TY, S, n_ty, CZ, W, n_cz, CX, n_cx, C cells per thread, threads, the
// planes' row pitch P, smem_bytes) from the wrapper's `spec_launch_plan`;
// dt as the update multiplies by it (rounded to bf16 for bf16 fields).
struct K6Call {
  const void* const* in;
  void* const* out;
  const float* pv;
  const float* xm;
  const float* ym;
  void* stream;
  size_t smem_bytes;
  int nf, p_len, B, X, Y, Z, T, TY, S, n_ty, CZ, W, n_cz, CX, n_cx, C,
      threads, P, xm_stride, ym_stride;
  float dt;
};

namespace {

// typed by the cells: a ring over `const void*` fields takes more
// registers in some builds (diffusion's 4-cell ones, where it spilled); at
// least four pointers a side, the layout of the shipped builds' launches,
// since with fewer ptxas spilled in diffusion's 3-level 4-cell builds
template <typename E, int NF>
struct RingArgs {
  const E* in[NF < 4 ? 4 : NF];  // (B, X, Y, Z) per field, contiguous
  E* out[NF < 4 ? 4 : NF];
  const float* pv;               // the parameter vectors, p_len apart
  const float* xm;               // rows of X, slot stride xm_stride
  const float* ym;               // rows of Y, slot stride ym_stride
  int p_len, X, Y, Z, TY, S, n_ty, CZ, W, n_cz, CX, P, xm_stride, ym_stride;
  float dt;
};

// The ring's shape for functor Op: radius R, the x offsets XLO..XHI of its
// reads off the centre row (NX of them), the slices a level trails the one
// below (LAG), the planes a level and field keeps (SLOTS), the registers a
// level keeps per field and cell (KEEP: slices j-R .. j+LAG-1) and rk2's
// base FIFO (HOLD).
template <class Op>
struct RingShape {
  static constexpr int R = Op::kRadius;
  static constexpr int XLO = Op::kPlaneLo;
  static constexpr int XHI = Op::kPlaneHi;
  static constexpr int NX = XHI - XLO + 1;
  static constexpr int LAG = R > XHI + 1 ? R : XHI + 1;
  static constexpr int SLOTS = NX + 1;
  static constexpr int KEEP = R + LAG;
  static constexpr int HOLD = LAG - R + 1;
  static_assert(R >= 1 && XLO >= -R && XLO <= XHI && XHI <= R,
                "a functor's plane offsets lie within its radius");
};

// fn(std::integral_constant<int, F>) for F in [F0, NF): the field index as
// a compile-time constant, for the operators' `at<F, ...>`
template <int F0, int NF, class Fn>
__device__ __forceinline__ void for_fields(Fn&& fn) {
  if constexpr (F0 < NF) {
    fn(std::integral_constant<int, F0>{});
    for_fields<F0 + 1, NF>(fn);
  }
}

template <class Op, int STAGES, int L, int C, int THREADS, typename E,
          bool CB>
__global__ void __launch_bounds__(THREADS)
    stencil_ring_kernel(const RingArgs<E, Op::kFields> a) {
  using G = RingShape<Op>;
  constexpr int NF = Op::kFields;
  constexpr int NP = Op::kVectors;
  constexpr int NPS = NP > 0 ? NP : 1;   // the cell's zc array, never empty
  constexpr bool RF = CellOf<E>::bf16;  // a field op rounds to bf16
  constexpr bool RC = RF && CB;         // so does a coefficient's
  constexpr int R = G::R;
  constexpr int LAG = G::LAG;
  constexpr int KEEP = G::KEEP;
  constexpr int NS = G::SLOTS;
  constexpr int D = R * L;        // the halo: each level reaches R further
  constexpr int OUT_LAG = LAG * L;  // the output slice trails the loaded one
  constexpr int WS = R + 1 + G::XHI;  // ring index of the slice a level's
                                      // planes take this step (KEEP: nxt)
  constexpr int HP = STAGES == 2 ? L / 2 : 1;   // rk2's level pairs
  extern __shared__ float smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int X = a.X, Y = a.Y, Z = a.Z, S = a.S, W = a.W, P = a.P;
  const int t = blockIdx.x % a.n_ty;
  const int rest = blockIdx.x / a.n_ty;
  const int cz = rest % a.n_cz;
  const int cx = rest / a.n_cz;
  const int b = blockIdx.y;
  const int slab_lo = min(max(t * a.TY - D, 0), Y - S);
  const int own_lo = t * a.TY - slab_lo;              // slab rows owned:
  const int own_hi = own_lo + min(a.TY, Y - t * a.TY);  // [own_lo, own_hi)
  const int z0 = cz * a.CZ;
  const int z1 = min(z0 + a.CZ, Z);
  const int zlo = min(max(z0 - D, 0), Z - W);         // the window's first z
  const int x0 = cx * a.CX;
  const int x1 = min(x0 + a.CX, X);
  const int xs = max(x0 - D, 0);
  const int xe = x1 - 1 + OUT_LAG;
  const int plane = S * P;
  const size_t slice = (size_t)Y * Z;
  const size_t base = (size_t)b * X * slice + (size_t)slab_lo * Z + zlo;
  const E* in[NF];
  E* out[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    in[f] = a.in[f] + base;
    out[f] = a.out[f] + base;
  }
  const typename Op::Coef coef = Op::coef(a.pv, a.p_len);
  const float dt = a.dt;
  const float half_dt = 0.5f * a.dt;
  const float* xmb = a.xm + (size_t)b * a.xm_stride;
  const float* ymb = a.ym + (size_t)b * a.ym_stride + slab_lo;
  float* pz = smem + Op::kHead;      // [NP][W]: the window's z coefficients
  float* planes = pz + NP * W;       // [NS][L][NF][S][P]
  const size_t buf_sz = (size_t)L * NF * plane;
  // z coefficient p of window cell zw is element zoff(p) + z of vector
  // zvec(p), z = zlo + zw, inside the vector for every z (the wrapper pads
  // a generated functor's vectors so that it is; a bounds test here costs
  // the diffusion builds registers)
  for (int i = tid; i < NP * W; i += nt) {
    const int p = i / W;
    pz[i] = a.pv[(size_t)Op::zvec(p) * a.p_len + Op::zoff(p) + zlo
                 + (i - p * W)];
  }

  // this thread's slab row r and window cells z = zt + q*ZS, worked out once
  const int ZS = (W + C - 1) / C;
  const int r = tid / ZS;
  const int zt = tid - r * ZS;
  const bool row_ok = r < S;
  const int dist = r < own_lo ? own_lo - r
                              : (r >= own_hi ? r - own_hi + 1 : 0);
  const bool owned = row_ok && dist == 0;
  // the levels 1..levels at which the row takes a source
  const int levels = row_ok && r >= R && r <= S - 1 - R && ymb[r] > 0.0f
                         ? max(L - (dist + R - 1) / R, 0) : 0;
  // bit q: z in the window; z takes a source; z owned
  unsigned zcell = 0, zsrc = 0, zown = 0;
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int z = zt + q * ZS;
    if (row_ok && z < W) zcell |= 1u << q;
    if (z >= R && z <= W - 1 - R) zsrc |= 1u << q;
    if (owned && z < W && zlo + z >= z0 && zlo + z < z1) zown |= 1u << q;
  }
  const int c0 = r * P + zt;   // plane index of cell 0
  const int g0 = r * Z + zt;   // its offset in a slice of the slab window

  // the ring: per level below L, each field's slices j-R .. j+LAG-1
  // (ring[.][s] is slice j - R + s of the level computing j); nxt is level
  // 0's newest slice, pf the slice loaded ahead; rk2 keeps, per pair of
  // levels, level k-2's slices in hold until full level k reads them
  float ring[L][KEEP][NF][C], nxt[NF][C], pf[NF][C];
  float hold[HP][G::HOLD][NF][C];
#pragma unroll
  for (int q = 0; q < C; ++q) {
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      pf[f][q] = 0.0f;
#pragma unroll
      for (int m = 0; m < HP; ++m) {
#pragma unroll
        for (int h = 0; h < G::HOLD; ++h) hold[m][h][f][q] = 0.0f;
      }
#pragma unroll
      for (int m = 0; m < L; ++m) {
#pragma unroll
        for (int s = 0; s < KEEP; ++s) ring[m][s][f][q] = 0.0f;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < C; ++q) {
    if (zcell >> q & 1u) {
      const size_t off = (size_t)xs * slice + g0 + q * ZS;
#pragma unroll
      for (int f = 0; f < NF; ++f) pf[f][q] = ld_cell(in[f] + off);
    }
  }
  __syncthreads();

  int rot = 0;   // the plane slot of slice j + XLO at this step
  for (int i = xs; i <= xe; ++i) {
#pragma unroll
    for (int q = 0; q < C; ++q) {
#pragma unroll
      for (int f = 0; f < NF; ++f) nxt[f][q] = pf[f][q];
    }
    if (i < xe) {
      const size_t off = (size_t)min(i + 1, X - 1) * slice + g0;
#pragma unroll
      for (int q = 0; q < C; ++q) {
        if (zcell >> q & 1u) {
#pragma unroll
          for (int f = 0; f < NF; ++f)
            pf[f][q] = ld_cell(in[f] + off + q * ZS);
        }
      }
    }
    // this step's plane slots: slices j + XLO .. j + XHI read, j + XHI + 1
    // written (into the slot slice j + XLO - 1 leaves)
    const float* prd[G::NX];
    float* pwr;
    if constexpr (NS == 2) {  // one plane a level read: double-buffered
      prd[0] = planes + rot * buf_sz;
      pwr = planes + (rot ^ 1) * buf_sz;
    } else {
#pragma unroll
      for (int x = 0; x < G::NX; ++x)
        prd[x] = planes + (rot + x < NS ? rot + x : rot + x - NS) * buf_sz;
      pwr = planes + (rot == 0 ? G::NX : rot - 1) * buf_sz;
    }
#pragma unroll
    for (int k = 1; k <= L; ++k) {
      const int j = i - k * LAG;
      const bool x_ok = j >= R && j <= X - 1 - R && j >= x0 - D + k * R &&
                        xmb[j] > 0.0f;
      const bool g_level = STAGES == 2 && k % 2 == 1;     // rk2's g
      const bool full_level = STAGES == 2 && k % 2 == 0;  // base: k-2
      const float step_dt = g_level ? half_dt : dt;
      const size_t lvl = (size_t)(k - 1) * NF * plane;
      float* wl = pwr + lvl;
      float src[NF][C];
#pragma unroll
      for (int q = 0; q < C; ++q) {
#pragma unroll
        for (int f = 0; f < NF; ++f) src[f][q] = 0.0f;
      }
      // an interior row: its neighbour rows and z +- R lie in the planes
      // (the z walls' reads too, into the pitch's pad or the next row)
      if (x_ok && k <= levels) {
#pragma unroll
        for (int q = 0; q < C; ++q) {
          RingCell<NF, NPS, R, G::NX, G::XLO> cell;
#pragma unroll
          for (int f = 0; f < NF; ++f) {
#pragma unroll
            for (int s = 0; s <= 2 * R; ++s)
              cell.xv[s][f] = s < KEEP ? ring[k - 1][s < KEEP ? s : 0][f][q]
                                       : nxt[f][q];
#pragma unroll
            for (int x = 0; x < G::NX; ++x)
              cell.pl[x][f] = prd[x] + lvl + f * plane;
          }
          cell.c = c0 + q * ZS;
          cell.P = P;
#pragma unroll
          for (int p = 0; p < NPS; ++p)
            cell.zc[p] = p < NP ? pz[p * W + zt + q * ZS] : 0.0f;
          const bool zin = zsrc >> q & 1u;
          for_fields<0, NF>([&](auto fc) {
            constexpr int f = decltype(fc)::value;
            // the source in the field's dtype (`astype(base.dtype)`)
            const float s =
                rpk<RF>(Op::template source<f, RF, RC>(cell, coef));
            src[f][q] = zin ? s : 0.0f;
          });
        }
      }
      // level k-1's slice j + XHI + 1 lands in its plane, read from the
      // next step on
#pragma unroll
      for (int q = 0; q < C; ++q) {
        if (zcell >> q & 1u) {
#pragma unroll
          for (int f = 0; f < NF; ++f)
            wl[f * plane + c0 + q * ZS] =
                WS < KEEP ? ring[k - 1][WS < KEEP ? WS : 0][f][q] : nxt[f][q];
        }
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const float res =
              rpk<RF>((full_level ? hold[(k - 2) / 2][0][f][q]
                                  : ring[k - 1][R][f][q])
                      + rpk<RF>(step_dt * src[f][q]));
          // slice j-R of level k-1: the base of level k+1 LAG-R steps on
          if (g_level) {
#pragma unroll
            for (int m = 0; m + 1 < G::HOLD; ++m)
              hold[(k - 1) / 2][m][f][q] = hold[(k - 1) / 2][m + 1][f][q];
            hold[(k - 1) / 2][G::HOLD - 1][f][q] = ring[k - 1][0][f][q];
          }
#pragma unroll
          for (int s = 0; s + 1 < KEEP; ++s)
            ring[k - 1][s][f][q] = ring[k - 1][s + 1][f][q];
          ring[k - 1][KEEP - 1][f][q] = nxt[f][q];
          nxt[f][q] = res;
        }
      }
    }
    // nxt now holds level L at slice i - OUT_LAG
    const int j = i - OUT_LAG;
    if (j >= x0 && zown) {
      const size_t off = (size_t)j * slice + g0;
#pragma unroll
      for (int q = 0; q < C; ++q) {
        if (zown >> q & 1u) {
#pragma unroll
          for (int f = 0; f < NF; ++f)
            st_cell(out[f] + off + q * ZS, nxt[f][q]);
        }
      }
    }
    __syncthreads();
    if constexpr (NS == 2)
      rot ^= 1;
    else
      rot = rot + 1 == NS ? 0 : rot + 1;
  }
}

template <class Op, int STAGES, int L, int C, int N, typename E, bool CB>
int launch(const K6Call& c) {
  constexpr int NF = Op::kFields;
  if (c.nf != NF) return (int)cudaErrorInvalidValue;
  RingArgs<E, NF> a;
  for (int f = 0; f < NF; ++f) {
    a.in[f] = static_cast<const E*>(c.in[f]);
    a.out[f] = static_cast<E*>(c.out[f]);
  }
  a.pv = c.pv;
  a.xm = c.xm;
  a.ym = c.ym;
  a.p_len = c.p_len;
  a.X = c.X;
  a.Y = c.Y;
  a.Z = c.Z;
  a.TY = c.TY;
  a.S = c.S;
  a.n_ty = c.n_ty;
  a.CZ = c.CZ;
  a.W = c.W;
  a.n_cz = c.n_cz;
  a.CX = c.CX;
  a.P = c.P;
  a.xm_stride = c.xm_stride;
  a.ym_stride = c.ym_stride;
  a.dt = c.dt;
  auto kern = stencil_ring_kernel<Op, STAGES, L, C, N, E, CB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(c.n_ty * c.n_cz * c.n_cx, c.B);
  kern<<<grid, c.threads, c.smem_bytes, (cudaStream_t)c.stream>>>(a);
  return (int)cudaGetLastError();
}

// out: registers per thread, local (spill) bytes per thread, the most
// threads a block can have, and resident blocks per SM at (threads, smem)
template <class Op, int STAGES, int L, int C, int N, typename E, bool CB>
int attrs(int threads, size_t smem, int* out) {
  auto kern = stencil_ring_kernel<Op, STAGES, L, C, N, E, CB>;
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

struct Entry {
  int (*launch)(const K6Call&);
  int (*attrs)(int, size_t, int*);
};

// the build of L levels and C cells at N threads, or none where rk2's L is
// odd, L is past the functor's LMAX or the table builds no C (N = 0)
template <class Op, int STAGES, int L, int C, int N, typename E, bool CB,
          int LMAX>
constexpr Entry entry() {
  if constexpr (L % STAGES == 0 && N > 0 && L <= LMAX)
    return {launch<Op, STAGES, L, C, N, E, CB>,
            attrs<Op, STAGES, L, C, N, E, CB>};
  else
    return {nullptr, nullptr};
}

// one functor's builds, row L - 1: L levels for C = 2 (at N2 threads) and
// C = 4 (at N4), up to LMAX levels
using Table = std::array<std::array<Entry, 2>, K6_MAX_LEVELS>;
template <class Op, int STAGES, int N2, int N4, typename E, bool CB,
          int LMAX, int... I>
constexpr Table table(std::integer_sequence<int, I...>) {
  return {{std::array<Entry, 2>{
      {entry<Op, STAGES, I + 1, 2, N2, E, CB, LMAX>(),
       entry<Op, STAGES, I + 1, 4, N4, E, CB, LMAX>()}}...}};
}
constexpr auto kLevels = std::make_integer_sequence<int, K6_MAX_LEVELS>{};

// the entry of T steps at `stages` and C cells in `tables` (one Table per
// stages, 1 and 2), or null
inline const Entry* pick(const Table* tables, int stages, int T, int C) {
  const int L = stages * T;
  const int ci = C == 2 ? 0 : C == 4 ? 1 : -1;
  if (stages < 1 || stages > 2 || T < 1 || L > K6_MAX_LEVELS || ci < 0)
    return nullptr;
  const Entry* e = &tables[stages - 1][L - 1][ci];
  return e->launch ? e : nullptr;
}

// an entry point's launch and attribute calls: cudaErrorInvalidValue for
// a functor, integrator, depth, C or field count the library was not built
// for, else the cudaError_t of the attribute call or of the launch
inline int k6_launch(const Entry* e, const K6Call* c) {
  return e ? e->launch(*c) : (int)cudaErrorInvalidValue;
}
inline int k6_attrs(const Entry* e, int threads, size_t smem, int* out) {
  return e ? e->attrs(threads, smem, out) : (int)cudaErrorInvalidValue;
}

// --- the shipped functors ----------------------------------------------------

// functor id (`spec.cuda_op`) -> functor
template <int OP>
struct OpOf;
template <>
struct OpOf<0> { using type = PwFluxOp<3>; };
template <>
struct OpOf<1> { using type = PwFluxOp<4>; };
template <>
struct OpOf<2> { using type = DiffusionOp; };

#define K6_VECTORS(OP, N)                                 \
  static_assert(OpOf<OP>::type::kVectors == N,           \
                "_build.K6_COEF_VECTORS disagrees with the functor");
K6_COEF_VECTORS(K6_VECTORS)
#undef K6_VECTORS

// the launch bound of each build of the table; 0: not built
template <int OP, int STAGES, int C>
struct Bounds { static constexpr int threads = 0; };
#define K6_BOUND(OP, STAGES, C, N) \
  template <>                      \
  struct Bounds<OP, STAGES, C> { static constexpr int threads = N; };
K6_BUILDS(K6_BOUND)
#undef K6_BOUND

template <int OP, int STAGES, typename E, bool CB>
constexpr Table shipped_table() {
  return table<typename OpOf<OP>::type, STAGES, Bounds<OP, STAGES, 2>::threads,
               Bounds<OP, STAGES, 4>::threads, E, CB, K6_MAX_LEVELS>(kLevels);
}

// the build of one storage (E, CB) that runs T steps of (op, stages) at C
// cells, or null
template <typename E, bool CB>
const Entry* find_shipped(int op, int stages, int T, int C) {
  static const Table kTables[3][2] = {
      {shipped_table<0, 1, E, CB>(), shipped_table<0, 2, E, CB>()},
      {shipped_table<1, 1, E, CB>(), shipped_table<1, 2, E, CB>()},
      {shipped_table<2, 1, E, CB>(), shipped_table<2, 2, E, CB>()}};
  if (op < 0 || op > 2) return nullptr;
  return pick(kTables[op], stages, T, C);
}

}  // namespace

// Every K6 entry point, each source's own name in front:
//   int <name>(int op, int stages, const K6Call* call)
// op (0 = PW (u, v, w), 1 = tracer (u, v, w, q), 2 = diffusion (phi); a
// generated build takes 0), stages (1 = euler, 2 = rk2), the call's
// arguments; returns `k6_launch`'s code. Its attributes entry,
//   int <name>_attrs(int op, int stages, int T, int C, int threads,
//                    size_t smem_bytes, int* out),
// writes out[4]: registers, local bytes per thread, max threads per block
// and resident blocks per SM of the (op, stages, T, C) build at (threads,
// smem).
