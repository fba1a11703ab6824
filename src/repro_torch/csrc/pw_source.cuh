// What the v1-v3 rung kernels (advect_blocked.cu, advect_dataflow.cu)
// share: the PW sources of a run of cells, and the cp.async moves that
// stage their slabs in shared memory ahead of the compute.
//
// The arithmetic is the reference's `_source_slices`
// (src/repro/kernels/advection/advection.py:119): src = fx + fy + fz, each
// term parenthesised as there. Built with --fmad=false, every product and sum
// rounds on its own, as PyTorch's elementwise ops round them in the plain
// version, so a kernel that uses this equals its plain version bitwise.
//
// A cell is E: a float, or an __nv_bfloat16 for bf16 fields. cp.async moves
// bytes without converting them, so a bf16 kernel's shared stages hold bf16
// cells as loaded, and its reads widen them exactly. A bf16 op of the
// reference rounds to bf16 here (`rnd`, cells.cuh): sums and products of
// field values, and products with a coefficient where the coefficients are
// bf16 too (CB); the source is rounded to the field's dtype before the
// epilogue writes it or folds it into `cen + dt * src` in bf16, as the
// reference's `_emit_tile_outputs` does.
//
// VEC is the cells one move carries: 1 (one cell) or one 16-byte vector
// (VEC = 4 f32 or 8 bf16 cells, v3 `wide`).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "cells.cuh"

// The three slices a cell's stencil reads: s[f][k] is field f (u, v, w) at
// x-1 (k = 0), x (k = 1) and x+1 (k = 2), each an (S, Z) slab in shared
// memory.
template <typename E>
struct RungSlices {
  const E* s[3][3];
};

// ---------------------------------------------------------------------------
// loads ahead: cp.async into shared memory, one commit group per stage
// ---------------------------------------------------------------------------

// One BYTES-byte word from device memory to shared memory, in flight until a
// wait: 4 bytes through L1 (.ca), or 16 bytes around it (.cg), the widths of
// the paper's 64- and 256-bit ports on this card.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's commit groups are in flight:
// none, or one where `pending` >= 1 (the instruction takes an immediate;
// waiting for more than asked is still right).
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy n cells (n % VEC == 0; both ends VEC cells aligned) from src to dst,
// the block's threads on consecutive words. A move is VEC cells: 4 or 16
// bytes. One bf16 cell (2 bytes) is below cp.async's least width, so the
// bf16 VEC = 1 build moves pairs of cells in 4-byte words where both ends
// of the plane are 4-byte aligned and n is even, and otherwise copies cell
// by cell through registers (visible, as cp.async's stores are, after the
// block's next barrier).
template <typename E, int VEC>
__device__ __forceinline__ void cp_async_plane(E* dst, const E* src, int n) {
  constexpr int BYTES = VEC * (int)sizeof(E);
  if constexpr (BYTES >= 4) {
    for (int k = threadIdx.x * VEC; k < n; k += blockDim.x * VEC)
      cp_async<BYTES>(dst + k, src + k);
  } else {
    if (((((uintptr_t)dst) | ((uintptr_t)src)) & 3) == 0 && n % 2 == 0) {
      for (int k = threadIdx.x * 2; k < n; k += blockDim.x * 2)
        cp_async<4>(dst + k, src + k);
    } else {
      for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = src[k];
    }
  }
}

// ---------------------------------------------------------------------------
// VEC consecutive cells of one slab row, read from shared memory
// ---------------------------------------------------------------------------

// A whole 16-byte word of shared memory, kept 16 bytes wide even where one
// lane of it is used (a narrowed 4-byte load at a 16-byte stride would take
// a warp four passes over the banks).
__device__ __forceinline__ uint4 lds128(const void* p) {
  uint4 q;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(q.x), "=r"(q.y), "=r"(q.z), "=r"(q.w)
               : "r"((unsigned)__cvta_generic_to_shared(p)));
  return q;
}

// cell e (0 .. 16 / sizeof(E) - 1) of a 16-byte word, widened
template <typename E>
__device__ __forceinline__ float word_cell(const uint4& q, int e) {
  const unsigned w = e * (int)sizeof(E) / 4 == 0   ? q.x
                     : e * (int)sizeof(E) / 4 == 1 ? q.y
                     : e * (int)sizeof(E) / 4 == 2 ? q.z
                                                   : q.w;
  if constexpr (CellOf<E>::bf16)
    return e % 2 ? bf16_hi(w) : bf16_lo(w);
  else
    return __uint_as_float(w);
}

// VEC = 1: one cell. VEC = 16 / sizeof(E): one 16-byte load, which a warp
// makes without bank conflicts (consecutive threads on consecutive 16-byte
// words).
template <typename E, int VEC>
__device__ __forceinline__ void lds(const E* p, float (&o)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (CellOf<E>::bf16)
      o[0] = __bfloat162float(*p);
    else
      o[0] = *p;
  } else if constexpr (!CellOf<E>::bf16) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    o[0] = q.x, o[1] = q.y, o[2] = q.z, o[3] = q.w;
  } else {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = word_cell<E>(q, e);
  }
}

// The z - 1 and z + 1 neighbours of the cells at p[0..VEC), whose own
// values are g: VEC = 1 reads p[-1] and p[1]; a 16-byte VEC takes the middle
// ones from g and the two ends from the 16-byte words on each side.
template <typename E, int VEC>
__device__ __forceinline__ void lds_z_sides(const E* p,
                                            const float (&g)[VEC],
                                            float (&lo)[VEC],
                                            float (&hi)[VEC]) {
  if constexpr (VEC == 1) {
    float a[1], b[1];
    lds<E, 1>(p - 1, a);
    lds<E, 1>(p + 1, b);
    lo[0] = a[0];
    hi[0] = b[0];
  } else {
    lo[0] = word_cell<E>(lds128(p - VEC), VEC - 1);
    hi[VEC - 1] = word_cell<E>(lds128(p + VEC), 0);
#pragma unroll
    for (int e = 1; e < VEC; ++e) lo[e] = g[e - 1];
#pragma unroll
    for (int e = 0; e < VEC - 1; ++e) hi[e] = g[e + 1];
  }
}

// VEC floats of a read-only row in device memory (the parameter row), in
// 16-byte loads where VEC > 1.
template <int VEC>
__device__ __forceinline__ void ldg_row(const float* p, float (&o)[VEC]) {
  if constexpr (VEC == 1) {
    o[0] = __ldg(p);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + e));
      o[e] = q.x, o[e + 1] = q.y, o[e + 2] = q.z, o[e + 3] = q.w;
    }
  }
}

// The rungs' parameter row is [tcx, tcy, 0, 0, tzc1(Z), tzc2(Z)] in f32 (the
// bf16 values of bf16 coefficients): the z vectors start 16 bytes in, so with
// Z a multiple of VEC every VEC-cell run of them is whole aligned 16-byte
// words.
struct RungParams {
  float tcx, tcy;
  const float* tzc1;
  const float* tzc2;
};

template <int VEC>
__device__ __forceinline__ RungParams rung_params(const float* row, int Z) {
  if constexpr (VEC > 1) {
    const float4 head = __ldg(reinterpret_cast<const float4*>(row));
    return {head.x, head.y, row + 4, row + 4 + Z};
  } else {
    return {__ldg(row), __ldg(row + 1), row + 4, row + 4 + Z};
  }
}

template <typename E, int VEC>
__device__ __forceinline__ void store_cells(E* p, const float (&o)[VEC]) {
  if constexpr (VEC == 1) {
    st_cell(p, o[0]);
  } else if constexpr (!CellOf<E>::bf16) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(bf16_pack(o[0], o[1]), bf16_pack(o[2], o[3]),
                   bf16_pack(o[4], o[5]), bf16_pack(o[6], o[7]));
  }
}

// ---------------------------------------------------------------------------
// the PW sources of VEC consecutive cells
// ---------------------------------------------------------------------------

// Write, for each field f, `interior ? src : 0` (sources) or
// `cen + dt * (interior ? src : 0)` (`fuse`) of the VEC cells of slab row r
// that start at slab cell c0 = r * Z + z0, to out[f] + dst. `row_ok`: the
// slice is x-interior and r is not a slab edge row (a domain wall or a cut
// edge, >= 1 row from every owned row); a cell is interior where also
// 1 <= z <= Z - 2. A select and never a multiply: only the select walls off
// what a cell that is not interior would read. Where `row_ok` is false
// nothing but the cells' own values is read, so ring slots that were never
// loaded (x = -1, x = X) and rows outside the slab stay unread. With bf16
// cells (RF) the ops round as the reference's do; CB: bf16 coefficients.
template <typename E, bool CB, int VEC>
__device__ __forceinline__ void rung_cells(
    const RungSlices<E>& sl, int c0, int z0, bool row_ok, int Z,
    const RungParams& pr, bool fuse, float dt, E* const (&out)[3],
    size_t dst) {
  constexpr bool RF = CellOf<E>::bf16;
  constexpr bool RC = RF && CB;
  float o[VEC], g[VEC];
  if (!row_ok) {
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      lds<E, VEC>(sl.s[f][1] + c0, g);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o[e] = fuse ? rnd<RF>(g[e] + rnd<RF>(dt * 0.0f)) : 0.0f;
      store_cells<E, VEC>(out[f] + dst, o);
    }
    return;
  }
  bool in[VEC];
  float t1[VEC], t2[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) in[e] = z0 + e >= 1 && z0 + e <= Z - 2;
  ldg_row<VEC>(pr.tzc1 + z0, t1);
  ldg_row<VEC>(pr.tzc2 + z0, t2);
  const float tcx = pr.tcx, tcy = pr.tcy;
  const E* wc = sl.s[2][1] + c0;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const E* fc = sl.s[f][1] + c0;
    float a[VEC], b[VEC], fx[VEC], fy[VEC];
    lds<E, VEC>(fc, g);
    // fx: the x neighbours, weighted by u at x -+ 1
    {
      float um[VEC], up[VEC];
      lds<E, VEC>(sl.s[f][0] + c0, a);
      lds<E, VEC>(sl.s[f][2] + c0, b);
      lds<E, VEC>(sl.s[0][0] + c0, um);
      lds<E, VEC>(sl.s[0][2] + c0, up);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        fx[e] = rnd<RC>(tcx * rnd<RF>(rnd<RF>(um[e] * rnd<RF>(g[e] + a[e])) -
                                      rnd<RF>(up[e] * rnd<RF>(g[e] + b[e]))));
    }
    // fy: the y neighbours, weighted by v at y -+ 1
    {
      float vn[VEC], vs[VEC];
      lds<E, VEC>(fc - Z, a);
      lds<E, VEC>(fc + Z, b);
      lds<E, VEC>(sl.s[1][1] + c0 - Z, vn);
      lds<E, VEC>(sl.s[1][1] + c0 + Z, vs);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        fy[e] = rnd<RC>(tcy * rnd<RF>(rnd<RF>(vn[e] * rnd<RF>(g[e] + a[e])) -
                                      rnd<RF>(vs[e] * rnd<RF>(g[e] + b[e]))));
    }
    // fz: the z neighbours, weighted by w at z -+ 1
    {
      float w0[VEC], wl[VEC], wr[VEC];
      lds_z_sides<E, VEC>(fc, g, a, b);
      lds<E, VEC>(wc, w0);
      lds_z_sides<E, VEC>(wc, w0, wl, wr);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float fz =
            rnd<RC>(rnd<RC>(rnd<RC>(t1[e] * wl[e]) * rnd<RF>(g[e] + a[e])) -
                    rnd<RC>(rnd<RC>(t2[e] * wr[e]) * rnd<RF>(g[e] + b[e])));
        const float src =
            in[e] ? rnd<RF>(rnd<RC>(rnd<RC>(fx[e] + fy[e]) + fz)) : 0.0f;
        o[e] = fuse ? rnd<RF>(g[e] + rnd<RF>(dt * src)) : src;
      }
    }
    store_cells<E, VEC>(out[f] + dst, o);
  }
}
