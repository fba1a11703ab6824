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
// cells as loaded. A bf16 op of the reference rounds to bf16 here: sums and
// products of field values, and products with a coefficient where the
// coefficients are bf16 too (CB); the source is rounded to the field's
// dtype before the epilogue writes it or folds it into `cen + dt * src` in
// bf16, as the reference's `_emit_tile_outputs` does. Two builds do it:
// - pairs (`rung_pairs`): a thread computes the cells z, z + 1 of one
//   32-bit word of shared memory (W words a run: 1, or 4 for `wide`'s
//   16-byte moves), each bf16 op of both cells one bf16x2 instruction
//   (cells.cuh). With f32 coefficients the products by a coefficient and
//   the sums after them stay f32 ops on the widened lanes, and the source
//   rounds by one paired convert. It needs Z even and every field on a
//   4-byte boundary, which the wrapper checks;
// - one cell (`rung_cells`), the f32 build and the bf16 build where the
//   pairs cannot run (odd Z, or a field off a 4-byte boundary): each op in
//   f32, each bf16 op rounded by `rpk` (cells.cuh).
//
// VEC is the cells one move carries: 1 (one cell), 2 (one bf16 pair) or one
// 16-byte vector (VEC = 4 f32 or 8 bf16 cells, v3 `wide`).
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

// VEC = 1: one cell, widened. VEC = 4 (f32): one 16-byte load, which a
// warp makes without bank conflicts (consecutive threads on consecutive
// 16-byte words).
template <typename E, int VEC>
__device__ __forceinline__ void lds(const E* p, float (&o)[VEC]) {
  static_assert(VEC == 1 || !CellOf<E>::bf16, "bf16 runs are pairs");
  if constexpr (VEC == 1) {
    if constexpr (CellOf<E>::bf16)
      o[0] = __bfloat162float(*p);
    else
      o[0] = *p;
  } else {
    const float4 q = *reinterpret_cast<const float4*>(p);
    o[0] = q.x, o[1] = q.y, o[2] = q.z, o[3] = q.w;
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
    lo[0] = __uint_as_float(lds128(p - VEC).w);
    hi[VEC - 1] = __uint_as_float(lds128(p + VEC).x);
#pragma unroll
    for (int e = 1; e < VEC; ++e) lo[e] = g[e - 1];
#pragma unroll
    for (int e = 0; e < VEC - 1; ++e) hi[e] = g[e + 1];
  }
}

// VEC floats of a read-only row in device memory (the parameter row): one
// load, an 8-byte one for a pair, or 16-byte loads where VEC is a multiple
// of 4.
template <int VEC>
__device__ __forceinline__ void ldg_row(const float* p, float (&o)[VEC]) {
  if constexpr (VEC == 1) {
    o[0] = __ldg(p);
  } else if constexpr (VEC == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = q.x, o[1] = q.y;
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
// Z a multiple of VEC every VEC-cell run of them is whole aligned 8- or
// 16-byte words.
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
  if constexpr (VEC > 1) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else if constexpr (CellOf<E>::bf16) {
    // a bf16 value already (`rpk`'s, or zero): its high half
    *p = __ushort_as_bfloat16((unsigned short)(__float_as_uint(o[0]) >> 16));
  } else {
    st_cell(p, o[0]);
  }
}

// ---------------------------------------------------------------------------
// the PW sources of VEC consecutive cells, one cell at a time
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
        o[e] = fuse ? rpk<RF>(g[e] + rpk<RF>(dt * 0.0f)) : 0.0f;
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
  // the z weights t1 * w(z - 1) and t2 * w(z + 1), the same for the three
  // fields: once where VEC > 1 (the f32 16-byte build, which spilled 8 B
  // taking them in each field's loop), in each field's loop where VEC = 1
  float tw1[VEC], tw2[VEC];
  if constexpr (VEC > 1) {
    float w0[VEC], wl[VEC], wr[VEC];
    lds<E, VEC>(wc, w0);
    lds_z_sides<E, VEC>(wc, w0, wl, wr);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      tw1[e] = rpk<RC>(t1[e] * wl[e]);
      tw2[e] = rpk<RC>(t2[e] * wr[e]);
    }
  }
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
        fx[e] = rpk<RC>(tcx * rpk<RF>(rpk<RF>(um[e] * rpk<RF>(g[e] + a[e])) -
                                      rpk<RF>(up[e] * rpk<RF>(g[e] + b[e]))));
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
        fy[e] = rpk<RC>(tcy * rpk<RF>(rpk<RF>(vn[e] * rpk<RF>(g[e] + a[e])) -
                                      rpk<RF>(vs[e] * rpk<RF>(g[e] + b[e]))));
    }
    // fz: the z neighbours, weighted by w at z -+ 1
    {
      lds_z_sides<E, VEC>(fc, g, a, b);
      if constexpr (VEC == 1) {
        float w0[VEC], wl[VEC], wr[VEC];
        lds<E, VEC>(wc, w0);
        lds_z_sides<E, VEC>(wc, w0, wl, wr);
        tw1[0] = rpk<RC>(t1[0] * wl[0]);
        tw2[0] = rpk<RC>(t2[0] * wr[0]);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float fz = rpk<RC>(rpk<RC>(tw1[e] * rpk<RF>(g[e] + a[e])) -
                                 rpk<RC>(tw2[e] * rpk<RF>(g[e] + b[e])));
        const float src =
            in[e] ? rpk<RF>(rpk<RC>(rpk<RC>(fx[e] + fy[e]) + fz)) : 0.0f;
        o[e] = fuse ? rpk<RF>(g[e] + rpk<RF>(dt * src)) : src;
      }
    }
    store_cells<E, VEC>(out[f] + dst, o);
  }
}

// ---------------------------------------------------------------------------
// the PW sources of bf16 cells two a 32-bit word
// ---------------------------------------------------------------------------

using Bf16 = __nv_bfloat16;

// A run's three fields one after another, unrolled so that their loads
// interleave, except in `wide` (W = 4) with f32 coefficients: its sixteen
// f32 z weights a thread leave too few of the 64 registers its launch bound
// allows for three fields at once (that build spilled 20 B unrolled, and
// runs in 61 registers rolled).
template <bool CB, int W>
constexpr int kPairFieldUnroll = W == 4 && !CB ? 1 : 3;

// W consecutive 32-bit words of a bf16 plane in shared memory at p (a word
// boundary): 2W cells, one 4-byte load, or one 16-byte load where W = 4.
template <int W>
__device__ __forceinline__ void lds_words(const Bf16* p, unsigned (&o)[W]) {
  static_assert(W == 1 || W == 4, "a 4- or a 16-byte load");
  if constexpr (W == 1) {
    o[0] = *reinterpret_cast<const unsigned*>(p);
  } else {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    o[0] = q.x, o[1] = q.y, o[2] = q.z, o[3] = q.w;
  }
}

// The z - 1 and z + 1 neighbours of the words at p, whose own words are g,
// as words: (z - 1, z) is the high half of the word before and the low half
// of its own, (z + 1, z + 2) its high half and the low half of the word
// after, one byte permutation each. W = 1 reads the words on each side; W =
// 4 the 16-byte words on each side, kept 16 bytes wide (`lds128`).
template <int W>
__device__ __forceinline__ void lds_z_pairs(const Bf16* p,
                                            const unsigned (&g)[W],
                                            unsigned (&lo)[W],
                                            unsigned (&hi)[W]) {
  unsigned before, after;
  if constexpr (W == 1) {
    before = *reinterpret_cast<const unsigned*>(p - 2);
    after = *reinterpret_cast<const unsigned*>(p + 2);
  } else {
    before = lds128(p - 2 * W).w;
    after = lds128(p + 2 * W).x;
  }
  lo[0] = __byte_perm(before, g[0], 0x5432);
#pragma unroll
  for (int i = 1; i < W; ++i) lo[i] = __byte_perm(g[i - 1], g[i], 0x5432);
#pragma unroll
  for (int i = 0; i < W - 1; ++i) hi[i] = __byte_perm(g[i], g[i + 1], 0x5432);
  hi[W - 1] = __byte_perm(g[W - 1], after, 0x5432);
}

// W words to device memory at p: one 4-byte store, or one 16-byte store
template <int W>
__device__ __forceinline__ void store_words(Bf16* p, const unsigned (&o)[W]) {
  if constexpr (W == 1)
    *reinterpret_cast<unsigned*>(p) = o[0];
  else
    *reinterpret_cast<uint4*>(p) = make_uint4(o[0], o[1], o[2], o[3]);
}

// lane h of a word, widened exactly
__device__ __forceinline__ float lane(unsigned word, int h) {
  return h ? bf16_hi(word) : bf16_lo(word);
}

// The interior mask of the word of cells z, z + 1 (z even): 0xffff in each
// half whose cell lies at 1 <= z <= Z - 2.
__device__ __forceinline__ unsigned interior_mask(int z, int Z) {
  return (z >= 1 && z <= Z - 2 ? 0x0000ffffu : 0u) |
         (z + 1 <= Z - 2 ? 0xffff0000u : 0u);
}

// `rung_cells` of the 2W bf16 cells of slab row r from slab cell
// c0 = r * Z + z0, z0 even: the same values, bitwise, each bf16 op of two
// cells one bf16x2 instruction (cells.cuh). The z weights tzc1 * w(z - 1)
// and tzc2 * w(z + 1) are the same for the three fields, so they are
// computed once. The interior select is a mask a half (a cell that is not
// interior gets +0, as the select gives it), and where `row_ok` is false
// each cell is `g + dt * (+0)` in bf16, as there.
template <bool CB, int W>
__device__ __forceinline__ void rung_pairs(
    const RungSlices<Bf16>& sl, int c0, int z0, bool row_ok, int Z,
    const RungParams& pr, bool fuse, float dt, Bf16* const (&out)[3],
    size_t dst) {
  const unsigned dt2 = bf16_pack(dt, dt);  // exact: dt is a bf16 value
  unsigned o[W], g[W];
  if (!row_ok) {
    const unsigned step0 = b2_mul(dt2, 0u);
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      lds_words<W>(sl.s[f][1] + c0, g);
#pragma unroll
      for (int i = 0; i < W; ++i) o[i] = fuse ? b2_add(g[i], step0) : 0u;
      store_words<W>(out[f] + dst, o);
    }
    return;
  }
  const float tcx = pr.tcx, tcy = pr.tcy;
  // bf16 coefficients as words (exact: they are bf16 values)
  const unsigned tcx2 = bf16_pack(tcx, tcx), tcy2 = bf16_pack(tcy, tcy);
  // the z weights: bf16 ops with bf16 coefficients (cw), else f32 products
  // of the widened lanes (fw)
  unsigned cw1[W], cw2[W];
  float fw1[2 * W], fw2[2 * W];
  {
    float t1[2 * W], t2[2 * W];
    unsigned w0[W], wl[W], wr[W];
    ldg_row<2 * W>(pr.tzc1 + z0, t1);
    ldg_row<2 * W>(pr.tzc2 + z0, t2);
    lds_words<W>(sl.s[2][1] + c0, w0);
    lds_z_pairs<W>(sl.s[2][1] + c0, w0, wl, wr);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if constexpr (CB) {
        cw1[i] = b2_mul(bf16_pack(t1[2 * i], t1[2 * i + 1]), wl[i]);
        cw2[i] = b2_mul(bf16_pack(t2[2 * i], t2[2 * i + 1]), wr[i]);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          fw1[2 * i + h] = t1[2 * i + h] * lane(wl[i], h);
          fw2[2 * i + h] = t2[2 * i + h] * lane(wr[i], h);
        }
      }
    }
  }
  // field f's planes lie f field strides past field 0's, in both kernels
  const ptrdiff_t fs = sl.s[1][1] - sl.s[0][1];
#pragma unroll (kPairFieldUnroll<CB, W>)
  for (int f = 0; f < 3; ++f) {
    const Bf16* fc = sl.s[0][1] + f * fs + c0;
    unsigned a[W], b[W], dx[W], dy[W];
    lds_words<W>(fc, g);
    // the x neighbours, weighted by u at x -+ 1 (before the coefficient)
    {
      unsigned um[W], up[W];
      lds_words<W>(sl.s[0][0] + f * fs + c0, a);
      lds_words<W>(sl.s[0][2] + f * fs + c0, b);
      lds_words<W>(sl.s[0][0] + c0, um);
      lds_words<W>(sl.s[0][2] + c0, up);
#pragma unroll
      for (int i = 0; i < W; ++i)
        dx[i] = b2_sub(b2_mul(um[i], b2_add(g[i], a[i])),
                       b2_mul(up[i], b2_add(g[i], b[i])));
    }
    // the y neighbours, weighted by v at y -+ 1
    {
      unsigned vn[W], vs[W];
      lds_words<W>(fc - Z, a);
      lds_words<W>(fc + Z, b);
      lds_words<W>(sl.s[1][1] + c0 - Z, vn);
      lds_words<W>(sl.s[1][1] + c0 + Z, vs);
#pragma unroll
      for (int i = 0; i < W; ++i) {
        dy[i] = b2_sub(b2_mul(vn[i], b2_add(g[i], a[i])),
                       b2_mul(vs[i], b2_add(g[i], b[i])));
        if constexpr (CB)  // fx + fy, which frees dy
          dx[i] = b2_add(b2_mul(tcx2, dx[i]), b2_mul(tcy2, dy[i]));
      }
    }
    // the z neighbours; the source and the update
    lds_z_pairs<W>(fc, g, a, b);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const unsigned ga = b2_add(g[i], a[i]), gb = b2_add(g[i], b[i]);
      unsigned src;
      if constexpr (CB) {
        src = b2_add(dx[i], b2_sub(b2_mul(cw1[i], ga), b2_mul(cw2[i], gb)));
      } else {
        float s[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float fx = tcx * lane(dx[i], h);
          const float fy = tcy * lane(dy[i], h);
          const float fz = fw1[2 * i + h] * lane(ga, h) -
                           fw2[2 * i + h] * lane(gb, h);
          s[h] = fx + fy + fz;
        }
        src = bf16_pack(s[0], s[1]);
      }
      src &= interior_mask(z0 + 2 * i, Z);
      o[i] = fuse ? b2_add(g[i], b2_mul(dt2, src)) : src;
    }
    store_words<W>((f == 0 ? out[0] : f == 1 ? out[1] : out[2]) + dst, o);
  }
}

// The rungs' compute of the VEC cells of slab row r from slab cell c0: the
// pair build where bf16 cells come in words (VEC >= 2), else `rung_cells`.
template <typename E, bool CB, int VEC>
__device__ __forceinline__ void rung_run(const RungSlices<E>& sl, int c0,
                                         int z0, bool row_ok, int Z,
                                         const RungParams& pr, bool fuse,
                                         float dt, E* const (&out)[3],
                                         size_t dst) {
  if constexpr (CellOf<E>::bf16 && VEC > 1)
    rung_pairs<CB, VEC / 2>(sl, c0, z0, row_ok, Z, pr, fuse, dt, out, dst);
  else
    rung_cells<E, CB, VEC>(sl, c0, z0, row_ok, Z, pr, fuse, dt, out, dst);
}
