// What the v1-v3 rung kernels (advect_blocked.cu, advect_dataflow.cu)
// share: the PW sources of a run of cells, and the cp.async moves that
// stage their slabs in shared memory ahead of the compute.
//
// The arithmetic is the reference's `_source_slices`
// (src/repro/kernels/advection/advection.py:119): src = fx + fy + fz, each
// term parenthesised as there. Built with --fmad=false, every product and sum
// rounds on its own, as PyTorch's elementwise ops round them in the plain
// version, so a kernel that uses this equals its plain version bitwise.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

// The three slices a cell's stencil reads: s[f][k] is field f (u, v, w) at
// x-1 (k = 0), x (k = 1) and x+1 (k = 2), each an (S, Z) slab in shared
// memory.
struct RungSlices {
  const float* s[3][3];
};

// ---------------------------------------------------------------------------
// loads ahead: cp.async into shared memory, one commit group per stage
// ---------------------------------------------------------------------------

// One VEC-float word from device memory to shared memory, in flight until a
// wait: 4 bytes through L1 (.ca) for VEC = 1, 16 bytes around it (.cg) for
// VEC = 4, the widths of the paper's 64- and 256-bit ports on this card.
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (VEC == 4)
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

// Copy n floats (n % VEC == 0; both ends VEC * 4-byte aligned) from src to
// dst, the block's threads on consecutive words.
template <int VEC>
__device__ __forceinline__ void cp_async_plane(float* dst, const float* src,
                                               int n) {
  for (int k = threadIdx.x * VEC; k < n; k += blockDim.x * VEC)
    cp_async<VEC>(dst + k, src + k);
}

// ---------------------------------------------------------------------------
// VEC consecutive cells of one slab row, read from shared memory
// ---------------------------------------------------------------------------

// VEC = 1: one float. VEC = 4: one 16-byte load, which a warp makes without
// bank conflicts (consecutive threads on consecutive 16-byte words).
template <int VEC>
__device__ __forceinline__ void lds(const float* p, float (&o)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    o[0] = q.x, o[1] = q.y, o[2] = q.z, o[3] = q.w;
  } else {
    o[0] = *p;
  }
}

// A whole 16-byte word of shared memory, kept 16 bytes wide even where one
// lane of it is used (a narrowed 4-byte load at a 16-byte stride would take
// a warp four passes over the banks).
__device__ __forceinline__ float4 lds128(const float* p) {
  float4 q;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(q.x), "=f"(q.y), "=f"(q.z), "=f"(q.w)
               : "r"((unsigned)__cvta_generic_to_shared(p)));
  return q;
}

// The z - 1 and z + 1 neighbours of the cells at p[0..VEC), whose own
// values are g: VEC = 1 reads p[-1] and p[1]; VEC = 4 takes the middle ones
// from g and the two ends from the 16-byte words on each side.
template <int VEC>
__device__ __forceinline__ void lds_z_sides(const float* p,
                                            const float (&g)[VEC],
                                            float (&lo)[VEC],
                                            float (&hi)[VEC]) {
  if constexpr (VEC == 4) {
    lo[0] = lds128(p - 4).w, lo[1] = g[0], lo[2] = g[1], lo[3] = g[2];
    hi[0] = g[1], hi[1] = g[2], hi[2] = g[3], hi[3] = lds128(p + 4).x;
  } else {
    lo[0] = p[-1];
    hi[0] = p[1];
  }
}

// VEC floats of a read-only row in device memory (the parameter row),
// 16 bytes in one load for VEC = 4.
template <int VEC>
__device__ __forceinline__ void ldg_row(const float* p, float (&o)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = q.x, o[1] = q.y, o[2] = q.z, o[3] = q.w;
  } else {
    o[0] = __ldg(p);
  }
}

// The rungs' parameter row is [tcx, tcy, 0, 0, tzc1(Z), tzc2(Z)]: the z
// vectors start 16 bytes in, so with Z % 4 == 0 every VEC-cell run of them
// is one aligned VEC-float word.
struct RungParams {
  float tcx, tcy;
  const float* tzc1;
  const float* tzc2;
};

template <int VEC>
__device__ __forceinline__ RungParams rung_params(const float* row, int Z) {
  if constexpr (VEC == 4) {
    const float4 head = __ldg(reinterpret_cast<const float4*>(row));
    return {head.x, head.y, row + 4, row + 4 + Z};
  } else {
    return {__ldg(row), __ldg(row + 1), row + 4, row + 4 + Z};
  }
}

template <int VEC>
__device__ __forceinline__ void store_cells(float* p, const float (&o)[VEC]) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  else
    *p = o[0];
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
// loaded (x = -1, x = X) and rows outside the slab stay unread.
template <int VEC>
__device__ __forceinline__ void rung_cells(
    const RungSlices& sl, int c0, int z0, bool row_ok, int Z,
    const RungParams& pr, bool fuse, float dt, float* const (&out)[3],
    size_t dst) {
  float o[VEC], g[VEC];
  if (!row_ok) {
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      lds<VEC>(sl.s[f][1] + c0, g);
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = fuse ? g[e] + dt * 0.0f : 0.0f;
      store_cells<VEC>(out[f] + dst, o);
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
  const float* wc = sl.s[2][1] + c0;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const float* fc = sl.s[f][1] + c0;
    float a[VEC], b[VEC], fx[VEC], fy[VEC];
    lds<VEC>(fc, g);
    // fx: the x neighbours, weighted by u at x -+ 1
    {
      float um[VEC], up[VEC];
      lds<VEC>(sl.s[f][0] + c0, a);
      lds<VEC>(sl.s[f][2] + c0, b);
      lds<VEC>(sl.s[0][0] + c0, um);
      lds<VEC>(sl.s[0][2] + c0, up);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        fx[e] = tcx * (um[e] * (g[e] + a[e]) - up[e] * (g[e] + b[e]));
    }
    // fy: the y neighbours, weighted by v at y -+ 1
    {
      float vn[VEC], vs[VEC];
      lds<VEC>(fc - Z, a);
      lds<VEC>(fc + Z, b);
      lds<VEC>(sl.s[1][1] + c0 - Z, vn);
      lds<VEC>(sl.s[1][1] + c0 + Z, vs);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        fy[e] = tcy * (vn[e] * (g[e] + a[e]) - vs[e] * (g[e] + b[e]));
    }
    // fz: the z neighbours, weighted by w at z -+ 1
    {
      float w0[VEC], wl[VEC], wr[VEC];
      lds_z_sides<VEC>(fc, g, a, b);
      lds<VEC>(wc, w0);
      lds_z_sides<VEC>(wc, w0, wl, wr);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float fz = t1[e] * wl[e] * (g[e] + a[e])
                         - t2[e] * wr[e] * (g[e] + b[e]);
        const float src = in[e] ? fx[e] + fy[e] + fz : 0.0f;
        o[e] = fuse ? g[e] + dt * src : src;
      }
    }
    store_cells<VEC>(out[f] + dst, o);
  }
}
