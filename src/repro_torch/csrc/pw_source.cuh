// The PW source of one field at one slab cell, shared by the v1-v3 rung
// kernels (advect_blocked.cu, advect_dataflow.cu).
//
// The arithmetic is the reference's `_source_slices`
// (src/repro/kernels/advection/advection.py:119): src = fx + fy + fz, each
// term parenthesised as there. Built with --fmad=false, every product and sum
// rounds on its own, as PyTorch's elementwise ops round them in the plain
// version, so a kernel that uses this equals its plain version bitwise.
#pragma once

// The three slices a cell's stencil reads: s[f][k] is field f (u, v, w) at
// x-1 (k = 0), x (k = 1) and x+1 (k = 2), each an (S, Z) slab in shared
// memory.
struct RungSlices {
  const float* s[3][3];
};

// The value one rung emits for field f at slab cell c = r*Z + z:
// `interior ? src : 0` for sources, `cen + dt * (interior ? src : 0)` with
// `fuse`. A select and never a multiply: a cell that is not interior may sit
// next to a slice or row that holds no data (zero-filled ring slots, slab
// edges), and only the select walls it off. Neighbours are read only for
// interior cells, whose c - Z, c + Z, c - 1 and c + 1 lie inside the slab.
__device__ __forceinline__ float rung_value(const RungSlices& sl, int f,
                                            int c, int Z, bool interior,
                                            float tcx, float tcy, float t1,
                                            float t2, bool fuse, float dt) {
  const float* fc = sl.s[f][1];
  float src = 0.0f;
  if (interior) {
    const float* um = sl.s[0][0];
    const float* up = sl.s[0][2];
    const float* vc = sl.s[1][1];
    const float* wc = sl.s[2][1];
    const float* fm = sl.s[f][0];
    const float* fp = sl.s[f][2];
    const float g = fc[c];
    const float fx = tcx * (um[c] * (g + fm[c]) - up[c] * (g + fp[c]));
    const float fy = tcy * (vc[c - Z] * (g + fc[c - Z])
                            - vc[c + Z] * (g + fc[c + Z]));
    const float fz = t1 * wc[c - 1] * (g + fc[c - 1])
                     - t2 * wc[c + 1] * (g + fc[c + 1]);
    src = fx + fy + fz;
  }
  return fuse ? fc[c] + dt * src : src;
}

// Whether slab cell (r, z) of an x-interior slice gets a source: not on a
// slab edge row (a domain wall or a cut edge, >= 1 row from every owned row)
// and not on a z wall.
__device__ __forceinline__ bool rung_interior(bool x_ok, int r, int z, int S,
                                              int Z) {
  return x_ok && r >= 1 && r <= S - 2 && z >= 1 && z <= Z - 2;
}
