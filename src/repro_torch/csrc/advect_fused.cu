// Fused PW advection ring (v4 temporal blocking) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/advection/advection.py `advect_fused` ->
// `_kernel_fused` (the Pallas TPU kernel), and its vmap over slots,
// `advect_fused_batched`.
//
// What it computes: T masked explicit-Euler PW steps of u, v, w in one pass
// over device memory. Each block owns one (y-tile, slot) pair and walks x
// from 0 to X+T-1. Slice min(i, X-1) of the tile's slab (S = TY + 2T rows,
// clipped flush into the domain) lands in level 0, ring slot i%3; level k
// then computes slice j = i-k from level k-1's slots ((i+1)%3, (i+2)%3,
// i%3) = (j-1, j, j+1). Levels 1..T-1 stay in shared memory; level T is
// stored straight to the output, owned rows only. Owned rows keep >= T rows
// of margin to any cut slab edge, so the tiled result equals the untiled
// one bitwise, and no block ever writes a row another block owns.
//
// Update: new = cen + dt * (interior ? src : 0.0f), a select and never a
// multiply: startup/tail slices (x < 0, x > X-1) and the zero-filled ring
// hold values that only the select walls off. src keeps the reference's
// operation order, fx + fy + fz, each parenthesised as in `_source_slices`;
// with --fmad=false every product and sum rounds on its own, as in the plain
// PyTorch version.
//
// Bound on one H100 SXM: memory. One pass reads and writes the three fields
// once: 6*X*Y*Z*4 bytes, 1.61 GB at (1024, 1024, 64), 0.48 ms at 3.35 TB/s;
// the arithmetic, T * (63 ops per interior cell + 6 per cell) as
// chip_smoke.py counts it, is 0.27 ms at 67 TFLOP/s for T = 4. The design keeps the T-1 intermediate levels out of device
// memory entirely (the kernel's whole point) and reads each slice once,
// coalesced along Z. Known limits, left for later work: loads are
// synchronous (no cp.async/TMA double buffering), and at B = 1 a
// (1024, 1024, 64) grid gives 64 blocks of one per SM on 132 SMs.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 512;

struct Ring {
  float* base;
  size_t field_sz;  // floats per field: T levels * 3 slots * plane
  int plane;        // S * Z floats per slot
  __device__ float* at(int f, int level, int slot) const {
    return base + f * field_sz + (size_t)(level * 3 + slot) * plane;
  }
};

// One cell of one level: the three advanced fields at slab cell c = r*Z + z
// from the previous level's slots m (x-1), cc (x) and p (x+1).
__device__ __forceinline__ void pw_cell(const Ring& ring, int level, int m,
                                        int cc, int p, int c, int Z,
                                        bool interior, float tcx, float tcy,
                                        float t1, float t2, float dt,
                                        float out[3]) {
  const float* um = ring.at(0, level, m);
  const float* uc = ring.at(0, level, cc);
  const float* up = ring.at(0, level, p);
  const float* vc = ring.at(1, level, cc);
  const float* wc = ring.at(2, level, cc);
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const float* fm = ring.at(f, level, m);
    const float* fcs = ring.at(f, level, cc);
    const float* fp = ring.at(f, level, p);
    const float fc = fcs[c];
    float src = 0.0f;
    if (interior) {
      const float fx = tcx * (um[c] * (fc + fm[c]) - up[c] * (fc + fp[c]));
      const float fy = tcy * (vc[c - Z] * (fc + fcs[c - Z])
                              - vc[c + Z] * (fc + fcs[c + Z]));
      const float fz = t1 * wc[c - 1] * (fc + fcs[c - 1])
                       - t2 * wc[c + 1] * (fc + fcs[c + 1]);
      src = fx + fy + fz;
    }
    out[f] = fc + dt * src;
  }
}

__global__ void __launch_bounds__(kThreads) advect_fused_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ w, float* __restrict__ ou,
    float* __restrict__ ov, float* __restrict__ ow,
    const float* __restrict__ params, const float* __restrict__ xm,
    const float* __restrict__ ym, int X, int Y,
    int Z, int T, int TY, int S, int p_stride, int xm_stride, int ym_stride,
    float dt) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int slab_lo = min(max(t * TY - T, 0), Y - S);
  const int own_lo = t * TY;
  const int own_rows = min(TY, Y - own_lo);
  const int own_r0 = own_lo - slab_lo;  // slab row of the first owned row
  const size_t slice = (size_t)Y * Z;
  const size_t boff = (size_t)b * X * slice;
  const float* in[3] = {u + boff, v + boff, w + boff};
  float* out[3] = {ou + boff, ov + boff, ow + boff};
  // this slot's row of [tcx, tcy, tzc1(Z), tzc2(Z)]
  const float* prow = params + (size_t)b * p_stride;
  const float tcx = prow[0];
  const float tcy = prow[1];
  const float* tzc1 = prow + 2;
  const float* tzc2 = prow + 2 + Z;
  const float* xmb = xm + (size_t)b * xm_stride;
  const float* ymb = ym + (size_t)b * ym_stride + slab_lo;
  const int plane = S * Z;
  const Ring ring{smem, (size_t)T * 3 * plane, plane};

  for (size_t idx = threadIdx.x; idx < 3 * ring.field_sz; idx += kThreads)
    smem[idx] = 0.0f;
  __syncthreads();

  for (int i = 0; i < X + T; ++i) {
    const int s0 = i % 3, sm = (i + 1) % 3, sc = (i + 2) % 3;
    const size_t src_off = (size_t)min(i, X - 1) * slice + (size_t)slab_lo * Z;
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      float* dst = ring.at(f, 0, s0);
      const float* srcp = in[f] + src_off;
      for (int idx = threadIdx.x; idx < plane; idx += kThreads)
        dst[idx] = srcp[idx];
    }
    __syncthreads();
    for (int k = 1; k <= T; ++k) {
      const int j = i - k;
      const bool x_ok =
          j >= 1 && j <= X - 2 && xmb[min(max(j, 0), X - 1)] > 0.0f;
      if (k < T) {
        for (int idx = threadIdx.x; idx < plane; idx += kThreads) {
          const int r = idx / Z, z = idx - r * Z;
          const bool interior = x_ok && r >= 1 && r <= S - 2 && z >= 1 &&
                                z <= Z - 2 && ymb[r] > 0.0f;
          float nv[3];
          pw_cell(ring, k - 1, sm, sc, s0, idx, Z, interior, tcx, tcy,
                  interior ? tzc1[z] : 0.0f, interior ? tzc2[z] : 0.0f,
                  dt, nv);
#pragma unroll
          for (int f = 0; f < 3; ++f) ring.at(f, k, s0)[idx] = nv[f];
        }
      } else if (j >= 0) {
        const size_t dst_off = (size_t)j * slice + (size_t)own_lo * Z;
        for (int idx = threadIdx.x; idx < own_rows * Z; idx += kThreads) {
          const int c = own_r0 * Z + idx;
          const int r = c / Z, z = c - r * Z;
          const bool interior = x_ok && r >= 1 && r <= S - 2 && z >= 1 &&
                                z <= Z - 2 && ymb[r] > 0.0f;
          float nv[3];
          pw_cell(ring, k - 1, sm, sc, s0, c, Z, interior, tcx, tcy,
                  interior ? tzc1[z] : 0.0f, interior ? tzc2[z] : 0.0f,
                  dt, nv);
#pragma unroll
          for (int f = 0; f < 3; ++f) out[f][dst_off + idx] = nv[f];
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

// u, v, w, ou, ov, ow: (B, X, Y, Z) f32, contiguous.
// params: rows of [tcx, tcy, tzc1(Z), tzc2(Z)], slot stride p_stride
// (0 = one row shared by every slot, else 2 + 2Z).
// xm: rows of X, ym: rows of Y, slot strides 0 (shared) or X / Y.
// Geometry (TY, S, n_ty) comes from the wrapper; smem_bytes is the ring.
// Returns the cudaError_t of the attribute call or of the launch.
extern "C" int advect_fused_f32(const float* u, const float* v,
                                const float* w, float* ou, float* ov,
                                float* ow, const float* params,
                                const float* xm, const float* ym, int B,
                                int X, int Y, int Z, int T, int TY, int S,
                                int n_ty, int p_stride, int xm_stride,
                                int ym_stride, float dt, size_t smem_bytes,
                                void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      advect_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_ty, B);
  advect_fused_kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      u, v, w, ou, ov, ow, params, xm, ym, X, Y, Z, T, TY, S, p_stride,
      xm_stride, ym_stride, dt);
  return (int)cudaGetLastError();
}
