// Spec-driven fused ring (the stencil-spec frontend's engine) for Hopper,
// sm_90a.
//
// Replaces: src/repro/kernels/advection/advection.py `stencil_fused` ->
// `_kernel_stencil_fused` (the Pallas TPU kernel), and its vmap over slots,
// `stencil_fused_batched`.
//
// What it computes: T steps of a StencilSpec's integrator over its NF fields
// in one pass over device memory. Each field has a ring of L = STAGES*T
// levels of W = 2R+1 slots of the tile's slab (S = TY + 2D rows, D = R*L,
// clipped flush into the domain). Each block owns one (y-tile, slot) pair
// and walks x from 0 to X+D-1: slice min(i, X-1) lands in level 0, slot
// i % W; level k computes slice j = i - k*R from level k-1's slots
// (i - R + dx) % W, |dx| <= R. Euler spends one level per step
// (cen + dt*src). Midpoint RK2 spends two: odd levels hold
// g = cen + (dt/2)*src, even levels write base + dt*src(g), base being level
// k-2's slice j in slot (i - 2R) % W. Level L is stored straight to the
// output, owned rows only: blocks run at once, so none rewrites a row
// another block owns (the Pallas kernel's sliding remainder block is not
// ported). Owned rows keep >= D rows of margin to any cut slab edge, so the
// tiled result equals the untiled one bitwise.
//
// Update: new = base + step_dt * (interior ? src : 0.0f), a select and never
// a multiply: startup/tail slices and the zero-filled ring hold values that
// only the select walls off, and masked slices copy through (g = cen,
// new = base). interior = R <= j <= X-1-R, x_mask[j], the row mask, and the
// R-cell pad of the slab in y and z. The source is the operator functor of
// stencil_ops.cuh, the spec callback's arithmetic term by term; with
// --fmad=false every product and sum rounds on its own, as in the plain
// PyTorch version.
//
// The kernel is a template over R, STAGES and the functor; the C entry point
// instantiates it for the three shipped operators (PW, tracer, diffusion)
// x {euler, rk2} at radius 1. A spec the table does not name is refused by
// the wrapper on the card (ROADMAP Queue 2: CUDA sources for user-defined
// specs).
//
// Bound on one H100 SXM: memory. One pass reads and writes the NF fields
// once: 2*NF*X*Y*Z*4 bytes, 1.61 GB for PW at (1024, 1024, 64), 0.48 ms at
// 3.35 TB/s; the arithmetic, STAGES*T source passes of 64 (PW), 85 (tracer)
// or 14 (diffusion) operations per interior cell plus the 2-op update of
// each field, is below that at 67 TFLOP/s. The design keeps the L-1
// intermediate levels out of device memory (the kernel's point) and reads
// each slice once, coalesced along Z. Known limits, as K1's: synchronous
// loads, one block per SM at the large rings, and n_ty * B blocks only (64
// for PW at y_tile 16 on 132 SMs).
#include <cuda_runtime.h>
#include <stddef.h>

#include "stencil_ops.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxFields = 4;

struct StencilArgs {
  const float* in[kMaxFields];   // (B, X, Y, Z) per field, contiguous
  float* out[kMaxFields];
  const float* pv;               // the packed parameter vectors, back to back
  const float* xm;               // rows of X, slot stride xm_stride
  const float* ym;               // rows of Y, slot stride ym_stride
  int p_len, X, Y, Z, T, TY, S, xm_stride, ym_stride;
  float dt;
};

// One ring level over cells [c0, c0 + n_cells) of the slab:
// new = base + step_dt * (interior ? src : 0). Below the last level the
// value goes to the ring (`dst` offsets, slab cell c); the last level writes
// the owned rows to the output (`out` rows, owned cell idx).
template <int R, class Op, bool LAST>
__device__ __forceinline__ void ring_level(
    float* ring, RingAccessor<R, Op::kFields> sh,
    const int (&base)[Op::kFields],
    const int (&dst)[Op::kFields], float* const (&out)[Op::kFields],
    int n_cells, int c0, int S, int Z, bool x_ok, const float* ymb,
    float step_dt, const float* pv, int p_len) {
  constexpr int NF = Op::kFields;
  for (int idx = threadIdx.x; idx < n_cells; idx += kThreads) {
    const int c = c0 + idx;
    const int r = c / Z, z = c - r * Z;
    const bool interior = x_ok && r >= R && r <= S - 1 - R && z >= R &&
                          z <= Z - 1 - R && ymb[r] > 0.0f;
    sh.c = c;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      float src = 0.0f;
      if (interior) src = Op::source(sh, f, pv, p_len, z);
      const float nv = ring[base[f] + c] + step_dt * src;
      if constexpr (LAST)
        out[f][idx] = nv;
      else
        ring[dst[f] + c] = nv;
    }
  }
}

template <int R, int STAGES, class Op>
__global__ void __launch_bounds__(kThreads)
    stencil_fused_kernel(const StencilArgs a) {
  constexpr int NF = Op::kFields;
  constexpr int W = 2 * R + 1;
  extern __shared__ float smem[];
  const int X = a.X, Y = a.Y, Z = a.Z, S = a.S;
  const int L = STAGES * a.T;
  const int D = R * L;
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int slab_lo = min(max(t * a.TY - D, 0), Y - S);
  const int own_lo = t * a.TY;
  const int own_rows = min(a.TY, Y - own_lo);
  const int own_c0 = (own_lo - slab_lo) * Z;  // slab cell of the first owned
  const size_t slice = (size_t)Y * Z;
  const size_t boff = (size_t)b * X * slice;
  const float* xmb = a.xm + (size_t)b * a.xm_stride;
  const float* ymb = a.ym + (size_t)b * a.ym_stride + slab_lo;
  // ring offsets in floats: field f, level l, slot s at
  // f*field_sz + l*level_sz + s*plane (the ring fits 232,448 B, so int)
  const int plane = S * Z;
  const int level_sz = W * plane;
  const int field_sz = L * level_sz;
  const float half_dt = 0.5f * a.dt;

  for (int idx = threadIdx.x; idx < NF * field_sz; idx += kThreads)
    smem[idx] = 0.0f;
  __syncthreads();

  for (int i = 0; i < X + D; ++i) {
    const int s0 = (i % W) * plane;
    const size_t src_off =
        boff + (size_t)min(i, X - 1) * slice + (size_t)slab_lo * Z;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      float* dst = smem + f * field_sz + s0;
      const float* srcp = a.in[f] + src_off;
      for (int idx = threadIdx.x; idx < plane; idx += kThreads)
        dst[idx] = srcp[idx];
    }
    __syncthreads();
    for (int k = 1; k <= L; ++k) {
      const int j = i - k * R;
      const bool x_ok = j >= R && j <= X - 1 - R && xmb[j] > 0.0f;
      const float step_dt = (STAGES == 2 && k % 2 == 1) ? half_dt : a.dt;
      // rk2's full levels add to level k-2's slice j, slot (i - 2R) % W;
      // otherwise the base is the centre slot (i - R) % W of level k-1
      const bool full = STAGES == 2 && k % 2 == 0;
      const int base_lvl = (full ? k - 2 : k - 1) * level_sz;
      const int base_slot = (full ? (i + 1) % W : (i + R + 1) % W) * plane;
      RingAccessor<R, NF> sh;
      sh.ring = smem;
      sh.Z = Z;
      int base[NF], dst[NF];
      float* out[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) {
#pragma unroll
        for (int dx = -R; dx <= R; ++dx)  // (i - R + dx) % W, non-negative
          sh.slot[f][dx + R] = f * field_sz + (k - 1) * level_sz +
                               ((i + R + 1 + dx) % W) * plane;
        base[f] = f * field_sz + base_lvl + base_slot;
        dst[f] = f * field_sz + k * level_sz + s0;
        out[f] = a.out[f] + boff + (size_t)max(j, 0) * slice +
                 (size_t)own_lo * Z;
      }
      if (k < L)
        ring_level<R, Op, false>(smem, sh, base, dst, out, plane, 0, S, Z,
                                 x_ok, ymb, step_dt, a.pv, a.p_len);
      else if (j >= 0)  // level L of a slice before x = 0 has no output row
        ring_level<R, Op, true>(smem, sh, base, dst, out, own_rows * Z,
                                own_c0, S, Z, x_ok, ymb, step_dt, a.pv,
                                a.p_len);
      __syncthreads();
    }
  }
}

template <int R, int STAGES, class Op>
int launch(const StencilArgs& a, int B, int n_ty, size_t smem_bytes,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stencil_fused_kernel<R, STAGES, Op>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  stencil_fused_kernel<R, STAGES, Op>
      <<<dim3(n_ty, B), kThreads, smem_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// op: 0 = PW (u, v, w), 1 = tracer (u, v, w, q), 2 = diffusion (phi);
// stages: 1 = euler, 2 = rk2; radius: 1 (the only one instantiated).
// in*/out*: (B, X, Y, Z) f32, contiguous; the unused ones are null.
// pv: the spec's packed parameter vectors back to back, each p_len long,
// shared by every slot. xm: rows of X, ym: rows of Y, slot strides 0
// (shared) or X / Y. Geometry (TY, S, n_ty) comes from the wrapper;
// smem_bytes is the ring. Returns cudaErrorInvalidValue for an operator,
// integrator or radius that is not instantiated, else the cudaError_t of
// the attribute call or of the launch.
extern "C" int stencil_fused_f32(
    int op, int stages, int radius, const float* in0, const float* in1,
    const float* in2, const float* in3, float* out0, float* out1,
    float* out2, float* out3, const float* pv, int p_len, const float* xm,
    const float* ym, int B, int X, int Y, int Z, int T, int TY, int S,
    int n_ty, int xm_stride, int ym_stride, float dt, size_t smem_bytes,
    void* stream) {
  const StencilArgs a{{in0, in1, in2, in3}, {out0, out1, out2, out3}, pv,
                      xm, ym, p_len, X, Y, Z, T, TY, S, xm_stride, ym_stride,
                      dt};
  cudaStream_t s = (cudaStream_t)stream;
  if (radius != 1 || op < 0 || op > 2 || stages < 1 || stages > 2)
    return (int)cudaErrorInvalidValue;
  switch (op * 2 + stages - 1) {
    case 0: return launch<1, 1, PwFluxOp<3>>(a, B, n_ty, smem_bytes, s);
    case 1: return launch<1, 2, PwFluxOp<3>>(a, B, n_ty, smem_bytes, s);
    case 2: return launch<1, 1, PwFluxOp<4>>(a, B, n_ty, smem_bytes, s);
    case 3: return launch<1, 2, PwFluxOp<4>>(a, B, n_ty, smem_bytes, s);
    case 4: return launch<1, 1, DiffusionOp>(a, B, n_ty, smem_bytes, s);
    case 5: return launch<1, 2, DiffusionOp>(a, B, n_ty, smem_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
