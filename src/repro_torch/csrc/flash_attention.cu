// Flash-attention forward (K8) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/attention/attention.py `flash_attention` ->
// `_flash_kernel` (the Pallas TPU kernel).
//
// What it computes: for q (B, H, Sq, D) and k, v (B, Hkv, Skv, D), bf16 or
// f32, out = softmax(q k^T * scale) v per head, with kv head h / (H / Hkv)
// (GQA). One block per (b, h, q-tile of block_q rows) walks the kv tiles
// of block_k keys in order, as the Pallas grid's innermost axis does, and
// keeps what the Pallas kernel keeps in VMEM scratch in f32 shared memory:
// the row max m, the row sum l and the accumulator acc (block_q x D). Per
// tile: s = (q . k) * scale in f32; under `causal`, s = NEG_INF = -2**30
// where k_pos > q_pos, both counted from 0 (the top-left mask, not
// mha_ref's bottom-right one when Sq != Skv); m_new = max(m, rowmax(s)),
// p = exp(s - m_new), corr = exp(m - m_new), l = l * corr + rowsum(p),
// acc = acc * corr + p v. At the end out = acc / max(l, 1e-30), rounded to
// q's dtype.
//
// Bound on one H100 SXM: operations. At q (1, 40, 2048, 128), k/v (1, 8,
// 2048, 128) bf16, causal, the two products are 4.29e10 FLOP, 0.043 ms at
// the 989 TFLOP/s of the bf16 tensor cores, against 50 MB of inputs and
// output, 0.015 ms at 3.35 TB/s. This first version computes both products
// in SIMT f32 FMA over shared-memory tiles (67 TFLOP/s peak), so it cannot
// come near that bound; wgmma and TMA are later work. What the design does:
// each thread computes 4 x 4 outputs from two 16-byte shared-memory reads
// per step of the inner loop (Q and K stored transposed, P transposed, rows
// padded against bank conflicts); global loads run along D, coalesced; the
// q-tiles with the most causal work launch first; kv tiles wholly above
// the diagonal are skipped. Products use explicit fmaf: the library builds
// with --fmad=false for the stencil kernels, and attention is compared
// within a tolerance, not bitwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;             // keys per shared K/V chunk
constexpr int kKStride = kChunk + 4;   // row stride of the transposed K chunk
constexpr float kNegInf = -1073741824.0f;  // -2**30, the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float x, float* p) { *p = x; }
__device__ __forceinline__ void store_as(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void unpack(const float4 v, float out[4]) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int H, int Hkv, int Sq,
    int Skv, int D, int BQ, int BK, int causal, float scale) {
  extern __shared__ float4 smem4[];
  const int BQp = (BQ + 3) & ~3;
  const int Dp = (D + 3) & ~3;
  const int QS = BQp + 4;               // row stride of the transposed Q tile
  const int nsplit = max(1, kThreads / BQp);   // threads per row for stats
  float* Qt = reinterpret_cast<float*>(smem4);  // [Dp][QS]
  float* acc = Qt + Dp * QS;                     // [BQp][Dp]
  float* KV = acc + BQp * Dp;   // K chunk [Dp][kKStride] or V chunk [kChunk][Dp]
  float* Pt = KV + kKStride * Dp;                // [BK][BQp]: s, then p
  float* m_s = Pt + BK * BQp;
  float* l_s = m_s + BQp;
  float* c_s = l_s + BQp;
  float* red_max = c_s + BQp;                    // [nsplit][BQp]
  float* red_sum = red_max + max(kThreads, BQp);

  const int iq = gridDim.x - 1 - blockIdx.x;   // most causal work first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int q0 = iq * BQ;
  const T* qb = q + (((size_t)b * H + h) * Sq + q0) * (size_t)D;
  const T* kb = k + ((size_t)b * Hkv + hk) * (size_t)Skv * D;
  const T* vb = v + ((size_t)b * Hkv + hk) * (size_t)Skv * D;
  T* ob = o + (((size_t)b * H + h) * Sq + q0) * (size_t)D;

  // the q tile, transposed and zero-padded; acc = 0, m = NEG_INF, l = 0
  for (int i = tid; i < BQp * Dp; i += kThreads) {
    const int r = i / Dp, d = i % Dp;
    Qt[d * QS + r] = (r < BQ && d < D) ? to_f32(qb[(size_t)r * D + d]) : 0.0f;
    acc[i] = 0.0f;
  }
  for (int r = tid; r < BQp; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.0f;
  }
  __syncthreads();

  const int nk = Skv / BK;
  const int q_last = q0 + BQ - 1;
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    // A kv tile wholly above the diagonal (every k_pos > every q_pos) is
    // skipped. The Pallas kernel computes it all masked: s = NEG_INF, so
    // m_new = m (tile 0 holds k_pos 0 <= q_pos, so m is a real logit by
    // then), p = exp(NEG_INF - m) = 0 and corr = exp(0) = 1, and l and acc
    // keep their bits. Skipping it changes nothing, bit for bit.
    if (causal && k0 > q_last) break;

    // 1. s = (q . k) * scale, masked, chunk by chunk of keys
    for (int c0 = 0; c0 < BK; c0 += kChunk) {
      const int nc = min(kChunk, BK - c0);
      for (int i = tid; i < kChunk * Dp; i += kThreads) {
        const int j = i / Dp, d = i % Dp;
        KV[d * kKStride + j] =
            (j < nc && d < D) ? to_f32(kb[(size_t)(k0 + c0 + j) * D + d])
                              : 0.0f;
      }
      __syncthreads();
      for (int mt = tid; mt < (BQp / 4) * (kChunk / 4); mt += kThreads) {
        const int rg = mt / (kChunk / 4), cg = mt % (kChunk / 4);
        float a[4][4] = {};
        for (int d = 0; d < Dp; ++d) {
          float qa[4], ka[4];
          unpack(*reinterpret_cast<const float4*>(Qt + d * QS + 4 * rg), qa);
          unpack(*reinterpret_cast<const float4*>(KV + d * kKStride + 4 * cg),
                 ka);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) a[i][j] = fmaf(qa[i], ka[j], a[i][j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + 4 * cg + j;
          if (c >= BK) break;
          float s[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i] = a[i][j] * scale;
            if (causal && k0 + c > q0 + 4 * rg + i) s[i] = kNegInf;
          }
          *reinterpret_cast<float4*>(Pt + c * BQp + 4 * rg) =
              make_float4(s[0], s[1], s[2], s[3]);
        }
      }
      __syncthreads();
    }

    // 2. the tile's row statistics, nsplit threads per row
    for (int i = tid; i < BQp * nsplit; i += kThreads) {
      const int r = i % BQp, part = i / BQp;
      float mx = kNegInf;
      for (int c = part; c < BK; c += nsplit) mx = fmaxf(mx, Pt[c * BQp + r]);
      red_max[part * BQp + r] = mx;
    }
    __syncthreads();
    for (int i = tid; i < BQp * nsplit; i += kThreads) {
      const int r = i % BQp, part = i / BQp;
      float m_new = m_s[r];
      for (int t = 0; t < nsplit; ++t)
        m_new = fmaxf(m_new, red_max[t * BQp + r]);
      float sum = 0.0f;
      for (int c = part; c < BK; c += nsplit) {
        const float p = expf(Pt[c * BQp + r] - m_new);
        Pt[c * BQp + r] = p;
        sum += p;
      }
      red_sum[part * BQp + r] = sum;
    }
    __syncthreads();
    for (int r = tid; r < BQp; r += kThreads) {
      float m_new = m_s[r];
      float sum = 0.0f;
      for (int t = 0; t < nsplit; ++t) {
        m_new = fmaxf(m_new, red_max[t * BQp + r]);
        sum += red_sum[t * BQp + r];
      }
      const float corr = expf(m_s[r] - m_new);
      l_s[r] = l_s[r] * corr + sum;
      c_s[r] = corr;
      m_s[r] = m_new;
    }
    __syncthreads();

    // 3. acc = acc * corr + p v, chunk by chunk of keys
    for (int c0 = 0; c0 < BK; c0 += kChunk) {
      const int nc = min(kChunk, BK - c0);
      for (int i = tid; i < kChunk * Dp; i += kThreads) {
        const int j = i / Dp, d = i % Dp;
        KV[i] = (j < nc && d < D) ? to_f32(vb[(size_t)(k0 + c0 + j) * D + d])
                                  : 0.0f;
      }
      __syncthreads();
      for (int mt = tid; mt < (BQp / 4) * (Dp / 4); mt += kThreads) {
        const int rg = mt / (Dp / 4), dg = mt % (Dp / 4);
        float a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          unpack(*reinterpret_cast<const float4*>(
                     acc + (4 * rg + i) * Dp + 4 * dg), a[i]);
          if (c0 == 0) {
            const float corr = c_s[4 * rg + i];
#pragma unroll
            for (int e = 0; e < 4; ++e) a[i][e] *= corr;
          }
        }
        for (int j = 0; j < nc; ++j) {
          float pa[4], va[4];
          unpack(*reinterpret_cast<const float4*>(Pt + (c0 + j) * BQp + 4 * rg),
                 pa);
          unpack(*reinterpret_cast<const float4*>(KV + j * Dp + 4 * dg), va);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) a[i][e] = fmaf(pa[i], va[e], a[i][e]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(acc + (4 * rg + i) * Dp + 4 * dg) =
              make_float4(a[i][0], a[i][1], a[i][2], a[i][3]);
      }
      __syncthreads();
    }
  }

  // out = acc / max(l, 1e-30), in q's dtype
  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    store_as(acc[r * Dp + d] / fmaxf(l_s[r], 1e-30f), ob + (size_t)r * D + d);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int Sq, int Skv, int D, int block_q, int block_k,
           int causal, float scale, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Sq / block_q, H, B);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, Sq, Skv, D,
      block_q, block_k, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, H, Sq, D); k, v: (B, Hkv, Skv, D); contiguous, all f32
// (is_bf16 = 0) or all bf16 (is_bf16 = 1). The caller checks H % Hkv == 0,
// Sq % block_q == 0, Skv % block_k == 0 and that `smem` (the wrapper's
// `smem_bytes`) fits one block. Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(int is_bf16, const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int Hkv, int Sq, int Skv, int D,
                                   int block_q, int block_k, int causal,
                                   float scale, size_t smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Sq, Skv, D, block_q,
                                 block_k, causal, scale, smem, s);
  return launch<float>(q, k, v, o, B, H, Hkv, Sq, Skv, D, block_q, block_k,
                       causal, scale, smem, s);
}
