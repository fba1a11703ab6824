// Flash-attention forward (K8) for Hopper, sm_90a: the f32 kernel.
//
// Replaces: src/repro/kernels/attention/attention.py `flash_attention` ->
// `_flash_kernel` (the Pallas TPU kernel), for f32 q, k, v. bf16 inputs go
// to the tensor-core kernel, `flash_attention_tc.cu`: the reference's f32
// dot is exact f32, and TF32 would not hold the f32 tolerance of 1e-5.
//
// What it computes: for q (B, H, Sq, D) and k, v (B, Hkv, Skv, D), f32,
// each addressed by its (b, h, s) strides, out = softmax(q k^T * scale) v
// per head, with kv head h / (H / Hkv)
// (GQA). One block per (b, h, q-tile of block_q rows) walks the kv tiles
// of block_k keys in order, as the Pallas grid's innermost axis does, and
// keeps what the Pallas kernel keeps in VMEM scratch in f32 shared memory:
// the row max m, the row sum l and the accumulator acc (block_q x D). Per
// tile: s = (q . k) * scale in f32; under `causal`, s = NEG_INF = -2**30
// where k_pos > q_pos, both counted from 0 (the top-left mask, not
// mha_ref's bottom-right one when Sq != Skv); m_new = max(m, rowmax(s)),
// p = exp(s - m_new), corr = exp(m - m_new), l = l * corr + rowsum(p),
// acc = acc * corr + p v. At the end out = acc / max(l, 1e-30).
//
// Bound on one H100 SXM: operations, at the 67 TFLOP/s of f32 outside the
// tensor cores. BQ and BK are the caller's blocks, halved (BK first while
// it is at least BQ) until the tiles fit one block's shared memory
// (`attention.simt_tiles`); rows past Sq and keys past Skv of a ragged
// tile are zero-filled and masked. What the design does:
// each thread computes 4 x 4 outputs from two 16-byte shared-memory reads
// per step of the inner loop (Q and K stored transposed, P transposed, rows
// padded against bank conflicts); global loads run along D, coalesced; the
// q-tiles with the most causal work launch first; kv tiles wholly above
// the diagonal are skipped. Products use explicit fmaf: the library builds
// with --fmad=false for the stencil kernels, and attention is compared
// within a tolerance, not bitwise.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;             // keys per shared K/V chunk
constexpr int kKStride = kChunk + 4;   // row stride of the transposed K chunk
constexpr float kNegInf = -1073741824.0f;  // -2**30, the reference's NEG_INF

__device__ __forceinline__ void unpack(const float4 v, float out[4]) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

struct Strides {
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
};

__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, const Strides st,
    int H, int Hkv, int Sq, int Skv, int D, int BQ, int BK, int causal,
    float scale) {
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
  const float* qb = q + b * st.q_b + h * st.q_h + q0 * st.q_s;
  const float* kb = k + b * st.k_b + hk * st.k_h;
  const float* vb = v + b * st.v_b + hk * st.v_h;
  float* ob = o + b * st.o_b + h * st.o_h + q0 * st.o_s;
  const int rows = min(BQ, Sq - q0);   // rows of a ragged last q tile

  // the q tile, transposed and zero-padded; acc = 0, m = NEG_INF, l = 0
  for (int i = tid; i < BQp * Dp; i += kThreads) {
    const int r = i / Dp, d = i % Dp;
    Qt[d * QS + r] = (r < rows && d < D) ? qb[r * st.q_s + d] : 0.0f;
    acc[i] = 0.0f;
  }
  for (int r = tid; r < BQp; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.0f;
  }
  __syncthreads();

  const int nk = (Skv + BK - 1) / BK;
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
      const int nc = min(kChunk, min(BK, Skv - k0) - c0);
      for (int i = tid; i < kChunk * Dp; i += kThreads) {
        const int j = i / Dp, d = i % Dp;
        KV[d * kKStride + j] =
            (j < nc && d < D) ? kb[(k0 + c0 + j) * st.k_s + d] : 0.0f;
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
            if (k0 + c >= Skv || (causal && k0 + c > q0 + 4 * rg + i))
              s[i] = kNegInf;
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
      const int nc = max(0, min(kChunk, min(BK, Skv - k0) - c0));
      for (int i = tid; i < kChunk * Dp; i += kThreads) {
        const int j = i / Dp, d = i % Dp;
        KV[i] = (j < nc && d < D) ? vb[(k0 + c0 + j) * st.v_s + d] : 0.0f;
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

  // out = acc / max(l, 1e-30)
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    ob[r * st.o_s + d] = acc[r * Dp + d] / fmaxf(l_s[r], 1e-30f);
  }
}

}  // namespace

// q, o: (B, H, Sq, D); k, v: (B, Hkv, Skv, D); f32, each addressed by its
// (b, h, s) element strides with unit d stride. BQ and BK need not divide
// Sq and Skv; `smem` is the wrapper's `smem_bytes(BQ, BK, D)`, within one
// block's shared memory. The caller checks H % Hkv == 0. Returns the
// cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, long long q_b,
                                   long long q_h, long long q_s,
                                   long long k_b, long long k_h,
                                   long long k_s, long long v_b,
                                   long long v_h, long long v_s,
                                   long long o_b, long long o_h,
                                   long long o_s, int B, int H, int Hkv,
                                   int Sq, int Skv, int D, int BQ, int BK,
                                   int causal, float scale, size_t smem,
                                   void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Strides st{q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h,
                   o_s};
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st, H, Hkv, Sq,
      Skv, D, BQ, BK, causal, scale);
  return (int)cudaGetLastError();
}
