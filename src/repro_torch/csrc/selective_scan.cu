// Selective scan (K9, Mamba-1) for Hopper, sm_90a: a time-parallel chunk
// scan with y summed inside the thread.
//
// Replaces: src/repro/kernels/ssm/ssm.py `selective_scan` -> `_kernel`
// (`_chunk_body`), the Pallas TPU kernel.
//
// What it computes: for xc, dt (B, S, D), Bm, Cm (B, S, N), A (D, N) and
// h0 (B, D, N), walking t = 0 .. S-1 from h = h0:
//   a = exp(dt[t, d] * A[d, n]);  h[d, n] = a * h[d, n] + (dt[t, d] * x[t, d])
//   * B[t, n];  y[t, d] = sum_n h[d, n] * C[t, n]
// and writes y (B, S, D) and h_final (B, D, N), both f32. x, B and C are
// f32 or bf16 (all three the same), dt f32 or x's type; every value is
// widened to f32 before it is used, as the Pallas kernel promotes them.
// The Pallas kernel evaluates each chunk as an associative scan of the
// pairs (a, bu), h_all = pa * h0 + pb, with h carried from chunk to chunk;
// this kernel evaluates the same composition in two levels.
//
// Layout. A block takes one batch row and kDT = 16 consecutive d, and
// walks the sequence in time tiles of TL = LT * K steps, h carried in
// shared memory from tile to tile: it never leaves the SM, and two buffers
// (one read, one written) let no lane wait on another within a tile. LT
// lanes of a warp split one d's tile in time, each owning K consecutive
// steps; a warp holds 32 / LT values of d, the block kDT * LT threads. For
// each state n a lane
//   1. composes its K pairs (a_i = 2^(dt_i * A log2 e), bu_i = dt_i x_i
//      B_i) into one map h -> P h + Q;
//   2. scans the maps of its LT lanes (log2 LT rounds of shfl_up), folds in
//      the carried h[d, n] and takes its first state from the lane before;
//   3. walks its K steps again, h = a_i h + bu_i, y_i += h C_i.
// It takes kStates = 2 states at a time, their chains interleaved. So y
// is summed over n in registers, with no reduction across lanes per step,
// and the last lane's h is the carry. Steps past S (a tile the sequence
// does not fill) are staged as zeros: a = 1, bu = 0, h passes.
// K is a template parameter (the register arrays); LT, the tile and the
// shared bytes come from the wrapper's launch plan (`scan_launch_plan`).
//
// Staging. Each tile's x and dt (rows of kDT values: 32 or 64 bytes) and
// B and C (one contiguous run of TL * N values) are copied into one of two
// raw stages with 16-byte cp.async while the tile before computes (where a
// shape or pointer is not 16-byte aligned, by plain loads in their place).
// x and dt rows of one lane's K steps are followed by 16 bytes of pad, so
// the lanes of a warp read them in distinct banks. B and C are widened
// once per tile into f32 [n][t] arrays (a row pitch of TL + 4 floats), so
// a lane reads its K values of one n as float4s, broadcast to the lanes of
// other d. y leaves through a [d][t] f32 array, as whole rows of 16 d.
//
// Bounds on one H100 SXM at the 2048-token prefill's shape (xc (1, 2048,
// 8192) bf16, dt f32, B/C (1, 2048, 16) bf16): bytes, 101 MB read and 68
// MB written, 0.0506 ms at 3.35 TB/s; the exps, 268M of them at 16 a clock
// per SM on the special-function units, 0.064-0.072 ms at 1.98-1.755 GHz.
// The exp is one ex2.approx.ftz after a multiply by A log2 e (scaled once
// per (d, n)); dt * x is formed once per (t, d). The library builds with
// --fmad=false; this kernel's gate is a tolerance, so the compose, the
// walk and y's sum are explicit __fmaf_rn.
//
// No tensor cores: Mamba-1's A is diagonal in (d, n), so the recurrence is
// elementwise, and y's contraction over n is 16 long and differs at every
// t; neither is a matrix product.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kDT = 16;           // d per block
constexpr int kMaxN = 128;        // states per d
constexpr int kStates = 2;        // states a lane walks at once
// threads a block of the K build may have (its launch bound): kDT * 32
// lanes, kDT * 16 at K >= 4, whose register arrays (kStates * K values of
// a and of bu) ptxas squeezed into 64 registers with spills under a
// 512-thread bound
template <int K>
constexpr int max_threads() {
  return K * kStates >= 8 ? 256 : 512;
}
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Byte offsets of one block's shared memory; the wrapper's
// `scan_shared_bytes` computes the same total.
struct Layout {
  int TL, TLP;
  size_t x, dt, b, c, stage;      // within a raw stage; a stage's bytes
  size_t bs, cs, ys, as, hs, total;
};

__host__ __device__ inline Layout layout(int LT, int K, int N, int sx,
                                         int sdt) {
  Layout L;
  L.TL = LT * K;
  L.TLP = L.TL + 4;
  L.x = 0;
  L.dt = L.x + round16((size_t)L.TL * kDT * sx + 16 * LT);
  L.b = L.dt + round16((size_t)L.TL * kDT * sdt + 16 * LT);
  L.c = L.b + round16((size_t)L.TL * N * sx);
  L.stage = L.c + round16((size_t)L.TL * N * sx);
  L.bs = 2 * L.stage;
  L.cs = L.bs + (size_t)N * L.TLP * 4;
  L.ys = L.cs + (size_t)N * L.TLP * 4;
  L.as = L.ys + (size_t)kDT * L.TLP * 4;
  L.hs = L.as + (size_t)kDT * N * 4;
  L.total = L.hs + (size_t)2 * kDT * N * 4;
  return L;
}

struct Args {
  const void* x;
  const void* dt;
  const void* Bm;
  const void* Cm;
  const float* A;
  const float* h0;
  float* y;
  float* hout;
  int S, D, N, LT;
  int vec_x, vec_dt, vec_bc;  // 16-byte cp.async where 1, plain loads else
};

// Copy the rows [t0, t0 + TL) of one operand's kDT columns from d0 into a
// raw stage: row t at t * kDT + (t / K) * pad, zeros past S or D.
template <typename T>
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const T* __restrict__ src, int vec,
                                           size_t row0, int t0, int d0,
                                           int TL, int K, int S, int D) {
  constexpr int kRow = kDT * (int)sizeof(T);
  if (vec) {
    constexpr int kChunks = kRow / 16;
    const int valid = (D - d0) * (int)sizeof(T);  // a multiple of 16 here
    for (int e = threadIdx.x; e < TL * kChunks; e += blockDim.x) {
      const int t = e / kChunks, c = e - t * kChunks;
      const bool live = t0 + t < S && c * 16 < valid;
      const unsigned char* g =
          live ? reinterpret_cast<const unsigned char*>(
                     src + (row0 + t0 + t) * (size_t)D + d0) + c * 16
               : reinterpret_cast<const unsigned char*>(src);
      cp_async16(dst + t * kRow + (t / K) * 16 + c * 16, g, live ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < TL * kDT; e += blockDim.x) {
      const int t = e / kDT, dd = e - t * kDT;
      const bool live = t0 + t < S && d0 + dd < D;
      const T v = live ? src[(row0 + t0 + t) * (size_t)D + d0 + dd] : T(0.0f);
      *reinterpret_cast<T*>(dst + t * kRow + (t / K) * 16 +
                            dd * (int)sizeof(T)) = v;
    }
  }
}

// Copy TL * N contiguous values of B or C from step t0 into a raw stage,
// zeros past S.
template <typename T>
__device__ __forceinline__ void stage_run(unsigned char* dst,
                                          const T* __restrict__ src, int vec,
                                          size_t row0, int t0, int TL, int N,
                                          int S) {
  const size_t first = (row0 + t0) * (size_t)N;
  const int count = (t0 + TL <= S ? TL : S - t0) * N;
  if (vec) {
    const int bytes = count * (int)sizeof(T);
    const int chunks = (TL * N * (int)sizeof(T) + 15) / 16;
    const unsigned char* g =
        reinterpret_cast<const unsigned char*>(src + first);
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
      const int left = bytes - c * 16;
      const int n = left <= 0 ? 0 : (left < 16 ? left : 16);
      cp_async16(dst + c * 16,
                 n ? g + c * 16 : reinterpret_cast<const unsigned char*>(src),
                 n);
    }
  } else {
    T* out = reinterpret_cast<T*>(dst);
    for (int e = threadIdx.x; e < TL * N; e += blockDim.x) {
      out[e] = e < count ? src[first + e] : T(0.0f);
    }
  }
}

template <int K, typename TX, typename TDT>
__device__ __forceinline__ void stage_tile(const Args& a, const Layout& L,
                                           unsigned char* st, size_t row0,
                                           int t0, int d0) {
  stage_rows(st + L.x, static_cast<const TX*>(a.x), a.vec_x, row0, t0, d0,
             L.TL, K, a.S, a.D);
  stage_rows(st + L.dt, static_cast<const TDT*>(a.dt), a.vec_dt, row0, t0,
             d0, L.TL, K, a.S, a.D);
  stage_run(st + L.b, static_cast<const TX*>(a.Bm), a.vec_bc, row0, t0, L.TL,
            a.N, a.S);
  stage_run(st + L.c, static_cast<const TX*>(a.Cm), a.vec_bc, row0, t0, L.TL,
            a.N, a.S);
}

// K consecutive floats from shared memory (16-byte aligned where K % 4 == 0)
template <int K>
__device__ __forceinline__ void load_k(float (&v)[K], const float* p) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] = p[i];
  }
}

template <int K>
__device__ __forceinline__ void store_k(float* p, const float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) p[i] = v[i];
  }
}

// States n .. n + NB - 1 of the lane's d over its K steps of the tile
// (steps 1-3 of the header), their chains interleaved: y_i += h[n'] C_i for
// each state in turn, the carried h of each replaced by the last lane's.
template <int K, int NB>
__device__ __forceinline__ void scan_states(
    int n, int N, int LT, int s, int dl, int TLP, const float* Bs,
    const float* Cs, const float* As2, const float* hs, float* hs_next,
    const float (&dtv)[K], const float (&dxv)[K], float (&yv)[K]) {
  float carry[NB], P[NB], Q[NB], h[NB], av[NB][K], uv[NB][K];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float a2 = As2[dl * N + n + j];
    carry[j] = hs[dl * N + n + j];
    float bv[K];
    load_k<K>(bv, Bs + (n + j) * TLP + s * K);
    P[j] = 1.0f;
    Q[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      av[j][i] = ex2(dtv[i] * a2);
      uv[j][i] = dxv[i] * bv[i];
      Q[j] = __fmaf_rn(av[j][i], Q[j], uv[j][i]);
      P[j] = P[j] * av[j][i];
    }
  }
  for (int off = 1; off < LT; off <<= 1) {  // inclusive scan of the maps
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float Pp = __shfl_up_sync(kFull, P[j], off, LT);
      const float Qp = __shfl_up_sync(kFull, Q[j], off, LT);
      if (s >= off) {
        Q[j] = __fmaf_rn(P[j], Qp, Q[j]);
        P[j] = P[j] * Pp;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float after = __fmaf_rn(P[j], carry[j], Q[j]);  // h after my steps
    const float before = __shfl_up_sync(kFull, after, 1, LT);
    h[j] = s == 0 ? carry[j] : before;
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    float cv[K];
    load_k<K>(cv, Cs + (n + j) * TLP + s * K);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      h[j] = __fmaf_rn(av[j][i], h[j], uv[j][i]);
      yv[i] = __fmaf_rn(h[j], cv[i], yv[i]);
    }
  }
  if (s == LT - 1) {
#pragma unroll
    for (int j = 0; j < NB; ++j) hs_next[dl * N + n + j] = h[j];
  }
}

template <int K, typename TX, typename TDT>
__global__ void __launch_bounds__(max_threads<K>())
    selective_scan_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int LT = a.LT, N = a.N, S = a.S, D = a.D;
  const Layout L = layout(LT, K, N, sizeof(TX), sizeof(TDT));
  float* Bs = reinterpret_cast<float*>(smem + L.bs);
  float* Cs = reinterpret_cast<float*>(smem + L.cs);
  float* ys = reinterpret_cast<float*>(smem + L.ys);
  float* As2 = reinterpret_cast<float*>(smem + L.as);
  float* hs = reinterpret_cast<float*>(smem + L.hs);

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kDT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int s = lane & (LT - 1);                         // time segment
  const int dl = (tid >> 5) * (32 / LT) + lane / LT;     // d in the block
  const size_t row0 = (size_t)b * S;

  for (int e = tid; e < kDT * N; e += blockDim.x) {
    const int dd = e / N, n = e - dd * N;
    const bool live = d0 + dd < D;
    hs[e] = live ? a.h0[((size_t)b * D + d0 + dd) * N + n] : 0.0f;
    As2[e] = live ? a.A[(size_t)(d0 + dd) * N + n] * kLog2e : 0.0f;
  }

  // (t, n) of this thread's first value of B and C in a tile, and the
  // step between its values: the widening loop divides by N only here
  const int t_first = tid / N, n_first = tid - t_first * N;
  const int t_step = blockDim.x / N, n_step = blockDim.x - t_step * N;
  const int n_tiles = (S + L.TL - 1) / L.TL;
  stage_tile<K, TX, TDT>(a, L, smem, row0, 0, d0);
  cp_async_commit();
  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = j * L.TL;
    const int valid = S - t0 < L.TL ? S - t0 : L.TL;
    unsigned char* st = smem + (j & 1) * L.stage;
    if (j + 1 < n_tiles) {
      stage_tile<K, TX, TDT>(a, L, smem + ((j + 1) & 1) * L.stage, row0,
                             t0 + L.TL, d0);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // tile j staged (and, at j = 0, h0 and A)

    const TX* rb = reinterpret_cast<const TX*>(st + L.b);
    const TX* rc = reinterpret_cast<const TX*>(st + L.c);
    for (int e = tid, t = t_first, n = n_first; e < L.TL * N;
         e += blockDim.x, t += t_step, n += n_step) {
      if (n >= N) {
        n -= N;
        ++t;
      }
      Bs[n * L.TLP + t] = to_f32(rb[e]);
      Cs[n * L.TLP + t] = to_f32(rc[e]);
    }
    __syncthreads();

    float dtv[K], dxv[K], yv[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int row = s * K + i;
      const float dv = to_f32(*reinterpret_cast<const TDT*>(
          st + L.dt + row * kDT * sizeof(TDT) + s * 16 + dl * sizeof(TDT)));
      const float xv = to_f32(*reinterpret_cast<const TX*>(
          st + L.x + row * kDT * sizeof(TX) + s * 16 + dl * sizeof(TX)));
      dtv[i] = dv;
      dxv[i] = dv * xv;
      yv[i] = 0.0f;
    }
    const float* h_in = hs + (j & 1) * kDT * N;
    float* h_out = hs + ((j + 1) & 1) * kDT * N;
    int n = 0;
    for (; n + kStates <= N; n += kStates) {
      scan_states<K, kStates>(n, N, LT, s, dl, L.TLP, Bs, Cs, As2, h_in,
                              h_out, dtv, dxv, yv);
    }
    for (; n < N; ++n) {
      scan_states<K, 1>(n, N, LT, s, dl, L.TLP, Bs, Cs, As2, h_in, h_out,
                        dtv, dxv, yv);
    }
    store_k<K>(ys + dl * L.TLP + s * K, yv);
    __syncthreads();

    for (int e = tid; e < valid * kDT; e += blockDim.x) {
      const int t = e / kDT, dd = e - t * kDT;
      if (d0 + dd < D) {
        a.y[(row0 + t0 + t) * D + d0 + dd] = ys[dd * L.TLP + t];
      }
    }
  }
  for (int e = tid; e < kDT * N; e += blockDim.x) {
    const int dd = e / N;
    if (d0 + dd < D) {
      a.hout[((size_t)b * D + d0) * N + e] = hs[(n_tiles & 1) * kDT * N + e];
    }
  }
}

using KernelFn = void (*)(const Args);

template <int K>
KernelFn pick(int x_bf16, int dt_bf16, int LT) {
  if (kDT * LT > max_threads<K>()) return nullptr;
  if (x_bf16 && dt_bf16)
    return selective_scan_chunk_kernel<K, __nv_bfloat16, __nv_bfloat16>;
  if (x_bf16) return selective_scan_chunk_kernel<K, __nv_bfloat16, float>;
  return selective_scan_chunk_kernel<K, float, float>;
}

KernelFn kernel_for(int K, int x_bf16, int dt_bf16, int LT) {
  switch (K) {
    case 1: return pick<1>(x_bf16, dt_bf16, LT);
    case 2: return pick<2>(x_bf16, dt_bf16, LT);
    case 4: return pick<4>(x_bf16, dt_bf16, LT);
    case 8: return pick<8>(x_bf16, dt_bf16, LT);
    default: return nullptr;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The plan's checks: a build of K whose launch bound takes kDT * LT
// threads, LT a power of two in [4, 32], N in [1, kMaxN], dt bf16 only
// with x bf16, and smem the layout's bytes.
KernelFn checked(int x_bf16, int dt_bf16, int N, int LT, int K,
                 size_t smem) {
  if (N < 1 || N > kMaxN || (dt_bf16 && !x_bf16) || LT < 4 || LT > 32 ||
      (LT & (LT - 1))) {
    return nullptr;
  }
  const Layout L = layout(LT, K, N, x_bf16 ? 2 : 4, dt_bf16 ? 2 : 4);
  if (L.total != smem) return nullptr;
  return kernel_for(K, x_bf16, dt_bf16, LT);
}

}  // namespace

// x, Bm, Cm: bf16 when x_bf16, else f32; dt: bf16 when dt_bf16, else f32
// (dt bf16 only with x bf16); all contiguous. The plan (LT lanes a d, K
// steps a lane, smem bytes) comes from the wrapper's `scan_launch_plan`.
// Returns a cudaError_t, 0 on success; cudaErrorInvalidValue for a plan
// the library was not built for or whose smem is not its layout's.
extern "C" int selective_scan_fwd(int x_bf16, int dt_bf16, const void* x,
                                  const void* dt, const void* Bm,
                                  const void* Cm, const float* A,
                                  const float* h0, float* y, float* hout,
                                  int B, int S, int D, int N, int LT, int K,
                                  size_t smem, void* stream) {
  const KernelFn kern = checked(x_bf16, dt_bf16, N, LT, K, smem);
  if (kern == nullptr || B < 1 || S < 1 || D < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int sx = x_bf16 ? 2 : 4, sdt = dt_bf16 ? 2 : 4;
  const Args a{x, dt, Bm, Cm, A, h0, y, hout, S, D, N, LT,
               aligned16(x) && (D * sx) % 16 == 0,
               aligned16(dt) && (D * sdt) % 16 == 0,
               aligned16(Bm) && aligned16(Cm) && (N * sx) % 16 == 0};
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((D + kDT - 1) / kDT, B);
  kern<<<grid, kDT * LT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// out[4]: registers and local (spill) bytes per thread, the most threads a
// block can have, and resident blocks per SM of the K build for these
// types at kDT * LT threads and smem bytes.
extern "C" int selective_scan_attrs(int x_bf16, int dt_bf16, int N, int LT,
                                    int K, size_t smem, int* out) {
  const KernelFn kern = checked(x_bf16, dt_bf16, N, LT, K, smem);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kern);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kDT * LT, smem);
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = fa.maxThreadsPerBlock;
  out[3] = per_sm;
  return 0;
}
