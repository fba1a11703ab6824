// Selective scan (K9, Mamba-1) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/ssm/ssm.py `selective_scan` -> `_kernel`
// (`_chunk_body`), the Pallas TPU kernel.
//
// What it computes: for xc, dt (B, S, D), Bm, Cm (B, S, N), A (D, N) and
// h0 (B, D, N), walking t = 0 .. S-1 in order from h = h0:
//   a = exp(dt[t, d] * A[d, n]);  h[d, n] = a * h[d, n] + (dt[t, d] * x[t, d])
//   * B[t, n];  y[t, d] = sum_n h[d, n] * C[t, n]
// and writes y (B, S, D) and h_final (B, D, N), both f32. x, B and C are
// f32 or bf16 (all three the same), dt f32 or x's type; every value is
// widened to f32 before it is used, as the Pallas kernel promotes them.
//
// Layout. The Pallas kernel walks the chunks of one batch row in order with
// h in VMEM scratch and evaluates each chunk as a log2(chunk)-round
// associative scan over a (chunk, D, N) tensor; its grid has B programs in
// parallel. The recurrence is independent for every (b, d, n) and only y
// sums over n, so here each thread owns (b, d, n) with h in a register and
// walks the sequence itself: L lanes per d (L = N rounded up to a power of
// two, at most 32; a thread holds ceil(N / L) <= 4 states), y summed over
// the L lanes by xor shuffles, lane 0 writing it. A block holds kDTile = 16
// consecutive d of one batch row (16 * L threads). At falcon-mamba's prefill
// shape (B 1, D 8192, N 16) that is 131,072 threads in 512 blocks of 256;
// a thread per d holding all N states would give 8,192 threads, 64 warps,
// and leave most of the 132 SMs idle.
//
// Staging. The reference's `chunk` is the sequence block one program holds
// in fast memory; here it is the block staged through shared memory: per
// chunk, x and dt of the tile's 16 d (rows of 16 consecutive values along
// d) and B and C of the chunk (shared by the whole block) are copied in,
// in their own types, then walked step by step. Shared memory per block is
// chunk * (16 * (sizeof x + sizeof dt) + 2 * N * sizeof x), which the
// wrapper checks against the per-block limit before any build (40,960 B at
// chunk 256, N 16, x bf16, dt f32). Loads are not issued ahead of use.
//
// Bound on one H100 SXM: bytes. At xc (1, 2048, 8192) bf16, dt f32, B/C
// (1, 2048, 16) bf16, N 16, it must read 101 MB and write 68 MB (y f32 and
// h_final), 0.0506 ms at 3.35 TB/s, against 7 operations per (t, d, n)
// (the exp counted as one) plus one per (t, d), 0.028 ms at 67 TFLOP/s.
// The library builds with --fmad=false, so every product and sum is
// rounded on its own, as the plain version rounds them; the sum over n runs
// in another order than the plain version's, and expf may differ from
// torch.exp by an ulp, so the two agree within a tolerance, not bitwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kDTile = 16;      // d per block
constexpr int kMaxStates = 4;   // states per thread: N <= 32 * kMaxStates

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TX, typename TDT>
__global__ void selective_scan_kernel(
    const TX* __restrict__ x, const TDT* __restrict__ dt,
    const TX* __restrict__ Bm, const TX* __restrict__ Cm,
    const float* __restrict__ A, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ hout, int S, int D, int N,
    int L, int chunk) {
  extern __shared__ float4 smem4[];
  TDT* dts = reinterpret_cast<TDT*>(smem4);  // [chunk][kDTile]
  TX* xs = reinterpret_cast<TX*>(dts + chunk * kDTile);  // [chunk][kDTile]
  TX* bs = xs + chunk * kDTile;                          // [chunk][N]
  TX* cs = bs + chunk * N;                               // [chunk][N]

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kDTile;
  const int dl = threadIdx.x / L;
  const int lane = threadIdx.x % L;
  const int d = d0 + dl;
  const bool live = d < D;
  const int per = (N + L - 1) / L;

  float h[kMaxStates], a_dn[kMaxStates];
#pragma unroll
  for (int k = 0; k < kMaxStates; ++k) {
    const int n = lane + k * L;
    const bool mine = live && k < per && n < N;
    h[k] = mine ? h0[((size_t)b * D + d) * N + n] : 0.0f;
    a_dn[k] = mine ? A[(size_t)d * N + n] : 0.0f;
  }

  const size_t row0 = (size_t)b * S;
  for (int t0 = 0; t0 < S; t0 += chunk) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < chunk * kDTile; i += blockDim.x) {
      const int t = i / kDTile;
      const int dd = d0 + i % kDTile;
      const size_t g = (row0 + t0 + t) * D + dd;
      dts[i] = dd < D ? dt[g] : TDT(0.0f);
      xs[i] = dd < D ? x[g] : TX(0.0f);
    }
    const size_t gbc = (row0 + t0) * N;
    for (int i = threadIdx.x; i < chunk * N; i += blockDim.x) {
      bs[i] = Bm[gbc + i];
      cs[i] = Cm[gbc + i];
    }
    __syncthreads();
    for (int t = 0; t < chunk; ++t) {
      const float dtv = to_f32(dts[t * kDTile + dl]);
      const float dx = dtv * to_f32(xs[t * kDTile + dl]);
      float part = 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxStates; ++k) {
        const int n = lane + k * L;
        if (k < per && n < N) {
          const float a = expf(dtv * a_dn[k]);
          h[k] = a * h[k] + dx * to_f32(bs[t * N + n]);
          part = part + h[k] * to_f32(cs[t * N + n]);
        }
      }
      for (int off = L / 2; off > 0; off >>= 1) {
        part = part + __shfl_xor_sync(0xffffffffu, part, off);
      }
      if (lane == 0 && live) {
        y[(row0 + t0 + t) * D + d] = part;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kMaxStates; ++k) {
    const int n = lane + k * L;
    if (live && k < per && n < N) {
      hout[((size_t)b * D + d) * N + n] = h[k];
    }
  }
}

int lanes_for(int N) {
  int L = 1;
  while (L < N && L < 32) L *= 2;
  return L;
}

template <typename TX, typename TDT>
int launch(const void* x, const void* dt, const void* Bm, const void* Cm,
           const float* A, const float* h0, float* y, float* hout, int B,
           int S, int D, int N, int chunk, size_t smem,
           cudaStream_t stream) {
  auto kernel = selective_scan_kernel<TX, TDT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int L = lanes_for(N);
  dim3 grid((D + kDTile - 1) / kDTile, B);
  kernel<<<grid, kDTile * L, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TDT*>(dt),
      static_cast<const TX*>(Bm), static_cast<const TX*>(Cm), A, h0, y, hout,
      S, D, N, L, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// x, Bm, Cm: bf16 when x_bf16, else f32; dt: bf16 when dt_bf16, else f32
// (dt bf16 only with x bf16). Returns a cudaError_t, 0 on success.
extern "C" int selective_scan_fwd(int x_bf16, int dt_bf16, const void* x,
                                  const void* dt, const void* Bm,
                                  const void* Cm, const float* A,
                                  const float* h0, float* y, float* hout,
                                  int B, int S, int D, int N, int chunk,
                                  size_t smem, cudaStream_t stream) {
  if (N < 1 || N > 32 * kMaxStates || chunk < 1 || S % chunk != 0 ||
      (dt_bf16 && !x_bf16)) {
    return (int)cudaErrorInvalidValue;
  }
  if (x_bf16 && dt_bf16) {
    return launch<__nv_bfloat16, __nv_bfloat16>(x, dt, Bm, Cm, A, h0, y, hout,
                                                B, S, D, N, chunk, smem,
                                                stream);
  }
  if (x_bf16) {
    return launch<__nv_bfloat16, float>(x, dt, Bm, Cm, A, h0, y, hout, B, S,
                                        D, N, chunk, smem, stream);
  }
  return launch<float, float>(x, dt, Bm, Cm, A, h0, y, hout, B, S, D, N,
                              chunk, smem, stream);
}
