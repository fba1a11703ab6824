// In-kernel halo-band exchange (K7) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/advection/advection.py `halo_band_exchange_dma`
// -> `_kernel_band_dma` (the Pallas TPU kernel that issues
// `make_async_remote_copy` from inside the kernel).
//
// What it moves: for each shard, field, side and `_band_schedule` hop, the
// `cnt` boundary planes (dim 0) or rows (dim 1) of the sender's field go into
// the k-away ring neighbour's double-buffered recv slab, at the hop's recv
// offset in slot block_index % 2. The wrapper (`advection._band_exchange_cuda`)
// turns that schedule into one message per (field, side, hop): a source
// pointer, a destination pointer already offset to its slab, slot and hop,
// and the receiver's arrival counter.
//
// Design. The TPU stages each band through VMEM only because its DMA engine
// needs a source there; here threads load the band from the sender's field
// and store it straight into the receiver's slab, 16 bytes a thread where
// every run and base is 16-byte aligned. On a mesh of distinct cards the
// receiver's slab and counters are peer (UVA) pointers, so the stores cross
// NVLink; on a loopback mesh they stay in one card's memory.
//
// The reference's handshake is split into three kernels, so that one stream
// can carry every shard of a loopback mesh without deadlock:
//   enter: signal each partner's barrier word (the capacity handshake of
//          `_kernel_band_dma`: the receiver has entered this block's
//          exchange, so the slot being written is vacant);
//   put:   wait until my barrier word reaches its epoch's count, store the
//          bands, `__threadfence_system()`, then add one per block to the
//          receiver's arrival word;
//   wait:  spin until my arrival word reaches its epoch's count.
// The words are u64, monotone over epochs (one exchange = one epoch), so no
// exchange resets them. On a loopback mesh the host issues every enter, then
// every put, then every wait on the one stream, so each wait is already met
// when it runs. Each spin is bounded in wall time (%globaltimer, in ns, not
// clock64: it does not depend on the SM clock): past the bound the kernel
// sets a bit of the shard's error word and returns, and the wrapper's check
// raises naming it.
//
// Bound on one H100 SXM: bytes, and at the path's shape launch latency. Per
// shard and block at (2, 2), T = 4, the two phases move 6,340,608 B; on a
// loopback mesh each byte is read and written once in HBM (3.35 TB/s), across
// cards each byte crosses NVLink once (450 GB/s each way). Either is a few
// microseconds, against three launches per shard and phase.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHops = 8;
constexpr int kMaxMsgs = 3 * 2 * kMaxHops;  // field x side x hop
constexpr int kMaxPartners = 2 * kMaxHops;
constexpr int kThreads = 256;
constexpr unsigned long long kErrEnter = 1ull;  // put: partners never entered
constexpr unsigned long long kErrArrive = 2ull;  // wait: bands never arrived

struct Messages {
  const float* src[kMaxMsgs];           // first word of the band
  float* dst[kMaxMsgs];                 // receiver's slab, slot and offset
  unsigned long long* arrive[kMaxMsgs];  // receiver's arrival word
  int cnt[kMaxMsgs];                    // planes/rows of the band
};

struct Partners {
  unsigned long long* barrier[kMaxPartners];
};

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *word >= want or timeout_ns pass; true when met.
__device__ bool wait_at_least(const unsigned long long* word,
                              unsigned long long want, long long timeout_ns) {
  const unsigned long long t0 = globaltimer();
  while (*reinterpret_cast<const volatile unsigned long long*>(word) < want) {
    if ((long long)(globaltimer() - t0) > timeout_ns) return false;
    __nanosleep(64);
  }
  __threadfence_system();
  return true;
}

__global__ void band_enter_kernel(Partners p, int n) {
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    __threadfence_system();
    for (int i = 0; i < n; ++i) atomicAdd_system(p.barrier[i], 1ull);
  }
}

// words: my [barrier, arrivals, error]. Message m = blockIdx.y; its band is
// `runs` runs of cnt * inner floats, src_stride / dst_stride floats apart.
template <bool kVec4>
__global__ void __launch_bounds__(kThreads) band_put_kernel(
    Messages msg, int runs, int inner, long long src_stride,
    long long dst_stride, unsigned long long* words,
    unsigned long long barrier_want, long long timeout_ns) {
  __shared__ int entered;
  if (threadIdx.x == 0) {
    entered = wait_at_least(&words[0], barrier_want, timeout_ns);
    if (!entered) atomicOr(&words[2], kErrEnter);
  }
  __syncthreads();
  if (!entered) return;
  const int m = blockIdx.y;
  const float* src = msg.src[m];
  float* dst = msg.dst[m];
  constexpr int V = kVec4 ? 4 : 1;
  const long long run = (long long)msg.cnt[m] * inner / V;  // vectors a run
  const long long total = run * runs;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const long long o = i / run, e = i - o * run;
    if (kVec4) {
      reinterpret_cast<float4*>(dst + o * dst_stride)[e] =
          reinterpret_cast<const float4*>(src + o * src_stride)[e];
    } else {
      dst[o * dst_stride + e] = src[o * src_stride + e];
    }
  }
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd_system(msg.arrive[m], 1ull);
}

__global__ void band_wait_kernel(unsigned long long* words,
                                 unsigned long long want,
                                 long long timeout_ns) {
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    if (!wait_at_least(&words[1], want, timeout_ns))
      atomicOr(&words[2], kErrArrive);
  }
}

}  // namespace

// barriers: n (<= 2 * kMaxHops) device pointers to the partners' barrier
// words. Returns the cudaError_t of the launch, or 1 (cudaErrorInvalidValue)
// for too many partners.
extern "C" int band_exchange_enter(void* const* barriers, int n,
                                   void* stream) {
  if (n < 0 || n > kMaxPartners) return (int)cudaErrorInvalidValue;
  Partners p{};
  for (int i = 0; i < n; ++i)
    p.barrier[i] = static_cast<unsigned long long*>(barriers[i]);
  band_enter_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(p, n);
  return (int)cudaGetLastError();
}

// srcs, dsts, arrives: n_msgs (<= 3 * 2 * kMaxHops) device pointers; cnts:
// n_msgs band sizes. blocks: blocks per message. vec4: every base, run and
// stride is a multiple of 4 floats and 16-byte aligned.
extern "C" int band_exchange_put(void* const* srcs, void* const* dsts,
                                 void* const* arrives, const int* cnts,
                                 int n_msgs, int blocks, int runs, int inner,
                                 long long src_stride, long long dst_stride,
                                 int vec4, void* words,
                                 unsigned long long barrier_want,
                                 long long timeout_ns, void* stream) {
  if (n_msgs < 1 || n_msgs > kMaxMsgs || blocks < 1)
    return (int)cudaErrorInvalidValue;
  Messages msg{};
  for (int i = 0; i < n_msgs; ++i) {
    msg.src[i] = static_cast<const float*>(srcs[i]);
    msg.dst[i] = static_cast<float*>(dsts[i]);
    msg.arrive[i] = static_cast<unsigned long long*>(arrives[i]);
    msg.cnt[i] = cnts[i];
  }
  dim3 grid(blocks, n_msgs);
  auto* w = static_cast<unsigned long long*>(words);
  if (vec4)
    band_put_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        msg, runs, inner, src_stride, dst_stride, w, barrier_want,
        timeout_ns);
  else
    band_put_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        msg, runs, inner, src_stride, dst_stride, w, barrier_want,
        timeout_ns);
  return (int)cudaGetLastError();
}

extern "C" int band_exchange_wait(void* words, unsigned long long want,
                                  long long timeout_ns, void* stream) {
  band_wait_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      static_cast<unsigned long long*>(words), want, timeout_ns);
  return (int)cudaGetLastError();
}

// Let card `dev` store into card `peer`'s memory. Returns 0 when enabled or
// already enabled, -1 when the pair has no peer access, else the
// cudaError_t. Restores the calling thread's current device.
extern "C" int band_exchange_enable_peer(int dev, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return -1;
  int old = 0;
  err = cudaGetDevice(&old);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    err = cudaSuccess;
  }
  cudaError_t back = cudaSetDevice(old);
  return (int)(err != cudaSuccess ? err : back);
}
