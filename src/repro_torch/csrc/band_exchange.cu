// In-kernel halo-band exchange (K7) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/advection/advection.py `halo_band_exchange_dma`
// -> `_kernel_band_dma` (the Pallas TPU kernel that issues
// `make_async_remote_copy` from inside the kernel).
//
// What it moves: one exchange phase of a mesh, for every shard of one card
// in one launch. Each shard has, per field and slot (block_index % 2), an
// EXTENDED buffer, the slab the local kernel (K1) reads next: the shard's own
// planes in the middle and `depth` halo planes (dim 0) or rows (dim 1) on
// each side. A message is one copy into such a buffer: the shard's own field
// into its interior (skipped when the field already lies there, as in the y
// phase, which sends from the x-extended buffer), or one `_band_schedule`
// band (field, side, hop) of the sender's field into the k-away ring
// neighbour's halo. The wrapper (`advection._band_exchange_cuda`) builds the
// table of messages once per buffers, slot and layout and keeps it in device
// memory: per message a source index and offset, a destination address, the
// receiver's arrival word (0 on the same card), `runs` runs of `run` bytes
// with their strides, and its first tile. Per call only the sources' base
// pointers travel, by value. The table counts bytes, so the kernel is blind
// to the cells' type: f32 and bf16 fields move alike, bit for bit.
//
// Bound on one H100 SXM: bytes, and at the path's shape launch latency. At
// 67M on a (2, 2) loopback mesh, T = 4, the x phase moves each shard once
// into its buffer (805 MB read, 805 MB written) and 12.6 MB of bands, the y
// phase 12.8 MB of bands: 1.66 GB a block read or written, 0.496 ms at 3.35
// TB/s (half in bf16). The bands alone are 50.7 MB read and written, 0.015
// ms: below a launch's latency, so the design puts a card's whole phase
// into ONE launch.
//
// Design:
//   * One put launch per card and phase carries every message of every
//     shard on that card. The work is cut into tiles of kTileUnits 16-byte
//     units, never across messages; a grid of one wave (the card's SMs times
//     the blocks each holds, planned by the wrapper) walks the tiles, and a
//     block finds a tile's message by a binary search over the table's
//     first tiles. Each thread has kUnitsPerThread 16-byte loads in flight
//     before it stores them. A message whose run, strides, offsets or bases
//     are not 16-byte multiples (a row of Z cells that is not, an odd view)
//     takes the narrow path, unit by unit in 2-byte moves (every cell is 2
//     or 4 bytes).
//   * Senders and receivers on one card share its stream, so stream order is
//     the handshake there: no enter, no wait, no fence. Only a card whose
//     messages cross to another card's buffers (peer stores over NVLink,
//     through UVA) keeps the reference's handshake, per card, on u64 words
//     monotone over epochs: enter signals each sending partner card's
//     barrier word (the receiver has entered this exchange, so the slot
//     being written is vacant); the put waits for its barrier word, stores,
//     and after each tile of a crossing message `__threadfence_system()`s
//     and adds one to the receiver card's arrival word; wait spins until its
//     arrival word reaches the tiles due. Each spin is bounded in wall time
//     (%globaltimer, in ns, independent of the SM clock): past the bound the
//     kernel sets a bit of the card's error word and returns, and the
//     wrapper's check raises naming it.
//   * No TMA: the x phase's runs are contiguous (128 KB an x-plane of a
//     band or interior), the y phase's are rows of Z cells (256 B at Z = 64
//     in f32, 128 B in bf16); plain 16-byte loads and stores already move
//     whole lines.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnitsPerThread = 4;  // 16-byte loads in flight per thread
constexpr int kTileUnits = kThreads * kUnitsPerThread;  // 16 KB a tile
constexpr int kMaxSources = 96;     // 3 fields x 32 shards on one card
constexpr int kMaxPartners = 32;
constexpr unsigned long long kErrEnter = 1ull;   // put: partners never entered
constexpr unsigned long long kErrArrive = 2ull;  // wait: bands never arrived

// One row of the wrapper's table: int64 columns in this order
// (`advection.BAND_COLUMNS`), every size and offset in bytes.
struct Msg {
  long long src;         // index into the call's source bases
  long long src_off;     // bytes from that base to the message's first byte
  long long dst;         // address of its first byte in the receiver's buffer
  long long arrive;      // receiver card's arrival word; 0 on the same card
  long long runs;        // runs of `run` bytes
  long long run;
  long long src_stride;  // bytes from one run to the next
  long long dst_stride;
  long long vec16;       // run, strides, offset and dst allow 16-byte moves
  long long tile0;       // the message's first tile
};
static_assert(sizeof(Msg) == 10 * sizeof(long long), "table row layout");

struct Sources {
  const char* p[kMaxSources];
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

// The message holding tile t: the last row whose first tile is <= t.
__device__ __forceinline__ const Msg* find_msg(const Msg* msgs, int n,
                                               long long t) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(&msgs[mid].tile0) <= t) lo = mid;
    else hi = mid - 1;
  }
  return &msgs[lo];
}

// words: this card's [barrier, arrivals, error], or null when no message
// crosses to another card. Bytes of one message are indexed i in
// [0, runs * run) < 2^31 (the wrapper checks), run o = i / run.
__global__ void __launch_bounds__(kThreads) band_put_kernel(
    const Msg* __restrict__ msgs, int n_msgs, long long n_tiles, Sources srcs,
    int srcs_vec16, unsigned long long* words, unsigned long long enter_want,
    long long timeout_ns) {
  if (words != nullptr) {
    __shared__ int entered;
    if (threadIdx.x == 0) {
      entered = wait_at_least(&words[0], enter_want, timeout_ns);
      if (!entered) atomicOr(&words[2], kErrEnter);
    }
    __syncthreads();
    if (!entered) return;
  }
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const Msg* m = find_msg(msgs, n_msgs, t);
    const char* src = srcs.p[__ldg(&m->src)] + __ldg(&m->src_off);
    char* dst = reinterpret_cast<char*>(__ldg(&m->dst));
    const unsigned run = (unsigned)__ldg(&m->run);
    const unsigned n = (unsigned)(__ldg(&m->runs) * __ldg(&m->run));
    const long long ss = __ldg(&m->src_stride);
    const long long ds = __ldg(&m->dst_stride);
    const unsigned u0 =
        (unsigned)((t - __ldg(&m->tile0)) * kTileUnits) + threadIdx.x;
    if (__ldg(&m->vec16) && srcs_vec16) {
      uint4 v[kUnitsPerThread];
#pragma unroll
      for (int j = 0; j < kUnitsPerThread; ++j) {
        const unsigned i = 16u * (u0 + j * kThreads);
        if (i < n) {
          const unsigned o = i / run, w = i - o * run;
          v[j] = __ldg(reinterpret_cast<const uint4*>(src + o * ss + w));
        }
      }
#pragma unroll
      for (int j = 0; j < kUnitsPerThread; ++j) {
        const unsigned i = 16u * (u0 + j * kThreads);
        if (i < n) {
          const unsigned o = i / run, w = i - o * run;
          *reinterpret_cast<uint4*>(dst + o * ds + w) = v[j];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kUnitsPerThread; ++j) {
        const unsigned base = 16u * (u0 + j * kThreads);
#pragma unroll
        for (int q = 0; q < 16; q += 2) {
          const unsigned i = base + q;
          if (i < n) {
            const unsigned o = i / run, w = i - o * run;
            *reinterpret_cast<unsigned short*>(dst + o * ds + w) =
                __ldg(reinterpret_cast<const unsigned short*>(src + o * ss +
                                                              w));
          }
        }
      }
    }
    const long long arrive = __ldg(&m->arrive);
    if (arrive != 0) {
      __threadfence_system();
      __syncthreads();
      if (threadIdx.x == 0)
        atomicAdd_system(reinterpret_cast<unsigned long long*>(arrive), 1ull);
    }
  }
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

// barriers: n (<= kMaxPartners) device pointers to the sending partner
// cards' barrier words. Returns the cudaError_t of the launch, or
// cudaErrorInvalidValue for too many partners.
extern "C" int band_exchange_enter(void* const* barriers, int n,
                                   void* stream) {
  if (n < 1 || n > kMaxPartners) return (int)cudaErrorInvalidValue;
  Partners p{};
  for (int i = 0; i < n; ++i)
    p.barrier[i] = static_cast<unsigned long long*>(barriers[i]);
  band_enter_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(p, n);
  return (int)cudaGetLastError();
}

// table: n_msgs rows of `Msg` in device memory, their tiles numbered
// 0 .. n_tiles - 1 in row order. sources: n_sources (<= kMaxSources) device
// pointers, the bases the rows index; srcs_vec16: every base is 16-byte
// aligned. grid: blocks of kThreads walking the tiles.
extern "C" int band_exchange_put(const void* table, int n_msgs,
                                 long long n_tiles, int grid,
                                 void* const* sources, int n_sources,
                                 int srcs_vec16, void* words,
                                 unsigned long long enter_want,
                                 long long timeout_ns, void* stream) {
  if (n_msgs < 1 || n_tiles < 1 || grid < 1 || n_sources < 1 ||
      n_sources > kMaxSources)
    return (int)cudaErrorInvalidValue;
  Sources s{};
  for (int i = 0; i < n_sources; ++i)
    s.p[i] = static_cast<const char*>(sources[i]);
  band_put_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const Msg*>(table), n_msgs, n_tiles, s, srcs_vec16,
      static_cast<unsigned long long*>(words), enter_want, timeout_ns);
  return (int)cudaGetLastError();
}

extern "C" int band_exchange_wait(void* words, unsigned long long want,
                                  long long timeout_ns, void* stream) {
  band_wait_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      static_cast<unsigned long long*>(words), want, timeout_ns);
  return (int)cudaGetLastError();
}

// out: [registers, local (spill) bytes, resident put blocks per SM, threads
// a block, units a tile, most sources, most partners] on the current card.
extern "C" int band_exchange_attrs(int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, band_put_kernel);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, band_put_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = per_sm;
  out[3] = kThreads;
  out[4] = kTileUnits;
  out[5] = kMaxSources;
  out[6] = kMaxPartners;
  return 0;
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
