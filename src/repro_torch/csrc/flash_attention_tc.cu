// Flash-attention forward (K8) on the H100's tensor cores, bf16, sm_90a:
// warpgroup MMA (wgmma) fed by the Tensor Memory Accelerator (TMA).
//
// Replaces: src/repro/kernels/attention/attention.py `flash_attention` ->
// `_flash_kernel` (the Pallas TPU kernel), for bf16 q, k, v. f32 inputs
// stay on the SIMT kernel (`flash_attention.cu`): the reference's f32 dot
// is exact f32, which the bf16 tensor cores cannot give.
//
// What it computes: out = softmax(q k^T * scale) v per head, kv head
// h / (H / Hkv) (GQA); under `causal`, logits where k_pos > q_pos (both
// from 0, the top-left mask) are NEG_INF = -2**30; the row max m, the row
// sum l and the accumulator stay in f32; out = acc / max(l, 1e-30),
// rounded to bf16. P is rounded to bf16 before P V, one rounding more than
// the plain version makes (the tolerance `attention.bf16_bound` derives).
//
// Bound on one H100 SXM: operations. At q (1, 40, 2048, 128), k/v (1, 8,
// 2048, 128), causal, the two products are 4.30e10 FLOP, 0.0434 ms at the
// 989 TFLOP/s of the bf16 tensor cores, against 50 MB of inputs and output
// (0.015 ms at 3.35 TB/s). Only wgmma reaches the tensor cores' full rate,
// so the design is the Hopper one:
// - a block owns 128 query rows of one (b, h): two consumer warpgroups of
//   64 rows (wgmma's M) and a producer warpgroup, one thread of which
//   loads. setmaxnreg takes the producers down to 24 registers a thread
//   and raises the consumers to 240 at run time, but ptxas compiles the
//   block at 168 a thread (65,536 / 384), so the kv tiles shrink as D
//   grows to keep S, P and O within that (D 256 still spills 96 bytes);
// - the producer issues TMA loads of Q (once) and of K and V tiles into a
//   ring of 2 stages, with full and empty mbarriers: the next tile lands
//   while the current one is computed. TMA zero-fills rows and keys past
//   Sq and Skv (masked here) and columns past D;
// - S = Q K^T is wgmma with Q and K from shared memory (K stored [key][d]
//   and read K-major, 128-byte swizzle), its f32 accumulator in registers;
//   the online softmax runs there, its row max and sum from the quad
//   shuffles of the accumulator layout; P is rounded to bf16 in registers
//   and is wgmma's A operand for O += P V, with V from shared memory read
//   with the transpose bit (its rows are D-contiguous); O stays in
//   registers (D / 2 floats a thread);
// - the head dim is a template parameter (64, 128, 192, 256; a smaller D
//   multiple of 8 rides the next with zero-filled columns) and the kv
//   tiles are 128 keys up to D 128, 64 at D 192 and 32 at D 256: at most
//   161 KB of shared memory, the kernel's own choice whatever blocks the
//   caller names;
// - the tensor maps take q, k and v by their strides, and the output rows
//   are stored by theirs, so the model's (B, S, K, G, D) and (B, S, K, D)
//   tensors are read and written in place; the maps of recent launches
//   are cached, so a repeated launch encodes none;
// - kv tiles wholly above the diagonal are skipped (exact: see
//   flash_attention.cu), only diagonal or ragged tiles are masked, and the
//   q tiles with the most causal work launch first.
// cuTensorMapEncodeTiled comes through cudaGetDriverEntryPoint, so the
// library links no -lcuda.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 2;                      // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);   // + the producer group
constexpr int kProducerRegs = 24;     // registers a thread after setmaxnreg:
constexpr int kConsumerRegs = 240;    // 128 x 24 + 256 x 240 <= 65536
constexpr int kBQ = 64 * kConsumers;               // query rows of a block
constexpr int kStages = 2;
constexpr int kCol = 64;           // bf16 in a 128-byte swizzled row
constexpr float kNegInf = -1073741824.0f;          // -2**30, the reference's
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  __nv_bfloat16* o;
  long long o_b, o_h, o_s;   // element strides of the output (d stride 1)
  int H, Hkv, Sq, Skv, D, causal;
  float scale_log2;          // scale * log2(e): exp(x) = exp2(x log2 e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Wait for the phase of `bar` with this parity to complete. A wait that
// outlasts some 2**26 polls (seconds) traps, so that a fault in the
// pipeline ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// one TMA box of a 4-d tensor map (d, s, h, b) into shared memory, counted
// on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int d, int s, int h, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(s), "r"(h), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

// a wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), swizzle 128B
__device__ __forceinline__ uint64_t desc(const void* p, int lbo, int sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N wgmma groups of this thread are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator registers across the async
// wgmma's issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2**x by the special-function unit (relative error about 2**-22, far
// inside the bf16 rounding of P)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 32 f32) = (scale_d ? d : 0) + A (64 x 16 bf16, shared, K-major)
// * B (32 keys x 16 bf16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 f32) = (scale_d ? d : 0) + A (64 x 16 bf16, shared, K-major)
// * B (64 keys x 16 bf16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128 f32) = (scale_d ? d : 0) + A (64 x 16 bf16, shared, K-major)
// * B (128 keys x 16 bf16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 f32) += A (64 x 16 bf16, registers) * B (16 x 64 bf16,
// shared, MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t a[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32) += A (64 x 16 bf16, registers) * B (16 x 128 bf16,
// shared, MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t a[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 192 f32) += A (64 x 16 bf16, registers) * B (16 x 192 bf16,
// shared, MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n192(float* d, const uint32_t a[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256 f32) += A (64 x 16 bf16, registers) * B (16 x 256 bf16,
// shared, MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t a[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 32) wgmma_ss_n32(d, da, db, scale_d);
  else if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t a[4],
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (N == 192) wgmma_rs_n192(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// Shared memory of a block: Q (DP / 64 column blocks of kBQ rows of 128
// bytes), then a ring of kStages K tiles and kStages V tiles (DP / 64
// column blocks of BK rows each), then the mbarriers; 1024 bytes of slack
// align the swizzled tiles.
template <int DP, int BK>
constexpr int smem_bytes() {
  return 1024 + (DP / kCol) * 128 * (kBQ + 2 * kStages * BK) +
         8 * (1 + 2 * kStages);
}

// One block: kBQ query rows of head h of batch b; consumer warpgroup g
// owns rows 64g..64g+63 (warp w of it rows 16w..16w+15 of those), the
// first thread of the last warpgroup loads.
// named barriers: 0 is __syncthreads, 1 + g consumer warpgroup g's own
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Issue S = Q K^T for consumer warpgroup g (its 64 rows of Q, the BK keys
// of the K tile at `kt`); S is written when the wgmma group completes.
template <int DP, int BK>
__device__ __forceinline__ void qk_tile(float* s, const uint8_t* sQ,
                                        const uint8_t* kt, int g) {
  constexpr int QCB = kBQ * 128, KCB = BK * 128;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss<BK>(
        s, desc(sQ + (kk / 4) * QCB + g * 64 * 128 + (kk % 4) * 32, 16, 1024),
        desc(kt + (kk / 4) * KCB + (kk % 4) * 32, 16, 1024), kk > 0);
}

// Issue O += P V for a warpgroup: P (bf16) from registers, the V tile at
// `vt` read MN-major (the transpose bit).
template <int DP, int BK>
__device__ __forceinline__ void pv_tile(float* o, const uint32_t* p,
                                        const uint8_t* vt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<DP>(o, p + 4 * kk, desc(vt + kk * 16 * 128, BK * 128, 1024));
}

// One S tile's online softmax in base 2, in registers: mask (keys past
// Skv, and under causal keys past the row) where `masked`, the row max m
// over the unscaled logits (quad shuffles of the accumulator layout),
// corr = 2**((m_old - m) c), l = l corr + sum p, P = 2**(s c - m c) in
// bf16 as wgmma's A fragments; c = scale log2 e. The caller scales O by
// corr.
template <int BK>
__device__ __forceinline__ void softmax_tile(float* s, uint32_t* p, float* m,
                                             float* l, float* corr, int k0,
                                             int row0, int lane, bool masked,
                                             const Params& a) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    if (masked) {
      const int key = k0 + (i / 4) * 8 + 2 * (lane & 3) + (i & 1);
      const int row = row0 + ((i >> 1) & 1) * 8;
      if (key >= a.Skv || (a.causal && key > row)) s[i] = kNegInf;
    }
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = ex2((m[r] - mx[r]) * a.scale_log2);
    m[r] = mx[r];
    mc[r] = mx[r] * a.scale_log2;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const float p0 = ex2(fmaf(s[i], a.scale_log2, -mc[r]));
    const float p1 = ex2(fmaf(s[i + 1], a.scale_log2, -mc[r]));
    l[r] += p0 + p1;
    p[i / 2] = pack_bf16(p0, p1);
  }
}

template <int DP, int BK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const Params a) {
  constexpr int NCB = DP / kCol;     // column blocks of a row
  constexpr int QCB = kBQ * 128;     // bytes of a Q column block
  constexpr int KCB = BK * 128;      // bytes of a K or V column block
  constexpr int KV = NCB * KCB;      // bytes of a K or V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sQ + NCB * QCB;
  uint8_t* sV = sK + kStages * KV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * KV);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the warpgroup, broadcast so that the compiler sees it warp-uniform
  // (setmaxnreg applies to a region that a uniform branch opens)
  const int group = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // most work first
  const int h = blockIdx.y, b = blockIdx.z;
  int nk = (a.Skv + BK - 1) / BK;
  if (a.causal) nk = min(nk, (q0 + kBQ - 1) / BK + 1);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (group == kConsumers) {   // the producer warpgroup: one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (warp == 4 * kConsumers && lane == 0) {
      const int hk = h / (a.H / a.Hkv);
      mbar_expect_tx(q_full, NCB * QCB);
      for (int cb = 0; cb < NCB; ++cb)
        tma_load(sQ + cb * QCB, &tq, cb * kCol, q0, h, b, q_full);
      for (int j = 0; j < nk; ++j) {
        const int st = j % kStages;
        mbar_wait(&empty[st], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * KV);
        for (int cb = 0; cb < NCB; ++cb) {
          tma_load(sK + st * KV + cb * KCB, &tk, cb * kCol, j * BK, hk, b,
                   &full[st]);
          tma_load(sV + st * KV + cb * KCB, &tv, cb * kCol, j * BK, hk, b,
                   &full[st]);
        }
      }
    }
  } else {   // the consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    const int wg = group, w = warp % 4;
    const int rr0 = wg * 64 + w * 16 + lane / 4;   // block rows rr0, rr0 + 8
    const int row0 = q0 + rr0;
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};
    mbar_wait(q_full, 0);

    for (int j = 0; j < nk; ++j) {
      const int st = j % kStages;
      mbar_wait(&full[st], (j / kStages) & 1);
      float s[BK / 2], corr[2];
      uint32_t p[BK / 4];
      qk_tile<DP, BK>(s, sQ, sK + st * KV, wg);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BK / 2>(s);
      // mask only a tile with a key past Skv, or (causal) past the
      // warp's first row
      const int k_end = (j + 1) * BK;
      const bool masked = k_end > a.Skv ||
                          (a.causal && k_end - 1 > q0 + wg * 64 + w * 16);
      softmax_tile<BK>(s, p, m, l, corr, j * BK, row0, lane, masked, a);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      pv_tile<DP, BK>(o, p, sV + st * KV);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<DP / 2>(o);
      fence_regs<BK / 4>(p);
      mbar_arrive(&empty[st]);
    }

    // out = O / max(l, 1e-30) in bf16, staged in this warpgroup's Q rows (the
    // same swizzled layout), then stored as 16-byte rows
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.0f / fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = rr0 + 8 * r;
        uint8_t* dst = sQ + (i / 8) * QCB + rr * 128 +
                       (((i % 8) ^ (rr & 7)) * 16) + (lane & 3) * 4;
        *reinterpret_cast<uint32_t*>(dst) =
            pack_bf16(o[4 * i + 2 * r] * inv[r], o[4 * i + 2 * r + 1] * inv[r]);
      }
    }
    bar_sync(1 + wg, 128);
    __nv_bfloat16* ob = a.o + b * a.o_b + h * a.o_h;
    for (int i = tid % 128; i < 64 * DP / 8; i += 128) {
      const int rr = wg * 64 + i / (DP / 8), c = i % (DP / 8);
      const int row = q0 + rr;
      if (row < a.Sq && c * 8 < a.D)
        *reinterpret_cast<uint4*>(ob + row * a.o_s + c * 8) =
            *reinterpret_cast<const uint4*>(sQ + (c / 8) * QCB + rr * 128 +
                                            (((c % 8) ^ (rr & 7)) * 16));
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver the runtime loaded (null where
// it has none)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d (d, s, h, b) bf16 tensor map of boxes of 64 d (128 bytes, swizzled
// 128B) by `rows` s; strides in elements. Columns and rows past the
// extents read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, long long sb, long long sh,
              long long ss, int B, int H, int S, int D, int rows) {
  EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {kCol, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor maps of recent launches, by everything a map encodes (a run
// calls K8 on a few shapes and addresses over and over). Not guarded: the
// port launches from one host thread.
struct MapKey {
  const void* ptr;
  long long sb, sh, ss;
  int B, H, S, D, rows;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && sb == o.sb && sh == o.sh && ss == o.ss &&
           B == o.B && H == o.H && S == o.S && D == o.D && rows == o.rows;
  }
};
constexpr int kMapCache = 64;
MapKey map_keys[kMapCache];
CUtensorMap map_vals[kMapCache];
int map_used = 0, map_next = 0;

bool cached_map(CUtensorMap* map, const MapKey& key) {
  for (int i = 0; i < map_used; ++i)
    if (map_keys[i] == key) {
      *map = map_vals[i];
      return true;
    }
  if (!make_map(map, key.ptr, key.sb, key.sh, key.ss, key.B, key.H, key.S,
                key.D, key.rows))
    return false;
  map_keys[map_next] = key;
  map_vals[map_next] = *map;
  map_next = (map_next + 1) % kMapCache;
  if (map_used < kMapCache) ++map_used;
  return true;
}

struct Operands {
  const void *q, *k, *v;
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s;
  int B;
};

// Allow the build its dynamic shared memory on the current card, once a
// card.
template <int DP, int BK>
cudaError_t allow_smem() {
  static unsigned long long done = 0;   // a bit a card
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && (done >> dev & 1))) return err;
  err = cudaFuncSetAttribute(flash_wgmma_kernel<DP, BK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<DP, BK>());
  if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
  return err;
}

template <int DP, int BK>
int launch(const Operands& x, const Params& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!cached_map(&tq, {x.q, x.q_b, x.q_h, x.q_s, x.B, a.H, a.Sq, a.D, kBQ}) ||
      !cached_map(&tk,
                  {x.k, x.k_b, x.k_h, x.k_s, x.B, a.Hkv, a.Skv, a.D, BK}) ||
      !cached_map(&tv,
                  {x.v, x.v_b, x.v_h, x.v_s, x.B, a.Hkv, a.Skv, a.D, BK}))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<DP, BK>();
  cudaError_t err = allow_smem<DP, BK>();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, x.B);
  flash_wgmma_kernel<DP, BK><<<grid, kThreads, smem, stream>>>(tq, tk, tv,
                                                                a);
  return (int)cudaGetLastError();
}

// out: registers and local (spill) bytes per thread, dynamic shared bytes
// and resident blocks per SM of the build
template <int DP, int BK>
int attrs(int* out) {
  constexpr int smem = smem_bytes<DP, BK>();
  cudaError_t err = allow_smem<DP, BK>();
  cudaFuncAttributes fa;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&fa, flash_wgmma_kernel<DP, BK>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, flash_wgmma_kernel<DP, BK>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = smem;
  out[3] = blocks;
  return 0;
}

}  // namespace

// q, o: (B, H, Sq, D); k, v: (B, Hkv, Skv, D); bf16, each addressed by its
// (b, h, s) element strides with unit d stride. The caller checks H % Hkv
// == 0, D % 8 == 0, D <= 256, every stride a multiple of 8 elements and
// every pointer 16-byte aligned. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a D it was not built for, or a tensor map
// the CUDA driver refuses).
extern "C" int flash_attention_tc_fwd(
    const void* q, const void* k, const void* v, void* o, long long q_b,
    long long q_h, long long q_s, long long k_b, long long k_h, long long k_s,
    long long v_b, long long v_h, long long v_s, long long o_b, long long o_h,
    long long o_s, int B, int H, int Hkv, int Sq, int Skv, int D, int causal,
    float scale, void* stream) {
  const Operands x{q, k, v, q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, B};
  const Params a{static_cast<__nv_bfloat16*>(o), o_b, o_h, o_s, H, Hkv, Sq,
                 Skv, D, causal, scale * kLog2e};
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 64) return launch<64, 128>(x, a, s);
  if (D <= 128) return launch<128, 128>(x, a, s);
  if (D <= 192) return launch<192, 64>(x, a, s);
  if (D <= 256) return launch<256, 32>(x, a, s);
  return (int)cudaErrorInvalidValue;
}

// The build that runs head dim D (see flash_attention_tc_fwd): out[0..3] =
// registers, spilled bytes per thread, shared bytes, resident blocks per
// SM. Returns a cudaError_t.
extern "C" int flash_attention_tc_attrs(int D, int* out) {
  if (D <= 64) return attrs<64, 128>(out);
  if (D <= 128) return attrs<128, 128>(out);
  if (D <= 192) return attrs<192, 64>(out);
  if (D <= 256) return attrs<256, 32>(out);
  return (int)cudaErrorInvalidValue;
}
