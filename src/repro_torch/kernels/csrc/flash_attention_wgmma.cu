// Hopper (sm_90a) forward flash attention in bf16 on the tensor cores: the
// same function as the kernel in flash_attention.cu (the float32 route,
// whose operands go to the bf16 tensor cores in three pieces each),
//
//     s   = (q . k) / sqrt(D)                              (f32)
//     s   = softcap * tanh(s / softcap)          when softcap > 0
//     s   = -inf  unless  kpos < Sk  [and kpos <= qpos]  [and qpos - kpos < window]
//     out = softmax(s) . v,  with qpos = q_offset + row
//
// taken as an online softmax over 64-key tiles with f32 running max m, sum
// l and accumulator acc; the output is acc / max(l, 1e-37), rounded once to
// bf16, and, when asked (`lse` not null: training), each row's f32
// log-sum-exp m + log(max(l, 1e-37)) to lse (B, H, Sq) for the backward
// kernel (flash_attention_bwd.cu). Query head h reads kv head h / (H / KV);
// no K/V is repeated.
//
// Replaces the TPU kernel `flash_attention_pallas` in
// src/repro/kernels/flash_attention.py (`_flash_kernel` at line 27,
// pallas_call at line 95) for bf16 inputs; what it keeps from the TPU
// kernel and what differs (the exact skip of fully masked KV tiles, the
// safe running max, the right-pad mask against the true Sk) is said in
// flash_attention.cu and holds here too.
//
// What bounds it on an H100: at the gemma2-9b prefill shape (B=4, H=16,
// KV=8, S=4608, D=256) the work is 4 B H D per unmasked (query, key) pair,
// ~7e11 FLOP against 453 MB of Q/K/V/O: the 989 TFLOP/s of the bf16 tensor
// cores, ~0.70 ms.
//
// Design. One block per (128 query rows, head, batch), 384 threads:
//   * warpgroup 0 is the producer. Its first thread loads Q once and then
//     K and V, 64 keys a stage, into a two-stage ring with TMA
//     (cp.async.bulk.tensor, 128-byte swizzle, 32-byte at D = 16) guarded by
//     mbarriers: `full` (the bytes arrived) and `empty` (all 8 consumer
//     warps are done with the stage). The boxes address the models'
//     (B, S, NH, D) layout through strides, and TMA zero-fills rows past S.
//   * warpgroups 1 and 2 each own 64 query rows. Per stage: S = Q K^T by
//     wgmma m64n64k16 with both operands K-major in shared memory; scale,
//     softcap, the mask (only on tiles a mask can reach: the diagonal, the
//     window edge and the right pad), the online softmax in registers; then
//     O += P V by wgmma m64nDk16 with P from registers (the S accumulator's
//     layout is the A fragment's for 16-bit types) and V MN-major in shared
//     memory, read through wgmma's transpose flag.
//   * registers are rebalanced with setmaxnreg: 24 for the producer, 240 for
//     the consumers, which hold O (D/2 f32 a thread, 128 at D = 256).
//   * blocks are numbered heaviest first: the last causal query tiles, which
//     see the most keys, start in the first wave.
//
// P near f32 accuracy on bf16 tensor cores. A kernel that rounds P to bf16
// before P.V puts up to 2^-8 relative error on every weight, and its output
// then misses the f32 result correctly rounded by far more than the
// 2^-18 max|v| noise that chip_smoke.py allows. So P is split:
// p_hi = bf16(p) and p_lo = bf16(p - p_hi) (p - p_hi is exact in f32), and
// P.V is issued twice, p_hi then p_lo, into one f32 accumulator. What is
// left out is at most
// 2^-16 p, of either sign from key to key, so the output moves by far less
// than 2^-18 max|v|. The row sums l take the f32 p. Q.K^T needs no such
// care: bf16 products are exact in the f32 accumulator. expf and tanhf are
// the accurate ones (no --use_fast_math).
//
// Masked keys score -inf and the running max is safe (m == -inf is used as
// 0 in the exponents), so a masked key adds exactly 0 wherever it falls: the
// skipped tiles change nothing and a row that sees no key gives 0. A
// warpgroup whose rows a tile cannot reach skips its products (it still
// waits for the stage and releases it). There are no atomics and every
// reduction has a fixed order, so two launches agree bitwise.
//
// Shared memory: Q 128 x D, K and V 2 x 64 x D, all bf16, plus 64 bytes of
// barriers and up to 1 KB to align the ring to the swizzle's 1024 bytes:
// 197,696 bytes at D = 256.
//
// Head dims 96 and 112 (phi3-mini, zamba2-7b) run the D = 128 layout, padded
// inside the kernel, with the true head dim DT as a second template
// parameter: the TMA maps declare DT as the inner extent, with true-DT
// strides (192 and 224 bytes, multiples of 16), so the second 64-column box
// reads columns DT..127 as zeros (out-of-bounds fill), and the epilogue
// stores only the columns below DT. Zero q and k columns add nothing to
// q . k, the padded v columns land in accumulator columns that are never
// stored, and the scale is 1 / sqrt(DT) from the host: the result is the
// unpadded function, at 14% (112) or 33% (96) more MMA work and no copy on
// the host. At DT = D the instantiation is the unpadded kernel.
//
// Plain C interface, loaded with ctypes. The TMA descriptors are encoded on
// the host with cuTensorMapEncodeTiled, reached through the runtime's
// driver entry point, so the library does not link libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;          // query rows per block
constexpr int kWG = 64;           // query rows per consumer warpgroup
constexpr int kBK = 64;           // keys per ring stage
constexpr int kStages = 2;
constexpr int kThreads = 384;     // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr uint32_t kBarrierBytes = 64;
constexpr uint32_t kAlign = 1024;  // the 128-byte swizzle repeats every 1 KB

template <int D>
struct Cfg {
  static constexpr int kE = D < 64 ? D : 64;  // bf16 in one swizzled row
  static constexpr int kSW = 2 * kE;          // its bytes: 128 or 32
  static_assert(kSW == 128 || kSW == 32, "layout head dim 16, 64, 128 or 256");
  static constexpr int kChunks = D / kE;      // swizzled column blocks
  static constexpr int kKSteps = D / 16;      // k16 steps of Q.K^T
  static constexpr int kStepsPerChunk = kE / 16;
  static constexpr uint64_t kLayout = kSW == 128 ? 1 : 3;  // descriptor code
  static constexpr uint32_t kQChunk = kBQ * kSW;  // bytes of one Q column block
  static constexpr uint32_t kKVChunk = kBK * kSW;
  static constexpr uint32_t kTile = kBK * D * 2;  // one K or V stage
  static constexpr uint32_t kKOff = kBQ * D * 2;
  static constexpr uint32_t kVOff = kKOff + kStages * kTile;
  static constexpr uint32_t kBarOff = kVOff + kStages * kTile;
  static constexpr uint32_t kBytes = kBarOff + kBarrierBytes + kAlign;
};

// ---------------------------------------------------------------------------
// mbarrier, TMA and wgmma in PTX
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the barrier has completed the phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA box of a (B, S, NH, D) tensor, coordinates innermost first.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int d0, int head, int row, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(head), "r"(row),
      "r"(b), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (in 16-byte units) and the swizzle code.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of an accumulator register
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// S (64 x 64 f32) = [S +] A . B^T over 16 of the contraction: A (64 x 16)
// and B (64 x 16) K-major bf16 in shared memory. accumulate == 0 zeroes S.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// O (64 x N f32) += A . B over 16 keys: A (64 x 16 bf16) in registers in the
// accumulator-compatible fragment, B (16 keys x N) MN-major in shared memory
// (the transpose flag: V is read as it lies, d contiguous).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The KV tiles [begin, end) that query positions [qmin, qmax] can see.
__device__ __forceinline__ void tile_range(int qmin, int qmax, int Sk,
                                           int causal, int window, int& begin,
                                           int& end) {
  end = (Sk + kBK - 1) / kBK;
  if (causal) end = min(end, qmax / kBK + 1);
  begin = 0;
  if (window > 0 && qmin - window + 1 > 0) begin = (qmin - window + 1) / kBK;
}

template <int D, int DT>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   int B, int H, int KV, int Sq, int Sk, float scale,
                   int causal, int window, float softcap, int q_offset) {
  using C = Cfg<D>;
  static_assert(DT <= D && DT % 8 == 0, "true head dim within the layout");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + kAlign - 1) & ~(kAlign - 1);
  const uint32_t q_s = base;
  const uint32_t k_s = base + C::kKOff;
  const uint32_t v_s = base + C::kVOff;
  const uint32_t q_full = base + C::kBarOff;
  const uint32_t full = q_full + 8;                // + 8 * stage
  const uint32_t empty = full + 8 * kStages;       // + 8 * stage

  // heaviest query tiles first: block 0 takes the last tile of every head
  const int q_tiles = (Sq + kBQ - 1) / kBQ;
  const int hb = blockIdx.x % (H * B);
  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x / (H * B));
  const int h = hb % H;
  const int b = hb / H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;

  int kt_begin, kt_end;
  tile_range(q_offset + q0, q_offset + min(q0 + kBQ, Sq) - 1, Sk, causal,
             window, kt_begin, kt_end);
  const int n_tiles = max(0, kt_end - kt_begin);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer: one thread issues every TMA load ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kBQ * D * 2);
      for (int c = 0; c < C::kChunks; ++c)
        tma_load(q_s + c * C::kQChunk, &tm_q, c * C::kE, h, q0, b, q_full);
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % kStages;
        const uint32_t use = it / kStages;
        mbar_wait(empty + 8 * stage, (use & 1) ^ 1);  // the first use passes
        const uint32_t bar = full + 8 * stage;
        mbar_expect_tx(bar, 2 * C::kTile);
        const int k0 = (kt_begin + it) * kBK;
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load(k_s + stage * C::kTile + c * C::kKVChunk, &tm_k, c * C::kE,
                   kvh, k0, b, bar);
          tma_load(v_s + stage * C::kTile + c * C::kKVChunk, &tm_v, c * C::kE,
                   kvh, k0, b, bar);
        }
      }
    }
  } else {
    // ---------------- consumers: 64 query rows per warpgroup --------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int g = lane / 4;  // fragment row within the warp's 16
    const int qd = lane % 4; // fragment column pair
    const int row0 = q0 + wg * kWG;                  // first row of this warpgroup
    const int my_row = row0 + warp * 16 + g;         // and + 8
    const bool active = row0 < Sq;
    int w_begin = 0, w_end = 0;
    if (active) {
      tile_range(q_offset + row0, q_offset + min(row0 + kWG, Sq) - 1, Sk,
                 causal, window, w_begin, w_end);
    }
    // x * (1 / softcap) is x / softcap within one f32 rounding, without a
    // division per score
    const float inv_cap = softcap > 0.0f ? 1.0f / softcap : 0.0f;
    const int w_qmin = q_offset + row0;
    const int w_qmax = q_offset + min(row0 + kWG, Sq) - 1;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.0f, 0.0f};

    const uint64_t q_desc = smem_desc(q_s + wg * kWG * C::kSW, 16,
                                      8 * C::kSW, C::kLayout);
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int stage = it % kStages;
      const int kt = kt_begin + it;
      mbar_wait(full + 8 * stage, (it / kStages) & 1);
      if (kt >= w_begin && kt < w_end) {
        const int k0 = kt * kBK;
        const uint32_t k_tile = k_s + stage * C::kTile;
        const uint32_t v_tile = v_s + stage * C::kTile;

        // S = Q . K^T (64 x 64, f32)
        float s[32];
#pragma unroll
        for (int r = 0; r < 32; ++r) s[r] = 0.0f;
        const uint64_t k_desc = smem_desc(k_tile, 16, 8 * C::kSW, C::kLayout);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < C::kKSteps; ++ks) {
          const uint32_t off = (ks / C::kStepsPerChunk) * C::kQChunk +
                               (ks % C::kStepsPerChunk) * 32;
          const uint32_t koff = (ks / C::kStepsPerChunk) * C::kKVChunk +
                                (ks % C::kStepsPerChunk) * 32;
          wgmma_ss_n64(s, q_desc + (off >> 4), k_desc + (koff >> 4), ks > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

        // scale, softcap, mask; s[4j + 2i + c] is row my_row + 8i, key
        // k0 + 8j + 2qd + c
        const bool need_mask = k0 + kBK > Sk ||
                               (causal && k0 + kBK - 1 > w_qmin) ||
                               (window > 0 && w_qmax - k0 >= window);
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int i = (r >> 1) & 1;
          float x = s[r] * scale;
          if (softcap > 0.0f) x = softcap * tanhf(x * inv_cap);
          if (need_mask) {
            const int kpos = k0 + 8 * (r >> 2) + 2 * qd + (r & 1);
            const int qpos = q_offset + my_row + 8 * i;
            bool keep = kpos < Sk;
            if (causal) keep = keep && kpos <= qpos;
            if (window > 0) keep = keep && (qpos - kpos < window);
            x = keep ? x : -INFINITY;
          }
          s[r] = x;
          mx[i] = fmaxf(mx[i], x);
        }
        float alpha[2], m_use[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float m_new = fmaxf(m[i], mx[i]);
          m_use[i] = m_new == -INFINITY ? 0.0f : m_new;
          alpha[i] = expf(m[i] - m_use[i]);  // 0 while m is still -inf
          m[i] = m_new;
        }
        // P, its row sums, and the split into two bf16 A fragments
        uint32_t p_hi[16], p_lo[16];
#pragma unroll
        for (int r = 0; r < 32; r += 2) {
          const int i = (r >> 1) & 1;
          const float p0 = expf(s[r] - m_use[i]);
          const float p1 = expf(s[r + 1] - m_use[i]);
          sum[i] += p0;
          sum[i] += p1;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(hi);
          p_hi[r / 2] = *reinterpret_cast<const uint32_t*>(&hi);
          p_lo[r / 2] = pack_bf16(p0 - hf.x, p1 - hf.y);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
          sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
          l[i] = l[i] * alpha[i] + sum[i];
        }
#pragma unroll
        for (int r = 0; r < D / 2; ++r) o[r] *= alpha[(r >> 1) & 1];

        // O += P_hi . V, then O += P_lo . V (16 keys a step)
        const uint64_t v_desc = smem_desc(v_tile, C::kKVChunk, 8 * C::kSW,
                                          C::kLayout);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint32_t a[4] = {p_hi[4 * kk], p_hi[4 * kk + 1],
                                 p_hi[4 * kk + 2], p_hi[4 * kk + 3]};
          wgmma_rs<D>(o, a, v_desc + ((kk * 16 * C::kSW) >> 4));
        }
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint32_t a[4] = {p_lo[4 * kk], p_lo[4 * kk + 1],
                                 p_lo[4 * kk + 2], p_lo[4 * kk + 3]};
          wgmma_rs<D>(o, a, v_desc + ((kk * 16 * C::kSW) >> 4));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);
    }

    // out = acc / max(l, 1e-37), rounded once to bf16; the columns below
    // DT (the true head dim, a multiple of 8) only
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = my_row + 8 * i;
      if (!active || row >= Sq) continue;
      const float denom = fmaxf(l[i], 1e-37f);
      // m and l are the same in the 4 lanes (qd) of a row
      if (lse != nullptr && qd == 0)
        lse[(static_cast<size_t>(b) * H + h) * Sq + row] = m[i] + logf(denom);
      __nv_bfloat16* dst =
          out + ((static_cast<size_t>(b) * Sq + row) * H + h) * DT + 2 * qd;
#pragma unroll
      for (int j = 0; j < DT / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(o[4 * j + 2 * i] / denom, o[4 * j + 2 * i + 1] / denom);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A TMA descriptor for one (B, S, NH, D) bf16 tensor: boxes of `rows` rows
// of one head and E columns, swizzled as the wgmma descriptors read them.
// D is the tensor's true head dim: at 96 and 112 the last box of a row runs
// past it, and TMA fills those columns with zeros.
cudaError_t encode(CUtensorMap* map, const void* ptr, int B, int S, int NH,
                   int D, int rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const int E = D < 64 ? D : 64;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(NH),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(NH) * D * 2,
                                 static_cast<cuuint64_t>(S) * NH * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(E), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult rc = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      E == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The kernel of layout head dim D on tensors of true head dim DT (DT <= D;
// DT < D zero-pads the columns DT..D-1 inside the kernel).
template <int D, int DT = D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int H, int KV, int Sq, int Sk,
                   float scale,
                   int causal, int window, float softcap, int q_offset,
                   cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = encode(&tm_q, q, B, Sq, H, DT, kBQ);
  if (err == cudaSuccess) err = encode(&tm_k, k, B, Sk, KV, DT, kBK);
  if (err == cudaSuccess) err = encode(&tm_v, v, B, Sk, KV, DT, kBK);
  if (err != cudaSuccess) return err;
  constexpr uint32_t smem = Cfg<D>::kBytes;
  err = cudaFuncSetAttribute(flash_wgmma_kernel<D, DT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>((Sq + kBQ - 1) / kBQ) * H * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_wgmma_kernel<D, DT><<<static_cast<unsigned>(blocks), kThreads, smem,
                              stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), lse, B, H, KV, Sq,
      Sk, scale, causal, window, softcap, q_offset);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k and v (B, Sk, KV, D), out (B, Sq, H, D), all
// contiguous bf16 with 16-byte aligned data, D in {16, 64, 96, 112, 128,
// 256} (96 and 112 on the 128 layout); lse (B, H, Sq) float32, or null
// when no backward follows.
// Launches on `stream`; returns cudaGetLastError() of the launch (0 on
// success), or the error of encoding a TMA descriptor. Does not synchronise
// and allocates nothing.
int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int B, int H, int KV,
                              int Sq, int Sk, int D, float scale, int causal,
                              int window, float softcap, int q_offset,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1 ||
      window < 0 || q_offset < 0) {
    return cudaErrorInvalidValue;
  }
  switch (D) {
    case 16:
      return launch<16>(q, k, v, out, static_cast<float*>(lse), B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    case 64:
      return launch<64>(q, k, v, out, static_cast<float*>(lse), B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    case 96:
      return launch<128, 96>(q, k, v, out, static_cast<float*>(lse), B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    case 112:
      return launch<128, 112>(q, k, v, out, static_cast<float*>(lse), B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    case 128:
      return launch<128>(q, k, v, out, static_cast<float*>(lse), B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    case 256:
      return launch<256>(q, k, v, out, static_cast<float*>(lse), B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* flash_attention_wgmma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
