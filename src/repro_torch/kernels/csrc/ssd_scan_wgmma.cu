// Hopper (sm_90a) Mamba-2 SSD scan in bf16 on the tensor cores: the same
// function as the CUDA-core kernel in ssd_scan.cu (which keeps the float32
// route),
//
//     state_t = exp(dt_t A_h) state_{t-1} + dt_t outer(x_t, B_t)    (P x N, f32)
//     y_t     = C_t . state_t + D_h x_t
//
// taken in chunks of kQ = 64 steps. With cum the inclusive cumsum of dt A
// inside a chunk,
//
//     W_ij      = (C_i . B_j) exp(cum_i - cum_j) dt_j      (j <= i, else 0)
//     y_i       = sum_j W_ij x_j + exp(cum_i) C_i . state_in + D_h x_i
//     state_out = exp(cum_last) state_in + sum_j (x_j w_j) outer B_j,
//                 w_j = exp(cum_last - cum_j) dt_j
//
// all summed in f32, and y is rounded once to bf16. Every exponent is <= 0
// (A < 0, dt > 0): the decay between two steps is formed only as
// exp(cum_i - cum_j) with j <= i. Head h reads B/C group h / (H / G).
//
// Replaces the TPU kernel `ssd_scan_pallas` in src/repro/kernels/ssd_scan.py
// (`_ssd_kernel` at line 28, pallas_call at line 80) plus the D skip of its
// ops wrapper, for bf16 inputs, as the CUDA-core kernel did before it; what
// it keeps from the TPU kernel and what differs (a loop over the chunks
// inside the block in place of the sequential grid axis, the chunk of 64,
// the masked ragged tail, D x added before the one rounding) is said in
// ssd_scan.cu and holds here too.
//
// What bounds it on an H100: at the mamba2-130m serving shape (B = 16,
// S = 2048, H = 24, P = 64, G = 1, N = 128) it must read x, dt, B, C and
// write y, about 220 MB, 0.066 ms at 3.35 TB/s; the chunked work is
// ~30 GFLOP, 0.03 ms at the 989 TFLOP/s of the bf16 tensor cores. So the
// bound is bytes. The splits below double three of the four products,
// still well under the byte time. What holds this kernel back instead is
// the CUDA-core work inside each chunk, W's expf first, with two
// warpgroups per SM to hide its latency (tools/ssd_wgmma_phases.py times
// each phase on the card; PERF.md has the numbers).
//
// Design. One block per (two heads of one B/C group, batch row), 384
// threads:
//   * warpgroup 0 is the producer. Its first warp fills a three-stage ring
//     guarded by mbarriers, `full` (the bytes arrived and dt is written)
//     and `empty` (all 8 consumer warps are done with the stage): lane 0
//     loads both heads' x (64 x P) and the group's B and C (64 x N) with
//     TMA (cp.async.bulk.tensor; 128-byte swizzle for 64-column boxes, two
//     of them at N = 128, 64-byte at 32 columns, 32-byte at 16). The
//     4-D maps keep S as its own dimension, so a box past S reads zeros
//     and never the next batch row. TMA cannot take dt (its step stride is
//     H elements), so the 32 lanes load it with plain loads, issued before
//     the wait for the stage so that their latency hides behind it, store
//     it as f32 (0 past S) and arrive on `full` after it.
//   * warpgroups 1 and 2 each take one head, and load B and C once for
//     both (mamba2 has G = 1). Per chunk each warp of a warpgroup scans
//     dt A itself (no barrier across warps), forms the state update's A
//     operand and scales the carried state by exp(cum_last). Then the
//     warpgroup issues, back to back and before the chunk's elementwise
//     work, the three products that need no W: G = C.B^T (m64n64, both
//     operands K-major), y = C.state^T (m64nP, the state K-major) and the
//     state update (m64nN: A from registers, B read MN-major through the
//     transpose flag). While they run it forms W from G's accumulator (its
//     layout is the 16-bit A fragment's); then y's rows are scaled by
//     exp(cum_i) and y += W.x (A = W from registers, x read MN-major). So
//     the chain inside a chunk is G -> W -> W.x, and the state products,
//     which need the carried state, run beside W's elementwise work.
//     (Scaling the state while products are in flight made ptxas wait
//     for them first, C7517, so it happens before they are issued.)
//   * the state is carried in f32 as a wgmma accumulator in registers
//     (P x N, rows padded to 64: 64 f32 a thread at N = 128), scaled by
//     exp(cum_last) before each update. It goes to shared memory only as
//     the B operand of the next chunk's C.state^T.
//   * registers are rebalanced with setmaxnreg: 40 for the producer, 232
//     for the consumers.
//   * a block whose group has an odd number of heads leaves its second
//     warpgroup without a head in the last pair: it computes on what it
//     is given, stores nothing, and still waits for and releases every
//     stage, so the ring stays in step.
//
// f32 accuracy on bf16 tensor cores. C.B^T needs no care: C and B are bf16,
// so each product is exact in the f32 accumulator. The other three
// products each take an f32 operand: W in W.x, the state in C.state^T and
// x_j w_j in the update. Rounded once to bf16, each of them moves the
// output by 2-50x more than the 2^-18 max|y| that chip_smoke.py allows
// beyond correct rounding (tests/test_torch_ssd_split.py, on the CPU). So
// each is split, v_hi = bf16(v) and v_lo = bf16(v - v_hi) (v - v_hi is
// exact in f32), and its product is issued twice, hi then lo, into one f32
// accumulator: what is left out is at most 2^-16 |v|. expf is the accurate
// one (no --use_fast_math). There are no atomics and every sum has a fixed
// order, so two launches agree bitwise.
//
// Shared memory at P = 64, N = 128: three stages of 48 KB (two x tiles,
// B, C), the two heads' state tiles (hi and lo, 64 KB), dt (1.5 KB), the
// per-warp step weights (4 KB), the barriers and up to 1 KB to align the
// ring to the swizzle's 1024 bytes: 219,712 bytes, one block per SM.
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

constexpr int kQ = 64;       // chunk length: wgmma's M
constexpr int kHeads = 2;    // heads per block, one consumer warpgroup each
constexpr int kStages = 3;   // the x/B/C ring
constexpr int kThreads = 128 * (1 + kHeads);
constexpr int kConsumerWarps = 4 * kHeads;
constexpr uint32_t kFullCount = 1 + 32;  // lane 0's expect_tx and 32 dt arrivals
constexpr uint32_t kBarrierBytes = 64;
constexpr uint32_t kAlign = 1024;  // the 128-byte swizzle repeats every 1 KB

// wgmma descriptor code of a swizzle: 128, 64 or 32 bytes a row
constexpr uint64_t layout_code(int row_bytes) {
  return row_bytes == 128 ? 1 : (row_bytes == 64 ? 2 : 3);
}

template <int P, int N>
struct Cfg {
  static_assert(P == 16 || P == 32 || P == 64, "head dim 16, 32 or 64");
  static_assert(N == 16 || N == 32 || N == 64 || N == 128,
                "state dim 16, 32, 64 or 128");
  static constexpr int kXRow = 2 * P;                 // bytes of an x row
  static constexpr int kE = N < 64 ? N : 64;          // columns of a B/C/state block
  static constexpr int kRow = 2 * kE;                 // its bytes a row
  static constexpr int kBlocks = N / kE;              // column blocks: 2 at N = 128
  static constexpr int kKSteps = N / 16;              // k16 steps over N
  static constexpr int kStepsPerBlock = kE / 16;
  static constexpr uint64_t kXLayout = layout_code(kXRow);
  static constexpr uint64_t kLayout = layout_code(kRow);
  static constexpr uint32_t kXTile = kQ * kXRow;       // one head's x
  static constexpr uint32_t kBCBlock = kQ * kRow;      // one column block of B or C
  static constexpr uint32_t kBCTile = kBlocks * kBCBlock;
  static constexpr uint32_t kStage = kHeads * kXTile + 2 * kBCTile;
  static constexpr uint32_t kStBlock = P * kRow;       // one column block of a state tile
  static constexpr uint32_t kStTile = kBlocks * kStBlock;
  static constexpr uint32_t kStateOff = kStages * kStage;
  static constexpr uint32_t kDtOff = kStateOff + kHeads * 2 * kStTile;
  static constexpr uint32_t kScratchOff = kDtOff + 4 * kStages * kHeads * kQ;
  static constexpr uint32_t kBarOff = kScratchOff + 4 * kConsumerWarps * 2 * kQ;
  static constexpr uint32_t kBytes = kBarOff + kBarrierBytes + kAlign;
};

// Byte offset inside a tile whose rows are `RowBytes` long, swizzled as TMA
// writes it and wgmma reads it: the 16-byte chunk index is XORed with the
// row's position in the swizzle's repeat (tiles start at its boundary).
template <int RowBytes>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  constexpr uint32_t mask = RowBytes == 128 ? 0x70 : (RowBytes == 64 ? 0x30 : 0x10);
  return off ^ ((off >> 3) & mask);
}

// ---------------------------------------------------------------------------
// mbarrier, TMA, named barriers and wgmma in PTX
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

// One TMA box of a (B, S, NH, C) tensor, coordinates innermost first.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int head, int row, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row),
      "r"(b), "r"(bar)
      : "memory");
}

// Barrier `id` over the 128 threads of one warpgroup.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Make this thread's shared-memory writes visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
// Wait until at most `Pending` committed groups are still running (groups
// complete in the order they were committed).
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending) : "memory");
}
// Keep the compiler from moving reads or writes of an accumulator register
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x N f32) = [D +] A . B^T over 16 of the contraction: A (64 x 16) and
// B (N x 16) K-major bf16 in shared memory. accumulate == 0 zeroes D.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate);

// D (64 x N f32) += A . B over 16 of the contraction: A (64 x 16 bf16) in
// registers in the accumulator-compatible fragment, B (16 x N) MN-major in
// shared memory (the transpose flag: read as it lies, N contiguous).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t desc_a,
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
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// v0, v1 split into bf16 halves: hi = bf16(v), lo = bf16(v - hi), packed in
// pairs as the A fragment takes them.
__device__ __forceinline__ void split_pack(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_c,
                 const __nv_bfloat16* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ D,
                 __nv_bfloat16* __restrict__ out, int S, int H, int rep,
                 int pairs, long long dtb, long long dts, long long dth) {
  using C = Cfg<P, N>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + kAlign - 1) & ~(kAlign - 1);
  uint8_t* const gbase = smem_raw + (base - raw);  // the same bytes, generic
  const uint32_t full = base + C::kBarOff;         // + 8 * stage
  const uint32_t empty = full + 8 * kStages;       // + 8 * stage
  float* const dt_ring = reinterpret_cast<float*>(gbase + C::kDtOff);

  const int g = blockIdx.x / pairs;
  const int pair = blockIdx.x % pairs;
  const int b = blockIdx.y;
  const int h0 = g * rep + 2 * pair;  // this block's heads: h0 and h0 + 1
  const bool second = 2 * pair + 1 < rep;
  const int n_chunks = (S + kQ - 1) / kQ;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, kFullCount);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer: warp 0 fills the ring ---------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      for (int it = 0; it < n_chunks; ++it) {
        const int stage = it % kStages;
        const uint32_t use = it / kStages;
        const int c0 = it * kQ;
        // dt of both heads, steps c0 + lane and c0 + lane + 32, as f32 (0
        // past S or past the block's heads), loaded before the wait for the
        // stage so that their latency hides behind it
        float dv[kHeads][kQ / 32];
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh) {
          const bool valid = hh == 0 || second;
#pragma unroll
          for (int k = 0; k < kQ / 32; ++k) {
            const int s = c0 + lane + 32 * k;
            dv[hh][k] = valid && s < S
                            ? __bfloat162float(
                                  dt[b * dtb + s * dts + (h0 + hh) * dth])
                            : 0.0f;
          }
        }
        mbar_wait(empty + 8 * stage, (use & 1) ^ 1);  // the first use passes
        const uint32_t bar = full + 8 * stage;
        const uint32_t st = base + stage * C::kStage;
        if (lane == 0) {
          mbar_expect_tx(bar, C::kStage);
          for (int hh = 0; hh < kHeads; ++hh)
            tma_load(st + hh * C::kXTile, &tm_x, 0, h0 + hh, c0, b, bar);
          const uint32_t b_t = st + kHeads * C::kXTile;
          for (int k = 0; k < C::kBlocks; ++k) {
            tma_load(b_t + k * C::kBCBlock, &tm_b, k * C::kE, g, c0, b, bar);
            tma_load(b_t + C::kBCTile + k * C::kBCBlock, &tm_c, k * C::kE, g,
                     c0, b, bar);
          }
        }
        float* dts_s = dt_ring + stage * kHeads * kQ;
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh)
#pragma unroll
          for (int k = 0; k < kQ / 32; ++k)
            dts_s[hh * kQ + lane + 32 * k] = dv[hh][k];
        mbar_arrive(bar);  // releases this lane's dt writes
      }
    }
  } else {
    // ---------------- consumers: one head per warpgroup -------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int gq = lane / 4;  // fragment row within the warp's 16
    const int qd = lane % 4;  // fragment column pair
    const int h = h0 + wg;
    const bool active = wg == 0 || second;
    const float a_h = active ? A[h] : 0.0f;
    const float d_h = active && D != nullptr ? D[h] : 0.0f;
    const int r0 = 16 * warp + gq;  // the fragment's rows: r0 and r0 + 8
    float* const cum_s = reinterpret_cast<float*>(gbase + C::kScratchOff) +
                         (4 * wg + warp) * 2 * kQ;
    float* const wst_s = cum_s + kQ;  // exp(cum_last - cum_j) dt_j
    const uint32_t st_hi = base + C::kStateOff + wg * 2 * C::kStTile;
    const uint32_t st_lo = st_hi + C::kStTile;
    uint8_t* const st_hi_g = gbase + (st_hi - base);
    uint8_t* const st_lo_g = gbase + (st_lo - base);

    // The carried state (rows p, columns n): state[4j + 2i + c] is row
    // r0 + 8i, column 8j + 2qd + c. Rows at or past P stay 0.
    float state[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) state[i] = 0.0f;

    // Write the state as the hi and lo bf16 tiles C.state^T reads (rows p < P,
    // K-major in column blocks of kE, swizzled as TMA would write them). The
    // barrier that makes every warp's writes visible to the products is the
    // one before the next chunk's products are issued.
    auto store_state = [&]() {
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int n = 8 * j + 2 * qd;
        const uint32_t blk = (n / C::kE) * C::kStBlock;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int p = r0 + 8 * i;
          if (p >= P) continue;
          const uint32_t off =
              blk + swz<C::kRow>(p * C::kRow + (n % C::kE) * 2);
          uint32_t hi, lo;
          split_pack(state[4 * j + 2 * i], state[4 * j + 2 * i + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(st_hi_g + off) = hi;
          *reinterpret_cast<uint32_t*>(st_lo_g + off) = lo;
        }
      }
      fence_async_smem();
    };
    store_state();  // the state carried into chunk 0 is 0

    for (int it = 0; it < n_chunks; ++it) {
      const int stage = it % kStages;
      const int c0 = it * kQ;
      const uint32_t x_t = base + stage * C::kStage + wg * C::kXTile;
      const uint32_t b_t = base + stage * C::kStage + kHeads * C::kXTile;
      const uint32_t c_t = b_t + C::kBCTile;
      const uint8_t* const x_g = gbase + (x_t - base);
      const float* const dt_s = dt_ring + (stage * kHeads + wg) * kQ;
      mbar_wait(full + 8 * stage, (it / kStages) & 1);

      // 1. This warp's scan of dt A over the chunk (lane l: steps 2l and
      // 2l + 1, a scan of the pair sums across the warp), the state weights
      // w_j = exp(cum_last - cum_j) dt_j and exp(cum_last).
      __syncwarp();  // the previous chunk's readers of cum_s are done
      float elast;
      {
        const float d0 = dt_s[2 * lane];
        const float d1 = dt_s[2 * lane + 1];
        const float a0 = d0 * a_h;
        const float a1 = d1 * a_h;
        float incl = a0 + a1;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float v = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += v;
        }
        float excl = __shfl_up_sync(0xffffffffu, incl, 1);
        if (lane == 0) excl = 0.0f;
        const float last = __shfl_sync(0xffffffffu, incl, 31);
        const float cum0 = excl + a0;
        const float cum1 = incl;
        cum_s[2 * lane] = cum0;
        cum_s[2 * lane + 1] = cum1;
        wst_s[2 * lane] = expf(last - cum0) * d0;
        wst_s[2 * lane + 1] = expf(last - cum1) * d1;
        elast = expf(last);
      }
      __syncwarp();
      const float cum_r[2] = {cum_s[r0], cum_s[r0 + 8]};

      // 2. The state update's A operand (rows p, columns j: x_j[p] w_j)
      // split into hi and lo, and the state times exp(cum_last), while no
      // product is in flight.
      uint32_t u_hi[16], u_lo[16];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 16 * kk + 8 * half + 2 * qd;
          const float w0 = wst_s[j];
          const float w1 = wst_s[j + 1];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int p = r0 + 8 * i;
            float v0 = 0.0f, v1 = 0.0f;
            if (p < P) {
              v0 = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                       x_g + swz<C::kXRow>(j * C::kXRow + 2 * p))) * w0;
              v1 = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                       x_g + swz<C::kXRow>((j + 1) * C::kXRow + 2 * p))) * w1;
            }
            split_pack(v0, v1, u_hi[4 * kk + 2 * half + i],
                       u_lo[4 * kk + 2 * half + i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < N / 2; ++i) state[i] *= elast;

      // 3. The products that need no W, issued back to back before the
      // chunk's elementwise work: G = C . B^T (64 x 64), y = C . state^T
      // (64 x P, hi then lo) and state += (x w)^T . B (P x N, hi then lo).
      float gacc[32], y[P / 2];
#pragma unroll
      for (int i = 0; i < 32; ++i) gacc[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < P / 2; ++i) y[i] = 0.0f;
      warpgroup_sync(1 + wg);  // every warp's state tiles are written
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C::kKSteps; ++ks) {
        const uint32_t off = (ks / C::kStepsPerBlock) * C::kBCBlock +
                             (ks % C::kStepsPerBlock) * 32;
        wgmma_ss<64>(gacc, smem_desc(c_t + off, 16, 8 * C::kRow, C::kLayout),
                     smem_desc(b_t + off, 16, 8 * C::kRow, C::kLayout), ks > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t st_t = half == 0 ? st_hi : st_lo;
#pragma unroll
        for (int ks = 0; ks < C::kKSteps; ++ks) {
          const uint32_t off = (ks / C::kStepsPerBlock) * C::kBCBlock +
                               (ks % C::kStepsPerBlock) * 32;
          const uint32_t soff = (ks / C::kStepsPerBlock) * C::kStBlock +
                                (ks % C::kStepsPerBlock) * 32;
          wgmma_ss<P>(y, smem_desc(c_t + off, 16, 8 * C::kRow, C::kLayout),
                      smem_desc(st_t + soff, 16, 8 * C::kRow, C::kLayout),
                      half > 0 || ks > 0);
        }
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {u_hi[4 * kk], u_hi[4 * kk + 1],
                               u_hi[4 * kk + 2], u_hi[4 * kk + 3]};
        wgmma_rs<N>(state, a,
                    smem_desc(b_t + kk * 16 * C::kRow, C::kBCBlock,
                              8 * C::kRow, C::kLayout));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {u_lo[4 * kk], u_lo[4 * kk + 1],
                               u_lo[4 * kk + 2], u_lo[4 * kk + 3]};
        wgmma_rs<N>(state, a,
                    smem_desc(b_t + kk * 16 * C::kRow, C::kBCBlock,
                              8 * C::kRow, C::kLayout));
      }
      wgmma_commit();

      // 4. W from G's accumulator: gacc[4j + 2i + c] is row r0 + 8i, column
      // 8j + 2qd + c; split into the hi and lo A fragments of W . x.
      wgmma_wait<2>();
      fence_regs(gacc);
      uint32_t w_hi[16], w_lo[16];
#pragma unroll
      for (int r = 0; r < 32; r += 2) {
        const int i = (r >> 1) & 1;
        const int row = r0 + 8 * i;
        const int col = 8 * (r >> 2) + 2 * qd;
        float v[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          // every lane takes the same path: the exponent is clamped to 0
          // above the diagonal (where W is 0) instead of branching
          const float w = gacc[r + c] *
                          expf(fminf(cum_r[i] - cum_s[col + c], 0.0f)) *
                          dt_s[col + c];
          v[c] = col + c <= row ? w : 0.0f;
        }
        split_pack(v[0], v[1], w_hi[r / 2], w_lo[r / 2]);
      }

      // 5. y's rows times exp(cum_i), then y += W_hi . x + W_lo . x.
      wgmma_wait<1>();
      fence_regs(y);
      const float ecum[2] = {expf(cum_r[0]), expf(cum_r[1])};
#pragma unroll
      for (int r = 0; r < P / 2; ++r) y[r] *= ecum[(r >> 1) & 1];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {w_hi[4 * kk], w_hi[4 * kk + 1],
                               w_hi[4 * kk + 2], w_hi[4 * kk + 3]};
        wgmma_rs<P>(y, a,
                    smem_desc(x_t + kk * 16 * C::kXRow, C::kXTile,
                              8 * C::kXRow, C::kXLayout));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {w_lo[4 * kk], w_lo[4 * kk + 1],
                               w_lo[4 * kk + 2], w_lo[4 * kk + 3]};
        wgmma_rs<P>(y, a,
                    smem_desc(x_t + kk * 16 * C::kXRow, C::kXTile,
                              8 * C::kXRow, C::kXLayout));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(y);
      fence_regs(state);

      // 6. y + D x, rounded once to bf16; rows at or past S are not stored.
      if (active) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = r0 + 8 * i;
          const int s = c0 + row;
          if (s >= S) continue;
          __nv_bfloat16* dst =
              out + ((static_cast<size_t>(b) * S + s) * H + h) * P + 2 * qd;
#pragma unroll
          for (int j = 0; j < P / 8; ++j) {
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    x_g + swz<C::kXRow>(row * C::kXRow + 2 * (8 * j + 2 * qd))));
            *reinterpret_cast<uint32_t*>(dst + 8 * j) =
                pack_bf16(y[4 * j + 2 * i] + d_h * xv.x,
                          y[4 * j + 2 * i + 1] + d_h * xv.y);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);  // this warp is done with the stage

      // 7. The state for the next chunk's C . state^T, once every warp's
      // products of this chunk have read the old tiles.
      if (it + 1 < n_chunks) {
        warpgroup_sync(1 + wg);
        store_state();
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

// A TMA descriptor for one contiguous (B, S, NH, Cols) bf16 tensor: boxes of
// kQ rows of one head and min(Cols, 64) columns, swizzled as the wgmma
// descriptors read them. S is a dimension of its own, so a box past S
// reads zeros.
cudaError_t encode(CUtensorMap* map, const void* ptr, int B, int S, int NH,
                   int cols) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const int E = cols < 64 ? cols : 64;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(NH),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(NH) * cols * 2,
                                 static_cast<cuuint64_t>(S) * NH * cols * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(E), 1,
                             static_cast<cuuint32_t>(kQ), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      E == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
              : (E == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int P, int N>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const void* Bm, const void* Cm, const float* D, void* out,
                   int B, int S, int H, int G, const long long* dts,
                   cudaStream_t stream) {
  CUtensorMap tm_x, tm_b, tm_c;
  cudaError_t err = encode(&tm_x, x, B, S, H, P);
  if (err == cudaSuccess) err = encode(&tm_b, Bm, B, S, G, N);
  if (err == cudaSuccess) err = encode(&tm_c, Cm, B, S, G, N);
  if (err != cudaSuccess) return err;
  constexpr uint32_t smem = Cfg<P, N>::kBytes;
  err = cudaFuncSetAttribute(ssd_wgmma_kernel<P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int rep = H / G;
  const int pairs = (rep + kHeads - 1) / kHeads;
  const dim3 grid(G * pairs, B);
  ssd_wgmma_kernel<P, N><<<grid, kThreads, smem, stream>>>(
      tm_x, tm_b, tm_c, static_cast<const __nv_bfloat16*>(dt), A, D,
      static_cast<__nv_bfloat16*>(out), S, H, rep, pairs, dts[0], dts[1],
      dts[2]);
  return cudaGetLastError();
}

template <int P>
cudaError_t dispatch_n(const void* x, const void* dt, const float* A,
                       const void* Bm, const void* Cm, const float* D,
                       void* out, int B, int S, int H, int G, int N,
                       const long long* dts, cudaStream_t s) {
  switch (N) {
    case 16:
      return launch<P, 16>(x, dt, A, Bm, Cm, D, out, B, S, H, G, dts, s);
    case 32:
      return launch<P, 32>(x, dt, A, Bm, Cm, D, out, B, S, H, G, dts, s);
    case 64:
      return launch<P, 64>(x, dt, A, Bm, Cm, D, out, B, S, H, G, dts, s);
    case 128:
      return launch<P, 128>(x, dt, A, Bm, Cm, D, out, B, S, H, G, dts, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (B, S, H, P), B and C (B, S, G, N) contiguous bf16 with 16-byte aligned
// data; dt (B, S, H) bf16 read through the 3 element strides in `dt_strides`
// (b, s, h); A (H,) and D (H,) float32, D may be null; out (B, S, H, P)
// contiguous bf16. P in {16, 32, 64}, N in {16, 32, 64, 128}. Launches on
// `stream`; returns cudaGetLastError() of the launch (0 on success), or the
// error of encoding a TMA descriptor. Does not synchronise and allocates
// nothing.
int ssd_scan_wgmma_fwd(const void* x, const void* dt, const float* A,
                       const void* Bm, const void* Cm, const float* D,
                       void* out, int B, int S, int H, int G, int P, int N,
                       const long long* dt_strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || S < 1 || H < 1 || G < 1 || H % G != 0 ||
      dt_strides == nullptr) {
    return cudaErrorInvalidValue;
  }
  switch (P) {
    case 16:
      return dispatch_n<16>(x, dt, A, Bm, Cm, D, out, B, S, H, G, N, dt_strides, s);
    case 32:
      return dispatch_n<32>(x, dt, A, Bm, Cm, D, out, B, S, H, G, N, dt_strides, s);
    case 64:
      return dispatch_n<64>(x, dt, A, Bm, Cm, D, out, B, S, H, G, N, dt_strides, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* ssd_scan_wgmma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
