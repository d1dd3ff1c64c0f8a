// Hopper (sm_90a) Mamba-2 SSD scan (state-space duality), forward, in float32
// on the bf16 tensor cores:
//
//     state_t = exp(dt_t A_h) state_{t-1} + dt_t outer(x_t, B_t)    (P x N, f32)
//     y_t     = C_t . state_t + D_h x_t
//
// for x (B, S, H, P), dt (B, S, H), A (H,), B/C (B, S, G, N) and D (H,) or
// none, all float32; head h reads B/C group h / (H / G). Taken in chunks of
// kQ = 64 steps. With cum the inclusive cumsum of dt A inside a chunk,
//
//     W_ij      = (C_i . B_j) exp(cum_i - cum_j) dt_j      (j <= i, else 0)
//     y_i       = sum_j W_ij x_j + exp(cum_i) C_i . state_in + D_h x_i
//     state_out = exp(cum_last) state_in + sum_j (x_j u_j) outer B_j,
//                 u_j = exp(cum_last - cum_j) dt_j
//
// to f32 accuracy, with D x added in f32 (the one rounding is f32's own).
// Every exponent is <= 0 (A < 0, dt > 0): the decay between two steps is
// formed only as exp(cum_i - cum_j) with j <= i, never as a product with
// exp(-cum), which would overflow. The bf16 inputs take ssd_scan_wgmma.cu.
//
// Replaces the TPU kernel `ssd_scan_pallas` in src/repro/kernels/ssd_scan.py
// (`_ssd_kernel` at line 28, pallas_call at line 80) plus the D skip its ops
// wrapper adds. What it keeps: the chunk decomposition above and the (P, N)
// f32 state carried from chunk to chunk on chip. What differs, and why:
//   * the TPU runs the chunk axis of its (B, H, S / chunk) grid in order and
//     carries the state in VMEM scratch between grid steps. Blocks here run
//     in no order, so a block owns its heads of one batch row and loops over
//     the chunks itself, carrying the state in registers;
//   * the TPU chunk (the ops default 128, the model's 256) is 64 here, the
//     M of a wgmma tile; the function depends on it only through rounding;
//   * the TPU ops wrapper transposes to (B, H, S, P), pads S to a multiple
//     of the chunk and adds D x after rounding the scan: two roundings. Here
//     the model's (B, S, H, P) layout is read in place, the ragged last
//     chunk is masked (rows past S are zeros: dt = 0, x = 0 add nothing),
//     and D x is added before the one rounding, as the reference model's
//     `ssd_chunked` does.
//
// What bounds it on an H100: at mamba2-130m's training layer (B = 8,
// S = 2048, H = 24, P = 64, G = 1, N = 128) it must read x, dt, B, C and
// write y, ~0.22 GB, 0.066 ms at 3.35 TB/s. Its chunked work (C.B^T once
// per group, W.x over j <= i, the two state terms) is ~1.5e10 FLOP, 0.22 ms
// at the 67 TFLOP/s of the f32 CUDA cores, where the kernel before this one
// ran (2.2 ms). On the tensor cores each f32 product costs six bf16 ones
// (below): 0.09 ms at 989 TFLOP/s, so the bound is of the order of the byte
// time, and what holds the kernel back is the elementwise work between the
// products and the splits into pieces (PERF.md has the numbers).
//
// f32 accuracy on bf16 tensor cores. Every product is a bf16 wgmma with an
// f32 accumulator, as in ssd_scan_bwd.cu. An f32 operand is split into
// three bf16 pieces, p0 = bf16(v), p1 = bf16(v - p0), p2 = bf16(v - p0 - p1),
// which hold it exactly (each residual is exact in f32). A product of two
// split operands is the sum of the piece products with a + b <= 2, the
// smallest first: what is left out is within ~2^-23 of |a||b| a term. Both
// the inputs (x, B, C) and what the kernel forms in f32 (W, the state as
// C . state reads it, x_j u_j of the update) go in so. One piece (a single
// bf16 rounding) puts y ~1e-3 of max|y| off, two pieces ~1e-6; three hold it
// within 1e-8 (tests/test_torch_ssd_fwd_split.py, on the CPU). Each product
// starts from a zeroed accumulator, and what it gives is added in f32 by
// the threads: the state update too, so the carry across chunks is never
// summed by the tensor cores, whose accumulator truncates (PERF.md §6).
// expf is the accurate one (no --use_fast_math). There are no atomics and
// every sum has a fixed order, so two launches agree bitwise.
//
// Design. One block per (two heads of one B/C group, batch row), 384
// threads, as ssd_scan_wgmma.cu:
//   * warp 0 is the producer: per chunk, once the consumers have released
//     the staging slot, lane 0 loads the group's B and C rows (64 x N f32
//     each, unswizzled) with TMA; the 4-D maps keep S as its own dimension,
//     so a box past S reads zeros and never the next batch row. TMA cannot
//     take dt (its step stride is H elements), so the 32 lanes load both
//     heads' dt with plain loads, issued before the wait for the slot, and
//     store it beside B and C; they also ask L2 for the heads' x rows of the
//     chunk (bulk prefetches), a chunk ahead of the consumers' reads.
//   * warpgroups 1 and 2 each take one head. Per chunk they split the
//     staged B and C into bf16 piece tiles together (both heads read them),
//     warp 0 of each scans its head's dt A, and the slot goes back to the
//     producer, whose next load then overlaps the chunk. Each warpgroup then
//     forms G = C.B^T (both operands in shared memory) and y_inter^T =
//     state.C^T (A: the state split in registers a k-step at a time), parks
//     exp(cum_i) y_inter in shared memory, forms W from G's accumulator
//     into piece tiles of its own, y_intra^T = x^T.W^T (A: x split in
//     registers), stores y = y_intra + exp(cum_i) y_inter + D x, and adds
//     the state update (x u)^T.B, 64 columns of N at a time (B read
//     MN-major through the transpose flag), each to the scaled state with
//     an fma.
//   * y comes out transposed (rows p, columns i) so that the state, held in
//     registers in the accumulator's layout (rows p), is the A operand of
//     C . state with no copy to shared memory. x is read from L2 into
//     registers at the places the fragments of x^T and (x u)^T and the
//     output take (the same 32 places a thread), so it needs no tile; it is
//     read twice a chunk (for x^T.W^T, then for y and the update) rather
//     than held.
//   * registers: setmaxnreg gives the producer warpgroup 24 and the
//     consumers 240. At N = 128 the state takes 64 a thread; beside it,
//     y_inter held through the chunk (32), x held (32) and thread offsets
//     hoisted out of the chunk loop each made ptxas spill, so y_inter is
//     parked in shared memory (in C's piece tiles, which no product reads
//     after it), x is read where used, and the thread's coordinates are
//     made opaque once a chunk.
//   * a block whose group has an odd number of heads leaves its second
//     warpgroup without a head in the last pair: it computes on zeros,
//     stores nothing, and still takes part in every barrier.
//
// Shared memory at P = 64, N = 128: the staging slot (B and C in f32, 64 KB,
// and dt), B and C as three bf16 piece tiles each (96 KB), W's three pieces
// for each head (48 KB), the per-head step vectors, the barriers and up to
// 1 KB to align the tiles to the swizzle's 1024 bytes: 217,184 bytes, one
// block per SM (`shared_memory_bytes` in ssd_scan.py mirrors it); at N <= 64
// the parked y_inter takes 32 KB of its own. Two heads a block, not one: B
// and C are split once for both, and the 227 KB hold no second slot or
// third head.
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

constexpr int kQ = 64;             // chunk length: wgmma's M
constexpr int kHeads = 2;          // heads per block, one consumer warpgroup each
constexpr int kPieces = 3;         // bf16 pieces of an f32 operand
constexpr int kThreads = 128 * (1 + kHeads);
constexpr int kConsumers = 128 * kHeads;
constexpr uint32_t kFullCount = 1 + 32;  // lane 0's expect_tx and 32 dt arrivals
constexpr uint32_t kAlign = 1024;  // every tile starts on the 128-byte swizzle's repeat

constexpr uint32_t align_up(uint32_t v) { return (v + kAlign - 1) & ~(kAlign - 1); }

// wgmma descriptor code of a swizzle: 128, 64 or 32 bytes a row
constexpr uint64_t layout_code(int row_bytes) {
  return row_bytes == 128 ? 1 : (row_bytes == 64 ? 2 : 3);
}

// Byte offset inside a tile whose rows are `RowBytes` long, swizzled as
// wgmma reads it: the 16-byte chunk index is XORed with the row's position
// in the swizzle's repeat.
template <int RowBytes>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  constexpr uint32_t mask = RowBytes == 128 ? 0x70 : (RowBytes == 64 ? 0x30 : 0x10);
  return off ^ ((off >> 3) & mask);
}

// A bf16 tile of kQ rows and `Cols` columns: column blocks of E = min(Cols,
// 64) columns, each kQ rows of 2E bytes, swizzled by that width.
template <int Cols>
struct Tile {
  static constexpr int kE = Cols < 64 ? Cols : 64;
  static constexpr int kRB = 2 * kE;
  static constexpr uint32_t kBlock = kQ * kRB;
  static constexpr uint32_t kBytes = align_up(kQ * Cols * 2);
  static constexpr uint64_t kCode = layout_code(kRB);
};

// Byte offset of element (r, c) of such a tile.
template <int Cols>
__device__ __forceinline__ uint32_t toff(int r, int c) {
  using L = Tile<Cols>;
  return (c / L::kE) * L::kBlock + swz<L::kRB>(r * L::kRB + (c % L::kE) * 2);
}

template <int P, int N>
struct Cfg {
  static_assert(P == 16 || P == 32 || P == 64, "head dim 16, 32 or 64");
  static_assert(N == 16 || N == 32 || N == 64 || N == 128,
                "state dim 16, 32, 64 or 128");
  static constexpr int kNB = N < 64 ? N : 64;       // columns of one update product
  static constexpr uint32_t kRaw = kQ * N * 4;      // the group's B or C rows, f32
  static constexpr uint32_t kDtOff = 2 * kRaw;      // both heads' dt, in the slot
  static constexpr uint32_t kStage = align_up(kDtOff + 4 * kHeads * kQ);
  static constexpr uint32_t kBC = Tile<N>::kBytes;  // one piece of B or C
  static constexpr uint32_t kWP = Tile<kQ>::kBytes; // one piece of W
  static constexpr uint32_t kBOff = kStage;
  static constexpr uint32_t kCOff = kBOff + kPieces * kBC;
  static constexpr uint32_t kWOff = kCOff + kPieces * kBC;  // + head * kPieces * kWP
  static constexpr uint32_t kVecOff = kWOff + kHeads * kPieces * kWP;
  // per head: dt, cum, exp(cum), u = exp(cum_last - cum) dt, exp(cum_last)
  static constexpr int kVecFloats = 4 * kQ + 4;
  // each head's y_inter (32 f32 a consumer thread), parked: in C's piece
  // tiles where they hold it (N = 128, where there is no other room), else
  // in a region of its own
  static constexpr uint32_t kYBytes = kHeads * 32 * 128 * 4;
  static constexpr bool kYInC = kPieces * kBC >= kYBytes;
  static constexpr uint32_t kYOwn = kVecOff + 4 * kHeads * kVecFloats;
  static constexpr uint32_t kYOff = kYInC ? kCOff : kYOwn;
  static constexpr uint32_t kBarOff = kYOwn + (kYInC ? 0 : kYBytes);
  static constexpr uint32_t kBytes = kBarOff + 64 + kAlign;
};

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

// One TMA box of a (B, S, G, N) tensor, coordinates innermost first.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int group, int row, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(group), "r"(row),
      "r"(b), "r"(bar)
      : "memory");
}

// Bring `bytes` (a multiple of 16) at global `ptr` into L2 ahead of use.
__device__ __forceinline__ void prefetch_l2(const void* ptr, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(ptr),
               "r"(bytes)
               : "memory");
}

// Barrier 1 over the 256 consumer threads.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Barrier `id` over the 128 threads of one warpgroup.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Make this thread's shared-memory writes visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `v` as a value the compiler cannot see through: a descriptor built from
// it is computed where it is used, not hoisted out of the chunk loop.
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (in 16-byte units) and the swizzle code.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// The operand of one k16 step read K-major from a tile (rows: the M or N
// index, columns: the contraction), at k-step `ks`.
template <int Cols>
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int ks) {
  using L = Tile<Cols>;
  return smem_desc(tile + (16 * ks / L::kE) * L::kBlock + (16 * ks % L::kE) * 2,
                   16, 8 * L::kRB, L::kCode);
}

// The operand of one k16 step read MN-major (the transpose flag) from a
// tile whose rows are the contraction: rows 16kk.., columns of block `cb`.
template <int Cols>
__device__ __forceinline__ uint64_t mdesc(uint32_t tile, int cb, int kk) {
  using L = Tile<Cols>;
  return smem_desc(tile + cb * L::kBlock + kk * 16 * L::kRB, L::kBlock,
                   8 * L::kRB, L::kCode);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending) : "memory");
}
// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int K>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x n, f32) += A . B over 16 of the contraction, always accumulating
// (the caller zeroes D first). ss: A and B bf16 in shared memory, K-major;
// rs: A bf16 in registers in the accumulator-compatible fragment, a[0..3],
// TB the transpose flag of B (1: MN-major).
__device__ __forceinline__ void wgmma_ss64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs16(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs32(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int NN, int TB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (NN == 16) {
    wgmma_rs16<TB>(d, a, db);
  } else if constexpr (NN == 32) {
    wgmma_rs32<TB>(d, a, db);
  } else {
    wgmma_rs64<TB>(d, a, db);
  }
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// v0, v1 split into three bf16 pieces each, packed in pairs (v0 in the low
// half) as the A fragment and the tiles take them.
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& p0,
                                       uint32_t& p1, uint32_t& p2) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = v0 - hf.x, r1 = v1 - hf.y;  // exact
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  p0 = bits(h);
  p1 = bits(m);
  p2 = bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

// kQ rows of Cols f32 values, dense at `raw`, into the three pieces of a
// tile, by the 256 consumer threads.
template <int Cols>
__device__ __forceinline__ void to_pieces(const float* raw, uint8_t* tile, int ct) {
  constexpr int kUnits = kQ * Cols / 4;
#pragma unroll 4
  for (int u = ct; u < kUnits; u += kConsumers) {
    const int r = u / (Cols / 4);
    const int c = (u % (Cols / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(raw + r * Cols + c);
    uint32_t lo[3], hi[3];
    split3(v.x, v.y, lo[0], lo[1], lo[2]);
    split3(v.z, v.w, hi[0], hi[1], hi[2]);
    const uint32_t off = toff<Cols>(r, c);
#pragma unroll
    for (int k = 0; k < kPieces; ++k)
      *reinterpret_cast<uint2*>(tile + k * Tile<Cols>::kBytes + off) = make_uint2(lo[k], hi[k]);
  }
}

// The pieces of a product A . B: calls f(a, b) for each pair with
// a + b <= 2, the smallest first, so that the f32 accumulator takes the
// small terms before the large ones have grown it.
template <typename F>
__device__ __forceinline__ void for_pairs(F f) {
  f(2, 0);
  f(1, 1);
  f(0, 2);
  f(1, 0);
  f(0, 1);
  f(0, 0);
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_f32_kernel(const __grid_constant__ CUtensorMap tm_b,
               const __grid_constant__ CUtensorMap tm_c,
               const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ D,
               float* __restrict__ out, int S, int H, int rep, int pairs,
               long long dtb, long long dts, long long dth) {
  using C = Cfg<P, N>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + kAlign - 1) & ~(kAlign - 1);
  uint8_t* const gbase = smem_raw + (base - raw);  // the same bytes, generic
  const uint32_t full = base + C::kBarOff;
  const uint32_t empty = full + 8;
  float* const dt_slot = reinterpret_cast<float*>(gbase + C::kDtOff);

  const int g = blockIdx.x / pairs;
  const int pair = blockIdx.x % pairs;
  const int b = blockIdx.y;
  const int h0 = g * rep + 2 * pair;  // this block's heads: h0 and h0 + 1
  const bool second = 2 * pair + 1 < rep;
  const int n_chunks = (S + kQ - 1) / kQ;

  if (threadIdx.x == 0) {
    mbar_init(full, kFullCount);
    mbar_init(empty, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer: warp 0 fills the staging slot -------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      for (int it = 0; it < n_chunks; ++it) {
        const int c0 = it * kQ;
        // dt of both heads, steps c0 + lane and c0 + lane + 32 (0 past S or
        // past the block's heads), loaded before the wait for the slot
        float dv[kHeads][2];
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int s = c0 + lane + 32 * k;
            dv[hh][k] = (hh == 0 || second) && s < S
                            ? dt[b * dtb + s * dts + (h0 + hh) * dth]
                            : 0.0f;
            // and the heads' x rows into L2, a chunk ahead of the
            // consumers' reads at their fragments' places
            if ((hh == 0 || second) && s < S)
              prefetch_l2(x + ((static_cast<size_t>(b) * S + s) * H + h0 + hh) * P,
                          P * 4);
          }
        mbar_wait(empty, (it & 1) ^ 1);  // the first use passes
        if (lane == 0) {
          mbar_expect_tx(full, 2 * C::kRaw);
          tma_load(base, &tm_b, g, c0, b, full);
          tma_load(base + C::kRaw, &tm_c, g, c0, b, full);
        }
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh)
#pragma unroll
          for (int k = 0; k < 2; ++k) dt_slot[hh * kQ + lane + 32 * k] = dv[hh][k];
        mbar_arrive(full);  // releases this lane's dt writes
      }
    }
    return;
  }

  // ---------------- consumers: one head per warpgroup ----------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = (threadIdx.x - 128) / 128;
  const int h = h0 + wg;
  const bool active = wg == 0 || second;
  const float a_h = active ? A[h] : 0.0f;
  const float d_h = active && D != nullptr ? D[h] : 0.0f;
  float* const vec = reinterpret_cast<float*>(gbase + C::kVecOff) + wg * C::kVecFloats;
  float* const dt_v = vec;            // dt_j
  float* const cum_v = dt_v + kQ;     // cum_j
  float* const e_v = cum_v + kQ;      // exp(cum_i)
  float* const u_v = e_v + kQ;        // u_j = exp(cum_last - cum_j) dt_j
  float* const el_v = u_v + kQ;       // exp(cum_last)
  const uint32_t b_t = base + C::kBOff, c_t = base + C::kCOff;
  const uint32_t w_t = base + C::kWOff + wg * kPieces * C::kWP;
  uint8_t* const w_g = gbase + C::kWOff + wg * kPieces * C::kWP;
  const float* const xh = x + (static_cast<size_t>(b) * S * H + (active ? h : h0)) * P;

  // The carried state (rows p, columns n): state[4j + 2i + c] is row
  // r0 + 8i, column 8j + 2qd + c. Rows at or past P stay 0.
  float state[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) state[i] = 0.0f;

  for (int it = 0; it < n_chunks; ++it) {
    // The thread's coordinates, made opaque once a chunk: the dozens of
    // shared- and device-memory offsets derived from them are then formed
    // where used, not hoisted out of the chunk loop, where held they would
    // take the registers the products need (and spill).
    const int t = static_cast<int>(opaque(threadIdx.x)) - 128 - 128 * wg;
    const int ct = 128 * wg + t;
    const int warp = t / 32;
    const int lane = t % 32;
    const int qd = lane % 4;              // fragment column pair
    const int r0 = 16 * warp + lane / 4;  // the fragment's rows (p): r0, r0 + 8
    const int c0 = it * kQ;
    const int rows = S - c0 < kQ ? S - c0 : kQ;  // rows of this chunk inside S
    const int hp = H * P;                        // x's and y's row stride
    const float* const xc = xh + static_cast<size_t>(c0) * hp;
    float* const oc = out + (static_cast<size_t>(b) * S + c0) * hp +
                      static_cast<size_t>(h) * P;

    // x at the places a thread's fragments take: entry 2q + c of a thread's
    // x is row j = 16kk + 8half + 2qd + c of the chunk (q = 4kk + 2half +
    // ii), column p = r0 + 8ii: the place of A fragment register q % 4 of
    // k-step kk of x^T and of (x u)^T, and of accumulator entry 2q + c of
    // y^T. Read from device memory (L2, where the producer prefetched the
    // rows) where needed rather than held through the chunk, for registers.
    auto x_at = [&](int q, int c) -> float {
      const int p = r0 + 8 * (q & 1);
      const int j = 16 * (q >> 2) + 8 * ((q >> 1) & 1) + 2 * qd + c;
      return active && p < P && j < rows ? xc[static_cast<size_t>(j) * hp + p]
                                         : 0.0f;
    };

    // 1. Once both warpgroups' products of the last chunk are done: this
    // chunk's B and C into pieces, and warp 0's scan of its head's dt A
    // (lane l: steps 2l and 2l + 1, a scan of the pair sums across the
    // warp). Then the slot goes back to the producer.
    mbar_wait(full, it & 1);
    consumer_sync();
    if (warp == 0) {
      const float d0 = dt_slot[wg * kQ + 2 * lane];
      const float d1 = dt_slot[wg * kQ + 2 * lane + 1];
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
      const float cm[2] = {excl + a0, incl};
      const float dv[2] = {d0, d1};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int r = 2 * lane + k;
        dt_v[r] = dv[k];
        cum_v[r] = cm[k];
        e_v[r] = expf(cm[k]);
        u_v[r] = expf(last - cm[k]) * dv[k];
      }
      if (lane == 0) *el_v = expf(last);
    }
    to_pieces<N>(reinterpret_cast<const float*>(gbase), gbase + C::kBOff, ct);
    to_pieces<N>(reinterpret_cast<const float*>(gbase + C::kRaw), gbase + C::kCOff, ct);
    fence_async_smem();
    consumer_sync();
    if (ct == 0) mbar_arrive(empty);  // the producer loads the next chunk

    // 2. G = C . B^T (rows i, columns j), both operands' pieces in shared
    // memory; then y_inter^T = state . C^T (rows p, columns i), the state
    // split as the A operand a k-step at a time.
    float gacc[32], yi[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) gacc[r] = yi[r] = 0.0f;
    wgmma_fence();
    for_pairs([&](int a, int bp) {
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks)
        wgmma_ss64(gacc, kdesc<N>(opaque(c_t) + a * C::kBC, ks),
                   kdesc<N>(opaque(b_t) + bp * C::kBC, ks));
    });
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t sp[kPieces][4];
      // split after the last k-step's wait, not hoisted above it into a
      // second set of registers
      fence_regs<8>(state + 8 * ks);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        split3(state[8 * ks + 2 * k], state[8 * ks + 2 * k + 1], sp[0][k],
               sp[1][k], sp[2][k]);
      wgmma_fence();
      for_pairs([&](int a, int bp) {
        wgmma_rs<64, 0>(yi, sp[a], kdesc<N>(opaque(c_t) + bp * C::kBC, ks));
      });
      wgmma_commit();
      wgmma_wait<0>();
    }
    fence_regs<32>(gacc);
    fence_regs<32>(yi);
    // y_inter^T times exp(cum_i) (entry r is column i = 8(r / 4) + 2qd +
    // (r & 1)), parked in shared memory until the store, once both
    // warpgroups' products that read C are done (at N = 128 it takes C's
    // piece tiles): held, its 32 registers beside the state's 64 spill
    consumer_sync();
    float* const yi_s = reinterpret_cast<float*>(gbase + C::kYOff) + wg * 32 * 128 + t;
#pragma unroll
    for (int r = 0; r < 32; ++r) yi_s[r * 128] = e_v[8 * (r >> 2) + 2 * qd + (r & 1)] * yi[r];

    // 3. W from G's accumulator (gacc[4jj + 2ii + c] is row i = r0 + 8ii,
    // column j = 8jj + 2qd + c) into this head's piece tiles, rows i.
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const int i = r0 + 8 * ((r >> 1) & 1);
      const int j = 8 * (r >> 2) + 2 * qd;
      float v[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        // every lane takes the same path: the exponent is clamped to 0
        // above the diagonal (where W is 0) instead of branching
        const float w = gacc[r + c] * expf(fminf(cum_v[i] - cum_v[j + c], 0.0f)) *
                        dt_v[j + c];
        v[c] = j + c <= i ? w : 0.0f;
      }
      uint32_t pw[3];
      split3(v[0], v[1], pw[0], pw[1], pw[2]);
#pragma unroll
      for (int k = 0; k < kPieces; ++k)
        *reinterpret_cast<uint32_t*>(w_g + k * C::kWP + toff<kQ>(i, j)) = pw[k];
    }
    fence_async_smem();
    warpgroup_sync(2 + wg);  // every warp's W is written

    // 4. y_intra^T = x^T . W^T (rows p, columns i), x read at its places
    // and split as the A operand two k-steps at a time.
    float ya[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) ya[r] = 0.0f;
#pragma unroll
    for (int k0 = 0; k0 < 4; k0 += 2) {
      uint32_t xp[kPieces][8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int q = 4 * k0 + k;
        split3(x_at(q, 0), x_at(q, 1), xp[0][k], xp[1][k], xp[2][k]);
      }
      wgmma_fence();
      for_pairs([&](int a, int bp) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wgmma_rs<64, 0>(ya, xp[a] + 4 * kk,
                          kdesc<kQ>(opaque(w_t) + bp * C::kWP, k0 + kk));
      });
      wgmma_commit();
      wgmma_wait<0>();
    }
    fence_regs<32>(ya);

    // 5. y = y_intra + exp(cum_i) y_inter + D x: entry r of the
    // accumulators is row p = r0 + 8ii, column i = 8(r / 4) + 2qd + (r & 1);
    // rows at or past S, and columns p at or past P, are not stored. The
    // same reads of x give the state update's A operand (x u)^T, split;
    // half the places at a time.
    uint32_t up[kPieces][16];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float xv[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) xv[k] = x_at(8 * half + k / 2, k % 2);
      if (active) {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int r = 16 * half + k;
          const int p = r0 + 8 * ((r >> 1) & 1);
          const int i = 8 * (r >> 2) + 2 * qd + (r & 1);
          if (p < P && i < rows)
            oc[static_cast<size_t>(i) * hp + p] = ya[r] + yi_s[r * 128] + d_h * xv[k];
        }
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int q = 8 * half + m;
        const int j = 16 * (q >> 2) + 8 * ((q >> 1) & 1) + 2 * qd;
        split3(xv[2 * m] * u_v[j], xv[2 * m + 1] * u_v[j + 1], up[0][q],
               up[1][q], up[2][q]);
      }
    }

    // 6. The state update (x u)^T . B (rows p, columns n), 64 columns of N
    // at a time, each into a fresh accumulator added to the scaled state.
    const float el = *el_v;
#pragma unroll
    for (int nb = 0; nb < N / C::kNB; ++nb) {
      float add[C::kNB / 2];
#pragma unroll
      for (int r = 0; r < C::kNB / 2; ++r) add[r] = 0.0f;
      wgmma_fence();
      for_pairs([&](int a, int bp) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<C::kNB, 1>(add, up[a] + 4 * kk,
                              mdesc<N>(opaque(b_t) + bp * C::kBC, nb, kk));
      });
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<C::kNB / 2>(add);
#pragma unroll
      for (int r = 0; r < C::kNB / 2; ++r) {
        float& s = state[nb * C::kNB / 2 + r];
        s = fmaf(s, el, add[r]);
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

// A TMA descriptor for one contiguous (B, S, G, N) f32 tensor: boxes of kQ
// rows of one group and all N columns, unswizzled (the consumers split them
// into the tiles the products read). S is a dimension of its own, so a box
// past S reads zeros.
cudaError_t encode(CUtensorMap* map, const void* ptr, int B, int S, int G,
                   int N) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(G),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(N) * 4,
                                 static_cast<cuuint64_t>(G) * N * 4,
                                 static_cast<cuuint64_t>(S) * G * N * 4};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(N), 1,
                             static_cast<cuuint32_t>(kQ), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                         const_cast<void*>(ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int P, int N>
cudaError_t launch(const float* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* D, float* out,
                   int B, int S, int H, int G, const long long* dts,
                   cudaStream_t stream) {
  CUtensorMap tm_b, tm_c;
  cudaError_t err = encode(&tm_b, Bm, B, S, G, N);
  if (err == cudaSuccess) err = encode(&tm_c, Cm, B, S, G, N);
  if (err != cudaSuccess) return err;
  constexpr uint32_t smem = Cfg<P, N>::kBytes;
  err = cudaFuncSetAttribute(ssd_f32_kernel<P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int rep = H / G;
  const int pairs = (rep + kHeads - 1) / kHeads;
  const dim3 grid(G * pairs, B);
  ssd_f32_kernel<P, N><<<grid, kThreads, smem, stream>>>(
      tm_b, tm_c, x, dt, A, D, out, S, H, rep, pairs, dts[0], dts[1], dts[2]);
  return cudaGetLastError();
}

template <int P>
cudaError_t dispatch_n(const float* x, const float* dt, const float* A,
                       const void* Bm, const void* Cm, const float* D,
                       float* out, int B, int S, int H, int G, int N,
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

// x (B, S, H, P) contiguous, B and C (B, S, G, N) contiguous with 16-byte
// aligned data (TMA reads them), dt (B, S, H) read through the 3 element
// strides in `dt_strides` (b, s, h), A (H,) and D (H,), all float32, D may be
// null; out (B, S, H, P) contiguous float32. P in {16, 32, 64}, N in {16,
// 32, 64, 128}. Launches on `stream`; returns cudaGetLastError() of the
// launch (0 on success), or the error of encoding a TMA descriptor. Does not
// synchronise and allocates nothing.
int ssd_scan_fwd(const float* x, const float* dt, const float* A,
                 const void* Bm, const void* Cm, const float* D, float* out,
                 int B, int S, int H, int G, int P, int N,
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

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
