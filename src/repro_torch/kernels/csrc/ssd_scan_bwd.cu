// Hopper (sm_90a) Mamba-2 SSD scan, backward, on the tensor cores: the
// gradients of
//
//     state_t = exp(dt_t A_h) state_{t-1} + dt_t outer(x_t, B_t)    (P x N, f32)
//     y_t     = C_t . state_t + D_h x_t
//
// for x (B, S, H, P), dt (B, S, H), A (H,) f32, B/C (B, S, G, N), D (H,) f32
// or none, given dy (B, S, H, P): dx, ddt, dB, dC in the inputs' dtype and
// dA, dD in f32. Head h reads B/C group h / (H / G), so dB and dC sum over
// the H / G heads of a group. Everything is computed to f32 accuracy from
// the inputs as read, and each output is rounded once.
//
// Replaces nothing in the reference: the JAX package differentiates
// `models/ssm.py::ssd_chunked` (plain jnp) and defines no backward for its
// Pallas kernel `ssd_scan_pallas` (src/repro/kernels/ssd_scan.py:67). The
// port's training path runs the forward kernel (ssd_scan.cu / ssd_scan_wgmma.cu),
// so its gradient is this kernel; the plain version is autograd through
// `kernels/ref.py::ssd_chunked_ref` (`ref.ssd_chunked_grads`), and
// `ref.ssd_bwd_decomposed` writes out the decomposition below, splits and
// all, in PyTorch.
//
// The math, in chunks of kQ = 64 steps (local rows i, j; cum the inclusive
// cumsum of dt A in the chunk, last = cum_{kQ-1}; all exponents <= 0):
//
//   L_ij = exp(cum_i - cum_j) (j <= i, else 0), G_ij = C_i . B_j,
//   W_ij = G_ij L_ij dt_j,  E_i = exp(cum_i),  u_j = exp(last - cum_j) dt_j,
//   y_i   = sum_j W_ij x_j + E_i C_i . S0 + D x_i,
//   S_out = exp(last) S0 + sum_j u_j outer(x_j, B_j),
//
// with S0 the state entering the chunk and dS the gradient of the state
// leaving it (carried back from later chunks). Then, with dW_ij = dy_i . x_j,
// T_ij = dW_ij L_ij, dG_ij = T_ij dt_j and M_ij = T_ij G_ij:
//
//   dx_j  = sum_i W_ij dy_i + u_j dS B_j + D dy_j
//   dC_i  = sum_j dG_ij B_j + E_i dy_i . S0
//   dB_j  = sum_i dG_ij C_i + u_j x_j . dS
//   dS_in = exp(last) dS + sum_i E_i outer(dy_i, C_i)        (the carry)
//   du_j  = x_j . dS B_j,  de = sum dS * S0,
//   dcum_i = sum_j M_ij dt_j - dt_i sum_k M_ki + C_i . dC_inter_i - du_i u_i
//            (+ sum_j du_j u_j + exp(last) de at i = kQ - 1),
//   ddt_j = sum_i M_ij + du_j exp(last - cum_j) + A sum_{i >= j} dcum_i,
//   dA    = sum_j dt_j sum_{i >= j} dcum_i,   dD = sum dy * x.
//
// What bounds it on an H100: at mamba2-130m's training layer (B = 8,
// S = 2048, H = 24, P = 64, G = 1, N = 128, f32) it must read x, dt, B, C,
// dy and write dx, ddt, dB, dC (~0.34 GB, 0.10 ms at 3.35 TB/s); its
// chunked work (the products above over j <= i, the three state terms and
// the two carries) is ~42 GFLOP, 0.63 ms at the 67 TFLOP/s of the f32
// CUDA cores. On the tensor cores, as here, each f32 product costs six
// bf16 products (below): ~0.25 TFLOP of full 64-row tiles, 0.26 ms at
// 989 TFLOP/s, so the byte time and the state scratch's traffic (below)
// are of the same order as the products'.
//
// f32 accuracy on bf16 tensor cores. Every product is a bf16 wgmma with
// an f32 accumulator. An f32 operand is split into three bf16 pieces,
// p0 = bf16(v), p1 = bf16(v - p0), p2 = bf16(v - p0 - p1), which hold it
// exactly (8 + 8 + 8 significant bits; each residual is exact in f32).
// A product of two split operands is the sum of the piece products with
// a + b <= 2, (0,0), (0,1), (1,0), (0,2), (1,1), (2,0): what is left out is
// within ~2^-23 of |a||b| a term. An input of bf16 is its own single piece,
// so its products with a split operand take three. Two pieces (2^-16) put
// dA 5e-5 of its max off at bf16 inputs and 5e-5 off at f32 ones, past the
// 1e-5 rule; one piece (a single bf16 rounding) 1e-3
// (tests/test_torch_ssd_bwd_split.py, on the CPU). expf is the accurate one
// (no --use_fast_math), every exponent is <= 0, there are no float atomics
// and every sum has a fixed order, so two launches agree bitwise.
//
// Design (three launches on one stream):
//   1. `sweep`: one block per (two heads of a B/C group, batch row,
//      direction), a producer warpgroup and one consumer warpgroup per
//      head, as the forward's wgmma kernel: a two-stage TMA ring of the
//      heads' x (forward) or dy (reverse) rows and the group's B or C rows.
//      Each consumer carries its head's state (forward) or dS (reverse) in
//      registers in the accumulator's layout, stores it to an f32 scratch
//      (B, H, NC, P, N) as the chunk's S0 or dS, and adds to it, scaled by
//      exp(last), the chunk's (u x)^T B or (E dy)^T C from an accumulator of
//      its own: A, the weighted rows, split in registers; B, the B or C
//      rows, split into bf16 tiles read MN-major.
//   2. `chunk`: one block per (chunk, group, batch row) that walks the
//      group's heads in ascending order, so dB and dC are summed over them
//      in its registers and no per-head partial goes to memory. Its
//      producer warp loads by TMA the group's B and C rows once, then each
//      head's x and dy rows and (plain loads, its step stride being H) dt,
//      into one staging slot that the consumers split into bf16 tiles, and
//      asks L2 for the head's S0 and dS a head ahead (a bulk prefetch). Two
//      consumer warpgroups run the same code on their own 32 of the
//      chunk's 64 columns: each keeps its half of G^T = B C^T (rows j) for
//      every head and forms, per head, its half of dW^T = x dy^T, of W^T,
//      dG^T (into split tiles) and the sums of M, and its half of the
//      contraction W^T dy (A = W^T from its registers). Per 64-row tile of
//      N it reads S0 and dS from the scratch into registers as A operands
//      (split there, two k-steps at a time) and forms its columns of
//      E (S0^T dy^T) with C . that (for dcum), of u (dS^T x^T), of B^T dG^T
//      and of C^T dG, each in an accumulator of its own added in f32 to the
//      sums it carries across the heads (in registers, or at N = 128,
//      where the two tiles' sums would not fit them, in a 32 KB f32
//      scratch a block that each thread alone reads and writes), and of
//      raw^T = dS B^T (for dx and
//      du). The sums across heads are the threads' own f32 adds: the
//      tensor cores' accumulator truncates, and carrying dB and dC in it
//      through 112 heads put them 3e-5 off. One warp then runs dcum, its
//      suffix sums, ddt and the dA and dD partials (B, NC, H) as a warp
//      scan of two steps a lane.
//   3. `reduce_heads` sums the dA and dD partials over (b, chunk) in
//      ascending order.
// The sweeps stay a pass of their own: a block that carried dS across the
// chunks of one head could not sum dB and dC over a group's heads without
// per-head partials in memory, which this design exists to remove.
//
// Built without --use_fast_math. Plain C interface, loaded with ctypes; the
// TMA descriptors are encoded on the host with cuTensorMapEncodeTiled,
// reached through the runtime's driver entry point (no libcuda link).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;              // chunk length: wgmma's M
constexpr int kMid = 3;             // bf16 pieces of an operand computed in f32
constexpr int kThreads = 384;       // a producer warpgroup, two consumer ones
constexpr int kConsumers = 256;
constexpr int kSweepStages = 2;     // the sweep's TMA ring
constexpr uint32_t kFullCount = 1 + 32;  // lane 0's expect_tx and 32 dt arrivals
constexpr uint32_t kAlign = 1024;   // every tile starts on the 128-byte swizzle's repeat

enum DtypeCode { kF32 = 0, kBF16 = 1 };

// bf16 pieces of an input tile: three hold an f32 exactly, one a bf16
template <typename T>
struct In {
  static constexpr int kPieces = 1;
};
template <>
struct In<float> {
  static constexpr int kPieces = 3;
};

constexpr uint32_t align_up(uint32_t v) { return (v + kAlign - 1) & ~(kAlign - 1); }

// wgmma descriptor code of a swizzle: 128, 64 or 32 bytes a row
constexpr uint64_t layout_code(int row_bytes) {
  return row_bytes == 128 ? 1 : (row_bytes == 64 ? 2 : 3);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
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

// One TMA box of a (B, S, NH, Cols) tensor, coordinates innermost first.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int head, int row, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(head), "r"(row),
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

// Make this thread's shared-memory writes visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `v` as a value the compiler cannot see through: a descriptor built from
// it is computed where it is used, not hoisted out of the head loop (where
// the dozens of 64-bit descriptors of a head's products would each hold
// two registers for the whole loop).
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
// (the caller zeroes D first). ss: A and B bf16 in shared memory, TA / TB
// the transpose flags (1: MN-major); rs: A bf16 in registers in the
// accumulator-compatible fragment, a[0..3].
template <int TB>
__device__ __forceinline__ void wgmma_rs16(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss32(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
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

// The first `Pieces` of that split (1: a bf16 rounding, exact for a bf16).
template <int Pieces>
__device__ __forceinline__ void split_n(float v0, float v1, uint32_t* out) {
  uint32_t p[3];
  split3(v0, v1, p[0], p[1], p[2]);
#pragma unroll
  for (int k = 0; k < Pieces; ++k) out[k] = p[k];
}

// The value a tile's `Pieces` pieces hold at byte offset `off` (their sum:
// exact, the pieces of an f32 being non-overlapping).
template <int Pieces>
__device__ __forceinline__ float piece_sum(const uint8_t* tile, uint32_t stride,
                                           uint32_t off) {
  float v = 0.0f;
#pragma unroll
  for (int k = 0; k < Pieces; ++k)
    v += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(tile + k * stride + off));
  return v;
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// Four values of row r, columns c..c+3, into the pieces of a tile.
template <int Cols, int Pieces>
__device__ __forceinline__ void put4(uint8_t* tile, uint32_t stride, int r,
                                     int c, const float (&v)[4]) {
  uint32_t lo[3], hi[3];
  split_n<Pieces>(v[0], v[1], lo);
  split_n<Pieces>(v[2], v[3], hi);
  const uint32_t off = toff<Cols>(r, c);
#pragma unroll
  for (int k = 0; k < Pieces; ++k)
    *reinterpret_cast<uint2*>(tile + k * stride + off) = make_uint2(lo[k], hi[k]);
}

// kQ rows of Cols values of T, dense at `raw`, into the pieces of a tile of
// TCols columns (columns past Cols zero), by the 256 consumer threads.
template <typename T, int Cols, int TCols>
__device__ __forceinline__ void to_pieces(const T* raw, uint8_t* tile, int ct) {
  constexpr int kUnits = kQ * TCols / 4;
#pragma unroll 4
  for (int u = ct; u < kUnits; u += kConsumers) {
    const int r = u / (TCols / 4);
    const int c = (u % (TCols / 4)) * 4;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (c < Cols) load4(raw + r * Cols + c, v);
    put4<TCols, In<T>::kPieces>(tile, Tile<TCols>::kBytes, r, c, v);
  }
}

// The pieces of product A . B (PA pieces of A, PB of B): calls f(a, b)
// for each pair with a + b <= 2, the smallest first, so that the f32
// accumulator takes the small terms before the large ones have grown it.
template <int PA, int PB, typename F>
__device__ __forceinline__ void for_pairs(F f) {
  if (PA > 2) f(2, 0);
  if (PA > 1 && PB > 1) f(1, 1);
  if (PB > 2) f(0, 2);
  if (PA > 1) f(1, 0);
  if (PB > 1) f(0, 1);
  f(0, 0);
}

// Sum over a warp by a butterfly: every lane gets the same bits (each step
// adds the same two values in either order).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// 1. The two sweeps. blockIdx.z == 0: states[c] = the state entering chunk c.
// blockIdx.z == 1: dstates[c] = the gradient of the state leaving chunk c.
// ---------------------------------------------------------------------------
template <typename T, int P, int N>
struct SweepCfg {
  static constexpr int kIn = In<T>::kPieces;
  static constexpr int kNB = N < 64 ? N : 64;  // columns of one product
  static constexpr uint32_t kVRaw = kQ * P * sizeof(T);  // one head's x or dy rows
  static constexpr uint32_t kMRaw = kQ * N * sizeof(T);  // the group's B or C rows
  static constexpr uint32_t kStage = align_up(2 * kVRaw + kMRaw);
  static constexpr uint32_t kMOff = kSweepStages * kStage;  // B or C as pieces
  static constexpr uint32_t kDtOff = kMOff + kIn * Tile<N>::kBytes;
  static constexpr uint32_t kWOff = kDtOff + 4 * kSweepStages * 2 * kQ;
  static constexpr uint32_t kBarOff = kWOff + 4 * 8 * 2 * kQ;
  static constexpr uint32_t kBytes = kBarOff + 64 + kAlign;
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_sweep(const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ CUtensorMap tm_dy,
              const __grid_constant__ CUtensorMap tm_b,
              const __grid_constant__ CUtensorMap tm_c,
              const T* __restrict__ dt, const float* __restrict__ A,
              float* __restrict__ states, float* __restrict__ dstates, int S,
              int H, int rep, int pairs, int NC, long long dtb, long long dts,
              long long dth) {
  using C = SweepCfg<T, P, N>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + kAlign - 1) & ~(kAlign - 1);
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t full = base + C::kBarOff;   // + 8 * stage
  const uint32_t empty = full + 8 * kSweepStages;
  float* const dt_ring = reinterpret_cast<float*>(gbase + C::kDtOff);

  const int g = blockIdx.x / pairs;
  const int pair = blockIdx.x % pairs;
  const int b = blockIdx.y;
  const bool rev = blockIdx.z == 1;
  const int h0 = g * rep + 2 * pair;  // this block's heads: h0 and h0 + 1
  const bool second = 2 * pair + 1 < rep;
  const CUtensorMap* tm_v = rev ? &tm_dy : &tm_x;
  const CUtensorMap* tm_m = rev ? &tm_c : &tm_b;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSweepStages; ++s) {
      mbar_init(full + 8 * s, kFullCount);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer: warp 0 fills the ring ---------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      for (int it = 0; it < NC; ++it) {
        const int c = rev ? NC - 1 - it : it;
        const int stage = it % kSweepStages;
        const uint32_t use = it / kSweepStages;
        const int c0 = c * kQ;
        float dv[2][2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int s = c0 + lane + 32 * k;
            dv[hh][k] = (hh == 0 || second) && s < S
                            ? to_float(dt[b * dtb + s * dts + (h0 + hh) * dth])
                            : 0.0f;
          }
        mbar_wait(empty + 8 * stage, (use & 1) ^ 1);  // the first use passes
        const uint32_t bar = full + 8 * stage;
        const uint32_t st = base + stage * C::kStage;
        if (lane == 0) {
          mbar_expect_tx(bar, 2 * C::kVRaw + C::kMRaw);
          tma_load(st, tm_v, h0, c0, b, bar);
          tma_load(st + C::kVRaw, tm_v, h0 + 1, c0, b, bar);
          tma_load(st + 2 * C::kVRaw, tm_m, g, c0, b, bar);
        }
        float* d_s = dt_ring + stage * 2 * kQ;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int k = 0; k < 2; ++k) d_s[hh * kQ + lane + 32 * k] = dv[hh][k];
        mbar_arrive(bar);  // releases this lane's dt writes
      }
    }
  } else {
    // ---------------- consumers: one head per warpgroup -------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int ct = threadIdx.x - 128;
    const int wg = ct / 128;
    const int t = ct % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int gq = lane / 4;
    const int qd = lane % 4;
    const int h = h0 + wg;
    const bool active = wg == 0 || second;
    const float a_h = active ? A[h] : 0.0f;
    const int r0 = 16 * warp + gq;  // the fragment's rows (p): r0 and r0 + 8
    float* const cum_s = reinterpret_cast<float*>(gbase + C::kWOff) + (4 * wg + warp) * 2 * kQ;
    float* const w_s = cum_s + kQ;
    const uint32_t m_t = base + C::kMOff;
    float* const out = (rev ? dstates : states) +
                       (static_cast<size_t>(b) * H + (active ? h : h0)) * NC * P * N;

    // The carried state (rows p, columns n): state[4j + 2i + c] is row
    // r0 + 8i, column 8j + 2qd + c. Rows at or past P stay 0.
    float state[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) state[i] = 0.0f;

    for (int it = 0; it < NC; ++it) {
      const int c = rev ? NC - 1 - it : it;
      const int stage = it % kSweepStages;
      const uint8_t* const st_g = gbase + stage * C::kStage;
      const T* const v = reinterpret_cast<const T*>(st_g + wg * C::kVRaw);
      const float* const d_s = dt_ring + (stage * 2 + wg) * kQ;
      mbar_wait(full + 8 * stage, (it / kSweepStages) & 1);

      // This warp's scan of dt A (lane l: steps 2l and 2l + 1) and the row
      // weights: u_j = exp(last - cum_j) dt_j forward, E_i = exp(cum_i) in
      // reverse.
      __syncwarp();
      float elast;
      {
        const float d0 = d_s[2 * lane];
        const float d1 = d_s[2 * lane + 1];
        const float a0 = d0 * a_h;
        const float a1 = d1 * a_h;
        float incl = a0 + a1;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float x = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += x;
        }
        float excl = __shfl_up_sync(0xffffffffu, incl, 1);
        if (lane == 0) excl = 0.0f;
        const float last = __shfl_sync(0xffffffffu, incl, 31);
        const float cum0 = excl + a0;
        const float cum1 = incl;
        w_s[2 * lane] = rev ? expf(cum0) : expf(last - cum0) * d0;
        w_s[2 * lane + 1] = rev ? expf(cum1) : expf(last - cum1) * d1;
        elast = expf(last);
      }
      __syncwarp();

      // The B or C rows into pieces, once both warpgroups' products of the
      // last chunk are done with the old ones; the weighted rows, this
      // head's A operand (rows p, columns j), split in registers.
      consumer_sync();
      to_pieces<T, N, N>(reinterpret_cast<const T*>(st_g + 2 * C::kVRaw),
                         gbase + C::kMOff, ct);
      uint32_t ap[kMid][16];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 16 * kk + 8 * half + 2 * qd;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int p = r0 + 8 * i;
            float v0 = 0.0f, v1 = 0.0f;
            if (p < P) {
              v0 = to_float(v[j * P + p]) * w_s[j];
              v1 = to_float(v[(j + 1) * P + p]) * w_s[j + 1];
            }
            uint32_t pc[3];
            split3(v0, v1, pc[0], pc[1], pc[2]);
#pragma unroll
            for (int k = 0; k < kMid; ++k) ap[k][4 * kk + 2 * half + i] = pc[k];
          }
        }
      fence_async_smem();
      consumer_sync();
      if (lane == 0) mbar_arrive(empty + 8 * stage);  // the stage is read

      // Store the carried state: forward the state entering chunk c, in
      // reverse the gradient of the state leaving it. Then scale and add.
      if (active) {
        float* o = out + static_cast<size_t>(c) * P * N;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int p = r0 + 8 * i;
            if (p < P)
              *reinterpret_cast<float2*>(o + p * N + 8 * j + 2 * qd) =
                  make_float2(state[4 * j + 2 * i], state[4 * j + 2 * i + 1]);
          }
      }
      // the chunk's product in an accumulator of its own, then added to
      // the scaled carry in f32 (round to nearest), so the carry is not
      // accumulated by the tensor cores chunk after chunk
      float add[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) add[i] = 0.0f;
      wgmma_fence();
      for_pairs<kMid, C::kIn>([&](int a, int bp) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int nb = 0; nb < N / C::kNB; ++nb)
            wgmma_rs<C::kNB, 1>(add + nb * C::kNB / 2, ap[a] + 4 * kk,
                                mdesc<N>(m_t + bp * Tile<N>::kBytes, nb, kk));
      });
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<N / 2>(add);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) state[i] = fmaf(state[i], elast, add[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. Every gradient term of one (chunk, group, batch row), the group's heads
// in ascending order. Consumer warpgroup k owns columns 32k..32k+31 of the
// chunk's 64 steps: of i in the products whose columns are the rows C, dy
// and dC are read on (G^T, dW^T, dC^T), of j in those on the rows of B, x
// and dB (dB^T, raw^T), and of the contraction over i in W^T dy.
// ---------------------------------------------------------------------------
template <typename T, int P, int N>
struct ChunkCfg {
  static constexpr int kIn = In<T>::kPieces;
  static constexpr int kNT = N < 64 ? 64 : N;  // columns of the B and C tiles
  static constexpr int kNK = N < 64 ? N : 64;  // state columns of one n tile
  static constexpr int kTiles = N / kNK;       // n tiles of 64 rows: 1 or 2
  static constexpr int kRS = P + 4;            // row stride of the f32 dx tile
  static constexpr uint32_t kStaging =
      align_up((kQ * N > 2 * kQ * P ? kQ * N : 2 * kQ * P) * sizeof(T));
  static constexpr uint32_t kBC = Tile<kNT>::kBytes;  // a piece of B or C
  static constexpr uint32_t kXY = Tile<P>::kBytes;    // a piece of x or dy
  static constexpr uint32_t kGH = Tile<32>::kBytes;   // half a piece of dG^T
  static constexpr uint32_t kBOff = kStaging;
  static constexpr uint32_t kCOff = kBOff + kIn * kBC;
  static constexpr uint32_t kXOff = kCOff + kIn * kBC;
  static constexpr uint32_t kYOff = kXOff + kIn * kXY;
  static constexpr uint32_t kGOff = kYOff + kIn * kXY;
  static constexpr uint32_t kDxOff = kGOff + kMid * 2 * kGH;
  static constexpr uint32_t kVecOff = kDxOff + 4 * kQ * kRS;
  // floats: dt as loaded; dt, cum, E = exp(cum), exp(last - cum); 2 halves'
  // sums of M over i; 4 warps' sums of M dt over j; 8 of C . dC_inter; 4
  // of du; 4 de, 8 dy . x, 4 scalars
  static constexpr int kVecFloats = 5 * kQ + 2 * kQ + 4 * kQ + 8 * kQ + 4 * kQ + 16;
  static constexpr uint32_t kBarOff = kVecOff + 4 * kVecFloats;
  static constexpr uint32_t kBytes = kBarOff + 64 + kAlign;
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk(const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ CUtensorMap tm_dy,
              const __grid_constant__ CUtensorMap tm_b,
              const __grid_constant__ CUtensorMap tm_c,
              const T* __restrict__ dt, const float* __restrict__ A,
              const float* __restrict__ D, const float* __restrict__ states,
              const float* __restrict__ dstates, T* __restrict__ dx,
              T* __restrict__ ddt, T* __restrict__ dB, T* __restrict__ dC,
              float* __restrict__ dA_part, float* __restrict__ dD_part,
              float* __restrict__ sums, int S, int H, int G, int rep, int NC,
              long long dtb, long long dts, long long dth) {
  using C = ChunkCfg<T, P, N>;
  constexpr int kIn = C::kIn;
  constexpr int kNT = C::kNT;
  constexpr int kTiles = C::kTiles;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + kAlign - 1) & ~(kAlign - 1);
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t full = base + C::kBarOff;
  const uint32_t empty = full + 8;
  float* const vec = reinterpret_cast<float*>(gbase + C::kVecOff);
  float* const dt_in = vec;               // the producer's dt of the next head
  float* const dt_h = dt_in + kQ;         // this head's
  float* const cum_h = dt_h + kQ;
  float* const e_h = cum_h + kQ;          // exp(cum_i)
  float* const eu_h = e_h + kQ;           // exp(last - cum_j)
  float* const colpart = eu_h + kQ;       // [2 halves][kQ]: sum_i M_ij
  float* const rowpart = colpart + 2 * kQ;  // [4 warps][kQ]: sum_j M_ij dt_j
  float* const qpart = rowpart + 4 * kQ;  // [tile][4 warps][kQ]: C_i . (S0^T dy^T)_i
  float* const dupart = qpart + 8 * kQ;   // [4 warps][kQ]: du_j
  float* const depart = dupart + 4 * kQ;  // [4 warps]
  float* const ddpart = depart + 4;       // [8 warps]: dy . x
  float* const sc = ddpart + 8;           // last, exp(last)
  float* const dx_s = reinterpret_cast<float*>(gbase + C::kDxOff);  // [j][kRS]
  const uint32_t b_t = base + C::kBOff, c_t = base + C::kCOff;
  const uint32_t x_t = base + C::kXOff, y_t = base + C::kYOff;
  const uint32_t g_t = base + C::kGOff;   // piece q, half h at + (2q + h) kGH
  const uint8_t* const c_g = gbase + C::kCOff;
  const uint8_t* const x_g = gbase + C::kXOff;
  const uint8_t* const y_g = gbase + C::kYOff;

  const int c = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int c0 = c * kQ;
  const int rows = S - c0 < kQ ? S - c0 : kQ;  // rows of this chunk inside S

  if (threadIdx.x == 0) {
    mbar_init(full, kFullCount);
    mbar_init(empty, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer: warp 0 fills the staging slot -------------
    // item 0: the group's B rows; 1: its C rows; 2 + k: head k's x and dy
    // rows and dt
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      for (int item = 0; item < 2 + rep; ++item) {
        const int h = g * rep + item - 2;
        float dv[2] = {0.0f, 0.0f};
        if (item >= 2) {
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int s = c0 + lane + 32 * k;
            if (s < S) dv[k] = to_float(dt[b * dtb + s * dts + h * dth]);
          }
        }
        mbar_wait(empty, (item & 1) ^ 1);  // the first use passes
        if (lane == 0) {
          if (item < 2) {
            mbar_expect_tx(full, kQ * N * sizeof(T));
            tma_load(base, item == 0 ? &tm_b : &tm_c, g, c0, b, full);
          } else {
            mbar_expect_tx(full, 2 * kQ * P * sizeof(T));
            tma_load(base, &tm_x, h, c0, b, full);
            tma_load(base + kQ * P * sizeof(T), &tm_dy, h, c0, b, full);
            // the head's S0 and dS into L2: the consumers read them as
            // operands from registers a head later
            const size_t sidx = ((static_cast<size_t>(b) * H + h) * NC + c) * P * N;
            prefetch_l2(states + sidx, P * N * 4);
            prefetch_l2(dstates + sidx, P * N * 4);
          }
        }
        if (item >= 2) {
          dt_in[lane] = dv[0];
          dt_in[lane + 32] = dv[1];
        }
        mbar_arrive(full);  // releases this lane's dt writes
      }
    }
    return;
  }

  // ---------------- consumers ----------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int ct = threadIdx.x - 128;
  const int wg = ct / 128;  // this warpgroup's half: columns 32wg..32wg+31
  const int t = ct % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int gq = lane / 4;
  const int qd = lane % 4;
  const int r0 = 16 * warp + gq;  // the fragment's rows: r0 and r0 + 8
  const int h0 = 32 * wg;         // first column of the half
  const T* const staged = reinterpret_cast<const T*>(gbase);
  // rows h0.. of a tile, as the start of a K-major operand of 32 rows
  const uint32_t x_h = x_t + h0 * Tile<P>::kRB;
  const uint32_t y_h = y_t + h0 * Tile<P>::kRB;
  const uint32_t b_h = b_t + h0 * Tile<kNT>::kRB;

  // 1. The group's B and C rows as pieces (columns past N zero).
  mbar_wait(full, 0);
  to_pieces<T, N, kNT>(staged, gbase + C::kBOff, ct);
  fence_async_smem();
  consumer_sync();
  if (ct == 0) mbar_arrive(empty);
  mbar_wait(full, 1);
  to_pieces<T, N, kNT>(staged, gbase + C::kCOff, ct);
  fence_async_smem();
  consumer_sync();
  if (ct == 0) mbar_arrive(empty);

  // the sums over the heads of dC^T and dB^T (rows n, this half's columns
  // i / j), added in f32 head after head: at N <= 64 in registers; at
  // N = 128 in `sums`, an f32 scratch of 32 KB a block that each thread
  // reads and writes only at its own places, 128 threads apart (held, the
  // two tiles' sums would cost each thread 64 registers, past what the
  // consumers have beside a head's operands)
  constexpr bool kHeld = kTiles == 1;
  float dca[16], dba[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) dca[r] = dba[r] = 0.0f;
  float* const my_sums =
      kHeld ? nullptr
            : sums + (((static_cast<size_t>(b) * NC + c) * G + g) * 2 + wg) *
                         (kTiles * 2 * 16 * 128) + t;
  if (!kHeld) {
#pragma unroll
    for (int r = 0; r < kTiles * 2 * 16; ++r) my_sums[r * 128] = 0.0f;
  }
  // sum r of tile tt's dC (which 0) or dB (1) += a * v, in f32, in
  // registers or read and written where it stands (the read is not
  // hoisted into the products before it)
  auto add_sum = [&](int tt, int which, int r, float a, float v) {
    if (kHeld) {
      float& d = which == 0 ? dca[r] : dba[r];
      d = fmaf(a, v, d);
    } else {
      float* const p = my_sums + ((2 * tt + which) * 16 + r) * 128;
      float cur;
      asm volatile("ld.global.cg.f32 %0, [%1];\n" : "=f"(cur) : "l"(p));
      *p = fmaf(a, v, cur);
    }
  };

  const float* const st_base = states + (static_cast<size_t>(b) * H) * NC * P * N;
  const float* const ds_base = dstates + (static_cast<size_t>(b) * H) * NC * P * N;

  for (int hi = 0; hi < rep; ++hi) {
    const int h = g * rep + hi;
    const float a_h = A[h];
    const size_t sidx = (static_cast<size_t>(h) * NC + c) * P * N;
    const float* const s0 = st_base + sidx;
    const float* const dsv = ds_base + sidx;

    // 2. This head's x and dy rows as pieces, once every reader of the last
    // head's is done; warp 0 takes dt and scans dt A.
    mbar_wait(full, (2 + hi) & 1);
    consumer_sync();
    float dd = 0.0f;  // this thread's share of sum dy * x
    {
      const T* xr = staged;
      const T* yr = staged + kQ * P;
#pragma unroll 1
      for (int u = ct; u < kQ * P / 4; u += kConsumers) {
        const int r = u / (P / 4);
        const int col = (u % (P / 4)) * 4;
        float xv[4], yv[4];
        load4(xr + r * P + col, xv);
        load4(yr + r * P + col, yv);
#pragma unroll
        for (int k = 0; k < 4; ++k) dd = fmaf(xv[k], yv[k], dd);
        put4<P, kIn>(gbase + C::kXOff, C::kXY, r, col, xv);
        put4<P, kIn>(gbase + C::kYOff, C::kXY, r, col, yv);
      }
    }
    if (ct < 32) {
      const float d0 = dt_in[2 * lane];
      const float d1 = dt_in[2 * lane + 1];
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
        dt_h[r] = dv[k];
        cum_h[r] = cm[k];
        e_h[r] = expf(cm[k]);
        eu_h[r] = expf(last - cm[k]);
      }
      if (lane == 0) {
        sc[0] = last;
        sc[1] = expf(last);
      }
    }
    fence_async_smem();
    consumer_sync();
    if (ct == 0) mbar_arrive(empty);  // the producer loads the next head
    dd = warp_sum(dd);
    if (lane == 0) ddpart[4 * wg + warp] = dd;

    // 3. G^T = B C^T and dW^T = x dy^T on this half's columns i (G^T is
    // the same for every head, but formed again beside dW^T rather than
    // held: held, it would cost each thread 16 registers through the head),
    // then W^T, dG^T (into this half's tiles) and M^T's sums; this half's
    // share of W^T dy.
    float dxa[P / 2];
    {
      float gt[16], acc[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) gt[r] = acc[r] = 0.0f;
      // G^T's and dW^T's contractions in groups of two k-steps, each waited
      // for before the next is issued: at N = 128 the f32 pieces' 48
      // products of one group would hold their descriptors all at once
      // (registers the consumers do not have beside the head's sums)
#pragma unroll
      for (int k0 = 0; k0 < N / 16; k0 += 2) {
        if (k0 > 0) wgmma_wait<0>();
        wgmma_fence();
        for_pairs<kIn, kIn>([&](int a, int bp) {
#pragma unroll
          for (int ks = k0; ks < k0 + 2 && ks < N / 16; ++ks)
            wgmma_ss32<0, 0>(gt, kdesc<kNT>(opaque(b_t) + a * C::kBC, ks),
                             kdesc<kNT>(opaque(c_t) + bp * C::kBC + h0 * Tile<kNT>::kRB, ks));
        });
        wgmma_commit();
      }
#pragma unroll
      for (int k0 = 0; k0 < P / 16; k0 += 2) {
        wgmma_wait<0>();
        wgmma_fence();
        for_pairs<kIn, kIn>([&](int a, int bp) {
#pragma unroll
          for (int ks = k0; ks < k0 + 2 && ks < P / 16; ++ks)
            wgmma_ss32<0, 0>(acc, kdesc<P>(opaque(x_t) + a * C::kXY, ks),
                             kdesc<P>(opaque(y_h) + bp * C::kXY, ks));
        });
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs<16>(gt);
      fence_regs<16>(acc);
      // acc[4jj + 2ii + cc] is row j = r0 + 8ii, column i = h0 + 8jj + 2qd + cc
      uint32_t wa[kMid][8];
      float colsum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float cs[2] = {0.0f, 0.0f};  // sum_j M_ij dt_j over the thread's rows
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int r = 4 * jj + 2 * ii;
          const int j = r0 + 8 * ii;
          const int il = 8 * jj + 2 * qd;  // column within the half
          const float cj = cum_h[j];
          const float dtj = dt_h[j];
          float w[2], dg[2];
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int i = h0 + il + cc;
            // every exponent <= 0: clamped above the diagonal (i < j),
            // where every term is 0
            const float l = expf(fminf(cum_h[i] - cj, 0.0f));
            const float tt = i >= j ? acc[r + cc] * l : 0.0f;
            const float m = tt * gt[r + cc];
            w[cc] = i >= j ? gt[r + cc] * l * dtj : 0.0f;
            dg[cc] = tt * dtj;
            colsum[ii] += m;
            cs[cc] = fmaf(m, dtj, cs[cc]);
          }
          uint32_t pw[3], pg[3];
          split3(w[0], w[1], pw[0], pw[1], pw[2]);
          split3(dg[0], dg[1], pg[0], pg[1], pg[2]);
#pragma unroll
          for (int k = 0; k < kMid; ++k) {
            wa[k][r / 2] = pw[k];
            *reinterpret_cast<uint32_t*>(gbase + C::kGOff + (2 * k + wg) * C::kGH +
                                         toff<32>(j, il)) = pg[k];
          }
        }
        // over the warp's 16 rows: the eight row groups
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          float v = cs[cc];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (gq == 0) rowpart[warp * kQ + h0 + 8 * jj + 2 * qd + cc] = v;
        }
      }
      fence_async_smem();
      // sum over this half's i of M_ij: the thread's 8 columns, then its quad
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        float v = colsum[ii];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (qd == 0) colpart[wg * kQ + r0 + 8 * ii] = v;
      }
      // W^T dy over this half's i (rows j, columns p)
#pragma unroll
      for (int r = 0; r < P / 2; ++r) dxa[r] = 0.0f;
      wgmma_fence();
      for_pairs<kMid, kIn>([&](int a, int bp) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wgmma_rs<P, 1>(dxa, wa[a] + 4 * kk,
                         mdesc<P>(opaque(y_t) + bp * C::kXY, 0, 2 * wg + kk));
      });
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<P / 2>(dxa);
    }
    // the first half's share starts the f32 dx tile (rows j, columns p)
    if (wg == 0) {
#pragma unroll
      for (int r = 0; r < P / 2; r += 2) {
        const int j = r0 + 8 * ((r >> 1) & 1);
        *reinterpret_cast<float2*>(dx_s + j * C::kRS + 8 * (r >> 2) + 2 * qd) =
            make_float2(dxa[r], dxa[r + 1]);
      }
    }
    consumer_sync();  // dG^T's tiles, the dx tile and the sums of M are written
    if (wg == 1) {
#pragma unroll
      for (int r = 0; r < P / 2; r += 2) {
        const int j = r0 + 8 * ((r >> 1) & 1);
        float2* d = reinterpret_cast<float2*>(dx_s + j * C::kRS + 8 * (r >> 2) + 2 * qd);
        const float2 v = *d;
        *d = make_float2(v.x + dxa[r], v.y + dxa[r + 1]);
      }
    }

    // 4. Per n tile: dC^T's and dB^T's terms on this half's columns, from
    // S0 and dS read as A operands (rows n, columns p), each into an
    // accumulator of its own and added to the sums in f32.
    float de = 0.0f;
#pragma unroll
    for (int tt = 0; tt < kTiles; ++tt) {
      // dC_inter^T = S0^T dy^T, S0 read at (n, p) = (64tt + r0 + 8ii,
      // 16kk + 8half + 2qd + cc) and split as the A operand, two k-steps
      // at a time (each group's pieces are 24 registers, not all 48)
      float acc[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r] = 0.0f;
#pragma unroll
      for (int kg = 0; kg < P / 16; kg += 2) {
        constexpr int kSteps = P / 16 < 2 ? P / 16 : 2;
        uint32_t sa[kMid][4 * kSteps];
#pragma unroll
        for (int k = 0; k < 8 * kSteps; k += 2) {
          const int kk = kg + k / 8, half = (k / 4) & 1, ii = (k / 2) & 1;
          const int n = 64 * tt + r0 + 8 * ii;
          const int p = 16 * kk + 8 * half + 2 * qd;
          const float v0 = n < N ? s0[p * N + n] : 0.0f;
          const float v1 = n < N ? s0[(p + 1) * N + n] : 0.0f;
          split3(v0, v1, sa[0][k / 2], sa[1][k / 2], sa[2][k / 2]);
        }
        wgmma_fence();
        for_pairs<kMid, kIn>([&](int a, int bp) {
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk)
            wgmma_rs<32, 0>(acc, sa[a] + 4 * kk,
                            kdesc<P>(opaque(y_h) + bp * C::kXY, kg + kk));
        });
        wgmma_commit();
        wgmma_wait<0>();
      }
      fence_regs<16>(acc);
      // C_i . dC_inter_i over this warp's rows n; dC^T += E_i dC_inter^T.
      // acc[4jj + 2ii + cc] is row n = 64tt + r0 + 8ii, column
      // i = h0 + 8jj + 2qd + cc
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int i = h0 + 8 * jj + 2 * qd + cc;
          float v = 0.0f;
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            const int r = 4 * jj + 2 * ii + cc;
            const int n = 64 * tt + r0 + 8 * ii;
            v = fmaf(piece_sum<kIn>(c_g, C::kBC, toff<kNT>(i, n)), acc[r], v);
            add_sum(tt, 0, r, e_h[i], acc[r]);
          }
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (gq == 0) qpart[(4 * tt + warp) * kQ + i] = v;
        }
      // dS at the same places, split, and the thread's share of de (S0
      // read again beside it), then dB_inter^T = dS^T x^T and dB^T +=
      // u_j dB_inter^T, two k-steps at a time
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r] = 0.0f;
#pragma unroll
      for (int kg = 0; kg < P / 16; kg += 2) {
        constexpr int kSteps = P / 16 < 2 ? P / 16 : 2;
        uint32_t da_[kMid][4 * kSteps];
#pragma unroll
        for (int k = 0; k < 8 * kSteps; k += 2) {
          const int kk = kg + k / 8, half = (k / 4) & 1, ii = (k / 2) & 1;
          const int n = 64 * tt + r0 + 8 * ii;
          const int p = 16 * kk + 8 * half + 2 * qd;
          float v0 = 0.0f, v1 = 0.0f;
          if (n < N) {
            v0 = dsv[p * N + n];
            v1 = dsv[(p + 1) * N + n];
            de = fmaf(s0[p * N + n], v0, de);
            de = fmaf(s0[(p + 1) * N + n], v1, de);
          }
          split3(v0, v1, da_[0][k / 2], da_[1][k / 2], da_[2][k / 2]);
        }
        wgmma_fence();
        for_pairs<kMid, kIn>([&](int a, int bp) {
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk)
            wgmma_rs<32, 0>(acc, da_[a] + 4 * kk,
                            kdesc<P>(opaque(x_h) + bp * C::kXY, kg + kk));
        });
        wgmma_commit();
        wgmma_wait<0>();
      }
      fence_regs<16>(acc);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int j = h0 + 8 * (r >> 2) + 2 * qd + (r & 1);
        add_sum(tt, 1, r, eu_h[j] * dt_h[j], acc[r]);
      }
      // B^T dG^T (rows n, this half's columns i: dG^T's tile of the half
      // read MN-major) and C^T dG (this half's columns j: rows of both
      // halves' tiles read K-major), each then added in f32
      float acc2[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r] = acc2[r] = 0.0f;
      wgmma_fence();
      // one k-step of both products at a time, for the same reason
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk > 0) wgmma_wait<0>();
        wgmma_fence();
        for_pairs<kIn, kMid>([&](int a, int bp) {
          wgmma_ss32<1, 1>(acc, mdesc<kNT>(opaque(b_t) + a * C::kBC, tt, kk),
                           mdesc<32>(opaque(g_t) + (2 * bp + wg) * C::kGH, 0, kk));
          wgmma_ss32<1, 0>(acc2, mdesc<kNT>(opaque(c_t) + a * C::kBC, tt, kk),
                           kdesc<32>(opaque(g_t) + (2 * bp + kk / 2) * C::kGH +
                                         h0 * Tile<32>::kRB, kk % 2));
        });
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs<16>(acc);
      fence_regs<16>(acc2);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        add_sum(tt, 0, r, 1.0f, acc[r]);
        add_sum(tt, 1, r, 1.0f, acc2[r]);
      }
      asm volatile("" ::: "memory");  // no tile's loads hoisted into another's
    }
    if (wg == 0) {
      de = warp_sum(de);
      if (lane == 0) depart[warp] = de;
    }

    // 5. raw^T = dS B^T on this half's columns j (rows p), over every n
    // tile, then du_j = sum_p x_jp raw_jp over this warp's rows p.
    float rawa[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) rawa[r] = 0.0f;
#pragma unroll
    for (int tt = 0; tt < kTiles; ++tt) {
#pragma unroll
      for (int kg = 0; kg < C::kNK / 16; kg += 2) {
        constexpr int kSteps = C::kNK / 16 < 2 ? C::kNK / 16 : 2;
        uint32_t ra[kMid][4 * kSteps];
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int ii = 0; ii < 2; ++ii) {
              const int p = r0 + 8 * ii;
              const int n = 64 * tt + 16 * (kg + kk) + 8 * half + 2 * qd;
              float2 v = make_float2(0.0f, 0.0f);
              if (p < P) v = *reinterpret_cast<const float2*>(dsv + p * N + n);
              const int q = 4 * kk + 2 * half + ii;
              split3(v.x, v.y, ra[0][q], ra[1][q], ra[2][q]);
            }
        wgmma_fence();
        for_pairs<kMid, kIn>([&](int a, int bp) {
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk)
            wgmma_rs<32, 0>(rawa, ra[a] + 4 * kk,
                            kdesc<kNT>(opaque(b_h) + bp * C::kBC, 4 * tt + kg + kk));
        });
        wgmma_commit();
        wgmma_wait<0>();
      }
      asm volatile("" ::: "memory");
    }
    fence_regs<16>(rawa);
    // rawa[4jj + 2ii + cc] is row p = r0 + 8ii, column j = h0 + 8jj + 2qd + cc
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int j = h0 + 8 * jj + 2 * qd + cc;
        float v = 0.0f;
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int p = r0 + 8 * ii;
          if (p < P)
            v = fmaf(piece_sum<kIn>(x_g, C::kXY, toff<P>(j, p)),
                     rawa[4 * jj + 2 * ii + cc], v);
        }
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (gq == 0) dupart[warp * kQ + j] = v;
      }
    consumer_sync();  // the other half's W^T dy is in the tile; every sum is written

    // dx_jp += u_j raw_jp on this half's columns j
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int p = r0 + 8 * ((r >> 1) & 1);
      const int j = h0 + 8 * (r >> 2) + 2 * qd + (r & 1);
      if (p < P) dx_s[j * C::kRS + p] += eu_h[j] * dt_h[j] * rawa[r];
    }
    if (ct < 32) {
      // 6. dcum, its suffix sums, ddt and the dA, dD partials: lane l takes
      // steps 2l and 2l + 1; every sum in a fixed order
      float dc[2], duu[2], colv[2], duv[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int r = 2 * lane + k;
        float rowm = 0.0f, q = 0.0f, du = 0.0f;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          rowm += rowpart[w * kQ + r];
          du += dupart[w * kQ + r];
        }
#pragma unroll
        for (int w = 0; w < 4 * kTiles; ++w) q += qpart[w * kQ + r];
        q *= e_h[r];
        colv[k] = colpart[r] + colpart[kQ + r];
        duv[k] = du;
        duu[k] = du * eu_h[r] * dt_h[r];
        dc[k] = rowm - dt_h[r] * colv[k] + q - duu[k];
      }
      const float tail = warp_sum(duu[0] + duu[1]);
      float de_sum = 0.0f, dd_sum = 0.0f;
#pragma unroll
      for (int w = 0; w < 4; ++w) de_sum += depart[w];
#pragma unroll
      for (int w = 0; w < 8; ++w) dd_sum += ddpart[w];
      if (lane == 31) dc[1] += tail + sc[1] * de_sum;
      // suffix sums from the right: the pair's sum, scanned down the lanes
      float incl = dc[0] + dc[1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += v;
      }
      float after = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) after = 0.0f;
      float suf[2];
      suf[1] = dc[1] + after;
      suf[0] = dc[0] + suf[1];
      float da = 0.0f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int r = 2 * lane + k;
        da = fmaf(dt_h[r], suf[k], da);
        const float v = colv[k] + duv[k] * eu_h[r] + a_h * suf[k];
        if (r < rows) ddt[(static_cast<size_t>(b) * S + c0 + r) * H + h] = from_float<T>(v);
      }
      da = warp_sum(da);
      if (lane == 0) {
        const size_t pidx = (static_cast<size_t>(b) * NC + c) * H + h;
        dA_part[pidx] = da;
        dD_part[pidx] = dd_sum;
      }
    }
    consumer_sync();  // the dx tile is whole

    // dx = W^T dy + u raw + D dy, rounded once; rows past S not stored
    const float d_h = D != nullptr ? D[h] : 0.0f;
#pragma unroll 1
    for (int e = 2 * ct; e < kQ * P; e += 2 * kConsumers) {
      const int j = e / P;
      const int p = e % P;
      if (j >= rows) continue;
      float v[2];
#pragma unroll
      for (int k = 0; k < 2; ++k)
        v[k] = fmaf(d_h, piece_sum<kIn>(y_g, C::kXY, toff<P>(j, p + k)),
                    dx_s[j * C::kRS + p + k]);
      T* dst = dx + ((static_cast<size_t>(b) * S + c0 + j) * H + h) * P + p;
      dst[0] = from_float<T>(v[0]);
      dst[1] = from_float<T>(v[1]);
    }
  }

  // 7. dB and dC of the group, summed over its heads, rounded once: the
  // sums' [4jj + 2ii + cc] is row n = 64tt + r0 + 8ii, column
  // i = h0 + 8jj + 2qd + cc
#pragma unroll
  for (int tt = 0; tt < kTiles; ++tt)
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int n = 64 * tt + r0 + 8 * ((r >> 1) & 1);
      const int i = h0 + 8 * (r >> 2) + 2 * qd + (r & 1);
      if (n < N && i < rows) {
        const size_t o = ((static_cast<size_t>(b) * S + c0 + i) * G + g) * N + n;
        dC[o] = from_float<T>(kHeld ? dca[r] : my_sums[(2 * tt * 16 + r) * 128]);
        dB[o] = from_float<T>(kHeld ? dba[r] : my_sums[((2 * tt + 1) * 16 + r) * 128]);
      }
    }
}

// ---------------------------------------------------------------------------
// 3. dA, dD (H,) = sum over (b, chunk), ascending, of the partials (B*NC, H).
// ---------------------------------------------------------------------------
__global__ void ssd_bwd_reduce_heads(const float* __restrict__ dA_part,
                                     const float* __restrict__ dD_part,
                                     float* __restrict__ dA,
                                     float* __restrict__ dD, int rows, int H) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float sa = 0.0f, sd = 0.0f;
  for (int r = 0; r < rows; ++r) {
    sa += dA_part[static_cast<size_t>(r) * H + h];
    sd += dD_part[static_cast<size_t>(r) * H + h];
  }
  dA[h] = sa;
  if (dD != nullptr) dD[h] = sd;
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

// A TMA descriptor for one contiguous (B, S, NH, Cols) tensor of T: boxes
// of kQ rows of one head and all Cols columns, unswizzled (the consumers
// split them into the tiles the products read). S is a dimension of its
// own, so a box past S reads zeros.
template <typename T>
cudaError_t encode(CUtensorMap* map, const void* ptr, int B, int S, int NH,
                   int cols) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t item = sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(NH),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(cols) * item,
                                 static_cast<cuuint64_t>(NH) * cols * item,
                                 static_cast<cuuint64_t>(S) * NH * cols * item};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(kQ), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult rc = fn(
      map,
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Args {
  const void *x, *dt, *Bm, *Cm, *dy;
  const float *A, *D;
  void *dx, *ddt, *dB, *dC;
  float *dA, *dD, *states, *dstates, *dA_part, *dD_part, *sums;
};

template <typename T, int P, int N>
cudaError_t launch(const Args& a, int B, int S, int H, int G,
                   const long long* dts, cudaStream_t stream) {
  CUtensorMap tm_x, tm_dy, tm_b, tm_c;
  cudaError_t err = encode<T>(&tm_x, a.x, B, S, H, P);
  if (err == cudaSuccess) err = encode<T>(&tm_dy, a.dy, B, S, H, P);
  if (err == cudaSuccess) err = encode<T>(&tm_b, a.Bm, B, S, G, N);
  if (err == cudaSuccess) err = encode<T>(&tm_c, a.Cm, B, S, G, N);
  if (err != cudaSuccess) return err;
  constexpr uint32_t sweep_smem = SweepCfg<T, P, N>::kBytes;
  constexpr uint32_t chunk_smem = ChunkCfg<T, P, N>::kBytes;
  err = cudaFuncSetAttribute(ssd_bwd_sweep<T, P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sweep_smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_chunk<T, P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(chunk_smem));
  if (err != cudaSuccess) return err;
  const int NC = (S + kQ - 1) / kQ;
  const int rep = H / G;
  const int pairs = (rep + 1) / 2;
  const T* dt = static_cast<const T*>(a.dt);
  ssd_bwd_sweep<T, P, N><<<dim3(G * pairs, B, 2), kThreads, sweep_smem, stream>>>(
      tm_x, tm_dy, tm_b, tm_c, dt, a.A, a.states, a.dstates, S, H, rep, pairs,
      NC, dts[0], dts[1], dts[2]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk<T, P, N><<<dim3(NC, G, B), kThreads, chunk_smem, stream>>>(
      tm_x, tm_dy, tm_b, tm_c, dt, a.A, a.D, a.states, a.dstates,
      static_cast<T*>(a.dx), static_cast<T*>(a.ddt), static_cast<T*>(a.dB),
      static_cast<T*>(a.dC), a.dA_part, a.dD_part, a.sums, S, H, G, rep, NC,
      dts[0], dts[1], dts[2]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_reduce_heads<<<(H + 127) / 128, 128, 0, stream>>>(
      a.dA_part, a.dD_part, a.dA, a.D != nullptr ? a.dD : nullptr, B * NC, H);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t dispatch_n(const Args& a, int B, int S, int H, int G, int N,
                       const long long* dts, cudaStream_t s) {
  switch (N) {
    case 16:
      return launch<T, P, 16>(a, B, S, H, G, dts, s);
    case 32:
      return launch<T, P, 32>(a, B, S, H, G, dts, s);
    case 64:
      return launch<T, P, 64>(a, B, S, H, G, dts, s);
    case 128:
      return launch<T, P, 128>(a, B, S, H, G, dts, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_p(const Args& a, int B, int S, int H, int G, int P,
                       int N, const long long* dts, cudaStream_t s) {
  switch (P) {
    case 16:
      return dispatch_n<T, 16>(a, B, S, H, G, N, dts, s);
    case 32:
      return dispatch_n<T, 32>(a, B, S, H, G, N, dts, s);
    case 64:
      return dispatch_n<T, 64>(a, B, S, H, G, N, dts, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Inputs: x (B, S, H, P), dt (B, S, H), B and C (B, S, G, N) and dy
// (B, S, H, P) of one dtype (0 = float32, 1 = bfloat16); x, B, C and dy
// contiguous with 16-byte aligned data (TMA reads them), dt read through
// the 3 element strides in `dt_strides` (b, s, h); A (H,) and D (H,)
// float32, D may be null. P in {16, 32, 64}, N in {16, 32, 64, 128}.
// Outputs, contiguous: dx (B, S, H, P), ddt (B, S, H), dB and dC
// (B, S, G, N) in the inputs' dtype; dA (H,) and dD (H,) float32 (dD
// unwritten when D is null). Scratch, f32 and contiguous, NC = ceil(S / 64):
// states and dstates (B, H, NC, P, N), dA_part and dD_part (B, NC, H), and
// at N = 128 sums (B, NC, G, 2, 2, 2, 16, 128), the dB and dC sums over
// a group's heads (null at other N).
// Launches three kernels on `stream`; returns the first error (0 on
// success): a TMA descriptor that does not encode, or cudaGetLastError()
// of a launch. Does not synchronise and allocates nothing.
int ssd_scan_bwd(const void* x, const void* dt, const float* A,
                 const void* Bm, const void* Cm, const float* D,
                 const void* dy, void* dx, void* ddt, float* dA, void* dB,
                 void* dC, float* dD, float* states, float* dstates,
                 float* dA_part, float* dD_part, float* sums, int B, int S,
                 int H, int G,
                 int P, int N, int dtype, const long long* dt_strides,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || S < 1 || H < 1 || G < 1 || G > 65535 ||
      H % G != 0 || dt_strides == nullptr || (N == 128 && sums == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const Args a{x, dt, Bm, Cm, dy, A, D, dx, ddt, dB, dC, dA, dD, states,
               dstates, dA_part, dD_part, sums};
  switch (dtype) {
    case kF32:
      return dispatch_p<float>(a, B, S, H, G, P, N, dt_strides, s);
    case kBF16:
      return dispatch_p<__nv_bfloat16>(a, B, S, H, G, P, N, dt_strides, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* ssd_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
