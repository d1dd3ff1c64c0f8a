// Hopper (sm_90a) backward of flash attention, float32 and bfloat16 inputs,
// on the bf16 tensor cores: the gradients dq, dk, dv of
//
//     s   = (q . k) / sqrt(D)                              (f32)
//     s   = softcap * tanh(s / softcap)          when softcap > 0
//     s   = -inf  unless  kpos < Sk  [and kpos <= qpos]  [and qpos - kpos < window]
//     out = softmax(s) . v,  with qpos = q_offset + row
//
// given out, dout and the forward's per-row log-sum-exp lse (B, H, Sq),
// which flash_attention.cu and flash_attention_wgmma.cu write when asked.
// The FlashAttention-2 recurrence, every product on the tensor cores with
// f32 accumulators:
//
//     Delta = rowsum(dout * out)
//     P     = exp(s - lse)            (exactly 0 where the mask masks)
//     dV    = P^T . dout,             dP = dout . V^T
//     dS    = P * (dP - Delta) * (1 - t^2),  t = tanh(s_raw / softcap)
//     dQ    = scale dS . K,           dK = scale dS^T . Q
//
// with the mask in the forward's order (scale, softcap, mask) and dK, dV
// summed over each group's query heads (GQA).
//
// Replaces no TPU kernel: the reference has no backward kernel. Its ops
// wrapper sends every non-TPU call to ref.attention_ref
// (src/repro/kernels/ref.py:40), and JAX differentiates that plain path.
// This kernel is the port's own, added so that dense and hybrid models
// train on the card; its plain twin is ref.attention_grads in
// src/repro_torch/kernels/ref.py, whose in_pieces / mid_pieces emulate the
// splits below.
//
// What bounds it on an H100: five products of 2 D FLOP per unmasked
// (query, key) pair (S, dP, dV, dQ, dK: 10 D), against q, k, v, out, dout
// and lse read once and dq, dk, dv written once: operations, at the
// gemma2-9b and zamba2-7b training layers. This design forms S and dP in
// both of its large kernels (14 D a pair, no atomics and no dS round trip
// through device memory) and takes each f32 product as several bf16 ones
// (below), so its floor is above that bound (PERF.md has both).
//
// Exactness on bf16 tensor cores. Every product is a bf16 wgmma with an f32
// accumulator.
//   * bf16 inputs: q, k, v and dout are exact bf16 operands, so S and dP
//     take them as they are. P and dS are f32 values; each is split into
//     two bf16 halves, hi = bf16(x) and lo = bf16(x - hi) (ref.split_p(x,
//     2), the forward's rule for P), and dV, dK, dQ are issued lo, then hi.
//   * f32 inputs: every operand is split into three bf16 pieces, p0 =
//     bf16(v), p1 = bf16(v - p0), p2 = bf16(v - p0 - p1), which hold it
//     exactly (split3 in sm90.cuh; q, k, v, dout as staged, P and dS from
//     registers); a product is the sum of the six piece products with
//     a + b <= 2, the smallest first (for_pairs), as csrc/ssd_scan.cu does.
//     In S and dP each piece product has columns of its own (below), summed
//     by the threads, the small ones first, so the tensor cores' truncating
//     sums never add a small term to the large one.
//   * a sum that crosses query tiles, heads or key tiles is never carried
//     in a tensor-core accumulator (PERF.md §6: such a carry truncates):
//     each tile's dV, dK or dQ is a fresh accumulator, 64 columns at a
//     time, added in f32 by the threads to the carried gradient.
// expf is the accurate one (no --use_fast_math); tanh is tanh_f32
// (sm90.cuh), a branch-free form within a few ulp of tanhf; the softcap's
// division is a multiplication by 1 / softcap (one f32 rounding apart), as
// in the forward kernels. There are no atomics and every sum has a fixed
// order, so two launches agree bitwise.
//
// Design: three launches.
//   1. flash_bwd_delta: one warp a (batch, row, head) sums dout * out over D.
//   2. flash_bwd_dkdv: one block per (64 keys, kv head, batch), heaviest
//      (earliest) key tiles first. It walks every query head of its group
//      and every query tile of kBN rows that can see a key of the tile.
//   3. flash_bwd_dq: one block per (64 query rows, head, batch), heaviest
//      (last) tiles first, walking the key tiles of kBN keys its rows see.
// Both large kernels have one shape, two warpgroups (256 threads):
//   * each warpgroup has a role. In dkdv the first forms S^T = K . Q^T
//     (keys x queries), P, and dV += P^T . dO; the second dP^T = V . dO^T,
//     dS, and dK += dS^T . Q. P and dS are taken in registers, since the
//     f32 accumulator's layout is a 16-bit A fragment's, and dO and Q are
//     read MN-major through wgmma's transpose flag. The first hands the
//     second P (1 - t^2) through shared memory (the 64 x kBN values, each
//     thread's at its own places), from which the second forms dS without
//     an exp of its own. In dq the first forms S = Q . K^T and the second
//     dP = dO . V^T. Where the key tile has two k-steps or more (every
//     case but f32 at D = 256) each warpgroup takes the dS of half the
//     tile's keys, the two handing each other the half of S or dP the other
//     needs, and each sums its half of the contraction dQ += dS . K (K
//     MN-major) into a partial dQ of its own; the two partials are added in
//     a fixed order at the end. At f32, D = 256 (16 keys, one k-step) the
//     second hands dP over and the first forms dS and dQ alone. The masks
//     are tested entry by entry only on tiles that a mask or an edge
//     reaches.
//   * the loads: the block's two resident tiles (dkdv: K and V; dq: Q and
//     dO; 64 rows) once, then each item's two streamed tiles (dkdv: Q and
//     dO; dq: K and V; kBN rows), all by TMA into a ring guarded by `full`
//     and `empty` mbarriers, issued by the warpgroup that waits on the
//     other's hand-over (dkdv: the second; dq: the first), which is the one
//     behind: when it is done with an item, the other is too, and the next
//     load goes out without a wait. bf16 keeps the next item in flight
//     through the whole of the current one; f32's single staging slot
//     takes the next item's load once the current one is split. In dkdv
//     the issuing warp's 32 lanes also load the item's lse and Delta with
//     plain loads (TMA cannot: lse's row stride is Sq floats) and arrive
//     on `full` beside lane 0's expect_tx.
//   * registers: no producer warp. A third warpgroup (or even one more
//     warp) puts three warps on one of the SM's four register files and
//     leaves the compiler 168 registers a thread, and the carried gradient
//     alone takes 128 at D = 256 (D / 2 a thread); with two warpgroups it
//     has 255. Each product's first wgmma ignores its accumulator's old
//     value (scale-d 0), so a fresh accumulator is not zeroed and takes
//     the registers the last one freed: zeroed, it took new ones, and D =
//     256 spilled.
// Per dtype:
//   * bf16: the tiles are TMA'd straight into 128-byte swizzled bf16 tiles
//     (32-byte at D = 16), a ring of two stages of kBN = 64 rows; S and dP
//     read both operands from shared memory.
//   * f32: the resident tiles stay f32 (TMA, 128-byte swizzle, 32-column
//     boxes; 64-byte at D = 16), and the A operand of S and dP is split
//     from them into registers a few k-steps at a time. The streamed tiles
//     come as f32 into one staging slot; the two warpgroups split them into
//     bf16 piece tiles (one matrix each) and release the slot, so the next
//     item's load overlaps this item's products. The stream is kBN = 16
//     rows at D = 256 (what 227 KB hold beside the f32 resident tiles) and
//     32 below. In each column block the three pieces' slabs lie one after
//     the other, so that S and dP take A's piece a times B's pieces
//     0..2 - a in one product, stacked along N: three products a k-step,
//     N = 3, 2 and 1 kBN, not six of kBN.
//
// Shared memory (kernels/flash_attention.py mirrors it:
// bwd_shared_memory_bytes): the two resident tiles, the ring, the f32
// piece tiles, two buffers of the 64 x kBN values handed between the
// warpgroups, each stage's lse and Delta, the barriers and up to 1 KB to
// align the tiles to the swizzle's 1024 bytes; 231,488 bytes for bf16 at
// D = 256 and 222,528 for f32, both kernels.
//
// Masking: rows past Sq and keys past Sk come as zeros from TMA and are
// masked; a masked entry gets P = 0 (its exp is never taken), so it adds
// exactly 0 to every gradient, and a row that sees no key (lse = -inf)
// contributes nothing. A block whose tile no row can see writes zeros.
//
// Head dims 96 and 112 run the D = 128 layout with the true head dim DT a
// runtime argument: the TMA maps declare DT as the inner extent, so the
// boxes read columns DT..127 as zeros, which add nothing to q . k or
// dout . v, and only the columns below DT are stored.
//
// Plain C interface, loaded with ctypes. The TMA descriptors are encoded on
// the host with cuTensorMapEncodeTiled, reached through the runtime's
// driver entry point, so the library does not link libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kRows = 64;         // rows of a block's resident tile: wgmma's M
constexpr int kThreads = 256;     // two warpgroups, no producer warp (the note)
constexpr int kDeltaThreads = 256;
constexpr uint32_t kAlign = 1024;  // every tile starts on the swizzle's repeat
// named barriers: values handed between the warpgroups (ready / consumed),
// and both warpgroups at once (the f32 piece tiles, dq's partial sums)
constexpr int kBarReady = 1, kBarFree = 2, kBarBoth = 3;

template <typename T, int L>
struct Cfg {
  static_assert(L == 16 || L == 64 || L == 128 || L == 256,
                "layout head dim 16, 64, 128 or 256");
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kNI = kF32 ? 3 : 1;  // pieces of an input operand
  static constexpr int kNM = kF32 ? 3 : 2;  // pieces of P or dS
  // rows of a streamed tile (the N of S and dP, the contraction of the
  // products after them)
  static constexpr int kBN = kF32 ? (L == 256 ? 16 : 32) : 64;
  static constexpr int kRing = kF32 ? 1 : 2;
  static constexpr int kNC = L < 64 ? L : 64;  // columns of one output product
  static constexpr int kChunks = L / kNC;
  // score entries whose elementwise steps the compiler may interleave:
  // one k-step's eight at D = 256, where the carried gradient takes half
  // the registers
  static constexpr int kGroup = L == 256 ? 8 : kBN / 4;
  // bf16 tiles: column blocks of kE columns, kRB bytes a row
  static constexpr int kE = L < 64 ? L : 64;
  static constexpr int kRB = 2 * kE;
  // f32 tiles (TMA's boxes): column blocks of kFE columns, kFRB bytes a row
  static constexpr int kFE = L < 32 ? L : 32;
  static constexpr int kFRB = 4 * kFE;
  static constexpr int kBoxE = kF32 ? kFE : kE;  // TMA box columns
  static constexpr int kBoxRB = kF32 ? kFRB : kRB;
  static constexpr uint32_t kRes = kRows * L * sizeof(T);        // one resident tile
  static constexpr uint32_t kStream = kBN * L * sizeof(T);       // one streamed tile
  static constexpr uint32_t kSlot = 2 * kStream;  // a stage: the two streamed tiles
  static constexpr uint32_t kPiece = kBN * L * 2;  // one bf16 piece of a streamed tile
  // dq splits its key tile between the warpgroups where it has two k-steps
  static constexpr bool kSplitDq = kBN >= 32;
  static constexpr uint32_t kX = 4 * kRows * kBN;  // one buffer of handed-over values
  static constexpr uint32_t kSlotOff = 2 * kRes;
  static constexpr uint32_t kPieceOff = kSlotOff + kRing * kSlot;
  static constexpr uint32_t kXOff = kPieceOff + (kF32 ? 2 * kNI * kPiece : 0);  // two buffers
  // each stage's lse and Delta (dkdv), then for f32 the copy the warpgroups
  // keep once the staging slot is free
  static constexpr uint32_t kVecOff = kXOff + 2 * kX;
  static constexpr uint32_t kBarOff = kVecOff + (2 * kRing + (kF32 ? 2 : 0)) * 4 * kBN;
  static constexpr uint32_t kBytes = kBarOff + 64 + kAlign;
  static_assert(kBytes <= 232448, "one block's shared memory");
  static_assert(kSlotOff % kAlign == 0 && kPieceOff % kAlign == 0 &&
                    kPiece % kAlign == 0 && kStream % kAlign == 0,
                "tiles 1024-aligned");
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Byte offset of element (r, c) of a bf16 tile of `Rows` rows and L
// columns (column blocks of kE, each Rows rows of kRB bytes, swizzled).
template <int Rows, int L>
__device__ __forceinline__ uint32_t toff(int r, int c) {
  constexpr int E = L < 64 ? L : 64;
  constexpr int RB = 2 * E;
  return (c / E) * (Rows * RB) + swz<RB>(r * RB + (c % E) * 2);
}

// The operand of k-step ks read K-major from a bf16 tile (rows: the M or N
// index, columns: the contraction).
template <int Rows, int L>
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int ks) {
  constexpr int E = L < 64 ? L : 64;
  constexpr int RB = 2 * E;
  return smem_desc(tile + (16 * ks / E) * (Rows * RB) + (16 * ks % E) * 2, 16,
                   8 * RB, layout_code(RB));
}

// The operand of k-step kk read MN-major (the transpose flag) from a bf16
// tile whose rows are the contraction: rows 16kk.., column block cb.
template <int Rows, int L>
__device__ __forceinline__ uint64_t mdesc(uint32_t tile, int cb, int kk) {
  constexpr int E = L < 64 ? L : 64;
  constexpr int RB = 2 * E;
  return smem_desc(tile + cb * (Rows * RB) + kk * 16 * RB, Rows * RB, 8 * RB,
                   layout_code(RB));
}

// Every column box of one tile of `rows` rows (a resident or a streamed
// tile), at (head, row0, b), into `dst`.
template <typename T, int L>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          int rows, int head, int row0, int b,
                                          uint32_t bar) {
  using C = Cfg<T, L>;
#pragma unroll
  for (int c = 0; c < L / C::kBoxE; ++c)
    tma_load(dst + c * rows * C::kBoxRB, map, c * C::kBoxE, head, row0, b, bar);
}

// acc (64 x kBN, f32) = A . B^T over the L columns: A the block's resident
// tile (64 rows; bf16 at smem address `res`, f32 at generic `res_g`), B a
// streamed tile's kBN rows (bf16: the tile at `tile`; f32: its three
// pieces at `tile`, poff's layout), both K-major.
template <typename T, int L>
__device__ __forceinline__ void score_product(float* acc, uint32_t res,
                                              const uint8_t* res_g,
                                              uint32_t tile) {
  using C = Cfg<T, L>;
  constexpr int BN = C::kBN;
  // the first product into each accumulator ignores its old value
  if constexpr (!C::kF32) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < L / 16; ++ks)
      wgmma_ss64(acc, kdesc<kRows, L>(opaque(res), ks),
                 kdesc<BN, L>(opaque(tile), ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BN / 2>(acc);
  } else {
    split_scores<BN, L>(acc, res_g, tile);
  }
}

// The A fragments of a 64 x 16 KS f32 value held in the accumulator's
// layout (v: KS k-steps of its entries), as kNM bf16 pieces (f32: three;
// bf16: the two halves): frag[a][kk] is piece a of k-step kk.
template <typename T, int L, int KS = Cfg<T, L>::kBN / 16>
__device__ __forceinline__ void to_frags(const float* v,
                                         uint32_t (&frag)[Cfg<T, L>::kNM][KS][4]) {
  using C = Cfg<T, L>;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float v0 = v[8 * kk + 2 * q], v1 = v[8 * kk + 2 * q + 1];
      if constexpr (C::kNM == 3)
        split3(v0, v1, frag[0][kk][q], frag[1][kk][q], frag[2][kk][q]);
      else
        split2(v0, v1, frag[0][kk][q], frag[1][kk][q]);
    }
}

// acc (64 x L, carried) += A . B: A the pieces of a 64 x 16 KS value in
// registers, B the 16 KS rows of a streamed tile from k-step kk0 on, read
// MN-major (bf16: the tile; f32: its piece tiles). kNC columns a product
// into a fresh accumulator,
// added to acc in f32; below D = 256 two fresh accumulators in turn, so
// that one product runs while the last one is added (at 256 the carried
// gradient leaves registers for one).
template <typename T, int L, int KS = Cfg<T, L>::kBN / 16>
__device__ __forceinline__ void grad_product(
    float* acc, const uint32_t (&frag)[Cfg<T, L>::kNM][KS][4], uint32_t tile,
    int kk0 = 0) {
  using C = Cfg<T, L>;
  constexpr int BN = C::kBN;
  constexpr int kFresh = L == 256 ? 1 : 2;
  float fresh[kFresh][C::kNC / 2];
  auto issue = [&](int n) {
    float* const f = fresh[n % kFresh];
    wgmma_fence();
    bool first = true;  // the first product ignores f's old value
    for_pairs<C::kNM, C::kNI>([&](int a, int bp) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint64_t desc =
            C::kF32 ? pmdesc<BN, L>(opaque(tile), bp, n, kk0 + kk)
                    : mdesc<BN, L>(opaque(tile), n, kk0 + kk);
        wgmma_rs<C::kNC, 1>(f, frag[a][kk], desc, !first);
        first = false;
      }
    });
    wgmma_commit();
  };
  issue(0);
#pragma unroll
  for (int n = 0; n < C::kChunks; ++n) {
    if (kFresh == 2 && n + 1 < C::kChunks) {
      issue(n + 1);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs<C::kNC / 2>(fresh[n % kFresh]);
#pragma unroll
    for (int r = 0; r < C::kNC / 2; ++r) acc[n * C::kNC / 2 + r] += fresh[n % kFresh][r];
    // the adds done before the next product is issued, so that it can take
    // the same registers
    fence_regs<C::kNC / 2>(acc + n * C::kNC / 2);
    if (kFresh == 1 && n + 1 < C::kChunks) issue(n + 1);
  }
}

// Store a carried 64 x L gradient (times `mul`) to rows row0 + r < S of
// head `head` of a (B, S, NH, DT) tensor; the columns below DT only.
template <typename T, int L>
__device__ __forceinline__ void store_grad(const float* acc, float mul, T* dst,
                                           int b, int S, int NH, int head,
                                           int row0, int DT, int warp,
                                           int lane) {
  using C = Cfg<T, L>;
  const int g = lane / 4, qd = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 16 * warp + g + 8 * i;
    if (row >= S) continue;
    T* o = dst + ((static_cast<size_t>(b) * S + row) * NH + head) * DT;
#pragma unroll
    for (int n = 0; n < C::kChunks; ++n)
#pragma unroll
      for (int j = 0; j < C::kNC / 8; ++j) {
        const int col = n * C::kNC + 8 * j + 2 * qd;
        if (col >= DT) continue;
        const float v0 = acc[n * C::kNC / 2 + 4 * j + 2 * i] * mul;
        const float v1 = acc[n * C::kNC / 2 + 4 * j + 2 * i + 1] * mul;
        if constexpr (C::kF32)
          *reinterpret_cast<float2*>(o + col) = make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(o + col) = pack_bf16(v0, v1);
      }
  }
}

// Delta[b, h, r] = sum_d dout[b, r, h, d] * out[b, r, h, d]: one warp a
// (b, r, h), lanes striding d, a fixed xor tree.
template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta(const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ delta, long long rows, int Sq, int H,
             int DT) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kDeltaThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = out + row * DT;
  const T* g = dout + row * DT;
  float acc = 0.0f;
  for (int d = lane; d < DT; d += 32) acc = fmaf(to_float(o[d]), to_float(g[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const long long br = row / H;
    const int r = static_cast<int>(br % Sq);
    const long long b = br / Sq;
    delta[(b * H + h) * Sq + r] = acc;
  }
}

// Shared-memory addresses of one block's layout.
template <typename T, int L>
struct Smem {
  uint32_t base;   // shared-state space, 1024-aligned
  uint8_t* gbase;  // the same bytes, generic
  __device__ __forceinline__ explicit Smem(uint8_t* raw_ptr) {
    const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(raw_ptr));
    base = (raw + kAlign - 1) & ~(kAlign - 1);
    gbase = raw_ptr + (base - raw);
  }
  using C = Cfg<T, L>;
  __device__ __forceinline__ uint32_t res(int i) const { return base + i * C::kRes; }
  __device__ __forceinline__ uint32_t slot(int s) const { return base + C::kSlotOff + s * C::kSlot; }
  __device__ __forceinline__ uint32_t full(int s) const { return base + C::kBarOff + 8 + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return base + C::kBarOff + 8 + 8 * C::kRing + 8 * s;
  }
  __device__ __forceinline__ uint32_t res_full() const { return base + C::kBarOff; }
  // the streamed tile i (0 or 1) as the products read it: bf16 the slot's
  // tile, f32 its piece tiles
  __device__ __forceinline__ uint32_t stream(int s, int i) const {
    return C::kF32 ? base + C::kPieceOff + i * C::kNI * C::kPiece
                   : slot(s) + i * C::kStream;
  }
  // the item's lse and Delta (kBN floats each)
  // the issuer writes stage s's lse (i = 0) and Delta (i = 1) here ...
  __device__ __forceinline__ float* slot_vec(int s, int i) const {
    return reinterpret_cast<float*>(gbase + C::kVecOff) + (2 * s + i) * C::kBN;
  }
  // ... and the warpgroups read them here (f32: a copy taken with the split)
  __device__ __forceinline__ float* vec(int s, int i) const {
    return C::kF32 ? reinterpret_cast<float*>(gbase + C::kVecOff) +
                         (2 * C::kRing + i) * C::kBN
                   : slot_vec(s, i);
  }
  // buffer b (0 or 1) of the values handed between the warpgroups
  __device__ __forceinline__ float* xbuf(int b) const {
    return reinterpret_cast<float*>(gbase + C::kXOff + b * C::kX);
  }
};

// f32: once both warpgroups are done with the last item's piece
// tiles, split the staging slot's streamed tile `wg` into its pieces (and
// keep the item's lse (wg 0) or Delta (wg 1) where dkdv reads them). On
// return the slot is free for the next item's load.
template <typename T, int L>
__device__ __forceinline__ void take_slot(const Smem<T, L>& sm, int wg, int t,
                                          bool with_vec) {
  using C = Cfg<T, L>;
  bar_sync(kBarBoth, kThreads);
  to_pieces<C::kBN, L>(sm.gbase + C::kSlotOff + wg * C::kStream,
                       sm.gbase + C::kPieceOff + wg * C::kNI * C::kPiece, t);
  if (with_vec && t < C::kBN) sm.vec(0, wg)[t] = sm.slot_vec(0, wg)[t];
  fence_async_smem();
  bar_sync(kBarBoth, kThreads);
}

// dK and dV of one (key tile, kv head, batch).
template <typename T, int L>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv(const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_do,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int B, int H, int KV,
               int Sq, int Sk, int DT, float scale, int causal, int window,
               float softcap, int q_offset) {
  using C = Cfg<T, L>;
  constexpr int BN = C::kBN;
  constexpr int kIssuer = 1;  // the warpgroup that waits on the other's scores
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Smem<T, L> sm(smem_raw);

  // heaviest first: block i takes key tile i / (KV B), the earliest tiles
  // (which the most query rows see under a causal mask) of every head first
  const int kt = blockIdx.x / (KV * B);
  const int kvh = blockIdx.x % KV;
  const int b = (blockIdx.x / KV) % B;
  const int k0 = kt * kRows;
  const int group = H / KV;

  // the query tiles with a row that sees a key of this tile
  const int q_tiles = (Sq + BN - 1) / BN;
  int qt_begin = 0, qt_end = q_tiles;
  if (causal) {
    const long long r = static_cast<long long>(k0) - q_offset;
    if (r > 0) qt_begin = static_cast<int>(r / BN < q_tiles ? r / BN : q_tiles);
  }
  if (window > 0) {
    const long long kmax = min(k0 + kRows, Sk) - 1;
    const long long r = kmax + window - 1 - q_offset;  // last row in reach
    qt_end = r < 0 ? 0 : static_cast<int>(r / BN + 1 < q_tiles ? r / BN + 1 : q_tiles);
  }
  const int n_q = max(0, qt_end - qt_begin);
  const int n_items = group * n_q;

  const int wg = threadIdx.x / 128;  // 0: S^T, P, dV; 1: dP^T, dS, dK
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int qd = lane % 4;
  const int kr0 = 16 * warp + lane / 4;  // the fragment's key rows: kr0, kr0 + 8
  const bool issuer = wg == kIssuer && warp == 0;
  float* const xb = sm.xbuf(0) + t;
  // x * (1 / softcap) is x / softcap within one f32 rounding, without a
  // division per score (as the forward kernels take it)
  const float inv_cap = softcap > 0.0f ? 1.0f / softcap : 0.0f;

  if (threadIdx.x == 0) {
    mbar_init(sm.res_full(), 1);
    for (int s = 0; s < C::kRing; ++s) {
      mbar_init(sm.full(s), 1 + 32);  // lane 0's expect_tx, 32 lanes' lse/Delta
      mbar_init(sm.empty(s), kThreads / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // Item it's query tile (Q, dO) into its slot, with its rows' lse and
  // Delta (plain loads: lse's row stride is Sq floats), by the issuing warp.
  auto load_item = [&](int it) {
    const int h = kvh * group + it / n_q;
    const int q0 = (qt_begin + it % n_q) * BN;
    const int s = it % C::kRing;
    float lv[(BN + 31) / 32], dvv[(BN + 31) / 32];
#pragma unroll
    for (int j = 0; j < (BN + 31) / 32; ++j) {
      const int r = lane + 32 * j;
      const size_t at = (static_cast<size_t>(b) * H + h) * Sq + q0 + r;
      const bool in = r < BN && q0 + r < Sq;
      lv[j] = in ? lse[at] : 0.0f;
      dvv[j] = in ? delta[at] : 0.0f;
    }
    if (lane == 0) {
      mbar_expect_tx(sm.full(s), 2 * C::kStream);
      load_tile<T, L>(sm.slot(s), &tm_q, BN, h, q0, b, sm.full(s));
      load_tile<T, L>(sm.slot(s) + C::kStream, &tm_do, BN, h, q0, b, sm.full(s));
    }
#pragma unroll
    for (int j = 0; j < (BN + 31) / 32; ++j) {
      const int r = lane + 32 * j;
      if (r < BN) {
        sm.slot_vec(s, 0)[r] = lv[j];
        sm.slot_vec(s, 1)[r] = dvv[j];
      }
    }
    mbar_arrive(sm.full(s));  // releases this lane's writes
  };

  if (issuer && n_items > 0) {
    if (lane == 0) {
      mbar_expect_tx(sm.res_full(), 2 * C::kRes);
      load_tile<T, L>(sm.res(0), &tm_k, kRows, kvh, k0, b, sm.res_full());
      load_tile<T, L>(sm.res(1), &tm_v, kRows, kvh, k0, b, sm.res_full());
    }
    for (int it = 0; it < C::kRing && it < n_items; ++it) load_item(it);
  }

  float grad[L / 2];  // wg 0: dV, wg 1: dK (unscaled)
#pragma unroll
  for (int i = 0; i < L / 2; ++i) grad[i] = 0.0f;

  if (n_items > 0) mbar_wait(sm.res_full(), 0);
  for (int it = 0; it < n_items; ++it) {
    const int q0 = (qt_begin + it % n_q) * BN;
    const int s = it % C::kRing;
    mbar_wait(sm.full(s), (it / C::kRing) & 1);  // the item's tiles are in
    if constexpr (C::kF32) {
      take_slot<T, L>(sm, wg, t, true);
      if (issuer && it + 1 < n_items) load_item(it + 1);  // the slot is free
    }
    const float* const lse_v = sm.vec(s, 0);
    const float* const delta_v = sm.vec(s, 1);

    // S^T = K . Q^T (wg 0) or dP^T = V . dO^T (wg 1): keys x queries; entry
    // r is key kr0 + 8 ((r >> 1) & 1), query q0 + 8 (r >> 2) + 2 qd + (r & 1)
    float sc[BN / 2];
    score_product<T, L>(sc, sm.res(wg), sm.gbase + wg * C::kRes,
                        sm.stream(s, wg));
    if (wg == 0) {
      // P, and P (1 - t^2) for wg 1's dS
      const bool masked = tile_masked(q0, BN, k0, kRows, Sq, Sk, q_offset,
                                      causal, window);
      // the lse of this thread's columns, read before the loop: its stores
      // to xb would otherwise order every read after the last entry's store
      float lv[BN / 4];
#pragma unroll
      for (int j = 0; j < BN / 4; ++j) lv[j] = lse_v[8 * (j >> 1) + 2 * qd + (j & 1)];
      if (it > 0) bar_sync(kBarFree, kThreads);  // wg 1 has read the last
      with_flags(softcap > 0.0f, masked, [&](auto cap, auto mask) {
        in_groups<0, BN / 2, (C::kGroup < BN / 2 ? C::kGroup : BN / 2)>(sc, [&](int r) {
          const int qc = 8 * (r >> 2) + 2 * qd + (r & 1);
          float g;
          const float x = capped<decltype(cap)::value>(sc[r], scale, softcap,
                                                        inv_cap, g);
          float p = expf(x - lv[2 * (r >> 2) + (r & 1)]);
          if constexpr (decltype(mask)::value)
            p = seen(q0 + qc, k0 + kr0 + 8 * ((r >> 1) & 1), Sq, Sk, q_offset,
                     causal, window) ? p : 0.0f;
          xb[r * 128] = p * g;
          sc[r] = p;
        });
      });
      bar_arrive(kBarReady, kThreads);  // P's scores are handed over
    } else {
      // dS = P (1 - t^2) (dP - Delta)
      float dl[BN / 4];  // the Delta of this thread's columns
#pragma unroll
      for (int j = 0; j < BN / 4; ++j) dl[j] = delta_v[8 * (j >> 1) + 2 * qd + (j & 1)];
      bar_sync(kBarReady, kThreads);  // wg 0's scores are in
#pragma unroll
      for (int r = 0; r < BN / 2; ++r)
        sc[r] = xb[r * 128] * (sc[r] - dl[2 * (r >> 2) + (r & 1)]);
      if (it + 1 < n_items) bar_arrive(kBarFree, kThreads);
    }
    // dV += P^T . dO (wg 0) or dK += dS^T . Q (wg 1)
    uint32_t frag[C::kNM][BN / 16][4];
    to_frags<T, L>(sc, frag);
    grad_product<T, L>(grad, frag, sm.stream(s, 1 - wg));
    if constexpr (!C::kF32) {
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(s));  // the item's tiles are free
      if (issuer && it + C::kRing < n_items) {
        mbar_wait(sm.empty(s), (it / C::kRing) & 1);  // both warpgroups' too
        load_item(it + C::kRing);
      }
    }
  }

  // dV, and dK = scale dS^T . Q, rounded once; the columns below DT only
  store_grad<T, L>(grad, wg == 0 ? 1.0f : scale, wg == 0 ? dv : dk, b, Sk, KV,
                   kvh, k0, DT, warp, lane);
}

// dQ of one (64 query rows, head, batch).
template <typename T, int L>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_do,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int B, int H, int KV, int Sq, int Sk, int DT,
             float scale, int causal, int window, float softcap,
             int q_offset) {
  using C = Cfg<T, L>;
  constexpr int BN = C::kBN;
  constexpr int kIssuer = 0;  // the warpgroup that waits on the other's dP
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Smem<T, L> sm(smem_raw);

  // heaviest first: block 0 takes the last query tile of every head
  const int q_tiles = (Sq + kRows - 1) / kRows;
  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x / (H * B));
  const int h = blockIdx.x % H;
  const int b = (blockIdx.x / H) % B;
  const int kvh = h / (H / KV);
  const int q0 = qt * kRows;

  // the key tiles (of kBN keys) this block's rows can see
  const int qmin = q_offset + q0;
  const int qmax = q_offset + min(q0 + kRows, Sq) - 1;
  int kt_end = (Sk + BN - 1) / BN;
  if (causal) kt_end = min(kt_end, qmax / BN + 1);
  int kt_begin = 0;
  if (window > 0 && qmin - window + 1 > 0) kt_begin = (qmin - window + 1) / BN;
  const int n_items = max(0, kt_end - kt_begin);

  const int wg = threadIdx.x / 128;  // 0: S, dS, dQ; 1: dP
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int qd = lane % 4;
  const int qr0 = 16 * warp + lane / 4;  // the fragment's query rows: qr0, qr0 + 8
  const bool issuer = wg == kIssuer && warp == 0;
  float* const xb = sm.xbuf(0) + t;
  const float inv_cap = softcap > 0.0f ? 1.0f / softcap : 0.0f;

  if (threadIdx.x == 0) {
    mbar_init(sm.res_full(), 1);
    for (int s = 0; s < C::kRing; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), kThreads / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // Item it's key tile (K, V) into its slot, by lane 0 of the issuing warp.
  auto load_item = [&](int it) {
    const int s = it % C::kRing;
    const int k0 = (kt_begin + it) * BN;
    if (lane == 0) {
      mbar_expect_tx(sm.full(s), 2 * C::kStream);
      load_tile<T, L>(sm.slot(s), &tm_k, BN, kvh, k0, b, sm.full(s));
      load_tile<T, L>(sm.slot(s) + C::kStream, &tm_v, BN, kvh, k0, b, sm.full(s));
    }
    __syncwarp();
  };

  if (issuer && n_items > 0) {
    if (lane == 0) {
      mbar_expect_tx(sm.res_full(), 2 * C::kRes);
      load_tile<T, L>(sm.res(0), &tm_q, kRows, h, q0, b, sm.res_full());
      load_tile<T, L>(sm.res(1), &tm_do, kRows, h, q0, b, sm.res_full());
    }
    for (int it = 0; it < C::kRing && it < n_items; ++it) load_item(it);
  }

  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + qr0 + 8 * i;
    const size_t at = (static_cast<size_t>(b) * H + h) * Sq + row;
    lse_r[i] = row < Sq ? lse[at] : 0.0f;
    delta_r[i] = row < Sq ? delta[at] : 0.0f;
  }

  float grad[L / 2];  // dQ (unscaled): wg 0's, or each warpgroup's partial
#pragma unroll
  for (int i = 0; i < L / 2; ++i) grad[i] = 0.0f;

  if (n_items > 0) mbar_wait(sm.res_full(), 0);
  for (int it = 0; it < n_items; ++it) {
    const int k0 = (kt_begin + it) * BN;
    const int s = it % C::kRing;
    mbar_wait(sm.full(s), (it / C::kRing) & 1);  // the item's tiles are in
    if constexpr (C::kF32) {
      take_slot<T, L>(sm, wg, t, false);
      if (issuer && it + 1 < n_items) load_item(it + 1);  // the slot is free
    }

    // S = Q . K^T (wg 0) or dP = dO . V^T (wg 1): queries x keys; entry r
    // is row qr0 + 8 ((r >> 1) & 1), key k0 + 8 (r >> 2) + 2 qd + (r & 1)
    float sc[BN / 2];
    score_product<T, L>(sc, sm.res(wg), sm.gbase + wg * C::kRes,
                        sm.stream(s, wg));
    const bool masked = tile_masked(q0, kRows, k0, BN, Sq, Sk, q_offset,
                                    causal, window);
    // dS of entries [r0, r1) into sc, from each entry's score s_at(r) and
    // dP dp_at(r)
    auto ds_into = [&](auto r0c, auto r1c, auto s_at, auto dp_at) {
      constexpr int R0 = decltype(r0c)::value, R1 = decltype(r1c)::value;
      with_flags(softcap > 0.0f, masked, [&](auto cap, auto mask) {
        in_groups<R0, R1, (C::kGroup < R1 - R0 ? C::kGroup : R1 - R0)>(sc, [&](int r) {
          const int i = (r >> 1) & 1;
          float g;
          const float x = capped<decltype(cap)::value>(s_at(r), scale, softcap,
                                                        inv_cap, g);
          float p = expf(x - lse_r[i]);
          if constexpr (decltype(mask)::value)
            p = seen(q0 + qr0 + 8 * i, k0 + 8 * (r >> 2) + 2 * qd + (r & 1), Sq,
                     Sk, q_offset, causal, window) ? p : 0.0f;
          sc[r] = p * g * (dp_at(r) - delta_r[i]);
        });
      });
    };
    if constexpr (C::kSplitDq) {
      // each warpgroup takes the dS of half the key tile (wg 0 the first
      // BN / 2 keys, its entries r < BN / 4), and so half the contraction
      // of dQ += dS . K into a partial dQ of its own: each hands the other
      // the half of its S or dP that the other needs (two buffers in turn,
      // so one barrier an item guards them)
      constexpr int Q = BN / 4;
      float* const x = sm.xbuf(it & 1) + t;
      if (wg == 0) {
#pragma unroll
        for (int r = Q; r < 2 * Q; ++r) x[(r - Q) * 128] = sc[r];
      } else {
#pragma unroll
        for (int r = 0; r < Q; ++r) x[(Q + r) * 128] = sc[r];
      }
      bar_sync(kBarReady, kThreads);  // both halves are handed over
      uint32_t frag[C::kNM][BN / 32][4];
      if (wg == 0) {
        ds_into(std::integral_constant<int, 0>{}, std::integral_constant<int, Q>{},
                [&](int r) { return sc[r]; },
                [&](int r) { return x[(Q + r) * 128]; });
        to_frags<T, L, BN / 32>(sc, frag);
      } else {
        ds_into(std::integral_constant<int, Q>{},
                std::integral_constant<int, 2 * Q>{},
                [&](int r) { return x[(r - Q) * 128]; },
                [&](int r) { return sc[r]; });
        to_frags<T, L, BN / 32>(sc + Q, frag);
      }
      // dQ_partial += dS . K over this warpgroup's keys
      grad_product<T, L, BN / 32>(grad, frag, sm.stream(s, 0), wg * BN / 32);
    } else if (wg == 1) {
      if (it > 0) bar_sync(kBarFree, kThreads);  // wg 0 has read the last
#pragma unroll
      for (int r = 0; r < BN / 2; ++r) xb[r * 128] = sc[r];
      bar_arrive(kBarReady, kThreads);  // dP is handed over
    } else {
      bar_sync(kBarReady, kThreads);  // wg 1's dP is in
      ds_into(std::integral_constant<int, 0>{},
              std::integral_constant<int, BN / 2>{}, [&](int r) { return sc[r]; },
              [&](int r) { return xb[r * 128]; });
      if (it + 1 < n_items) bar_arrive(kBarFree, kThreads);
      // dQ += dS . K
      uint32_t frag[C::kNM][BN / 16][4];
      to_frags<T, L>(sc, frag);
      grad_product<T, L>(grad, frag, sm.stream(s, 0));
    }
    if constexpr (!C::kF32) {
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(s));  // the item's tiles are free
      if (issuer && it + C::kRing < n_items) {
        mbar_wait(sm.empty(s), (it / C::kRing) & 1);  // both warpgroups' too
        load_item(it + C::kRing);
      }
    }
  }

  if constexpr (C::kSplitDq) {
    // dQ = the two partials' sum, in a fixed order: wg 1's through shared
    // memory (the stages', free now), added by wg 0
    static_assert(4 * 128 * (L / 2) <= C::kXOff - C::kSlotOff,
                  "the partial dQ fits the stages");
    float* const part = reinterpret_cast<float*>(sm.gbase + C::kSlotOff) + t;
    bar_sync(kBarBoth, kThreads);  // both are done with the stages
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < L / 2; ++j) part[j * 128] = grad[j];
    }
    bar_sync(kBarBoth, kThreads);
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < L / 2; ++j) grad[j] += part[j * 128];
    }
  }

  // dQ = scale dS . K, rounded once; the columns below DT only
  if (wg == 0)
    store_grad<T, L>(grad, scale, dq, b, Sq, H, h, q0, DT, warp, lane);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// The three kernels of layout head dim L on tensors of true head dim DT.
template <typename T, int L, int DT = L>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int H,
                   int KV, int Sq, int Sk, float scale, int causal,
                   int window, float softcap, int q_offset,
                   cudaStream_t stream) {
  using C = Cfg<T, L>;
  static_assert(DT <= L && DT % 8 == 0, "true head dim within the layout");
  const long long rows = static_cast<long long>(B) * Sq * H;
  const long long delta_blocks =
      (rows + kDeltaThreads / 32 - 1) / (kDeltaThreads / 32);
  const long long kv_blocks = static_cast<long long>((Sk + kRows - 1) / kRows) * KV * B;
  const long long q_blocks = static_cast<long long>((Sq + kRows - 1) / kRows) * H * B;
  if (delta_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL ||
      q_blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  flash_bwd_delta<T><<<static_cast<unsigned>(delta_blocks), kDeltaThreads, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, rows,
      Sq, H, DT);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // resident tiles: 64 rows; streamed tiles: kBN rows (encode_heads in
  // sm90.cuh: at DT 96 and 112 TMA reads the columns past DT as zeros)
  CUtensorMap q_res, do_res, k_res, v_res, q_str, do_str, k_str, v_str;
  err = encode_heads(&q_res, q, C::kF32, B, Sq, H, DT, C::kBoxE, kRows);
  if (err == cudaSuccess)
    err = encode_heads(&do_res, dout, C::kF32, B, Sq, H, DT, C::kBoxE, kRows);
  if (err == cudaSuccess)
    err = encode_heads(&k_res, k, C::kF32, B, Sk, KV, DT, C::kBoxE, kRows);
  if (err == cudaSuccess)
    err = encode_heads(&v_res, v, C::kF32, B, Sk, KV, DT, C::kBoxE, kRows);
  if (err == cudaSuccess)
    err = encode_heads(&q_str, q, C::kF32, B, Sq, H, DT, C::kBoxE, C::kBN);
  if (err == cudaSuccess)
    err = encode_heads(&do_str, dout, C::kF32, B, Sq, H, DT, C::kBoxE, C::kBN);
  if (err == cudaSuccess)
    err = encode_heads(&k_str, k, C::kF32, B, Sk, KV, DT, C::kBoxE, C::kBN);
  if (err == cudaSuccess)
    err = encode_heads(&v_str, v, C::kF32, B, Sk, KV, DT, C::kBoxE, C::kBN);
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kBytes));
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv<T, L><<<static_cast<unsigned>(kv_blocks), kThreads, C::kBytes, stream>>>(
      k_res, v_res, q_str, do_str, lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), B, H, KV, Sq, Sk, DT, scale, causal, window,
      softcap, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_bwd_dq<T, L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kBytes));
  if (err != cudaSuccess) return err;
  flash_bwd_dq<T, L><<<static_cast<unsigned>(q_blocks), kThreads, C::kBytes, stream>>>(
      q_res, do_res, k_str, v_str, lse, delta, static_cast<T*>(dq), B, H, KV,
      Sq, Sk, DT, scale, causal, window, softcap, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv, int B,
                       int H, int KV, int Sq, int Sk, int D, float scale,
                       int causal, int window, float softcap, int q_offset,
                       cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    case 64:
      return launch<T, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    case 96:
      return launch<T, 128, 96>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    case 112:
      return launch<T, 128, 112>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    case 128:
      return launch<T, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    case 256:
      return launch<T, 256>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, out, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, KV, D): contiguous,
// all of one dtype (`dtype` 0: float32, 1: bfloat16), q, k, v and dout
// with 16-byte aligned data (TMA reads them), D in {16, 64, 96, 112, 128,
// 256} (96 and 112 on the 128 layout); lse (B, H, Sq) float32 from the
// forward; delta a (B, H, Sq) float32 scratch. Launches three kernels on
// `stream`; returns the first launch error, or the error of encoding a TMA
// descriptor (0 on success). Does not synchronise and allocates nothing.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const void* lse,
                        void* delta, void* dq, void* dk, void* dv, int B,
                        int H, int KV, int Sq, int Sk, int D, int dtype,
                        float scale, int causal, int window, float softcap,
                        int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1 ||
      window < 0 || q_offset < 0) {
    return cudaErrorInvalidValue;
  }
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, out, dout, l, dl, dq, dk, dv, B, H, KV, Sq, Sk, D, scale, causal, window, softcap, q_offset, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, dout, l, dl, dq, dk, dv, B, H, KV, Sq, Sk, D, scale, causal, window, softcap, q_offset, s);
  return cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
