// Hopper (sm_90a) forward flash attention in float32 on the bf16 tensor
// cores: causal and sliding-window masks, grouped-query heads, tanh logit
// softcap and a query position offset,
//
//     s   = (q . k) / sqrt(D)                              (f32)
//     s   = softcap * tanh(s / softcap)          when softcap > 0
//     s   = -inf  unless  kpos < Sk  [and kpos <= qpos]  [and qpos - kpos < window]
//     out = softmax(s) . v,  with qpos = q_offset + row
//
// taken as an online softmax over tiles of kBN keys with f32 running max m,
// sum l and output O; the output is O / max(l, 1e-37). When asked (`lse`
// not null: training), each row's log-sum-exp m + log(max(l, 1e-37)) goes
// to lse (B, H, Sq) f32 for the backward kernel (flash_attention_bwd.cu); a
// row that sees no key gets -inf. Query head h reads kv head h / (H / KV);
// no K/V is repeated.
//
// Replaces the TPU kernel `flash_attention_pallas` in
// src/repro/kernels/flash_attention.py (`_flash_kernel` at line 27,
// pallas_call at line 95) for float32 inputs (bfloat16 takes
// flash_attention_wgmma.cu). What it keeps from that kernel: the online
// softmax with f32 m, l and O held on chip for a whole KV sweep, P kept at
// f32 accuracy for P.V, the mask order (scale, softcap, then mask), and the
// final division by max(l, 1e-37).
//
// What differs, and why:
//   * the TPU grid walks every KV block in order on one core and masks a
//     fully masked block with a finite -1e30, whose exp(0) terms a later
//     block wipes through alpha. Here each block computes the key tiles its
//     query rows can see (causal: up to the last row's position; window:
//     from the first row's position - window + 1) and skips the rest.
//     Masked scores are -inf and the running max is made safe (m == -inf is
//     used as 0 in the exponents), so a masked key adds exactly 0 in any
//     tile: no tile need be non-empty, the skip is exact, and a row that
//     sees no key at all gives 0;
//   * the right-pad mask is against the true Sk, passed in. The wrapper
//     pads nothing (the TPU ops wrapper pads Sk to 128 and passes the
//     padded length, so there the pad mask never masks).
//
// Exactness on bf16 tensor cores. The f32 route's tolerance (2e-5 against
// the plain version) leaves no room for TF32, nor for any operand rounded
// once to bf16. Every f32 operand is split into three bf16 pieces, p0 =
// bf16(v), p1 = bf16(v - p0), p2 = bf16(v - p0 - p1), which hold it exactly
// (split3 in sm90.cuh), and a product is the sum of the six piece products
// with a + b <= 2, the smallest first (for_pairs), as csrc/ssd_scan.cu and
// the backward's f32 route take them:
//   * S = Q . K^T: Q is the A operand, split from its f32 tile into
//     registers a few k-steps at a time; K's three piece tiles are stacked
//     along N, so a k-step is three products of N = 3, 2 and 1 kBN, each
//     piece product in columns of its own, summed by the threads smallest
//     first (split_scores in sm90.cuh), so the tensor cores' truncating sums
//     never add a small term to the large one;
//   * O += P . V: P comes from registers (the f32 accumulator's layout is a
//     16-bit A fragment's) in three pieces; V's three piece tiles are read
//     MN-major through wgmma's transpose flag. Each key tile's P.V goes into
//     a fresh accumulator (its first product ignores the old value, so it
//     needs no zeroing), 64 columns at a time, and the threads add it in
//     f32 to the carried O after the alpha rescale: O is never carried
//     across key tiles in a tensor-core accumulator (such a carry truncates
//     by 3e-5, PERF.md §6).
// The row sums l take the f32 P. expf is the accurate one (no
// --use_fast_math); tanh is tanh_f32 (sm90.cuh), branch-free and within a
// few ulp of tanhf; the softcap's division is a multiplication by
// 1 / softcap, as in the other two flash kernels. There are no atomics and
// every sum has a fixed order, so two launches agree bitwise, and the
// output is the same with and without lse.
//
// What bounds it on an H100: 4 B H D FLOP per unmasked (query, key) pair
// (S and P.V), against Q, K, V and O read or written once: operations, at
// every layer the port runs. As the six piece products of each product at
// 989 TFLOP/s that is 0.406 x the function's time on the CUDA cores at 67
// (PERF.md has both bounds).
//
// Design. One block per (128 query rows, head, batch), heaviest (last)
// query tiles first; two warpgroups (256 threads), each owning 64 rows, and
// no producer warp: at D = 256 the carried O alone takes 128 registers a
// thread, and a third warpgroup or a ninth warp caps ptxas at 168 (the
// backward spilled there). Per key tile of kBN keys:
//   * the loads: the block's Q (f32, two 64-row tiles) once, then each
//     tile's K and V in f32 into one staging slot, all by TMA (128-byte
//     swizzle, 32-column boxes; 64-byte at D = 16) addressing the models'
//     (B, S, NH, D) layout through strides, rows past S zero-filled,
//     guarded by an mbarrier;
//   * once both warpgroups are done with the last tile's pieces, warpgroup
//     0 splits the staged K and warpgroup 1 the staged V into their three
//     bf16 piece tiles; the slot is then free, and thread 0 issues the next
//     tile's loads, which overlap this tile's products;
//   * each warpgroup whose rows see the tile forms S, scales, caps and
//     masks it (entry by entry only on tiles a mask or an edge reaches),
//     runs the online softmax in registers, and adds P.V to its O.
// kBN is 16 keys at D = 256 (what 227 KB hold beside the 128 KB of f32 Q)
// and 32 below, as in the backward.
//
// Shared memory (kernels/flash_attention.py mirrors it:
// shared_memory_bytes(D, "wgmma-f32")): Q 128 x D f32, the staging slot
// (K and V, kBN x D f32 each), K's and V's three piece tiles (kBN x D bf16
// each), the barriers and up to 1 KB to align the tiles to the swizzle's
// 1024 bytes: 214,080 bytes at D = 256.
//
// Head dims 96 and 112 run the D = 128 layout with the true head dim DT a
// run-time argument: the TMA maps declare DT as the inner extent, so the
// boxes read columns DT..127 as zeros, which add nothing to q . k, the
// padded O columns are never stored, and the scale is 1 / sqrt(DT) from
// the host: the result is the unpadded function.
//
// Plain C interface, loaded with ctypes. The TMA descriptors are encoded on
// the host with cuTensorMapEncodeTiled, reached through the runtime's
// driver entry point, so the library does not link libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kRows = 64;          // query rows of a warpgroup: wgmma's M
constexpr int kBQ = 2 * kRows;     // query rows of a block
constexpr int kThreads = 256;      // two warpgroups, no producer warp
constexpr uint32_t kAlign = 1024;  // every tile starts on the swizzle's repeat
constexpr int kBarBoth = 1;        // named barrier: both warpgroups

template <int L>
struct Cfg {
  static_assert(L == 16 || L == 64 || L == 128 || L == 256,
                "layout head dim 16, 64, 128 or 256");
  static constexpr int kBN = L == 256 ? 16 : 32;  // keys of a tile
  static constexpr int kNC = L < 64 ? L : 64;     // columns of one P.V product
  static constexpr int kChunks = L / kNC;
  // f32 tiles (TMA's boxes): column blocks of kFE columns, kFRB bytes a row
  static constexpr int kFE = L < 32 ? L : 32;
  static constexpr int kFRB = 4 * kFE;
  static constexpr uint32_t kQ = kRows * L * 4;       // one warpgroup's Q
  static constexpr uint32_t kStream = kBN * L * 4;    // a staged K or V
  static constexpr uint32_t kPiece = kBN * L * 2;     // one bf16 piece of it
  static constexpr uint32_t kSlotOff = 2 * kQ;
  static constexpr uint32_t kPieceOff = kSlotOff + 2 * kStream;  // K's, V's
  static constexpr uint32_t kBarOff = kPieceOff + 2 * 3 * kPiece;
  static constexpr uint32_t kBytes = kBarOff + 64 + kAlign;
  static_assert(kBytes <= 232448, "one block's shared memory");
  static_assert(kQ % kAlign == 0 && kStream % kAlign == 0 &&
                    kPiece % kAlign == 0,
                "tiles 1024-aligned");
};

// The key tiles [begin, end) of kBN keys that query positions [qmin, qmax]
// can see.
template <int BN>
__device__ __forceinline__ void key_tiles(int qmin, int qmax, int Sk,
                                          int causal, int window, int& begin,
                                          int& end) {
  end = (Sk + BN - 1) / BN;
  if (causal) end = min(end, qmax / BN + 1);
  begin = 0;
  if (window > 0 && qmin - window + 1 > 0) begin = (qmin - window + 1) / BN;
}

// Every column box of one f32 tile of `rows` rows at (head, row0, b).
template <int L>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          int rows, int head, int row0, int b,
                                          uint32_t bar) {
  using C = Cfg<L>;
#pragma unroll
  for (int c = 0; c < L / C::kFE; ++c)
    tma_load(dst + c * rows * C::kFRB, map, c * C::kFE, head, row0, b, bar);
}

// O (64 x L, carried) = alpha O + P . V: P's three pieces in registers
// (`frag`, the kBN keys' k-steps), V's three piece tiles at `vp` read
// MN-major. kNC columns a product into a fresh accumulator, added to O in
// f32 by the threads; below D = 256 two fresh accumulators in turn, so
// that one product runs while the last one is added (at 256 the carried O
// leaves registers for one).
template <int L>
__device__ __forceinline__ void pv_product(
    float* o, const uint32_t (&frag)[3][Cfg<L>::kBN / 16][4], uint32_t vp,
    const float (&alpha)[2]) {
  using C = Cfg<L>;
  constexpr int BN = C::kBN;
  constexpr int kFresh = L == 256 ? 1 : 2;
  float fresh[kFresh][C::kNC / 2];
  auto issue = [&](int n) {
    float* const f = fresh[n % kFresh];
    wgmma_fence();
    bool first = true;  // the first product ignores f's old value
    for_pairs<3, 3>([&](int a, int bp) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wgmma_rs<C::kNC, 1>(f, frag[a][kk], pmdesc<BN, L>(opaque(vp), bp, n, kk),
                            !first);
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
    float* const f = fresh[n % kFresh];
    fence_regs<C::kNC / 2>(f);
    // entry r is row 8 ((r >> 1) & 1) of the thread's pair
#pragma unroll
    for (int r = 0; r < C::kNC / 2; ++r) {
      float& x = o[n * C::kNC / 2 + r];
      x = fmaf(x, alpha[(r >> 1) & 1], f[r]);
    }
    // the adds done before the next product is issued, so that it can take
    // the same registers
    fence_regs<C::kNC / 2>(o + n * C::kNC / 2);
    if (kFresh == 1 && n + 1 < C::kChunks) issue(n + 1);
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_f32(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              float* __restrict__ out, float* __restrict__ lse, int B, int H,
              int KV, int Sq, int Sk, int DT, float scale, int causal,
              int window, float softcap, int q_offset) {
  using C = Cfg<L>;
  constexpr int BN = C::kBN;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + kAlign - 1) & ~(kAlign - 1);
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t slot = base + C::kSlotOff;
  const uint32_t k_pieces = base + C::kPieceOff;
  const uint32_t v_pieces = k_pieces + 3 * C::kPiece;
  const uint32_t q_full = base + C::kBarOff;
  const uint32_t full = q_full + 8;

  // heaviest first: block 0 takes the last query tile of every head
  const int q_tiles = (Sq + kBQ - 1) / kBQ;
  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x / (H * B));
  const int h = blockIdx.x % H;
  const int b = (blockIdx.x / H) % B;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;

  int kt_begin, kt_end;
  key_tiles<BN>(q_offset + q0, q_offset + min(q0 + kBQ, Sq) - 1, Sk, causal,
                window, kt_begin, kt_end);
  const int n_items = max(0, kt_end - kt_begin);

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int qd = lane % 4;
  const int qr0 = 16 * warp + lane / 4;  // the fragment's rows: qr0, qr0 + 8
  const int row0 = q0 + kRows * wg;      // this warpgroup's first row
  const bool active = row0 < Sq;
  int w_begin = 0, w_end = 0;  // the key tiles this warpgroup's rows see
  if (active)
    key_tiles<BN>(q_offset + row0, q_offset + min(row0 + kRows, Sq) - 1, Sk,
                  causal, window, w_begin, w_end);
  const bool issuer = threadIdx.x == 0;
  // x * (1 / softcap) is x / softcap within one f32 rounding, without a
  // division per score
  const float inv_cap = softcap > 0.0f ? 1.0f / softcap : 0.0f;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(full, 1);
    fence_mbar_init();
  }
  __syncthreads();

  // Item it's key tile (K, V) into the staging slot.
  auto load_item = [&](int it) {
    const int k0 = (kt_begin + it) * BN;
    mbar_expect_tx(full, 2 * C::kStream);
    load_tile<L>(slot, &tm_k, BN, kvh, k0, b, full);
    load_tile<L>(slot + C::kStream, &tm_v, BN, kvh, k0, b, full);
  };
  if (issuer && n_items > 0) {
    mbar_expect_tx(q_full, 2 * C::kQ);
    load_tile<L>(base, &tm_q, kRows, h, q0, b, q_full);
    load_tile<L>(base + C::kQ, &tm_q, kRows, h, q0 + kRows, b, q_full);
    load_item(0);
  }

  float o[L / 2];  // O: entry n kNC/2 + r of chunk n, the accumulator's layout
#pragma unroll
  for (int i = 0; i < L / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};

  if (n_items > 0) mbar_wait(q_full, 0);
  for (int it = 0; it < n_items; ++it) {
    const int kt = kt_begin + it;
    const int k0 = kt * BN;
    mbar_wait(full, it & 1);  // the tile's K and V are in
    // once both warpgroups are done with the last tile's pieces, K (wg 0) or
    // V (wg 1) into its pieces; then the slot is free for the next tile
    bar_sync(kBarBoth, kThreads);
    to_pieces<BN, L>(gbase + C::kSlotOff + wg * C::kStream,
                     gbase + C::kPieceOff + wg * 3 * C::kPiece, t);
    fence_async_smem();
    bar_sync(kBarBoth, kThreads);
    if (issuer && it + 1 < n_items) load_item(it + 1);
    if (kt < w_begin || kt >= w_end) continue;  // masked for all its rows

    // S = Q . K^T: entry r is row qr0 + 8 ((r >> 1) & 1), key
    // k0 + 8 (r >> 2) + 2 qd + (r & 1)
    float sc[BN / 2];
    split_scores<BN, L>(sc, gbase + wg * C::kQ, k_pieces);
    const bool masked = tile_masked(row0, kRows, k0, BN, Sq, Sk, q_offset,
                                    causal, window);
    float mx[2] = {-INFINITY, -INFINITY};
    with_flags(softcap > 0.0f, masked, [&](auto cap, auto mask) {
#pragma unroll
      for (int r = 0; r < BN / 2; ++r) {
        const int i = (r >> 1) & 1;
        float g;
        float x = capped<decltype(cap)::value>(sc[r], scale, softcap, inv_cap,
                                               g);
        if constexpr (decltype(mask)::value)
          x = seen(row0 + qr0 + 8 * i, k0 + 8 * (r >> 2) + 2 * qd + (r & 1),
                   Sq, Sk, q_offset, causal, window) ? x : -INFINITY;
        sc[r] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    });
    // the online softmax: the rows' max over their 4 lanes, then P and l
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
    // P's three pieces as the A fragments of its k-steps
    uint32_t frag[3][BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 8 * kk + 2 * q;
        const int i = q & 1;
        const float p0 = expf(sc[r] - m_use[i]);
        const float p1 = expf(sc[r + 1] - m_use[i]);
        sum[i] += p0;
        sum[i] += p1;
        split3(p0, p1, frag[0][kk][q], frag[1][kk][q], frag[2][kk][q]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
    pv_product<L>(o, frag, v_pieces, alpha);
  }

  // out = O / max(l, 1e-37); the columns below DT only
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + qr0 + 8 * i;
    if (!active || row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-37f);
    // m and l are the same in the 4 lanes (qd) of a row
    if (lse != nullptr && qd == 0)
      lse[(static_cast<size_t>(b) * H + h) * Sq + row] = m[i] + logf(denom);
    float* const dst = out + ((static_cast<size_t>(b) * Sq + row) * H + h) * DT;
#pragma unroll
    for (int n = 0; n < C::kChunks; ++n)
#pragma unroll
      for (int j = 0; j < C::kNC / 8; ++j) {
        const int col = n * C::kNC + 8 * j + 2 * qd;
        if (col >= DT) continue;
        const float* const x = o + n * C::kNC / 2 + 4 * j + 2 * i;
        *reinterpret_cast<float2*>(dst + col) =
            make_float2(x[0] / denom, x[1] / denom);
      }
  }
}

// The kernel of layout head dim L on tensors of true head dim DT <= L.
template <int L, int DT = L>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int H, int KV, int Sq, int Sk,
                   float scale, int causal, int window, float softcap,
                   int q_offset, cudaStream_t stream) {
  using C = Cfg<L>;
  static_assert(DT <= L && DT % 8 == 0, "true head dim within the layout");
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = encode_heads(&tm_q, q, true, B, Sq, H, DT, C::kFE, kRows);
  if (err == cudaSuccess)
    err = encode_heads(&tm_k, k, true, B, Sk, KV, DT, C::kFE, C::kBN);
  if (err == cudaSuccess)
    err = encode_heads(&tm_v, v, true, B, Sk, KV, DT, C::kFE, C::kBN);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_f32<L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kBytes));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>((Sq + kBQ - 1) / kBQ) * H * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_fwd_f32<L><<<static_cast<unsigned>(blocks), kThreads, C::kBytes,
                     stream>>>(tm_q, tm_k, tm_v, static_cast<float*>(out), lse,
                               B, H, KV, Sq, Sk, DT, scale, causal, window,
                               softcap, q_offset);
  return cudaGetLastError();
}

cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out,
                       float* lse, int B, int H, int KV, int Sq, int Sk, int D,
                       float scale, int causal, int window, float softcap,
                       int q_offset, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<16>(q, k, v, out, lse, B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    case 64:
      return launch<64>(q, k, v, out, lse, B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    case 96:
      return launch<128, 96>(q, k, v, out, lse, B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    case 112:
      return launch<128, 112>(q, k, v, out, lse, B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    case 128:
      return launch<128>(q, k, v, out, lse, B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    case 256:
      return launch<256>(q, k, v, out, lse, B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k and v (B, Sk, KV, D), out (B, Sq, H, D), all
// contiguous float32 with 16-byte aligned data (TMA reads q, k and v;
// bfloat16 takes flash_attention_wgmma.cu), D in {16, 64, 96, 112, 128,
// 256} (96 and 112 on the 128 layout); lse (B, H, Sq) float32, or null when
// no backward follows. Launches on `stream`; returns cudaGetLastError() of
// the launch (0 on success), or the error of encoding a TMA descriptor.
// Does not synchronise and allocates nothing.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, void* lse, int B, int H, int KV, int Sq,
                        int Sk, int D, float scale, int causal, int window,
                        float softcap, int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1 ||
      window < 0 || q_offset < 0) {
    return cudaErrorInvalidValue;
  }
  return dispatch_d(q, k, v, out, static_cast<float*>(lse), B, H, KV, Sq, Sk, D, scale, causal, window, softcap, q_offset, s);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
