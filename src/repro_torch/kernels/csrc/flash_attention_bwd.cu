// Hopper (sm_90a) backward of flash attention, float32 and bfloat16 inputs,
// on the CUDA cores: the gradients dq, dk, dv of
//
//     s   = (q . k) / sqrt(D)                              (f32)
//     s   = softcap * tanh(s / softcap)          when softcap > 0
//     s   = -inf  unless  kpos < Sk  [and kpos <= qpos]  [and qpos - kpos < window]
//     out = softmax(s) . v,  with qpos = q_offset + row
//
// given out, dout and the forward's per-row log-sum-exp lse (B, H, Sq),
// which flash_attention.cu and flash_attention_wgmma.cu write when asked.
// The FlashAttention-2 recurrence, all in f32:
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
// src/repro_torch/kernels/ref.py.
//
// What bounds it on an H100: five products of 2 D FLOP per unmasked
// (query, key) pair (S, dP, dV, dQ, dK: 10 D), against q, k, v, out, dout
// and lse read once and dq, dk, dv written once. On the CUDA cores the f32
// rate (67 TFLOP/s) is the limit; this design recomputes S and dP in both
// of its large kernels (14 D a pair) and reads every operand from shared
// memory, so it lands well above that bound. Simple and right first.
//
// Design: three launches, no atomics, every sum in a fixed order, so two
// launches give bitwise the same gradients.
//   1. flash_bwd_delta: one warp a (batch, row, head) sums dout * out over D.
//   2. flash_bwd_dkdv: one block per (key tile, kv head, batch). K and V of the tile
//      stay in shared memory; the block walks every query head of its
//      group and every query tile that can see a key of the tile, stages
//      that tile's Q and dO, forms S^T and dP^T (keys x queries), P and dS,
//      and accumulates dV += P^T . dO and dK += dS^T . Q in f32 registers.
//      dK and dV are written once, scaled and rounded there.
//   3. flash_bwd_dq: one block per (query tile, head, batch), heaviest tiles first;
//      Q and dO stay in shared memory, the block walks the key tiles its
//      rows can see (the forward's range), forms S, dP and dS again, and
//      accumulates dQ += dS . K in f32 registers.
// 256 threads as 16 x 16 in every large kernel: in dkdv thread (ty, tx)
// owns keys ty*RK + i of the score tile and queries tx + 16 j, then the
// same keys' rows of dK and dV at D/16 columns; in dq it owns query rows
// 4 ty + i, keys tx + 16 j, and then those rows of dQ.
//
// Shared memory (f32 tiles, rows padded by 4 floats): a query tile is 64
// rows and a key tile 64 rows, 32 at D = 256, where dkdv holds K, V (32 x
// 260), Q, dO (64 x 260), P^T, dS^T (32 x 68) and lse, Delta: 217,600
// bytes; dq holds Q, dO (64 x 260), K, V (32 x 260) and dS (64 x 36):
// 208,896 bytes, both under the 232,448 a block may use
// (kernels/flash_attention.py mirrors this: bwd_shared_memory_bytes).
//
// Masking: rows past Sq and keys past Sk take the zero fill of the staging
// and are masked; a masked entry gets P = 0 (its exp is never taken), so it
// adds exactly 0 to every gradient, and a row that sees no key (lse =
// -inf) contributes nothing. bf16 inputs are widened to f32 when staged and
// the gradients rounded once to bf16 at the store.
//
// Head dims 96 and 112 run the D = 128 layout with the true head dim DT a
// second template parameter, as the forward kernels do: columns DT..127 of
// every staged tile are zero, so they add nothing to q . k or dout . v,
// and only the columns below DT are stored.
//
// Built without --use_fast_math: expf and tanhf stay the accurate ones.
// Plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // floats of row padding (keeps float4 aligned)
constexpr int kBQ = 64;        // query rows of a tile

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
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

template <int D>
struct Layout {
  static constexpr int kBK = D == 256 ? 32 : 64;  // keys of a tile
  static constexpr int kRS = D + kPad;            // row stride of a D-wide tile
  static constexpr int kTS = kBQ + kPad;          // row stride of P^T, dS^T
  static constexpr int kSS = kBK + kPad;          // row stride of dq's dS
  static constexpr int kVec = D >= 64 ? 4 : 1;    // output columns as float4
  static constexpr int kDC = D / 16;              // output columns a thread
  static constexpr size_t kDkdvBytes =
      sizeof(float) * (2 * static_cast<size_t>(kBK) * kRS +
                       2 * static_cast<size_t>(kBQ) * kRS +
                       2 * static_cast<size_t>(kBK) * kTS + 2 * kBQ);
  static constexpr size_t kDqBytes =
      sizeof(float) * (2 * static_cast<size_t>(kBQ) * kRS +
                       2 * static_cast<size_t>(kBK) * kRS +
                       static_cast<size_t>(kBQ) * kSS);
  // output column of a thread's e-th element
  static __device__ __forceinline__ int col(int tx, int e) {
    return kVec == 4 ? (e / 4) * 64 + tx * 4 + (e % 4) : tx + 16 * e;
  }
};

// Stage rows [row0, row0 + ROWS) of one head of a (B, S, NH, DT) tensor as
// f32 at `dst` (row stride `stride`) in the layout of head dim D >= DT,
// zero-filling rows at or past S and columns at or past DT.
template <typename T, int ROWS, int D, int DT>
__device__ __forceinline__ void stage_tile(float* dst, int stride,
                                           const T* __restrict__ src, int b,
                                           int S, int NH, int head, int row0) {
#pragma unroll 4
  for (int idx = threadIdx.x; idx < ROWS * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    const int row = row0 + r;
    float x = 0.0f;
    if (row < S && (DT == D || d < DT)) {
      x = to_float(src[((static_cast<size_t>(b) * S + row) * NH + head) * DT + d]);
    }
    dst[r * stride + d] = x;
  }
}

// Whether the query at row `qrow` (position q_offset + qrow) sees key kpos:
// the forward's mask, and rows past Sq see nothing.
__device__ __forceinline__ bool seen(int qrow, int kpos, int Sq, int Sk,
                                     int q_offset, int causal, int window) {
  const int qpos = q_offset + qrow;
  bool keep = qrow < Sq && kpos < Sk;
  if (causal) keep = keep && kpos <= qpos;
  if (window > 0) keep = keep && (qpos - kpos < window);
  return keep;
}

// P and dS of one score: x = s * scale, capped; P = exp(x - lse) where the
// key is seen, else 0; dS = P (dP - Delta), times the cap's derivative.
__device__ __forceinline__ void p_and_ds(float s, float dp, float lse,
                                         float delta, bool keep, float scale,
                                         float softcap, float& p, float& ds) {
  float x = s * scale;
  float t = 0.0f;
  if (softcap > 0.0f) {
    t = tanhf(x / softcap);
    x = softcap * t;
  }
  p = keep ? expf(x - lse) : 0.0f;
  ds = p * (dp - delta);
  if (softcap > 0.0f) ds *= 1.0f - t * t;
}

// Delta[b, h, r] = sum_d dout[b, r, h, d] * out[b, r, h, d]: one warp a
// (b, r, h), lanes striding d, a fixed xor tree.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta(const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ delta, long long rows, int Sq, int H,
             int DT) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
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

template <typename T, int D, int DT>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int H, int KV, int Sq,
            int Sk, float scale, int causal, int window, float softcap,
            int q_offset) {
  using Lay = Layout<D>;
  static_assert(DT <= D, "true head dim within the layout");
  constexpr int BK = Lay::kBK;
  constexpr int RK = BK / 16;  // keys a thread owns
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // BK x kRS
  float* v_s = k_s + BK * Lay::kRS;              // BK x kRS
  float* q_s = v_s + BK * Lay::kRS;              // kBQ x kRS
  float* do_s = q_s + kBQ * Lay::kRS;            // kBQ x kRS
  float* p_s = do_s + kBQ * Lay::kRS;            // BK x kTS: P^T
  float* ds_s = p_s + BK * Lay::kTS;             // BK x kTS: dS^T
  float* lse_s = ds_s + BK * Lay::kTS;           // kBQ
  float* delta_s = lse_s + kBQ;                  // kBQ

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / KV;

  // the query tiles with a row that sees a key of this tile
  const int q_tiles = (Sq + kBQ - 1) / kBQ;
  int qt_begin = 0, qt_end = q_tiles;
  if (causal) {
    const long long r = static_cast<long long>(k0) - q_offset;
    if (r > 0) qt_begin = static_cast<int>(r / kBQ < q_tiles ? r / kBQ : q_tiles);
  }
  if (window > 0) {
    const long long kmax = min(k0 + BK, Sk) - 1;
    const long long r = kmax + window - 1 - q_offset;  // last row in reach
    qt_end = r < 0 ? 0 : static_cast<int>(r / kBQ + 1 < q_tiles ? r / kBQ + 1 : q_tiles);
  }

  stage_tile<T, BK, D, DT>(k_s, Lay::kRS, k, b, Sk, KV, kvh, k0);
  stage_tile<T, BK, D, DT>(v_s, Lay::kRS, v, b, Sk, KV, kvh, k0);

  float dk_acc[RK][Lay::kDC], dv_acc[RK][Lay::kDC];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int e = 0; e < Lay::kDC; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.0f;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous tile's readers are done
      stage_tile<T, kBQ, D, DT>(q_s, Lay::kRS, q, b, Sq, H, h, q0);
      stage_tile<T, kBQ, D, DT>(do_s, Lay::kRS, dout, b, Sq, H, h, q0);
      if (tid < kBQ) {
        const int row = q0 + tid;
        const size_t at = (static_cast<size_t>(b) * H + h) * Sq + row;
        lse_s[tid] = row < Sq ? lse[at] : 0.0f;
        delta_s[tid] = row < Sq ? delta[at] : 0.0f;
      }
      __syncthreads();

      // s[i][j] = k[ty RK + i] . q[tx + 16 j], dp[i][j] = v[ty RK + i] . do[tx + 16 j]
      float s[RK][4], dp[RK][4];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 a[RK], c[4];
#pragma unroll
        for (int i = 0; i < RK; ++i)
          a[i] = *reinterpret_cast<const float4*>(&k_s[(ty * RK + i) * Lay::kRS + d]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          c[j] = *reinterpret_cast<const float4*>(&q_s[(tx + 16 * j) * Lay::kRS + d]);
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float x = s[i][j];
            x = fmaf(a[i].x, c[j].x, x);
            x = fmaf(a[i].y, c[j].y, x);
            x = fmaf(a[i].z, c[j].z, x);
            x = fmaf(a[i].w, c[j].w, x);
            s[i][j] = x;
          }
      }
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 a[RK], c[4];
#pragma unroll
        for (int i = 0; i < RK; ++i)
          a[i] = *reinterpret_cast<const float4*>(&v_s[(ty * RK + i) * Lay::kRS + d]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          c[j] = *reinterpret_cast<const float4*>(&do_s[(tx + 16 * j) * Lay::kRS + d]);
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float x = dp[i][j];
            x = fmaf(a[i].x, c[j].x, x);
            x = fmaf(a[i].y, c[j].y, x);
            x = fmaf(a[i].z, c[j].z, x);
            x = fmaf(a[i].w, c[j].w, x);
            dp[i][j] = x;
          }
      }

#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int kr = ty * RK + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = tx + 16 * j;
          float p, ds;
          p_and_ds(s[i][j], dp[i][j], lse_s[qc], delta_s[qc],
                   seen(q0 + qc, k0 + kr, Sq, Sk, q_offset, causal, window),
                   scale, softcap, p, ds);
          p_s[kr * Lay::kTS + qc] = p;
          ds_s[kr * Lay::kTS + qc] = ds;
        }
      }
      __syncthreads();

      // dv[i][:] += P^T[key i][:] . dO,  dk[i][:] += dS^T[key i][:] . Q
#pragma unroll 2
      for (int kk = 0; kk < kBQ; kk += 4) {
        float4 pr[RK], dr[RK];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pr[i] = *reinterpret_cast<const float4*>(&p_s[(ty * RK + i) * Lay::kTS + kk]);
          dr[i] = *reinterpret_cast<const float4*>(&ds_s[(ty * RK + i) * Lay::kTS + kk]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* orow = do_s + (kk + u) * Lay::kRS;
          const float* qrow = q_s + (kk + u) * Lay::kRS;
          float ov[Lay::kDC], qv[Lay::kDC];
          if (Lay::kVec == 4) {
#pragma unroll
            for (int c = 0; c < Lay::kDC / 4; ++c) {
              const float4 to = *reinterpret_cast<const float4*>(&orow[c * 64 + tx * 4]);
              const float4 tq = *reinterpret_cast<const float4*>(&qrow[c * 64 + tx * 4]);
              ov[4 * c + 0] = to.x; ov[4 * c + 1] = to.y;
              ov[4 * c + 2] = to.z; ov[4 * c + 3] = to.w;
              qv[4 * c + 0] = tq.x; qv[4 * c + 1] = tq.y;
              qv[4 * c + 2] = tq.z; qv[4 * c + 3] = tq.w;
            }
          } else {
#pragma unroll
            for (int e = 0; e < Lay::kDC; ++e) {
              ov[e] = orow[Lay::col(tx, e)];
              qv[e] = qrow[Lay::col(tx, e)];
            }
          }
#pragma unroll
          for (int i = 0; i < RK; ++i) {
            const float p = component(pr[i], u);
            const float ds = component(dr[i], u);
#pragma unroll
            for (int e = 0; e < Lay::kDC; ++e) {
              dv_acc[i][e] = fmaf(p, ov[e], dv_acc[i][e]);
              dk_acc[i][e] = fmaf(ds, qv[e], dk_acc[i][e]);
            }
          }
        }
      }
    }
  }

  // dK = scale dS^T . Q and dV, rounded once; the columns below DT only
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kpos = k0 + ty * RK + i;
    if (kpos >= Sk) continue;
    const size_t at = ((static_cast<size_t>(b) * Sk + kpos) * KV + kvh) * DT;
#pragma unroll
    for (int e = 0; e < Lay::kDC; ++e) {
      const int c = Lay::col(tx, e);
      if (DT == D || c < DT) {
        dk[at + c] = from_float<T>(dk_acc[i][e] * scale);
        dv[at + c] = from_float<T>(dv_acc[i][e]);
      }
    }
  }
}

template <typename T, int D, int DT>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int H, int KV, int Sq, int Sk, float scale,
          int causal, int window, float softcap, int q_offset) {
  using Lay = Layout<D>;
  static_assert(DT <= D, "true head dim within the layout");
  constexpr int BK = Lay::kBK;
  constexpr int CK = BK / 16;  // keys a thread owns in the score tile
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // kBQ x kRS
  float* do_s = q_s + kBQ * Lay::kRS;            // kBQ x kRS
  float* k_s = do_s + kBQ * Lay::kRS;            // BK x kRS
  float* v_s = k_s + BK * Lay::kRS;              // BK x kRS
  float* ds_s = v_s + BK * Lay::kRS;             // kBQ x kSS

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  // heaviest first: under the causal mask the last query tiles see the most
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;

  // the key tiles this block's rows can see (the forward's range)
  const int qmin = q_offset + q0;
  const int qmax = q_offset + min(q0 + kBQ, Sq) - 1;
  int kt_end = (Sk + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, qmax / BK + 1);
  int kt_begin = 0;
  if (window > 0 && qmin - window + 1 > 0) kt_begin = (qmin - window + 1) / BK;

  stage_tile<T, kBQ, D, DT>(q_s, Lay::kRS, q, b, Sq, H, h, q0);
  stage_tile<T, kBQ, D, DT>(do_s, Lay::kRS, dout, b, Sq, H, h, q0);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    const size_t at = (static_cast<size_t>(b) * H + h) * Sq + row;
    lse_r[i] = row < Sq ? lse[at] : 0.0f;
    delta_r[i] = row < Sq ? delta[at] : 0.0f;
  }

  float acc[4][Lay::kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < Lay::kDC; ++e) acc[i][e] = 0.0f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers of k_s, v_s, ds_s are done
    stage_tile<T, BK, D, DT>(k_s, Lay::kRS, k, b, Sk, KV, kvh, k0);
    stage_tile<T, BK, D, DT>(v_s, Lay::kRS, v, b, Sk, KV, kvh, k0);
    __syncthreads();

    // s[i][j] = q[4 ty + i] . k[tx + 16 j], dp[i][j] = do[4 ty + i] . v[tx + 16 j]
    float s[4][CK], dp[4][CK];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], c[CK];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&q_s[(4 * ty + i) * Lay::kRS + d]);
#pragma unroll
      for (int j = 0; j < CK; ++j)
        c[j] = *reinterpret_cast<const float4*>(&k_s[(tx + 16 * j) * Lay::kRS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          float x = s[i][j];
          x = fmaf(a[i].x, c[j].x, x);
          x = fmaf(a[i].y, c[j].y, x);
          x = fmaf(a[i].z, c[j].z, x);
          x = fmaf(a[i].w, c[j].w, x);
          s[i][j] = x;
        }
    }
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], c[CK];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&do_s[(4 * ty + i) * Lay::kRS + d]);
#pragma unroll
      for (int j = 0; j < CK; ++j)
        c[j] = *reinterpret_cast<const float4*>(&v_s[(tx + 16 * j) * Lay::kRS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          float x = dp[i][j];
          x = fmaf(a[i].x, c[j].x, x);
          x = fmaf(a[i].y, c[j].y, x);
          x = fmaf(a[i].z, c[j].z, x);
          x = fmaf(a[i].w, c[j].w, x);
          dp[i][j] = x;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kc = tx + 16 * j;
        float p, ds;
        p_and_ds(s[i][j], dp[i][j], lse_r[i], delta_r[i],
                 seen(q0 + qr, k0 + kc, Sq, Sk, q_offset, causal, window),
                 scale, softcap, p, ds);
        ds_s[qr * Lay::kSS + kc] = ds;
      }
    }
    __syncthreads();

    // acc[i][:] += dS[4 ty + i][:] . K
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dr[i] = *reinterpret_cast<const float4*>(&ds_s[(4 * ty + i) * Lay::kSS + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* krow = k_s + (kk + u) * Lay::kRS;
        float kv[Lay::kDC];
        if (Lay::kVec == 4) {
#pragma unroll
          for (int c = 0; c < Lay::kDC / 4; ++c) {
            const float4 t = *reinterpret_cast<const float4*>(&krow[c * 64 + tx * 4]);
            kv[4 * c + 0] = t.x;
            kv[4 * c + 1] = t.y;
            kv[4 * c + 2] = t.z;
            kv[4 * c + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < Lay::kDC; ++e) kv[e] = krow[Lay::col(tx, e)];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ds = component(dr[i], u);
#pragma unroll
          for (int e = 0; e < Lay::kDC; ++e) acc[i][e] = fmaf(ds, kv[e], acc[i][e]);
        }
      }
    }
  }

  // dQ = scale dS . K, rounded once; the columns below DT only
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Sq) continue;
    T* o = dq + ((static_cast<size_t>(b) * Sq + row) * H + h) * DT;
#pragma unroll
    for (int e = 0; e < Lay::kDC; ++e) {
      const int c = Lay::col(tx, e);
      if (DT == D || c < DT) o[c] = from_float<T>(acc[i][e] * scale);
    }
  }
}

// The three kernels of layout head dim D on tensors of true head dim DT.
template <typename T, int D, int DT = D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int H,
                   int KV, int Sq, int Sk, float scale, int causal,
                   int window, float softcap, int q_offset,
                   cudaStream_t stream) {
  using Lay = Layout<D>;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(B) * Sq * H;
  const long long delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (delta_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_bwd_delta<T><<<static_cast<unsigned>(delta_blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(out), tdo, delta, rows, Sq, H, DT);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, D, DT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Lay::kDkdvBytes));
  if (err != cudaSuccess) return err;
  const dim3 kv_grid((Sk + Lay::kBK - 1) / Lay::kBK, KV, B);
  flash_bwd_dkdv<T, D, DT><<<kv_grid, kThreads, Lay::kDkdvBytes, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      H, KV, Sq, Sk, scale, causal, window, softcap, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_bwd_dq<T, D, DT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Lay::kDqBytes));
  if (err != cudaSuccess) return err;
  const dim3 q_grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_bwd_dq<T, D, DT><<<q_grid, kThreads, Lay::kDqBytes, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), H, KV, Sq, Sk, scale,
      causal, window, softcap, q_offset);
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
// all of one dtype (`dtype` 0: float32, 1: bfloat16), D in {16, 64, 96,
// 112, 128, 256} (96 and 112 on the 128 layout); lse (B, H, Sq) float32
// from the forward; delta a (B, H, Sq) float32 scratch. Launches three
// kernels on `stream`; returns the first launch error (0 on success). Does
// not synchronise and allocates nothing.
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
