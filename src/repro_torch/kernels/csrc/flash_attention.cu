// Hopper (sm_90a) forward flash attention in float32 on the CUDA cores:
// causal and sliding-window masks, grouped-query heads, tanh logit softcap
// and a query position offset,
//
//     s   = (q . k) / sqrt(D)                              (f32)
//     s   = softcap * tanh(s / softcap)          when softcap > 0
//     s   = -inf  unless  kpos < Sk  [and kpos <= qpos]  [and qpos - kpos < window]
//     out = softmax(s) . v,  with qpos = q_offset + row
//
// taken as an online softmax over 64-key tiles with f32 running max m, sum
// l and accumulator acc; the output is acc / max(l, 1e-37). When asked
// (`lse` not null: training), each row's log-sum-exp m + log(max(l, 1e-37))
// goes to lse (B, H, Sq) f32 for the backward kernel
// (flash_attention_bwd.cu); a row that sees no key gets -inf.
// Query head h reads kv head h / (H / KV); no K/V is repeated.
//
// Replaces the TPU kernel `flash_attention_pallas` in
// src/repro/kernels/flash_attention.py (`_flash_kernel` at line 27,
// pallas_call at line 95). What it keeps from that kernel: the online
// softmax with f32 m, l and acc held on chip for a whole KV sweep, P kept
// in f32 for P.V, the mask order (scale, softcap, then mask), and the
// final division by max(l, 1e-37).
//
// What differs, and why:
//   * the TPU grid walks every KV block in order on one core and masks a
//     fully masked block with a finite -1e30, whose exp(0) terms a later
//     block wipes through alpha. Here each block computes the KV-tile range
//     its 64 query rows can see (causal: up to the last row's position;
//     window: from the first row's position - window + 1) and skips the
//     rest. Masked scores are -inf and the running max is made safe
//     (m == -inf is used as 0 in the exponents), so a masked key adds
//     exactly 0 in any tile: no tile need be non-empty, the skip is exact,
//     and a row that sees no key at all gives 0;
//   * the right-pad mask is against the true Sk, passed in. The wrapper
//     pads nothing (the TPU ops wrapper pads Sk to 128 and passes the
//     padded length, so there the pad mask never masks);
//   * the TPU kernel's 128 x 128 MXU tiles become 64 x 64 tiles for 256
//     threads: thread (ty, tx) owns query rows 4ty..4ty+3, keys
//     tx + 16j (j < 4) of the score tile, and D/16 columns of acc.
//
// This is the float32 route: its tolerance (2e-5 against the plain
// version) leaves no room for TF32 tensor cores. bfloat16 takes the
// tensor-core kernel in flash_attention_wgmma.cu.
//
// Design (simple and right first): one thread block per (64-row query
// tile, head, batch). Q, K and V tiles are staged in shared memory (Q for
// the whole sweep); scores and P.V are FMAs
// on CUDA cores with f32 accumulation in a fixed order, and the row
// max/sum reductions are xor-butterflies over the 16 threads of a row, so
// two launches give bitwise-equal results. Shared memory per block is
// 4 * (64 (D+4) [Q] + 64 (D+4) [K] + 64 D [V] + 64 * 68 [P]) bytes:
// 216,064 at D = 256, under the 232,448 a block may use.
//
// Head dims 96 and 112 run the D = 128 layout (float4 column groups of 64),
// instantiated with the true head dim DT as a second template parameter:
// the tiles are staged from the true-DT rows with columns DT..127
// zero-filled, and only the columns below DT are stored. Zero columns add
// exact zeros to q . k, the padded accumulator columns are never stored,
// and the scale is 1 / sqrt(DT) from the host, so the result is the
// unpadded function. At DT = D the column tests fold away at compile time.
//
// What bounds it on an H100: 4 B H D FLOP per unmasked (query, key) pair
// over the 67 TFLOP/s of f32 on the CUDA cores, against Q, K, V and O read
// or written once. It reads every operand from shared memory, so it lands
// above that bound.
//
// Built without --use_fast_math: expf and tanhf stay the accurate ones.
// Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // floats of row padding (keeps float4 aligned)

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Row reductions over the 16 threads (tx) that share a query row: lanes
// 16 * (ty & 1) + tx of a warp. Every lane ends with the same value.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
struct Layout {
  static constexpr int kQS = D + kPad;    // row stride of Q and K tiles
  static constexpr int kPS = kBK + kPad;  // row stride of the P tile
  static constexpr int kVec = D >= 64 ? 4 : 1;  // acc columns read as float4
  static constexpr int kDC = D / 16;            // acc columns per thread
  static constexpr size_t kFloats = static_cast<size_t>(kBQ) * kQS +
                                    static_cast<size_t>(kBK) * kQS +
                                    static_cast<size_t>(kBK) * D +
                                    static_cast<size_t>(kBQ) * kPS;
  static constexpr size_t kBytes = kFloats * sizeof(float);
  // acc column of a thread's e-th element
  static __device__ __forceinline__ int col(int tx, int e) {
    return kVec == 4 ? (e / 4) * 64 + tx * 4 + (e % 4) : tx + 16 * e;
  }
};

// Stage rows [row0, row0 + 64) of one head of a (B, S, NH, DT) tensor as
// f32 at `dst` (row stride `stride`) in the layout of head dim D >= DT,
// zero-filling rows at or past S and columns at or past DT.
template <typename T, int D, int DT>
__device__ __forceinline__ void stage_tile(float* dst, int stride,
                                           const T* __restrict__ src, int b,
                                           int S, int NH, int head, int row0) {
#pragma unroll 4
  for (int idx = threadIdx.x; idx < kBQ * D; idx += kThreads) {
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

template <typename T, int D, int DT>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int H, int KV, int Sq, int Sk,
                       float scale, int causal, int window, float softcap,
                       int q_offset) {
  using Lay = Layout<D>;
  static_assert(DT <= D, "true head dim within the layout");
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // kBQ x kQS
  float* k_s = q_s + kBQ * Lay::kQS;             // kBK x kQS
  float* v_s = k_s + kBK * Lay::kQS;             // kBK x D
  float* p_s = v_s + kBK * D;                    // kBQ x kPS

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  // The KV tiles this block's rows can see; the rest are fully masked.
  const int qmin = q_offset + q0;
  const int qmax = q_offset + min(q0 + kBQ, Sq) - 1;
  int kt_end = (Sk + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, qmax / kBK + 1);
  int kt_begin = 0;
  if (window > 0 && qmin - window + 1 > 0) kt_begin = (qmin - window + 1) / kBK;

  stage_tile<T, D, DT>(q_s, Lay::kQS, q, b, Sq, H, h, q0);

  float m[4], l[4], acc[4][Lay::kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < Lay::kDC; ++e) acc[i][e] = 0.0f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers of k_s, v_s, p_s are done
    stage_tile<T, D, DT>(k_s, Lay::kQS, k, b, Sk, KV, kvh, k0);
    stage_tile<T, D, DT>(v_s, D, v, b, Sk, KV, kvh, k0);
    __syncthreads();

    // s[i][j] = q[4ty + i] . k[tx + 16j]
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&q_s[(4 * ty + i) * Lay::kQS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(&k_s[(tx + 16 * j) * Lay::kQS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, kb[j].x, a);
          a = fmaf(qa[i].y, kb[j].y, a);
          a = fmaf(qa[i].z, kb[j].z, a);
          a = fmaf(qa[i].w, kb[j].w, a);
          s[i][j] = a;
        }
    }

    // scale, softcap, mask; online softmax update of m, l and acc
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        bool keep = kpos < Sk;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && (qpos - kpos < window);
        x = keep ? x : -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float alpha = expf(m[i] - m_use);  // 0 while m is still -inf
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_use);
        s[i][j] = p;
        sum += p;
      }
      sum = row_sum(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < Lay::kDC; ++e) acc[i][e] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) p_s[(4 * ty + i) * Lay::kPS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // acc[i][:] += p[4ty + i][:] . v   (P in f32)
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(&p_s[(4 * ty + i) * Lay::kPS + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = v_s + (kk + u) * D;
        float vv[Lay::kDC];
        if (Lay::kVec == 4) {
#pragma unroll
          for (int c = 0; c < Lay::kDC / 4; ++c) {
            const float4 t = *reinterpret_cast<const float4*>(&vrow[c * 64 + tx * 4]);
            vv[4 * c + 0] = t.x;
            vv[4 * c + 1] = t.y;
            vv[4 * c + 2] = t.z;
            vv[4 * c + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < Lay::kDC; ++e) vv[e] = vrow[Lay::col(tx, e)];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = component(pr[i], u);
#pragma unroll
          for (int e = 0; e < Lay::kDC; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-37f);
    // m and l are the same in the 16 threads of a row
    if (lse != nullptr && tx == 0)
      lse[(static_cast<size_t>(b) * H + h) * Sq + row] = m[i] + logf(denom);
    T* o = out + ((static_cast<size_t>(b) * Sq + row) * H + h) * DT;
#pragma unroll
    for (int e = 0; e < Lay::kDC; ++e) {
      const int c = Lay::col(tx, e);
      if (DT == D || c < DT) o[c] = from_float<T>(acc[i][e] / denom);
    }
  }
}

// The kernel of layout head dim D on tensors of true head dim DT <= D.
template <typename T, int D, int DT = D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int H, int KV, int Sq, int Sk,
                   float scale,
                   int causal, int window, float softcap, int q_offset,
                   cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D, DT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, D, DT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, H, KV, Sq, Sk,
      scale, causal, window, softcap, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out,
                       float* lse, int B, int H, int KV, int Sq, int Sk, int D,
                       float scale, int causal, int window, float softcap,
                       int q_offset, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, out, lse, B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    case 96:
      return launch<T, 128, 96>(q, k, v, out, lse, B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    case 112:
      return launch<T, 128, 112>(q, k, v, out, lse, B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    case 256:
      return launch<T, 256>(q, k, v, out, lse, B, H, KV, Sq, Sk, scale, causal, window, softcap, q_offset, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k and v (B, Sk, KV, D), out (B, Sq, H, D), all
// contiguous float32 (bfloat16 takes flash_attention_wgmma.cu), D in {16,
// 64, 96, 112, 128, 256} (96 and 112 on the 128 layout); lse (B, H, Sq)
// float32, or null when no backward follows. Launches on `stream`; returns
// cudaGetLastError() of the launch (0 on success). Does not synchronise
// and allocates nothing.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, void* lse, int B, int H, int KV, int Sq,
                        int Sk, int D, float scale, int causal, int window,
                        float softcap, int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1 ||
      window < 0 || q_offset < 0) {
    return cudaErrorInvalidValue;
  }
  return dispatch_d<float>(q, k, v, out, static_cast<float*>(lse), B, H, KV, Sq, Sk, D, scale, causal, window, softcap, q_offset, s);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
