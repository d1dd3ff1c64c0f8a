// Hopper (sm_90a) Mamba-2 SSD scan (state-space duality), forward:
//
//     state_t = exp(dt_t A_h) state_{t-1} + dt_t outer(x_t, B_t)    (P x N, f32)
//     y_t     = C_t . state_t + D_h x_t
//
// for x (B, S, H, P), dt (B, S, H), A (H,) f32, B/C (B, S, G, N), D (H,) f32
// or none; head h reads B/C group h / (H / G). Taken in chunks of kQ = 64
// steps. With cum the inclusive cumsum of dt A inside a chunk,
//
//     W_ij      = (C_i . B_j) exp(cum_i - cum_j) dt_j      (j <= i, else 0)
//     y_i       = sum_j W_ij x_j + exp(cum_i) C_i . state_in + D_h x_i
//     state_out = exp(cum_last) state_in + sum_j exp(cum_last - cum_j) dt_j outer(x_j, B_j)
//
// all in f32, and y is rounded once to x's dtype. Every exponent is <= 0
// (A < 0, dt > 0), so every exp lies in (0, 1]: the decay between two steps
// is formed only as exp(cum_i - cum_j) with j <= i, never as a product
// with exp(-cum), which would overflow.
//
// Replaces the TPU kernel `ssd_scan_pallas` in src/repro/kernels/ssd_scan.py
// (`_ssd_kernel` at line 28, pallas_call at line 80) plus the D skip its ops
// wrapper adds. What it keeps: the chunk decomposition above and the (P, N)
// f32 state carried from chunk to chunk on chip.
//
// What differs, and why:
//   * the TPU runs the chunk axis of its (B, H, S / chunk) grid in order and
//     carries the state in VMEM scratch between grid steps. Blocks here run
//     in no order, so one block owns one (b, h) and loops over the chunks
//     itself, carrying the state in shared memory;
//   * the TPU chunk (the ops default 128, the model's 256) would need
//     256 KB for W alone at 256; here the chunk is 64 and W, the B and C
//     tiles, the x tile and the state fit in 136,208 bytes at P = 64,
//     N = 128. The function depends on the chunk only through f32 rounding;
//   * the TPU ops wrapper transposes to (B, H, S, P), pads S to a multiple
//     of the chunk and adds D x in x's dtype after rounding the scan: two
//     roundings. Here the model's (B, S, H, P) layout is read in place
//     through strides, the ragged last chunk is masked (rows past S are
//     staged as zeros: dt = 0, x = 0 adds nothing), and D x is added in f32
//     before the one rounding, as the reference model's `ssd_chunked` does.
//
// Design (simple and right first): one block of 256 threads (16 x 16) per
// (h, b); per chunk it stages B, C and x as f32 in shared memory, warp 0
// scans the log-decays, then
//   1. W (64 x 64): thread (ty, tx) forms C.B^T for rows 4ty..4ty+3 and
//      columns tx + 16j, applies the decay and dt_j, and stores W;
//   2. y (64 x P): the same rows, columns tx + 16e; W . x over j <= i, then
//      exp(cum_i) C_i . state from the state in shared memory, then D x;
//   3. the state (P x N): thread owns rows ty + 16a, columns tx + 16c.
// One block per (b, h) with the whole head, rather than P split over
// several blocks: C.B^T and the decays are then formed once per chunk, not
// once per slice (they are 29% of the FMAs at P = 64, N = 128). At the
// mamba2-130m serving shape (B = 16, H = 24) that is 384 blocks, 2.9 waves
// of one block per SM (the 136 KB of shared memory allow one).
// All sums are FMAs on CUDA cores in a fixed order, with no atomics, so two
// launches agree bitwise.
//
// What bounds it on an H100: at the serving shape (B = 16, S = 2048,
// H = 24, P = 64, N = 128, bf16) it must read x, dt, B, C and write y, about
// 220 MB, 0.066 ms at 3.35 TB/s; the chunked work (C.B^T once per group,
// W.x over j <= i, the state terms) is ~30 GFLOP at a chunk of 64, 0.030 ms
// at the 989 TFLOP/s of the bf16 tensor cores. So the bound is bytes.
// This kernel does its ~2 x 21 GFLOP of FMAs (C.B^T once per head) on the CUDA
// cores (67 TFLOP/s f32), reading every operand from shared memory, and
// loads each chunk without overlap, so it lands far above that bound;
// tensor cores (wgmma on the C.B^T, W.x and state products), TMA loads of
// the next chunk during this one, and more than one block per SM are the
// later design.
//
// Built without --use_fast_math: expf stays the accurate one. Plain C
// interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kQ = 64;         // chunk length
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // floats of row padding (keeps float4 aligned)

enum DtypeCode { kF32 = 0, kBF16 = 1 };

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

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Element strides of the inputs (the last axis of x, B and C is contiguous).
struct Strides {
  long long xb, xs, xh;  // x (B, S, H, P)
  long long db, ds, dh;  // dt (B, S, H)
  long long bb, bs, bg;  // B (B, S, G, N)
  long long cb, cs, cg;  // C (B, S, G, N)
};

template <int P, int N>
struct Layout {
  static_assert(P % 16 == 0 && N % 16 == 0, "P and N must be multiples of 16");
  static constexpr int kNS = N + kPad;   // row stride of the B, C and state tiles
  static constexpr int kWS = kQ + kPad;  // row stride of the W tile
  static constexpr int kPC = P / 16;     // y columns per thread
  static constexpr int kSR = P / 16;     // state rows per thread
  static constexpr int kSC = N / 16;     // state columns per thread
  // B and C tiles, the x tile, W, the state, then dt, cum, exp(cum), the
  // state weights exp(cum_last - cum_j) dt_j and exp(cum_last)
  static constexpr size_t kFloats =
      2 * static_cast<size_t>(kQ) * kNS + static_cast<size_t>(kQ) * P +
      static_cast<size_t>(kQ) * kWS + static_cast<size_t>(P) * kNS + 4 * kQ + 4;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ D,
                T* __restrict__ out, int S, int H, int rep, Strides st) {
  using Lay = Layout<P, N>;
  constexpr int kNS = Lay::kNS;
  constexpr int kWS = Lay::kWS;
  extern __shared__ float4 smem4[];
  float* b_s = reinterpret_cast<float*>(smem4);  // kQ x kNS: B, then B_j w_j
  float* c_s = b_s + kQ * kNS;                   // kQ x kNS
  float* x_s = c_s + kQ * kNS;                   // kQ x P
  float* w_s = x_s + kQ * P;                     // kQ x kWS
  float* st_s = w_s + kQ * kWS;                  // P x kNS: the carried state
  float* dt_s = st_s + P * kNS;                  // kQ
  float* cum_s = dt_s + kQ;                      // kQ
  float* ecum_s = cum_s + kQ;                    // kQ: exp(cum_i)
  float* wst_s = ecum_s + kQ;                    // kQ: exp(cum_last - cum_j) dt_j
  float* elast_s = wst_s + kQ;                   // 1: exp(cum_last)

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / rep;
  const float a_h = A[h];
  const T* xp = x + b * st.xb + h * st.xh;
  const T* dtp = dt + b * st.db + h * st.dh;
  const T* bp = Bm + b * st.bb + g * st.bg;
  const T* cp = Cm + b * st.cb + g * st.cg;
  T* outp = out + (static_cast<size_t>(b) * S * H + h) * P;  // (B, S, H, P)

  for (int i = tid; i < P * kNS; i += kThreads) st_s[i] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += kQ) {
    __syncthreads();  // the previous chunk's readers of every tile are done

    // Stage the chunk as f32; rows at or past S are zeros.
    for (int idx = tid; idx < kQ * N; idx += kThreads) {
      const int r = idx / N;
      const int n = idx % N;
      const int s = c0 + r;
      float bv = 0.0f, cv = 0.0f;
      if (s < S) {
        bv = to_float(bp[s * st.bs + n]);
        cv = to_float(cp[s * st.cs + n]);
      }
      b_s[r * kNS + n] = bv;
      c_s[r * kNS + n] = cv;
    }
    for (int idx = tid; idx < kQ * P; idx += kThreads) {
      const int r = idx / P;
      const int p = idx % P;
      const int s = c0 + r;
      x_s[idx] = s < S ? to_float(xp[s * st.xs + p]) : 0.0f;
    }
    if (tid < kQ) {
      const int s = c0 + tid;
      dt_s[tid] = s < S ? to_float(dtp[s * st.ds]) : 0.0f;
    }
    __syncthreads();

    // Warp 0: cum = inclusive cumsum of dt A over the chunk, lane l taking
    // steps 2l and 2l + 1 (a scan of the pair sums across the warp).
    if (tid < 32) {
      const int l = tid;
      const float a0 = dt_s[2 * l] * a_h;
      const float a1 = dt_s[2 * l + 1] * a_h;
      float incl = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (l >= o) incl += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (l == 0) excl = 0.0f;
      const float last = __shfl_sync(0xffffffffu, incl, 31);
      const float cum0 = excl + a0;
      const float cum1 = incl;
      cum_s[2 * l] = cum0;
      cum_s[2 * l + 1] = cum1;
      ecum_s[2 * l] = expf(cum0);
      ecum_s[2 * l + 1] = expf(cum1);
      wst_s[2 * l] = expf(last - cum0) * dt_s[2 * l];
      wst_s[2 * l + 1] = expf(last - cum1) * dt_s[2 * l + 1];
      if (l == 0) *elast_s = expf(last);
    }
    __syncthreads();

    // 1. W[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i.
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        float4 cr[4], br[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cr[i] = *reinterpret_cast<const float4*>(&c_s[(4 * ty + i) * kNS + n]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          br[j] = *reinterpret_cast<const float4*>(&b_s[(tx + 16 * j) * kNS + n]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float a = acc[i][j];
            a = fmaf(cr[i].x, br[j].x, a);
            a = fmaf(cr[i].y, br[j].y, a);
            a = fmaf(cr[i].z, br[j].z, a);
            a = fmaf(cr[i].w, br[j].w, a);
            acc[i][j] = a;
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          float w = 0.0f;
          if (col <= row) w = acc[i][j] * expf(cum_s[row] - cum_s[col]) * dt_s[col];
          w_s[row * kWS + col] = w;
        }
      }
    }
    __syncthreads();

    // 2. y[i][p] for rows 4ty + i, columns tx + 16e. B is not read again
    // in this phase, so B_j is scaled by its state weight here, for 3.
    {
      float yin[4][Lay::kPC], yst[4][Lay::kPC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < Lay::kPC; ++e) yin[i][e] = yst[i][e] = 0.0f;
      const int jend = 4 * ty + 4;  // W is 0 past the thread's last row
      for (int j = 0; j < jend; j += 4) {
        float4 wr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wr[i] = *reinterpret_cast<const float4*>(&w_s[(4 * ty + i) * kWS + j]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float xv[Lay::kPC];
#pragma unroll
          for (int e = 0; e < Lay::kPC; ++e) xv[e] = x_s[(j + u) * P + tx + 16 * e];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float w = component(wr[i], u);
#pragma unroll
            for (int e = 0; e < Lay::kPC; ++e) yin[i][e] = fmaf(w, xv[e], yin[i][e]);
          }
        }
      }
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        float4 cr[4], sr[Lay::kPC];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cr[i] = *reinterpret_cast<const float4*>(&c_s[(4 * ty + i) * kNS + n]);
#pragma unroll
        for (int e = 0; e < Lay::kPC; ++e)
          sr[e] = *reinterpret_cast<const float4*>(&st_s[(tx + 16 * e) * kNS + n]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < Lay::kPC; ++e) {
            float a = yst[i][e];
            a = fmaf(cr[i].x, sr[e].x, a);
            a = fmaf(cr[i].y, sr[e].y, a);
            a = fmaf(cr[i].z, sr[e].z, a);
            a = fmaf(cr[i].w, sr[e].w, a);
            yst[i][e] = a;
          }
      }
      const float d_h = D != nullptr ? D[h] : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 4 * ty + i;
        const int s = c0 + row;
        if (s >= S) continue;
        const float ec = ecum_s[row];
#pragma unroll
        for (int e = 0; e < Lay::kPC; ++e) {
          const int p = tx + 16 * e;
          float y = yin[i][e] + ec * yst[i][e];
          if (D != nullptr) y = y + d_h * x_s[row * P + p];
          outp[static_cast<size_t>(s) * H * P + p] = from_float<T>(y);
        }
      }
      for (int idx = tid; idx < kQ * N; idx += kThreads) {
        const int r = idx / N;
        b_s[r * kNS + idx % N] *= wst_s[r];
      }
    }
    __syncthreads();

    // 3. state[p][n] = exp(cum_last) state[p][n] + sum_j x_j[p] B_j[n] w_j
    // for rows ty + 16a, columns tx + 16c (each thread its own entries).
    {
      float acc[Lay::kSR][Lay::kSC];
#pragma unroll
      for (int a = 0; a < Lay::kSR; ++a)
#pragma unroll
        for (int c = 0; c < Lay::kSC; ++c) acc[a][c] = 0.0f;
#pragma unroll 4
      for (int j = 0; j < kQ; ++j) {
        float xv[Lay::kSR], bv[Lay::kSC];
#pragma unroll
        for (int a = 0; a < Lay::kSR; ++a) xv[a] = x_s[j * P + ty + 16 * a];
#pragma unroll
        for (int c = 0; c < Lay::kSC; ++c) bv[c] = b_s[j * kNS + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < Lay::kSR; ++a)
#pragma unroll
          for (int c = 0; c < Lay::kSC; ++c) acc[a][c] = fmaf(xv[a], bv[c], acc[a][c]);
      }
      const float el = *elast_s;
#pragma unroll
      for (int a = 0; a < Lay::kSR; ++a)
#pragma unroll
        for (int c = 0; c < Lay::kSC; ++c) {
          float* sp = &st_s[(ty + 16 * a) * kNS + tx + 16 * c];
          *sp = *sp * el + acc[a][c];
        }
    }
  }
}

template <typename T, int P, int N>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const void* Bm, const void* Cm, const float* D, void* out,
                   int B, int S, int H, int G, const Strides& st,
                   cudaStream_t stream) {
  constexpr size_t smem = Layout<P, N>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  ssd_scan_kernel<T, P, N><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), D,
      static_cast<T*>(out), S, H, H / G, st);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t dispatch_n(const void* x, const void* dt, const float* A,
                       const void* Bm, const void* Cm, const float* D,
                       void* out, int B, int S, int H, int G, int N,
                       const Strides& st, cudaStream_t s) {
  switch (N) {
    case 16:
      return launch<T, P, 16>(x, dt, A, Bm, Cm, D, out, B, S, H, G, st, s);
    case 32:
      return launch<T, P, 32>(x, dt, A, Bm, Cm, D, out, B, S, H, G, st, s);
    case 64:
      return launch<T, P, 64>(x, dt, A, Bm, Cm, D, out, B, S, H, G, st, s);
    case 128:
      return launch<T, P, 128>(x, dt, A, Bm, Cm, D, out, B, S, H, G, st, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_p(const void* x, const void* dt, const float* A,
                       const void* Bm, const void* Cm, const float* D,
                       void* out, int B, int S, int H, int G, int P, int N,
                       const Strides& st, cudaStream_t s) {
  switch (P) {
    case 16:
      return dispatch_n<T, 16>(x, dt, A, Bm, Cm, D, out, B, S, H, G, N, st, s);
    case 32:
      return dispatch_n<T, 32>(x, dt, A, Bm, Cm, D, out, B, S, H, G, N, st, s);
    case 64:
      return dispatch_n<T, 64>(x, dt, A, Bm, Cm, D, out, B, S, H, G, N, st, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (B, S, H, P), dt (B, S, H), B and C (B, S, G, N) of one dtype
// (0 = float32, 1 = bfloat16), read through the 12 element strides in
// `strides` (x: b, s, h; dt: b, s, h; B: b, s, g; C: b, s, g; the last
// axis of x, B and C contiguous); A (H,) and D (H,) float32, D may be null;
// out (B, S, H, P) contiguous in the inputs' dtype. Launches on `stream`;
// returns cudaGetLastError() of the launch (0 on success). Does not
// synchronise and allocates nothing.
int ssd_scan_fwd(const void* x, const void* dt, const float* A,
                 const void* Bm, const void* Cm, const float* D, void* out,
                 int B, int S, int H, int G, int P, int N, int dtype,
                 const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || S < 1 || H < 1 || G < 1 || H % G != 0 ||
      strides == nullptr) {
    return cudaErrorInvalidValue;
  }
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  switch (dtype) {
    case kF32:
      return dispatch_p<float>(x, dt, A, Bm, Cm, D, out, B, S, H, G, P, N, st, s);
    case kBF16:
      return dispatch_p<__nv_bfloat16>(x, dt, A, Bm, Cm, D, out, B, S, H, G, P, N, st, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
