// Hopper (sm_90a) Mamba-2 SSD scan, backward: the gradients of
//
//     state_t = exp(dt_t A_h) state_{t-1} + dt_t outer(x_t, B_t)    (P x N, f32)
//     y_t     = C_t . state_t + D_h x_t
//
// for x (B, S, H, P), dt (B, S, H), A (H,) f32, B/C (B, S, G, N), D (H,) f32
// or none, given dy (B, S, H, P): dx, ddt, dB, dC in the inputs' dtype and
// dA, dD in f32. Head h reads B/C group h / (H / G), so dB and dC sum over
// the H / G heads of a group. Everything is computed in f32 from the
// inputs as read, and each output is rounded once.
//
// Replaces nothing in the reference: the JAX package differentiates
// `models/ssm.py::ssd_chunked` (plain jnp) and defines no backward for its
// Pallas kernel `ssd_scan_pallas` (src/repro/kernels/ssd_scan.py:67). The
// port's training path runs the forward kernel (ssd_scan.cu / ssd_scan_wgmma.cu),
// so its gradient is this kernel; the plain version is autograd through
// `kernels/ref.py::ssd_chunked_ref` (`ref.ssd_chunked_grads`).
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
// Design (simple and right first; four launches on one stream):
//   1. `sweep`: one block per (h, b) and direction. Forward, it carries the
//      state chunk by chunk and stores the state entering each chunk; in
//      reverse, it carries dS and stores the gradient of the state leaving
//      each chunk, each into a (B, H, NC, P, N) f32 scratch. Thread (ty, tx)
//      of 256 owns state entries (ty + 16a, tx + 16c), as the forward
//      kernel's state phase.
//   2. `chunk`: one block per (h, chunk, b), 256 threads, every term above
//      from the chunk's x, dy, B, C, dt and its two stored states, all
//      staged as f32 in shared memory (223,504 bytes at P = 64, N = 128).
//      It writes dx and ddt, and per-head partials of dB and dC
//      (B, S, H, N) and of dA and dD (B, NC, H).
//   3. `reduce_bc` sums the dB and dC partials over the heads of each group
//      in ascending order; `reduce_heads` sums the dA and dD partials over
//      (b, chunk) in ascending order.
// No float atomics anywhere: every partial has one writer and every sum a
// fixed order, so two launches give bitwise the same gradients.
//
// What bounds it on an H100: at mamba2-130m's training layer (B = 8,
// S = 2048, H = 24, P = 64, G = 1, N = 128, f32) it must read x, dt, B, C,
// dy and write dx, ddt, dB, dC (~0.34 GB, 0.10 ms at 3.35 TB/s); its
// chunked work (the products above over j <= i, the three state terms and
// the two carries) is ~42 GFLOP in f32 (0.63 ms at the 67 TFLOP/s of the
// CUDA cores), so the bound is operations. This design also writes and reads the two
// state scratches and the dB/dC partials (~0.8 GB more), runs one block of
// eight warps per SM in `chunk` (its shared memory allows no second), and
// does every product as CUDA-core FMAs; tensor cores (wgmma on G, dW, the
// state products) and a fused sweep are the later design.
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

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Sum over the 16 lanes of a half warp (the 16 tx of one ty), in a fixed
// order; every lane of the group gets the sum.
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sum of one value a thread, in a fixed tree order; `red` holds
// kThreads floats. Every thread gets the sum. Starts and ends with a barrier.
__device__ __forceinline__ float block_sum(float v, float* red) {
  __syncthreads();
  red[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int o = kThreads / 2; o > 0; o >>= 1) {
    if (static_cast<int>(threadIdx.x) < o) red[threadIdx.x] += red[threadIdx.x + o];
    __syncthreads();
  }
  const float s = red[0];
  __syncthreads();
  return s;
}

// Element strides of the inputs (the last axis of x, B, C and dy is
// contiguous).
struct Strides {
  long long xb, xs, xh;  // x (B, S, H, P)
  long long db, ds, dh;  // dt (B, S, H)
  long long bb, bs, bg;  // B (B, S, G, N)
  long long cb, cs, cg;  // C (B, S, G, N)
  long long yb, ys, yh;  // dy (B, S, H, P)
};

// Warp 0 of a block: cum = inclusive cumsum of dt A over the chunk in
// `cum_s`, lane l taking steps 2l and 2l + 1 (the forward kernel's scan, so
// both take the same cum); returns last = cum_{kQ-1} in every lane.
__device__ __forceinline__ float chunk_cumsum(const float* dt_s, float a_h,
                                              float* cum_s) {
  const int l = threadIdx.x;
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
  cum_s[2 * l] = excl + a0;
  cum_s[2 * l + 1] = incl;
  return __shfl_sync(0xffffffffu, incl, 31);
}

// ---------------------------------------------------------------------------
// 1. The two sweeps. blockIdx.z == 0: states[c] = the state entering chunk c.
// blockIdx.z == 1: dstates[c] = the gradient of the state leaving chunk c.
// ---------------------------------------------------------------------------
template <int P, int N>
struct SweepLayout {
  static constexpr int kNS = N + kPad;
  static constexpr size_t kFloats =
      static_cast<size_t>(kQ) * P + static_cast<size_t>(kQ) * kNS + 3 * kQ + 4;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_sweep(const T* __restrict__ x, const T* __restrict__ dt,
              const float* __restrict__ A, const T* __restrict__ Bm,
              const T* __restrict__ Cm, const T* __restrict__ dy,
              float* __restrict__ states, float* __restrict__ dstates, int S,
              int H, int rep, int NC, Strides st) {
  constexpr int kNS = SweepLayout<P, N>::kNS;
  constexpr int kSR = P / 16;
  constexpr int kSC = N / 16;
  extern __shared__ float4 smem4[];
  float* v_s = reinterpret_cast<float*>(smem4);  // kQ x P: x or dy
  float* m_s = v_s + kQ * P;                     // kQ x kNS: B or C, weighted
  float* dt_s = m_s + kQ * kNS;                  // kQ
  float* cum_s = dt_s + kQ;                      // kQ
  float* w_s = cum_s + kQ;                       // kQ: the row weights
  float* el_s = w_s + kQ;                        // 1: exp(last)

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const bool reverse = blockIdx.z == 1;
  const int g = h / rep;
  const float a_h = A[h];
  const T* vp = reverse ? dy + b * st.yb + h * st.yh : x + b * st.xb + h * st.xh;
  const long long vs = reverse ? st.ys : st.xs;
  const T* mp = reverse ? Cm + b * st.cb + g * st.cg : Bm + b * st.bb + g * st.bg;
  const long long ms = reverse ? st.cs : st.bs;
  const T* dtp = dt + b * st.db + h * st.dh;
  float* out = (reverse ? dstates : states) +
               (static_cast<size_t>(b) * H + h) * NC * P * N;

  float acc[kSR][kSC];
#pragma unroll
  for (int a = 0; a < kSR; ++a)
#pragma unroll
    for (int c = 0; c < kSC; ++c) acc[a][c] = 0.0f;

  for (int k = 0; k < NC; ++k) {
    const int c = reverse ? NC - 1 - k : k;
    const int c0 = c * kQ;
    float* o = out + static_cast<size_t>(c) * P * N;
#pragma unroll
    for (int a = 0; a < kSR; ++a)
#pragma unroll
      for (int cc = 0; cc < kSC; ++cc) o[(ty + 16 * a) * N + tx + 16 * cc] = acc[a][cc];
    __syncthreads();  // the previous chunk's readers of every tile are done

    for (int idx = tid; idx < kQ * N; idx += kThreads) {
      const int r = idx / N;
      const int s = c0 + r;
      m_s[r * kNS + idx % N] = s < S ? to_float(mp[s * ms + idx % N]) : 0.0f;
    }
    for (int idx = tid; idx < kQ * P; idx += kThreads) {
      const int s = c0 + idx / P;
      v_s[idx] = s < S ? to_float(vp[s * vs + idx % P]) : 0.0f;
    }
    if (tid < kQ) {
      const int s = c0 + tid;
      dt_s[tid] = s < S ? to_float(dtp[s * st.ds]) : 0.0f;
    }
    __syncthreads();
    if (tid < 32) {
      const float last = chunk_cumsum(dt_s, a_h, cum_s);
      __syncwarp();
      for (int r = tid; r < kQ; r += 32) {
        // forward: u_j = exp(last - cum_j) dt_j; reverse: E_i = exp(cum_i)
        w_s[r] = reverse ? expf(cum_s[r]) : expf(last - cum_s[r]) * dt_s[r];
      }
      if (tid == 0) *el_s = expf(last);
    }
    __syncthreads();
    for (int idx = tid; idx < kQ * N; idx += kThreads) {
      const int r = idx / N;
      m_s[r * kNS + idx % N] *= w_s[r];
    }
    __syncthreads();

    float sum[kSR][kSC];
#pragma unroll
    for (int a = 0; a < kSR; ++a)
#pragma unroll
      for (int cc = 0; cc < kSC; ++cc) sum[a][cc] = 0.0f;
#pragma unroll 4
    for (int j = 0; j < kQ; ++j) {
      float vv[kSR], mv[kSC];
#pragma unroll
      for (int a = 0; a < kSR; ++a) vv[a] = v_s[j * P + ty + 16 * a];
#pragma unroll
      for (int cc = 0; cc < kSC; ++cc) mv[cc] = m_s[j * kNS + tx + 16 * cc];
#pragma unroll
      for (int a = 0; a < kSR; ++a)
#pragma unroll
        for (int cc = 0; cc < kSC; ++cc) sum[a][cc] = fmaf(vv[a], mv[cc], sum[a][cc]);
    }
    const float el = *el_s;
#pragma unroll
    for (int a = 0; a < kSR; ++a)
#pragma unroll
      for (int cc = 0; cc < kSC; ++cc) acc[a][cc] = acc[a][cc] * el + sum[a][cc];
  }
}

// ---------------------------------------------------------------------------
// 2. Every gradient term of one (h, chunk, b).
// ---------------------------------------------------------------------------
template <int P, int N>
struct ChunkLayout {
  static constexpr int kNS = N + kPad;   // row stride of B, C, S0, dS
  static constexpr int kWS = kQ + kPad;  // row stride of W, dG, M
  // x, dy; B, C; S0, dS; W, dG, M; 9 vectors of kQ; kThreads for sums; 4
  static constexpr size_t kFloats =
      2 * static_cast<size_t>(kQ) * P + 2 * static_cast<size_t>(kQ) * kNS +
      2 * static_cast<size_t>(P) * kNS + 3 * static_cast<size_t>(kQ) * kWS +
      9 * kQ + kThreads + 4;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk(const T* __restrict__ x, const T* __restrict__ dt,
              const float* __restrict__ A, const T* __restrict__ Bm,
              const T* __restrict__ Cm, const float* __restrict__ D,
              const T* __restrict__ dy, const float* __restrict__ states,
              const float* __restrict__ dstates, T* __restrict__ dx,
              T* __restrict__ ddt, float* __restrict__ dB_part,
              float* __restrict__ dC_part, float* __restrict__ dA_part,
              float* __restrict__ dD_part, int S, int H, int rep, int NC,
              Strides st) {
  using Lay = ChunkLayout<P, N>;
  constexpr int kNS = Lay::kNS;
  constexpr int kWS = Lay::kWS;
  constexpr int kPC = P / 16;  // P columns a thread
  constexpr int kNC = N / 16;  // N columns a thread
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);  // kQ x P
  float* dy_s = x_s + kQ * P;                    // kQ x P
  float* b_s = dy_s + kQ * P;                    // kQ x kNS
  float* c_s = b_s + kQ * kNS;                   // kQ x kNS
  float* s0_s = c_s + kQ * kNS;                  // P x kNS: the entering state
  float* ds_s = s0_s + P * kNS;                  // P x kNS: dS of the leaving one
  float* w_s = ds_s + P * kNS;                   // kQ x kWS: W
  float* dg_s = w_s + kQ * kWS;                  // kQ x kWS: dG
  float* m_s = dg_s + kQ * kWS;                  // kQ x kWS: M
  float* dt_s = m_s + kQ * kWS;                  // kQ
  float* cum_s = dt_s + kQ;                      // kQ
  float* e_s = cum_s + kQ;                       // kQ: E_i = exp(cum_i)
  float* eu_s = e_s + kQ;                        // kQ: exp(last - cum_j)
  float* colm_s = eu_s + kQ;                     // kQ: sum_i M_ij
  float* rowm_s = colm_s + kQ;                   // kQ: sum_j M_ij dt_j
  float* du_s = rowm_s + kQ;                     // kQ
  float* q_s = du_s + kQ;                        // kQ: C_i . dC_inter_i
  float* dcum_s = q_s + kQ;                      // kQ
  float* red_s = dcum_s + kQ;                    // kThreads
  float* sc_s = red_s + kThreads;                // 4: last, exp(last), de, dD

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / rep;
  const int c0 = c * kQ;
  const float a_h = A[h];
  const T* xp = x + b * st.xb + h * st.xh;
  const T* dyp = dy + b * st.yb + h * st.yh;
  const T* dtp = dt + b * st.db + h * st.dh;
  const T* bp = Bm + b * st.bb + g * st.bg;
  const T* cp = Cm + b * st.cb + g * st.cg;
  const size_t sidx = ((static_cast<size_t>(b) * H + h) * NC + c) * P * N;

  // Stage the chunk as f32; rows at or past S are zeros.
  for (int idx = tid; idx < kQ * N; idx += kThreads) {
    const int r = idx / N;
    const int n = idx % N;
    const int s = c0 + r;
    b_s[r * kNS + n] = s < S ? to_float(bp[s * st.bs + n]) : 0.0f;
    c_s[r * kNS + n] = s < S ? to_float(cp[s * st.cs + n]) : 0.0f;
  }
  for (int idx = tid; idx < kQ * P; idx += kThreads) {
    const int s = c0 + idx / P;
    const int p = idx % P;
    x_s[idx] = s < S ? to_float(xp[s * st.xs + p]) : 0.0f;
    dy_s[idx] = s < S ? to_float(dyp[s * st.ys + p]) : 0.0f;
  }
  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int p = idx / N;
    s0_s[p * kNS + idx % N] = states[sidx + idx];
    ds_s[p * kNS + idx % N] = dstates[sidx + idx];
  }
  if (tid < kQ) {
    const int s = c0 + tid;
    dt_s[tid] = s < S ? to_float(dtp[s * st.ds]) : 0.0f;
  }
  __syncthreads();
  if (tid < 32) {
    const float last = chunk_cumsum(dt_s, a_h, cum_s);
    __syncwarp();
    for (int r = tid; r < kQ; r += 32) {
      e_s[r] = expf(cum_s[r]);
      eu_s[r] = expf(last - cum_s[r]);
    }
    if (tid == 0) {
      sc_s[0] = last;
      sc_s[1] = expf(last);
    }
  }
  __syncthreads();

  // A. Rows i = 4ty + ii, columns j = tx + 16jj: G = C B^T, dW = dy x^T,
  // then W, dG and M on and below the diagonal (0 above it).
  {
    float gacc[4][4], wacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) gacc[i][j] = wacc[i][j] = 0.0f;
#pragma unroll 2
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
        for (int j = 0; j < 4; ++j) gacc[i][j] = dot4(cr[i], br[j], gacc[i][j]);
    }
#pragma unroll 2
    for (int p = 0; p < P; p += 4) {
      float4 yr[4], xr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        yr[i] = *reinterpret_cast<const float4*>(&dy_s[(4 * ty + i) * P + p]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        xr[j] = *reinterpret_cast<const float4*>(&x_s[(tx + 16 * j) * P + p]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wacc[i][j] = dot4(yr[i], xr[j], wacc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        float w = 0.0f, dg = 0.0f, m = 0.0f;
        if (col <= row) {
          const float l = expf(cum_s[row] - cum_s[col]);
          const float t = wacc[i][j] * l;
          w = gacc[i][j] * l * dt_s[col];
          dg = t * dt_s[col];
          m = t * gacc[i][j];
        }
        w_s[row * kWS + col] = w;
        dg_s[row * kWS + col] = dg;
        m_s[row * kWS + col] = m;
      }
    }
  }
  __syncthreads();

  // The sums of M (threads 0-63 a column, 64-127 a row, ascending), and the
  // block sums de = sum dS * S0 and dy . x (each thread's strided terms in
  // order, then a fixed tree).
  if (tid < kQ) {
    float s = 0.0f;
    for (int i = tid; i < kQ; ++i) s += m_s[i * kWS + tid];
    colm_s[tid] = s;
  } else if (tid < 2 * kQ) {
    const int r = tid - kQ;
    float s = 0.0f;
    for (int j = 0; j <= r; ++j) s = fmaf(m_s[r * kWS + j], dt_s[j], s);
    rowm_s[r] = s;
  }
  {
    float de = 0.0f;
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int p = idx / N;
      de = fmaf(ds_s[p * kNS + idx % N], s0_s[p * kNS + idx % N], de);
    }
    de = block_sum(de, red_s);
    float dd = 0.0f;
    for (int idx = tid; idx < kQ * P; idx += kThreads) dd = fmaf(dy_s[idx], x_s[idx], dd);
    dd = block_sum(dd, red_s);
    if (tid == 0) {
      sc_s[2] = de;
      sc_s[3] = dd;
    }
  }

  // B1. dx for rows j = 4ty + jj, columns p = tx + 16e, and du_j.
  {
    float intra[4][kPC], raw[4][kPC];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < kPC; ++e) intra[j][e] = raw[j][e] = 0.0f;
    for (int i = 4 * ty; i < kQ; ++i) {  // W_ij = 0 for i < j
      const float4 wr = *reinterpret_cast<const float4*>(&w_s[i * kWS + 4 * ty]);
      float yv[kPC];
#pragma unroll
      for (int e = 0; e < kPC; ++e) yv[e] = dy_s[i * P + tx + 16 * e];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float w = component(wr, j);
#pragma unroll
        for (int e = 0; e < kPC; ++e) intra[j][e] = fmaf(w, yv[e], intra[j][e]);
      }
    }
#pragma unroll 2
    for (int n = 0; n < N; n += 4) {
      float4 br[4], sr[kPC];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        br[j] = *reinterpret_cast<const float4*>(&b_s[(4 * ty + j) * kNS + n]);
#pragma unroll
      for (int e = 0; e < kPC; ++e)
        sr[e] = *reinterpret_cast<const float4*>(&ds_s[(tx + 16 * e) * kNS + n]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < kPC; ++e) raw[j][e] = dot4(br[j], sr[e], raw[j][e]);
    }
    const float d_h = D != nullptr ? D[h] : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = 4 * ty + j;
      const int s = c0 + row;
      const float u = eu_s[row] * dt_s[row];
      float du = 0.0f;
#pragma unroll
      for (int e = 0; e < kPC; ++e) {
        const int p = tx + 16 * e;
        du = fmaf(x_s[row * P + p], raw[j][e], du);
        float v = intra[j][e] + u * raw[j][e];
        if (D != nullptr) v = fmaf(d_h, dy_s[row * P + p], v);
        if (s < S) {
          dx[((static_cast<size_t>(b) * S + s) * H + h) * P + p] = from_float<T>(v);
        }
      }
      du = sum16(du);
      if (tx == 0) du_s[row] = du;
    }
  }

  // B2. dC for rows i = 4ty + ii, columns n = tx + 16k, and C_i . dC_inter_i.
  {
    float intra[4][kNC], z[4][kNC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < kNC; ++k) intra[i][k] = z[i][k] = 0.0f;
    const int jend = 4 * ty + 4;  // dG is 0 past the thread's last row
    for (int j = 0; j < jend; j += 4) {
      float4 gr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        gr[i] = *reinterpret_cast<const float4*>(&dg_s[(4 * ty + i) * kWS + j]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float bv[kNC];
#pragma unroll
        for (int k = 0; k < kNC; ++k) bv[k] = b_s[(j + u) * kNS + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float gv = component(gr[i], u);
#pragma unroll
          for (int k = 0; k < kNC; ++k) intra[i][k] = fmaf(gv, bv[k], intra[i][k]);
        }
      }
    }
    for (int p = 0; p < P; ++p) {
      float yv[4], sv[kNC];
#pragma unroll
      for (int i = 0; i < 4; ++i) yv[i] = dy_s[(4 * ty + i) * P + p];
#pragma unroll
      for (int k = 0; k < kNC; ++k) sv[k] = s0_s[p * kNS + tx + 16 * k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < kNC; ++k) z[i][k] = fmaf(yv[i], sv[k], z[i][k]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 4 * ty + i;
      const int s = c0 + row;
      const float e = e_s[row];
      float q = 0.0f;
#pragma unroll
      for (int k = 0; k < kNC; ++k) {
        const int n = tx + 16 * k;
        const float inter = e * z[i][k];
        q = fmaf(c_s[row * kNS + n], inter, q);
        if (s < S) {
          dC_part[((static_cast<size_t>(b) * S + s) * H + h) * N + n] = intra[i][k] + inter;
        }
      }
      q = sum16(q);
      if (tx == 0) q_s[row] = q;
    }
  }

  // B3. dB for rows j = 4ty + jj, columns n = tx + 16k.
  {
    float intra[4][kNC], v[4][kNC];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < kNC; ++k) intra[j][k] = v[j][k] = 0.0f;
    for (int i = 4 * ty; i < kQ; ++i) {  // dG_ij = 0 for i < j
      const float4 gr = *reinterpret_cast<const float4*>(&dg_s[i * kWS + 4 * ty]);
      float cv[kNC];
#pragma unroll
      for (int k = 0; k < kNC; ++k) cv[k] = c_s[i * kNS + tx + 16 * k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float gv = component(gr, j);
#pragma unroll
        for (int k = 0; k < kNC; ++k) intra[j][k] = fmaf(gv, cv[k], intra[j][k]);
      }
    }
    for (int p = 0; p < P; ++p) {
      float xv[4], sv[kNC];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = x_s[(4 * ty + j) * P + p];
#pragma unroll
      for (int k = 0; k < kNC; ++k) sv[k] = ds_s[p * kNS + tx + 16 * k];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < kNC; ++k) v[j][k] = fmaf(xv[j], sv[k], v[j][k]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = 4 * ty + j;
      const int s = c0 + row;
      if (s >= S) continue;
      const float u = eu_s[row] * dt_s[row];
#pragma unroll
      for (int k = 0; k < kNC; ++k) {
        const int n = tx + 16 * k;
        dB_part[((static_cast<size_t>(b) * S + s) * H + h) * N + n] =
            fmaf(u, v[j][k], intra[j][k]);
      }
    }
  }
  __syncthreads();

  // C. dcum, its suffix sums, ddt and the dA, dD partials (one thread, in
  // order).
  if (tid == 0) {
    const float el = sc_s[1];
    float tail = 0.0f;  // sum_j du_j u_j
    for (int r = 0; r < kQ; ++r) {
      const float du_u = du_s[r] * eu_s[r] * dt_s[r];
      tail += du_u;
      dcum_s[r] = rowm_s[r] - dt_s[r] * colm_s[r] + q_s[r] - du_u;
    }
    dcum_s[kQ - 1] += tail + el * sc_s[2];
    float suffix = 0.0f, da = 0.0f;
    for (int r = kQ - 1; r >= 0; --r) {
      suffix += dcum_s[r];
      da = fmaf(dt_s[r], suffix, da);
      const float v = colm_s[r] + du_s[r] * eu_s[r] + a_h * suffix;
      const int s = c0 + r;
      if (s < S) ddt[(static_cast<size_t>(b) * S + s) * H + h] = from_float<T>(v);
    }
    const size_t pidx = (static_cast<size_t>(b) * NC + c) * H + h;
    dA_part[pidx] = da;
    dD_part[pidx] = sc_s[3];
  }
}

// ---------------------------------------------------------------------------
// 3. The fixed-order sums across blocks.
// ---------------------------------------------------------------------------
// dB/dC (B*S, G, N) = sum over the rep heads of each group of the partials
// (B*S, H, N), ascending.
template <typename T>
__global__ void ssd_bwd_reduce_bc(const float* __restrict__ dB_part,
                                  const float* __restrict__ dC_part,
                                  T* __restrict__ dB, T* __restrict__ dC,
                                  long long rows, int H, int G, int N) {
  const long long total = rows * G * N;
  const int rep = H / G;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long bs = idx / (static_cast<long long>(G) * N);
    const int g = static_cast<int>((idx / N) % G);
    const int n = static_cast<int>(idx % N);
    const size_t base = (static_cast<size_t>(bs) * H + static_cast<size_t>(g) * rep) * N + n;
    float sb = 0.0f, sc = 0.0f;
    for (int r = 0; r < rep; ++r) {
      sb += dB_part[base + static_cast<size_t>(r) * N];
      sc += dC_part[base + static_cast<size_t>(r) * N];
    }
    dB[idx] = from_float<T>(sb);
    dC[idx] = from_float<T>(sc);
  }
}

// dA, dD (H,) = sum over (b, chunk), ascending, of the partials (B*NC, H).
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

struct Args {
  const void *x, *dt, *Bm, *Cm, *dy;
  const float *A, *D;
  void *dx, *ddt, *dB, *dC;
  float *dA, *dD, *states, *dstates, *dB_part, *dC_part, *dA_part, *dD_part;
};

template <typename T, int P, int N>
cudaError_t launch(const Args& a, int B, int S, int H, int G,
                   const Strides& st, cudaStream_t stream) {
  const int NC = (S + kQ - 1) / kQ;
  const int rep = H / G;
  constexpr size_t sweep_smem = SweepLayout<P, N>::kBytes;
  constexpr size_t chunk_smem = ChunkLayout<P, N>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_sweep<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sweep_smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_chunk<T, P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(chunk_smem));
  if (err != cudaSuccess) return err;
  const T* x = static_cast<const T*>(a.x);
  const T* dt = static_cast<const T*>(a.dt);
  const T* Bm = static_cast<const T*>(a.Bm);
  const T* Cm = static_cast<const T*>(a.Cm);
  const T* dy = static_cast<const T*>(a.dy);
  ssd_bwd_sweep<T, P, N><<<dim3(H, B, 2), kThreads, sweep_smem, stream>>>(
      x, dt, a.A, Bm, Cm, dy, a.states, a.dstates, S, H, rep, NC, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk<T, P, N><<<dim3(H, NC, B), kThreads, chunk_smem, stream>>>(
      x, dt, a.A, Bm, Cm, a.D, dy, a.states, a.dstates, static_cast<T*>(a.dx),
      static_cast<T*>(a.ddt), a.dB_part, a.dC_part, a.dA_part, a.dD_part, S,
      H, rep, NC, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(B) * S;
  const long long want = (rows * G * N + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 65535 ? want : 65535);  // grid-stride
  ssd_bwd_reduce_bc<T><<<blocks, kThreads, 0, stream>>>(
      a.dB_part, a.dC_part, static_cast<T*>(a.dB), static_cast<T*>(a.dC), rows,
      H, G, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_reduce_heads<<<(H + 127) / 128, 128, 0, stream>>>(
      a.dA_part, a.dD_part, a.dA, a.D != nullptr ? a.dD : nullptr, B * NC, H);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t dispatch_n(const Args& a, int B, int S, int H, int G, int N,
                       const Strides& st, cudaStream_t s) {
  switch (N) {
    case 16:
      return launch<T, P, 16>(a, B, S, H, G, st, s);
    case 32:
      return launch<T, P, 32>(a, B, S, H, G, st, s);
    case 64:
      return launch<T, P, 64>(a, B, S, H, G, st, s);
    case 128:
      return launch<T, P, 128>(a, B, S, H, G, st, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_p(const Args& a, int B, int S, int H, int G, int P,
                       int N, const Strides& st, cudaStream_t s) {
  switch (P) {
    case 16:
      return dispatch_n<T, 16>(a, B, S, H, G, N, st, s);
    case 32:
      return dispatch_n<T, 32>(a, B, S, H, G, N, st, s);
    case 64:
      return dispatch_n<T, 64>(a, B, S, H, G, N, st, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Inputs: x (B, S, H, P), dt (B, S, H), B and C (B, S, G, N) and dy
// (B, S, H, P) of one dtype (0 = float32, 1 = bfloat16), read through the
// 15 element strides in `strides` (x: b, s, h; dt: b, s, h; B: b, s, g;
// C: b, s, g; dy: b, s, h; the last axis of x, B, C and dy contiguous);
// A (H,) and D (H,) float32, D may be null. Outputs, contiguous: dx
// (B, S, H, P), ddt (B, S, H), dB and dC (B, S, G, N) in the inputs' dtype;
// dA (H,) and dD (H,) float32 (dD unwritten when D is null). Scratch, f32
// and contiguous, NC = ceil(S / 64): states and dstates (B, H, NC, P, N),
// dB_part and dC_part (B, S, H, N), dA_part and dD_part (B, NC, H).
// Launches four kernels on `stream`; returns the first cudaGetLastError()
// that is not 0 (0 on success). Does not synchronise and allocates nothing.
int ssd_scan_bwd(const void* x, const void* dt, const float* A,
                 const void* Bm, const void* Cm, const float* D,
                 const void* dy, void* dx, void* ddt, float* dA, void* dB,
                 void* dC, float* dD, float* states, float* dstates,
                 float* dB_part, float* dC_part, float* dA_part,
                 float* dD_part, int B, int S, int H, int G, int P, int N,
                 int dtype, const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || S < 1 || (S + kQ - 1) / kQ > 65535 || H < 1 ||
      H > 65535 || G < 1 || H % G != 0 || strides == nullptr) {
    return cudaErrorInvalidValue;
  }
  const Strides st{strides[0],  strides[1],  strides[2],  strides[3],
                   strides[4],  strides[5],  strides[6],  strides[7],
                   strides[8],  strides[9],  strides[10], strides[11],
                   strides[12], strides[13], strides[14]};
  const Args a{x,  dt, Bm, Cm, dy, A, D, dx, ddt, dB, dC, dA, dD, states,
               dstates, dB_part, dC_part, dA_part, dD_part};
  switch (dtype) {
    case kF32:
      return dispatch_p<float>(a, B, S, H, G, P, N, st, s);
    case kBF16:
      return dispatch_p<__nv_bfloat16>(a, B, S, H, G, P, N, st, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* ssd_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
