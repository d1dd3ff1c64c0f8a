// Hopper (sm_90a) kernel for SODDA's inner loop (paper Algorithm 1, steps
// 13-17): B independent L-step SVRG chains, each on one m_tilde-wide
// parameter sub-block,
//
//     wbar <- wbar - gamma * [(l'(x_i . wbar, y_i) - l'(x_i . w0, y_i)) * x_i + mu]
//
// for hinge, logistic or squared loss.
//
// Replaces the TPU kernel `sodda_inner_pallas` in
// src/repro/kernels/sodda_inner.py (pallas_call at line 96, body `_kernel` at
// line 46). What it keeps from that kernel: w0, mu and wbar stay on chip for
// the whole chain, and the snapshot margins z0 = X . w0 are hoisted out of
// the chain (their derivatives d0 are computed once for all L rows).
//
// Design (simple and right first):
//   * one thread block of kThreads threads per chain b; the loss is a
//     template parameter;
//   * w0, mu and wbar live in dynamic shared memory (3 * mt floats, 14.4 KB
//     at mt = 1200), with d0 (L floats) and the reduction scratch beside
//     them; the wrapper refuses an mt whose footprint exceeds the 227 KB a
//     block may use;
//   * thread t owns the columns j = t, t + kThreads, ...: it reads a row of X
//     coalesced, keeps a private partial dot, and is the only thread that
//     reads or writes wbar[j], so wbar needs no barrier between steps;
//   * z1 = x_i . wbar is reduced by a warp shuffle and then by every thread
//     summing the per-warp partials in warp order. The order is fixed and
//     there are no atomics, so two launches give bitwise-equal results;
//   * rows of X stream from device memory (no shared-memory staging of X
//     tiles, which the TPU kernel needed for its VMEM double buffer).
//
// What bounds it on an H100: the bytes are small (at Table-1 shapes B = 15,
// L = 64, mt = 1200: about 4.83 MB in and out, about 1.4 us at 3.35 TB/s),
// and only 15 of the 132 SMs have work. The real floor is the latency of the
// L dependent block-wide reductions (one barrier, a global load and a shuffle
// tree per step). Splitting one chain over a thread-block cluster with a
// distributed-shared-memory reduction each step is the layout that would
// attack that latency.
//
// Built without --use_fast_math so that expf in the logistic derivative
// stays close to torch.sigmoid. Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum LossCode { kHinge = 0, kLogistic = 1, kSquared = 2 };

template <int LOSS>
__device__ __forceinline__ float loss_deriv(float z, float y) {
  if (LOSS == kHinge) {
    return (y * z < 1.0f) ? -y : 0.0f;
  } else if (LOSS == kLogistic) {
    const float a = -y * z;  // -y * sigmoid(-y z), sigmoid(a) = 1/(1+e^-a)
    return -y * (1.0f / (1.0f + expf(-a)));
  } else {
    return z - y;
  }
}

// Butterfly sum: every lane ends with the same, bitwise-identical total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

template <int LOSS>
__global__ void __launch_bounds__(kThreads)
sodda_inner_kernel(const float* __restrict__ w0, const float* __restrict__ X,
                   const float* __restrict__ y, const float* __restrict__ mu,
                   float gamma, float* __restrict__ out, int L, int mt) {
  extern __shared__ float smem[];
  float* s_w0 = smem;            // mt
  float* s_mu = s_w0 + mt;       // mt
  float* s_wbar = s_mu + mt;     // mt
  float* s_d0 = s_wbar + mt;     // L
  float* s_red = s_d0 + L;       // 2 * kWarps, double-buffered by step parity

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t b = blockIdx.x;
  const float* Xb = X + b * static_cast<size_t>(L) * mt;
  const float* yb = y + b * static_cast<size_t>(L);

  for (int j = tid; j < mt; j += kThreads) {
    const float w = w0[b * mt + j];
    s_w0[j] = w;
    s_wbar[j] = w;
    s_mu[j] = mu[b * mt + j];
  }
  __syncthreads();

  // Hoisted snapshot derivatives d0_i = l'(x_i . w0, y_i): one warp per row.
  for (int i = warp; i < L; i += kWarps) {
    const float* x = Xb + static_cast<size_t>(i) * mt;
    float s = 0.0f;
    for (int j = lane; j < mt; j += 32) s += x[j] * s_w0[j];
    s = warp_sum(s);
    if (lane == 0) s_d0[i] = loss_deriv<LOSS>(s, yb[i]);
  }
  __syncthreads();

  for (int i = 0; i < L; ++i) {
    const float* x = Xb + static_cast<size_t>(i) * mt;
    float part = 0.0f;
    for (int j = tid; j < mt; j += kThreads) part += x[j] * s_wbar[j];
    part = warp_sum(part);
    // Step i writes buffer i & 1; step i + 2 rewrites it only after every
    // thread has passed step i + 1's barrier, hence finished reading it.
    float* red = s_red + (i & 1) * kWarps;
    if (lane == 0) red[warp] = part;
    __syncthreads();
    float z1 = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) z1 += red[w];
    const float c = loss_deriv<LOSS>(z1, yb[i]) - s_d0[i];
    for (int j = tid; j < mt; j += kThreads) {
      s_wbar[j] -= gamma * (c * x[j] + s_mu[j]);
    }
  }

  for (int j = tid; j < mt; j += kThreads) out[b * mt + j] = s_wbar[j];
}

template <int LOSS>
cudaError_t launch(const float* w0, const float* X, const float* y,
                   const float* mu, float gamma, float* out, int B, int L,
                   int mt, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * static_cast<size_t>(mt) + L +
                                       2 * kWarps);
  cudaError_t err = cudaFuncSetAttribute(
      sodda_inner_kernel<LOSS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  sodda_inner_kernel<LOSS><<<B, kThreads, smem, stream>>>(w0, X, y, mu, gamma,
                                                          out, L, mt);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches B chains on `stream`; returns cudaGetLastError() of the launch
// (0 on success). Does not synchronise and allocates nothing.
int sodda_inner_f32(const void* w0, const void* X, const void* y,
                    const void* mu, float gamma, void* out, int B, int L,
                    int mt, int loss, void* stream) {
  const float* w0f = static_cast<const float*>(w0);
  const float* Xf = static_cast<const float*>(X);
  const float* yf = static_cast<const float*>(y);
  const float* muf = static_cast<const float*>(mu);
  float* outf = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (loss) {
    case kHinge:
      return launch<kHinge>(w0f, Xf, yf, muf, gamma, outf, B, L, mt, s);
    case kLogistic:
      return launch<kLogistic>(w0f, Xf, yf, muf, gamma, outf, B, L, mt, s);
    case kSquared:
      return launch<kSquared>(w0f, Xf, yf, muf, gamma, outf, B, L, mt, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* sodda_inner_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
