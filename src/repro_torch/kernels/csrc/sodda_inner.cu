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
// the whole chain, rows of X arrive ahead of the step that needs them, and
// the snapshot derivatives d0_i = l'(x_i . w0, y_i) are taken off the chain.
//
// What bounds it on an H100: not bytes (at Table-1 shapes B = 15, L = 64,
// mt = 1200 about 4.83 MB move, ~1.4 us at 3.35 TB/s) and not operations,
// but the latency of the L dependent steps of each chain: step i + 1 needs
// the wbar that step i wrote, and step i needs the dot x_i . wbar of all mt
// columns first. So the layout takes every barrier and every device-memory
// load off that chain.
//
// Layout: one block of four warps per chain (B blocks; at B = 15 only 15 of
// the 132 SMs have work, which a latency-bound chain cannot use anyway).
//   * warp 0 runs the chain. Lane l owns the float4 column groups
//     q = l, l + 32, ...: up to G groups a lane (the column bucket G, a
//     template parameter chosen from mt before launch: mt <= 128 G, G in
//     4, 8, 12, 16) keep wbar in registers for all L steps, and mu too up
//     to G = 12 (at G = 16 mu stays in shared memory: too few registers).
//     Above the largest bucket (mt > 2048, G = 0 here) wbar and mu live in
//     shared memory, each lane touching only its own groups, so they need
//     no barrier either. A step takes the partial dot of x_i (already in
//     registers) in a fixed column order (four accumulators, one per float4
//     lane, groups ascending), reduces it with a __shfl_xor butterfly
//     (every lane ends with the same z1), releases the slot, waits for
//     the next row's `ready` barrier (a helper arrives on it once it has
//     seen the row's `full` and written d0; the helpers run ahead) and
//     issues the row's loads from the ring into the other register set,
//     computes c = l'(z1, y_i) - d0_i, and updates wbar from the x_i
//     registers (the G = 0 path reads the slot again and loads no row
//     ahead). No block barrier and no device-memory load sit on the chain;
//     a step waits on a barrier only where a row or its d0 is late.
//   * warp 1 is the producer. Its lanes set up the barriers. It keeps L
//     rows flowing into a ring of `slots` row slots in shared memory (as
//     many as fit, at most 8 and at most L, even above 1: a deeper ring
//     lets all chains ask for most of X at once, which delays every
//     chain's first row), each guarded by three mbarriers: `full` (the row
//     and y_i arrived), `ready` (d0_i is written) and `empty` (the chain
//     and a helper have read the slot).
//     Where the row pitch mt * 4 is a multiple of 16 bytes and X is
//     16-byte aligned, one lane copies each row with cp.async.bulk (TMA's
//     bulk copy; 1200, 1400 and 1800 take it); otherwise all 32 lanes copy
//     it with 4-byte cp.async, each lane's copies tracked by the barrier
//     (cp.async.mbarrier.arrive.noinc). The choice is made on the host from
//     mt and X's address. y_i comes with the row: the lanes load 32 labels
//     a chunk ahead, and lane 0 stores y_i beside the slot and arrives on
//     `full` once the copy is under way.
//   * warps 2 and 3 are the d0 helpers: helper h takes the rows of the
//     slots of parity h (the ring holds an even number of slots, or one
//     slot and one helper), so a helper waits on a slot's barrier only
//     after it waited on that slot's previous phase itself. It waits for
//     `full`, computes d0_i from the slot with w0 in registers (G = 0: w0
//     read from device memory) in the chain's reduction order, stores it
//     beside the slot and arrives on `ready` and `empty`.
//   * every warp passes the block's one barrier once, after its prologue
//     (barrier set-up, the loads of w0, mu and the first labels), so those
//     overlap;
//   * rows are padded to a multiple of 4 floats in the ring; the pad is
//     zeroed once, and registers of columns past mt hold zeros, so no step
//     masks a column.
// Launches are bitwise repeatable: every sum has one fixed order, and there
// are no atomics.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, (15, 64, 1200) hinge:
// 0.0207 ms a launch (CUDA graph of launches; the one-block-per-chain
// kernel it replaces took 0.0892 ms), 14x the 0.00144 ms bound. A step
// takes ~644 cycles (tools/sodda_inner_phases.py, clock64 marks): the
// butterfly 156, the issue of the next row's loads 122, the dot 110, the
// 96-FMA axpy 109, the wait for the next row's `ready` 79, the release 34
// and the loss 34. So one warp's dependent chain, not memory, sets the
// time; the first row arrives after ~2400 cycles.
//
// Built without --use_fast_math so that expf in the logistic derivative
// stays close to torch.sigmoid. Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kWarps = 4;  // the chain, the producer and two d0 helpers
constexpr int kThreads = 32 * kWarps;
constexpr int kHelpers = kWarps - 2;
constexpr int kMaxSlots = 8;  // deeper rings only delay the first row
constexpr int kBudget = 232448;   // shared memory one block may use (227 KB)
constexpr int kSlotExtra = 32;    // three mbarriers and (d0_i, y_i) a slot
constexpr int kMaxBucket = 16;    // float4 groups a lane: mt <= 2048
constexpr int kMuBucket = 12;     // mu in registers up to this bucket

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

__device__ __forceinline__ void fma4(float4& acc, float4 a, float4 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.y = fmaf(a.y, b.y, acc.y);
  acc.z = fmaf(a.z, b.z, acc.z);
  acc.w = fmaf(a.w, b.w, acc.w);
}

__device__ __forceinline__ float sum4(float4 a) {
  return (a.x + a.y) + (a.z + a.w);
}

// wbar <- wbar - gamma * (c * x + mu), one float4 group.
__device__ __forceinline__ void axpy4(float4& w, float4 x, float4 m, float c,
                                      float gamma) {
  w.x -= gamma * (c * x.x + m.x);
  w.y -= gamma * (c * x.y + m.y);
  w.z -= gamma * (c * x.z + m.z);
  w.w -= gamma * (c * x.w + m.w);
}

// Columns 4q .. 4q + 3 of a device row of mt floats, zeros past mt (rows
// of w0 and mu are only 4-byte aligned when mt % 4 != 0).
__device__ __forceinline__ float4 load4(const float* row, int q, int mt) {
  const int j = 4 * q;
  return make_float4(j < mt ? row[j] : 0.0f, j + 1 < mt ? row[j + 1] : 0.0f,
                     j + 2 < mt ? row[j + 2] : 0.0f,
                     j + 3 < mt ? row[j + 3] : 0.0f);
}

__device__ __forceinline__ void store4(float* row, int q, int mt, float4 v) {
  const int j = 4 * q;
  if (j < mt) row[j] = v.x;
  if (j + 1 < mt) row[j + 1] = v.y;
  if (j + 2 < mt) row[j + 2] = v.z;
  if (j + 3 < mt) row[j + 3] = v.w;
}

// ---------------------------------------------------------------------------
// mbarriers and asynchronous copies in PTX
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
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

// TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// ---------------------------------------------------------------------------
// The block's shared memory: per slot the barriers full, ready, empty and
// the pair (d0_i, y_i); then mu (G = 0 and the largest bucket), wbar
// (G = 0); then the ring.
// ---------------------------------------------------------------------------
struct Smem {
  uint32_t full, ready, empty;  // shared addresses of barrier 0 of each kind
  float2* meta;                 // (d0_i, y_i) of each slot
  float4* mu;                   // G = 0 and G = kMaxBucket only
  float4* wbar;                 // G = 0 only
  float* ring;                  // slots x pitch floats
};

__host__ __device__ constexpr int smem_rows(int G) {  // mu and wbar rows
  return G == 0 ? 2 : (G > kMuBucket ? 1 : 0);
}

template <int G>
__device__ __forceinline__ Smem carve(unsigned char* base, int slots,
                                      int pitch) {
  Smem s;
  s.full = smem_u32(base);
  s.ready = s.full + 8 * slots;
  s.empty = s.ready + 8 * slots;
  s.meta = reinterpret_cast<float2*>(base + 24 * slots);
  float* rest = reinterpret_cast<float*>(base + kSlotExtra * slots);
  s.mu = reinterpret_cast<float4*>(rest);
  s.wbar = reinterpret_cast<float4*>(rest + pitch);
  s.ring = rest + smem_rows(G) * pitch;
  return s;
}

// Slot `slot`'s row as float4 groups.
__device__ __forceinline__ const float4* row4(const Smem& s, int slot,
                                              int pitch) {
  return reinterpret_cast<const float4*>(s.ring +
                                         static_cast<size_t>(slot) * pitch);
}

// Lane `lane`'s groups q = lane + 32 g of a row, zeros past the row.
template <int G>
__device__ __forceinline__ void load_row(const float4* x4, int nq, int lane,
                                         float4 (&x)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int q = lane + 32 * g;
    x[g] = q < nq ? x4[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// A lane's partial dot in the fixed order: one accumulator per float4
// lane, groups ascending.
template <int G>
__device__ __forceinline__ float4 dot4(const float4 (&x)[G],
                                       const float4 (&v)[G]) {
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int g = 0; g < G; ++g) fma4(acc, x[g], v[g]);
  return acc;
}

// The block's one barrier: every warp passes it once, after its own
// prologue and before its loop (the roles reach it from different lines).
__device__ __forceinline__ void block_barrier() {
  asm volatile("bar.sync 0, %0;\n" ::"n"(kThreads) : "memory");
}

// The next ring position `step` slots on; `phase` flips at each wrap.
__device__ __forceinline__ void advance(int& slot, uint32_t& phase, int step,
                                        int slots) {
  slot += step;
  if (slot >= slots) {
    slot -= slots;
    phase ^= 1u;
  }
}

// ---------------------------------------------------------------------------
// The three roles
// ---------------------------------------------------------------------------
__device__ __forceinline__ void producer(const Smem& s, const float* Xb,
                                         const float* yb, int L, int mt,
                                         int slots, int pitch, bool bulk,
                                         int lane) {
  if (lane < slots) {  // lane k sets up slot k's barriers
    // bulk: the copy's expect_tx and y_i; cp.async: 32 lanes and y_i
    mbar_init(s.full + 8 * lane, bulk ? 2 : 33);
    mbar_init(s.ready + 8 * lane, 1);
    mbar_init(s.empty + 8 * lane, 2);  // the chain and one helper
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The pad columns [mt, pitch) of every slot: no copy writes them.
  const int pad = pitch - mt;
  for (int k = lane; k < slots * pad; k += 32) {
    s.ring[(k / pad) * pitch + mt + k % pad] = 0.0f;
  }
  // y of rows lane, 32 + lane, ... one chunk of 32 at a time; each chunk
  // is loaded a whole chunk before it is needed.
  float ychunk = lane < L ? yb[lane] : 0.0f;
  float ynext = 32 + lane < L ? yb[32 + lane] : 0.0f;
  block_barrier();

  int slot = 0;
  uint32_t phase = 0;
  for (int i = 0; i < L; ++i) {
    if (i > 0 && (i & 31) == 0) {
      ychunk = ynext;
      ynext = i + 32 + lane < L ? yb[i + 32 + lane] : 0.0f;
    }
    const uint32_t full = s.full + 8 * slot;
    mbar_wait(s.empty + 8 * slot, phase ^ 1u);  // the first use passes
    float* dst = s.ring + static_cast<size_t>(slot) * pitch;
    const float* src = Xb + static_cast<size_t>(i) * mt;
    if (bulk) {
      if (lane == 0) {
        mbar_expect_tx(full, 4u * mt);
        bulk_copy(smem_u32(dst), src, 4u * mt, full);
      }
    } else {
      for (int j = lane; j < mt; j += 32) cp_async4(smem_u32(dst + j), src + j);
      cp_async_arrive(full);
    }
    // y_i after the copy is under way, so its load never delays a row
    const float yi = __shfl_sync(0xffffffffu, ychunk, i & 31);
    if (lane == 0) {
      s.meta[slot].y = yi;
      mbar_arrive(full);  // releases the y_i store
    }
    advance(slot, phase, 1, slots);
  }
}

template <int LOSS, int G>
__device__ __forceinline__ void helper(const Smem& s, const float* w0b,
                                       int h, int L, int mt, int slots,
                                       int pitch, int lane) {
  const int helpers = slots > 1 ? kHelpers : 1;
  const int nq = pitch / 4;
  float4 w[G > 0 ? G : 1], x[G > 0 ? G : 1];
  if constexpr (G > 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) w[g] = load4(w0b, lane + 32 * g, mt);
  }
  block_barrier();
  if (h >= helpers) return;

  int slot = h;
  uint32_t phase = 0;
  for (int i = h; i < L; i += helpers) {
    mbar_wait(s.full + 8 * slot, phase);
    const float4* x4 = row4(s, slot, pitch);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if constexpr (G > 0) {
      load_row<G>(x4, nq, lane, x);
      acc = dot4<G>(x, w);
    } else {
      for (int q = lane; q < nq; q += 32) fma4(acc, x4[q], load4(w0b, q, mt));
    }
    const float z0 = warp_sum(sum4(acc));
    const float yi = s.meta[slot].y;
    __syncwarp();
    if (lane == 0) {
      s.meta[slot].x = loss_deriv<LOSS>(z0, yi);
      mbar_arrive(s.ready + 8 * slot);  // releases d0_i
      mbar_arrive(s.empty + 8 * slot);
    }
    advance(slot, phase, helpers, slots);
  }
}

// The chain with wbar in registers. A step waits for the next row's `ready`
// (the helper arrives on it after it waited for the row's `full`, so the
// row and d0 are both there) and issues the row's loads before the axpy, so
// the next dot finds x_{i+1} in registers; x alternates between two
// register sets (steps come in pairs). Waiting for that row earlier, before
// the dot, measured slower: the wait then finds it late more often.
template <int LOSS, int G>
__device__ __forceinline__ void chain_regs(const Smem& s, const float* w0b,
                                           const float* mub, float* outb,
                                           float gamma, int L, int mt,
                                           int slots, int pitch, int lane) {
  constexpr bool kMuRegs = G <= kMuBucket;
  const int nq = pitch / 4;
  float4 w[G], m[kMuRegs ? G : 1], xa[G], xb[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int q = lane + 32 * g;
    w[g] = load4(w0b, q, mt);
    if constexpr (kMuRegs) {
      m[g] = load4(mub, q, mt);
    } else if (q < nq) {
      s.mu[q] = load4(mub, q, mt);  // read back by this lane only
    }
  }
  block_barrier();

  int slot = 0;
  uint32_t phase = 0;
  if (L > 0) {
    mbar_wait(s.ready, 0);
    load_row<G>(row4(s, 0, pitch), nq, lane, xa);
  }
  auto step = [&](int i, const float4(&x)[G], float4(&xn)[G]) {
    const float4 acc = dot4<G>(x, w);
    const float z1 = warp_sum(sum4(acc));
    const float2 dy = s.meta[slot];
    __syncwarp();
    if (lane == 0) mbar_arrive(s.empty + 8 * slot);  // x_i is in registers
    advance(slot, phase, 1, slots);
    if (i + 1 < L) {
      mbar_wait(s.ready + 8 * slot, phase);  // row i + 1 and its d0
      load_row<G>(row4(s, slot, pitch), nq, lane, xn);
    }
    const float c = loss_deriv<LOSS>(z1, dy.y) - dy.x;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int q = lane + 32 * g;
      float4 mg;
      if constexpr (kMuRegs) {
        mg = m[g];
      } else {
        mg = q < nq ? s.mu[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      axpy4(w[g], x[g], mg, c, gamma);
    }
  };
  for (int i = 0; i < L; i += 2) {
    step(i, xa, xb);
    if (i + 1 < L) step(i + 1, xb, xa);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) store4(outb, lane + 32 * g, mt, w[g]);
}

// The chain with wbar and mu in shared memory (mt above the buckets): each
// lane reads and writes only its own groups; the axpy reads the slot again.
template <int LOSS>
__device__ __forceinline__ void chain_smem(const Smem& s, const float* w0b,
                                           const float* mub, float* outb,
                                           float gamma, int L, int mt,
                                           int slots, int pitch, int lane) {
  const int nq = pitch / 4;
  for (int q = lane; q < nq; q += 32) {
    s.wbar[q] = load4(w0b, q, mt);
    s.mu[q] = load4(mub, q, mt);
  }
  block_barrier();

  int slot = 0;
  uint32_t phase = 0;
  for (int i = 0; i < L; ++i) {
    mbar_wait(s.full + 8 * slot, phase);
    const float4* x4 = row4(s, slot, pitch);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int q = lane; q < nq; q += 32) fma4(acc, x4[q], s.wbar[q]);
    const float z1 = warp_sum(sum4(acc));
    mbar_wait(s.ready + 8 * slot, phase);
    const float2 dy = s.meta[slot];
    const float c = loss_deriv<LOSS>(z1, dy.y) - dy.x;
    for (int q = lane; q < nq; q += 32) {
      float4 w = s.wbar[q];
      axpy4(w, x4[q], s.mu[q], c, gamma);
      s.wbar[q] = w;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(s.empty + 8 * slot);
    advance(slot, phase, 1, slots);
  }
  for (int q = lane; q < nq; q += 32) store4(outb, q, mt, s.wbar[q]);
}

template <int LOSS, int G>
__global__ void __launch_bounds__(kThreads, 1)
sodda_inner_kernel(const float* __restrict__ w0, const float* __restrict__ X,
                   const float* __restrict__ y, const float* __restrict__ mu,
                   float gamma, float* __restrict__ out, int L, int mt,
                   int slots, int bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = (mt + 3) & ~3;
  const Smem s = carve<G>(smem, slots, pitch);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t b = blockIdx.x;
  if (warp == 0) {
    if constexpr (G > 0) {
      chain_regs<LOSS, G>(s, w0 + b * mt, mu + b * mt, out + b * mt, gamma,
                          L, mt, slots, pitch, lane);
    } else {
      chain_smem<LOSS>(s, w0 + b * mt, mu + b * mt, out + b * mt, gamma, L,
                       mt, slots, pitch, lane);
    }
  } else if (warp == 1) {
    producer(s, X + b * L * mt, y + b * L, L, mt, slots, pitch, bulk != 0,
             lane);
  } else {
    helper<LOSS, G>(s, w0 + b * mt, warp - 2, L, mt, slots, pitch, lane);
  }
}

// ---------------------------------------------------------------------------
// Host side: the layout (mirrored by kernels/sodda_inner.py) and the launch
// ---------------------------------------------------------------------------
int pitch_of(int mt) { return (mt + 3) & ~3; }

// float4 groups a lane holds in registers; 0: wbar and mu in shared memory
int bucket_of(int mt) {
  const int groups = (mt + 127) / 128;
  for (int g : {4, 8, 12, kMaxBucket})
    if (groups <= g) return g;
  return 0;
}

size_t fixed_bytes(int mt) {
  return smem_rows(bucket_of(mt)) * 4 * static_cast<size_t>(pitch_of(mt));
}

int slots_of(int L, int mt) {
  const size_t per_slot = 4 * static_cast<size_t>(pitch_of(mt)) + kSlotExtra;
  const size_t fixed = fixed_bytes(mt);
  const size_t fit = fixed >= kBudget ? 0 : (kBudget - fixed) / per_slot;
  const size_t want = L < 1 ? 1 : (L < kMaxSlots ? L : kMaxSlots);
  const int slots = static_cast<int>(fit < want ? fit : want);
  return slots > 1 ? slots & ~1 : slots;  // even: each helper its parity
}

template <int LOSS, int G>
cudaError_t launch(const float* w0, const float* X, const float* y,
                   const float* mu, float gamma, float* out, int B, int L,
                   int mt, cudaStream_t stream) {
  // Set once per instantiation, so that a launch captured in a CUDA graph
  // makes no attribute call.
  static const cudaError_t attr = cudaFuncSetAttribute(
      sodda_inner_kernel<LOSS, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBudget);
  if (attr != cudaSuccess) return attr;
  const int slots = slots_of(L, mt);
  if (slots < 1) return cudaErrorInvalidValue;
  const size_t smem = fixed_bytes(mt) +
                      slots * (4 * static_cast<size_t>(pitch_of(mt)) + kSlotExtra);
  const int bulk = mt % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;
  sodda_inner_kernel<LOSS, G><<<B, kThreads, smem, stream>>>(
      w0, X, y, mu, gamma, out, L, mt, slots, bulk);
  return cudaGetLastError();
}

template <int LOSS>
cudaError_t launch_bucket(const float* w0, const float* X, const float* y,
                          const float* mu, float gamma, float* out, int B,
                          int L, int mt, cudaStream_t stream) {
  switch (bucket_of(mt)) {
    case 4:
      return launch<LOSS, 4>(w0, X, y, mu, gamma, out, B, L, mt, stream);
    case 8:
      return launch<LOSS, 8>(w0, X, y, mu, gamma, out, B, L, mt, stream);
    case 12:
      return launch<LOSS, 12>(w0, X, y, mu, gamma, out, B, L, mt, stream);
    case kMaxBucket:
      return launch<LOSS, kMaxBucket>(w0, X, y, mu, gamma, out, B, L, mt,
                                      stream);
    default:
      return launch<LOSS, 0>(w0, X, y, mu, gamma, out, B, L, mt, stream);
  }
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
      return launch_bucket<kHinge>(w0f, Xf, yf, muf, gamma, outf, B, L, mt, s);
    case kLogistic:
      return launch_bucket<kLogistic>(w0f, Xf, yf, muf, gamma, outf, B, L, mt,
                                      s);
    case kSquared:
      return launch_bucket<kSquared>(w0f, Xf, yf, muf, gamma, outf, B, L, mt,
                                     s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* sodda_inner_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
