// Hopper (sm_90a) building blocks in PTX for the port's tensor-core kernels:
// mbarriers, TMA tile loads, wgmma shared-memory descriptors and products,
// the bf16 operand splits that let f32 data go through the bf16 tensor
// cores, and what flash attention's two f32 tensor-core kernels share (the
// mask, a branch-free tanh, the f32 and bf16 piece tiles' layouts, the
// split score product). Included by flash_attention.cu (the f32 forward)
// and flash_attention_bwd.cu; the other sources still keep copies of their
// own (ROADMAP B10). kernels/build.py hashes this header with every source,
// so an edit here rebuilds every library.
//
// Everything is in an anonymous namespace: each source that includes the
// header gets its own copy, as with the copies it replaces.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// mbarriers and TMA
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

// Make barrier initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One TMA box of a 4-D tensor, coordinates innermost first, completing on
// the mbarrier `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// Make this thread's shared-memory writes visible to wgmma's (and TMA's)
// reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barriers: `bar_sync` waits until `count` threads have arrived at
// barrier `id` (itself among them); `bar_arrive` arrives without waiting,
// after a release fence that orders this thread's earlier shared-memory
// writes before the threads that wait on the barrier read them.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("fence.acq_rel.cta;\n" ::: "memory");
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// `v` as a value the compiler cannot see through: a descriptor built from
// it is computed where it is used, not hoisted out of a loop (hoisted
// descriptors hold registers that the products need, and spill).
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

// ---------------------------------------------------------------------------
// swizzled tiles and wgmma descriptors
// ---------------------------------------------------------------------------
// wgmma descriptor code of a swizzle: 128, 64 or 32 bytes a row
__host__ __device__ constexpr uint64_t layout_code(int row_bytes) {
  return row_bytes == 128 ? 1 : (row_bytes == 64 ? 2 : 3);
}

// Byte offset inside a tile whose rows are `RowBytes` long, swizzled as TMA
// writes it and wgmma reads it: the 16-byte chunk index is XORed with the
// row's position in the swizzle's repeat (the tile starts 1024-aligned).
template <int RowBytes>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  constexpr uint32_t mask =
      RowBytes == 128 ? 0x70 : (RowBytes == 64 ? 0x30 : 0x10);
  return off ^ ((off >> 3) & mask);
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (in 16-byte units) and the swizzle code.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
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

// D (64 x n, f32) = A . B [+ D] over 16 of the contraction: scale_d 0
// ignores D's old value (the first product into a fresh accumulator, which
// then needs no zeroing and takes the registers its last use freed), 1 adds
// to it. ss: A and B bf16 in shared memory, K-major; rs: A bf16 in registers
// in the accumulator-compatible fragment, a[0..3], TB the transpose flag of
// B (1: MN-major).
__device__ __forceinline__ void wgmma_ss64(float* d, uint64_t da, uint64_t db,
                                           int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs16(float* d, const uint32_t* a, uint64_t db,
                                           int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs32(float* d, const uint32_t* a, uint64_t db,
                                           int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs64(float* d, const uint32_t* a, uint64_t db,
                                           int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs48(float* d, const uint32_t* a, uint64_t db,
                                           int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs96(float* d, const uint32_t* a, uint64_t db,
                                           int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int NN, int TB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db,
                                         int scale_d = 1) {
  if constexpr (NN == 16) {
    wgmma_rs16<TB>(d, a, db, scale_d);
  } else if constexpr (NN == 32) {
    wgmma_rs32<TB>(d, a, db, scale_d);
  } else if constexpr (NN == 48) {
    wgmma_rs48<TB>(d, a, db, scale_d);
  } else if constexpr (NN == 96) {
    wgmma_rs96<TB>(d, a, db, scale_d);
  } else {
    static_assert(NN == 64, "n16, n32, n48, n64 or n96");
    wgmma_rs64<TB>(d, a, db, scale_d);
  }
}

// ---------------------------------------------------------------------------
// bf16 operands of f32 values
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));  // lo in the low half
}

// v0, v1 split into two bf16 halves each, packed in pairs (v0 in the low
// half): hi = bf16(v), lo = bf16(v - hi), v - hi exact in f32.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& p0,
                                       uint32_t& p1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  p0 = bits(h);
  p1 = pack_bf16(v0 - hf.x, v1 - hf.y);
}

// v0, v1 split into three bf16 pieces each, packed in pairs (v0 in the low
// half) as the A fragment and the tiles take them: p0 = bf16(v), p1 =
// bf16(v - p0), p2 = bf16(v - p0 - p1), each residual exact in f32, so the
// three hold v exactly.
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& p0,
                                       uint32_t& p1, uint32_t& p2) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = v0 - hf.x, r1 = v1 - hf.y;  // exact
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  p0 = bits(h);
  p1 = bits(m);
  p2 = pack_bf16(r0 - mf.x, r1 - mf.y);
}

// The piece products of A . B, A in NA pieces and B in NB: calls f(a, b)
// for each pair with a + b <= 2, a < NA and b < NB, the smallest first, so
// that the f32 accumulator takes the small terms before the large ones
// have grown it.
template <int NA, int NB, typename F>
__device__ __forceinline__ void for_pairs(F f) {
  if constexpr (NA > 2 && NB > 0) f(2, 0);
  if constexpr (NA > 1 && NB > 1) f(1, 1);
  if constexpr (NA > 0 && NB > 2) f(0, 2);
  if constexpr (NA > 1 && NB > 0) f(1, 0);
  if constexpr (NA > 0 && NB > 1) f(0, 1);
  f(0, 0);
}

// ---------------------------------------------------------------------------
// flash attention's f32 tensor-core kernels: the mask, tanh, the piece tiles
// ---------------------------------------------------------------------------
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

// tanh in f32 without a branch (tanhf branches on |y|, and a branch in each
// score's step keeps the compiler from interleaving the scores): below
// |y| = 0.55 the odd Taylor polynomial to y^17 (the first term left out is
// under 3e-9), above it 1 - 2 / (exp(2 |y|) + 1) with y's sign; both are
// formed and one taken. Within a few f32 ulp of tanh.
__device__ __forceinline__ float tanh_f32(float y) {
  const float a = fabsf(y);
  const float s = y * y;
  float c = 5.90027440e-4f;    //  6404582 / 10854718875
  c = fmaf(c, s, -1.45583439e-3f);  // -929569 / 638512875
  c = fmaf(c, s, 3.59212804e-3f);   //  21844 / 6081075
  c = fmaf(c, s, -8.86323553e-3f);  // -1382 / 155925
  c = fmaf(c, s, 2.18694885e-2f);   //  62 / 2835
  c = fmaf(c, s, -5.39682540e-2f);  // -17 / 315
  c = fmaf(c, s, 1.33333333e-1f);   //  2 / 15
  c = fmaf(c, s, -3.33333333e-1f);  // -1 / 3
  const float small = fmaf(y * s, c, y);
  const float large = copysignf(1.0f - __fdividef(2.0f, expf(2.0f * a) + 1.0f), y);
  return a < 0.55f ? small : large;
}

// x = scale s, capped (softcap tanh(x / softcap)) when kCap, and g = 1 - t^2
// its derivative's factor (1 without a cap).
template <bool kCap>
__device__ __forceinline__ float capped(float s, float scale, float softcap,
                                        float inv_cap, float& g) {
  const float x = s * scale;
  if constexpr (kCap) {
    const float u = tanh_f32(x * inv_cap);
    g = 1.0f - u * u;
    return softcap * u;
  }
  g = 1.0f;
  return x;
}

// Calls body(cap, mask) with std::bool_constant flags for whether the scores
// are capped and whether this tile's entries are tested against the mask,
// so that each score's step carries no branch.
template <typename F>
__device__ __forceinline__ void with_flags(bool cap, bool mask, F body) {
  if (cap) {
    if (mask) body(std::true_type{}, std::true_type{});
    else body(std::true_type{}, std::false_type{});
  } else {
    if (mask) body(std::false_type{}, std::true_type{});
    else body(std::false_type{}, std::false_type{});
  }
}

// body(r) for the score entries r in [R0, R1), G at a time: each group's
// values are fenced before and after it (v: the values the steps work on),
// so the compiler interleaves the steps of a group but not of the next, and
// the group's temporaries are what the registers must hold beside the
// carried gradient. G = R1 - R0 leaves the whole range to the compiler.
template <int R0, int R1, int G, typename F>
__device__ __forceinline__ void in_groups(float* v, F body) {
#pragma unroll
  for (int g = R0; g < R1; g += G) {
    fence_regs<G>(v + g);
#pragma unroll
    for (int r = g; r < g + G; ++r) body(r);
    fence_regs<G>(v + g);
  }
}

// Whether a tile of query rows [q0, q0 + nq) and keys [k0, k0 + nk) has
// an entry that the mask hides or that lies past Sq or Sk; only such tiles
// test their entries one by one.
__device__ __forceinline__ bool tile_masked(int q0, int nq, int k0, int nk,
                                            int Sq, int Sk, int q_offset,
                                            int causal, int window) {
  return q0 + nq > Sq || k0 + nk > Sk ||
         (causal && k0 + nk - 1 > q_offset + q0) ||
         (window > 0 && q_offset + q0 + nq - 1 - k0 >= window);
}

// Byte offset of element (r, c) of an f32 tile as TMA writes it.
template <int Rows, int L>
__device__ __forceinline__ uint32_t foff(int r, int c) {
  constexpr int E = L < 32 ? L : 32;
  constexpr int RB = 4 * E;
  return (c / E) * (Rows * RB) + swz<RB>(r * RB + (c % E) * 4);
}

// f32's piece tiles of a streamed tile: in each column block of kE
// columns, the three pieces' BN-row slabs one after the other, so that a
// K-major read of 16 BN rows from piece 0 takes pieces 0.. (stacked along
// N) in one product. Byte offset of element (r, c) of piece k:
template <int BN, int L>
__device__ __forceinline__ uint32_t poff(int k, int r, int c) {
  constexpr int E = L < 64 ? L : 64;
  constexpr int RB = 2 * E;
  return (c / E) * (3 * BN * RB) + k * (BN * RB) + swz<RB>(r * RB + (c % E) * 2);
}

// The stacked pieces' operand of k-step ks, K-major (rows: the N index).
template <int BN, int L>
__device__ __forceinline__ uint64_t pdesc(uint32_t pieces, int ks) {
  constexpr int E = L < 64 ? L : 64;
  constexpr int RB = 2 * E;
  return smem_desc(pieces + (16 * ks / E) * (3 * BN * RB) + (16 * ks % E) * 2,
                   16, 8 * RB, layout_code(RB));
}

// Piece k's operand of k-step kk read MN-major: its rows 16kk.., column
// block cb.
template <int BN, int L>
__device__ __forceinline__ uint64_t pmdesc(uint32_t pieces, int k, int cb,
                                           int kk) {
  constexpr int E = L < 64 ? L : 64;
  constexpr int RB = 2 * E;
  return smem_desc(pieces + cb * (3 * BN * RB) + k * (BN * RB) + kk * 16 * RB,
                   3 * BN * RB, 8 * RB, layout_code(RB));
}

// f32: kBN rows of L values at `raw` (TMA's layout) into their three
// bf16 pieces at `pieces` (poff's layout), by the 128 threads of one
// warpgroup.
template <int BN, int L>
__device__ __forceinline__ void to_pieces(const uint8_t* raw, uint8_t* pieces,
                                          int t) {
  constexpr int kUnits = BN * L / 4;
#pragma unroll 4
  for (int u = t; u < kUnits; u += 128) {
    const int r = u / (L / 4);
    const int c = (u % (L / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(raw + foff<BN, L>(r, c));
    uint32_t lo[3], hi[3];
    split3(v.x, v.y, lo[0], lo[1], lo[2]);
    split3(v.z, v.w, hi[0], hi[1], hi[2]);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      *reinterpret_cast<uint2*>(pieces + poff<BN, L>(k, r, c)) = make_uint2(lo[k], hi[k]);
  }
}

// acc (64 x BN, f32) = A . B^T over L columns, on the bf16 tensor cores:
// A a 64-row f32 tile as TMA writes it (generic address `a_g`, foff's
// layout), B the three bf16 piece tiles of BN rows at `pieces` (poff's
// layout), both K-major. A's piece a times B's pieces 0..2 - a, stacked
// along N, in one product each: acc0 = A0 [B0 B1 B2], acc1 = A1 [B0 B1],
// acc2 = A2 B0, so that each of the six piece products has its own columns
// (the truncating tensor-core sums never mix a small one into the large
// one). A is split from the f32 tile kKG k-steps at a time (two from D =
// 128 on, for registers: four spill at 256, and run slower at 128), whose
// 3 kKG products go out as one group (the thread's coordinates opaque, so
// that its fragment offsets are formed where used rather than held across
// items). The first product into each accumulator ignores its old value.
template <int BN, int L>
__device__ __forceinline__ void split_scores(float* acc, const uint8_t* a_g,
                                             uint32_t pieces) {
  constexpr int kKG = L >= 128 ? 2 : (L / 16 < 4 ? L / 16 : 4);
  constexpr int H = BN / 2;  // entries of one piece product
  float acc0[3 * H], acc1[2 * H], acc2[H];
  const int t = static_cast<int>(opaque(threadIdx.x)) % 128;
  const int r0 = 16 * (t / 32) + (t % 32) / 4;
  const int qd = t % 4;
#pragma unroll
  for (int k0 = 0; k0 < L / 16; k0 += kKG) {
    uint32_t f[kKG][3][4];
#pragma unroll
    for (int kk = 0; kk < kKG; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = r0 + 8 * (q & 1);
        const int col = 16 * (k0 + kk) + 2 * qd + 8 * (q >> 1);
        const float2 v = *reinterpret_cast<const float2*>(
            a_g + foff<64, L>(row, col));
        split3(v.x, v.y, f[kk][0][q], f[kk][1][q], f[kk][2][q]);
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKG; ++kk) {
      const int ks = k0 + kk;
      wgmma_rs<BN, 0>(acc2, f[kk][2], pdesc<BN, L>(opaque(pieces), ks), ks > 0);
      wgmma_rs<2 * BN, 0>(acc1, f[kk][1], pdesc<BN, L>(opaque(pieces), ks), ks > 0);
      wgmma_rs<3 * BN, 0>(acc0, f[kk][0], pdesc<BN, L>(opaque(pieces), ks), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();  // the fragments are free for the next group
  }
  fence_regs<3 * H>(acc0);
  fence_regs<2 * H>(acc1);
  fence_regs<H>(acc2);
  // the pieces' columns of an entry: piece b's entry r is at b H + r
  // (a column block of BN is BN / 8 groups of 8); the small ones summed
  // smallest first, then the large one
#pragma unroll
  for (int r = 0; r < H; ++r)
    acc[r] = acc0[r] + ((((acc2[r] + acc1[H + r]) + acc0[2 * H + r]) + acc1[r]) +
                        acc0[H + r]);
}

// ---------------------------------------------------------------------------
// host: TMA descriptors, encoded through the runtime's driver entry point so
// that the library does not link libcuda
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
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

// A TMA descriptor for one (B, S, NH, DT) tensor, f32 or bf16: boxes of
// `rows` rows of one head and `box_e` columns, swizzled to the box's row
// bytes (32, 64 or 128) as the kernels read them. Where a row's last box
// runs past DT (DT 96 and 112 in the 128 layout), TMA fills those columns
// with zeros, as it fills rows past S.
inline cudaError_t encode_heads(CUtensorMap* map, const void* ptr, bool f32,
                                int B, int S, int NH, int DT, int box_e,
                                int rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t e = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(DT),
                              static_cast<cuuint64_t>(NH),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(DT) * e,
                                 static_cast<cuuint64_t>(NH) * DT * e,
                                 static_cast<cuuint64_t>(S) * NH * DT * e};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_e), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const cuuint64_t box_rb = box_e * e;
  const CUtensorMapSwizzle sw =
      box_rb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                    : (box_rb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                    : CU_TENSOR_MAP_SWIZZLE_32B);
  const CUresult rc = fn(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
