// The TMA + wgmma ring shared by gemm_wgmma.cu (B1's tensor-core route),
// bell_wgmma.cu (B6a's, both kernels) and gemm_tf32x3.cu (the 3xTF32 product
// of f32 operands), and the 3xTF32 stage of dx_comp.cu (B8c) and dx_fused.cu
// (B9): mbarriers, TMA loads, tensor-map encoding, wgmma's shared-memory
// descriptors, fences and instructions, the consumers' main loops, the
// staging of a finished tile in shared memory, and B1's fused epilogue over
// it (gemm_wgmma.cu's and gemm_tf32x3.cu's).
//
// The ring. A block of 384 threads: warpgroup 0 is the producer, whose one
// thread keeps TMA loads in flight into STAGES stages of (128 rows of A, BN
// rows of B) by one 128-byte swizzle row of k each (64 16-bit values, or 32
// f32 ones), PLANES such pairs a stage (2 for 3xTF32: the hi and lo planes),
// each stage with a full and an empty mbarrier; warpgroups 1 and 2 are the
// consumers, each issuing wgmma over its 64 rows into BN / 2 f32
// accumulators a thread (m64nBNk16 for 16-bit operands, m64nBNk8 for
// TF32). Every box lands with the 128-byte swizzle as rows of 128 bytes, in
// 1024-byte groups of 8 rows, and the descriptors read the same layout: a
// K-major operand is one box of (a row of k) x rows, a k step (k16 of 16-bit
// values, k8 of TF32) 32 bytes along its rows; an M- or N-major one
// (wgmma's transpose bits, 16-bit types only) is boxes of 64 k rows x 64
// columns placed kBox bytes apart (the descriptor's leading byte offset), a
// k16 step 16 rows, 2048 bytes. The stride byte offset is 1024 (8 rows) in
// both.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

namespace tml_ring {

constexpr int kBM = 128;             // rows of a block tile: two consumer warpgroups of 64
constexpr uint32_t kRowBytes = 128;  // k of a stage: one 128-byte swizzle row
constexpr int kBK = 64;              // ... of 16-bit values
constexpr int kBK32 = 32;            // ... of f32 (TF32) values
constexpr int kThreads = 384;        // the producer warpgroup and two consumers
constexpr uint32_t kBox = 64 * 128;  // bytes of one 64 x 64 box of 16-bit values (64 rows)
constexpr uint32_t kABytes = kBM * kRowBytes;  // A's part of a stage, one plane

// Bytes of one stage of PLANES (A, B) pairs, and of the dynamic shared
// memory a block of STAGES asks for (+ the ring's 1024-byte alignment).
template <int BN, int PLANES = 1>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return PLANES * (kABytes + BN * kRowBytes);
}
template <int BN, int STAGES, int PLANES = 1>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * static_cast<int>(stage_bytes<BN, PLANES>()) + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the phase of the given parity has completed. A phase that
// does not complete in 2^26 tries (seconds) is a fault of the kernel: trap,
// so that the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == 1u << 26) __trap();
  }
}

// Thread 0 initialises the ring's mbarriers: a full barrier completes on the
// producer's expect_tx and the bytes, an empty one on one arrival from each
// of the eight consumer warps.
template <int STAGES>
__device__ __forceinline__ void init_ring(uint64_t (&full)[STAGES], uint64_t (&empty)[STAGES]) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// One box of `map` at coordinates (c0, c1, c2) into shared memory at dst;
// its bytes complete on the mbarrier `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// wgmma's shared-memory matrix descriptor: start address, leading and stride
// byte offsets (each >> 4) and the 128-byte swizzle (mode 1, bits 62-63).
// The ring is 1024-byte aligned and every start lies less than 128 bytes
// past a 1024-byte boundary, so the base offset (bits 49-51) is 0.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (cute's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define TML_ACC8(i)                                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define TML_ACC64(i)                                                                    \
  TML_ACC8(i), TML_ACC8(i + 8), TML_ACC8(i + 16), TML_ACC8(i + 24), TML_ACC8(i + 32), \
      TML_ACC8(i + 40), TML_ACC8(i + 48), TML_ACC8(i + 56)
#define TML_REGS64                                                                   \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define TML_REGS128                                                                             \
  TML_REGS64                                                                                    \
  ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "          \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "            \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
// d = A B + (acc ? d : 0) over one k16 step, A and B 16-bit of type TY from
// the descriptors; TA / TB are wgmma's transpose bits (1: M- or N-major).
#define TML_WGMMA(N, TY, REGS, DA, DB, ACC, TA_, TB_)                                     \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" #ACC ", 0;\n"                                      \
  "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {" REGS "}, %" #DA ", %" #DB \
  ", p, 1, 1, %" #TA_ ", %" #TB_ ";\n}\n"

// Zeroing the accumulators through `acc` rather than by ordinary
// instructions keeps ptxas from serializing the wgmma pipeline (C7515).
template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da, uint64_t db, uint32_t acc) {
  if constexpr (std::is_same_v<T, __half>)
    asm volatile(TML_WGMMA(256, "f16", TML_REGS128, 128, 129, 130, 131, 132)
                 : TML_ACC64(0), TML_ACC64(64)
                 : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  else
    asm volatile(TML_WGMMA(256, "bf16", TML_REGS128, 128, 129, 130, 131, 132)
                 : TML_ACC64(0), TML_ACC64(64)
                 : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da, uint64_t db, uint32_t acc) {
  if constexpr (std::is_same_v<T, __half>)
    asm volatile(TML_WGMMA(128, "f16", TML_REGS64, 64, 65, 66, 67, 68)
                 : TML_ACC64(0)
                 : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  else
    asm volatile(TML_WGMMA(128, "bf16", TML_REGS64, 64, 65, 66, 67, 68)
                 : TML_ACC64(0)
                 : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// d = A B + (acc ? d : 0) over one k8 step of TF32 operands (f32 values
// whose low 13 mantissa bits the tensor cores do not read), both K-major:
// wgmma has no transpose bits for TF32.
#define TML_WGMMA_TF32(N, REGS, DA, DB, ACC)                                                     \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" #ACC ", 0;\n"                                             \
  "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" REGS "}, %" #DA ", %" #DB ", p, 1, " \
  "1;\n}\n"

__device__ __forceinline__ void wgmma_tf32(float (&d)[128], uint64_t da, uint64_t db, uint32_t acc) {
  asm volatile(TML_WGMMA_TF32(256, TML_REGS128, 128, 129, 130)
               : TML_ACC64(0), TML_ACC64(64)
               : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da, uint64_t db, uint32_t acc) {
  asm volatile(TML_WGMMA_TF32(128, TML_REGS64, 64, 65, 66) : TML_ACC64(0) : "l"(da), "l"(db), "r"(acc));
}

// The same, m64n128k8, with A from registers: this thread's four TF32 words
// of the warpgroup's 64 x 8 A (split_fragment's layout).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                           uint32_t acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" TML_REGS64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : TML_ACC64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero:
// an f32 word whose low 13 bits are 0.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// Byte offset of f32 element (r, c) in a K-major tile of 32-value rows as
// TMA's 128-byte swizzle lays it out: the 16-byte chunk index XOR the row
// within its 8-row group.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return r * kRowBytes + (((c >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// This thread's part of consumer cg's 64 x 8 A fragment at k8 step kk of an
// f32 A tile at shared address a, split: hi = rna(x), lo = rna(x - hi).
// The layout is mma.sync's m16n8k8 tf32 A in one 16-row band a warp: rows
// g and g + 8, columns t and t + 4 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void split_fragment(uint32_t a, int cg, int kk, uint32_t (&hi)[4],
                                               uint32_t (&lo)[4]) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int r = cg * 64 + warp * 16 + lane / 4, c = kk * 8 + lane % 4;
  const int rc[4][2] = {{r, c}, {r + 8, c}, {r, c + 4}, {r + 8, c + 4}};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float x;
    asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(a + swizzled(rc[j][0], rc[j][1])));
    hi[j] = rna_tf32(x);
    lo[j] = rna_tf32(x - __uint_as_float(hi[j]));
  }
}

// The same for a 16-bit A tile (bf16 or f16, TA): a box of 128 rows of 32
// values, 64 bytes a row, as TMA's 64-byte swizzle lays it out (the 16-byte
// chunk index XOR bits 1-2 of the row). A 16-bit value widened to f32 is
// exact in TF32 (bf16's 8 and f16's 11 significant bits, within f32's
// exponent range), so hi is the widened value and there is no lo.
template <typename TA>
__device__ __forceinline__ void widen_fragment(uint32_t a, int cg, int kk, uint32_t (&hi)[4]) {
  static_assert(std::is_same_v<TA, __nv_bfloat16> || std::is_same_v<TA, __half>, "16-bit A");
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int r = cg * 64 + warp * 16 + lane / 4, c = kk * 8 + lane % 4;
  const int rc[4][2] = {{r, c}, {r + 8, c}, {r, c + 4}, {r + 8, c + 4}};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int rr = rc[j][0], cc = rc[j][1];
    const uint32_t at = a + rr * 64 + ((((cc >> 3) ^ ((rr >> 1) & 3)) << 4) | ((cc & 7) << 1));
    uint16_t v;
    asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(at));
    if constexpr (std::is_same_v<TA, __nv_bfloat16>) {
      hi[j] = static_cast<uint32_t>(v) << 16;
    } else {
      hi[j] = __float_as_uint(__half2float(__ushort_as_half(v)));
    }
  }
}

// The consumer warpgroup cg's side of the ring: nk stages in order, each
// four k16 steps into acc, with one commit group in flight; a stage is
// released (one arrival a warp) once wgmma.wait_group shows that the
// products reading it are done. The first step's products overwrite acc
// (scale-d 0); with nk == 0 acc is left as it was. on_first() runs once the
// first stage has landed.
template <typename T, int BN, int STAGES, int TA, int TB, typename OnFirst>
__device__ __forceinline__ void consume(float (&acc)[BN / 2], int nk, uint32_t ring,
                                        uint64_t (&full)[STAGES], uint64_t (&empty)[STAGES],
                                        int cg, OnFirst on_first) {
  constexpr uint32_t kStageBytes = stage_bytes<BN>();
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % STAGES;
    mbar_wait(smem_u32(&full[s]), (kb / STAGES) & 1);
    if (kb == 0) on_first();
    const uint32_t sa = ring + s * kStageBytes + cg * kBox, sb = ring + s * kStageBytes + kABytes;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = TA ? make_desc(sa + kk * 2048, kBox, 1024) : make_desc(sa + kk * 32, 16, 1024);
      const uint64_t db = TB ? make_desc(sb + kk * 2048, kBox, 1024) : make_desc(sb + kk * 32, 16, 1024);
      wgmma<T, TA, TB>(acc, da, db, kb > 0 || kk > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_acc(acc);
    if (kb > 0) {  // the group of step kb - 1 is done: its stage may be refilled
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(acc);
      if (threadIdx.x % 32 == 0) mbar_arrive(smem_u32(&empty[(kb - 1) % STAGES]));
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
}

// The twelve products of stage s of a 3xTF32 ring into `part`, overwriting
// it: the stage holds the hi and lo planes of A's 128 x 32 (hi, then lo)
// and then of B's BN x 32 (both K-major); each of its four k8 steps issues
// lo·hi, hi·lo, then hi·hi (the small terms first; lo·lo is dropped). One
// commit group.
template <int BN>
__device__ __forceinline__ void stage_tf32x3(float (&part)[BN / 2], uint32_t stage, int cg) {
  const uint32_t a_hi = stage + cg * kBox, a_lo = a_hi + kABytes;
  const uint32_t b_hi = stage + 2 * kABytes, b_lo = b_hi + BN * kRowBytes;
  fence_acc(part);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < kBK32 / 8; ++kk) {
    const uint64_t dah = make_desc(a_hi + kk * 32, 16, 1024), dal = make_desc(a_lo + kk * 32, 16, 1024);
    const uint64_t dbh = make_desc(b_hi + kk * 32, 16, 1024), dbl = make_desc(b_lo + kk * 32, 16, 1024);
    wgmma_tf32(part, dal, dbh, kk > 0);
    wgmma_tf32(part, dah, dbl, 1);
    wgmma_tf32(part, dah, dbh, 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  fence_acc(part);
}

// Bytes of a 128 x 32 A box in f32 or 16-bit values.
template <typename TA>
__host__ __device__ constexpr uint32_t a_box_bytes() {
  return kBM * kBK32 * static_cast<uint32_t>(sizeof(TA));
}

// Whether a split-A stage holds B's lo plane: the products of an A in f32
// (TA float) are lo·hi, hi·lo and hi·hi (3), or lo·hi and hi·hi where B is
// exact (2), or hi·hi where both are (1); those of a 16-bit A (exact) are
// hi·lo and hi·hi (2), or hi·hi where B is exact too (1).
template <typename TA, int PRODUCTS>
__host__ __device__ constexpr bool stages_b_lo() {
  return PRODUCTS == 3 || (PRODUCTS == 2 && !std::is_same_v<TA, float>);
}

// The same with A split in registers: the stage holds A's 128 x 32 in f32
// (or 16-bit, TA), then the hi and, where stages_b_lo, the lo plane of B's
// BN x 32 (BN = 128). Each k8 step loads and splits (or widens) this
// thread's part of A's fragment and commits its products as a group; two
// register sets alternate, so a step's loads wait for the group of two
// steps before, which read that set. An exact operand (bf16 or f16 values,
// widened to f32 by the caller or here) has a lo plane of 0, and the
// products that read it are left out (stages_b_lo).
template <int BN, int PRODUCTS = 3, typename TA = float>
__device__ __forceinline__ void stage_tf32x3_split_a(float (&part)[BN / 2], uint32_t stage, int cg) {
  constexpr bool kAExact = !std::is_same_v<TA, float>;
  static_assert(BN == 128, "register A: m64n128k8");
  static_assert(PRODUCTS >= 1 && PRODUCTS <= (kAExact ? 2 : 3),
                "3xTF32, or fewer products of exact operands");
  const uint32_t b_hi = stage + a_box_bytes<TA>(), b_lo = b_hi + BN * kRowBytes;
  uint32_t h0[4], l0[4], h1[4], l1[4];
  fence_acc(part);
#pragma unroll
  for (int kk = 0; kk < kBK32 / 8; ++kk) {
    uint32_t(&hi)[4] = kk % 2 ? h1 : h0;
    uint32_t(&lo)[4] = kk % 2 ? l1 : l0;
    if (kk >= 2) asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if constexpr (kAExact) {
      widen_fragment<TA>(stage, cg, kk, hi);
    } else {
      split_fragment(stage, cg, kk, hi, lo);
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint64_t dbh = make_desc(b_hi + kk * 32, 16, 1024);
    const uint64_t dbl = make_desc(b_lo + kk * 32, 16, 1024);
    if constexpr (PRODUCTS == 3) {
      wgmma_tf32(part, lo, dbh, kk > 0);
      wgmma_tf32(part, hi, dbl, 1);
      wgmma_tf32(part, hi, dbh, 1);
    } else if constexpr (PRODUCTS == 2 && kAExact) {
      wgmma_tf32(part, hi, dbl, kk > 0);
      wgmma_tf32(part, hi, dbh, 1);
    } else if constexpr (PRODUCTS == 2) {
      wgmma_tf32(part, lo, dbh, kk > 0);
      wgmma_tf32(part, hi, dbh, 1);
    } else {
      wgmma_tf32(part, hi, dbh, kk > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }
  fence_acc(part);
}

// The three products of one 32-deep stage with A in f32, split in registers
// (hi = rna(x), lo = rna(x - hi)), for a calling warpgroup whose 64 rows of A
// start at `a` (32-value rows as TMA's 128-byte swizzle lays them out,
// `swizzled`) and whose 128 rows of B^T's hi and lo planes (K-major, the same
// swizzle) are at b_hi and b_lo: stage_tf32x3_split_a's products in its
// order (lo·hi, hi·lo, then hi·hi each k8 step, one commit group a step, two
// register sets alternating) for operands anywhere in shared memory: B8c's
// resident W, B9's A shared by both consumers. (The ring keeps its own copy:
// the same steps through this function changed its kernels' code and time.)
// part is overwritten; the caller waits for the groups (wgmma.wait_group 0)
// before it reads part or runs another stage, whose fragments reuse these
// registers.
__device__ __forceinline__ void stage_tf32x3_at(float (&part)[64], uint32_t a, uint32_t b_hi,
                                                uint32_t b_lo) {
  uint32_t h0[4], l0[4], h1[4], l1[4];
  fence_acc(part);
#pragma unroll
  for (int kk = 0; kk < kBK32 / 8; ++kk) {
    uint32_t(&hi)[4] = kk % 2 ? h1 : h0;
    uint32_t(&lo)[4] = kk % 2 ? l1 : l0;
    if (kk >= 2) asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    split_fragment(a, 0, kk, hi, lo);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint64_t dbh = make_desc(b_hi + kk * 32, 16, 1024);
    const uint64_t dbl = make_desc(b_lo + kk * 32, 16, 1024);
    wgmma_tf32(part, lo, dbh, kk > 0);
    wgmma_tf32(part, hi, dbl, 1);
    wgmma_tf32(part, hi, dbh, 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }
  fence_acc(part);
}

// Orders this thread's generic-proxy writes to shared memory before later
// reads of it by the async proxy (wgmma's operands written by threads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Bytes of a 3xTF32 stage: A's two planes and B's, or (SPLIT_A) A in f32 or
// 16-bit (TA) and B's planes that stages_b_lo says.
template <int BN, bool SPLIT_A, int PRODUCTS = 3, typename TA = float>
__host__ __device__ constexpr uint32_t tf32x3_stage_bytes() {
  return SPLIT_A ? a_box_bytes<TA>() + (stages_b_lo<TA, PRODUCTS>() ? 2 : 1) * BN * kRowBytes
                 : stage_bytes<BN, 2>();
}

// acc += part, in f32 (round to nearest), once part's group is done.
template <int N>
__device__ __forceinline__ void fold(float (&acc)[N], float (&part)[N]) {
  fence_acc(part);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += part[i];
}

// The consumer warpgroup cg's side of a 3xTF32 ring: nk stages in order.
// The tensor cores do not round their f32 additions to nearest, so a chain
// of 3 · k / 8 additions into one accumulator drifts with k (some 3e-5 of
// the result at k = 4096, ten times an f32 product's error). So each
// stage's twelve products go into a fresh partial (their chain stays 12
// long), which is summed in f32 into acc once they are done; then the
// stage is released (one arrival a warp). acc starts at 0. One partial: a
// second, to keep the next stage's products running during the sum, takes
// more registers than a thread has (ptxas gives each thread of a block
// with a producer warpgroup 168); the other consumer warpgroup's products
// run meanwhile. SPLIT_A: A's stage is f32 (or 16-bit, TA), split (or
// widened) in registers (stage_tf32x3_split_a, which says which PRODUCTS).
template <int BN, int STAGES, bool SPLIT_A, int PRODUCTS = 3, typename TA = float>
__device__ __forceinline__ void consume_tf32x3(float (&acc)[BN / 2], int nk, uint32_t ring,
                                               uint64_t (&full)[STAGES], uint64_t (&empty)[STAGES],
                                               int cg) {
  static_assert(SPLIT_A || (PRODUCTS == 3 && std::is_same_v<TA, float>), "A's planes: 3xTF32");
  constexpr uint32_t kStageBytes = tf32x3_stage_bytes<BN, SPLIT_A, PRODUCTS, TA>();
  float part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % STAGES;
    mbar_wait(smem_u32(&full[s]), (kb / STAGES) & 1);
    if constexpr (SPLIT_A) {
      stage_tf32x3_split_a<BN, PRODUCTS, TA>(part, ring + s * kStageBytes, cg);
    } else {
      stage_tf32x3<BN>(part, ring + s * kStageBytes, cg);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fold(acc, part);
    if (threadIdx.x % 32 == 0) mbar_arrive(smem_u32(&empty[s]));
  }
}

// The (row, column) within its warpgroup's 64 x BN tile of accumulator
// register i of this thread: wgmma's m64nNk16 f32 layout, which is
// mma.sync's m16n8 layout in one 16-row band a warp, repeated every 8
// columns. Registers i and i + 1 (i even) are neighbouring columns.
__device__ __forceinline__ int2 frag_pos(int i) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  return make_int2(warp * 16 + lane / 4 + 8 * ((i >> 1) & 1), 8 * (i >> 2) + 2 * (lane % 4) + (i & 1));
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Row stride, in floats, of a tile staged by stage_tile: padded by 8, so a
// warp's fragment stores take two wavefronts.
template <int BN>
__host__ __device__ constexpr int staged_ld() {
  return BN + 8;
}

// Writes consumer cg's fragment into the ring, free once both consumers'
// products are done (every load was waited for), and returns its 64 rows,
// staged_ld<BN>() floats apart, once the warpgroup has written them. The
// epilogues read the tile from there with whole rows to a warp.
template <int BN, int STAGES, int PLANES = 1>
__device__ __forceinline__ const float* stage_tile(const float (&acc)[BN / 2], uint8_t* smem_raw,
                                                   uint32_t ring, int cg) {
  constexpr int kLd = staged_ld<BN>();
  static_assert(2 * 64 * kLd * 4 <= STAGES * stage_bytes<BN, PLANES>(),
                "the staged tile fits in the ring");
  named_barrier(1, 256);
  float* tile = reinterpret_cast<float*>(smem_raw + (ring - smem_u32(smem_raw))) + cg * 64 * kLd;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int2 rc = frag_pos(i);
    *reinterpret_cast<float2*>(tile + rc.x * kLd + rc.y) = make_float2(acc[i], acc[i + 1]);
  }
  named_barrier(2 + cg, 128);
  return tile;
}

// v0 to element i of d and, where `two`, v1 to element i + 1: one two-wide
// store where `vec` (i even and d aligned to it).
__device__ __forceinline__ void store2(__nv_bfloat16* q, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(q) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store2(__half* q, float v0, float v1) {
  *reinterpret_cast<__half2*>(q) = __floats2half2_rn(v0, v1);
}
__device__ __forceinline__ void store2(float* q, float v0, float v1) {
  *reinterpret_cast<float2*>(q) = make_float2(v0, v1);
}
__device__ __forceinline__ void store1(__nv_bfloat16* q, float v) { *q = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store1(__half* q, float v) { *q = __float2half_rn(v); }
__device__ __forceinline__ void store1(float* q, float v) { *q = v; }

template <typename TD>
__device__ __forceinline__ void store_pair(TD* d, int64_t i, float v0, float v1, bool two, bool vec) {
  if (two && vec) {
    store2(d + i, v0, v1);
  } else {
    store1(d + i, v0);
    if (two) store1(d + i + 1, v1);
  }
}

// dtype codes, as tpumathlib_torch/dx/gemm.py passes them
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };
// activation codes
enum Act : int { kNone = 0, kRelu = 1, kGelu = 2 };

__device__ __forceinline__ float load_c(const void* c, int dtype, int64_t i) {
  switch (dtype) {
    case kBF16: return __bfloat162float(static_cast<const __nv_bfloat16*>(c)[i]);
    case kF16: return __half2float(static_cast<const __half*>(c)[i]);
    case kI8: return static_cast<float>(static_cast<const int8_t*>(c)[i]);
    default: return static_cast<const float*>(c)[i];
  }
}

__device__ __forceinline__ float relu(float v) {
  return v < 0.f ? 0.f : v;  // NaN passes through, as in the plain version
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
}

// D's rows gm[0 .. R) at columns gn and gn + 1 (where `two`), rows past M
// skipped; the dtype's branch holds all R stores.
template <int R, typename TD, typename P>
__device__ __forceinline__ void store_rows_as(const P& p, int64_t bz, const int64_t (&gm)[R],
                                              int64_t gn, const float (&v0)[R], const float (&v1)[R],
                                              bool two, bool vec) {
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (gm[j] < p.m) store_pair(static_cast<TD*>(p.d), bz * p.d_sb + gm[j] * p.d_sm + gn, v0[j], v1[j], two, vec);
}

template <int R, typename P>
__device__ __forceinline__ void store_rows(const P& p, int64_t bz, const int64_t (&gm)[R],
                                           int64_t gn, const float (&v0)[R], const float (&v1)[R],
                                           bool two, bool vec) {
  if (p.d_dtype == kBF16) {
    store_rows_as<R, __nv_bfloat16>(p, bz, gm, gn, v0, v1, two, vec);
  } else if (p.d_dtype == kF16) {
    store_rows_as<R, __half>(p, bz, gm, gn, v0, v1, two, vec);
  } else {
    store_rows_as<R, float>(p, bz, gm, gn, v0, v1, two, vec);
  }
}

// B1's fused epilogue over consumer cg's staged 64 x BN rows (stage_tile)
// of the tile at (m0, n0) of batch bz: D = epilogue(alpha * acc + beta * C
// + bias) [+ aux = its input], with p's C (any of the dtype codes, with
// batch, row and column strides; it may be D), bias (N,) f32, D (f32, bf16
// or f16) and aux (f32) sharing one layout with unit column stride, act
// none, relu or tanh-GELU. Each thread takes two neighbouring columns of
// 256 / BN rows a step, kRows steps a pass; every uniform branch (C, aux,
// activation, dtype) holds all the pass's rows, so their loads, math and
// stores are independent chains within one basic block. The thread that
// writes an element of D is the one that read it from C.
template <int BN, typename P>
__device__ __forceinline__ void fused_epilogue(const P& p, const float* tile, int64_t m0, int64_t n0,
                                               int64_t bz, int cg) {
  constexpr int kLd = staged_ld<BN>();
  constexpr int kPairs = BN / 2, kStep = 128 / kPairs, kRows = 4;
  static_assert(64 % (kRows * kStep) == 0, "whole passes");
  const int t = threadIdx.x % 128, col = 2 * (t % kPairs);
  const int64_t gn = n0 + col;
  if (gn >= p.n) return;
  // two-wide stores where every pair starts on 8 bytes (D and aux may be views)
  const bool two = gn + 1 < p.n;
  const bool vec = p.d_sm % 2 == 0 && p.d_sb % 2 == 0 && reinterpret_cast<uintptr_t>(p.d) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(p.aux) % 8 == 0;
  const float b0 = p.bias ? p.bias[gn] : 0.f, b1 = p.bias && two ? p.bias[gn + 1] : 0.f;
  for (int r = t / kPairs; r < 64; r += kRows * kStep) {
    float v0[kRows], v1[kRows];
    int64_t gm[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const float2 a2 = *reinterpret_cast<const float2*>(tile + (r + j * kStep) * kLd + col);
      gm[j] = m0 + cg * 64 + r + j * kStep;
      v0[j] = p.alpha * a2.x;
      v1[j] = p.alpha * a2.y;
    }
    if (p.c) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (gm[j] >= p.m) continue;
        const int64_t ci = bz * p.c_sb + gm[j] * p.c_sm + gn * p.c_sn;
        v0[j] += p.beta * load_c(p.c, p.c_dtype, ci);
        if (two) v1[j] += p.beta * load_c(p.c, p.c_dtype, ci + p.c_sn);
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      v0[j] += b0;
      v1[j] += b1;
    }
    if (p.aux) {
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (gm[j] < p.m) store_pair(p.aux, bz * p.d_sb + gm[j] * p.d_sm + gn, v0[j], v1[j], two, vec);
    }
    if (p.act == kRelu) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) v0[j] = relu(v0[j]), v1[j] = relu(v1[j]);
    } else if (p.act == kGelu) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) v0[j] = gelu(v0[j]), v1[j] = gelu(v1[j]);
    }
    store_rows<kRows>(p, bz, gm, gn, v0, v1, two, vec);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, reached through the runtime so that
// the library links no -lcuda; null where libcuda lacks it. This
// and encode are static: each source keeps its own copy, called directly
// rather than through the library's symbol table.
static inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t rc =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                                                    : nullptr;
  }();
  return fn;
}

// A 3-D map (inner, outer, batch) of an operand of `esize`-byte elements
// (16-bit unless given) whose inner dimension has unit stride and whose
// outer one has stride ld; boxes of box_inner x box_outer, 128-byte swizzle
// unless given, zero fill out of bounds. An operand shared by every batch
// gets a batch extent of 1 (coordinate 0).
static inline CUresult encode(CUtensorMap* map, CUtensorMapDataType dt, const void* ptr, int64_t inner,
                       int64_t outer, int64_t ld, int64_t batch, int64_t sb, bool batched,
                       uint32_t box_inner, uint32_t box_outer, int esize = 2,
                       CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer),
                              static_cast<cuuint64_t>(batched ? batch : 1)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * esize,
                                 static_cast<cuuint64_t>(batched ? sb : outer * ld) * esize};
  const cuuint32_t box[3] = {box_inner, box_outer, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(map, dt, 3, const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device, once a device: the limit is a per-device attribute of the
// function, and setting it on every launch costs host time that small calls
// feel. `raised` is the caller's set of devices done, one a kernel (a
// static of its launcher); a device past 63 sets it on every launch.
inline cudaError_t raise_smem_once(const void* kernel, int bytes, std::atomic<uint64_t>& raised) {
  int device = 0;
  const cudaError_t got = cudaGetDevice(&device);
  if (got != cudaSuccess) return got;
  const uint64_t bit = device < 64 ? uint64_t(1) << device : 0;
  if (raised.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr == cudaSuccess) raised.fetch_or(bit, std::memory_order_relaxed);
  return attr;
}

}  // namespace tml_ring
