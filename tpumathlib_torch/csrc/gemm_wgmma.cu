// Tensor-core GEMM with a fused epilogue, for Hopper (sm_90a): B1's route
// for 16-bit operands.
//
//   D = epilogue(alpha * A @ B + beta * C + bias)   [+ aux = pre-activation]
//
// Replaces the TPU kernel tpumathlib/dx/gemm.py::pallas_matmul (kernel body
// at :193) for bf16 and f16 A and B; f32 and int8 operands, and layouts
// this route refuses, take gemm_epilogue.cu (dx/gemm.py routes between
// them). The contract is that file's: A (batch, M, K), B (batch, K, N), C
// broadcast by its strides and read in its own dtype, bias (N,) f32, D
// f32/bf16/f16 and aux f32 with unit column stride; epilogues none, relu and
// tanh-GELU, each with or without bias and aux.
//
// What bounds it: 2·M·N·K operations at 989 TFLOP/s (bf16 and f16, dense);
// at 4096^3 that is 0.139 ms, against 0.030 ms for the bytes.
//
// Design. One block of 384 threads computes a 128 x BN tile of D (BN = 256,
// or 128 where 256 would leave SMs idle). Warpgroup 0 is the producer: it
// gives up registers (setmaxnreg) and one of its threads keeps TMA loads in
// flight into a ring of STAGES stages of (128 x 64 of A, 64 x BN of B), each
// stage with a full and an empty mbarrier. Warpgroups 1 and 2 are the
// consumers: each issues wgmma m64nBNk16 over its 64 rows into BN / 2 f32
// accumulators a thread, keeps one commit group in flight, and releases a
// stage only once wgmma.wait_group shows that the products reading it are
// done. TMA's zero fill of out-of-bounds boxes masks the ragged M, N and K
// edges of the operands; the epilogue masks its stores.
//
// Layouts. Every box lands with the 128-byte swizzle as rows of 64 16-bit
// values (128 bytes), in 1024-byte groups of 8 rows, and the wgmma
// descriptors read the same layout: a K-major operand (A row-major, B
// column-major) is one box of 64 k x 128 (A) or BN (B) rows, and a k16 step
// moves 32 bytes along its rows; an M- or N-major one (an A^T view, a
// row-major B; wgmma's transpose bits) is boxes of 64 k rows x 64 columns
// placed 8192 bytes apart (the descriptor's leading byte offset), and a k16
// step moves 16 rows, 2048 bytes. The stride byte offset is 1024 (8 rows)
// in both. So transposed views need no copy.
//
// The epilogue. The first k16 step's products overwrite the accumulators
// (wgmma's scale-d), so no other instruction writes them while the pipeline
// runs and ptxas keeps the wgmma asynchronous. After the last step each
// consumer writes its fragment into the ring, now free, and applies alpha,
// beta·C, bias, the aux store, relu or GELU and the store of D in a short
// loop over rows, two neighbouring columns a thread (a warp stores whole
// rows), 4 rows a pass with each uniform branch around all 4, so that
// their chains overlap. Unrolled over the fragment in registers (some
// 15000 instructions a kernel) the epilogue took longer than the products.
// frag_pos maps a register to its (row, column), and nothing else does.
//
// Built with -DTML_GEMM_STAMPS (chip_smoke.py phase 5 builds this source
// alone so), the kernel also writes, for every block, %globaltimer at its
// start, when its first stage has landed, after its last product and after
// its epilogue, and its SM, into the buffer that tml_gemm_wgmma_stamps
// sets: the split of a tile's time into prologue, main loop and epilogue.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

// dtype codes, as tpumathlib_torch/dx/gemm.py passes them
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };
// activation codes
enum Act : int { kNone = 0, kRelu = 1, kGelu = 2 };

constexpr int kBM = 128;       // rows of a block tile: two consumer warpgroups of 64
constexpr int kBK = 64;        // k of a stage: one 128-byte swizzle row of 16-bit values
constexpr int kThreads = 384;  // the producer warpgroup and two consumers
constexpr uint32_t kBox = 64 * 128;  // bytes of one 64 x 64 box

// The compiled tile configs: (BM, BN, BK, stages). Config ids index this
// table; dx/gemm.py's _TC_CONFIGS lists the same in order.
constexpr int kConfigs[][4] = {
    {kBM, 256, kBK, 4},
    {kBM, 128, kBK, 6},
};
constexpr int kNumConfigs = sizeof(kConfigs) / sizeof(kConfigs[0]);

struct Params {
  const void* c;       // may be null
  const float* bias;   // may be null
  void* d;
  float* aux;          // may be null
  int64_t m, n, k;
  int64_t c_sb, c_sm, c_sn;  // strides in elements
  int64_t d_sb, d_sm;        // D and aux share one layout, unit column stride
  float alpha, beta;
  int act, c_dtype, d_dtype;
  int a_batched, b_batched;  // 0: one matrix for every batch (its map has one)
};

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

// The (row, column) within its warpgroup's 64 x BN tile of accumulator
// register i of this thread: wgmma's m64nNk16 f32 layout, which is
// mma.sync's m16n8 layout in one 16-row band a warp, repeated every 8
// columns. Registers i and i + 1 (i even) are neighbouring columns.
__device__ __forceinline__ int2 frag_pos(int i) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  return make_int2(warp * 16 + lane / 4 + 8 * ((i >> 1) & 1), 8 * (i >> 2) + 2 * (lane % 4) + (i & 1));
}

#ifdef TML_GEMM_STAMPS
__device__ unsigned long long* g_stamps;  // 5 values a block: 4 times (ns), the SM

// stamp j of this block, from the first consumer's first thread
__device__ __forceinline__ void stamp(int j) {
  if (threadIdx.x != 128 || g_stamps == nullptr) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned long long blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  g_stamps[5 * blk + j] = t;
  if (j == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_stamps[5 * blk + 4] = sm;
  }
}
#define TML_STAMP(j) stamp(j)
#else
#define TML_STAMP(j) \
  do {            \
  } while (0)
#endif

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

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

// D's rows gm[0 .. R) at columns gn and gn + 1 (where `two`), rows past M
// skipped; the dtype's branch holds all R stores.
template <int R, typename TD>
__device__ __forceinline__ void store_rows_as(const Params& p, int64_t bz, const int64_t (&gm)[R],
                                              int64_t gn, const float (&v0)[R], const float (&v1)[R],
                                              bool two, bool vec) {
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (gm[j] < p.m) store_pair(static_cast<TD*>(p.d), bz * p.d_sb + gm[j] * p.d_sm + gn, v0[j], v1[j], two, vec);
}

template <int R>
__device__ __forceinline__ void store_rows(const Params& p, int64_t bz, const int64_t (&gm)[R],
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

template <typename T, int BN, int STAGES, int TA, int TB>
__global__ void __launch_bounds__(kThreads, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, const Params p) {
  constexpr uint32_t kABytes = kBM * kBK * 2, kStageBytes = kABytes + kBK * BN * 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle repeats every 1024 bytes
  const int wg = threadIdx.x / 128;
  const int nk = static_cast<int>((p.k + kBK - 1) / kBK);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN, bz = blockIdx.z;
  TML_STAMP(0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);   // the producer's expect_tx, then the bytes
      mbar_init(smem_u32(&empty[s]), 8);  // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int za = p.a_batched ? bz : 0, zb = p.b_batched ? bz : 0;
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % STAGES, k0 = kb * kBK;
        const uint32_t bar = smem_u32(&full[s]);
        mbar_wait(smem_u32(&empty[s]), ((kb / STAGES) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(bar, kStageBytes);
        const uint32_t sa = ring + s * kStageBytes, sb = sa + kABytes;
        if (TA) {
          tma_load(sa, &map_a, m0, k0, za, bar);
          tma_load(sa + kBox, &map_a, m0 + 64, k0, za, bar);
        } else {
          tma_load(sa, &map_a, k0, m0, za, bar);
        }
        if (TB) {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) tma_load(sb + j * kBox, &map_b, n0 + 64 * j, k0, zb, bar);
        } else {
          tma_load(sb, &map_b, k0, n0, zb, bar);
        }
      }
    }
    return;
  }

  // a consumer: rows 64 * cg .. 64 * cg + 63 of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cg = wg - 1;
  float acc[BN / 2];  // set by the first step's products (acc = 0)
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % STAGES;
    mbar_wait(smem_u32(&full[s]), (kb / STAGES) & 1);
    if (kb == 0) TML_STAMP(1);
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
  TML_STAMP(2);
  if (nk == 0) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  }

  // The tile goes through shared memory, so that the epilogue is one short
  // loop with whole rows to a warp (coalesced loads of C and stores of D
  // and aux) instead of BN / 2 unrolled copies. The ring is free once both
  // consumers' products are done: every load was waited for. Rows are
  // padded by 8 floats, so a warp's fragment stores take two wavefronts.
  named_barrier(1, 256);
  constexpr int kLd = BN + 8;
  static_assert(2 * 64 * kLd * 4 <= STAGES * kStageBytes, "the staged tile fits in the ring");
  float* tile = reinterpret_cast<float*>(smem_raw + (ring - smem_u32(smem_raw))) + cg * 64 * kLd;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int2 rc = frag_pos(i);
    *reinterpret_cast<float2*>(tile + rc.x * kLd + rc.y) = make_float2(acc[i], acc[i + 1]);
  }
  named_barrier(2 + cg, 128);

  // the fused epilogue: each thread takes two neighbouring columns of
  // 256 / BN rows a step, kRows steps a pass; every uniform branch (C,
  // aux, activation, dtype) holds all the pass's rows, so their loads, math
  // and stores are independent chains within one basic block
  constexpr int kPairs = BN / 2, kStep = 128 / kPairs, kRows = 4;
  static_assert(64 % (kRows * kStep) == 0, "whole passes");
  const int t = threadIdx.x % 128, col = 2 * (t % kPairs);
  const int64_t gn = n0 + col;
  if (gn >= p.n) return;  // never thread 0 (column n0 < N), whose stamp follows
  const bool two = gn + 1 < p.n, vec = p.d_sm % 2 == 0 && p.d_sb % 2 == 0;
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
  TML_STAMP(3);
}

// One operand as the route takes it: a (batch, rows, cols) view with
// strides in elements.
struct Operand {
  const void* ptr;
  int64_t rows, cols, sb, sr, sc;
};

// 0 where the operand is row-major (unit column stride), 1 where it is
// column-major, -1 where the route refuses it: the other stride must be a
// multiple of 8 elements (16 bytes) and cover its dimension, the batch
// stride 0 or a multiple of 8 past one matrix, and the base 16-byte aligned.
// dx/gemm.py::_tc_layout is the same rule.
int major_of(const Operand& o, int64_t batch) {
  if (reinterpret_cast<uintptr_t>(o.ptr) % 16) return -1;
  int major;
  int64_t extent;
  if (o.sc == 1 && o.sr % 8 == 0 && o.sr >= (o.cols > 1 ? o.cols : 1)) {
    major = 0;
    extent = o.rows * o.sr;
  } else if (o.sr == 1 && o.sc % 8 == 0 && o.sc >= (o.rows > 1 ? o.rows : 1)) {
    major = 1;
    extent = o.cols * o.sc;
  } else {
    return -1;
  }
  return batch == 1 || o.sb == 0 || (o.sb % 8 == 0 && o.sb >= extent) ? major : -1;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, reached through the runtime so
// that the library links no -lcuda; null where the driver lacks it.
EncodeTiled encode_tiled() {
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

// A 3-D map (inner, outer, batch) of a 16-bit operand whose inner dimension
// has unit stride and whose outer one has stride ld; boxes of box_inner x
// box_outer, 128-byte swizzle, zero fill out of bounds. An operand shared
// by every batch gets a batch extent of 1 (coordinate 0).
CUresult encode(CUtensorMap* map, CUtensorMapDataType dt, const void* ptr, int64_t inner,
                int64_t outer, int64_t ld, int64_t batch, int64_t sb, bool batched,
                uint32_t box_inner, uint32_t box_outer) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer),
                              static_cast<cuuint64_t>(batched ? batch : 1)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 2,
                                 static_cast<cuuint64_t>(batched ? sb : outer * ld) * 2};
  const cuuint32_t box[3] = {box_inner, box_outer, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(map, dt, 3, const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename T, int CFG, int TA, int TB>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb, const Params& p, int64_t batch,
                   cudaStream_t stream) {
  constexpr int BN = kConfigs[CFG][1], STAGES = kConfigs[CFG][3];
  constexpr int kSmem = STAGES * (kBM * kBK + kBK * BN) * 2 + 1024;  // + the ring's alignment
  auto* kernel = gemm_wgmma_kernel<T, BN, STAGES, TA, TB>;
  // the limit is a per-device attribute of the function: set it on every launch
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const int64_t gx = (p.n + BN - 1) / BN, gy = (p.m + kBM - 1) / kBM;
  if (gx > 2147483647LL || gy > 65535 || batch > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy), static_cast<unsigned>(batch));
  kernel<<<grid, kThreads, kSmem, stream>>>(ma, mb, p);
  return cudaGetLastError();
}

template <typename T, int CFG>
cudaError_t by_layout(int ta, int tb, const CUtensorMap& ma, const CUtensorMap& mb,
                      const Params& p, int64_t batch, cudaStream_t s) {
  if (ta) return tb ? launch<T, CFG, 1, 1>(ma, mb, p, batch, s) : launch<T, CFG, 1, 0>(ma, mb, p, batch, s);
  return tb ? launch<T, CFG, 0, 1>(ma, mb, p, batch, s) : launch<T, CFG, 0, 0>(ma, mb, p, batch, s);
}

template <typename T>
cudaError_t by_config(int config, int ta, int tb, const CUtensorMap& ma, const CUtensorMap& mb,
                      const Params& p, int64_t batch, cudaStream_t s) {
  switch (config) {
    case 0: return by_layout<T, 0>(ta, tb, ma, mb, p, batch, s);
    case 1: return by_layout<T, 1>(ta, tb, ma, mb, p, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Number of compiled tile configs; writes (BM, BN, BK, stages) of each into
// out[4 * i .. 4 * i + 3] for i < cap.
int tml_gemm_wgmma_configs(int* out, int cap) {
  for (int i = 0; i < kNumConfigs && i < cap; ++i)
    for (int j = 0; j < 4; ++j) out[4 * i + j] = kConfigs[i][j];
  return kNumConfigs;
}

// tml_gemm_epilogue's arguments (gemm_epilogue.cu) for bf16 or f16 A and B
// (ab_dtype 1 or 2) in a layout major_of takes. Launches on `stream` and
// returns 0, or a CUDA error: cudaErrorInvalidValue for an operand, dtype or
// config it does not take, cudaErrorSymbolNotFound where the driver has no
// tensor-map encoder, cudaErrorInvalidPitchValue where it refuses a map.
int tml_gemm_wgmma(const void* a, const void* b, const void* c, const float* bias, void* d,
                   float* aux, int64_t batch, int64_t m, int64_t n, int64_t k,
                   const int64_t* strides, float alpha, float beta, int act, int ab_dtype,
                   int c_dtype, int d_dtype, int config, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return cudaSuccess;
  if ((ab_dtype != kBF16 && ab_dtype != kF16) || d_dtype < kF32 || d_dtype > kF16 || config < 0 ||
      config >= kNumConfigs)
    return cudaErrorInvalidValue;
  const Operand oa{a, m, k, strides[0], strides[1], strides[2]};
  const Operand ob{b, k, n, strides[3], strides[4], strides[5]};
  const int ma = major_of(oa, batch), mb = major_of(ob, batch);
  Params p;
  p.c = c; p.bias = bias; p.d = d; p.aux = aux;
  p.m = m; p.n = n; p.k = k;
  p.c_sb = strides[6]; p.c_sm = strides[7]; p.c_sn = strides[8];
  p.d_sb = strides[9]; p.d_sm = strides[10];
  p.alpha = alpha; p.beta = beta;
  p.act = act; p.c_dtype = c_dtype; p.d_dtype = d_dtype;
  p.a_batched = batch > 1 && oa.sb != 0;
  p.b_batched = batch > 1 && ob.sb != 0;
  CUtensorMap map_a{}, map_b{};  // unread when k == 0: no stage is loaded
  if (k > 0) {
    if (ma < 0 || mb < 0) return cudaErrorInvalidValue;
    if (!encode_tiled()) return cudaErrorSymbolNotFound;
    const CUtensorMapDataType dt =
        ab_dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
    const int bn = kConfigs[config][1];
    // A: K-major boxes of 64 k x 128 rows, or M-major boxes of 64 x 64
    const CUresult ra = ma == 0 ? encode(&map_a, dt, a, k, m, oa.sr, batch, oa.sb, p.a_batched, 64, kBM)
                                : encode(&map_a, dt, a, m, k, oa.sc, batch, oa.sb, p.a_batched, 64, 64);
    // B: N-major boxes of 64 x 64 (row-major B), or K-major boxes of 64 k x BN rows
    const CUresult rb = mb == 0 ? encode(&map_b, dt, b, n, k, ob.sr, batch, ob.sb, p.b_batched, 64, 64)
                                : encode(&map_b, dt, b, k, n, ob.sc, batch, ob.sb, p.b_batched, 64, bn);
    if (ra != CUDA_SUCCESS || rb != CUDA_SUCCESS) return cudaErrorInvalidPitchValue;
  }
  const int ta = ma == 1, tb = mb == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ab_dtype == kBF16 ? by_config<__nv_bfloat16>(config, ta, tb, map_a, map_b, p, batch, s)
                           : by_config<__half>(config, ta, tb, map_a, map_b, p, batch, s);
}

#ifdef TML_GEMM_STAMPS
// Where the stamps go: 5 * blocks unsigned 64-bit values on the device
// (null: none are written).
int tml_gemm_wgmma_stamps(void* buf) {
  unsigned long long* p = static_cast<unsigned long long*>(buf);
  return cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));
}
#endif

}  // extern "C"
