// Tensor-core GEMM with a fused epilogue, for Hopper (sm_90a): B1's route
// for 16-bit operands.
//
//   D = epilogue(alpha * A @ B + beta * C + bias)   [+ aux = pre-activation]
//
// Replaces the TPU kernel tpumathlib/dx/gemm.py::pallas_matmul (kernel body
// at :193) for bf16 and f16 A and B; f32 operands take gemm_tf32x3.cu, int8
// ones and layouts this route refuses gemm_epilogue.cu (dx/gemm.py routes
// between them). The contract is that file's: A (batch, M, K), B (batch, K, N), C
// broadcast by its strides and read in its own dtype, bias (N,) f32, D
// f32/bf16/f16 and aux f32 with unit column stride; epilogues none, relu and
// tanh-GELU, each with or without bias and aux.
//
// What bounds it: 2·M·N·K operations at 989 TFLOP/s (bf16 and f16, dense);
// at 4096^3 that is 0.139 ms, against 0.030 ms for the bytes.
//
// Design. One block of 384 threads computes a 128 x BN tile of D (BN = 256,
// or 128 where 256 would leave SMs idle) on the ring of hopper_ring.cuh:
// warpgroup 0 is the producer, which gives up registers (setmaxnreg) and
// keeps TMA loads of (128 x 64 of A, 64 x BN of B) in flight in STAGES
// stages; warpgroups 1 and 2 are the consumers, each issuing wgmma
// m64nBNk16 over its 64 rows with one commit group in flight. TMA's zero
// fill of out-of-bounds boxes masks the ragged M, N and K edges of the
// operands; the epilogue masks its stores.
//
// Layouts (the header's): a K-major operand (A row-major, B column-major)
// is one box of 64 k x 128 (A) or BN (B) rows; an M- or N-major one (an A^T
// view, a row-major B; wgmma's transpose bits) is boxes of 64 k rows x 64
// columns. So transposed views need no copy.
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
// The epilogue (fused_epilogue) is in hopper_ring.cuh, shared with the
// 3xTF32 kernel's f32 route of B1.
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

#include "hopper_ring.cuh"

namespace {

using namespace tml_ring;

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

template <typename T, int BN, int STAGES, int TA, int TB>
__global__ void __launch_bounds__(kThreads, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, const Params p) {
  constexpr uint32_t kStageBytes = stage_bytes<BN>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle repeats every 1024 bytes
  const int wg = threadIdx.x / 128;
  const int nk = static_cast<int>((p.k + kBK - 1) / kBK);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN, bz = blockIdx.z;
  TML_STAMP(0);
  init_ring(full, empty);

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
  consume<T, BN, STAGES, TA, TB>(acc, nk, ring, full, empty, cg, [] { TML_STAMP(1); });
  TML_STAMP(2);
  if (nk == 0) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  }

  // The tile goes through shared memory, so that the epilogue is one short
  // loop with whole rows to a warp (coalesced loads of C and stores of D
  // and aux) instead of BN / 2 unrolled copies.
  const float* tile = stage_tile<BN, STAGES>(acc, smem_raw, ring, cg);
  fused_epilogue<BN>(p, tile, m0, n0, bz, cg);   // the stamping thread (column n0 < N) passes it all
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

template <typename T, int CFG, int TA, int TB>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb, const Params& p, int64_t batch,
                   cudaStream_t stream) {
  constexpr int BN = kConfigs[CFG][1], STAGES = kConfigs[CFG][3];
  constexpr int kSmem = smem_bytes<BN, STAGES>();
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
