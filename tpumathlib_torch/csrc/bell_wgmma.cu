// Blocked-ELL SpMM on the tensor cores, for Hopper (sm_90a): B6a's route for
// bf16 x bf16 and f16 x f16 operands.
//
//   tml_bell_spmm_wgmma: Y = alpha * A @ B, A Blocked-ELL with mb block rows
//                        of ellw (bs x bs) blocks and a block-column table
//                        cols (mb, ellw) (-1 = pad slot), B dense (n, k)
//                        with rows ldb elements apart, Y (m, k) in B's
//                        dtype; f32 accumulation.
//
// Replaces the TPU kernel tpumathlib/sparse/pallas_kernels.py::
// bell_spmm_pallas (:98, body _bell_kernel :35, pallas_call :123) for
// 16-bit operand pairs; f32 and mixed pairs take spmm_simt in
// bell_sparse.cu (sparse/pallas_kernels.py routes between them).
//
// What bounds it: 2 * mb * ellw * bs * bs * k operations at 989 TFLOP/s
// (bf16 and f16, dense); at the bench shape (mb 128, ellw 16, bs 128, k
// 4096) that is 0.278 ms, against 0.100 ms for A, B and Y once each.
//
// Design. A Blocked-ELL product is a GEMM whose K loop walks (slot j, offset
// t): a tile of Y (128 rows of block row i, BN columns) sums, over the valid
// slots j of cols[i, :] and the k-stages t0 of 64 in bs, A's rows
// (i * ellw + j) * bs + r0 .. +127 at columns t0 .. t0+63 (a K-major box of
// `data` viewed as (mb * ellw * bs, bs)) times B's rows cols[i, j] * bs + t0
// .. +63 (an N-major box of B, read through wgmma's transpose bit as B1
// reads a row-major B). So the block is B1's (hopper_ring.cuh): one
// producer thread keeps TMA loads in flight in a ring of STAGES stages, two
// consumer warpgroups issue wgmma m64nBNk16 into f32 accumulators. Producer
// and consumers read the same cols row, uniform in the block, so they agree
// on the stages: valid slots x bs / 64. A pad slot is skipped whatever its
// data holds. A block row of pads only has no stage and writes zeros. TMA's
// zero fill covers B's rows past n and columns past k; the epilogue (alpha,
// the cast, 4 rows a pass through the staged tile) masks rows past m and
// columns past k.
//
// Order. Consecutive blocks take the row tiles of a group of column tiles,
// the group's columns of B sized to stay in L2 (kL2Budget): B is read from
// device memory about once, and A once a group, where launching the row
// tiles of one column at a time would read A once a column tile.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_ring.cuh"

namespace {

using namespace tml_ring;

// operand dtype codes (kBF16 = 1, kF16 = 2), as tpumathlib_torch/sparse/pallas_kernels.py
// passes them: hopper_ring.cuh's DType

constexpr int kSMs = 132;                // an H100 SXM's: fewer tiles than this leave SMs idle
constexpr int64_t kL2Budget = 24 << 20;  // bytes of B's columns a group of column tiles reads

struct Params {
  const int32_t* cols;
  void* y;
  int64_t m, k;                        // Y's rows and columns
  int64_t row_tiles, col_tiles, group;  // tiles of Y, and column tiles a group
  int ellw, bs;
  float alpha;
};

template <typename T, int BN, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
bell_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, const Params p) {
  constexpr uint32_t kStageBytes = stage_bytes<BN>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle repeats every 1024 bytes
  const int wg = threadIdx.x / 128;
  // this block's tile: row tile rt (block row i, its rows r0 .. r0 + 127),
  // column tile ct, the row tiles of a group of column tiles in turn
  const int64_t per_group = p.group * p.row_tiles, g = blockIdx.x / per_group;
  const int64_t width = min(p.group, p.col_tiles - g * p.group), w = blockIdx.x % per_group;
  const int64_t rt = w / width, ct = g * p.group + w % width;
  const int64_t i = rt / (p.bs / kBM);
  const int r0 = static_cast<int>(rt % (p.bs / kBM)) * kBM, n0 = static_cast<int>(ct) * BN;
  const int32_t* crow = p.cols + i * p.ellw;
  init_ring(full, empty);

  if (wg == 0) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int kb = 0;
      for (int j = 0; j < p.ellw; ++j) {
        const int c = crow[j];
        if (c < 0) continue;  // a pad slot
        const int arow = static_cast<int>((i * p.ellw + j) * p.bs) + r0, brow = c * p.bs;
        for (int t0 = 0; t0 < p.bs; t0 += kBK, ++kb) {
          const int s = kb % STAGES;
          const uint32_t bar = smem_u32(&full[s]);
          mbar_wait(smem_u32(&empty[s]), ((kb / STAGES) & 1) ^ 1);  // the first round passes
          mbar_expect_tx(bar, kStageBytes);
          const uint32_t sa = ring + s * kStageBytes, sb = sa + kABytes;
          tma_load(sa, &map_a, t0, arow, 0, bar);
#pragma unroll
          for (int q = 0; q < BN / 64; ++q) tma_load(sb + q * kBox, &map_b, n0 + 64 * q, brow + t0, 0, bar);
        }
      }
    }
    return;
  }

  // a consumer: rows 64 * cg .. 64 * cg + 63 of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cg = wg - 1;
  int valid = 0;
  for (int j = 0; j < p.ellw; ++j) valid += crow[j] >= 0;
  const int nk = valid * (p.bs / kBK);
  float acc[BN / 2];  // set by the first step's products (acc = 0)
  consume<T, BN, STAGES, 0, 1>(acc, nk, ring, full, empty, cg, [] {});
  if (nk == 0) {  // a block row of pad slots only
#pragma unroll
    for (int q = 0; q < BN / 2; ++q) acc[q] = 0.f;
  }
  constexpr int kLd = staged_ld<BN>();
  const float* tile = stage_tile<BN, STAGES>(acc, smem_raw, ring, cg);

  // alpha, the cast and the stores: two neighbouring columns a thread (a
  // warp stores whole rows), 256 / BN rows a step, kRows steps a pass
  constexpr int kPairs = BN / 2, kStep = 128 / kPairs, kRows = 4;
  static_assert(64 % (kRows * kStep) == 0, "whole passes");
  const int t = threadIdx.x % 128, col = 2 * (t % kPairs);
  const int64_t gn = n0 + col;
  if (gn >= p.k) return;
  const bool two = gn + 1 < p.k, vec = p.k % 2 == 0;
  const int64_t row0 = i * p.bs + r0 + cg * 64;
  T* y = static_cast<T*>(p.y);
  for (int r = t / kPairs; r < 64; r += kRows * kStep) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int64_t gm = row0 + r + j * kStep;
      const float2 v = *reinterpret_cast<const float2*>(tile + (r + j * kStep) * kLd + col);
      if (gm < p.m) store_pair(y, gm * p.k + gn, p.alpha * v.x, p.alpha * v.y, two, vec);
    }
  }
}

template <typename T, int BN, int STAGES>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb, const Params& p, cudaStream_t s) {
  constexpr int kSmem = smem_bytes<BN, STAGES>();
  auto* kernel = bell_wgmma_kernel<T, BN, STAGES>;
  // the limit is a per-device attribute of the function: set it on every launch
  const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  kernel<<<static_cast<unsigned>(p.row_tiles * p.col_tiles), kThreads, kSmem, s>>>(ma, mb, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_width(int bn, const CUtensorMap& ma, const CUtensorMap& mb, const Params& p,
                     cudaStream_t s) {
  return bn == 256 ? launch<T, 256, 4>(ma, mb, p, s) : launch<T, 128, 6>(ma, mb, p, s);
}

}  // namespace

extern "C" {

// cols: (mb, ellw) int32, -1 = pad slot; a: (mb, ellw, bs, bs) contiguous;
// b: (n, k) with rows ldb elements apart; y: (m, k) contiguous, m <= mb * bs;
// a, b and y in `dtype` (1 bf16, 2 f16). bs % 128 == 0, ldb >= k a multiple
// of 8 (16 bytes, TMA's row pitch), a and b 16-byte aligned. Launches on
// `stream` and returns 0, or a CUDA error: cudaErrorInvalidValue for
// arguments it does not take, cudaErrorSymbolNotFound where libcuda has no
// tensor-map encoder, cudaErrorInvalidPitchValue where it refuses a map.
int tml_bell_spmm_wgmma(const void* cols, const void* a, const void* b, void* y, int64_t mb,
                        int64_t ellw, int64_t bs, int64_t m, int64_t n, int64_t k, int64_t ldb,
                        float alpha, int dtype, void* stream) {
  if ((dtype != kBF16 && dtype != kF16) || bs <= 0 || bs % kBM != 0 || bs > (1 << 15) ||
      ellw < 0 || mb < 0 || m < 0 || m > mb * bs || n < 0 || k < 0 || ldb < k || ldb % 8 != 0 ||
      mb * ellw * bs >= (1LL << 31) || n >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 || reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return cudaErrorInvalidValue;
  if (m == 0 || k == 0) return cudaSuccess;
  Params p;
  p.cols = static_cast<const int32_t*>(cols);
  p.y = y;
  p.m = m;
  p.k = k;
  // with no slot or no row of B, every tile sums nothing: no stage is loaded
  p.ellw = n > 0 ? static_cast<int>(ellw) : 0;
  p.bs = static_cast<int>(bs);
  p.alpha = alpha;
  p.row_tiles = (m + kBM - 1) / kBM;
  const int bn = p.row_tiles * ((k + 255) / 256) >= kSMs ? 256 : 128;
  p.col_tiles = (k + bn - 1) / bn;
  const int64_t b_cols_bytes = n * bn * 2;
  p.group = b_cols_bytes > 0 ? kL2Budget / b_cols_bytes : p.col_tiles;
  p.group = p.group < 1 ? 1 : (p.group > p.col_tiles ? p.col_tiles : p.group);
  if (p.row_tiles * p.col_tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  CUtensorMap map_a{}, map_b{};  // unread when there is no slot: no stage is loaded
  if (p.ellw > 0) {
    if (!encode_tiled()) return cudaErrorSymbolNotFound;
    const CUtensorMapDataType dt = dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
    // A: K-major boxes of 64 k x 128 rows of (mb * ellw * bs, bs); B: N-major boxes of 64 x 64
    const CUresult ra = encode(&map_a, dt, a, bs, mb * ellw * bs, bs, 1, 0, false, kBK, kBM);
    const CUresult rb = encode(&map_b, dt, b, k, n, ldb, 1, 0, false, 64, 64);
    if (ra != CUDA_SUCCESS || rb != CUDA_SUCCESS) return cudaErrorInvalidPitchValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == kBF16 ? by_width<__nv_bfloat16>(bn, map_a, map_b, p, s) : by_width<__half>(bn, map_a, map_b, p, s);
}

}  // extern "C"
