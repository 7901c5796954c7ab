// Blocked-ELL SpMM on the tensor cores, for Hopper (sm_90a): every operand
// pair of B6a, in two kernels.
//
//   tml_bell_spmm_wgmma:  Y = alpha * A @ B, A Blocked-ELL with mb block rows
//                         of ellw (bs x bs) blocks and a block-column table
//                         cols (mb, ellw) (-1 = pad slot), B dense (n, k)
//                         with rows ldb elements apart, Y (m, k) in B's
//                         dtype; f32 accumulation. bf16 x bf16 and f16 x f16.
//   tml_bell_spmm_tf32x3: the same product for f32 and mixed pairs (one
//                         operand f32, or bf16 with f16), as 3xTF32: A in its
//                         own dtype (f32, bf16 or f16), B as the TF32 planes
//                         of B^T (k, n) from tml_split_tf32, Y in f32, bf16
//                         or f16.
//
// Replaces the TPU kernel tpumathlib/sparse/pallas_kernels.py::
// bell_spmm_pallas (:98, body _bell_kernel :35, pallas_call :123), which
// runs its one dot at Precision.HIGHEST for f32 operands (:118-122);
// sparse/pallas_kernels.py::_spmm_route picks the kernel.
//
// What bounds them, at the bench shape (mb 128, ellw 16, bs 128, k 4096;
// 2 * nnz * k = 2.75e11 operations): 16-bit pairs at 989 TFLOP/s, 0.278 ms,
// against 0.100 ms for A, B and Y once each; f32 pairs as three TF32
// products at 495 TFLOP/s, 1.666 ms (f32 FMA outside the tensor cores would
// be 4.103 ms), against 0.2 ms for the operands and some 0.24 ms for the
// split of B^T (12 bytes an element of B). A pair of f32 with bf16 or f16
// needs two of the three products (the 16-bit operand's lo plane is 0:
// bf16 and f16 values are exact in TF32), 1.111 ms; bf16 with f16 one,
// 0.555 ms.
//
// Design. A Blocked-ELL product is a GEMM whose K loop walks (slot j, offset
// t): a tile of Y (128 rows of block row i, BN columns) sums, over the valid
// slots j of cols[i, :] and the k-stages t0 in bs, A's rows (i * ellw + j) *
// bs + r0 .. +127 at columns t0 .. (a K-major box of `data` viewed as (mb *
// ellw * bs, bs)) times B's rows cols[i, j] * bs + t0 ... Producer and
// consumers read the same cols row, uniform in the block, so they agree on
// the stages: valid slots x bs / (the stage's depth). A pad slot is skipped
// whatever its data holds; a block row of pads only has no stage and writes
// zeros. TMA's zero fill covers B's rows past n and columns past k; the
// epilogues mask rows past m and columns past k.
// - bell_wgmma_kernel (16-bit): B1's ring (hopper_ring.cuh), 64-deep stages:
//   one producer thread keeps TMA loads in flight in a ring of STAGES
//   stages, two consumer warpgroups issue wgmma m64nBNk16 into f32
//   accumulators; B is an N-major box, read through wgmma's transpose bit.
//   Its epilogue: alpha, the cast and the stores, 4 rows a pass.
// - bell_tf32x3_kernel (f32 and mixed): gemm_tf32x3.cu's 3xTF32 ring with
//   this slot walk in its producer: 288 threads, 128 x 128 tiles, 32-deep
//   stages of A's 128 x 32 (split in the consumers' registers,
//   stage_tf32x3_split_a) and B^T's hi and lo 128 x 32 (TF32 operands must
//   be K-major, so B is split and transposed once a call); each stage's
//   products go into a fresh partial summed into the accumulator in f32
//   (consume_tf32x3: the tensor cores' own additions do not round to
//   nearest). The products follow the operands (stages_b_lo): A in f32
//   with B^T's two planes, three a k8 step (48 KB stages); with B exact,
//   B^T's hi plane alone, lo·hi and hi·hi (32 KB). A 16-bit A comes as it
//   lies, a 64-byte row of 32 values, and is widened in registers, exact:
//   hi·lo and hi·hi with B^T's two planes (40 KB), hi·hi with B exact too
//   (24 KB). As many stages as fit 200 KB. The epilogue is B1's Fused one
//   (hopper_ring.cuh) with alpha alone, over the tile staged in the ring.
//
// Order. Consecutive blocks take the row tiles of a group of column tiles,
// the group's columns of B (or of B^T's planes) sized to stay in L2
// (kL2Budget): B is read from device memory about once, and A once a
// group, where launching the row tiles of one column at a time would read
// A once a column tile.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_ring.cuh"

namespace {

using namespace tml_ring;

// operand dtype codes (kF32 = 0, kBF16 = 1, kF16 = 2), as
// tpumathlib_torch/sparse/pallas_kernels.py passes them: hopper_ring.cuh's DType

constexpr int kSMs = 132;                // an H100 SXM's: fewer tiles than this leave SMs idle
constexpr int64_t kL2Budget = 24 << 20;  // bytes of B's columns a group of column tiles reads

// The slot walk of a block row, and the order of the tiles: both kernels'.
struct Walk {
  const int32_t* cols;
  int64_t row_tiles, col_tiles, group;  // tiles of Y, and column tiles a group
  int ellw, bs;
};

// This block's tile: block row i, its rows r0 .. r0 + 127 there, its
// columns n0 .. n0 + bn - 1; the row tiles of a group of column tiles in turn.
__device__ __forceinline__ void tile_of(const Walk& w, int bn, int64_t* i, int* r0, int* n0) {
  const int64_t per_group = w.group * w.row_tiles, g = blockIdx.x / per_group;
  const int64_t width = min(w.group, w.col_tiles - g * w.group), x = blockIdx.x % per_group;
  const int64_t rt = x / width, ct = g * w.group + x % width;
  *i = rt / (w.bs / kBM);
  *r0 = static_cast<int>(rt % (w.bs / kBM)) * kBM;
  *n0 = static_cast<int>(ct) * bn;
}

// The tiles of Y (m, k) in bn-wide columns, a group's columns of B (n rows of
// b_bytes a column) sized to kL2Budget.
inline void plan_tiles(Walk* w, int64_t m, int64_t n, int64_t k, int bn, int64_t b_bytes) {
  w->row_tiles = (m + kBM - 1) / kBM;
  w->col_tiles = (k + bn - 1) / bn;
  const int64_t b_cols_bytes = n * bn * b_bytes;
  w->group = b_cols_bytes > 0 ? kL2Budget / b_cols_bytes : w->col_tiles;
  w->group = w->group < 1 ? 1 : (w->group > w->col_tiles ? w->col_tiles : w->group);
}

struct Params {
  Walk w;
  void* y;
  int64_t m, k;  // Y's rows and columns
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
  int64_t i;
  int r0, n0;
  tile_of(p.w, BN, &i, &r0, &n0);
  const int32_t* crow = p.w.cols + i * p.w.ellw;
  init_ring(full, empty);

  if (wg == 0) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int kb = 0;
      for (int j = 0; j < p.w.ellw; ++j) {
        const int c = crow[j];
        if (c < 0) continue;  // a pad slot
        const int arow = static_cast<int>((i * p.w.ellw + j) * p.w.bs) + r0, brow = c * p.w.bs;
        for (int t0 = 0; t0 < p.w.bs; t0 += kBK, ++kb) {
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
  for (int j = 0; j < p.w.ellw; ++j) valid += crow[j] >= 0;
  const int nk = valid * (p.w.bs / kBK);
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
  const int64_t row0 = i * p.w.bs + r0 + cg * 64;
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
  static std::atomic<uint64_t> raised{0};
  const cudaError_t attr = raise_smem_once(reinterpret_cast<const void*>(kernel), kSmem, raised);
  if (attr != cudaSuccess) return attr;
  kernel<<<static_cast<unsigned>(p.w.row_tiles * p.w.col_tiles), kThreads, kSmem, s>>>(ma, mb, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_width(int bn, const CUtensorMap& ma, const CUtensorMap& mb, const Params& p,
                     cudaStream_t s) {
  return bn == 256 ? launch<T, 256, 4>(ma, mb, p, s) : launch<T, 128, 6>(ma, mb, p, s);
}

// --- f32 and mixed pairs: 3xTF32 ---------------------------------------------

constexpr int kTfBN = 128;                   // columns of a tile: m64n128k8 with A from registers
constexpr int kTfConsumers = 256;            // two consumer warpgroups, then the producer warp
constexpr int kTfBlock = kTfConsumers + 32;
constexpr uint32_t kTfRing = 200 << 10;      // bytes of stages: 4 of 48 KB ... 8 of 24 KB

template <typename TA, int PRODUCTS>
__host__ __device__ constexpr uint32_t tf_stage_bytes() {
  return tf32x3_stage_bytes<kTfBN, true, PRODUCTS, TA>();
}
template <typename TA, int PRODUCTS>
__host__ __device__ constexpr int tf_stages() {
  return static_cast<int>(kTfRing / tf_stage_bytes<TA, PRODUCTS>());
}

struct Tf32Params {  // fused_epilogue's fields (hopper_ring.cuh): alpha and D alone
  const void* c;      // null
  const float* bias;  // null
  void* d;            // Y
  float* aux;         // null
  int64_t m, n;       // Y's rows and columns
  int64_t c_sb, c_sm, c_sn, d_sb, d_sm;
  float alpha, beta;
  int act, c_dtype, d_dtype;
  Walk w;
};

template <typename TA, int PRODUCTS>
__global__ void __launch_bounds__(kTfBlock, 1)
bell_tf32x3_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_bh,
                   const __grid_constant__ CUtensorMap map_bl, const Tf32Params p) {
  constexpr int STAGES = tf_stages<TA, PRODUCTS>();
  constexpr uint32_t kStageBytes = tf_stage_bytes<TA, PRODUCTS>();
  static_assert(2 * 64 * staged_ld<kTfBN>() * 4 <= STAGES * kStageBytes, "the staged tile fits");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle repeats every 1024 bytes
  int64_t i;
  int r0, n0;
  tile_of(p.w, kTfBN, &i, &r0, &n0);
  const int32_t* crow = p.w.cols + i * p.w.ellw;
  init_ring(full, empty);

  if (threadIdx.x >= kTfConsumers) {  // the producer warp
    if (threadIdx.x == kTfConsumers) {
      int kb = 0;
      for (int j = 0; j < p.w.ellw; ++j) {
        const int c = crow[j];
        if (c < 0) continue;  // a pad slot
        const int arow = static_cast<int>((i * p.w.ellw + j) * p.w.bs) + r0, brow = c * p.w.bs;
        for (int t0 = 0; t0 < p.w.bs; t0 += kBK32, ++kb) {
          const int s = kb % STAGES;
          const uint32_t bar = smem_u32(&full[s]), sa = ring + s * kStageBytes, sb = sa + a_box_bytes<TA>();
          mbar_wait(smem_u32(&empty[s]), ((kb / STAGES) & 1) ^ 1);  // the first round passes
          mbar_expect_tx(bar, kStageBytes);
          tma_load(sa, &map_a, t0, arow, 0, bar);
          tma_load(sb, &map_bh, brow + t0, n0, 0, bar);
          if (stages_b_lo<TA, PRODUCTS>()) tma_load(sb + kTfBN * kRowBytes, &map_bl, brow + t0, n0, 0, bar);
        }
      }
    }
    return;
  }

  // consumer warpgroup cg: rows 64 * cg .. 64 * cg + 63 of the tile
  const int cg = threadIdx.x / 128;
  int valid = 0;
  for (int j = 0; j < p.w.ellw; ++j) valid += crow[j] >= 0;
  float acc[kTfBN / 2];  // the sum of the stages' partials (0 for a block row of pads only)
  consume_tf32x3<kTfBN, STAGES, true, PRODUCTS, TA>(acc, valid * (p.w.bs / kBK32), ring, full, empty, cg);
  const float* tile = stage_tile<kTfBN, STAGES>(acc, smem_raw, ring, cg);
  fused_epilogue<kTfBN>(p, tile, i * p.w.bs + r0, n0, 0, cg);
}

template <typename TA, int PRODUCTS>
cudaError_t launch_tf32x3(const CUtensorMap (&maps)[3], const Tf32Params& p, cudaStream_t s) {
  constexpr int kSmem = tf_stages<TA, PRODUCTS>() * static_cast<int>(tf_stage_bytes<TA, PRODUCTS>()) + 1024;
  auto* kernel = bell_tf32x3_kernel<TA, PRODUCTS>;
  static std::atomic<uint64_t> raised{0};
  const cudaError_t attr = raise_smem_once(reinterpret_cast<const void*>(kernel), kSmem, raised);
  if (attr != cudaSuccess) return attr;
  kernel<<<static_cast<unsigned>(p.w.row_tiles * p.w.col_tiles), kTfBlock, kSmem, s>>>(maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

bool aligned16(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; }

bool walk_args_ok(int64_t mb, int64_t ellw, int64_t bs, int64_t m, int64_t n, int64_t k) {
  return bs > 0 && bs % kBM == 0 && bs <= (1 << 15) && ellw >= 0 && mb >= 0 && m >= 0 &&
         m <= mb * bs && n >= 0 && k >= 0 && mb * ellw * bs < (1LL << 31) && n < (1LL << 31) &&
         k < (1LL << 31);
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
  if ((dtype != kBF16 && dtype != kF16) || !walk_args_ok(mb, ellw, bs, m, n, k) || ldb < k ||
      ldb % 8 != 0 || !aligned16(a) || !aligned16(b))
    return cudaErrorInvalidValue;
  if (m == 0 || k == 0) return cudaSuccess;
  Params p;
  p.w.cols = static_cast<const int32_t*>(cols);
  p.y = y;
  p.m = m;
  p.k = k;
  // with no slot or no row of B, every tile sums nothing: no stage is loaded
  p.w.ellw = n > 0 ? static_cast<int>(ellw) : 0;
  p.w.bs = static_cast<int>(bs);
  p.alpha = alpha;
  const int64_t row_tiles = (m + kBM - 1) / kBM;
  const int bn = row_tiles * ((k + 255) / 256) >= kSMs ? 256 : 128;
  plan_tiles(&p.w, m, n, k, bn, 2);
  if (p.w.row_tiles * p.w.col_tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  CUtensorMap map_a{}, map_b{};  // unread when there is no slot: no stage is loaded
  if (p.w.ellw > 0) {
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

// cols: (mb, ellw) int32, -1 = pad slot; a: (mb, ellw, bs, bs) contiguous
// in a_dtype (0 f32, 1 bf16, 2 f16); bt_hi, bt_lo: the TF32 planes of B^T
// (k, n) (tml_split_tf32 of B (n, k), transposed), row stride ldb, or bt_lo
// null where B is exact in TF32 (bf16 or f16 widened to f32); y: (m, k)
// contiguous in y_dtype (the same codes), m <= mb * bs. bs % 128 == 0; ldb
// >= n a multiple of 4 (16 bytes, TMA's row pitch); a and the planes
// 16-byte aligned. Three TF32 products a k8 step for an f32 A and bt_lo,
// two where one of them is exact (a 16-bit A, or bt_lo null), one where
// both are. Launches on `stream` and returns as tml_bell_spmm_wgmma.
int tml_bell_spmm_tf32x3(const void* cols, const void* a, const float* bt_hi, const float* bt_lo,
                         int64_t ldb, void* y, int64_t mb, int64_t ellw, int64_t bs, int64_t m,
                         int64_t n, int64_t k, float alpha, int a_dtype, int y_dtype, void* stream) {
  if (y == nullptr || y_dtype < kF32 || y_dtype > kF16 || a_dtype < kF32 || a_dtype > kF16 ||
      !walk_args_ok(mb, ellw, bs, m, n, k) || ldb < n || ldb % 4 != 0 || !aligned16(a) ||
      bt_hi == nullptr || !aligned16(bt_hi) || !aligned16(bt_lo))
    return cudaErrorInvalidValue;
  if (m == 0 || k == 0) return cudaSuccess;
  const bool b_lo = bt_lo != nullptr;
  Tf32Params p{};
  p.d = y;
  p.m = m;
  p.n = k;
  p.d_sm = k;
  p.alpha = alpha;
  p.d_dtype = y_dtype;
  p.w.cols = static_cast<const int32_t*>(cols);
  // with no slot or no row of B, every tile sums nothing: no stage is loaded
  p.w.ellw = n > 0 ? static_cast<int>(ellw) : 0;
  p.w.bs = static_cast<int>(bs);
  plan_tiles(&p.w, m, n, k, kTfBN, b_lo ? 8 : 4);
  if (p.w.row_tiles * p.w.col_tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  CUtensorMap maps[3] = {};  // unread when there is no slot: no stage is loaded
  if (p.w.ellw > 0) {
    if (!encode_tiled()) return cudaErrorSymbolNotFound;
    const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    // A: K-major boxes of 32 k x 128 rows of (mb * ellw * bs, bs), with the
    // 64-byte swizzle where its rows are 64 bytes (16-bit); B^T's planes:
    // K-major boxes of 32 x 128 of (k, n)
    const float* planes[2] = {bt_hi, b_lo ? bt_lo : bt_hi};
    CUresult rc = a_dtype == kF32
        ? encode(&maps[0], f32, a, bs, mb * ellw * bs, bs, 1, 0, false, kBK32, kBM, 4)
        : encode(&maps[0], a_dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                 a, bs, mb * ellw * bs, bs, 1, 0, false, kBK32, kBM, 2, CU_TENSOR_MAP_SWIZZLE_64B);
    for (int q = 0; q < 2 && rc == CUDA_SUCCESS; ++q)
      rc = encode(&maps[1 + q], f32, planes[q], n, k, ldb, 1, 0, false, kBK32, kTfBN, 4);
    if (rc != CUDA_SUCCESS) return cudaErrorInvalidPitchValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dtype == kF32) return b_lo ? launch_tf32x3<float, 3>(maps, p, s) : launch_tf32x3<float, 2>(maps, p, s);
  if (a_dtype == kBF16)
    return b_lo ? launch_tf32x3<__nv_bfloat16, 2>(maps, p, s) : launch_tf32x3<__nv_bfloat16, 1>(maps, p, s);
  return b_lo ? launch_tf32x3<__half, 2>(maps, p, s) : launch_tf32x3<__half, 1>(maps, p, s);
}

}  // extern "C"
