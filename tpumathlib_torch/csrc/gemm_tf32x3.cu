// The 3xTF32 product of f32 matrices on Hopper's tensor cores (sm_90a), and
// the split pass that feeds it:
//
//   tml_split_tf32:  hi = rna_tf32(x), lo = rna_tf32(x - hi) of an f32
//                    (rows, cols) matrix, written as two f32 planes with row
//                    stride ldo; optionally transposed (the planes are then
//                    (cols, rows)), optionally with x's top (cols x cols)
//                    block read as unit lower triangular (1 on its
//                    diagonal, 0 above it: a masked V of Householder
//                    vectors);
//   tml_gemm_tf32x3: D = alpha * A B + beta * C, A given as the hi and lo
//                    planes of (m, k) or as (m, k) in f32 (split in the
//                    kernel), B as the planes of B^T (n, k), all K-major;
//                    C (may be D itself) and D, f32, with row strides.
//
// Replaces no TPU kernel: the TPU's MXU multiplies f32 operands by passes of
// bf16 at the caller's precision, and the reference's f32 products at
// HIGHEST precision are what this gives on the card's tensor cores. It is
// the product of the Mp ring GEMM (B12a, B12b: tpumathlib/mp/overlap.py:112,
// :190, through tpumathlib_torch/mp/overlap.py) and of the trailing update
// of B4b (tpumathlib/solver/qr_onelaunch.py:439, through
// tpumathlib_torch/solver/qr_onelaunch.py::_DeviceOrgqr).
//
// Why three products. TF32 keeps 10 mantissa bits, so one TF32 product is
// some 1e-4 off an f32 one at K = 4096. Split into hi + lo, each operand is
// carried to about 2^-22 of itself, and hi*hi + hi*lo + lo*hi is the f32
// product to within lo*lo (2^-22) and the f32 sums. The tensor cores read
// TF32 operands from f32 words and ignore their low 13 bits, so the split is
// a rounding, cvt.rna.tf32.f32 (RNA: to nearest, ties away from zero; x -
// hi is exact in f32), done by the split pass or, for A, by the consumers.
//
// What bounds it: 3 * 2 m n k operations at 495 TFLOP/s (TF32, dense): a
// ring step at (2048, 4096) @ (4096, 4096) is 206 GFLOP, 0.4165 ms. The
// split pass is bound by bytes: 12 an element (read once, two planes
// written), 0.030 ms for a (2048, 4096) chunk at 3.35 TB/s.
//
// Design: B1's ring (hopper_ring.cuh) with two planes a stage. One block of
// 288 threads computes a 128 x 128 tile of D: warpgroups 0 and 1 are the
// consumers (wgmma m64n128k8 tf32, three a k8 step), and the ninth warp is
// the producer, whose one thread keeps TMA loads of the four
// 128-byte-wide boxes of a stage in flight (A's hi and lo 128 x 32, B^T's
// hi and lo 128 x 32). A 32-value f32 row is one 128-byte swizzle row, as a
// 64-value 16-bit row is, so the K-major descriptors, the 1024-byte groups
// and the mbarrier ring are B1's. A stage is 64 KB: 3 stages. Where A lies
// as TMA reads it (a row stride of a multiple of 4, a 16-byte aligned
// base), it comes in f32 instead, a 48 KB stage, 4 stages: each consumer
// thread loads its four values of a k8 step's A fragment from the swizzled
// tile, splits them and issues wgmma with A from registers
// (stage_tf32x3_split_a), which saves the ring a split pass a product
// (0.04 ms each at a ring step) for a slower product. The tensor
// cores do not round their f32 additions to nearest, and one accumulator
// along k = 4096 drifted to 3e-5 of the result: each stage's products go
// into a fresh partial, summed into the accumulator in f32
// (consume_tf32x3). ptxas gives a thread of this block at most 168
// registers (it counts 288 threads as 384, setmaxnreg or not), which holds
// the accumulator and one partial (142 used) but not a second partial to
// overlap the sum with the next stage's products: with two, 210 registers
// at 256 threads, its loads from thread 0 made ptxas serialize the wgmma
// (C7518), and it was slower. A 128 x 256 tile (2 stages of 96 KB) would
// need twice the accumulators. TMA's zero fill masks ragged M, N and K; the
// epilogue masks its stores. The epilogue is B1's: the tile staged in the
// ring, then a loop over rows, two neighbouring columns a thread, alpha,
// beta * C and the store; the thread that writes an element of D is the
// one that read it from C, so C may be D.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_ring.cuh"

namespace {

using namespace tml_ring;

enum SplitFlags : int { kTranspose = 1, kUnitLower = 2 };

// 128 x 128 tiles; stages of 64 KB (A's planes) or 48 KB (A in f32, split in registers)
constexpr int kBN = 128, kStagesPlanes = 3, kStagesSplitA = 4;
constexpr int kConsumers = 256;           // two consumer warpgroups, then the producer warp
constexpr int kBlock = kConsumers + 32;

struct Params {
  const float* c;  // may be null, and may be d
  float* d;
  int64_t m, n, k;
  int64_t ldc, ldd;
  float alpha, beta;
  bool vec;  // two-wide stores of D: ldd even and D aligned to two elements
};

template <int BN, int STAGES, bool SPLIT_A>
__global__ void __launch_bounds__(kBlock, 1)
gemm_tf32x3_kernel(const __grid_constant__ CUtensorMap map_ah, const __grid_constant__ CUtensorMap map_al,
                   const __grid_constant__ CUtensorMap map_bh, const __grid_constant__ CUtensorMap map_bl,
                   const Params p) {
  constexpr uint32_t kStageBytes = tf32x3_stage_bytes<BN, SPLIT_A>();
  static_assert(2 * 64 * staged_ld<BN>() * 4 <= STAGES * kStageBytes, "the staged tile fits");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle repeats every 1024 bytes
  const int nk = static_cast<int>((p.k + kBK32 - 1) / kBK32);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  init_ring(full, empty);

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % STAGES, k0 = kb * kBK32;
        const uint32_t bar = smem_u32(&full[s]), sa = ring + s * kStageBytes;
        const uint32_t sb = sa + (SPLIT_A ? 1 : 2) * kABytes;
        mbar_wait(smem_u32(&empty[s]), ((kb / STAGES) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(bar, kStageBytes);
        tma_load(sa, &map_ah, k0, m0, 0, bar);
        if (!SPLIT_A) tma_load(sa + kABytes, &map_al, k0, m0, 0, bar);
        tma_load(sb, &map_bh, k0, n0, 0, bar);
        tma_load(sb + BN * kRowBytes, &map_bl, k0, n0, 0, bar);
      }
    }
    return;
  }

  // consumer warpgroup cg: rows 64 * cg .. 64 * cg + 63 of the tile
  const int cg = threadIdx.x / 128;
  float acc[BN / 2];  // the sum of the stages' partials (0 where k = 0)
  consume_tf32x3<BN, STAGES, SPLIT_A>(acc, nk, ring, full, empty, cg);
  constexpr int kLd = staged_ld<BN>();
  const float* tile = stage_tile<BN, STAGES, 2>(acc, smem_raw, ring, cg);

  // B1's epilogue loop: two neighbouring columns a thread, 256 / BN rows a
  // step, kRows steps a pass, each uniform branch around all of a pass's rows
  constexpr int kPairs = BN / 2, kStep = 128 / kPairs, kRows = 4;
  static_assert(64 % (kRows * kStep) == 0, "whole passes");
  const int t = threadIdx.x % 128, col = 2 * (t % kPairs);
  const int64_t gn = n0 + col;
  if (gn >= p.n) return;
  const bool two = gn + 1 < p.n;
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
        const int64_t ci = gm[j] * p.ldc + gn;
        v0[j] += p.beta * p.c[ci];
        if (two) v1[j] += p.beta * p.c[ci + 1];
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (gm[j] < p.m) store_pair(p.d, gm[j] * p.ldd + gn, v0[j], v1[j], two, p.vec);
  }
}

template <bool SPLIT_A>
cudaError_t launch_gemm(const CUtensorMap (&maps)[4], const Params& p, cudaStream_t stream) {
  constexpr int kStages = SPLIT_A ? kStagesSplitA : kStagesPlanes;
  constexpr int kSmem = kStages * static_cast<int>(tf32x3_stage_bytes<kBN, SPLIT_A>()) + 1024;
  auto* kernel = gemm_tf32x3_kernel<kBN, kStages, SPLIT_A>;
  // the limit is a per-device attribute of the function: set it on every launch
  const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const int64_t gx = (p.n + kBN - 1) / kBN, gy = (p.m + kBM - 1) / kBM;
  if (gx > 2147483647LL || gy > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  kernel<<<grid, kBlock, kSmem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

constexpr int kSplitThreads = 256, kSplitTile = 32;

__device__ __forceinline__ float unit_lower_at(float v, int64_t r, int64_t c, int64_t cols) {
  return r < cols && c >= r ? (c == r ? 1.f : 0.f) : v;
}

// The split in place of the layout: a block takes 4 * 256 columns of
// kSplitRows rows (four neighbouring values a thread and row, one 16-byte
// load and two 16-byte stores where `vec`; the rows' loads issued
// together), row groups past the grid's y extent in a loop.
constexpr int kSplitRows = 4;

__global__ void __launch_bounds__(kSplitThreads)
split_rows_kernel(const float* __restrict__ x, int64_t ldx, float* __restrict__ hi,
                  float* __restrict__ lo, int64_t ldo, int64_t rows, int64_t cols, bool unit_lower,
                  bool vec) {
  const int64_t c0 = (int64_t(blockIdx.x) * kSplitThreads + threadIdx.x) * 4;
  if (c0 >= cols) return;
  const bool whole = vec && c0 + 4 <= cols;
  for (int64_t r0 = int64_t(blockIdx.y) * kSplitRows; r0 < rows; r0 += int64_t(gridDim.y) * kSplitRows) {
    float v[kSplitRows][4];
#pragma unroll
    for (int i = 0; i < kSplitRows; ++i) {
      const int64_t r = r0 + i;
      if (r >= rows) continue;
      if (whole) {
        const float4 t = *reinterpret_cast<const float4*>(x + r * ldx + c0);
        v[i][0] = t.x, v[i][1] = t.y, v[i][2] = t.z, v[i][3] = t.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] = c0 + j < cols ? x[r * ldx + c0 + j] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kSplitRows; ++i) {
      const int64_t r = r0 + i;
      if (r >= rows) continue;
      float h[4], l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float w = unit_lower ? unit_lower_at(v[i][j], r, c0 + j, cols) : v[i][j];
        h[j] = __uint_as_float(rna_tf32(w));
        l[j] = __uint_as_float(rna_tf32(w - h[j]));
      }
      if (whole) {
        *reinterpret_cast<float4*>(hi + r * ldo + c0) = make_float4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<float4*>(lo + r * ldo + c0) = make_float4(l[0], l[1], l[2], l[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c0 + j < cols) {
            hi[r * ldo + c0 + j] = h[j];
            lo[r * ldo + c0 + j] = l[j];
          }
        }
      }
    }
  }
}

// The transposed split, by 32 x 32 tiles through shared memory (33 columns:
// no bank conflicts): a warp reads 32 neighbouring values of a row of x and
// writes 32 neighbouring values of a row of the planes; row tiles past the
// grid's y extent in a loop.
__global__ void __launch_bounds__(kSplitThreads)
split_cols_kernel(const float* __restrict__ x, int64_t ldx, float* __restrict__ hi,
                  float* __restrict__ lo, int64_t ldo, int64_t rows, int64_t cols, bool unit_lower) {
  __shared__ float tile[kSplitTile][kSplitTile + 1];
  const int tx = threadIdx.x % kSplitTile, ty = threadIdx.x / kSplitTile;
  const int64_t c0 = int64_t(blockIdx.x) * kSplitTile;
  for (int64_t r0 = int64_t(blockIdx.y) * kSplitTile; r0 < rows; r0 += int64_t(gridDim.y) * kSplitTile) {
    for (int i = ty; i < kSplitTile; i += kSplitThreads / kSplitTile) {
      const int64_t r = r0 + i, c = c0 + tx;
      if (r < rows && c < cols) {
        const float v = x[r * ldx + c];
        tile[i][tx] = unit_lower ? unit_lower_at(v, r, c, cols) : v;
      }
    }
    __syncthreads();
    for (int i = ty; i < kSplitTile; i += kSplitThreads / kSplitTile) {
      const int64_t orow = c0 + i, ocol = r0 + tx;  // the planes are (cols, rows)
      if (orow >= cols || ocol >= rows) continue;
      const float v = tile[tx][i], h = __uint_as_float(rna_tf32(v));
      hi[orow * ldo + ocol] = h;
      lo[orow * ldo + ocol] = __uint_as_float(rna_tf32(v - h));
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// x (rows, cols) with row stride ldx; hi and lo (rows, cols), or (cols,
// rows) with flags & 1, with row stride ldo; flags & 2: x's top (cols x
// cols) block read as unit lower triangular. Launches on `stream`; returns
// the CUDA status (cudaErrorInvalidValue for arguments it does not take).
int tml_split_tf32(const float* x, int64_t ldx, float* hi, float* lo, int64_t ldo, int64_t rows,
                   int64_t cols, int flags, void* stream) {
  const bool transpose = flags & kTranspose;
  if (x == nullptr || hi == nullptr || lo == nullptr || rows < 0 || cols < 0 || flags < 0 ||
      flags > (kTranspose | kUnitLower) || ldx < cols || ldo < (transpose ? rows : cols))
    return cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool unit_lower = flags & kUnitLower;
  if (transpose) {
    const int64_t gx = (cols + kSplitTile - 1) / kSplitTile, gy = (rows + kSplitTile - 1) / kSplitTile;
    if (gx > 2147483647LL) return cudaErrorInvalidValue;
    const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy < 65535 ? gy : 65535));
    split_cols_kernel<<<grid, kSplitThreads, 0, s>>>(x, ldx, hi, lo, ldo, rows, cols, unit_lower);
  } else {
    const bool vec = aligned16(x) && aligned16(hi) && aligned16(lo) && ldx % 4 == 0 && ldo % 4 == 0;
    const int64_t gx = (cols + 4 * kSplitThreads - 1) / (4 * kSplitThreads);
    const int64_t gy = (rows + kSplitRows - 1) / kSplitRows;
    const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy < 65535 ? gy : 65535));
    split_rows_kernel<<<grid, kSplitThreads, 0, s>>>(x, ldx, hi, lo, ldo, rows, cols, unit_lower, vec);
  }
  return cudaGetLastError();
}

// D (m, n) = alpha * A B + beta * C. a_hi, a_lo: A's planes (m, k), row
// stride lda, or a_hi A itself in f32 and a_lo null (A is then split in the
// consumers' registers); b_hi, b_lo: B^T's planes (n, k), row stride ldb; every plane
// 16-byte aligned with its row stride a multiple of 4 (TMA's). C: f32 (m,
// n), row stride ldc, or null; it may be D. D: f32 (m, n), row stride ldd.
// Launches on `stream`; returns 0,
// or a CUDA error: cudaErrorInvalidValue for an argument it does not take,
// cudaErrorSymbolNotFound where the driver has no tensor-map encoder,
// cudaErrorInvalidPitchValue where it refuses a map.
int tml_gemm_tf32x3(const float* a_hi, const float* a_lo, int64_t lda, const float* b_hi,
                    const float* b_lo, int64_t ldb, const float* c, int64_t ldc, float* d, int64_t ldd,
                    int64_t m, int64_t n, int64_t k, float alpha, float beta, void* stream) {
  if (d == nullptr || m < 0 || n < 0 || k < 0 || ldd < n || (c != nullptr && ldc < n))
    return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  Params p;
  p.c = c; p.d = d;
  p.m = m; p.n = n; p.k = k;
  p.ldc = ldc; p.ldd = ldd;
  p.alpha = alpha; p.beta = beta;
  p.vec = ldd % 2 == 0 && reinterpret_cast<uintptr_t>(d) % 8 == 0;
  const bool split_a = a_lo == nullptr;  // A in f32, split in the consumers' registers
  CUtensorMap maps[4] = {};  // unread when k == 0: no stage is loaded
  if (k > 0) {
    const float* planes[4] = {a_hi, split_a ? a_hi : a_lo, b_hi, b_lo};
    for (const float* q : planes)
      if (q == nullptr || !aligned16(q)) return cudaErrorInvalidValue;
    if (lda < k || ldb < k || lda % 4 || ldb % 4) return cudaErrorInvalidValue;
    if (!encode_tiled()) return cudaErrorSymbolNotFound;
    const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    for (int i = 0; i < 4; ++i) {
      const bool is_a = i < 2;
      if (i == 1 && split_a) continue;
      const CUresult rc = encode(&maps[i], f32, planes[i], k, is_a ? m : n, is_a ? lda : ldb, 1, 0,
                                 false, kBK32, is_a ? kBM : kBN, 4);
      if (rc != CUDA_SUCCESS) return cudaErrorInvalidPitchValue;
    }
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return split_a ? launch_gemm<true>(maps, p, s) : launch_gemm<false>(maps, p, s);
}

}  // extern "C"
