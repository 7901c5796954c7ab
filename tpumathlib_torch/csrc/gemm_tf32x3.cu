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
//                    C (may be D itself) and D, f32, with row strides;
//   tml_gemm_tf32x3_epilogue: the same product under B1's fused epilogue
//                    (tml_gemm_epilogue's contract): a batch, C of any
//                    dtype code with its strides (it may be D), the bias of
//                    each column, ReLU or tanh-GELU, aux (the f32 value
//                    before the activation), D in f32, bf16 or f16;
//   tml_dropout_matmul: D = where(u > rate, A B / (1 - rate), 0) in f32, u
//                    word gm * n + gn of tml_random_uniform(seed, m * n)
//                    (philox.cuh); with `exact` (operands exact in TF32:
//                    bf16 values widened to f32) one TF32 product a k8 step.
//
// Three epilogues of one kernel body (the Epilogue template argument):
// Axpby for the Mp ring GEMM (B12a, B12b: tpumathlib/mp/overlap.py:112,
// :190, through tpumathlib_torch/mp/overlap.py) and the trailing update of
// B4b (tpumathlib/solver/qr_onelaunch.py:439, through
// tpumathlib_torch/solver/qr_onelaunch.py::_DeviceOrgqr), which replace no
// TPU kernel of their own: the TPU's MXU multiplies f32 operands by passes
// of bf16 at the caller's precision, and the reference's f32 products at
// HIGHEST precision are what this gives on the card's tensor cores; Fused,
// B1's route for f32 operands (the TPU kernel
// tpumathlib/dx/gemm.py::pallas_matmul, body :193, epilogue :215-225;
// tpumathlib_torch/dx/gemm.py routes to it), which also carries the
// blocked factorizations' products; Dropout, B10b (the TPU kernel
// tpumathlib/dx/rng.py::dropout_matmul_kernel, :53, pallas_call :70).
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
// written), 0.030 ms for a (2048, 4096) chunk at 3.35 TB/s. B1 and B10b at
// 4096^3: 0.833 ms; the dropout's Philox draws (one block of ten rounds a
// run of 4 columns, two where the run's flat index is not a multiple of 4)
// are some 1 % of that.
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
// epilogues mask their stores. Each epilogue reads the finished tile from
// the ring, where stage_tile puts it once both consumers' products are
// done, so that the accumulator's registers are free for the GELU's tanhf,
// the bias and aux or Philox's ten rounds. Axpby and Fused take two
// neighbouring columns a thread (B1's loop: alpha, beta * C, ...; the
// thread that writes an element of D is the one that read it from C, so C
// may be D); Dropout takes runs of 4 neighbouring columns, a warp a row,
// so that one Philox block (two where the run's flat index gm * n + gn is
// not a multiple of 4) gives a run's 4 uniforms, and stores them as one
// 16-byte store where it can. A batch (grid z) reads A and B at their
// batch strides, 0 for a matrix every batch shares (its map has a batch of
// 1). With `exact` A comes in f32 and B as its hi plane alone (lo is 0 for
// a bf16 value): one product a k8 step, a stage of 32 KB, 6 stages.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_ring.cuh"
#include "philox.cuh"

namespace {

using namespace tml_ring;

enum SplitFlags : int { kTranspose = 1, kUnitLower = 2 };

// 128 x 128 tiles; stages of 64 KB (A's planes), 48 KB (A in f32, split in
// registers) or 32 KB (exact operands: A in f32, B's hi plane)
constexpr int kBN = 128, kStagesPlanes = 3, kStagesSplitA = 4, kStagesExact = 6;
constexpr int kConsumers = 256;           // two consumer warpgroups, then the producer warp
constexpr int kBlock = kConsumers + 32;

// The epilogues' parameters; each also gives the main loop m, n, k and
// whether A and B have a batch (grid z) or one matrix for every batch.
struct Axpby {
  const float* c;  // may be null, and may be d
  float* d;
  int64_t m, n, k;
  int64_t ldc, ldd;
  float alpha, beta;
  bool vec;  // two-wide stores of D: ldd even and D aligned to two elements
  int a_batched, b_batched;
};

struct Fused {  // fused_epilogue's fields (hopper_ring.cuh)
  const void* c;      // may be null, and may be d
  const float* bias;  // may be null
  void* d;
  float* aux;         // may be null
  int64_t m, n, k;
  int64_t c_sb, c_sm, c_sn;  // strides in elements
  int64_t d_sb, d_sm;        // D and aux share one layout, unit column stride
  float alpha, beta;
  int act, c_dtype, d_dtype;
  int a_batched, b_batched;
};

struct Dropout {
  float* d;
  int64_t m, n, k;
  int64_t ldd;
  uint32_t key0, key1;  // the seed's low and high words
  float rate, den;      // den = 1 - rate, rounded to f32 by the caller
  bool vec4;            // 16-byte stores of D: ldd a multiple of 4 and D 16-byte aligned
  int a_batched, b_batched;
};

// B12's and B4b's epilogue, as PR 20 wrote it: alpha, beta * C, the store.
__device__ __forceinline__ void epilogue(const Axpby& p, const float* tile, int64_t m0, int64_t n0,
                                         int64_t, int cg) {
  // B1's epilogue loop: two neighbouring columns a thread, 256 / BN rows a
  // step, kRows steps a pass, each uniform branch around all of a pass's rows
  constexpr int kLd = staged_ld<kBN>();
  constexpr int kPairs = kBN / 2, kStep = 128 / kPairs, kRows = 4;
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

// B1's epilogue on the f32 route.
__device__ __forceinline__ void epilogue(const Fused& p, const float* tile, int64_t m0, int64_t n0,
                                         int64_t bz, int cg) {
  fused_epilogue<kBN>(p, tile, m0, n0, bz, cg);
}

// B10b's: each thread a run of 4 neighbouring columns (a warp a row of the
// tile), kRows rows a pass so that their Philox chains overlap; the kept
// values divided by den, as the plain version divides by 1 - rate.
__device__ __forceinline__ void epilogue(const Dropout& p, const float* tile, int64_t m0,
                                         int64_t n0, int64_t, int cg) {
  constexpr int kLd = staged_ld<kBN>();
  constexpr int kQuads = kBN / 4, kStep = 128 / kQuads, kRows = 4;
  static_assert(64 % (kRows * kStep) == 0, "whole passes");
  const int t = threadIdx.x % 128, col = 4 * (t % kQuads);
  const int64_t gn = n0 + col;
  if (gn >= p.n) return;
  const bool four = p.vec4 && gn + 4 <= p.n;
  for (int r = t / kQuads; r < 64; r += kRows * kStep) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int64_t gm = m0 + cg * 64 + r + j * kStep;
      if (gm >= p.m) continue;
      const float4 a4 = *reinterpret_cast<const float4*>(tile + (r + j * kStep) * kLd + col);
      float u[4];
      tml_philox::uniforms4(static_cast<uint64_t>(gm * p.n + gn), p.key0, p.key1, u);
      const float v[4] = {u[0] > p.rate ? a4.x / p.den : 0.f, u[1] > p.rate ? a4.y / p.den : 0.f,
                          u[2] > p.rate ? a4.z / p.den : 0.f, u[3] > p.rate ? a4.w / p.den : 0.f};
      float* q = p.d + gm * p.ldd + gn;
      if (four) {
        *reinterpret_cast<float4*>(q) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (gn + c < p.n) q[c] = v[c];
      }
    }
  }
}

template <int BN, int STAGES, bool SPLIT_A, int PRODUCTS, typename Epilogue>
__global__ void __launch_bounds__(kBlock, 1)
gemm_tf32x3_kernel(const __grid_constant__ CUtensorMap map_ah, const __grid_constant__ CUtensorMap map_al,
                   const __grid_constant__ CUtensorMap map_bh, const __grid_constant__ CUtensorMap map_bl,
                   const Epilogue p) {
  constexpr uint32_t kStageBytes = tf32x3_stage_bytes<BN, SPLIT_A, PRODUCTS>();
  static_assert(2 * 64 * staged_ld<BN>() * 4 <= STAGES * kStageBytes, "the staged tile fits");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle repeats every 1024 bytes
  const int nk = static_cast<int>((p.k + kBK32 - 1) / kBK32);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN, bz = blockIdx.z;
  init_ring(full, empty);

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers) {
      const int za = p.a_batched ? bz : 0, zb = p.b_batched ? bz : 0;
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % STAGES, k0 = kb * kBK32;
        const uint32_t bar = smem_u32(&full[s]), sa = ring + s * kStageBytes;
        const uint32_t sb = sa + (SPLIT_A ? 1 : 2) * kABytes;
        mbar_wait(smem_u32(&empty[s]), ((kb / STAGES) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(bar, kStageBytes);
        tma_load(sa, &map_ah, k0, m0, za, bar);
        if (!SPLIT_A) tma_load(sa + kABytes, &map_al, k0, m0, za, bar);
        tma_load(sb, &map_bh, k0, n0, zb, bar);
        if (PRODUCTS == 3) tma_load(sb + BN * kRowBytes, &map_bl, k0, n0, zb, bar);
      }
    }
    return;
  }

  // consumer warpgroup cg: rows 64 * cg .. 64 * cg + 63 of the tile
  const int cg = threadIdx.x / 128;
  float acc[BN / 2];  // the sum of the stages' partials (0 where k = 0)
  consume_tf32x3<BN, STAGES, SPLIT_A, PRODUCTS>(acc, nk, ring, full, empty, cg);
  const float* tile = stage_tile<BN, STAGES, 2>(acc, smem_raw, ring, cg);
  epilogue(p, tile, m0, n0, bz, cg);
}

template <bool SPLIT_A, int PRODUCTS, typename Epilogue>
cudaError_t launch_gemm(const CUtensorMap (&maps)[4], const Epilogue& p, int64_t batch,
                        cudaStream_t stream) {
  constexpr int kStages = PRODUCTS == 1 ? kStagesExact : SPLIT_A ? kStagesSplitA : kStagesPlanes;
  constexpr int kSmem = kStages * static_cast<int>(tf32x3_stage_bytes<kBN, SPLIT_A, PRODUCTS>()) + 1024;
  auto* kernel = gemm_tf32x3_kernel<kBN, kStages, SPLIT_A, PRODUCTS, Epilogue>;
  // once a device: the host loops launch some 100 products a call
  static std::atomic<uint64_t> raised{0};
  const cudaError_t attr = raise_smem_once(reinterpret_cast<const void*>(kernel), kSmem, raised);
  if (attr != cudaSuccess) return attr;
  const int64_t gx = (p.n + kBN - 1) / kBN, gy = (p.m + kBM - 1) / kBM;
  if (gx > 2147483647LL || gy > 65535 || batch > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy), static_cast<unsigned>(batch));
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

// The tensor maps of A (its planes, or A in f32 where a_lo is null) and of
// B^T's planes (b_lo null with `exact`: its hi plane alone), K-major boxes of
// 32 x 128, each with its batch stride (a batch of 1 where the stride is 0
// or there is one matrix). Returns 0, or the entry points' error.
int encode_operands(CUtensorMap (&maps)[4], const float* a_hi, const float* a_lo, int64_t lda,
                    int64_t a_sb, const float* b_hi, const float* b_lo, int64_t ldb, int64_t b_sb,
                    int64_t batch, int64_t m, int64_t n, int64_t k, bool exact) {
  const bool split_a = a_lo == nullptr;
  const bool batched[2] = {batch > 1 && a_sb != 0, batch > 1 && b_sb != 0};
  const float* planes[4] = {a_hi, split_a ? a_hi : a_lo, b_hi, exact ? b_hi : b_lo};
  for (const float* q : planes)
    if (q == nullptr || !aligned16(q)) return cudaErrorInvalidValue;
  if (lda < k || ldb < k || lda % 4 || ldb % 4 || (batched[0] && a_sb % 4) ||
      (batched[1] && b_sb % 4))
    return cudaErrorInvalidValue;
  if (!encode_tiled()) return cudaErrorSymbolNotFound;
  const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  for (int i = 0; i < 4; ++i) {
    const bool is_a = i < 2;
    if ((i == 1 && split_a) || (i == 3 && exact)) continue;
    const CUresult rc = encode(&maps[i], f32, planes[i], k, is_a ? m : n, is_a ? lda : ldb, batch,
                               is_a ? a_sb : b_sb, batched[is_a ? 0 : 1], kBK32, is_a ? kBM : kBN, 4);
    if (rc != CUDA_SUCCESS) return cudaErrorInvalidPitchValue;
  }
  return cudaSuccess;
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
  Axpby p;
  p.c = c; p.d = d;
  p.m = m; p.n = n; p.k = k;
  p.ldc = ldc; p.ldd = ldd;
  p.alpha = alpha; p.beta = beta;
  p.vec = ldd % 2 == 0 && reinterpret_cast<uintptr_t>(d) % 8 == 0;
  p.a_batched = p.b_batched = 0;
  CUtensorMap maps[4] = {};  // unread when k == 0: no stage is loaded
  if (k > 0) {
    const int rc = encode_operands(maps, a_hi, a_lo, lda, 0, b_hi, b_lo, ldb, 0, 1, m, n, k, false);
    if (rc != cudaSuccess) return rc;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a_lo == nullptr ? launch_gemm<true, 3>(maps, p, 1, s) : launch_gemm<false, 3>(maps, p, 1, s);
}

// tml_gemm_epilogue's contract (gemm_epilogue.cu) for f32 A and B, given as
// tml_gemm_tf32x3 takes them: a_hi, a_lo A's planes (batch, m, k) or a_hi
// A in f32 and a_lo null; b_hi, b_lo the planes of B^T (batch, n, k).
// strides: A's batch and row strides, B^T's, C's batch, row and column
// strides, D's (and aux's) batch and row strides, in elements (a batch
// stride of 0: one matrix for every batch). C: any dtype code, or null; it
// may be D. bias: (n,) f32 or null. D: f32, bf16 or f16 (d_dtype 0, 1, 2),
// unit column stride; aux: f32 or null, D's layout. act: 0 none, 1 relu, 2
// tanh-GELU. Returns as tml_gemm_tf32x3; cudaErrorInvalidConfiguration for
// a batch or rows past a grid's 65535 blocks (the caller goes in pieces).
int tml_gemm_tf32x3_epilogue(const float* a_hi, const float* a_lo, const float* b_hi,
                             const float* b_lo, const void* c, const float* bias, void* d, float* aux,
                             int64_t batch, int64_t m, int64_t n, int64_t k, const int64_t* strides,
                             float alpha, float beta, int act, int c_dtype, int d_dtype, void* stream) {
  if (d == nullptr || strides == nullptr || batch < 0 || m < 0 || n < 0 || k < 0 || act < kNone ||
      act > kGelu || c_dtype < kF32 || c_dtype > kI8 || d_dtype < kF32 || d_dtype > kF16)
    return cudaErrorInvalidValue;
  if (batch == 0 || m == 0 || n == 0) return cudaSuccess;
  Fused p;
  p.c = c; p.bias = bias; p.d = d; p.aux = aux;
  p.m = m; p.n = n; p.k = k;
  p.c_sb = strides[4]; p.c_sm = strides[5]; p.c_sn = strides[6];
  p.d_sb = strides[7]; p.d_sm = strides[8];
  p.alpha = alpha; p.beta = beta;
  p.act = act; p.c_dtype = c_dtype; p.d_dtype = d_dtype;
  p.a_batched = batch > 1 && strides[0] != 0;
  p.b_batched = batch > 1 && strides[2] != 0;
  if (p.d_sm < n) return cudaErrorInvalidValue;
  CUtensorMap maps[4] = {};
  if (k > 0) {
    const int rc = encode_operands(maps, a_hi, a_lo, strides[1], strides[0], b_hi, b_lo, strides[3],
                                   strides[2], batch, m, n, k, false);
    if (rc != cudaSuccess) return rc;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a_lo == nullptr ? launch_gemm<true, 3>(maps, p, batch, s)
                         : launch_gemm<false, 3>(maps, p, batch, s);
}

// B10b: d (m, n) f32, row stride ldd, = where(u > rate, A B / den, 0), u
// the uniforms of tml_random_uniform(key, m * n) over the flat output; A
// and B^T as tml_gemm_tf32x3 takes them. exact = 1: A in f32 (a_lo null)
// and B^T's hi plane alone (b_lo unread), both exact in TF32, one product a
// k8 step. den is 1 - rate, rounded to f32 by the caller.
int tml_dropout_matmul(const float* a_hi, const float* a_lo, int64_t lda, const float* b_hi,
                       const float* b_lo, int64_t ldb, float* d, int64_t ldd, int64_t m, int64_t n,
                       int64_t k, uint32_t key0, uint32_t key1, float rate, float den, int exact,
                       void* stream) {
  if (d == nullptr || m < 0 || n < 0 || k < 0 || ldd < n || exact < 0 || exact > 1 ||
      (exact && a_lo != nullptr))
    return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  Dropout p;
  p.d = d;
  p.m = m; p.n = n; p.k = k;
  p.ldd = ldd;
  p.key0 = key0; p.key1 = key1;
  p.rate = rate; p.den = den;
  p.vec4 = ldd % 4 == 0 && aligned16(d);
  p.a_batched = p.b_batched = 0;
  CUtensorMap maps[4] = {};
  if (k > 0) {
    const int rc = encode_operands(maps, a_hi, a_lo, lda, 0, b_hi, b_lo, ldb, 0, 1, m, n, k, exact);
    if (rc != cudaSuccess) return rc;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (exact) return launch_gemm<true, 1>(maps, p, 1, s);
  return a_lo == nullptr ? launch_gemm<true, 3>(maps, p, 1, s) : launch_gemm<false, 3>(maps, p, 1, s);
}

}  // extern "C"
