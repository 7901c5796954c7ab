// Blocked-ELL sparse products, for Hopper (sm_90a):
//
//   tml_bell_spmm: Y = alpha * A @ B, A Blocked-ELL with mb block rows of
//                  ellw (bs x bs) blocks and a block-column table cols
//                  (mb, ellw) (-1 = pad slot), B dense (n, k), Y (m, k) in
//                  B's dtype; f32 accumulation.
//   tml_bell_spmv: y = alpha * A @ x, the same A in f32, x (n,), y (m,), f32.
//
// Replaces the TPU kernels of tpumathlib/sparse/pallas_kernels.py:
// bell_spmm_pallas (:98, body _bell_kernel :35, pallas_call :123; also
// bell_spmv_pallas :150 through it) and the two execute kernels of SpmvPlan,
// execute (:378, _bell_split_kernel :163, pallas_call :404) and
// _execute_rowform (:429, _bell_row_kernel :260, pallas_call :450). Those two
// differ only in TPU workarounds (bf16 hi/lo planes in place of f32 MXU
// products; transposed blocks and an 8-sublane interleave), so one f32 kernel
// here computes what both compute. tpumathlib_torch/sparse/pallas_kernels.py
// holds the wrappers and the plain PyTorch versions.
//
// In both, element (r, t) of slot j of block row i multiplies row
// cols[i, j] * bs + t of B (or x); rows at or past n read as zero, and a pad
// slot (cols < 0) is skipped whatever its data holds (the TPU kernel clamps
// pad ids to block 0 and relies on their data being zero).
//
// What bounds them, at the bench shapes:
// - SpMM, mb = nb = 128, ellw = 16, bs = 128, k = 4096, bf16: 2.75e11 flop
//   against 335 MB (A, B and Y once each), about 820 flop a byte, so it is
//   bound by the tensor cores: 0.278 ms at 989 TFLOP/s (bytes 0.100 ms).
//   Design: one block of 256 threads per 128 x 128 tile of Y (128 rows of one
//   block row, 128 columns), looping over the block row's slots and, inside
//   each, over K chunks of the slot's bs columns, which stands in for the TPU
//   kernel's sequential ell axis. Each chunk stages the A rows and the B rows
//   that the slot's column id names in shared memory. bf16 x bf16 and
//   f16 x f16 run on the tensor cores through WMMA (16 x 16 x 16 fragments,
//   f32 accumulators, eight warps of 64 x 32); every other operand pair
//   (f32, or mixed) is converted to f32 on load and summed as f32 FMA, never
//   TF32 (the reference runs f32 operands at HIGHEST). No cp.async or TMA
//   pipeline yet: the simple kernel first.
// - SpMV, mb = nb = 128, ellw = 32, bs = 128, f32: A is 268 MB, read once,
//   against 2 flop per 4 bytes, so it is bound by device memory: 0.080 ms at
//   3.35 TB/s. Design: one warp per output row, lanes along t reading A's
//   row in 16-byte vectors (coalesced 512 bytes a warp), four slots in flight
//   a warp, x through the read-only cache (64 KB at the bench shape, resident
//   in L1/L2), a warp reduction, y written once.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

// operand dtype codes, as tpumathlib_torch/sparse/pallas_kernels.py passes them
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

constexpr int kTile = 128;      // rows and columns of Y per thread block
constexpr int kThreads = 256;   // both SpMM kernels

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half_rn(v); }

struct SpmmArgs {
  const int32_t* cols;
  const void* a;
  const void* b;
  void* y;
  int64_t m, n, k;
  int ellw, bs;
  float alpha;
};

// The tile of blockIdx.x: block row i and the tile's first row r0 in it.
__device__ __forceinline__ void tile_rows(const SpmmArgs& p, int64_t* i, int* r0) {
  const int per_block = p.bs / kTile;
  *i = blockIdx.x / per_block;
  *r0 = static_cast<int>(blockIdx.x % per_block) * kTile;
}

// f32 FMA over operands converted on load: 8 x 8 outputs a thread.
template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads) spmm_simt(const SpmmArgs p) {
  constexpr int BK = 16, TM = 8, TN = 8, TX = kTile / TN;
  static_assert((kTile / TM) * (kTile / TN) == kThreads, "one 8 x 8 patch a thread");
  // +4 keeps rows 16-byte aligned and spreads the transposed A stores
  __shared__ float As[BK][kTile + 4];
  __shared__ float Bs[BK][kTile + 4];

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  int64_t i;
  int r0;
  tile_rows(p, &i, &r0);
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const TA* A = static_cast<const TA*>(p.a);
  const TB* B = static_cast<const TB*>(p.b);

  float acc[TM][TN];
#pragma unroll
  for (int u = 0; u < TM; ++u)
#pragma unroll
    for (int v = 0; v < TN; ++v) acc[u][v] = 0.f;

  for (int j = 0; j < p.ellw; ++j) {
    const int c = p.cols[i * p.ellw + j];
    if (c < 0) continue;  // pad slot; c is the same for the whole block
    const TA* blk = A + ((i * p.ellw + j) * p.bs + r0) * static_cast<int64_t>(p.bs);
    const int64_t brow = static_cast<int64_t>(c) * p.bs;
    for (int t0 = 0; t0 < p.bs; t0 += BK) {
      // A rows r0 .. r0+127, columns t0 .. t0+15, stored transposed
#pragma unroll
      for (int s = 0; s < kTile * BK / kThreads; ++s) {
        const int e = tid + s * kThreads;
        const int r = e / BK, kk = e % BK;
        As[kk][r] = to_f32(blk[static_cast<int64_t>(r) * p.bs + t0 + kk]);
      }
      // B rows brow + t0 .. +15, columns c0 .. c0+127
#pragma unroll
      for (int s = 0; s < BK * kTile / kThreads; ++s) {
        const int e = tid + s * kThreads;
        const int kk = e / kTile, cn = e % kTile;
        const int64_t gr = brow + t0 + kk, gc = c0 + cn;
        Bs[kk][cn] = (gr < p.n && gc < p.k) ? to_f32(B[gr * p.k + gc]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float ra[TM], rb[TN];
#pragma unroll
        for (int u = 0; u < TM; ++u) ra[u] = As[kk][ty * TM + u];
#pragma unroll
        for (int v = 0; v < TN; ++v) rb[v] = Bs[kk][tx * TN + v];
#pragma unroll
        for (int u = 0; u < TM; ++u)
#pragma unroll
          for (int v = 0; v < TN; ++v) acc[u][v] = fmaf(ra[u], rb[v], acc[u][v]);
      }
      __syncthreads();
    }
  }

  TB* Y = static_cast<TB*>(p.y);
#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int64_t gm = i * p.bs + r0 + ty * TM + u;
    if (gm >= p.m) continue;
#pragma unroll
    for (int v = 0; v < TN; ++v) {
      const int64_t gn = c0 + tx * TN + v;
      if (gn < p.k) store(Y + gm * p.k + gn, p.alpha * acc[u][v]);
    }
  }
}

// Tensor cores through WMMA, for bf16 x bf16 or f16 x f16 operands: eight
// warps, 2 along the rows x 4 along the columns, each holding 4 x 2
// accumulator fragments (64 x 32 of Y) in f32.
template <typename T>
__global__ void __launch_bounds__(kThreads) spmm_wmma(const SpmmArgs p) {
  using namespace nvcuda;
  constexpr int BK = 32;
  constexpr int LDA = BK + 8, LDB = kTile + 8;  // padded rows, multiples of 8 elements
  // 16-bit words of T (no constructors in shared memory)
  __shared__ __align__(128) uint16_t As[kTile * LDA];
  __shared__ __align__(128) uint16_t Bs[BK * LDB];
  __shared__ __align__(128) float stage[kThreads / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  int64_t i;
  int r0;
  tile_rows(p, &i, &r0);
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const T* A = static_cast<const T*>(p.a);
  const uint16_t* B16 = static_cast<const uint16_t*>(p.b);
  const bool b_vec = p.k % 8 == 0;  // rows of B start 16-byte aligned (the wrapper aligns B)

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 2; ++v) wmma::fill_fragment(acc[u][v], 0.f);

  for (int j = 0; j < p.ellw; ++j) {
    const int c = p.cols[i * p.ellw + j];
    if (c < 0) continue;  // pad slot; c is the same for the whole block
    const T* blk = A + ((i * p.ellw + j) * p.bs + r0) * static_cast<int64_t>(p.bs);
    const int64_t brow = static_cast<int64_t>(c) * p.bs;
    for (int t0 = 0; t0 < p.bs; t0 += BK) {
      // A: 128 rows x 32 columns, two 16-byte vectors a thread
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int e = tid + s * kThreads;
        const int r = e / (BK / 8), col = (e % (BK / 8)) * 8;
        *reinterpret_cast<uint4*>(&As[r * LDA + col]) =
            *reinterpret_cast<const uint4*>(blk + static_cast<int64_t>(r) * p.bs + t0 + col);
      }
      // B: 32 rows x 128 columns, two vectors of 8 a thread, zero past n and k
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int e = tid + s * kThreads;
        const int r = e / (kTile / 8), col = (e % (kTile / 8)) * 8;
        const int64_t gr = brow + t0 + r, gc = c0 + col;
        union {
          uint4 v;
          uint16_t h[8];
        } u;
        u.v = make_uint4(0u, 0u, 0u, 0u);
        if (gr < p.n) {
          const uint16_t* src = B16 + gr * p.k + gc;
          if (b_vec && gc + 8 <= p.k) {
            u.v = *reinterpret_cast<const uint4*>(src);
          } else {
#pragma unroll
            for (int q = 0; q < 8; ++q)
              if (gc + q < p.k) u.h[q] = src[q];
          }
        }
        *reinterpret_cast<uint4*>(&Bs[r * LDB + col]) = u.v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af[4];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf[2];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          wmma::load_matrix_sync(af[u], reinterpret_cast<const T*>(As + (wm * 64 + u * 16) * LDA + kk),
                                 LDA);
#pragma unroll
        for (int v = 0; v < 2; ++v)
          wmma::load_matrix_sync(bf[v], reinterpret_cast<const T*>(Bs + kk * LDB + wn * 32 + v * 16),
                                 LDB);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 2; ++v) wmma::mma_sync(acc[u][v], af[u], bf[v], acc[u][v]);
      }
      __syncthreads();
    }
  }

  // each fragment through the warp's 16 x 16 staging tile, then alpha, the
  // output cast and the ragged edges: lane l writes 8 values of row l / 2
  T* Y = static_cast<T*>(p.y);
  float* st = stage[warp];
  const int rr = lane / 2, cc = (lane % 2) * 8;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      wmma::store_matrix_sync(st, acc[u][v], 16, wmma::mem_row_major);
      __syncwarp();
      const int64_t gm = i * p.bs + r0 + wm * 64 + u * 16 + rr;
      const int64_t gn0 = c0 + wn * 32 + v * 16 + cc;
      if (gm < p.m) {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (gn0 + q < p.k) store(Y + gm * p.k + gn0 + q, p.alpha * st[rr * 16 + cc + q]);
      }
      __syncwarp();
    }
  }
}

template <typename TA, typename TB>
cudaError_t launch_simt(const SpmmArgs& p, dim3 grid, cudaStream_t s) {
  spmm_simt<TA, TB><<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

template <typename TA>
cudaError_t by_b(int b_dtype, const SpmmArgs& p, dim3 grid, cudaStream_t s) {
  switch (b_dtype) {
    case kF32: return launch_simt<TA, float>(p, grid, s);
    case kBF16: return launch_simt<TA, __nv_bfloat16>(p, grid, s);
    case kF16: return launch_simt<TA, __half>(p, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

constexpr int kSpmvWarps = 8;   // warps (output rows) a block
constexpr int kSpmvSlots = 4;   // slots in flight a warp

__global__ void __launch_bounds__(kSpmvWarps * 32)
spmv_kernel(const int32_t* __restrict__ cols, const float* __restrict__ a,
            const float* __restrict__ x, float* __restrict__ y, int64_t m, int64_t n, int ellw,
            int bs, float alpha) {
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kSpmvWarps + threadIdx.x / 32;
  if (row >= m) return;  // the whole warp
  const int64_t i = row / bs;
  const int r = static_cast<int>(row % bs);
  const int32_t* crow = cols + i * ellw;
  // A[i, j, r, t] sits at arow + j * slot + t
  const float* arow = a + (i * ellw * bs + r) * static_cast<int64_t>(bs);
  const int64_t slot = static_cast<int64_t>(bs) * bs;

  float acc = 0.f;
  for (int t = lane * 4; t < bs; t += 128) {
    for (int j0 = 0; j0 < ellw; j0 += kSpmvSlots) {
      float4 av[kSpmvSlots], xv[kSpmvSlots];
#pragma unroll
      for (int s = 0; s < kSpmvSlots; ++s) {
        const int j = j0 + s;
        const int c = j < ellw ? __ldg(crow + j) : -1;
        av[s] = make_float4(0.f, 0.f, 0.f, 0.f);
        xv[s] = av[s];
        if (c >= 0) {
          av[s] = __ldg(reinterpret_cast<const float4*>(arow + j * slot + t));
          const int64_t xi = static_cast<int64_t>(c) * bs + t;
          if (xi + 4 <= n) {
            xv[s] = __ldg(reinterpret_cast<const float4*>(x + xi));
          } else {
            xv[s].x = xi < n ? __ldg(x + xi) : 0.f;
            xv[s].y = xi + 1 < n ? __ldg(x + xi + 1) : 0.f;
            xv[s].z = xi + 2 < n ? __ldg(x + xi + 2) : 0.f;
            xv[s].w = xi + 3 < n ? __ldg(x + xi + 3) : 0.f;
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kSpmvSlots; ++s) {
        acc = fmaf(av[s].x, xv[s].x, acc);
        acc = fmaf(av[s].y, xv[s].y, acc);
        acc = fmaf(av[s].z, xv[s].z, acc);
        acc = fmaf(av[s].w, xv[s].w, acc);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) y[row] = alpha * acc;
}

}  // namespace

extern "C" {

// cols: (mb, ellw) int32, -1 = pad slot; a: (mb, ellw, bs, bs) contiguous in
// a_dtype; b: (n, k) contiguous in b_dtype; y: (m, k) contiguous in b_dtype,
// m <= mb * bs. bs % 128 == 0. a, b and y 16-byte aligned. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int tml_bell_spmm(const void* cols, const void* a, const void* b, void* y, int64_t mb,
                  int64_t ellw, int64_t bs, int64_t m, int64_t n, int64_t k, float alpha,
                  int a_dtype, int b_dtype, void* stream) {
  if (bs <= 0 || bs % kTile != 0 || bs > (1 << 15) || ellw < 0 || ellw > (1 << 20) || mb < 0 ||
      m < 0 || m > mb * bs || n < 0 || k < 0)
    return cudaErrorInvalidValue;
  if (m == 0 || k == 0) return cudaSuccess;
  const int64_t row_tiles = (m + kTile - 1) / kTile, col_tiles = (k + kTile - 1) / kTile;
  if (row_tiles > 0x7fffffff || col_tiles > 65535) return cudaErrorInvalidConfiguration;
  SpmmArgs p;
  p.cols = static_cast<const int32_t*>(cols);
  p.a = a; p.b = b; p.y = y;
  p.m = m; p.n = n; p.k = k;
  p.ellw = static_cast<int>(ellw);
  p.bs = static_cast<int>(bs);
  p.alpha = alpha;
  const dim3 grid(static_cast<unsigned>(row_tiles), static_cast<unsigned>(col_tiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dtype == b_dtype && a_dtype == kBF16) {
    spmm_wmma<__nv_bfloat16><<<grid, kThreads, 0, s>>>(p);
    return cudaGetLastError();
  }
  if (a_dtype == b_dtype && a_dtype == kF16) {
    spmm_wmma<__half><<<grid, kThreads, 0, s>>>(p);
    return cudaGetLastError();
  }
  switch (a_dtype) {
    case kF32: return by_b<float>(b_dtype, p, grid, s);
    case kBF16: return by_b<__nv_bfloat16>(b_dtype, p, grid, s);
    case kF16: return by_b<__half>(b_dtype, p, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

// cols: (mb, ellw) int32, -1 = pad slot; a: (mb, ellw, bs, bs) f32
// contiguous; x: (n,) f32; y: (m,) f32, m <= mb * bs. bs % 8 == 0. a and x
// 16-byte aligned. Launches on `stream` and returns cudaGetLastError().
int tml_bell_spmv(const void* cols, const void* a, const void* x, void* y, int64_t mb,
                  int64_t ellw, int64_t bs, int64_t m, int64_t n, float alpha, void* stream) {
  if (bs <= 0 || bs % 8 != 0 || bs > (1 << 15) || ellw < 0 || ellw > (1 << 20) || mb < 0 ||
      m < 0 || m > mb * bs || n < 0)
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const int64_t blocks = (m + kSpmvWarps - 1) / kSpmvWarps;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  spmv_kernel<<<static_cast<unsigned>(blocks), kSpmvWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols), static_cast<const float*>(a), static_cast<const float*>(x),
      static_cast<float*>(y), m, n, static_cast<int>(ellw), static_cast<int>(bs), alpha);
  return cudaGetLastError();
}

}  // extern "C"
