// Blocked-ELL SpMV, for Hopper (sm_90a):
//
//   tml_bell_spmv: y = alpha * A @ x, A Blocked-ELL with mb block rows of
//                  ellw (bs x bs) f32 blocks and a block-column table cols
//                  (mb, ellw) (-1 = pad slot), x (n,), y (m,), f32.
//
// Replaces the two execute kernels of SpmvPlan in
// tpumathlib/sparse/pallas_kernels.py, execute (:378, _bell_split_kernel
// :163, pallas_call :404) and _execute_rowform (:429, _bell_row_kernel
// :260, pallas_call :450), which also serves an f32 bell_spmv_pallas (:150).
// The two execute kernels differ only in TPU workarounds (bf16 hi/lo planes
// in place of f32 MXU products; transposed blocks and an 8-sublane
// interleave), so one f32 kernel here computes what both compute. The SpMM
// (bell_spmm_pallas, :98) is bell_wgmma.cu's, for every operand pair.
// tpumathlib_torch/sparse/pallas_kernels.py holds the wrappers and the plain
// PyTorch versions.
//
// Element (r, t) of slot j of block row i multiplies x[cols[i, j] * bs + t];
// entries at or past n read as zero, and a pad slot (cols < 0) is skipped
// whatever its data holds (the TPU kernel clamps pad ids to block 0 and
// relies on their data being zero).
//
// What bounds it, at the bench shape mb = nb = 128, ellw = 32, bs = 128: A
// is 268 MB, read once, against 2 flop per 4 bytes, so it is bound by
// device memory: 0.080 ms at 3.35 TB/s. Design: one warp per output row,
// lanes along t reading A's row in 16-byte vectors (coalesced 512 bytes a
// warp), four slots in flight a warp, x through the read-only cache (64 KB
// at the bench shape, resident in L1/L2), a warp reduction, y written once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

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
