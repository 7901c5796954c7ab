// The matmul four-step FFT for Hopper (sm_90a), in one launch or in two:
//
//   tml_four_step_fft: for planar f32 rows x = (xr, xi) (rows, N), N = n1 n2 <=
//                      16384, and the table of the N roots tab[j] = w_N^j
//                      (interleaved (re, im), f32), writes the unnormalised DFT
//                      y = (yr, yi) (rows, N) with w_N = exp(-+2 pi i / N) as the
//                      table was built. mode 1 runs the fused kernel; mode 2 runs
//                      stage 1 and stage 2 as two kernels through `scratch`
//                      (2 rows N f32: the intermediate C, re plane then im).
//
// Replaces the TPU kernels of tpumathlib/fft/kernels.py: pallas_fft's
// pallas_call (:217, tile kernel :130), which keeps a tile of rows in VMEM
// through both DFT stages, the twiddle and the index transpose (mode 1); and of
// tpumathlib/fft/pallas_split.py: pallas_fft2's two pallas_calls (:95, stage
// kernels :40 and :56), which send the intermediate C (b, n2, k1) through
// device memory (mode 2). tpumathlib_torch/fft/kernels.py and
// tpumathlib_torch/fft/pallas_split.py hold the wrappers and the plain PyTorch
// version (_four_step_plain).
//
// The computation of one row, with A[n1, n2] = x[n1 n2' + n2] (n2' the length):
//   stage 1  B[k1, n2] = sum_{n1} w_{n1}^{k1 n1} A[n1, n2]     (a DFT over n1)
//   twiddle  C[k1, n2] = B[k1, n2] w_N^{k1 n2}
//   stage 2  D[k1, k2] = sum_{n2} C[k1, n2] w_{n2}^{n2 k2}     (a DFT over n2)
//   output   y[k2 n1 + k1] = D[k1, k2]
// Every factor is an entry of the one root table: w_{n1}^t = tab[(t mod n1) n2],
// w_{n2}^t = tab[(t mod n2) n1], the twiddle tab[k1 n2] (k1 n2 < N). The
// reference builds (n1, n1) and (n2, n2) DFT matrices instead; their entries
// equal the table's within one f32 rounding, and the table is 8 N bytes (128 KB
// at N = 16384) where the matrices grow to 8 N^2 bytes for a prime N (n1 = 1).
// It stays in device memory and is read through L1 and L2.
//
// One block takes one row: 256 threads, or 1024 in the fused kernel when C
// takes more than 64 KB of shared memory, where only one or two blocks fit on
// an SM (with 256 threads, N = 16384 ran at 8 warps an SM and took 5.12 ms at
// 1024 x 16384 on an H100 at 700 W, slower than the split form). Stage 1 gives
// each thread one n2 and four k1 (adjacent threads on adjacent n2: the reads of
// A coalesce, and the four table entries a step are the same for the whole
// warp, one broadcast load each); it writes C transposed, C^T[n2][k1], to
// shared memory with a row stride of n1 + 1 when n1 is even, so that the writes
// of a warp (adjacent n2) fall in distinct banks. Stage 2 gives each thread one
// k1 and four k2 (adjacent threads on adjacent k1: the reads of C^T are
// conflict-free, the table loads broadcast and the writes of y[k2 n1 + k1]
// coalesce). Products are full complex f32 FMA (4 a complex product), not the
// reference's 3-product Karatsuba: that saves MXU passes on a TPU and nothing
// on Hopper's FP32 pipes. The table index of each sum is carried as (t mod n)
// scaled, one add and one compare a step. Shared memory is 8 n2 (n1 + 1) bytes
// at most, 132,096 at N = 16384 and 196,584 for the worst split (n1 = 2, n2 =
// 8191). Mode 2 runs the same two stages as two kernels, C^T (rows, n2, k1) in
// device memory.
//
// What bounds the function: its bytes, the planes read and written once, 16
// rows N bytes (268 MB at 4096 x 4096, 0.080 ms at 3.35 TB/s); an FFT's
// 5 N log2 N flop a row takes 0.015 ms at 67 TFLOP/s. The DFT-as-matmul
// formulation does 8 N (n1 + n2) flop a row, 17.2 GFLOP at 4096 x 4096, which on
// the FP32 pipes alone cannot take less than 0.256 ms; with a table load and
// the index arithmetic beside the 4 FMA of each complex product, it needs about
// 0.53 ms of issue. Mode 2 moves twice mode 1's bytes. Measured on an H100 at
// 700 W (chip_smoke.py phase 35): 1.26 ms fused, 1.67 ms split (not profiled).

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 256;         // threads a block
constexpr int kWideThreads = 1024;    // the fused kernel's block when C takes > 64 KB
constexpr int kMaxN = 16384;
constexpr int kTile = 4;              // k1 (stage 1) or k2 (stage 2) a thread
constexpr int kSmemMax = 232448;      // the shared memory a block may use on sm_90

__host__ __device__ __forceinline__ int c_stride(int n1) { return n1 + ((n1 & 1) ^ 1); }

// Stage 1 and the twiddle: ct_re/ct_im[n2 * ldc + k1] = C[k1, n2] for one row.
__device__ __forceinline__ void stage1(const float* __restrict__ xr, const float* __restrict__ xi,
                                       float* ct_re, float* ct_im, int ldc,
                                       const float2* __restrict__ tab, int n1, int n2) {
  const int n = n1 * n2;
  const int groups = (n1 + kTile - 1) / kTile;
  for (int task = threadIdx.x; task < n2 * groups; task += blockDim.x) {
    const int r = task % n2;              // n2
    const int c0 = (task / n2) * kTile;   // the first of this thread's k1
    float acc_re[kTile] = {}, acc_im[kTile] = {};
    int idx[kTile], step[kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      idx[i] = 0;
      step[i] = c0 + i < n1 ? (c0 + i) * n2 : 0;   // (k1 n1 mod n1) n2 grows by k1 n2
    }
    for (int j = 0; j < n1; ++j) {
      const float ar = __ldg(xr + j * n2 + r), ai = __ldg(xi + j * n2 + r);
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        const float2 w = __ldg(tab + idx[i]);
        acc_re[i] = fmaf(ar, w.x, fmaf(-ai, w.y, acc_re[i]));
        acc_im[i] = fmaf(ar, w.y, fmaf(ai, w.x, acc_im[i]));
        idx[i] += step[i];
        if (idx[i] >= n) idx[i] -= n;
      }
    }
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const int c = c0 + i;
      if (c < n1) {
        const float2 t = __ldg(tab + c * r);
        ct_re[r * ldc + c] = fmaf(acc_re[i], t.x, -acc_im[i] * t.y);
        ct_im[r * ldc + c] = fmaf(acc_re[i], t.y, acc_im[i] * t.x);
      }
    }
  }
}

// Stage 2 and the digit reversal: y[k2 n1 + k1] = sum_{n2} w_{n2}^{n2 k2} C[k1, n2].
__device__ __forceinline__ void stage2(const float* ct_re, const float* ct_im, int ldc,
                                       float* __restrict__ yr, float* __restrict__ yi,
                                       const float2* __restrict__ tab, int n1, int n2) {
  const int n = n1 * n2;
  const int groups = (n2 + kTile - 1) / kTile;
  for (int task = threadIdx.x; task < n1 * groups; task += blockDim.x) {
    const int c = task % n1;              // k1
    const int r0 = (task / n1) * kTile;   // the first of this thread's k2
    float acc_re[kTile] = {}, acc_im[kTile] = {};
    int idx[kTile], step[kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      idx[i] = 0;
      step[i] = r0 + i < n2 ? (r0 + i) * n1 : 0;   // (n2 k2 mod n2) n1 grows by k2 n1
    }
    for (int j = 0; j < n2; ++j) {
      const float cr = ct_re[j * ldc + c], ci = ct_im[j * ldc + c];
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        const float2 w = __ldg(tab + idx[i]);
        acc_re[i] = fmaf(cr, w.x, fmaf(-ci, w.y, acc_re[i]));
        acc_im[i] = fmaf(cr, w.y, fmaf(ci, w.x, acc_im[i]));
        idx[i] += step[i];
        if (idx[i] >= n) idx[i] -= n;
      }
    }
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const int r = r0 + i;
      if (r < n2) {
        yr[r * n1 + c] = acc_re[i];
        yi[r * n1 + c] = acc_im[i];
      }
    }
  }
}

__global__ void __launch_bounds__(kWideThreads)
four_step_fused_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                       float* __restrict__ yr, float* __restrict__ yi,
                       const float2* __restrict__ tab, int n1, int n2) {
  extern __shared__ float smem[];
  const int ldc = c_stride(n1);
  const int64_t off = int64_t(blockIdx.x) * n1 * n2;
  float* ct_re = smem;
  float* ct_im = smem + n2 * ldc;
  stage1(xr + off, xi + off, ct_re, ct_im, ldc, tab, n1, n2);
  __syncthreads();
  stage2(ct_re, ct_im, ldc, yr + off, yi + off, tab, n1, n2);
}

__global__ void __launch_bounds__(kThreads)
four_step_stage1_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                        float* __restrict__ ct_re, float* __restrict__ ct_im,
                        const float2* __restrict__ tab, int n1, int n2) {
  const int64_t off = int64_t(blockIdx.x) * n1 * n2;
  stage1(xr + off, xi + off, ct_re + off, ct_im + off, n1, tab, n1, n2);
}

__global__ void __launch_bounds__(kThreads)
four_step_stage2_kernel(const float* __restrict__ ct_re, const float* __restrict__ ct_im,
                        float* __restrict__ yr, float* __restrict__ yi,
                        const float2* __restrict__ tab, int n1, int n2) {
  const int64_t off = int64_t(blockIdx.x) * n1 * n2;
  stage2(ct_re + off, ct_im + off, n1, yr + off, yi + off, tab, n1, n2);
}

// Lets the fused kernel take up to the block's limit of shared memory. The
// attribute is kept per function and device, so it is set once a device.
cudaError_t allow_max_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(four_step_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemMax);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

}  // namespace

extern "C" {

// xr, xi, yr, yi (rows, n1 n2) f32 contiguous; tab (n1 n2, 2) f32, the roots
// w_N^j; n1 n2 <= 16384. mode 1: one fused kernel; mode 2: two kernels through
// scratch (2 rows n1 n2 f32). Launches on `stream`; returns the CUDA status of
// the last launch (0 on success).
int tml_four_step_fft(const void* xr, const void* xi, void* yr, void* yi, void* scratch,
                      const void* tab, int64_t rows, int64_t n1, int64_t n2, int mode,
                      void* stream) {
  if (xr == nullptr || xi == nullptr || yr == nullptr || yi == nullptr || tab == nullptr ||
      rows < 0 || rows > 0x7fffffff || n1 < 1 || n2 < 1 || n1 * n2 > kMaxN ||
      (mode != 1 && mode != 2) || (mode == 2 && scratch == nullptr))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int a = static_cast<int>(n1), b = static_cast<int>(n2);
  const unsigned grid = static_cast<unsigned>(rows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x_re = static_cast<const float*>(xr);
  const float* x_im = static_cast<const float*>(xi);
  float* y_re = static_cast<float*>(yr);
  float* y_im = static_cast<float*>(yi);
  const float2* roots = static_cast<const float2*>(tab);
  if (mode == 1) {
    const size_t smem = sizeof(float) * 2 * size_t(b) * c_stride(a);
    if (smem > size_t(kSmemMax)) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t e = allow_max_smem();
      if (e != cudaSuccess) return e;
    }
    const int threads = smem > 64 * 1024 ? kWideThreads : kThreads;
    four_step_fused_kernel<<<grid, threads, smem, s>>>(x_re, x_im, y_re, y_im, roots, a, b);
    return cudaGetLastError();
  }
  float* c_re = static_cast<float*>(scratch);
  float* c_im = c_re + rows * n1 * n2;
  four_step_stage1_kernel<<<grid, kThreads, 0, s>>>(x_re, x_im, c_re, c_im, roots, a, b);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  four_step_stage2_kernel<<<grid, kThreads, 0, s>>>(c_re, c_im, y_re, y_im, roots, a, b);
  return cudaGetLastError();
}

}  // extern "C"
