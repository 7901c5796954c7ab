// The four-step FFT for Hopper (sm_90a), in one launch or in two, as in-block
// Stockham radix passes:
//
//   tml_four_step_fft: for planar f32 rows x = (xr, xi) (rows, N), N = n1 n2 <=
//                      16384, and the table of the N forward roots tab[j] = w^j,
//                      w = exp(-2 pi i / N) (interleaved (re, im), f32, built in
//                      float64), writes the unnormalised DFT y = (yr, yi)
//                      (rows, N), forward or inverse, in natural order. mode 1
//                      is one launch; mode 2 two, cut where the reference cuts
//                      its two kernels, through `scratch` (2 rows N f32).
//
// Replaces the TPU kernels of tpumathlib/fft/kernels.py: pallas_fft's
// pallas_call (:217, tile kernel :130), which keeps a tile of rows in VMEM
// through both DFT stages (mode 1); and of tpumathlib/fft/pallas_split.py:
// pallas_fft2's two pallas_calls (:95, stage kernels :40 and :56), which send
// the intermediate C (b, n2, k1) through device memory (mode 2).
// tpumathlib_torch/fft/kernels.py holds the wrappers, the plain PyTorch
// version (_four_step_plain, the reference's DFT products) and the host plan
// (_four_step_plan).
//
// What bounds it: its bytes, the planes read and written once, 16 rows N bytes
// (268 MB at 4096 x 4096 or 1024 x 16384: 0.080 ms at 3.35 TB/s); mode 2 moves
// C through device memory as well, 32 rows N bytes (0.160 ms). An FFT's
// 5 N log2 N flop a row take 0.015 ms at 67 TFLOP/s. The reference computes
// each stage as a DFT product, 8 N (n1 + n2) flop a row (17× an FFT's at 4096),
// which on the FP32 pipes alone would need 0.256 ms; so this kernel runs radix
// passes instead and does the FFT's own work. Measured (chip_smoke.py phase
// 35; NVIDIA H100 80GB HBM3, 700.00 W): mode 1 0.1030 ms at 4096 x 4096 (77.8 %
// of its bound) and 0.1698 ms at 1024 x 16384 (47.2 %: one 1024-thread block
// an SM, its passes instruction-bound); mode 2 0.2110 and 0.2769 ms (76.0 % and
// 57.9 % of its own 0.160); torch.fft.fft 0.0961 and 0.1181 ms.
//
// The design (the passes, their twiddles, the pad and the direct pass live in
// stockham_passes.cuh, shared with B5's fft_dif.cu and B9's dx_fused.cu):
// - The plan. The host factors each transform's length into passes, as many
//   radix-16 as divide it, one radix-8, -4 or -2 for the power of two left, then
//   radix-3 and radix-5 passes, then one direct pass for each other prime factor
//   (a sum of that many terms an output, from the root table, in partial sums
//   of 64 terms; N = 127 and 12289 take one, 16383 = 3 43 127 two). The main
//   shapes hold radix passes only. Mode 1 transforms the whole row. Mode 2's
//   first launch runs the passes of n1 over the n2 columns and multiplies by
//   w^{k1 n2}; its second the passes of n2 over the n1 rows of C^T. The plan
//   comes as int32 words and reaches the kernel by value (a __grid_constant__
//   struct).
// - A launch sees each row as `lanes` interleaved transforms of `len` points
//   (point p of lane v at p lanes + v: lanes = 1 in mode 1, n2 then n1 in mode
//   2). A pass of radix R on butterfly u (j = u / lanes, v = u % lanes, k = j mod
//   ns, ns the length done before it) reads point r at flat index u + r N / R,
//   multiplies it by w_{ns R}^{r k}, runs an R-point DFT in registers and writes
//   point q to ((j - k) R + k + q ns) lanes + v: Stockham's autosort order, so
//   the last pass writes the natural order and no permutation pass is needed.
//   Adjacent threads take adjacent butterflies: the first pass reads device
//   memory and the last writes it coalesced.
// - Threads. A thread holds P points, ceil(P / R) butterflies a pass: 16 for
//   a power-of-two N >= 4 (radices 2, 4, 8, 16; N / 16 threads a row, so 256
//   at 4096 and 1024 at 16384, __launch_bounds__(1024): 64 registers), 64 for
//   any other N (also radix 3, 5, direct passes and the copy that N = 1 and
//   mode 2's n1 = 1 need; __launch_bounds__(256): up to 255 registers, since
//   a radix-3 pass holds 66 points). Rows share a block up to 256 threads and
//   227 KB of shared memory; one row a block from N = 4096. 16 points beat
//   32 at both main shapes, and at 32 the other family spilled.
// - Shared memory holds the row's two planes between passes (8 N bytes plus
//   padding and one float a row), written after every thread of the block
//   has read. The power-of-two family pads one float after every 32 (index
//   f + (f >> 5), one LEA.HI), so every read is free of bank conflicts and
//   every write but those of mode 1's ns = 16 pass (two runs of 16 floats
//   256 apart: two wavefronts). An XOR swizzle that is free of conflicts
//   everywhere costs about five integer operations an access and was slower
//   at 16384: the passes are instruction-bound. Registers,
//   not shared memory, bound the blocks an SM holds (1024 threads at 64
//   registers fill the register file at N = 16384), so exchanging one plane
//   at a time (4 N bytes, four barriers an exchange instead of two) would
//   add no block.
// - Twiddles. Point r of a butterfly needs w_{ns R}^{r k} = tab[r k N / (ns R)].
//   A thread loads w^e and w^{4e} (e = k N / (ns R)) and applies w^{(r mod 4)
//   e} then w^{4 (r div 4) e}, formed by products: two loads a butterfly
//   through L1 instead of R - 1 scattered ones. The inverse is the conjugate
//   of the forward transform of the conjugate: the kernel negates the
//   imaginary plane as it reads x and as it writes y, and runs the forward
//   passes on the one table.
// - One block a group of rows, no persistent loop: a persistent grid, and an
//   L2 prefetch of the next row, did not help (at 16384 a row already in L2
//   barely moved its time).

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "stockham_passes.cuh"

namespace {

using namespace tml_stockham;

constexpr int kMaxN = 16384;
constexpr int kPointsMixed = 64;     // points a thread for any N that is not a power of two >= 4
constexpr int kThreadsMixed = 256;   // that family's launch bound: up to 255 registers (a
                                     // radix-3 pass holds 66 points)
constexpr int kSmemMax = 232448;     // the shared memory a block may use on sm_90

// One block takes lp.rows rows (the last block may have fewer).
template <int P>
__global__ void __launch_bounds__(P == kPointsPow2 ? kThreadsPow2 : kThreadsMixed)
four_step_kernel(const __grid_constant__ Launch lp, const float* __restrict__ xr,
                 const float* __restrict__ xi, float* __restrict__ yr, float* __restrict__ yi,
                 const float2* __restrict__ tab, int64_t rows) {
  constexpr bool POW2 = P == kPointsPow2;
  extern __shared__ float smem[];
  const int sub = threadIdx.x / lp.threads;
  const int64_t row = int64_t(blockIdx.x) * lp.rows + sub;
  Row w;
  w.t = threadIdx.x - sub * lp.threads;
  w.live = row < rows;
  w.off = w.out = (w.live ? row : 0) * lp.n;
  w.sr = smem + sub * (2 * lp.ld + 1);
  for (int p = 0; p < lp.npasses; ++p) {
    const Pass ps = lp.pass[p];
    const bool first = p == 0, last = p + 1 == lp.npasses;
    switch (ps.radix) {
      case 2: radix_pass<2, P>(lp, ps, w, first, last, xr, xi, yr, yi, tab); break;
      case 4: radix_pass<4, P>(lp, ps, w, first, last, xr, xi, yr, yi, tab); break;
      case 8: radix_pass<8, P>(lp, ps, w, first, last, xr, xi, yr, yi, tab); break;
      case 16: radix_pass<16, P>(lp, ps, w, first, last, xr, xi, yr, yi, tab); break;
      default:
        if constexpr (!POW2) {
          if (ps.radix == 1) radix_pass<1, P>(lp, ps, w, first, last, xr, xi, yr, yi, tab);
          else if (ps.radix == 3) radix_pass<3, P>(lp, ps, w, first, last, xr, xi, yr, yi, tab);
          else if (ps.radix == 5) radix_pass<5, P>(lp, ps, w, first, last, xr, xi, yr, yi, tab);
          else direct_pass<P>(lp, ps, w, last, yr, yi, tab);
        }
    }
  }
  if (lp.to_scratch && w.live) {
    // C^T[n2][k1] = B[k1][n2] w^{k1 n2}: flat f = n2 n1 + k1, read where the
    // last pass put it (n2 (n1 + 1) + k1), written coalesced.
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const int f = w.t + s * lp.threads;
      if (f < lp.n) {
        const int b = POW2 ? f >> lp.log_len : f / lp.len;
        const int k1 = f - b * lp.len;
        float a = w.sr[f + b], c = w.sr[lp.ld + f + b];
        const float2 t = __ldg(tab + k1 * b);
        cmul(a, c, t.x, t.y);
        yr[w.off + f] = a;
        yi[w.off + f] = c;
      }
    }
  }
}

// Reads one launch of the plan at words[at]: (len, lanes, threads, rows,
// points, npasses, radices...). False where it does not describe a transform
// of want_len points over want_lanes lanes that the kernel can run.
bool parse_launch(const int32_t* words, int64_t count, int64_t& at, int n, int want_len,
                  int want_lanes, bool to_scratch, Launch& lp, bool& pow2) {
  lp = Launch{};
  if (at + 6 > count) return false;
  const int len = words[at], lanes = words[at + 1], threads = words[at + 2];
  const int rows = words[at + 3], points = words[at + 4], np = words[at + 5];
  at += 6;
  if (len != want_len || lanes != want_lanes || np < 0 || np >= kMaxPasses || at + np > count)
    return false;
  pow2 = points == kPointsPow2;
  if (pow2 ? (n < 4 || (n & (n - 1)) != 0) : points != kPointsMixed) return false;
  const int max_threads = pow2 ? kThreadsPow2 : kThreadsMixed;
  lp.points = points;
  if (threads < 1 || rows < 1 || int64_t(threads) * rows > max_threads ||
      int64_t(threads) * points < n)
    return false;
  lp.n = n;
  lp.len = len;
  lp.lanes = lanes;
  lp.log_len = ilog2(len);
  lp.log_lanes = ilog2(lanes);
  lp.threads = threads;
  lp.rows = rows;
  lp.to_scratch = to_scratch;
  lp.ld = (std::max(n + n / 32 + 1, n + (to_scratch ? lanes : 0)) + 31) / 32 * 32;
  int k = 0, ns = 1;
  if (np == 0 || !register_radix(words[at])) {   // a copy first (the other family's)
    if (pow2) return false;
    lp.pass[k++] = Pass{1, 1, n};
  }
  for (int p = 0; p < np; ++p) {
    const int r = words[at + p];
    if (r < 2 || int64_t(ns) * r > len || len % (ns * r) != 0) return false;
    if (pow2 && r != 2 && r != 4 && r != 8 && r != 16) return false;
    lp.pass[k++] = Pass{r, ns, n / (ns * r)};
    ns *= r;
  }
  if (ns != len) return false;
  lp.npasses = k;
  at += np;
  return true;
}

// Lets kernel `fn` take more than 48 KB of dynamic shared memory, once a device.
template <class Kernel>
cudaError_t allow_smem(Kernel* fn, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

template <int P>
cudaError_t launch(const Launch& lp, const float* xr, const float* xi, float* yr, float* yi,
                   const float2* tab, int64_t rows, cudaStream_t s) {
  static std::atomic<unsigned long long> allowed{0};
  const size_t smem = sizeof(float) * size_t(lp.rows) * (2 * size_t(lp.ld) + 1);
  if (smem > size_t(kSmemMax)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_smem(four_step_kernel<P>, allowed);
    if (e != cudaSuccess) return e;
  }
  const unsigned blocks = static_cast<unsigned>((rows + lp.rows - 1) / lp.rows);
  four_step_kernel<P><<<blocks, lp.rows * lp.threads, smem, s>>>(lp, xr, xi, yr, yi, tab, rows);
  return cudaGetLastError();
}

cudaError_t launch_any(const Launch& lp, bool pow2, const float* xr, const float* xi, float* yr,
                       float* yi, const float2* tab, int64_t rows, cudaStream_t s) {
  return lp.points == kPointsPow2 ? launch<kPointsPow2>(lp, xr, xi, yr, yi, tab, rows, s)
                                  : launch<kPointsMixed>(lp, xr, xi, yr, yi, tab, rows, s);
}

}  // namespace

extern "C" {

// xr, xi, yr, yi (rows, n1 n2) f32 contiguous; tab (n1 n2, 2) f32, the forward
// roots w^j; n1 n2 <= 16384; inverse 0 or 1. plan: plan_len int32 words, (mode,
// n1, n2) and each launch's (len, lanes, threads, rows, points, npasses,
// radices...) as fft/kernels.py::_four_step_plan builds them. mode 1: one
// launch; mode 2: two through scratch (2 rows n1 n2 f32). Launches on
// `stream`; returns the CUDA status of the last launch (0 on success).
int tml_four_step_fft(const void* xr, const void* xi, void* yr, void* yi, void* scratch,
                      const void* tab, int64_t rows, int64_t n1, int64_t n2, int mode, int inverse,
                      const int32_t* plan, int64_t plan_len, void* stream) {
  if (xr == nullptr || xi == nullptr || yr == nullptr || yi == nullptr || tab == nullptr ||
      plan == nullptr || rows < 0 || rows > 0x7fffffff || n1 < 1 || n2 < 1 || n1 * n2 > kMaxN ||
      (mode != 1 && mode != 2) || (mode == 2 && scratch == nullptr) || plan_len < 3 ||
      plan[0] != mode || plan[1] != n1 || plan[2] != n2)
    return cudaErrorInvalidValue;
  const int n = static_cast<int>(n1 * n2);
  Launch lps[2];
  bool pow2[2];
  int64_t at = 3;
  for (int l = 0; l < mode; ++l) {
    const int len = mode == 1 ? n : static_cast<int>(l == 0 ? n1 : n2);
    if (!parse_launch(plan, plan_len, at, n, len, n / len, mode == 2 && l == 0, lps[l], pow2[l]))
      return cudaErrorInvalidValue;
    lps[l].conj_in = l == 0 && inverse;
    lps[l].conj_out = l == mode - 1 && inverse;
  }
  if (at != plan_len) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x_re = static_cast<const float*>(xr);
  const float* x_im = static_cast<const float*>(xi);
  float* y_re = static_cast<float*>(yr);
  float* y_im = static_cast<float*>(yi);
  const float2* roots = static_cast<const float2*>(tab);
  if (mode == 1) return launch_any(lps[0], pow2[0], x_re, x_im, y_re, y_im, roots, rows, s);
  float* c_re = static_cast<float*>(scratch);
  float* c_im = c_re + rows * n;
  const cudaError_t e = launch_any(lps[0], pow2[0], x_re, x_im, c_re, c_im, roots, rows, s);
  if (e != cudaSuccess) return e;
  return launch_any(lps[1], pow2[1], c_re, c_im, y_re, y_im, roots, rows, s);
}

}  // extern "C"
