// Planar complex-to-complex FFT over the last axis, for Hopper (sm_90a):
//
//   tml_dif_fft: (yr, yi) = DFT(xr + i xi) of every row of a (rows, N) pair
//                of f32 or bf16 planes, N a power of two >= 256, unnormalised
//                in both directions (the sign of the twiddle table picks the
//                direction), written in natural or in the reference's raw
//                order.
//
// Replaces the TPU kernel tpumathlib/fft/stockham.py::dif_fft (:335; body
// _pipeline_kernel :265 and _fft_chunk :191, pallas_call :382).
// tpumathlib_torch/fft/stockham.py::dif_fft is its wrapper.
//
// What bounds it: an FFT does 5 N log2 N flops for 8 N bytes of f32 planes
// read and written, so on this card it is bound by device memory: one read
// and one write of the planes at 3.35 TB/s is 0.080 ms for 4096 rows of
// N = 4096 in f32, 0.040 ms in bf16 planes; the flops (1.0e9 at 67 TFLOP/s
// f32) take 0.015 ms.
//
// Design: B5b's in-block Stockham radix passes (stockham_passes.cuh), on
// the power-of-two family: a row of N <= 16384 is transformed by N / 16
// threads, 16 points each, rows sharing a block up to 256 threads, in one
// launch. The first pass reads the planes straight into registers,
// coalesced; passes of radix 16 (and one of 8, 4 or 2) run in registers with
// two twiddle loads a butterfly, exchanging through shared memory padded by
// one float in 32.
// - Natural order: the Stockham order leaves the spectrum in natural order,
//   so the last pass writes y from registers, coalesced.
// - The raw order of groups of L (shuffle_perm(N, L / 128)): frequency
//   f = p G + r (G = N / L, s = log2 G) sits at bitrev_s(r) L + p. The plan
//   puts the odd radix first, so that the last pass is radix 16 with one
//   butterfly a thread, and raw_last_pass maps threads to butterflies so
//   that each 8 lanes store 8 neighbouring raw positions and a warp's reads
//   hit 32 banks: no extra pass through shared memory (with one, the raw
//   order took 20 % longer than natural order on an H100).
// - The direction: the table holds N / 2 roots exp(-+2 pi i k / N); a block
//   reads its sign at k = N / 4 (-+i) into shared memory. The passes are
//   forward; the inverse conjugates x as it is read, y as it is written and
//   the roots as they are loaded (TableSign).
// - Registers: up to 4096 points (blocks of up to 256 threads) the kernels
//   are bounded to 3 blocks an SM, 85 registers; 8192-point rows and segments
//   (512 threads) to the same 85. At 64, as a 16384-point row's 1024 threads
//   need, ptxas spills in the raw-order and bf16 instantiations (44-64
//   bytes), not in f32 natural order; at 128 and 255 (32 or 64 points a
//   thread) the raw and segment kernels spilled more.
// - Above N = 16384 the first log2(N / 8192) radix-2 stages of a
//   decimation in frequency run as passes of up to radix 16 over device
//   memory into an f32 scratch (global_pass: a thread reads 16 points k0 +
//   t h of a span, runs their DFT, multiplies output q by w^{k0 q} with the
//   same two-load twiddles and writes it at k0 + bitrev(q) h, in place after
//   the first pass). Each contiguous 8192-long segment seg of a row is then
//   an independent transform whose natural index k is frequency k 2^e +
//   bitrev_e(seg) (e = log2(N / 8192)); a block runs the in-block passes on
//   it and writes the output positions it holds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "stockham_passes.cuh"

namespace {

using namespace tml_stockham;

constexpr int kMaxLogRow = 14;      // rows up to 16384 points: one launch, 135 KB of shared memory
constexpr int kLogSeg = 13;         // longer rows: segments of 8192 points after the global passes
constexpr int kBlock = 256;         // rows share a block up to this many threads
constexpr int kSmemMax = 232448;    // the shared memory a block may use on sm_90
constexpr int kPassThreads = 256;   // threads a block of the global passes

// bits-wide bit reversal of x (0 for bits == 0)
__device__ __forceinline__ int brev(int x, int bits) {
  return bits ? static_cast<int>(__brev(static_cast<unsigned>(x)) >> (32 - bits)) : 0;
}

// +1 for the forward table, -1 for the inverse's: tab[N / 4] = -+i.
__device__ __forceinline__ float table_sign(const float2* tab, int log_n) {
  return __ldg(&tab[1 << (log_n - 2)].y) < 0.f ? 1.f : -1.f;
}

// What a launch of dif_kernel writes.
enum Order {
  kNatural,    // whole rows, natural order: the last pass writes y
  kRaw,        // whole rows, the raw order of groups of 2^lp.log_group: raw_last_pass
  kSegments,   // the segments of long rows: the last pass writes shared memory, the
               // epilogue the segment's output positions
};

// The in-block plan of a unit of 2^log_s points of a row of 2^log_n: radix-16
// passes and one of 8, 4 or 2 for the bits left, that one last (B5b's
// order), or first for the raw order, whose last pass must be radix 16;
// twiddle strides in the row's table of N / 2 roots.
Launch unit_launch(int log_s, int log_n, int log_l, int order) {
  Launch lp{};
  lp.log_row = log_n;
  lp.log_group = log_l;
  lp.log_segs = log_n - log_s;
  const int s = 1 << log_s;
  lp.n = lp.len = s;
  lp.lanes = 1;
  lp.log_len = log_s;
  lp.points = kPointsPow2;
  lp.threads = s / kPointsPow2;
  lp.ld = (s + s / 32 + 1 + 31) / 32 * 32;
  const int row_bytes = 4 * (2 * lp.ld + 1);
  const int fit = kBlock / lp.threads < kSmemMax / row_bytes ? kBlock / lp.threads
                                                              : kSmemMax / row_bytes;
  lp.rows = fit > 1 ? fit : 1;
  int k = 0, ns = 1;
  const int rest = log_s % 4;
  if (order == kRaw && rest) {
    lp.pass[k++] = Pass{1 << rest, 1, (1 << (log_n - rest))};
    ns = 1 << rest;
  }
  for (int left = log_s - (order == kRaw ? rest : 0); left > 0;) {
    const int lr = left < 4 ? left : 4;
    lp.pass[k++] = Pass{1 << lr, ns, (1 << (log_n - lr)) / ns};
    ns <<= lr;
    left -= lr;
  }
  lp.npasses = k;
  return lp;
}

// The direction of a block's transform, +1 forward and -1 inverse, from the
// table; volatile, so that each use reads shared memory rather than holding
// it in one of the passes' 64 registers.
__shared__ volatile float s_sign;

// The inverse conjugates the caller's x as the first pass reads it (a
// segment's scratch is conjugated already), y as it is written, and the
// table's roots.
template <bool SEG>
struct TableSign {
  static __device__ __forceinline__ float in() { return SEG ? 1.f : s_sign; }
  static __device__ __forceinline__ float out() { return s_sign; }
  static __device__ __forceinline__ float table() { return s_sign; }
};

// The raw order's last pass: radix 16, one butterfly a thread (the plan puts
// the other radix first). Thread t of a row takes butterfly u = l G + m +
// 8 G h (l < 8, m < G = 2^s, h < L / 128), so that u mod G = m and u div G =
// l + 8 h; its outputs, frequencies u + q T (T = N / 16, a multiple of G),
// sit at bitrev_s(m) L + l + 8 h + q L / 16. A warp's 32 lanes are four
// groups of 8 consecutive l (8 neighbouring positions a group: one 32-byte
// sector of f32), whose m are b, b + G / 4, b + G / 2, b + 3 G / 4: with the
// passes' pad (f + (f >> 5)), the 32 lanes' reads at u + r T then fall on 32
// banks (G >= 4; G = 2 takes 32 consecutive u).
template <class SIGN, class TO>
__device__ __forceinline__ void raw_last_pass(const Launch& lp, const Pass& ps, const Row& w,
                                              TO* __restrict__ yr, TO* __restrict__ yi,
                                              const float2* __restrict__ tab) {
  const int log_g = lp.log_row - lp.log_group, log_l = lp.log_group;
  int m, h;
  if (log_g >= 2) {   // w.t = l + 8 d + 32 (b + G / 4 h)
    const int rest = w.t >> 5, quarter = log_g - 2;
    m = (rest & ((1 << quarter) - 1)) + (((w.t >> 3) & 3) << quarter);
    h = rest >> quarter;
  } else {            // w.t = l + 8 m + 16 h
    m = (w.t >> 3) & 1;
    h = w.t >> 4;
  }
  const int l = w.t & 7;
  const int u = (l << log_g) + m + (h << (3 + log_g));
  float re[16], im[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int s = smem_index<true>(u + r * lp.threads);
    re[r] = w.sr[s];
    im[r] = w.sr[lp.ld + s];
  }
  twiddle<16>(re, im, tab, u * ps.stride, SIGN::table());   // k = u: ns = T
  Dft<16>::run(re, im);
  if (!w.live) return;
  const int o = (brev(m, log_g) << log_l) + l + 8 * h, step = 1 << (log_l - 4);
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    store_plane(yr + (w.out + o + q * step), re[q]);
    store_plane(yi + (w.out + o + q * step), SIGN::out() * im[q]);
  }
}

// One block transforms lp.rows units of 2^lp.log_len points: whole rows, or
// (kSegments) the 2^lp.log_segs segments of each row that the global passes
// left in the scratch planes, in the order ORDER says; blocks of up to MAXT
// threads. 256 (rows up to 4096 points) lets ptxas take 85 registers, 3
// blocks an SM; 512-thread blocks (8192-point rows and segments) are bounded
// as 768 for the same 85, at which no instantiation spills. A 16384-point
// row's 1024 threads have 64: its f32 natural-order instantiation does not
// spill, its raw-order and bf16 ones spill a few registers (nvcc.log;
// chip_smoke.py phase 14 prints them).
template <int ORDER, int MAXT, int MINB, class TI, class TO>
__global__ void __launch_bounds__(MAXT, MINB)
dif_kernel(const __grid_constant__ Launch lp, const TI* __restrict__ xr, const TI* __restrict__ xi,
           TO* __restrict__ yr, TO* __restrict__ yi, const float2* __restrict__ tab,
           int64_t units) {
  constexpr int P = kPointsPow2;
  constexpr bool SEG = ORDER == kSegments;
  using Sign = TableSign<SEG>;
  extern __shared__ float smem[];
  if (threadIdx.x == 0) s_sign = table_sign(tab, lp.log_row);
  __syncthreads();
  const int sub = threadIdx.x / lp.threads;
  const int64_t unit = int64_t(blockIdx.x) * lp.rows + sub;
  Row w;
  w.t = threadIdx.x - sub * lp.threads;
  w.live = unit < units;
  w.off = (w.live ? unit : 0) * lp.n;   // segments are contiguous in the scratch
  w.out = SEG ? ((w.live ? unit : 0) >> lp.log_segs) * (int64_t{lp.n} << lp.log_segs) : w.off;
  w.sr = smem + sub * (2 * lp.ld + 1);
  constexpr int kLast = SEG ? kToSmem : kLastByPlan;
  for (int p = 0; p < lp.npasses; ++p) {
    const Pass ps = lp.pass[p];
    const bool first = p == 0, last = p + 1 == lp.npasses;
    if (ORDER == kRaw && last) {   // plan: the other radix first, then radix 16
      raw_last_pass<Sign>(lp, ps, w, yr, yi, tab);
      break;
    }
    switch (ps.radix) {
      case 2: radix_pass<2, P, kLast, Sign>(lp, ps, w, first, last, xr, xi, yr, yi, tab); break;
      case 4: radix_pass<4, P, kLast, Sign>(lp, ps, w, first, last, xr, xi, yr, yi, tab); break;
      case 8: radix_pass<8, P, kLast, Sign>(lp, ps, w, first, last, xr, xi, yr, yi, tab); break;
      case 16: radix_pass<16, P, kLast, Sign>(lp, ps, w, first, last, xr, xi, yr, yi, tab); break;
      default: break;
    }
  }
  if constexpr (SEG) {   // segment seg: its index k is frequency k 2^e + bitrev_e(seg)
    if (!w.live) return;
    TO* __restrict__ br = yr + w.out;
    TO* __restrict__ bi = yi + w.out;
    const int log_l = lp.log_group, log_g = lp.log_row - lp.log_group, log_e = lp.log_segs;
    const int b = brev(static_cast<int>(unit & ((1 << log_e) - 1)), log_e);
#pragma unroll 4
    for (int i = 0; i < P; ++i) {
      const int k = w.t + i * lp.threads;
      const int f = (k << log_e) | b;
      const int pos = log_g == 0 ? f
                                 : (brev(f & ((1 << log_g) - 1), log_g) << log_l) | (f >> log_g);
      const int s = smem_index<true>(k);
      store_plane(br + pos, w.sr[s]);
      store_plane(bi + pos, Sign::out() * w.sr[lp.ld + s]);
    }
  }
}

// 2^LOG_R radix-2 stages [s0, s0 + LOG_R) of the decimation in frequency over
// whole rows in device memory, as one radix-2^LOG_R pass: a thread's points
// k0 + t h of a span of 2^LOG_R h (h = N >> (s0 + LOG_R)), their DFT, output q
// times w_{N >> s0}^{k0 q}, written at k0 + bitrev(q) h of the span in the
// f32 scratch planes (sr, si). The first pass reads the caller's planes (the
// inverse conjugates them); the others read the scratch and write it in place.
template <int LOG_R, class TI>
__global__ void __launch_bounds__(kPassThreads)
global_pass(const TI* xr, const TI* xi, float* sr, float* si, const float2* __restrict__ tab,
            int64_t rows, int log_n, int s0) {
  constexpr int R = 1 << LOG_R;
  const int64_t g = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int log_groups = log_n - LOG_R;
  if (g >= (rows << log_groups)) return;
  const float tsign = table_sign(tab, log_n);
  const float isign = s0 == 0 ? tsign : 1.f;
  const int64_t base = (g >> log_groups) << log_n;
  const int gl = static_cast<int>(g & ((int64_t{1} << log_groups) - 1));
  const int log_h = log_n - s0 - LOG_R;
  const int k0 = gl & ((1 << log_h) - 1);
  const int64_t k = base + ((gl >> log_h) << (log_h + LOG_R)) + k0;
  float re[R], im[R];
#pragma unroll
  for (int t = 0; t < R; ++t) {
    re[t] = load_plane(xr + k + (int64_t{t} << log_h));
    im[t] = isign * load_plane(xi + k + (int64_t{t} << log_h));
  }
  Dft<R>::run(re, im);
  twiddle<R>(re, im, tab, k0 << s0, tsign);
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int64_t at = k + (int64_t{brev(q, LOG_R)} << log_h);
    sr[at] = re[q];
    si[at] = im[q];
  }
}

template <int LOG_R, class TI>
cudaError_t launch_global(const TI* xr, const TI* xi, float* sr, float* si, const float2* tw,
                          int64_t rows, int log_n, int s0, cudaStream_t stream) {
  const int64_t threads = rows << (log_n - LOG_R);
  const int64_t blocks = (threads + kPassThreads - 1) / kPassThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  global_pass<LOG_R, TI><<<static_cast<unsigned>(blocks), kPassThreads, 0, stream>>>(
      xr, xi, sr, si, tw, rows, log_n, s0);
  return cudaGetLastError();
}

template <class TI>
cudaError_t global_passes(const TI* xr, const TI* xi, float* sr, float* si, const float2* tw,
                          int64_t rows, int log_n, int s0, int log_r, cudaStream_t stream) {
  switch (log_r) {
    case 4: return launch_global<4>(xr, xi, sr, si, tw, rows, log_n, s0, stream);
    case 3: return launch_global<3>(xr, xi, sr, si, tw, rows, log_n, s0, stream);
    case 2: return launch_global<2>(xr, xi, sr, si, tw, rows, log_n, s0, stream);
    default: return launch_global<1>(xr, xi, sr, si, tw, rows, log_n, s0, stream);
  }
}

template <int ORDER, int MAXT, int MINB, class TI, class TO>
cudaError_t launch_units(const Launch& lp, const TI* xr, const TI* xi, TO* yr, TO* yi,
                         const float2* tw, int64_t units, cudaStream_t stream) {
  static std::atomic<unsigned long long> allowed{0};
  const size_t smem = sizeof(float) * size_t(lp.rows) * (2 * size_t(lp.ld) + 1);
  const int64_t blocks = (units + lp.rows - 1) / lp.rows;
  if (blocks > 0x7fffffff || smem > size_t(kSmemMax - 1024)) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {   // once a device; the kernel's static s_sign takes the rest
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (!(allowed.load(std::memory_order_relaxed) & bit)) {
      e = cudaFuncSetAttribute(dif_kernel<ORDER, MAXT, MINB, TI, TO>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax - 1024);
      if (e != cudaSuccess) return e;
      allowed.fetch_or(bit, std::memory_order_relaxed);
    }
  }
  dif_kernel<ORDER, MAXT, MINB, TI, TO>
      <<<static_cast<unsigned>(blocks), lp.rows * lp.threads, smem, stream>>>(lp, xr, xi, yr, yi,
                                                                             tw, units);
  return cudaGetLastError();
}

template <int ORDER, class TI, class TO>
cudaError_t launch_any(const Launch& lp, const TI* xr, const TI* xi, TO* yr, TO* yi,
                       const float2* tw, int64_t units, cudaStream_t stream) {
  if (lp.n <= 4096)
    return launch_units<ORDER, 256, 3>(lp, xr, xi, yr, yi, tw, units, stream);
  if (lp.n == 8192)
    return launch_units<ORDER, 768, 1>(lp, xr, xi, yr, yi, tw, units, stream);
  return launch_units<ORDER, 1024, 1>(lp, xr, xi, yr, yi, tw, units, stream);
}

template <typename P>
cudaError_t run(const P* xr, const P* xi, P* yr, P* yi, float* scratch, const float2* tw,
                int64_t rows, int log_n, int log_l, cudaStream_t stream) {
  const int log_s = log_n <= kMaxLogRow ? log_n : kLogSeg;
  const int log_e = log_n - log_s;
  if (log_e == 0) {
    if (log_l == log_n)
      return launch_any<kNatural>(unit_launch(log_s, log_n, log_l, kNatural), xr, xi, yr, yi, tw,
                                  rows, stream);
    return launch_any<kRaw>(unit_launch(log_s, log_n, log_l, kRaw), xr, xi, yr, yi, tw, rows,
                            stream);
  }
  if (scratch == nullptr) return cudaErrorInvalidValue;
  float* sr = scratch;
  float* si = scratch + (rows << log_n);
  for (int s0 = 0; s0 < log_e;) {
    const int lr = std::min(log_e - s0, 4);
    const cudaError_t err =
        s0 == 0 ? global_passes(xr, xi, sr, si, tw, rows, log_n, s0, lr, stream)
                : global_passes<float>(sr, si, sr, si, tw, rows, log_n, s0, lr, stream);
    if (err != cudaSuccess) return err;
    s0 += lr;
  }
  const Launch lp = unit_launch(log_s, log_n, log_l, kSegments);
  const float* scr = sr;
  const float* sci = si;
  return launch_units<kSegments, 768, 1>(lp, scr, sci, yr, yi, tw, rows << log_e, stream);
}

}  // namespace

extern "C" {

// xr, xi: (rows, 2^log_n) contiguous planes, f32 (bf16 == 0) or bf16; yr, yi:
// fresh outputs of the same type and shape (never the inputs); tw: 2^(log_n-1)
// f32 complex twiddles exp(-+2 pi i k / N), interleaved (re, im); scratch:
// rows x N f32 complex (two f32 planes of rows x N), needed only when N >
// 16384 (else may be null). log_l = log_n gives natural order, 7 <= log_l <
// log_n the raw order of groups of L = 2^log_l. Launches on `stream` (one
// launch for N <= 16384) and returns cudaGetLastError().
int tml_dif_fft(const void* xr, const void* xi, void* yr, void* yi, void* scratch, const void* tw,
                int64_t rows, int log_n, int log_l, int bf16, void* stream) {
  if (log_n < 8 || log_n > 30 || log_l < 7 || log_l > log_n || rows < 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<float*>(scratch);
  auto t = static_cast<const float2*>(tw);
  if (bf16) {
    return run(static_cast<const __nv_bfloat16*>(xr), static_cast<const __nv_bfloat16*>(xi),
               static_cast<__nv_bfloat16*>(yr), static_cast<__nv_bfloat16*>(yi), sc, t, rows,
               log_n, log_l, st);
  }
  return run(static_cast<const float*>(xr), static_cast<const float*>(xi), static_cast<float*>(yr),
             static_cast<float*>(yi), sc, t, rows, log_n, log_l, st);
}

}  // extern "C"
