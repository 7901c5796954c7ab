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
// The design:
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

namespace {

constexpr int kMaxN = 16384;
constexpr int kMaxPasses = 15;       // 14 prime factors at most (2^14) and a copy pass
constexpr int kPointsPow2 = 16;      // points a thread: a power-of-two N >= 4
constexpr int kPointsMixed = 64;     // any other N
constexpr int kThreadsPow2 = 1024;   // the families' launch bounds: 64 registers a thread
constexpr int kThreadsMixed = 256;   // up to 255 registers (a radix-3 pass holds 66 points)
constexpr int kSmemMax = 232448;     // the shared memory a block may use on sm_90
constexpr int kChunk = 64;           // terms a partial sum of a direct pass

struct Pass {
  int radix;    // 1 (a copy), 2, 3, 4, 5, 8 or 16 in registers; any other: a direct pass
  int ns;       // the length of the transforms done before this pass
  int stride;   // N / (ns radix): the table's step for w_{ns radix}
};

struct Launch {
  int n;                // the row's length, and the table's
  int len, lanes;       // lanes interleaved transforms of len points
  int log_len, log_lanes;   // their log2 in the power-of-two family
  int threads, rows;    // a row's threads, rows a block
  int ld;               // floats of one plane of a row in shared memory
  int npasses;
  int conj_in, conj_out;    // negate the imaginary plane read / written (the inverse)
  int to_scratch;       // mode 2's first launch: C^T with the twiddle w^{k1 n2}
  int points;           // a thread's points: picks the kernel family
  Pass pass[kMaxPasses];
};

// (ar, ai) *= (br, bi)
__device__ __forceinline__ void cmul(float& ar, float& ai, float br, float bi) {
  const float r = fmaf(ar, br, -ai * bi);
  ai = fmaf(ar, bi, ai * br);
  ar = r;
}

__device__ __forceinline__ float2 cprod(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// ---------------------------------------------------------------------------
// R-point DFTs in registers, forward (w_R = exp(-2 pi i / R)), natural order in
// and out.

__device__ __forceinline__ void dft4(float& r0, float& i0, float& r1, float& i1,
                                     float& r2, float& i2, float& r3, float& i3) {
  const float ar = r0 + r2, ai = i0 + i2, br = r0 - r2, bi = i0 - i2;
  const float cr = r1 + r3, ci = i1 + i3, dr = r1 - r3, di = i1 - i3;
  r0 = ar + cr;
  i0 = ai + ci;
  r2 = ar - cr;
  i2 = ai - ci;
  r1 = br + di;   // b - i d
  i1 = bi - dr;
  r3 = br - di;   // b + i d
  i3 = bi + dr;
}

// (a, b) *= w16^M, M in {1, 2, 3, 4, 6, 9}
template <int M>
__device__ __forceinline__ void rot16(float& a, float& b) {
  constexpr float c8 = 0.92387953251128674f, s8 = 0.38268343236508977f;
  constexpr float h = 0.70710678118654752f;
  float r, i;
  if constexpr (M == 1) {
    r = fmaf(a, c8, b * s8);
    i = fmaf(b, c8, -a * s8);
  } else if constexpr (M == 2) {
    r = (a + b) * h;
    i = (b - a) * h;
  } else if constexpr (M == 3) {
    r = fmaf(a, s8, b * c8);
    i = fmaf(b, s8, -a * c8);
  } else if constexpr (M == 4) {
    r = b;
    i = -a;
  } else if constexpr (M == 6) {
    r = (b - a) * h;
    i = -(a + b) * h;
  } else {
    static_assert(M == 9, "rot16 takes M in {1, 2, 3, 4, 6, 9}");
    r = -fmaf(a, c8, b * s8);
    i = fmaf(a, s8, -b * c8);
  }
  a = r;
  b = i;
}

template <int R>
struct Dft;

template <>
struct Dft<2> {
  static __device__ __forceinline__ void run(float (&re)[2], float (&im)[2]) {
    const float r = re[0] - re[1], i = im[0] - im[1];
    re[0] += re[1];
    im[0] += im[1];
    re[1] = r;
    im[1] = i;
  }
};

template <>
struct Dft<3> {
  static __device__ __forceinline__ void run(float (&re)[3], float (&im)[3]) {
    constexpr float s3 = 0.86602540378443865f;   // sin(2 pi / 3)
    const float sr = re[1] + re[2], si = im[1] + im[2];
    const float dr = re[1] - re[2], di = im[1] - im[2];
    const float mr = fmaf(-0.5f, sr, re[0]), mi = fmaf(-0.5f, si, im[0]);
    re[0] += sr;
    im[0] += si;
    re[1] = fmaf(s3, di, mr);
    im[1] = fmaf(-s3, dr, mi);
    re[2] = fmaf(-s3, di, mr);
    im[2] = fmaf(s3, dr, mi);
  }
};

template <>
struct Dft<4> {
  static __device__ __forceinline__ void run(float (&re)[4], float (&im)[4]) {
    dft4(re[0], im[0], re[1], im[1], re[2], im[2], re[3], im[3]);
  }
};

template <>
struct Dft<5> {
  static __device__ __forceinline__ void run(float (&re)[5], float (&im)[5]) {
    constexpr float c1 = 0.30901699437494742f, c2 = -0.80901699437494742f;   // cos(2 pi / 5), cos(4 pi / 5)
    constexpr float s1 = 0.95105651629515357f, s2 = 0.58778525229247313f;    // sin(2 pi / 5), sin(4 pi / 5)
    const float a1r = re[1] + re[4], a1i = im[1] + im[4], b1r = re[1] - re[4], b1i = im[1] - im[4];
    const float a2r = re[2] + re[3], a2i = im[2] + im[3], b2r = re[2] - re[3], b2i = im[2] - im[3];
    const float m1r = fmaf(c2, a2r, fmaf(c1, a1r, re[0])), m1i = fmaf(c2, a2i, fmaf(c1, a1i, im[0]));
    const float m2r = fmaf(c1, a2r, fmaf(c2, a1r, re[0])), m2i = fmaf(c1, a2i, fmaf(c2, a1i, im[0]));
    const float n1r = fmaf(s1, b1r, s2 * b2r), n1i = fmaf(s1, b1i, s2 * b2i);
    const float n2r = fmaf(s2, b1r, -s1 * b2r), n2i = fmaf(s2, b1i, -s1 * b2i);
    re[0] += a1r + a2r;
    im[0] += a1i + a2i;
    re[1] = m1r + n1i;   // m1 - i n1
    im[1] = m1i - n1r;
    re[4] = m1r - n1i;   // m1 + i n1
    im[4] = m1i + n1r;
    re[2] = m2r + n2i;   // m2 - i n2
    im[2] = m2i - n2r;
    re[3] = m2r - n2i;   // m2 + i n2
    im[3] = m2i + n2r;
  }
};

// 8 = 2 x 4: point 4 n1 + n2; output k1 + 2 k2.
template <>
struct Dft<8> {
  static __device__ __forceinline__ void run(float (&re)[8], float (&im)[8]) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float r = re[c] - re[c + 4], i = im[c] - im[c + 4];
      re[c] += re[c + 4];
      im[c] += im[c + 4];
      re[c + 4] = r;
      im[c + 4] = i;
    }
    rot16<2>(re[5], im[5]);   // w8^1
    rot16<4>(re[6], im[6]);   // w8^2
    rot16<6>(re[7], im[7]);   // w8^3
    dft4(re[0], im[0], re[1], im[1], re[2], im[2], re[3], im[3]);
    dft4(re[4], im[4], re[5], im[5], re[6], im[6], re[7], im[7]);
    // X[k1 + 2 k2] sits at 4 k1 + k2
    const float t1r = re[1], t1i = im[1], t2r = re[2], t2i = im[2], t3r = re[3], t3i = im[3];
    const float t5r = re[5], t5i = im[5], t6r = re[6], t6i = im[6];
    re[1] = re[4];
    im[1] = im[4];
    re[2] = t1r;
    im[2] = t1i;
    re[3] = t5r;
    im[3] = t5i;
    re[4] = t2r;
    im[4] = t2i;
    re[5] = t6r;
    im[5] = t6i;
    re[6] = t3r;
    im[6] = t3i;
  }
};

// 16 = 4 x 4: point 4 n1 + n2; output k1 + 4 k2.
template <>
struct Dft<16> {
  static __device__ __forceinline__ void run(float (&re)[16], float (&im)[16]) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      dft4(re[c], im[c], re[c + 4], im[c + 4], re[c + 8], im[c + 8], re[c + 12], im[c + 12]);
    // w16^{n2 k1} at n2 + 4 k1
    rot16<1>(re[5], im[5]);
    rot16<2>(re[9], im[9]);
    rot16<3>(re[13], im[13]);
    rot16<2>(re[6], im[6]);
    rot16<4>(re[10], im[10]);
    rot16<6>(re[14], im[14]);
    rot16<3>(re[7], im[7]);
    rot16<6>(re[11], im[11]);
    rot16<9>(re[15], im[15]);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      dft4(re[4 * c], im[4 * c], re[4 * c + 1], im[4 * c + 1], re[4 * c + 2], im[4 * c + 2],
           re[4 * c + 3], im[4 * c + 3]);
    // X[k1 + 4 k2] sits at 4 k1 + k2: transpose
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = a + 1; b < 4; ++b) {
        const float r = re[4 * a + b], i = im[4 * a + b];
        re[4 * a + b] = re[4 * b + a];
        im[4 * a + b] = im[4 * b + a];
        re[4 * b + a] = r;
        im[4 * b + a] = i;
      }
    }
  }
};

// Point 4a + b times w^{(4a + b) e}, where w^e = tab[e], as two factors:
// w^{b e} (w^e from the table, w^{2e}, w^{3e} by products), then w^{4a e}
// (w^{4e} from the table, its powers by products). Two factors live at a time.
template <int R>
__device__ __forceinline__ void twiddle(float (&re)[R], float (&im)[R],
                                        const float2* __restrict__ tab, int e) {
  const float2 w1 = __ldg(tab + e);
  float2 wb = w1;
#pragma unroll
  for (int b = 1; b < 4 && b < R; ++b) {
    if (b > 1) wb = cprod(wb, w1);
#pragma unroll
    for (int a = 0; 4 * a + b < R; ++a) cmul(re[4 * a + b], im[4 * a + b], wb.x, wb.y);
  }
  if constexpr (R > 4) {
    const float2 w4 = __ldg(tab + 4 * e);
    float2 wa = w4;
#pragma unroll
    for (int a = 1; 4 * a < R; ++a) {
      if (a > 1) wa = cprod(wa, w4);
#pragma unroll
      for (int b = 0; b < 4 && 4 * a + b < R; ++b) cmul(re[4 * a + b], im[4 * a + b], wa.x, wa.y);
    }
  }
}

// ---------------------------------------------------------------------------
// The passes

struct Row {
  int t;                      // the thread's index within its row
  bool live;                  // the row exists (the last group may have fewer)
  int64_t off;                // the row's offset in the planes
  float* sr;                  // the row's real plane in shared memory (imaginary at + ld)
};

// The shared-memory index of flat index f: the power-of-two family pads one
// float after every 32.
template <bool POW2>
__device__ __forceinline__ int smem_index(int f) {
  if constexpr (POW2) return f + (f >> 5);
  else return f;
}

template <bool POW2>
__device__ __forceinline__ int flat(const Launch& lp, int pos, int v) {
  if constexpr (POW2) return (pos << lp.log_lanes) | v;
  else return pos * lp.lanes + v;
}

enum Store { kToSmem, kToY, kToCt };

// Twiddles, DFTs and writes of a thread's butterflies after their reads: to
// shared memory for the next pass, to y (the last pass of mode 1 or of mode
// 2's second launch), or to shared memory as C^T with a row of len + 1 (the
// last pass of mode 2's first launch, read back by the kernel's epilogue).
template <int R, int P, int STORE>
__device__ __forceinline__ void finish(const Launch& lp, const Pass& ps, const Row& w,
                                       float (&re)[(P + R - 1) / R][R],
                                       float (&im)[(P + R - 1) / R][R], float* __restrict__ yr,
                                       float* __restrict__ yi, const float2* __restrict__ tab) {
  constexpr int B = (P + R - 1) / R;
  constexpr bool POW2 = P == kPointsPow2;
  const int nb = lp.n / R;
  const float sign = STORE == kToY && lp.conj_out ? -1.f : 1.f;
  float* __restrict__ br = yr + w.off;
  float* __restrict__ bi = yi + w.off;
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const int u = w.t + i * lp.threads;
    if constexpr (R == 1) {   // a copy: output u is flat index u
      if (u < nb) {
        if constexpr (STORE == kToY) {
          if (w.live) {
            br[u] = re[i][0];
            bi[u] = sign * im[i][0];
          }
        } else {
          const int s = STORE == kToCt ? (u % lp.lanes) * (lp.len + 1) + u / lp.lanes
                                       : smem_index<POW2>(u);
          w.sr[s] = re[i][0];
          w.sr[lp.ld + s] = im[i][0];
        }
      }
    } else if (u < nb) {
      int j, v, k;
      if constexpr (POW2) {
        j = u >> lp.log_lanes;
        v = u & (lp.lanes - 1);
        k = j & (ps.ns - 1);
      } else {
        j = u / lp.lanes;
        v = u - j * lp.lanes;
        k = j % ps.ns;
      }
      if (ps.ns > 1) twiddle<R>(re[i], im[i], tab, k * ps.stride);
      Dft<R>::run(re[i], im[i]);
      const int base = (j - k) * R + k;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int pos = base + q * ps.ns;
        if constexpr (STORE == kToY) {
          if (w.live) {
            const int f = flat<POW2>(lp, pos, v);
            br[f] = re[i][q];
            bi[f] = sign * im[i][q];
          }
        } else {
          const int s = STORE == kToCt ? v * (lp.len + 1) + pos
                                       : smem_index<POW2>(flat<POW2>(lp, pos, v));
          w.sr[s] = re[i][q];
          w.sr[lp.ld + s] = im[i][q];
        }
      }
    }
  }
}

// One pass of radix R in registers: every thread reads its butterflies
// (device memory in the first pass, coalesced; else shared memory), waits
// for the block, then finishes them.
template <int R, int P>
__device__ __forceinline__ void radix_pass(const Launch& lp, const Pass& ps, const Row& w,
                                           bool first, bool last, const float* __restrict__ xr,
                                           const float* __restrict__ xi, float* __restrict__ yr,
                                           float* __restrict__ yi, const float2* __restrict__ tab) {
  constexpr int B = (P + R - 1) / R;   // butterflies a thread
  constexpr bool POW2 = P == kPointsPow2;
  const int nb = lp.n / R;             // butterflies a row
  float re[B][R], im[B][R];
  if (first) {
    const float sign = lp.conj_in ? -1.f : 1.f;
    const float* __restrict__ ar = xr + w.off;
    const float* __restrict__ ai = xi + w.off;
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int u = w.t + i * lp.threads;
      const bool ok = w.live && u < nb;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        re[i][r] = ok ? __ldg(ar + u + r * nb) : 0.f;
        im[i][r] = ok ? sign * __ldg(ai + u + r * nb) : 0.f;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int u = w.t + i * lp.threads;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int s = smem_index<POW2>(u + r * nb);
        re[i][r] = u < nb ? w.sr[s] : 0.f;
        im[i][r] = u < nb ? w.sr[lp.ld + s] : 0.f;
      }
    }
    __syncthreads();   // every read of the row done before the writes
  }
  if (last && !lp.to_scratch) {
    finish<R, P, kToY>(lp, ps, w, re, im, yr, yi, tab);
    return;
  }
  if (last) finish<R, P, kToCt>(lp, ps, w, re, im, yr, yi, tab);
  else finish<R, P, kToSmem>(lp, ps, w, re, im, yr, yi, tab);
  __syncthreads();
}

// A pass whose radix is a prime above 5: output q of butterfly u is the sum
// over r of x[u + r N / R] w_{ns R}^{r (k + q ns)}, each factor from the table.
// Reads shared memory (a copy pass runs first where it is the first pass).
// The sum runs in chunks of kChunk terms (N = 12289 sums 12289 terms).
template <int P>
__device__ __forceinline__ void direct_pass(const Launch& lp, const Pass& ps, const Row& w,
                                            bool last, float* __restrict__ yr,
                                            float* __restrict__ yi, const float2* __restrict__ tab) {
  const int R = ps.radix, nb = lp.n / R, m = ps.ns * R;
  float ar[P], ai[P];
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const int f = w.t + s * lp.threads;
    float accr = 0.f, acci = 0.f;
    if (f < lp.n) {
      const int u = f % nb, q = f / nb;
      const int k = (u / lp.lanes) % ps.ns;
      const int step = k + q * ps.ns;   // < m
      int e = 0;
      for (int r0 = 0; r0 < R; r0 += kChunk) {   // chunks keep the f32 sum's error ~ sqrt(R / kChunk)
        float cr = 0.f, ci = 0.f;
        const int r1 = min(R, r0 + kChunk);
        for (int r = r0; r < r1; ++r) {
          const float2 t = __ldg(tab + e * ps.stride);
          const float a = w.sr[u + r * nb], b = w.sr[lp.ld + u + r * nb];
          cr = fmaf(a, t.x, fmaf(-b, t.y, cr));
          ci = fmaf(a, t.y, fmaf(b, t.x, ci));
          e += step;
          if (e >= m) e -= m;
        }
        accr += cr;
        acci += ci;
      }
    }
    ar[s] = accr;
    ai[s] = acci;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < P; ++s) {
    int f = w.t + s * lp.threads;
    asm volatile("" : "+r"(f));   // recompute the indices here, not hold them across the barrier
    if (f < lp.n) {
      const int u = f % nb, q = f / nb;
      const int j = u / lp.lanes, v = u - j * lp.lanes;
      const int k = j % ps.ns;
      const int pos = (j - k) * R + k + q * ps.ns;
      if (last && !lp.to_scratch) {
        if (w.live) {
          yr[w.off + pos * lp.lanes + v] = ar[s];
          yi[w.off + pos * lp.lanes + v] = lp.conj_out ? -ai[s] : ai[s];
        }
      } else {
        const int o = last ? v * (lp.len + 1) + pos : pos * lp.lanes + v;
        w.sr[o] = ar[s];
        w.sr[lp.ld + o] = ai[s];
      }
    }
  }
  if (!(last && !lp.to_scratch)) __syncthreads();
}

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
  w.off = (w.live ? row : 0) * lp.n;
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

int ilog2(int v) {
  int k = 0;
  while ((1 << k) < v) ++k;
  return k;
}

bool host_register_radix(int r) {
  return r == 2 || r == 3 || r == 4 || r == 5 || r == 8 || r == 16;
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
  if (np == 0 || !host_register_radix(words[at])) {   // a copy first (the other family's)
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
