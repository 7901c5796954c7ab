// The in-block Stockham radix passes shared by fft_four_step.cu (B5b, B5c),
// fft_dif.cu (B5) and dx_fused.cu (B9): the R-point DFTs in registers, the
// two-load twiddles, the padded shared-memory index, one pass of radix R over
// the rows a block holds, read from device memory or shared memory and
// written to shared memory or to device memory, and the direct pass of a
// prime radix above 5 (from shared memory).
//
// A launch sees each row as `lanes` interleaved transforms of `len` points
// (point p of lane v at p lanes + v). A pass of radix R on butterfly u (j = u
// / lanes, v = u % lanes, k = j mod ns, ns the length done before it) reads
// point r at flat index u + r n / R, multiplies it by w_{ns R}^{r k}, runs an
// R-point DFT in registers and writes point q to ((j - k) R + k + q ns) lanes
// + v: Stockham's autosort order, so the last pass writes the natural order.
// Adjacent threads take adjacent butterflies: the first pass reads device
// memory and the last writes it coalesced.
//
// Twiddles: point r of a butterfly needs w_{ns R}^{r k} = tab[r k stride],
// stride = N / (ns R) for a table of the N-th roots (N may exceed the row's
// n: B5 transforms 16384-long segments of longer rows with the row's table).
// A thread loads w^e and w^{4e} (e = k stride) and applies w^{(r mod 4) e}
// then w^{4 (r div 4) e}, formed by products: two loads a butterfly through
// L1 instead of R - 1 scattered ones.
//
// The passes are forward. An inverse transform is the conjugate of the
// forward transform of the conjugate: the first pass negates the imaginary
// plane it reads and the last the one it writes (lp.conj_in, lp.conj_out);
// or, where the kernel learns the direction only from its table (B5, handed
// the inverse roots for an inverse transform), a SIGN policy gives the
// factors of the imaginary parts read, written and loaded from the table.
// B5b's policy, UnitSign, is 1 at compile time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tml_stockham {

constexpr int kMaxPasses = 15;       // 14 prime factors at most (2^14) and a copy pass
constexpr int kPointsPow2 = 16;      // points a thread: a power-of-two N >= 4
constexpr int kThreadsPow2 = 1024;   // that family's launch bound: 64 registers a thread

// Host helpers of the plans' readers (fft_four_step.cu, dx_fused.cu): the
// least k with 2^k >= v, and whether a radix runs in registers.
inline int ilog2(int v) {
  int k = 0;
  while ((1 << k) < v) ++k;
  return k;
}

inline bool register_radix(int r) {
  return r == 2 || r == 3 || r == 4 || r == 5 || r == 8 || r == 16;
}

struct Pass {
  int radix;    // 1 (a copy), 2, 3, 4, 5, 8 or 16 in registers; any other: a direct pass
  int ns;       // the length of the transforms done before this pass
  int stride;   // N / (ns radix): the table's step for w_{ns radix}
};

struct Launch {
  int n;                // the row's length
  int len, lanes;       // lanes interleaved transforms of len points
  int log_len, log_lanes;   // their log2 in the power-of-two family
  int threads, rows;    // a row's threads, rows a block
  int ld;               // floats of one plane of a row in shared memory
  int npasses;
  int conj_in, conj_out;    // negate the imaginary plane read / written (the inverse)
  int to_scratch;       // mode 2's first launch: C^T with the twiddle w^{k1 n2}
  int points;           // a thread's points: picks the kernel family
  int log_row, log_group, log_segs;   // B5: log2 of the row's length, of the raw order's
                                      // groups (log_row: natural), of segments a row
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

// Plane element loads and stores: f32 or bf16 in device memory, f32 inside.
__device__ __forceinline__ float load_plane(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_plane(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_plane(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_plane(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
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

// Point 4a + b times w^{(4a + b) e}, where w^e = tab[e] (its imaginary part
// times tsign), as two factors: w^{b e} (w^e from the table, w^{2e}, w^{3e}
// by products), then w^{4a e} (w^{4e} from the table, its powers by
// products). Two factors live at a time.
template <int R>
__device__ __forceinline__ void twiddle(float (&re)[R], float (&im)[R],
                                        const float2* __restrict__ tab, int e, float tsign) {
  float2 w1 = __ldg(tab + e);
  w1.y *= tsign;
  float2 wb = w1;
#pragma unroll
  for (int b = 1; b < 4 && b < R; ++b) {
    if (b > 1) wb = cprod(wb, w1);
#pragma unroll
    for (int a = 0; 4 * a + b < R; ++a) cmul(re[4 * a + b], im[4 * a + b], wb.x, wb.y);
  }
  if constexpr (R > 4) {
    float2 w4 = __ldg(tab + 4 * e);
    w4.y *= tsign;
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
  int64_t off;                // the row's offset in the planes read by the first pass
  int64_t out;                // the row's offset in the planes written by the last pass
  float* sr;                  // the row's real plane in shared memory (imaginary at + ld)
};

// The factors of the imaginary parts: of the plane the first pass reads, of
// the one the last pass writes, and of the table's roots.
struct UnitSign {
  static __device__ __forceinline__ float in() { return 1.f; }
  static __device__ __forceinline__ float out() { return 1.f; }
  static __device__ __forceinline__ float table() { return 1.f; }
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

// Where a pass writes: shared memory for the next pass (kToSmem; also B5's
// last pass over a long row's segment, read back by its epilogue); y (kToY);
// shared memory as C^T with a row of len + 1 (kToCt: mode 2's first launch,
// read back by the kernel's epilogue); or, for the last pass, by
// lp.to_scratch one of the last two (kLastByPlan: B5b, B5c).
enum Store { kToSmem, kToY, kToCt, kLastByPlan };

// Twiddles, DFTs and writes of a thread's butterflies after their reads.
template <int R, int P, int STORE, class SIGN, class TO>
__device__ __forceinline__ void finish(const Launch& lp, const Pass& ps, const Row& w,
                                       float (&re)[(P + R - 1) / R][R],
                                       float (&im)[(P + R - 1) / R][R], TO* __restrict__ yr,
                                       TO* __restrict__ yi, const float2* __restrict__ tab) {
  constexpr int B = (P + R - 1) / R;
  constexpr bool POW2 = P == kPointsPow2;
  const int nb = lp.n / R;
  const float sign = STORE != kToY ? 1.f : lp.conj_out ? -1.f : SIGN::out();
  TO* __restrict__ br = yr + w.out;
  TO* __restrict__ bi = yi + w.out;
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const int u = w.t + i * lp.threads;
    if constexpr (R == 1) {   // a copy: output u is flat index u
      if (u < nb) {
        if constexpr (STORE == kToY) {
          if (w.live) {
            store_plane(br + u, re[i][0]);
            store_plane(bi + u, sign * im[i][0]);
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
      if (ps.ns > 1) twiddle<R>(re[i], im[i], tab, k * ps.stride, SIGN::table());
      Dft<R>::run(re[i], im[i]);
      const int base = (j - k) * R + k;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int pos = base + q * ps.ns;
        if constexpr (STORE == kToY) {
          if (w.live) {
            const int f = flat<POW2>(lp, pos, v);
            store_plane(br + f, re[i][q]);
            store_plane(bi + f, sign * im[i][q]);
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
// for the block, then finishes them. The last pass writes as LAST says.
template <int R, int P, int LAST = kLastByPlan, class SIGN = UnitSign, class TI = float,
          class TO = float>
__device__ __forceinline__ void radix_pass(const Launch& lp, const Pass& ps, const Row& w,
                                           bool first, bool last, const TI* __restrict__ xr,
                                           const TI* __restrict__ xi, TO* __restrict__ yr,
                                           TO* __restrict__ yi, const float2* __restrict__ tab) {
  constexpr int B = (P + R - 1) / R;   // butterflies a thread
  constexpr bool POW2 = P == kPointsPow2;
  const int nb = lp.n / R;             // butterflies a row
  float re[B][R], im[B][R];
  if (first) {
    const float sign = lp.conj_in ? -1.f : SIGN::in();
    const TI* __restrict__ ar = xr + w.off;
    const TI* __restrict__ ai = xi + w.off;
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int u = w.t + i * lp.threads;
      const bool ok = w.live && u < nb;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        re[i][r] = ok ? load_plane(ar + u + r * nb) : 0.f;
        im[i][r] = ok ? sign * load_plane(ai + u + r * nb) : 0.f;
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
  if constexpr (LAST == kLastByPlan) {
    if (last && !lp.to_scratch) {
      finish<R, P, kToY, SIGN>(lp, ps, w, re, im, yr, yi, tab);
      return;
    }
    if (last) finish<R, P, kToCt, SIGN>(lp, ps, w, re, im, yr, yi, tab);
    else finish<R, P, kToSmem, SIGN>(lp, ps, w, re, im, yr, yi, tab);
  } else {
    if (last) {
      finish<R, P, LAST, SIGN>(lp, ps, w, re, im, yr, yi, tab);
      if constexpr (LAST == kToY) return;
    } else {
      finish<R, P, kToSmem, SIGN>(lp, ps, w, re, im, yr, yi, tab);
    }
  }
  __syncthreads();
}

constexpr int kChunk = 64;   // terms a partial sum of a direct pass

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

}  // namespace tml_stockham
