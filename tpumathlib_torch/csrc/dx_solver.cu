// Batched small factorizations and solves, for Hopper (sm_90a):
//
//   tml_potrf_batched: Cholesky of each f32 (n, n) SPD matrix of a batch; the
//                      lower factor, or with a right-hand side (n, k) the
//                      solution of A X = B (posv).
//   tml_getrf_batched: LU with or without partial pivoting; (LU, piv), or with
//                      a right-hand side the solution of A X = B (gesv).
//   tml_geqrf_batched: Householder QR in LAPACK geqrf layout; (QR, tau).
//   tml_unmqr_batched: Q^T C or Q C from geqrf's reflectors, QR (m, n) and C
//                      (m, k).
//   tml_gels_batched:  least squares min |A x - b| of each (m, n), m >= n:
//                      the QR steps on m rows, Q^T B, then R X = (Q^T B)[:n].
//
// Replaces the TPU kernels of tpumathlib/dx/solver.py: _run_batched's
// pallas_call (:222, for potrf_batched :238, getrf_batched :257 and
// geqrf_batched :374; bodies _potrf_body :54, _getrf_body :73, _geqrf_body
// :157), gesv_batched's (:301) and posv_batched's (:359), and the lane-packed
// getrf_batched_packed (:480, kernel :391) and potrf_batched_packed (:977,
// kernel :907), and unmqr_batched's (:597, body _apply_q_body :538) and
// gels_batched's (:637, bodies _geqrf_body_rect :502, _apply_q_body,
// _trsm_upper_rect :559). Lane packing (128 / n matrices to a 128-lane row, 0/1
// matmuls to move columns between lanes) is a TPU layout: here one thread
// block factors one matrix, so the packed functions launch these kernels too,
// and a non-finite value stays in its own matrix. tpumathlib_torch/dx/
// solver.py holds the wrappers and the plain PyTorch versions, which take the
// same steps; nvcc contracts the kernels' multiply-adds to FMAs and their sums
// run in another order, so the two agree to rounding, not bit for bit.
//
// What bounds them: at batch 8192 x n 32 f32, reading A and writing the
// factor is 67.1 MB, 0.020 ms at 3.35 TB/s (50.9 MB, 0.015 ms, for Cholesky,
// which needs only A's lower triangle), while n^3/3 flop a matrix is
// 2.7e8 in all, 0.004 ms at 67 TFLOP/s (n^3/3 x B at the FP32 peak: 1.3 us
// for potrf, twice that for getrf): device memory bounds them. potrf and
// getrf (and their solves, posv and gesv) take one of three routes by (n, k)
// (factor_route): a warp a matrix for n <= 32 and k <= 32, the rows in the
// lanes' registers with no barrier (getrf's pivoted virtually, the pivot
// search a shuffle reduction); right-looking 32-column panels in a block's
// shared memory while the padded matrix and the right-hand side fit, up to n
// = 224 without one, a few barriers a panel for potrf and one a column for
// getrf (whose panel's rows sit in its threads' registers); and above that
// the column steps in place in the output, in device memory, so no n is
// refused for its size (below "Cholesky", "LU, a warp a matrix" and "LU,
// 32-column panels"). On an H100 (700 W; chip_smoke.py phase 20) the LU's
// warp route factors 8192 matrices of 32 in 0.078 ms pivoted and 0.061
// unpivoted, against 0.193 and 0.184 for torch.linalg.lu_factor_ex. geqrf,
// unmqr and gels: a block copies its matrix (and right-hand side) into
// shared memory once, runs the n dependent steps there, each a read of
// column j, a reduction where the step needs one and a masked rank-1 update,
// separated by __syncthreads, and writes its result once; past a block's
// 227 KB a second instantiation works in place in device memory. geqrf for n
// <= 32 and unmqr for m <= 64, n <= 32 take a warp a matrix instead
// (csrc/dx_qr_warp.cu, on the QR core of csrc/dx_qr_warp.cuh), and geqrf for
// n <= 224 and unmqr for m <= 224 32-column panels (csrc/dx_qr_panel.cu), so
// these block kernels serve gels and the sizes beyond. gels takes
// a warp a matrix for m <= 64, n <= 32 and k <= 32 (below "gels, a warp a
// matrix": A's columns in the lanes' registers, B's rows beside them, no
// barrier): at batch 8192 x m 64 x n 32, k 4, it reads A and B and writes X,
// 79.7 MB, 0.024 ms, against about 1 GFLOP (0.015 ms) of QR and Q^T B.
//
// Numerical conventions, shared with the plain versions:
// - potrf: 1/sqrt of the pivot; L's column is the column times it; the
//   lower triangle only is read; a non-positive pivot gives NaN from its
//   column on.
// - getrf: true division by the pivot; the pivot is the row of largest
//   magnitude in column j (rows >= j), the lowest row among equals, and the
//   first NaN row where the column holds a NaN (the reference returns n
//   there, out of range).
// - geqrf: dlarfg with alpha = -sign(x_j) * |x|, sign(0) = +1; a zero tail
//   gives tau = 0; the reflector is stored with v_j = 1, tau = tau_h * v_j^2.
// - solves: gesv applies the row swaps in sequence, then the unit-lower and
//   the upper substitution; posv L y = b, then L^T x = y.
// - unmqr: H_j = I - tau_j v v^T with v_j = 1 and v below it QR's column j,
//   applied for j ascending (Q^T) or descending (Q); reflectors j >= m are
//   empty. gels: geqrf on m rows, Q^T B, then R X = (Q^T B)[:n] by upper
//   substitution, X written as the substitution leaves it (the reference's
//   kernel adds each column's sum times 0, which turns a column holding an
//   inf wholly to NaN).

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "dx_qr_warp.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int64_t kSmemMax = 232448;  // a block's opt-in shared memory on sm_90
constexpr int64_t kMaxN = 16384;      // keeps n * n in an int and the vectors in shared memory
constexpr int kScalars = 4;

// The matrix a block works on, row-major with leading dimension ld: in
// shared memory, or in place in the output (or work space) in device memory.
struct Mat {
  float* p;
  int ld;
  __device__ __forceinline__ float& operator()(int r, int c) const { return p[r * ld + c]; }
};

struct Args {
  const float* a;  // (batch, m, n); m = n but for unmqr and gels
  float* out;      // (batch, m, n): the factor; for a solve (unmqr, gels) null where the
                   // block fits in shared memory, else the matrix's work space
  int32_t* piv;    // (batch, n) pivots, or null
  float* tau;      // (batch, n): geqrf's output, unmqr's input
  const float* b;  // (batch, m, k), or null
  float* x;        // (batch, xrows, k) where the block fits in shared memory, else
                   // (batch, m, k), worked in place; or null
  int m, n, k, xrows, pivot, trans;
};

using Kernel = void (*)(Args);

int lead(int64_t n) { return static_cast<int>(n | 1); }  // odd: column reads spread over banks
// s_v[m], s_w[max(n, k)], s_t[n] and the scalars
int64_t small_bytes(int64_t m, int64_t n, int64_t k) {
  return (m + std::max(n, k) + n + kScalars) * 4;
}
int64_t full_bytes(int64_t m, int64_t n, int64_t k) {
  return small_bytes(m, n, k) + (m * lead(n) + m * k) * 4;
}
int threads_for(int64_t n) {
  return n <= 16 ? 64 : n <= 32 ? 128 : n <= 64 ? 256 : n <= 128 ? 512 : kMaxThreads;
}

// Shared memory: s_v[m], s_w[max(n, k)], s_t[n] (LU's pivots as int, or
// gels' tau), kScalars scalars, then, in the shared instantiation, the matrix
// (m x ld) and the right-hand side (m x k).
struct Block {
  Mat A;
  float* X;  // (m, k) row-major, or null
  float* v;
  float* w;
  float* t;
  int* piv;
  float* scal;
};

template <bool kShared>
__device__ Block stage(const Args& p, float* smem) {
  const int m = p.m, n = p.n, k = p.k;
  const int64_t bi = blockIdx.x;
  Block s;
  s.v = smem;
  s.w = s.v + m;
  s.t = s.w + max(n, k);
  s.piv = reinterpret_cast<int*>(s.t);
  s.scal = s.t + n;
  if (kShared) {
    s.A = Mat{s.scal + kScalars, n | 1};
    s.X = k ? s.A.p + m * (n | 1) : nullptr;
  } else {
    s.A = Mat{p.out + bi * m * n, n};
    s.X = k ? p.x + bi * m * k : nullptr;
  }
  const float* a = p.a + bi * m * n;
  for (int e = threadIdx.x; e < m * n; e += blockDim.x) s.A(e / n, e % n) = a[e];
  if (k) {
    const float* b = p.b + bi * m * k;
    for (int e = threadIdx.x; e < m * k; e += blockDim.x) s.X[e] = b[e];
  }
  __syncthreads();
  return s;
}

// The result out of shared memory (the device-memory instantiation already
// holds it in place, apart from potrf's upper triangle, which is zeroed).
template <bool kShared>
__device__ void unstage(const Args& p, const Block& s, bool lower) {
  const int m = p.m, n = p.n, k = p.k;
  const int64_t bi = blockIdx.x;
  if (p.out != nullptr && (kShared || lower)) {
    float* o = p.out + bi * m * n;
    for (int e = threadIdx.x; e < m * n; e += blockDim.x) {
      const int r = e / n, c = e % n;
      o[e] = (lower && c > r) ? 0.f : s.A(r, c);
    }
  }
  if (kShared && k) {
    float* x = p.x + bi * p.xrows * k;
    for (int e = threadIdx.x; e < p.xrows * k; e += blockDim.x) x[e] = s.X[e];
  }
}

// ----------------------------- Cholesky -----------------------------
//
// Three routes by size (factor_route; dx/solver.py::_potrf_route mirrors it):
// - n <= 32 and k <= 32: a warp a matrix (potrf_warp_kernel), 4 matrices a
//   block, the matrix in its lanes' registers, no block barrier.
// - else, where the padded matrix fits in a block's shared memory
//   (panel_bytes, n <= 224 without a right-hand side): right-looking in
//   32-column panels (potrf_panel_kernel), a block a matrix.
// - else: the column steps in place in the output, in device memory
//   (potrf_inplace_kernel).
// All three take _potrf_plain's column steps in its order: step j scales
// column j by 1/sqrt of its pivot, then subtracts l_r l_c from A(r, c) for
// j < c <= r, each element's updates in ascending j. The panel route only
// groups them: a panel's diagonal block, then its rows below, then the
// trailing update, whose tile sums the panel's 32 columns in order. What
// bounds them (B x n^3/3 flop against the bytes of the lower triangle in and
// the factor out) is in the file header; measured on an H100 (700 W), the
// warp route factors 8192 matrices of 32 in 0.036 ms and the panel route 1024
// of 128 in 0.165 ms, where torch.linalg.cholesky_ex takes 0.237 and 0.508.

using tml_qr::kFull;
using tml_qr::kWarpN;          // the warp routes' largest n and k
using tml_qr::kWarpMatrices;   // matrices (warps) a block on the warp routes
constexpr int kPanel = 32;          // the panel route's panel width
constexpr int kMaxPanelWarps = 7;   // the panel route's largest block: n <= 224, a row a thread

// The column steps of a 32 x 32 matrix in a warp, in the row layout: lane r
// holds row r, a[c] = A(r, c) for c <= r (a[c] for c > r is never read, and
// may hold anything). Step j takes its pivot from lane j by __shfl_sync;
// every lane scales its a[j] (l_r) and subtracts l_r l_c from a[c], c > j,
// l_c from lane c. No lane tests its index: the products that land above
// the diagonal are never read. inv gets 1/sqrt of the lane's own pivot. A
// matrix with n < 32 is padded with the identity, whose steps change no
// entry of the matrix's own rows.
__device__ __forceinline__ void warp_potrf(float (&a)[kWarpN], int lane, float& inv) {
#pragma unroll
  for (int j = 0; j < kWarpN; ++j) {
    const float ij = 1.f / sqrtf(__shfl_sync(kFull, a[j], j));
    if (lane == j) inv = ij;
    a[j] *= ij;
#pragma unroll
    for (int c = j + 1; c < kWarpN; ++c) a[c] = fmaf(-a[j], __shfl_sync(kFull, a[j], c), a[c]);
  }
}

// One step of a substitution on the KC right-hand sides x[c] (X's row in
// each lane): y_c = x_c(lane src) / d, lane src keeps y and the lanes that
// `take` subtract l y_c.
template <int KC>
__device__ __forceinline__ void warp_solve_step(float (&x)[KC], int src, float d, float l, bool own,
                                                bool take) {
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    const float y = __shfl_sync(kFull, x[c], src) / d;
    if (own) x[c] = y;
    else if (take) x[c] = fmaf(-l, y, x[c]);
  }
}

// A warp a matrix, n <= 32: the matrix goes through the warp's 32 x 33 tile
// of shared memory both ways, so that device memory is read and written a
// row at a time, coalesced (the lower triangle only is read; the identity
// past n). SOLVE (k <= KC <= 32): lane r holds row r of B; L y = b in the
// row layout, then L^T x = y with L turned into the column layout (lane r
// holds column r, a[j] = L(j, r)) through the tile, both with posv_solves'
// divisions and order. Columns of X past k are zeros and stay zeros.
template <int KC>
__global__ void __launch_bounds__(kWarpMatrices * 32) potrf_warp_kernel(const Args p, int64_t batch) {
  __shared__ float tiles[kWarpMatrices][kWarpN][kWarpN + 1];
  const int lane = threadIdx.x & 31;
  float (*t)[kWarpN + 1] = tiles[threadIdx.x >> 5];
  const int64_t bi = int64_t(blockIdx.x) * kWarpMatrices + (threadIdx.x >> 5);
  if (bi >= batch) return;
  const int n = p.n, k = p.k;
  const float* A = p.a + bi * n * n;
#pragma unroll
  for (int r = 0; r < kWarpN; ++r)
    t[r][lane] = lane <= r && r < n ? __ldg(A + r * n + lane) : (r == lane ? 1.f : 0.f);
  __syncwarp();
  float a[kWarpN];
#pragma unroll
  for (int c = 0; c < kWarpN; ++c) a[c] = t[lane][c];
  float inv = 0.f;
  warp_potrf(a, lane, inv);
  float x[KC > 0 ? KC : 1];
  if constexpr (KC > 0) {   // L y = b
    const float* B = p.b + bi * n * k;
#pragma unroll
    for (int c = 0; c < KC; ++c) x[c] = lane < n && c < k ? __ldg(B + lane * k + c) : 0.f;
#pragma unroll
    for (int j = 0; j < kWarpN; ++j)
      warp_solve_step<KC>(x, j, __shfl_sync(kFull, a[j], j), a[j], lane == j, lane > j);
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < kWarpN; ++c) t[lane][c] = c <= lane ? a[c] : 0.f;
  __syncwarp();
  if (p.out != nullptr) {
    float* L = p.out + bi * n * n;
#pragma unroll
    for (int r = 0; r < kWarpN; ++r)
      if (r < n && lane < n) L[r * n + lane] = t[r][lane];
  }
  if constexpr (KC > 0) {   // L^T x = y, on L's columns
#pragma unroll
    for (int j = 0; j < kWarpN; ++j) a[j] = t[j][lane];
#pragma unroll
    for (int j = kWarpN - 1; j >= 0; --j)
      warp_solve_step<KC>(x, j, __shfl_sync(kFull, a[j], j), a[j], lane == j, lane < j);
    float* X = p.x + bi * n * k;
#pragma unroll
    for (int c = 0; c < KC; ++c)
      if (lane < n && c < k) X[lane * k + c] = x[c];
  }
}

// The panel route's shared memory: the matrix padded to np = n rounded up to
// 32 (the identity past n), row-major with ld = np + 4 (a multiple of 4, 4
// mod 32: the rows' float4 reads across threads miss no bank), a panel's 32
// pivots' 1/sqrt, and the right-hand side (n x k).
__host__ __device__ inline int panel_np(int64_t n) { return static_cast<int>((n + kPanel - 1) / kPanel * kPanel); }
int64_t panel_bytes(int64_t n, int64_t k) {
  const int64_t np = panel_np(n);
  return 4 * (np * (np + 4) + kPanel + n * k);
}

// Right-looking in 32-column panels, a block a matrix. A panel p0 takes three
// barriers:
// 1. warp 0 loads the diagonal block in the column layout, factors it
//    (warp_potrf) and writes it back, with the pivots' 1/sqrt;
// 2. a thread a row below the panel solves x L_pp^T = a_r, x_c = (a_rc -
//    sum_{j < c} x_j L(c, j)) / sqrt(pivot_c), the same steps in the same order
//    as the column loop; it writes x to its row and, transposed, to
//    A(p0 + j, r) above the diagonal, where nothing else lives;
// 3. the trailing lower triangle, in 4 x 4 tiles a thread (only lower tiles,
//    each with a row below n): A(r, c) -= sum_j x_rj x_cj over the panel's 32
//    columns in order, both operands read as float4 from the transposed rows.
// SOLVE: a warp a column of X, after the factor: the two substitutions of
// posv_solves with __syncwarp in place of barriers.
template <bool SOLVE>
__global__ void __launch_bounds__(256, 2) potrf_panel_kernel(const Args p) {
  extern __shared__ __align__(16) float smem[];
  const int n = p.n, k = p.k, np = panel_np(n), ld = np + 4;
  float* A = smem;
  float* s_inv = A + np * ld;
  float* X = s_inv + kPanel;
  const int64_t bi = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  const float* a = p.a + bi * n * n;
  for (int r = warp; r < np; r += warps)
    for (int c = lane; c < np; c += 32)
      A[r * ld + c] = r < n && c <= r ? __ldg(a + r * n + c) : (r == c ? 1.f : 0.f);
  if constexpr (SOLVE) {
    const float* b = p.b + bi * n * k;
    for (int e = tid; e < n * k; e += blockDim.x) X[e] = __ldg(b + e);
  }
  __syncthreads();

  for (int p0 = 0; p0 < n; p0 += kPanel) {
    if (warp == 0) {   // the diagonal block, lane r its row p0 + r (identity past n)
      float d[kWarpN];
      float4* row = reinterpret_cast<float4*>(A + (p0 + lane) * ld + p0);
#pragma unroll
      for (int q = 0; q < kPanel / 4; ++q) {
        const float4 v = row[q];
        d[4 * q] = v.x;
        d[4 * q + 1] = v.y;
        d[4 * q + 2] = v.z;
        d[4 * q + 3] = v.w;
      }
      float inv = 0.f;
      warp_potrf(d, lane, inv);
#pragma unroll
      for (int q = 0; q < kPanel / 4; ++q)   // above the diagonal: the block's junk, never read
        row[q] = make_float4(d[4 * q], d[4 * q + 1], d[4 * q + 2], d[4 * q + 3]);
      s_inv[lane] = inv;
    }
    __syncthreads();

    const int rb = p0 + kPanel;
    for (int r = rb + tid; r < n; r += blockDim.x) {
      float x[kPanel];
      float4* row = reinterpret_cast<float4*>(A + r * ld + p0);
#pragma unroll
      for (int q = 0; q < kPanel / 4; ++q) {
        const float4 v = row[q];
        x[4 * q] = v.x;
        x[4 * q + 1] = v.y;
        x[4 * q + 2] = v.z;
        x[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int c = 0; c < kPanel; ++c) {
        const float4* lrow = reinterpret_cast<const float4*>(A + (p0 + c) * ld + p0);
        float v = x[c];
#pragma unroll
        for (int q = 0; 4 * q < c; ++q) {
          const float4 l = lrow[q];
          const float lq[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
          for (int e = 0; e < 4 && 4 * q + e < c; ++e) v = fmaf(-x[4 * q + e], lq[e], v);
        }
        x[c] = v * s_inv[c];
      }
#pragma unroll
      for (int q = 0; q < kPanel / 4; ++q)
        row[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
#pragma unroll
      for (int j = 0; j < kPanel; ++j) A[(p0 + j) * ld + r] = x[j];
    }
    __syncthreads();

    const int t0 = rb / 4, m = (n + 3) / 4 - t0;   // trailing tiles along an edge
    const int tiles = m > 0 ? m * (m + 1) / 2 : 0;
    for (int t = tid; t < tiles; t += blockDim.x) {
      int i = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);   // t's tile row
      while (i * (i + 1) / 2 > t) --i;
      while ((i + 1) * (i + 2) / 2 <= t) ++i;
      const int r0 = 4 * (t0 + i), c0 = 4 * (t0 + t - i * (i + 1) / 2);
      float acc[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 v = *reinterpret_cast<const float4*>(A + (r0 + e) * ld + c0);
        acc[e][0] = v.x;
        acc[e][1] = v.y;
        acc[e][2] = v.z;
        acc[e][3] = v.w;
      }
#pragma unroll 8
      for (int j = 0; j < kPanel; ++j) {
        const float4 lr = *reinterpret_cast<const float4*>(A + (p0 + j) * ld + r0);
        const float4 lc = *reinterpret_cast<const float4*>(A + (p0 + j) * ld + c0);
        const float xr[4] = {lr.x, lr.y, lr.z, lr.w}, xc[4] = {lc.x, lc.y, lc.z, lc.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int f = 0; f < 4; ++f) acc[e][f] = fmaf(-xr[e], xc[f], acc[e][f]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        *reinterpret_cast<float4*>(A + (r0 + e) * ld + c0) =
            make_float4(acc[e][0], acc[e][1], acc[e][2], acc[e][3]);
    }
    __syncthreads();
  }

  if constexpr (SOLVE) {
    for (int c = warp; c < k; c += warps) {
      for (int j = 0; j < n; ++j) {
        const float y = X[j * k + c] / A[j * ld + j];
        __syncwarp();
        if (lane == 0) X[j * k + c] = y;
        for (int r = j + 1 + lane; r < n; r += 32) X[r * k + c] = fmaf(-A[r * ld + j], y, X[r * k + c]);
        __syncwarp();
      }
      for (int j = n - 1; j >= 0; --j) {
        const float y = X[j * k + c] / A[j * ld + j];
        __syncwarp();
        if (lane == 0) X[j * k + c] = y;
        for (int r = lane; r < j; r += 32) X[r * k + c] = fmaf(-A[j * ld + r], y, X[r * k + c]);
        __syncwarp();
      }
    }
    __syncthreads();
    float* x = p.x + bi * n * k;
    for (int e = tid; e < n * k; e += blockDim.x) x[e] = X[e];
  }
  if (p.out != nullptr) {
    float* o = p.out + bi * n * n;
    for (int r = warp; r < n; r += warps)
      for (int c = lane; c < n; c += 32) o[r * n + c] = c <= r ? A[r * ld + c] : 0.f;
  }
}

// The column steps in device memory, in place in the output: one barrier a
// step; step j reads column j and the pivot, and updates the trailing lower
// triangle; column j itself is scaled in step j + 1, when nobody reads it
// (each thread keeps the previous step's 1/sqrt).
__device__ void potrf_steps(const Mat& A, int n) {
  float inv_prev = 0.f;
  for (int j = 0; j < n; ++j) {
    const float inv = 1.f / sqrtf(A(j, j));
    const int m = n - 1 - j;
    for (int e = threadIdx.x; e < m * m; e += blockDim.x) {
      const int r = j + 1 + e / m, c = j + 1 + e % m;
      if (c <= r) A(r, c) -= (A(r, j) * inv) * (A(c, j) * inv);
    }
    if (j > 0)
      for (int r = j - 1 + threadIdx.x; r < n; r += blockDim.x) A(r, j - 1) *= inv_prev;
    inv_prev = inv;
    __syncthreads();
  }
  if (threadIdx.x == 0) A(n - 1, n - 1) *= inv_prev;
  __syncthreads();
}

// L y = b, then L^T x = y, in place on X (n, k): two barriers a step.
__device__ void posv_solves(const Mat& L, float* X, int n, int k) {
  for (int j = 0; j < n; ++j) {
    for (int c = threadIdx.x; c < k; c += blockDim.x) X[j * k + c] = X[j * k + c] / L(j, j);
    __syncthreads();
    for (int e = threadIdx.x; e < (n - 1 - j) * k; e += blockDim.x) {
      const int r = j + 1 + e / k, c = e % k;
      X[r * k + c] -= L(r, j) * X[j * k + c];
    }
    __syncthreads();
  }
  for (int j = n - 1; j >= 0; --j) {
    for (int c = threadIdx.x; c < k; c += blockDim.x) X[j * k + c] = X[j * k + c] / L(j, j);
    __syncthreads();
    for (int e = threadIdx.x; e < j * k; e += blockDim.x) {
      const int r = e / k, c = e % k;
      X[r * k + c] -= L(j, r) * X[j * k + c];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kMaxThreads) potrf_inplace_kernel(const Args p) {
  extern __shared__ float smem[];
  const Block s = stage<false>(p, smem);
  potrf_steps(s.A, p.n);
  if (p.k) posv_solves(s.A, s.X, p.n, p.k);
  unstage<false>(p, s, true);
}

// The routes of potrf and getrf (and their solves), one rule for both
// (dx/solver.py::_potrf_route and ::_getrf_route mirror it).
enum Route { kWarpRoute, kPanelRoute, kInPlaceRoute };

Route factor_route(int64_t n, int64_t k) {
  if (n <= kWarpN && k <= kWarpN) return kWarpRoute;
  return panel_bytes(n, k) <= kSmemMax ? kPanelRoute : kInPlaceRoute;
}

// A block of the panel routes' kernels: bytes of dynamic shared memory,
// raised past 48 KB (the default) where it needs more.
cudaError_t smem_for(Kernel kernel, int64_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

cudaError_t launch_potrf(const Args& p, int64_t batch, cudaStream_t stream) {
  const Route route = factor_route(p.n, p.k);
  if (route == kWarpRoute) {
    const unsigned blocks = static_cast<unsigned>((batch + kWarpMatrices - 1) / kWarpMatrices);
    void (*kernel)(Args, int64_t) = p.k == 0   ? potrf_warp_kernel<0>
                                    : p.k <= 4 ? potrf_warp_kernel<4>
                                               : potrf_warp_kernel<kWarpN>;
    kernel<<<blocks, kWarpMatrices * 32, 0, stream>>>(p, batch);
    return cudaGetLastError();
  }
  if (route == kPanelRoute) {
    const Kernel kernel = p.k ? potrf_panel_kernel<true> : potrf_panel_kernel<false>;
    const int64_t bytes = panel_bytes(p.n, p.k);
    const cudaError_t e = smem_for(kernel, bytes);
    if (e != cudaSuccess) return e;
    kernel<<<static_cast<unsigned>(batch), panel_np(p.n) <= 64 ? 128 : 256,
             static_cast<size_t>(bytes), stream>>>(p);
    return cudaGetLastError();
  }
  if (p.out == nullptr) return cudaErrorInvalidValue;
  const int64_t bytes = small_bytes(p.n, p.n, p.k);
  const cudaError_t e = smem_for(potrf_inplace_kernel, bytes);
  if (e != cudaSuccess) return e;
  potrf_inplace_kernel<<<static_cast<unsigned>(batch), threads_for(p.n), static_cast<size_t>(bytes),
                         stream>>>(p);
  return cudaGetLastError();
}

// ----------------------------- LU -----------------------------

// (v1, i1) before (v2, i2) as a pivot: NaN first, then the larger
// magnitude, then the lower row.
__device__ __forceinline__ bool before(float v1, int i1, float v2, int i2) {
  const bool n1 = isnan(v1), n2 = isnan(v2);
  if (n1 || n2) return n1 && (!n2 || i1 < i2);
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// Steps of LU: with pivoting, warp 0 finds the pivot (a shuffle reduction
// carrying the row), then row j and the pivot row are swapped whole; then the
// trailing update, which divides column j by the pivot on the fly; column j
// takes its multipliers in step j + 1, when nobody reads it. Without
// pivoting, one barrier a step.
__device__ void getrf_steps(const Mat& A, int n, bool pivot, int* s_piv, int32_t* piv_out) {
  float d_prev = 1.f;
  for (int j = 0; j < n; ++j) {
    if (pivot) {
      if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        float best = -1.f;
        int row = n;
        for (int r = j + lane; r < n; r += 32) {
          const float v = fabsf(A(r, j));
          if (before(v, r, best, row)) { best = v; row = r; }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, best, off);
          const int orow = __shfl_xor_sync(0xffffffffu, row, off);
          if (before(ov, orow, best, row)) { best = ov; row = orow; }
        }
        if (lane == 0) s_piv[j] = row;
      }
      __syncthreads();
      const int pr = s_piv[j];
      if (pr != j)
        for (int c = threadIdx.x; c < n; c += blockDim.x) {
          const float t = A(j, c);
          A(j, c) = A(pr, c);
          A(pr, c) = t;
        }
      __syncthreads();
    } else if (threadIdx.x == 0) {
      s_piv[j] = j;
    }
    if (piv_out != nullptr && threadIdx.x == 0) piv_out[j] = s_piv[j];
    const float d = A(j, j);
    const int m = n - 1 - j;
    for (int e = threadIdx.x; e < m * m; e += blockDim.x) {
      const int r = j + 1 + e / m, c = j + 1 + e % m;
      A(r, c) -= A(r, j) / d * A(j, c);
    }
    if (j > 0)
      for (int r = j + threadIdx.x; r < n; r += blockDim.x) A(r, j - 1) = A(r, j - 1) / d_prev;
    d_prev = d;
    __syncthreads();
  }
}

// U X = Y in place on the first n rows of X (n x k): two barriers a step.
__device__ void upper_solve(const Mat& U, float* X, int n, int k) {
  for (int j = n - 1; j >= 0; --j) {
    for (int c = threadIdx.x; c < k; c += blockDim.x) X[j * k + c] = X[j * k + c] / U(j, j);
    __syncthreads();
    for (int e = threadIdx.x; e < j * k; e += blockDim.x) {
      const int r = e / k, c = e % k;
      X[r * k + c] -= U(r, j) * X[j * k + c];
    }
    __syncthreads();
  }
}

// The row swaps applied to X in sequence, then L y = P b (unit lower) and
// U x = y.
__device__ void gesv_solves(const Mat& LU, const int* s_piv, float* X, int n, int k) {
  for (int c = threadIdx.x; c < k; c += blockDim.x)
    for (int j = 0; j < n; ++j) {
      const int pr = s_piv[j];
      const float t = X[j * k + c];
      X[j * k + c] = X[pr * k + c];
      X[pr * k + c] = t;
    }
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    for (int e = threadIdx.x; e < (n - 1 - j) * k; e += blockDim.x) {
      const int r = j + 1 + e / k, c = e % k;
      X[r * k + c] -= LU(r, j) * X[j * k + c];
    }
    __syncthreads();
  }
  upper_solve(LU, X, n, k);
}

// The in-place route: the column steps in device memory, in the output.
__global__ void __launch_bounds__(kMaxThreads) getrf_inplace_kernel(const Args p) {
  extern __shared__ float smem[];
  const Block s = stage<false>(p, smem);
  int32_t* piv = p.piv ? p.piv + static_cast<int64_t>(blockIdx.x) * p.n : nullptr;
  getrf_steps(s.A, p.n, p.pivot != 0, s.piv, piv);
  if (p.k) gesv_solves(s.A, s.piv, s.X, p.n, p.k);
}

// ----------------------------- LU, a warp a matrix -----------------------------
//
// n <= 32 and k <= 32 (factor_route; dx/solver.py::_getrf_route mirrors it),
// 4 matrices a block, no block barrier:
// lane r holds row r of A in registers, a[c] = A(r, c), loaded and stored
// through the warp's 32 x 33 tile so that device memory moves a row at a
// time, coalesced. Rows do not move (virtual pivoting): each lane keeps
// `pos`, the index its row has after the swaps so far (initially r), and
// `step`, the step at which its row became a pivot row; `live` says it has
// not yet. Rows past n are the identity and never live, so that a pad row
// (which 0 / 0 would turn to NaN after a zero pivot) is never picked. Step
// j: the pivot is the live lane with the first (|a[j]|, pos) in before()'s
// order (NaN first, then the larger magnitude, then the lower current row
// index, never the lane number), found by a 5-step __shfl_xor_sync
// reduction; ipiv[j] is its pos, the lane at pos j takes that pos and the
// pivot lane takes j. Without pivoting the pivot of step j is lane j. The
// live lanes then divide a[j] by the pivot (a true division: the
// multiplier, kept in a[j]) and subtract l u_c from a[c], c > j, u_c from
// the pivot lane by __shfl_sync: getrf_steps' updates, each row's in the
// same order. At the end lane r writes its row to row pos. SOLVE (KC >= k):
// B's row r travels with lane r, so the swaps cost nothing; with the pivot
// lane of each step kept in shared memory, L y = P b and U x = y run as
// shuffle steps in gesv_solves' order (a lane takes part in step j of the
// first while its row was live at step j, of the second while it was a
// pivot row before step j), and lane r writes its row of X to row pos.
// Columns of X past k are zeros and stay zeros.
template <int KC>
__global__ void __launch_bounds__(kWarpMatrices * 32, KC == kWarpN ? 4 : 8)
getrf_warp_kernel(const Args p, int64_t batch) {
  __shared__ float tiles[kWarpMatrices][kWarpN][kWarpN + 1];
  __shared__ int pivot_lanes[kWarpMatrices][kWarpN];
  const int lane = threadIdx.x & 31;
  float (*t)[kWarpN + 1] = tiles[threadIdx.x >> 5];
  int* pl_of = pivot_lanes[threadIdx.x >> 5];
  const int64_t bi = int64_t(blockIdx.x) * kWarpMatrices + (threadIdx.x >> 5);
  if (bi >= batch) return;
  const int n = p.n, k = p.k;
  const bool pivot = p.pivot != 0;
  const float* A = p.a + bi * n * n;
#pragma unroll
  for (int r = 0; r < kWarpN; ++r)
    t[r][lane] = r < n && lane < n ? __ldg(A + r * n + lane) : (r == lane ? 1.f : 0.f);
  __syncwarp();
  float a[kWarpN];
#pragma unroll
  for (int c = 0; c < kWarpN; ++c) a[c] = t[lane][c];
  int pos = lane, step = n, ipiv = 0;
  bool live = lane < n;
#pragma unroll
  for (int j = 0; j < kWarpN; ++j) {
    if (j >= n) break;
    int pl = j;   // the pivot lane
    if (pivot) {
      float bv = live ? fabsf(a[j]) : -1.f;
      int bp = live ? pos : kWarpN;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int op = __shfl_xor_sync(kFull, bp, off);
        if (before(ov, op, bv, bp)) { bv = ov; bp = op; }
      }
      pl = __ffs(__ballot_sync(kFull, live && pos == bp)) - 1;
      if (lane == j) ipiv = bp;
      if (pos == j) pos = bp;
      if (lane == pl) pos = j;
    } else if (lane == j) {
      ipiv = j;
    }
    if (KC > 0 && lane == 0) pl_of[j] = pl;
    const float d = __shfl_sync(kFull, a[j], pl);
    if (lane == pl) {
      live = false;
      step = j;
    }
    const float l = a[j] / d;
#pragma unroll
    for (int c = j + 1; c < kWarpN; ++c) {
      if (c >= n) break;
      const float u = __shfl_sync(kFull, a[c], pl);
      if (live) a[c] = fmaf(-l, u, a[c]);
    }
    if (live) a[j] = l;
  }
  if (p.piv != nullptr && lane < n) p.piv[bi * n + lane] = ipiv;
  __syncwarp();
  if (p.out != nullptr) {
#pragma unroll
    for (int c = 0; c < kWarpN; ++c) t[pos][c] = a[c];
    __syncwarp();
    float* LU = p.out + bi * n * n;
#pragma unroll
    for (int r = 0; r < kWarpN; ++r)
      if (r < n && lane < n) LU[r * n + lane] = t[r][lane];
  }
  if constexpr (KC > 0) {
    const float* B = p.b + bi * n * k;
    float x[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) x[c] = lane < n && c < k ? __ldg(B + lane * k + c) : 0.f;
#pragma unroll
    for (int j = 0; j < kWarpN; ++j) {   // L y = P b, L unit lower
      if (j >= n) break;
      warp_solve_step<KC>(x, pl_of[j], 1.f, a[j], false, step > j);
    }
#pragma unroll
    for (int j = kWarpN - 1; j >= 0; --j) {   // U x = y
      if (j >= n) continue;
      const int src = pl_of[j];
      warp_solve_step<KC>(x, src, __shfl_sync(kFull, a[j], src), a[j], lane == src, step < j);
    }
    float* X = p.x + bi * n * k;
#pragma unroll
    for (int c = 0; c < KC; ++c)
      if (lane < n && c < k) X[pos * k + c] = x[c];
  }
}

// ----------------------------- LU, 32-column panels -----------------------------
//
// n > 32 or k > 32 while the padded matrix and the right-hand side fit in a
// block's shared memory (factor_route, panel_bytes: n <= 224 without a
// right-hand side): right-looking LU in 32-column panels, LAPACK's getf2,
// laswp, trsm and gemm, a block of np = n rounded up to 32 threads a matrix.
// Shared memory as potrf_panel_kernel's: the matrix padded to np with the
// identity, ld = np + 4; the panel's 32 pivots; X (n x k). The 4 words past
// np of the first rows, which hold no entry of the matrix, hold the pivot
// search's slots. A panel p0 (its 32 columns, w = min(32, n - p0) of them
// the matrix's) takes w + 4 barriers:
// 1. Its steps, thread t holding row t's 32 panel entries in registers. Rows
//    do not move (virtual pivoting, as in getrf_warp_kernel): each keeps pos,
//    its row's index after the swaps so far, and live, not yet a pivot row;
//    rows past n are never live, so a pad row (which 0 / 0 turns to NaN after
//    a zero pivot) is never a pivot. Step j: each warp finds its first live
//    (|a[j]|, pos) in before()'s order by two __reduce_*_sync (pivot_key, then
//    the lowest pos); its winner writes its row to its own place in shared
//    memory (read only at the step that row is the pivot, after which it is
//    never live again) and the warp's key, 255 - pos and thread to a 64-bit
//    slot (two sets, alternate steps); one barrier; every thread takes the
//    largest slot, reads the pivot row, and the live rows divide a[j] by the
//    pivot (a true division: the multiplier) and subtract l u_c from a[c], c
//    > j. Without pivoting the pivot of step j is row j. A barrier; each row
//    goes to row pos; a barrier.
// 2. A thread a column outside the panel (and a column of X) applies the
//    panel's swaps in sequence (laswp); right of the panel it then solves
//    L11 U12 = A12 down its column, row r against L11's row r (float4 reads),
//    in ascending j.
// 3. The trailing A22 -= L21 U12 in 4 x 4 tiles a thread, each element's 32
//    products in ascending j, from float4 chunks of L's rows and U's rows.
// Swaps commute with the work on other columns and each element takes its
// updates in _getrf_plain's order, so the pivots are the plain loop's and
// the factor equals its to rounding (nvcc's FMAs). SOLVE: X's rows take
// each panel's swaps in step 2; after the last panel a warp a column of X
// runs L y = P b and U x = y in gesv_solves' order.

// A row's pivot key, the larger first: before()'s order of magnitudes, a NaN
// above every number; 0 for a row that is not live, below every live one.
__device__ __forceinline__ unsigned pivot_key(float v, bool live) {
  const float m = fabsf(v);
  return !live ? 0u : isnan(m) ? 0xffffffffu : __float_as_uint(m) + 1u;
}

// 168 registers a thread keep three blocks of 128 threads on an SM (n = 128:
// shared memory allows three) without a spill (launch bounds for 224 threads
// cap it at 128, where it spills).
template <bool SOLVE>
__global__ void __maxnreg__(168) getrf_panel_kernel(const Args p) {
  extern __shared__ __align__(16) float smem[];
  const int n = p.n, k = p.k, np = panel_np(n), ld = np + 4;
  float* A = smem;
  int* s_piv = reinterpret_cast<int*>(A + np * ld);
  float* X = A + np * ld + kPanel;
  const int64_t bi = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  const bool pivot = p.pivot != 0;
  const float* a = p.a + bi * n * n;
  if (n % 4 == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0) {
    const int cq = tid % (np / 4), c = 4 * cq;   // thread t: float4 column cq, rows r0 + 4 i
#pragma unroll 4
    for (int r = tid / (np / 4); r < np; r += 4) {
      const float4 v = r < n && c < n ? __ldg(reinterpret_cast<const float4*>(a + r * n) + cq)
                                      : make_float4(r == c, r == c + 1, r == c + 2, r == c + 3);
      *reinterpret_cast<float4*>(A + r * ld + c) = v;
    }
  } else {
#pragma unroll 8
    for (int r = 0; r < np; ++r)   // thread t loads column t, 8 rows in flight
      A[r * ld + tid] = r < n && tid < n ? __ldg(a + r * n + tid) : (r == tid ? 1.f : 0.f);
  }
  if constexpr (SOLVE) {
    const float* b = p.b + bi * n * k;
    for (int e = tid; e < n * k; e += blockDim.x) X[e] = __ldg(b + e);
  }
  __syncthreads();
  // slot s of the pivot search: the words past np of row s
  auto slot = [&](int s) { return reinterpret_cast<unsigned long long*>(A + s * ld + np); };

  for (int p0 = 0; p0 < n; p0 += kPanel) {
    float row[kPanel];
    float4* mine = reinterpret_cast<float4*>(A + tid * ld + p0);
#pragma unroll
    for (int q = 0; q < kPanel / 4; ++q) {
      const float4 v = tid >= p0 ? mine[q] : make_float4(0.f, 0.f, 0.f, 0.f);
      row[4 * q] = v.x;
      row[4 * q + 1] = v.y;
      row[4 * q + 2] = v.z;
      row[4 * q + 3] = v.w;
    }
    int pos = tid;
    bool live = tid >= p0 && tid < n;
#pragma unroll
    for (int jj = 0; jj < kPanel; ++jj) {
      const int j = p0 + jj;
      if (j >= n) break;
      int pr = j, prow = j;   // the pivot's pos, and the thread holding its row
      bool write = tid == j;  // this thread puts its row where the others read it
      if (pivot) {
        const unsigned key = pivot_key(row[jj], live);
        const unsigned wkey = __reduce_max_sync(kFull, key);
        const int wpos = __reduce_min_sync(kFull, key == wkey && key != 0u ? pos : INT_MAX);
        write = key == wkey && key != 0u && pos == wpos;
        if (write || (wkey == 0u && lane == 0))   // key, then 255 - pos, then the row's thread
          *slot((jj & 1) * warps + warp) =
              wkey == 0u ? 0ull : (static_cast<unsigned long long>(wkey) << 32) |
                                      static_cast<unsigned>((255 - wpos) << 8 | tid);
      }
      if (write) {
#pragma unroll
        for (int q = jj / 4; q < kPanel / 4; ++q)
          mine[q] = make_float4(row[4 * q], row[4 * q + 1], row[4 * q + 2], row[4 * q + 3]);
      }
      __syncthreads();
      if (pivot) {   // the largest slot of the warps that hold rows >= p0, all read at once
        unsigned long long key[kMaxPanelWarps];
#pragma unroll
        for (int w = 0; w < kMaxPanelWarps; ++w)
          key[w] = w >= p0 / 32 && w < warps ? *slot((jj & 1) * warps + w) : 0ull;
#pragma unroll
        for (int span = 1; span < kMaxPanelWarps; span *= 2)
#pragma unroll
          for (int w = 0; w + span < kMaxPanelWarps; w += 2 * span) key[w] = max(key[w], key[w + span]);
        pr = 255 - static_cast<int>(key[0] >> 8 & 0xff);
        prow = static_cast<int>(key[0] & 0xff);
        if (pos == j) pos = pr;
        if (tid == prow) pos = j;
      }
      if (tid == 0) {
        s_piv[jj] = pr;
        if (p.piv != nullptr) p.piv[bi * n + j] = pr;
      }
      if (tid == prow) live = false;
      // every thread computes; the live rows keep it (no branch: the next
      // step's pivot key can start as soon as its column is done). The pivot
      // row is read before the division, whose slow path is a branch.
      const float4* u = reinterpret_cast<const float4*>(A + prow * ld + p0);
      float uq[kPanel];
#pragma unroll
      for (int q = jj / 4; q < kPanel / 4; ++q) {
        const float4 v = u[q];
        uq[4 * q] = v.x;
        uq[4 * q + 1] = v.y;
        uq[4 * q + 2] = v.z;
        uq[4 * q + 3] = v.w;
      }
      const float l = row[jj] / uq[jj];
#pragma unroll
      for (int c = jj + 1; c < kPanel; ++c) row[c] = live ? fmaf(-l, uq[c], row[c]) : row[c];
      row[jj] = live ? l : row[jj];
    }
    __syncthreads();
    if (tid >= p0) {
      float4* to = reinterpret_cast<float4*>(A + pos * ld + p0);
#pragma unroll
      for (int q = 0; q < kPanel / 4; ++q)
        to[q] = make_float4(row[4 * q], row[4 * q + 1], row[4 * q + 2], row[4 * q + 3]);
    }
    __syncthreads();

    const int w = min(kPanel, n - p0), outside = n - w;
    for (int i = tid; i < outside + k; i += blockDim.x) {
      float* col = i < outside ? A + (i < p0 ? i : i + w) : X + (i - outside);
      const int stride = i < outside ? ld : k;
      for (int jj = 0; jj < w; ++jj) {   // laswp
        const int pr = s_piv[jj];
        if (pr != p0 + jj) {
          const float t = col[(p0 + jj) * stride];
          col[(p0 + jj) * stride] = col[pr * stride];
          col[pr * stride] = t;
        }
      }
      if (i < outside && i >= p0) {   // right of the panel (w = 32): L11 U12 = A12
        float x[kPanel];
#pragma unroll
        for (int r = 0; r < kPanel; ++r) x[r] = col[(p0 + r) * ld];
#pragma unroll
        for (int r = 1; r < kPanel; ++r) {
          const float4* lrow = reinterpret_cast<const float4*>(A + (p0 + r) * ld + p0);
          float v = x[r];
#pragma unroll
          for (int q = 0; 4 * q < r; ++q) {
            const float4 l = lrow[q];
            const float lq[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
            for (int e = 0; e < 4 && 4 * q + e < r; ++e) v = fmaf(-x[4 * q + e], lq[e], v);
          }
          x[r] = v;
        }
#pragma unroll
        for (int r = 1; r < kPanel; ++r) col[(p0 + r) * ld] = x[r];
      }
    }
    __syncthreads();

    const int rb = p0 + kPanel, m4 = (n - rb + 3) / 4;   // trailing tiles along an edge
    for (int t = tid; rb < n && t < m4 * m4; t += blockDim.x) {
      const int r0 = rb + 4 * (t / m4), c0 = rb + 4 * (t % m4);
      float acc[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 v = *reinterpret_cast<const float4*>(A + (r0 + e) * ld + c0);
        acc[e][0] = v.x;
        acc[e][1] = v.y;
        acc[e][2] = v.z;
        acc[e][3] = v.w;
      }
#pragma unroll 1
      for (int jq = 0; jq < kPanel / 4; ++jq) {
        float lv[4][4], uv[4][4];   // L(r0 + e, p0 + 4 jq + q), U(p0 + 4 jq + q, c0 + f)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 l = *reinterpret_cast<const float4*>(A + (r0 + e) * ld + p0 + 4 * jq);
          const float4 u = *reinterpret_cast<const float4*>(A + (p0 + 4 * jq + e) * ld + c0);
          lv[e][0] = l.x;
          lv[e][1] = l.y;
          lv[e][2] = l.z;
          lv[e][3] = l.w;
          uv[e][0] = u.x;
          uv[e][1] = u.y;
          uv[e][2] = u.z;
          uv[e][3] = u.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int f = 0; f < 4; ++f) acc[e][f] = fmaf(-lv[e][q], uv[q][f], acc[e][f]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        *reinterpret_cast<float4*>(A + (r0 + e) * ld + c0) =
            make_float4(acc[e][0], acc[e][1], acc[e][2], acc[e][3]);
    }
    __syncthreads();
  }

  if constexpr (SOLVE) {
    for (int c = warp; c < k; c += warps) {
      for (int j = 0; j < n; ++j) {   // L y = P b, L unit lower
        const float y = X[j * k + c];
        for (int r = j + 1 + lane; r < n; r += 32) X[r * k + c] = fmaf(-A[r * ld + j], y, X[r * k + c]);
        __syncwarp();
      }
      for (int j = n - 1; j >= 0; --j) {   // U x = y
        const float y = X[j * k + c] / A[j * ld + j];
        __syncwarp();
        if (lane == 0) X[j * k + c] = y;
        for (int r = lane; r < j; r += 32) X[r * k + c] = fmaf(-A[r * ld + j], y, X[r * k + c]);
        __syncwarp();
      }
    }
    __syncthreads();
    float* x = p.x + bi * n * k;
    for (int e = tid; e < n * k; e += blockDim.x) x[e] = X[e];
  }
  if (p.out != nullptr) {
    float* o = p.out + bi * n * n;
    if (n % 4 == 0 && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
      const int cq = tid % (np / 4), c = 4 * cq;
      for (int r = tid / (np / 4); r < n && c < n; r += 4)
        reinterpret_cast<float4*>(o + r * n)[cq] = *reinterpret_cast<const float4*>(A + r * ld + c);
    } else if (tid < n) {
      for (int r = 0; r < n; ++r) o[r * n + tid] = A[r * ld + tid];
    }
  }
}

// ----------------------------- QR -----------------------------

// Three barriers a step: warp 0 builds the reflector's scalars from column
// j; every thread then forms v (s_v) and, one column each, w = tau_h v^T A
// (s_w); then the rank-1 update of rows and columns >= j, with column j's
// rows below the diagonal taking the normalised reflector. A is m x n, m >= n.
__device__ void geqrf_steps(const Mat& A, int m, int n, float* s_v, float* s_w, float* s_scal,
                            float* tau) {
  for (int j = 0; j < n; ++j) {
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      float ss = 0.f, ts = 0.f;
      for (int r = j + lane; r < m; r += 32) {
        const float x = A(r, j);
        ss += x * x;
        if (r > j) ts += x * x;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
        ts += __shfl_xor_sync(0xffffffffu, ts, off);
      }
      if (lane == 0) {
        const float xj = A(j, j);
        const bool degenerate = ts == 0.f;
        const float sign = xj > 0.f ? 1.f : xj < 0.f ? -1.f : xj == 0.f ? 1.f : xj;
        const float alpha = degenerate ? xj : -sign * sqrtf(ss);
        const float vj = xj - alpha;
        const float vsq = degenerate ? 0.f : ts + vj * vj;
        const bool safe = vsq > 0.f;
        const float tau_h = safe ? 2.f / vsq : 0.f;
        s_scal[0] = tau_h;
        s_scal[1] = vj == 0.f ? 1.f : vj;
        s_scal[2] = vj;
        s_scal[3] = degenerate ? 1.f : 0.f;
        tau[j] = safe ? tau_h * vj * vj : 0.f;
      }
    }
    __syncthreads();
    const float tau_h = s_scal[0], vdiv = s_scal[1], vj = s_scal[2];
    const bool degenerate = s_scal[3] != 0.f;
    // v: column j with v_j = x_j - alpha, all zero for a zero tail
    for (int r = j + threadIdx.x; r < m; r += blockDim.x)
      s_v[r] = degenerate ? 0.f : r == j ? vj : A(r, j);
    for (int c = j + threadIdx.x; c < n; c += blockDim.x) {
      float acc = 0.f;
      if (!degenerate)
        for (int r = j; r < m; ++r) acc += (r == j ? vj : A(r, j)) * A(r, c);
      s_w[c] = acc * tau_h;
    }
    __syncthreads();
    const int rows = m - j, cols = n - j;
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const int r = j + e / cols, c = j + e % cols;
      if (c == j && r > j)
        A(r, j) = s_v[r] / vdiv;
      else
        A(r, c) -= s_v[r] * s_w[c];
    }
    __syncthreads();
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads) geqrf_kernel(const Args p) {
  extern __shared__ float smem[];
  const Block s = stage<kShared>(p, smem);
  geqrf_steps(s.A, p.m, p.n, s.v, s.w, s.scal, p.tau + static_cast<int64_t>(blockIdx.x) * p.n);
  unstage<kShared>(p, s, false);
}

// ----------------------------- unmqr / gels -----------------------------

// H_j = I - tau_j v v^T applied to X (m x k) for each reflector of QR (m x n),
// j ascending for Q^T X, descending for Q X; v_j = 1 is implied and v's
// entries are read below the diagonal. Two barriers a reflector: one warp a
// column of X forms w = tau_j v^T X (s_w, a shuffle reduction), then the
// rank-1 update X -= v w^T of rows >= j.
__device__ void apply_q(const Mat& QR, const float* tau, float* X, int m, int n, int k,
                        bool trans, float* s_w) {
  const int steps = min(m, n);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int i = 0; i < steps; ++i) {
    const int j = trans ? i : steps - 1 - i;
    for (int c = warp; c < k; c += warps) {
      float acc = 0.f;
      for (int r = j + lane; r < m; r += 32) acc += (r == j ? 1.f : QR(r, j)) * X[r * k + c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) s_w[c] = acc * tau[j];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < (m - j) * k; e += blockDim.x) {
      const int r = j + e / k, c = e % k;
      X[r * k + c] -= (r == j ? 1.f : QR(r, j)) * s_w[c];
    }
    __syncthreads();
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads) unmqr_kernel(const Args p) {
  extern __shared__ float smem[];
  const Block s = stage<kShared>(p, smem);
  apply_q(s.A, p.tau + static_cast<int64_t>(blockIdx.x) * p.n, s.X, p.m, p.n, p.k, p.trans != 0,
          s.w);
  unstage<kShared>(p, s, false);
}

// The QR steps on m rows (tau kept in s_t), Q^T B, then R X = (Q^T B)[:n].
template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads) gels_kernel(const Args p) {
  extern __shared__ float smem[];
  const Block s = stage<kShared>(p, smem);
  geqrf_steps(s.A, p.m, p.n, s.v, s.w, s.scal, s.t);
  apply_q(s.A, s.t, s.X, p.m, p.n, p.k, true, s.w);
  upper_solve(s.A, s.X, p.n, p.k);
  unstage<kShared>(p, s, false);
}

// ----------------------------- gels, a warp a matrix -----------------------------
//
// m <= 64, n <= 32 and k <= 32 (gels_warp_route; dx/solver.py::_gels_route
// mirrors it), kWarpMatrices matrices a block, no block barrier. Lane c holds
// column c of A, rows 0 ... 32 R - 1 in registers (R = 1 for m <= 32, else 2;
// the rows past m zeros that take no part: m = 32 R takes an instantiation of
// the steps that tests no row), loaded a row of A at a time, and the QR
// steps run as gels_qr_steps takes them (csrc/dx_qr_warp.cuh, shared with
// geqrf's warp route in csrc/dx_qr_warp.cu).
// Lane j keeps R's entry and v below it; after the last step each lane divides
// its column below the diagonal by its v_j, all lanes at once: the reflector
// geqrf_steps stores. The factored columns then go to the warp's tile (QR, m x
// 33), and B is taken 4 columns at a time (lane r holds rows r and r + 32 of
// them in registers): the stored reflectors (v_j = 1, tau = tau_h v_j^2,
// each lane reading its rows' entries from the tile) go on in order, as
// _apply_q_plain applies them: each lane forms its rows' share of v^T B's
// sums, a 5-step butterfly adds them (every lane gets the same sum), and each
// lane updates its rows; then R X = (Q^T B)[:n], R's row r in lane r, by
// warp_solve_step's divisions in _trsm_upper_rect_plain's order; X is written
// as the substitution leaves it (ROADMAP C18). The QR's and Q^T B's sums run
// in another order than torch's products: the result equals _gels_plain's to
// rounding. R = 2 takes 153 registers without a spill at three blocks an SM
// (at four, whose cap is 128, it spills).

using tml_qr::gels_qr_steps;

template <int R>
__global__ void __launch_bounds__(kWarpMatrices * 32, R == 1 ? 4 : 3) gels_warp_kernel(const Args p, int64_t batch) {
  constexpr int M = 32 * R, KG = 4;   // KG: B's columns in registers at a time
  __shared__ __align__(16) float slices[kWarpMatrices][2 * M + 4];   // v, its copy, 4 scalars
  __shared__ float tiles[kWarpMatrices][M][kWarpN + 1];              // QR
  __shared__ float tau_of[kWarpMatrices][kWarpN];
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  float (*t)[kWarpN + 1] = tiles[wi];
  float* taus = tau_of[wi];
  const int64_t bi = int64_t(blockIdx.x) * kWarpMatrices + wi;
  if (bi >= batch) return;
  const int m = p.m, n = p.n, k = p.k;
  const float* A = p.a + bi * m * n;
  float a[M];
#pragma unroll
  for (int r = 0; r < M; ++r) a[r] = lane < n && r < m ? __ldg(A + r * n + lane) : 0.f;
  float vdiv = 1.f;
  if (m == M)
    gels_qr_steps<R, true>(a, slices[wi], taus, vdiv, lane, m, n);
  else
    gels_qr_steps<R, false>(a, slices[wi], taus, vdiv, lane, m, n);
#pragma unroll
  for (int r = 0; r < M; ++r) {   // the reflectors: v_r / v_j below the diagonal, as stored
    if (r > lane) a[r] = a[r] / vdiv;
    if (r < m) t[r][lane] = a[r];
  }
  __syncwarp();

  float rrow[kWarpN];   // R's row `lane`
#pragma unroll
  for (int j = 0; j < kWarpN; ++j) rrow[j] = t[lane][j];
  const float* B = p.b + bi * m * k;
  float* X = p.x + bi * n * k;
  for (int c0 = 0; c0 < k; c0 += KG) {
    float x[R][KG];
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int c = 0; c < KG; ++c)
        x[q][c] = lane + 32 * q < m && c0 + c < k ? __ldg(B + (lane + 32 * q) * k + c0 + c) : 0.f;
#pragma unroll
    for (int j = 0; j < kWarpN; ++j) {   // H_j = I - tau_j v v^T, v_j = 1 and below it QR's column j
      if (j >= n) break;
      const float tau = taus[j];
      float vr[R];
      bool on[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int r = lane + 32 * q;
        on[q] = r >= j && r < m;
        vr[q] = r == j ? 1.f : on[q] ? t[r][j] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < KG; ++c) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < R; ++q)
          if (on[q]) s = fmaf(vr[q], x[q][c], s);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
        const float wq = s * tau;
#pragma unroll
        for (int q = 0; q < R; ++q)
          if (on[q]) x[q][c] = fmaf(-vr[q], wq, x[q][c]);
      }
    }
#pragma unroll
    for (int j = kWarpN - 1; j >= 0; --j) {   // R X = (Q^T B)[:n]
      if (j >= n) continue;
      warp_solve_step<KG>(x[0], j, __shfl_sync(kFull, rrow[j], j), rrow[j], lane == j, lane < j);
    }
#pragma unroll
    for (int c = 0; c < KG; ++c)
      if (lane < n && c0 + c < k) X[lane * k + c0 + c] = x[0][c];
  }
}

bool gels_warp_route(int64_t m, int64_t n, int64_t k) {
  return m <= 2 * kWarpN && n <= kWarpN && k <= kWarpN;
}

// ----------------------------- launch -----------------------------

cudaError_t launch(Kernel in_shared, Kernel in_place, const Args& p, int64_t batch, void* stream) {
  const bool shared = full_bytes(p.m, p.n, p.k) <= kSmemMax;
  if (!shared && p.out == nullptr) return cudaErrorInvalidValue;
  const Kernel kernel = shared ? in_shared : in_place;
  const int64_t bytes = shared ? full_bytes(p.m, p.n, p.k) : small_bytes(p.m, p.n, p.k);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(batch), threads_for(std::max(p.m, p.n)), static_cast<size_t>(bytes),
           static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

bool bad_sizes(const void* a, int64_t batch, int64_t m, int64_t n, int64_t k, const void* b,
               const void* x) {
  return a == nullptr || batch < 0 || batch > 0x7fffffff || n < 1 || n > kMaxN || m < 1 ||
         m > kMaxN || k < 0 || m * k > (int64_t{1} << 30) ||
         (k > 0 && (b == nullptr || x == nullptr));
}

Args make_args(const void* a, void* out, const void* b, void* x, int64_t m, int64_t n,
               int64_t k) {
  Args p{};
  p.a = static_cast<const float*>(a);
  p.out = static_cast<float*>(out);
  p.b = static_cast<const float*>(b);
  p.x = static_cast<float*>(x);
  p.m = static_cast<int>(m);
  p.n = static_cast<int>(n);
  p.k = static_cast<int>(k);
  p.xrows = p.m;
  return p;
}

}  // namespace

extern "C" {

// a: (batch, n, n) f32 contiguous, SPD (the lower triangle is read). Without a
// right-hand side (k = 0, b = x = null) writes the lower factor to l (batch,
// n, n), zeros above the diagonal. With one, b (batch, n, k) in and x (batch,
// n, k) out, the solution of A X = B; l may then be null where the matrix
// fits in shared memory (full_bytes(n, n, k) <= 232448), else it is the factor's
// work space. Launches on `stream`; returns the CUDA status (0 on success).
int tml_potrf_batched(const void* a, void* l, const void* b, void* x, int64_t batch, int64_t n,
                      int64_t k, void* stream) {
  if (bad_sizes(a, batch, n, n, k, b, x) || (k == 0 && l == nullptr))
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  return launch_potrf(make_args(a, l, b, x, n, n, k), batch, static_cast<cudaStream_t>(stream));
}

// As tml_potrf_batched, for LU: lu (batch, n, n) in the packed L\U layout and
// piv (batch, n) int32, the row swapped with j at step j (j itself when
// pivot = 0). With a right-hand side (gesv; pivot must be 1) piv may be null.
// Routes by factor_route: n <= 32 and k <= 32 a warp a matrix
// (getrf_warp_kernel); else, where panel_bytes(n, k) <= 232448, 32-column
// panels in a block's shared memory (getrf_panel_kernel; lu may then be null
// for a solve); else the column steps in place in lu (getrf_inplace_kernel),
// which a solve must then pass as the factor's work space.
int tml_getrf_batched(const void* a, void* lu, void* piv, const void* b, void* x, int64_t batch,
                      int64_t n, int64_t k, int pivot, void* stream) {
  if (bad_sizes(a, batch, n, n, k, b, x) || (k == 0 && (lu == nullptr || piv == nullptr)) ||
      (k > 0 && pivot == 0))
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  Args p = make_args(a, lu, b, x, n, n, k);
  p.piv = static_cast<int32_t*>(piv);
  p.pivot = pivot;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Route route = factor_route(n, k);
  if (route == kWarpRoute) {
    const unsigned blocks = static_cast<unsigned>((batch + kWarpMatrices - 1) / kWarpMatrices);
    void (*kernel)(Args, int64_t) = k == 0   ? getrf_warp_kernel<0>
                                    : k <= 4 ? getrf_warp_kernel<4>
                                             : getrf_warp_kernel<kWarpN>;
    kernel<<<blocks, kWarpMatrices * 32, 0, s>>>(p, batch);
    return cudaGetLastError();
  }
  const Kernel kernel = route == kPanelRoute ? (k ? getrf_panel_kernel<true> : getrf_panel_kernel<false>)
                                             : getrf_inplace_kernel;
  if (route == kInPlaceRoute && lu == nullptr) return cudaErrorInvalidValue;
  const int64_t bytes = route == kPanelRoute ? panel_bytes(n, k) : small_bytes(n, n, k);
  const cudaError_t e = smem_for(kernel, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(batch), route == kPanelRoute ? panel_np(n) : threads_for(n),
           static_cast<size_t>(bytes), s>>>(p);
  return cudaGetLastError();
}

// a: (batch, n, n) f32 contiguous; qr (batch, n, n) the R factor and the
// reflectors below the diagonal, tau (batch, n). n <= 32 takes a warp a
// matrix (csrc/dx_qr_warp.cu's geqrf_warp_kernel), n <= 224 32-column panels
// (csrc/dx_qr_panel.cu's geqrf_panel_kernel), the rest a block
// (geqrf_kernel).
int tml_geqrf_batched(const void* a, void* qr, void* tau, int64_t batch, int64_t n, void* stream) {
  if (bad_sizes(a, batch, n, n, 0, nullptr, nullptr) || qr == nullptr || tau == nullptr)
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  if (tml_qr::geqrf_warp_route(n) || tml_qr::geqrf_panel_route(n))
    return (tml_qr::geqrf_warp_route(n) ? tml_qr::launch_geqrf_warp : tml_qr::launch_geqrf_panel)(
        static_cast<const float*>(a), static_cast<float*>(qr), static_cast<float*>(tau), batch,
        static_cast<int>(n), static_cast<cudaStream_t>(stream));
  Args p = make_args(a, qr, nullptr, nullptr, n, n, 0);
  p.tau = static_cast<float*>(tau);
  return launch(geqrf_kernel<true>, geqrf_kernel<false>, p, batch, stream);
}

// qr (batch, m, n) and tau (batch, n) as geqrf leaves them, c (batch, m, k) f32
// contiguous; writes x (batch, m, k) = Q^T C (trans = 1) or Q C. m <= 64 and
// n <= 32 take a warp a matrix (csrc/dx_qr_warp.cu's unmqr_warp_kernel), the
// rest to m = 224 32-reflector panels (csrc/dx_qr_panel.cu's
// unmqr_panel_kernel), both with work unread; beyond, a block (unmqr_kernel),
// work null where full_bytes(m, n, k) <= 232448, else (batch, m, n) space for
// the reflectors (x is then worked in place).
int tml_unmqr_batched(const void* qr, const void* tau, const void* c, void* x, void* work,
                      int64_t batch, int64_t m, int64_t n, int64_t k, int trans, void* stream) {
  if (bad_sizes(qr, batch, m, n, k, c, x) || tau == nullptr) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  if (tml_qr::unmqr_warp_route(m, n) || tml_qr::unmqr_panel_route(m))
    return (tml_qr::unmqr_warp_route(m, n) ? tml_qr::launch_unmqr_warp : tml_qr::launch_unmqr_panel)(
        static_cast<const float*>(qr), static_cast<const float*>(tau), static_cast<const float*>(c),
        static_cast<float*>(x), batch, static_cast<int>(m), static_cast<int>(n),
        static_cast<int>(k), trans != 0, static_cast<cudaStream_t>(stream));
  Args p = make_args(qr, work, c, x, m, n, k);
  p.tau = const_cast<float*>(static_cast<const float*>(tau));
  p.trans = trans;
  return launch(unmqr_kernel<true>, unmqr_kernel<false>, p, batch, stream);
}

// a (batch, m, n), m >= n, and b (batch, m, k) f32 contiguous; writes the
// least-squares solution X to x: (batch, n, k) where full_bytes(m, n, k) <=
// 232448 and work is null; else x is (batch, m, k), worked in place, X its
// first n rows, and work (batch, m, n) holds the QR. m <= 64, n <= 32 and k
// <= 32 take a warp a matrix (gels_warp_kernel), the rest a block
// (gels_kernel).
int tml_gels_batched(const void* a, const void* b, void* x, void* work, int64_t batch, int64_t m,
                     int64_t n, int64_t k, void* stream) {
  if (bad_sizes(a, batch, m, n, k, b, x) || m < n) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  Args p = make_args(a, work, b, x, m, n, k);
  p.xrows = p.n;
  if (gels_warp_route(m, n, k)) {
    const unsigned blocks = static_cast<unsigned>((batch + kWarpMatrices - 1) / kWarpMatrices);
    void (*kernel)(Args, int64_t) = m <= kWarpN ? gels_warp_kernel<1> : gels_warp_kernel<2>;
    kernel<<<blocks, kWarpMatrices * 32, 0, static_cast<cudaStream_t>(stream)>>>(p, batch);
    return cudaGetLastError();
  }
  return launch(gels_kernel<true>, gels_kernel<false>, p, batch, stream);
}

}  // extern "C"
