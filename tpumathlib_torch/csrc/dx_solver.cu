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
// for potrf, twice that for getrf): device memory bounds them. Design: a
// block copies its matrix (and right-hand side) into shared memory once,
// runs the n dependent steps there, each a read of column j, a reduction
// where the step needs one and a masked rank-1 update, separated by
// __syncthreads, and writes its result once. With 8192 blocks of 128 threads
// and 4.6 KB of shared memory at n = 32, many blocks share an SM and hide
// each other's barriers. A matrix larger than a block's 227 KB (about
// n >= 240 without a right-hand side) is factored by a second instantiation
// of the same kernels in place in the output, in device memory, so no n is
// refused for its size. Warp per matrix with rows in registers, or several
// matrices a block, are later work. unmqr and gels take the same layout with
// m rows: at batch 8192 x m 64 x n 32, k 4, gels reads A and B and writes X,
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
#include <cstdint>

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

// One barrier a step: step j reads column j and the pivot, and updates the
// trailing lower triangle; column j itself is scaled in step j + 1, when
// nobody reads it (each thread keeps the previous step's 1/sqrt).
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

template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads) potrf_kernel(const Args p) {
  extern __shared__ float smem[];
  const Block s = stage<kShared>(p, smem);
  potrf_steps(s.A, p.n);
  if (p.k) posv_solves(s.A, s.X, p.n, p.k);
  unstage<kShared>(p, s, true);
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

template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads) getrf_kernel(const Args p) {
  extern __shared__ float smem[];
  const Block s = stage<kShared>(p, smem);
  int32_t* piv = p.piv ? p.piv + static_cast<int64_t>(blockIdx.x) * p.n : nullptr;
  getrf_steps(s.A, p.n, p.pivot != 0, s.piv, piv);
  if (p.k) gesv_solves(s.A, s.piv, s.X, p.n, p.k);
  unstage<kShared>(p, s, false);
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

// ----------------------------- launch -----------------------------

using Kernel = void (*)(Args);

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
  return launch(potrf_kernel<true>, potrf_kernel<false>, make_args(a, l, b, x, n, n, k), batch,
                stream);
}

// As tml_potrf_batched, for LU: lu (batch, n, n) in the packed L\U layout and
// piv (batch, n) int32, the row swapped with j at step j (j itself when
// pivot = 0). With a right-hand side (gesv; pivot must be 1) piv may be null.
int tml_getrf_batched(const void* a, void* lu, void* piv, const void* b, void* x, int64_t batch,
                      int64_t n, int64_t k, int pivot, void* stream) {
  if (bad_sizes(a, batch, n, n, k, b, x) || (k == 0 && (lu == nullptr || piv == nullptr)) ||
      (k > 0 && pivot == 0))
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  Args p = make_args(a, lu, b, x, n, n, k);
  p.piv = static_cast<int32_t*>(piv);
  p.pivot = pivot;
  return launch(getrf_kernel<true>, getrf_kernel<false>, p, batch, stream);
}

// a: (batch, n, n) f32 contiguous; qr (batch, n, n) the R factor and the
// reflectors below the diagonal, tau (batch, n).
int tml_geqrf_batched(const void* a, void* qr, void* tau, int64_t batch, int64_t n, void* stream) {
  if (bad_sizes(a, batch, n, n, 0, nullptr, nullptr) || qr == nullptr || tau == nullptr)
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  Args p = make_args(a, qr, nullptr, nullptr, n, n, 0);
  p.tau = static_cast<float*>(tau);
  return launch(geqrf_kernel<true>, geqrf_kernel<false>, p, batch, stream);
}

// qr (batch, m, n) and tau (batch, n) as geqrf leaves them, c (batch, m, k) f32
// contiguous; writes x (batch, m, k) = Q^T C (trans = 1) or Q C. work is null
// where full_bytes(m, n, k) <= 232448, else (batch, m, n) space for the
// reflectors (x is then worked in place).
int tml_unmqr_batched(const void* qr, const void* tau, const void* c, void* x, void* work,
                      int64_t batch, int64_t m, int64_t n, int64_t k, int trans, void* stream) {
  if (bad_sizes(qr, batch, m, n, k, c, x) || tau == nullptr) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  Args p = make_args(qr, work, c, x, m, n, k);
  p.tau = const_cast<float*>(static_cast<const float*>(tau));
  p.trans = trans;
  return launch(unmqr_kernel<true>, unmqr_kernel<false>, p, batch, stream);
}

// a (batch, m, n), m >= n, and b (batch, m, k) f32 contiguous; writes the
// least-squares solution X to x: (batch, n, k) where full_bytes(m, n, k) <=
// 232448 and work is null; else x is (batch, m, k), worked in place, X its
// first n rows, and work (batch, m, n) holds the QR.
int tml_gels_batched(const void* a, const void* b, void* x, void* work, int64_t batch, int64_t m,
                     int64_t n, int64_t k, void* stream) {
  if (bad_sizes(a, batch, m, n, k, b, x) || m < n) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  Args p = make_args(a, work, b, x, m, n, k);
  p.xrows = p.n;
  return launch(gels_kernel<true>, gels_kernel<false>, p, batch, stream);
}

}  // extern "C"
