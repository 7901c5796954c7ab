// Batched Jacobi eigensolver and SVD of small matrices, for Hopper (sm_90a):
//
//   tml_syevd_batched: cyclic two-sided Jacobi of each f32 (n, n) symmetric
//                      matrix, n <= 64, a fixed number of sweeps; w = the
//                      diagonal and V = the product of the rotations.
//   tml_gesvd_batched: one-sided (Hestenes) Jacobi of each f32 (n, n) matrix,
//                      n <= 64; U = the orthogonalised columns over their
//                      norms, s = the norms, V = the product of the rotations.
//
// Replaces the TPU kernels of tpumathlib/dx/solver.py: syevd_batched's
// pallas_call (:758, kernel _syevd_kernel :685) and gesvd_batched's (:843,
// kernel _gesvd_kernel :779). There each round is a few matmuls against 0/1
// permutation matrices, because Mosaic cannot gather lanes; here one thread
// block holds one matrix and V in shared memory and reads each pair's
// entries directly. tpumathlib_torch/dx/solver.py holds the wrappers, the
// plain PyTorch versions (_syevd_plain, _gesvd_plain) and the schedule
// (_roundrobin, passed in as an int table); the wrappers sort the results.
//
// Each sweep runs the rounds of the round-robin schedule, each round
// rotating n/2 disjoint pairs (p, q) by [[c, s], [-s, c]]:
//   syevd: (c, s) of each pair from A(p,p), A(q,q), A(p,q) as A stood
//          before the round (one thread a pair); a barrier; A's columns of
//          every pair and V's columns; a barrier; A's rows; a barrier.
//   gesvd: (c, s) from alpha = |a_p|^2, beta = |a_q|^2, gamma = a_p . a_q
//          (one warp a pair, shuffle sums); a barrier; A's and V's columns;
//          a barrier.
// With tau = (a_qq - a_pp) / (2 a_pq): t = sign(tau) / (|tau| +
// sqrt(1 + tau^2)), t = 1 at tau = 0, no turn where |a_pq| <= 1e-30; c =
// rsqrt(1 + t^2), s = t c. One (c, s) a pair: the reference takes t per lane,
// where sign(0) = 0 leaves a pair with equal diagonal entries (or column
// norms) unturned however large its coupling (ROADMAP C12); t = 1 per lane
// would not be orthogonal, since both lanes would get +s. Where tau != 0 the
// per-pair rotation is the reference's: the partner lane sees -tau and -s.
// For odd n the schedule is that of n + 1, and the pair of the spare index
// is skipped each round (the reference's sentinel row and column, never
// turned, gives the same result).
//
// What bounds them: at batch 8192 x n 32 f32, a sweep has 31 rounds of n/2
// pairs. syevd needs 12 n flop a pair (A stays symmetric, so J^T A J needs
// only one triangle of A's columns and rows, 6 n, and V's columns 6 n): 10
// sweeps are 1.9 MFLOP a matrix, 15.6 GFLOP in all, 0.23 ms at 67 TFLOP/s.
// gesvd needs 18 n (A's and V's columns and the three sums): 12 sweeps are
// 0.42 ms. Their bytes (A read, V and w or U, s, V written) take 0.03-0.04 ms
// at 3.35 TB/s. Operations bound them, and each
// round's few operations a thread sit between barriers, so the time is the
// latency of 3 (syevd) or 2 (gesvd) barriers and a handful of shared-memory
// reads a round; many blocks share an SM (8.4 KB at n = 32) to hide it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxN = 64;
constexpr int kMaxThreads = 512;

struct Args {
  const float* a;         // (batch, n, n)
  const int32_t* pairs;   // (rounds, npairs, 2) for n rounded up to even
  float* u;               // gesvd: (batch, n, n); syevd: unused
  float* d;               // syevd: w (batch, n); gesvd: s (batch, n)
  float* v;               // (batch, n, n)
  int n, rounds, npairs, sweeps;
};

int threads_for(int n) { return n <= 8 ? 64 : n <= 16 ? 128 : n <= 32 ? 256 : kMaxThreads; }

// Shared memory: A and V (n x (n + 1): column reads spread over banks), each
// pair's c, s, p, q, and n floats for gesvd's norms.
int64_t smem_bytes(int n, int npairs) {
  return (2 * static_cast<int64_t>(n) * (n + 1) + 4 * npairs + n) * 4;
}

struct Block {
  float* A;
  float* V;
  float* c;
  float* s;
  int* p;
  int* q;
  float* norm;
  int ld;
};

__device__ Block stage(const Args& a, float* smem) {
  const int n = a.n, ld = n + 1;
  Block b;
  b.A = smem;
  b.V = b.A + n * ld;
  b.c = b.V + n * ld;
  b.s = b.c + a.npairs;
  b.p = reinterpret_cast<int*>(b.s + a.npairs);
  b.q = b.p + a.npairs;
  b.norm = reinterpret_cast<float*>(b.q + a.npairs);
  b.ld = ld;
  const float* src = a.a + static_cast<int64_t>(blockIdx.x) * n * n;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int r = e / n, c = e % n;
    b.A[r * ld + c] = src[e];
    b.V[r * ld + c] = r == c ? 1.f : 0.f;
  }
  __syncthreads();
  return b;
}

// The rotation of one pair, from its two diagonal entries (or squared column
// norms) and its coupling.
__device__ __forceinline__ void rot_coeffs(float app, float aqq, float apq, float& c, float& s) {
  if (!(fabsf(apq) > 1e-30f)) {
    c = 1.f;
    s = 0.f;
    return;
  }
  const float tau = (aqq - app) / (2.f * apq);
  const float t = tau == 0.f ? 1.f : copysignf(1.f, tau) / (fabsf(tau) + sqrtf(1.f + tau * tau));
  c = rsqrtf(1.f + t * t);
  s = t * c;
}

// Pair k of round r, or p = -1 where it holds the spare index of odd n.
__device__ __forceinline__ void pair_of(const Args& a, int r, int k, int& p, int& q) {
  const int32_t* pq = a.pairs + (static_cast<int64_t>(r) * a.npairs + k) * 2;
  p = pq[0];
  q = pq[1];
  if (p >= a.n || q >= a.n) p = -1;
}

// Columns p and q of M (ld) turned for every live pair: (c a_p - s a_q,
// s a_p + c a_q), one thread a (pair, row).
__device__ __forceinline__ void turn_columns(const Block& b, float* M, int n, int npairs) {
  for (int e = threadIdx.x; e < npairs * n; e += blockDim.x) {
    const int k = e / n, i = e % n, p = b.p[k];
    if (p < 0) continue;
    const int q = b.q[k];
    const float c = b.c[k], s = b.s[k];
    const float x = M[i * b.ld + p], y = M[i * b.ld + q];
    M[i * b.ld + p] = c * x - s * y;
    M[i * b.ld + q] = s * x + c * y;
  }
}

__global__ void __launch_bounds__(kMaxThreads) syevd_kernel(const Args a) {
  extern __shared__ float smem[];
  const Block b = stage(a, smem);
  const int n = a.n, ld = b.ld;
  for (int sweep = 0; sweep < a.sweeps; ++sweep)
    for (int r = 0; r < a.rounds; ++r) {
      for (int k = threadIdx.x; k < a.npairs; k += blockDim.x) {
        int p, q;
        pair_of(a, r, k, p, q);
        float c = 1.f, s = 0.f;
        if (p >= 0) rot_coeffs(b.A[p * ld + p], b.A[q * ld + q], b.A[p * ld + q], c, s);
        b.p[k] = p;
        b.q[k] = q;
        b.c[k] = c;
        b.s[k] = s;
      }
      __syncthreads();
      turn_columns(b, b.A, n, a.npairs);
      turn_columns(b, b.V, n, a.npairs);
      __syncthreads();
      // rows p and q of A: (c a_p - s a_q, s a_p + c a_q)
      for (int e = threadIdx.x; e < a.npairs * n; e += blockDim.x) {
        const int k = e / n, i = e % n, p = b.p[k];
        if (p < 0) continue;
        const int q = b.q[k];
        const float c = b.c[k], s = b.s[k];
        const float x = b.A[p * ld + i], y = b.A[q * ld + i];
        b.A[p * ld + i] = c * x - s * y;
        b.A[q * ld + i] = s * x + c * y;
      }
      __syncthreads();
    }
  const int64_t bi = blockIdx.x;
  for (int i = threadIdx.x; i < n; i += blockDim.x) a.d[bi * n + i] = b.A[i * ld + i];
  for (int e = threadIdx.x; e < n * n; e += blockDim.x)
    a.v[bi * n * n + e] = b.V[(e / n) * ld + e % n];
}

__global__ void __launch_bounds__(kMaxThreads) gesvd_kernel(const Args a) {
  extern __shared__ float smem[];
  const Block b = stage(a, smem);
  const int n = a.n, ld = b.ld;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int sweep = 0; sweep < a.sweeps; ++sweep)
    for (int r = 0; r < a.rounds; ++r) {
      for (int k = warp; k < a.npairs; k += warps) {
        int p, q;
        pair_of(a, r, k, p, q);
        float al = 0.f, be = 0.f, ga = 0.f;
        if (p >= 0)
          for (int i = lane; i < n; i += 32) {
            const float x = b.A[i * ld + p], y = b.A[i * ld + q];
            al += x * x;
            be += y * y;
            ga += x * y;
          }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          al += __shfl_xor_sync(0xffffffffu, al, off);
          be += __shfl_xor_sync(0xffffffffu, be, off);
          ga += __shfl_xor_sync(0xffffffffu, ga, off);
        }
        if (lane == 0) {
          float c = 1.f, s = 0.f;
          if (p >= 0) rot_coeffs(al, be, ga, c, s);
          b.p[k] = p;
          b.q[k] = q;
          b.c[k] = c;
          b.s[k] = s;
        }
      }
      __syncthreads();
      turn_columns(b, b.A, n, a.npairs);
      turn_columns(b, b.V, n, a.npairs);
      __syncthreads();
    }
  // sigma_j = |a_j|, one warp a column; U = A / sigma (sigma = 0: / 1)
  for (int j = warp; j < n; j += warps) {
    float ss = 0.f;
    for (int i = lane; i < n; i += 32) ss += b.A[i * ld + j] * b.A[i * ld + j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (lane == 0) b.norm[j] = sqrtf(ss);
  }
  __syncthreads();
  const int64_t bi = blockIdx.x;
  for (int j = threadIdx.x; j < n; j += blockDim.x) a.d[bi * n + j] = b.norm[j];
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e % n;
    const float sig = b.norm[j];
    a.u[bi * n * n + e] = b.A[i * ld + j] / (sig > 0.f ? sig : 1.f);
    a.v[bi * n * n + e] = b.V[i * ld + j];
  }
}

cudaError_t launch(void (*kernel)(Args), const void* a, const void* pairs, void* u, void* d,
                   void* v, int64_t batch, int64_t n, int64_t sweeps, void* stream) {
  if (a == nullptr || pairs == nullptr || d == nullptr || v == nullptr || batch < 0 ||
      batch > 0x7fffffff || n < 1 || n > kMaxN || sweeps < 0 || sweeps > 0x7fffffff)
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  Args p{};
  p.a = static_cast<const float*>(a);
  p.pairs = static_cast<const int32_t*>(pairs);
  p.u = static_cast<float*>(u);
  p.d = static_cast<float*>(d);
  p.v = static_cast<float*>(v);
  p.n = static_cast<int>(n);
  const int npad = p.n + p.n % 2;
  p.rounds = npad - 1;
  p.npairs = npad / 2;
  p.sweeps = static_cast<int>(sweeps);
  kernel<<<static_cast<unsigned>(batch), threads_for(p.n),
           static_cast<size_t>(smem_bytes(p.n, p.npairs)), static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a: (batch, n, n) f32 contiguous, symmetric, n <= 64; pairs: int32
// (npad - 1, npad / 2, 2), npad = n + n % 2, the round-robin schedule. Writes
// the unsorted eigenvalues w (batch, n) and eigenvectors v (batch, n, n) after
// `sweeps` sweeps. Launches on `stream`; returns the CUDA status (0 on
// success).
int tml_syevd_batched(const void* a, const void* pairs, void* w, void* v, int64_t batch, int64_t n,
                      int64_t sweeps, void* stream) {
  return launch(syevd_kernel, a, pairs, nullptr, w, v, batch, n, sweeps, stream);
}

// As tml_syevd_batched, for the SVD of a (batch, n, n): u (batch, n, n), the
// unsorted singular values s (batch, n) and v (batch, n, n), A = U diag(s) V^T.
int tml_gesvd_batched(const void* a, const void* pairs, void* u, void* s, void* v, int64_t batch,
                      int64_t n, int64_t sweeps, void* stream) {
  if (u == nullptr) return cudaErrorInvalidValue;
  return launch(gesvd_kernel, a, pairs, u, s, v, batch, n, sweeps, stream);
}

}  // extern "C"
