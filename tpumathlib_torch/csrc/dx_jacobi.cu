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
// permutation matrices, because Mosaic cannot gather lanes; here a warp (n <=
// 32) or two (n <= 64) hold one matrix and V, a row a lane, and turn each
// pair's columns in registers. tpumathlib_torch/dx/solver.py holds the
// wrappers, the plain PyTorch versions (_syevd_plain, _gesvd_plain) and the
// schedule (_roundrobin, passed in as an int table, which both routes
// compute in the kernel instead); the wrappers sort the results.
//
// Each sweep runs the rounds of the round-robin schedule, each round
// rotating n/2 disjoint pairs (p, q) by [[c, s], [-s, c]]:
//   syevd: (c, s) of each pair from A(p,p), A(q,q), A(p,q) as A stood
//          before the round; then A's columns of every pair and V's
//          columns; then A's rows.
//   gesvd: (c, s) from alpha = |a_p|^2, beta = |a_q|^2, gamma = a_p . a_q;
//          then A's and V's columns.
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
// Two routes by n (jacobi_route; dx/solver.py::_jacobi_route mirrors it):
// - n <= 32: a warp a matrix (syevd_warp_kernel, gesvd_warp_kernel, below),
//   4 matrices a block. Lane i holds row i of A and of V in registers, the
//   columns in the order of the circle method's slots (Circle, in
//   dx_jacobi.cuh), so that every pair's columns are registers fixed at
//   compile time; between rounds the rotating slots move down by one
//   register. No block barrier and no table load in the loop: each round's
//   (c, s) go through a per-warp buffer in shared memory behind one
//   __syncwarp.
// - 33 <= n <= 64: two warps a matrix (syevd_block_kernel,
//   gesvd_block_kernel, csrc/dx_jacobi_block.cu), thread i holding row i of
//   A and of V in registers in the same slots, one block barrier a round:
//   gesvd's two warps add their halves of the column sums through shared
//   memory, syevd's threads exchange their rows of A·J through a tile.
//
// What bounds them: at batch 8192 x n 32 f32, a sweep has 31 rounds of n/2
// pairs. syevd needs 12 n flop a pair (A stays symmetric, so J^T A J needs
// only one triangle of A's columns and rows, 6 n, and V's columns 6 n): 10
// sweeps are 1.9 MFLOP a matrix, 15.6 GFLOP in all, 0.23 ms at 67 TFLOP/s.
// gesvd needs 18 n (A's and V's columns and the three sums): 12 sweeps are
// 0.42 ms. Their bytes (A read, V and w or U, s, V written) take 0.03-0.04 ms
// at 3.35 TB/s. Operations bound them, and on the warp route the instructions
// each lane runs for its share of them: a round at n = 32 is 128 multiplies and FMAs of
// A's and V's columns, then syevd's 64 of A's rows behind 32 shuffles and two
// 31-select trees (a lane's own diagonal entry and coupling sit in a slot
// known only at run time), or gesvd's 48 products and their sums (48
// shuffles, each step halving the pairs a lane holds, with the selects that
// pick what it keeps); then 62 register moves of the rotation, which syevd
// pays once in two rounds (its loop is unrolled by 2). Measured through the
// public calls on an H100 at 700 W (chip_smoke.py, time_paths.py) at 8192 x
// 32: syevd 1.84 ms and gesvd 2.52, where a block a matrix with A and V in
// shared memory took 11.2 and 17.0 (its 3 or 2 barriers a round) and
// torch.linalg's eigh and svd take 4.7 and 8.4.

#include "dx_jacobi.cuh"

namespace tml_jacobi {
namespace {

constexpr int kWarpMatrices = 4;    // matrices (warps) a block on the warp route
constexpr int kWarpBlocks = 4;      // blocks an SM the warp route asks for: 128 registers a lane

struct Args {
  const float* a;         // (batch, n, n)
  float* u;               // gesvd: (batch, n, n); syevd: unused
  float* d;               // syevd: w (batch, n); gesvd: s (batch, n)
  float* v;               // (batch, n, n)
  int n, sweeps;
};

// ----------------------------- the warp route -----------------------------

// x[i] for a runtime i < N by a tree of selects on i's bits: a register
// array indexed by a runtime value would go to local memory.
template <int N>
__device__ __forceinline__ float pick(const float (&x)[N], int i) {
  float t[N];
#pragma unroll
  for (int j = 0; j < N; ++j) t[j] = x[j];
#pragma unroll
  for (int level = 0; level < ceil_log2(N); ++level) {
    const int bit = 1 << level;
    const bool up = i & bit;
#pragma unroll
    for (int j = 0; j + bit < N; j += 2 * bit) t[j] = up ? t[j + bit] : t[j];
  }
  return t[0];
}

// Per warp: a 32 x 33 tile that carries a matrix between device memory and
// the lanes' rows, coalesced both ways, and two buffers of a round's (c, s),
// pair k's at cs[b][k / 2] (.x, .y for even k, .z, .w for odd).
struct WarpSmem {
  float tile[kWarpN][kWarpN + 1];
  float4 cs[2][kWarpN / 4];
};

// Lane i's row i of the (n, n) matrix at src, in slot order (the natural
// order at round 0), zeros past n.
template <int NPAD>
__device__ __forceinline__ void load_rows(float (&x)[NPAD], float (*t)[kWarpN + 1],
                                          const float* src, int n, int lane) {
#pragma unroll
  for (int r = 0; r < NPAD; ++r) t[r][lane] = r < n && lane < n ? __ldg(src + r * n + lane) : 0.f;
  __syncwarp();
#pragma unroll
  for (int c = 0; c < NPAD; ++c) x[c] = lane < NPAD ? t[lane][c] : 0.f;
}

// The first n entries of lanes 0 .. n - 1's rows to the (n, n) matrix at dst.
template <int NPAD>
__device__ __forceinline__ void store_rows(const float (&x)[NPAD], float (*t)[kWarpN + 1],
                                           float* dst, int n, int lane) {
  __syncwarp();
  if (lane < NPAD) {
#pragma unroll
    for (int c = 0; c < NPAD; ++c) t[lane][c] = x[c];
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < NPAD; ++r)
    if (r < n && lane < n) dst[r * n + lane] = t[r][lane];
}

// Two-sided Jacobi, a warp a matrix. Each round, every lane finds its
// slot, its partner's index and its role; the pair's diagonal entries and
// coupling A(p, q) come from the two lanes (a select tree for the lane's
// own entries, one shuffle for each of the partner's), and both lanes
// compute the same (c, s), which lane p puts in the round's buffer. Then
// A's and V's columns turn in every lane's registers, and A's rows turn
// with the partner's row, one shuffle an entry: lane p takes c a_p - s a_q,
// lane q c a_q + s a_p. A lane past n, or paired with the spare index, turns
// no row.
template <int NPAD>
__global__ void __launch_bounds__(kWarpMatrices * 32, kWarpBlocks)
    syevd_warp_kernel(const Args p, int64_t batch) {
  using C = Circle<NPAD>;
  __shared__ WarpSmem smem[kWarpMatrices];
  WarpSmem& ws = smem[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int64_t bi = int64_t(blockIdx.x) * kWarpMatrices + (threadIdx.x >> 5);
  if (bi >= batch) return;
  const int n = p.n;
  float a[NPAD], v[NPAD];
  load_rows<NPAD>(a, ws.tile, p.a + bi * n * n, n, lane);
#pragma unroll
  for (int c = 0; c < NPAD; ++c) v[c] = c == lane && lane < n ? 1.f : 0.f;
  const bool odd = n < NPAD, paired = lane < NPAD;
  int r = 0, buf = 0;   // r: the round in the sweep
  // Unrolled by 2 so that the rotation's moves are made once in two rounds;
  // a sweep's count of rounds need not be even.
#pragma unroll 2
  for (int64_t round = 0; round < int64_t(p.sweeps) * C::kM; ++round) {
    const int slot = paired ? C::slot_of(lane, r) : 0;
    const int pslot = C::partner_slot(slot);
    const int partner = paired ? C::index_at(pslot, r) : lane;
    const bool live = lane < n && partner < n, own_p = C::holds_p(slot);
    const float diag = pick(a, slot), cpl = pick(a, pslot);   // A(i, i), A(i, partner)
    const float diag2 = __shfl_sync(kFull, diag, partner);
    const float cpl2 = __shfl_sync(kFull, cpl, partner);
    float c, s;
    rot_coeffs(own_p ? diag : diag2, own_p ? diag2 : diag, own_p ? cpl : cpl2, c, s);
    if (live && own_p)
      reinterpret_cast<float2*>(ws.cs[buf])[C::pair_of(slot)] = make_float2(c, s);
    __syncwarp();
    turn_columns<NPAD>(a, v, ws.cs[buf], C::dead(odd, r));
    const float sr = own_p ? -s : s;
#pragma unroll
    for (int j = 0; j < NPAD; ++j) {
      const float y = __shfl_sync(kFull, a[j], partner);
      if (live) a[j] = c * a[j] + sr * y;
    }
    rotate<NPAD>(a);
    rotate<NPAD>(v);
    buf ^= 1;
    r = r + 1 == C::kM ? 0 : r + 1;
  }
  if (lane < n) p.d[bi * n + lane] = pick(a, lane);
  store_rows<NPAD>(v, ws.tile, p.v + bi * n * n, n, lane);
}

// Pair k's products in this lane's row (zeros for k past the pairs).
template <int NPAD>
__device__ __forceinline__ void products(const float (&a)[NPAD], int k, float& al, float& be,
                                         float& ga) {
  using C = Circle<NPAD>;
  const int kk = k < C::kPairs ? k : 0;
  const float x = k < C::kPairs ? a[C::p_slot(kk)] : 0.f;
  const float y = k < C::kPairs ? a[C::q_slot(kk)] : 0.f;
  al = x * x;
  be = y * y;
  ga = x * y;
}

// The sums over the warp's lanes of alpha, beta and gamma of every pair,
// formed in each lane from its row: the first halving step (mask 16) as the
// products are formed, so that only half of them are ever live; then
// halve_pairs, then butterflies on the one pair left. Lane l ends with pair
// l >> (5 - log2 H)'s sums (H: the pairs rounded up to a power of two), the
// same in every lane that holds it; al, be, ga get them.
template <int NPAD, int H>
__device__ __forceinline__ void pair_sums(const float (&a)[NPAD], int lane, float& al, float& be,
                                          float& ga) {
  constexpr int kKept = H > 1 ? H / 2 : 1, kMask = H > 1 ? 8 : 16;
  float sa[kKept], sb[kKept], sg[kKept];
  if constexpr (H > 1) {
    const bool up = lane & 16;
#pragma unroll
    for (int i = 0; i < kKept; ++i) {
      float ha, hb, hg;
      products<NPAD>(a, i, sa[i], sb[i], sg[i]);
      products<NPAD>(a, i + kKept, ha, hb, hg);
      halve(sa[i], ha, up, 16);
      halve(sb[i], hb, up, 16);
      halve(sg[i], hg, up, 16);
    }
  } else {
    products<NPAD>(a, 0, sa[0], sb[0], sg[0]);
  }
  halve_pairs<kKept / 2, kKept, kMask>(sa, sb, sg, lane);
#pragma unroll
  for (int mask = kMask / kKept; mask > 0; mask >>= 1) {
    sa[0] += __shfl_xor_sync(kFull, sa[0], mask);
    sb[0] += __shfl_xor_sync(kFull, sb[0], mask);
    sg[0] += __shfl_xor_sync(kFull, sg[0], mask);
  }
  al = sa[0];
  be = sb[0];
  ga = sg[0];
}

// One-sided Jacobi, a warp a matrix. Each round, pair_sums sums the three
// products of every pair's columns over the rows together, the first lane
// holding a pair's sums puts its (c, s) in the round's buffer, and A's and
// V's columns turn in every lane's registers.
// Then sigma_j = |a_j| by butterflies and U = A / sigma (sigma = 0: / 1).
template <int NPAD>
__global__ void __launch_bounds__(kWarpMatrices * 32, kWarpBlocks)
    gesvd_warp_kernel(const Args p, int64_t batch) {
  using C = Circle<NPAD>;
  constexpr int kLevels = ceil_log2(C::kPairs), kHeld = 1 << kLevels;
  __shared__ WarpSmem smem[kWarpMatrices];
  WarpSmem& ws = smem[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int64_t bi = int64_t(blockIdx.x) * kWarpMatrices + (threadIdx.x >> 5);
  if (bi >= batch) return;
  const int n = p.n;
  float a[NPAD], v[NPAD];
  load_rows<NPAD>(a, ws.tile, p.a + bi * n * n, n, lane);
#pragma unroll
  for (int c = 0; c < NPAD; ++c) v[c] = c == lane && lane < n ? 1.f : 0.f;
  const bool odd = n < NPAD;
  const int held = lane >> (5 - kLevels);
  const bool writer = (lane & ((32 >> kLevels) - 1)) == 0 && held < C::kPairs;
  int r = 0, buf = 0;   // r: the round in the sweep
  // Not unrolled: by 2, ptxas spills at n = 32 under the 128 registers of 4
  // blocks an SM, and 3 blocks an SM (168 registers) ran slower than this.
#pragma unroll 1
  for (int64_t round = 0; round < int64_t(p.sweeps) * C::kM; ++round) {
    float al, be, ga, c, s;
    pair_sums<NPAD, kHeld>(a, lane, al, be, ga);
    rot_coeffs(al, be, ga, c, s);
    if (writer) reinterpret_cast<float2*>(ws.cs[buf])[held] = make_float2(c, s);
    __syncwarp();
    turn_columns<NPAD>(a, v, ws.cs[buf], C::dead(odd, r));
    rotate<NPAD>(a);
    rotate<NPAD>(v);
    buf ^= 1;
    r = r + 1 == C::kM ? 0 : r + 1;
  }
  float own = 0.f;   // sigma_lane
#pragma unroll
  for (int j = 0; j < NPAD; ++j) {
    float ss = a[j] * a[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(kFull, ss, off);
    const float sig = sqrtf(ss);
    a[j] = a[j] / (sig > 0.f ? sig : 1.f);
    if (lane == j) own = sig;
  }
  if (lane < n) p.d[bi * n + lane] = own;
  store_rows<NPAD>(a, ws.tile, p.u + bi * n * n, n, lane);
  store_rows<NPAD>(v, ws.tile, p.v + bi * n * n, n, lane);
}

template <int NPAD>
cudaError_t launch_warp(bool svd, const Args& p, int64_t batch, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((batch + kWarpMatrices - 1) / kWarpMatrices);
  if (svd)
    gesvd_warp_kernel<NPAD><<<blocks, kWarpMatrices * 32, 0, stream>>>(p, batch);
  else
    syevd_warp_kernel<NPAD><<<blocks, kWarpMatrices * 32, 0, stream>>>(p, batch);
  return cudaGetLastError();
}

// One instantiation for each even NPAD up to 32.
template <int NPAD = 2>
cudaError_t launch_warp_route(bool svd, const Args& p, int64_t batch, cudaStream_t stream) {
  if (p.n + p.n % 2 == NPAD) return launch_warp<NPAD>(svd, p, batch, stream);
  if constexpr (NPAD < kWarpN) return launch_warp_route<NPAD + 2>(svd, p, batch, stream);
  return cudaErrorInvalidValue;
}

// ----------------------------- both routes -----------------------------

enum JacobiRoute { kWarpRoute, kBlockRoute };

JacobiRoute jacobi_route(int64_t n) { return n <= kWarpN ? kWarpRoute : kBlockRoute; }

cudaError_t launch(bool svd, const void* a, const void* pairs, void* u, void* d, void* v,
                   int64_t batch, int64_t n, int64_t sweeps, void* stream) {
  if (a == nullptr || pairs == nullptr || d == nullptr || v == nullptr || batch < 0 ||
      batch > 0x7fffffff || n < 1 || n > kMaxN || sweeps < 0 || sweeps > 0x7fffffff)
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  Args p{};
  p.a = static_cast<const float*>(a);
  p.u = static_cast<float*>(u);
  p.d = static_cast<float*>(d);
  p.v = static_cast<float*>(v);
  p.n = static_cast<int>(n);
  p.sweeps = static_cast<int>(sweeps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (jacobi_route(n) == kWarpRoute) return launch_warp_route(svd, p, batch, s);
  return launch_block_route(svd, p.a, p.u, p.d, p.v, batch, p.n, p.sweeps, s);
}

}  // namespace
}  // namespace tml_jacobi

extern "C" {

// a: (batch, n, n) f32 contiguous, symmetric, n <= 64; pairs: int32
// (npad - 1, npad / 2, 2), npad = n + n % 2, the round-robin schedule (both
// routes compute the same pairs in the kernel; the table is not read). Writes
// the unsorted eigenvalues w (batch, n) and eigenvectors v (batch, n, n) after
// `sweeps` sweeps. Launches on `stream`; returns the CUDA status (0 on
// success).
int tml_syevd_batched(const void* a, const void* pairs, void* w, void* v, int64_t batch, int64_t n,
                      int64_t sweeps, void* stream) {
  return tml_jacobi::launch(false, a, pairs, nullptr, w, v, batch, n, sweeps, stream);
}

// As tml_syevd_batched, for the SVD of a (batch, n, n): u (batch, n, n), the
// unsorted singular values s (batch, n) and v (batch, n, n), A = U diag(s) V^T.
int tml_gesvd_batched(const void* a, const void* pairs, void* u, void* s, void* v, int64_t batch,
                      int64_t n, int64_t sweeps, void* stream) {
  if (u == nullptr) return cudaErrorInvalidValue;
  return tml_jacobi::launch(true, a, pairs, u, s, v, batch, n, sweeps, stream);
}

}  // extern "C"
