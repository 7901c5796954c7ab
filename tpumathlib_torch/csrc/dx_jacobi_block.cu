// The block route of the batched Jacobi eigensolver and SVD for 33 <= n <= 64
// (tml_syevd_batched and tml_gesvd_batched, whose entry points and warp route
// are in csrc/dx_jacobi.cu), for Hopper (sm_90a).
//
// With the warp route it replaces the TPU kernels of tpumathlib/dx/solver.py:
// syevd_batched's pallas_call (:758) and gesvd_batched's (:843), up to the
// reference's largest n, 64. The function is that of dx/solver.py's
// _syevd_plain and _gesvd_plain: _live_pairs(n)'s rounds in its order with
// its p/q roles, each pair's (c, s) by rot_coeffs (csrc/dx_jacobi.cuh), the
// spare index of odd n skipped, never turned.
//
// Layout: two warps a matrix, a block of 64 threads a matrix. Thread i holds
// row i of A and of V in registers (zeros past n), the columns in the circle
// method's slots (Circle<NPAD>, NPAD = n rounded up to even, 34 to 64), so
// that every pair's columns are registers fixed at compile time and the
// columns turn with no exchange; between rounds the slots move down by one
// register. A round has one block barrier:
// - gesvd: each warp sums its 32 rows' products of every pair (warp_sums:
//   lane k ends with pair k's three sums) into a double-buffered slot.
//   After the barrier lane k of each warp adds warp 0's sums and warp 1's,
//   in that order, so both warps form the same (c, s), and passes them on
//   through its warp's buffer behind __syncwarp. Then A's and V's columns
//   turn.
// - syevd: A's and V's columns turn with the round's (c, s), and each thread
//   puts its row of A·J in a double-buffered tile (17 float4 a row, so a
//   quarter warp's rows fall on distinct banks). After the barrier it reads
//   its partner's row there (the partner may sit in the other warp) and
//   forms its row of J^T·A·J. Then lane k of each warp forms the next
//   round's (c, s) of pair k from the same tile and this round's (c, s):
//   A(p, p), A(q, q) and A(p, q) (from row p, as the plain version takes
//   it) by the row turn's own expression, bit for bit what the rows hold,
//   so no select tree picks them out of the registers.
// The double buffers make one barrier a round enough: a thread that writes a
// buffer again two rounds later has passed the barrier between, which every
// thread reaches only after its reads of that buffer. Each kernel has one
// instantiation for odd n and one for even n at each NPAD: for even n no
// pair is dead, so the column turns and syevd's row turn take no branch, and
// every slot is turned each round, so the compiler writes each turned value
// straight into the register its slot moves to (the rotation's moves cost
// nothing). A runtime test of the spare pair split the turns into a branch a
// pair, each with its own register copies (jacobi_variants.py's "skip").
//
// What bounds them: at batch 2048 x n 64, a sweep has 63 rounds of 32 pairs.
// syevd needs 12 n flop a pair turned (one triangle of A's columns and rows,
// and V's columns): 10 sweeps take 0.47 ms at 67 TFLOP/s; gesvd 18 n (A's and
// V's columns and the three sums), 12 sweeps 0.85 ms. Their bytes take 0.03-
// 0.05 ms at 3.35 TB/s. Operations bound them, and the instructions each
// thread issues for its row's share. By the source a syevd round is 256
// multiplies and FMAs of A's and V's columns, 128 of A's row, 16 float4
// stores and 32 float4 loads of the tile and the (c, s), and some 60 for the
// next (c, s) and the slots; a gesvd round 256 for the columns, then its
// sums' first step (64 selects of the columns, 48 products sent by 48
// shuffles, 48 FMAs) and 45 more shuffles, each with two selects and a sum. At
// 64 threads a matrix the launch bounds give each thread up to 255
// registers, 4 blocks (8 warps) an SM: 2048 matrices are 15.5 an SM, four
// waves, the last 88 % full. Five blocks an SM put three warps on some of
// the SM's four schedulers, whose registers allow 168 a thread, and both
// kernels spill there.

#include "dx_jacobi.cuh"

namespace tml_jacobi {
namespace {

constexpr int kThreads = 64;    // two warps a matrix, a row a thread
constexpr int kLd = 68;         // a tile row: 17 float4
constexpr int kBlocksPerSm = 4; // what the launch bounds ask for: up to 255 registers a thread

struct Matrices {
  const float* a;   // (batch, n, n)
  float* u;         // gesvd: (batch, n, n); syevd: unused
  float* d;         // syevd: w (batch, n); gesvd: s (batch, n)
  float* v;         // (batch, n, n)
  int n, sweeps;
};

// The (n, n) matrix at src into the first n rows and columns of t, and
// back, coalesced.
__device__ __forceinline__ void load_tile(float (*t)[kLd], const float* src, int n) {
  for (int e = threadIdx.x; e < n * n; e += kThreads) t[e / n][e % n] = __ldg(src + e);
}

__device__ __forceinline__ void store_tile(const float (*t)[kLd], float* dst, int n) {
  for (int e = threadIdx.x; e < n * n; e += kThreads) dst[e] = t[e / n][e % n];
}

// Entries c .. c + 3 of a tile row (c + 2, c + 3 left as they are past NPAD).
template <int NPAD>
__device__ __forceinline__ void get4(float (&y)[4], const float* row, int c) {
  if (c + 4 <= NPAD) {
    const float4 q = *reinterpret_cast<const float4*>(row + c);
    y[0] = q.x, y[1] = q.y, y[2] = q.z, y[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(row + c);
    y[0] = q.x, y[1] = q.y;
  }
}

template <int NPAD>
__device__ __forceinline__ void put_row(float* row, const float (&x)[NPAD]) {
#pragma unroll
  for (int c = 0; c < NPAD; c += 4) {
    if (c + 4 <= NPAD)
      *reinterpret_cast<float4*>(row + c) = make_float4(x[c], x[c + 1], x[c + 2], x[c + 3]);
    else
      *reinterpret_cast<float2*>(row + c) = make_float2(x[c], x[c + 1]);
  }
}

// Row i of the natural-order matrix in a tile, zeros past n.
template <int NPAD>
__device__ __forceinline__ void take_row(float (&x)[NPAD], const float* row, int i, int n) {
#pragma unroll
  for (int c = 0; c < NPAD; c += 4) {
    float y[4];
    get4<NPAD>(y, row, c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < NPAD) x[c + j] = i < n && c + j < n ? y[j] : 0.f;
  }
}

// Lane `lane`'s (c, s) of a round into a buffer: pair k's at [k / 2].
__device__ __forceinline__ void put_cs(float4* cs, int k, float c, float s) {
  reinterpret_cast<float2*>(cs)[k] = make_float2(c, s);
}

// Row p of J^T·B takes c b_p - s b_q, row q c b_q + s b_p: c x + sr y, sr =
// -s for p and s for q, with one rounding of c x, as the (c, s) that read it
// back from the tile see it too.
__device__ __forceinline__ float row_turned(float x, float y, float c, float sr) {
  return __fmaf_rn(sr, y, __fmul_rn(c, x));
}

struct SyevdSmem {
  float tile[2][kThreads][kLd];   // a round's rows of A·J in its slots; tile[1] holds A first
  float4 cs[2][2][kMaxN / 4];     // [warp][buffer]: a round's (c, s)
};

// Entry (x, col) of J^T·B, B = A·J in t by rows in the round's slots: col
// at slot scol; y: the row x is turned with by (c, sr), if `turned`.
__device__ __forceinline__ float turned_entry(const float (*t)[kLd], int x, int y, int scol,
                                              bool turned, float c, float sr) {
  const float tx = t[x][scol], ty = t[y][scol];
  return turned ? row_turned(tx, ty, c, sr) : tx;
}

// Two-sided Jacobi, two warps a matrix (see the top of the file); ODD: n is
// NPAD - 1, and the spare index's pair is skipped each round.
template <int NPAD, bool ODD>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) syevd_block_kernel(const Matrices m) {
  using C = Circle<NPAD>;
  __shared__ SyevdSmem sm;
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5, n = m.n;
  const int64_t bi = blockIdx.x, off = bi * n * n;
  load_tile(sm.tile[1], m.a + off, n);
  __syncthreads();
  float a[NPAD], v[NPAD];
  take_row<NPAD>(a, sm.tile[1][i], i, n);
#pragma unroll
  for (int c = 0; c < NPAD; ++c) v[c] = c == i && i < n ? 1.f : 0.f;
  if (lane < C::kPairs) {   // round 0's (c, s) from A: its slots are the natural order
    const int p = C::p_slot(lane), q = C::q_slot(lane);
    float c = 1.f, s = 0.f;
    if (p < n && q < n) rot_coeffs(sm.tile[1][p][p], sm.tile[1][q][q], sm.tile[1][p][q], c, s);
    put_cs(sm.cs[warp][0], lane, c, s);
  }
  __syncwarp();
  // Lane k forms pair k's (c, s) of the next round. Its p and q sit in this
  // round's slots sp and sq, whatever the round, with their partners in
  // psp and psq, in pairs kp and kq, as p where hp and hq.
  const int k = lane < C::kPairs ? lane : 0;
  const int sp = C::earlier(C::p_slot(k)), sq = C::earlier(C::q_slot(k));
  const int psp = C::partner_slot(sp), psq = C::partner_slot(sq);
  const int kp = C::pair_of(sp), kq = C::pair_of(sq);
  const bool hp = C::holds_p(sp), hq = C::holds_p(sq);
  int r = 0, buf = 0;   // r: the round in the sweep
  // Unrolled by 2 so that the rotation's moves are made once in two rounds.
#pragma unroll 2
  for (int64_t round = 0; round < int64_t(m.sweeps) * C::kM; ++round) {
    const float4* cs = sm.cs[warp][buf];
    const float2* cs2 = reinterpret_cast<const float2*>(cs);
    float(*t)[kLd] = sm.tile[buf];
    turn_columns<NPAD, ODD>(a, v, cs, C::dead(ODD, r));
    put_row<NPAD>(t[i], a);
    __syncthreads();
    // pair k of the next round (live where p, q < n) from the tile
    const int xp = C::index_at(sp, r), xq = C::index_at(sq, r);
    const int yp = C::index_at(psp, r), yq = C::index_at(psq, r);
    const float2 cp = cs2[kp], cq = cs2[kq];
    const float srp = hp ? -cp.y : cp.y, srq = hq ? -cq.y : cq.y;
    float c1, s1;
    rot_coeffs(turned_entry(t, xp, yp, sp, yp < n, cp.x, srp),
               turned_entry(t, xq, yq, sq, yq < n, cq.x, srq),
               turned_entry(t, xp, yp, sq, yp < n, cp.x, srp), c1, s1);
    // this thread's row of J^T·B; for even n every thread turns its row
    // (one past NPAD with itself: no row is read from there)
    const int slot = i < NPAD ? C::slot_of(i, r) : 0;
    const int partner = i < NPAD ? C::index_at(C::partner_slot(slot), r) : i;
    if (!ODD || (i < n && partner < n)) {
      const float2 q = cs2[C::pair_of(slot)];
      const float sr = C::holds_p(slot) ? -q.y : q.y;
#pragma unroll
      for (int c = 0; c < NPAD; c += 4) {
        float y[4];
        get4<NPAD>(y, t[partner], c);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < NPAD) a[c + j] = row_turned(a[c + j], y[j], q.x, sr);
      }
    }
    if (lane < C::kPairs) {
      const bool live = xp < n && xq < n;
      put_cs(sm.cs[warp][buf ^ 1], lane, live ? c1 : 1.f, live ? s1 : 0.f);
    }
    __syncwarp();
    rotate<NPAD>(a);
    rotate<NPAD>(v);
    buf ^= 1;
    r = r + 1 == C::kM ? 0 : r + 1;
  }
  // r is 0 again: the slots are the natural order. tile[buf] was last read
  // two rounds ago, tile[buf ^ 1] is free after the next barrier.
  put_row<NPAD>(sm.tile[buf][i], a);
  __syncthreads();
  put_row<NPAD>(sm.tile[buf ^ 1][i], v);
  if (i < n) m.d[bi * n + i] = sm.tile[buf][i][i];
  __syncthreads();
  store_tile(sm.tile[buf ^ 1], m.v + off, n);
}

// The sums over the warp's 32 rows of alpha, beta and gamma of every pair:
// lane k ends with pair k's (zeros past the pairs). The first step halves
// the 32 pairs a lane holds by selecting the columns it keeps (pairs i or
// i + 16 by lane bit 16) before the products, so that the kept product
// fuses into its sum with the partner's (one FMA); then halve_pairs. Lane
// k's sum is x_k x_k + x_k' x_k' (k' = k ^ 16, one rounding of the
// partner's product and of the FMA), then added at distance 8, 4, 2, 1.
template <int NPAD>
__device__ __forceinline__ void warp_sums(const float (&a)[NPAD], int lane, float& al, float& be,
                                          float& ga) {
  using C = Circle<NPAD>;
  constexpr int kKept = kWarpN / 2, kLast = C::kPairs - 1;
  float sa[kKept], sb[kKept], sg[kKept];
  const bool up = lane & kKept;
#pragma unroll
  for (int i = 0; i < kKept; ++i) {   // NPAD >= 34: pair i < 16 is always there
    const bool hi = i + kKept < C::kPairs;
    const int j = hi ? i + kKept : kLast;
    const float x0 = a[C::p_slot(i)], y0 = a[C::q_slot(i)];
    const float x1 = hi ? a[C::p_slot(j)] : 0.f, y1 = hi ? a[C::q_slot(j)] : 0.f;
    const float xk = up ? x1 : x0, yk = up ? y1 : y0, xs = up ? x0 : x1, ys = up ? y0 : y1;
    sa[i] = __fmaf_rn(xk, xk, __shfl_xor_sync(kFull, xs * xs, kKept));
    sb[i] = __fmaf_rn(yk, yk, __shfl_xor_sync(kFull, ys * ys, kKept));
    sg[i] = __fmaf_rn(xk, yk, __shfl_xor_sync(kFull, xs * ys, kKept));
  }
  halve_pairs<kKept / 2, kKept, kKept / 2>(sa, sb, sg, lane);
  al = sa[0];
  be = sb[0];
  ga = sg[0];
}

struct GesvdSmem {
  float tile[kThreads][kLd];     // A in, U and V out
  float4 sums[2][2][kWarpN];     // [buffer][warp][pair]: the warp's alpha, beta, gamma
  float4 cs[2][2][kMaxN / 4];    // [warp][buffer]: a round's (c, s)
  float sigma[kThreads];
};

// One-sided Jacobi, two warps a matrix (see the top of the file); then
// sigma_j = |a_j| and U = A / sigma (sigma = 0: / 1). ODD as for syevd.
template <int NPAD, bool ODD>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) gesvd_block_kernel(const Matrices m) {
  using C = Circle<NPAD>;
  __shared__ GesvdSmem sm;
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5, n = m.n;
  const int64_t bi = blockIdx.x, off = bi * n * n;
  load_tile(sm.tile, m.a + off, n);
  __syncthreads();
  float a[NPAD], v[NPAD];
  take_row<NPAD>(a, sm.tile[i], i, n);
#pragma unroll
  for (int c = 0; c < NPAD; ++c) v[c] = c == i && i < n ? 1.f : 0.f;
  int r = 0, buf = 0;   // r: the round in the sweep
  // Unrolled by 2 so that the rotation's moves are made once in two rounds.
#pragma unroll 2
  for (int64_t round = 0; round < int64_t(m.sweeps) * C::kM; ++round) {
    float al, be, ga;
    warp_sums<NPAD>(a, lane, al, be, ga);
    sm.sums[buf][warp][lane] = make_float4(al, be, ga, 0.f);
    __syncthreads();
    if (lane < C::kPairs) {
      const float4 x = sm.sums[buf][0][lane], y = sm.sums[buf][1][lane];
      float c, s;
      rot_coeffs(x.x + y.x, x.y + y.y, x.z + y.z, c, s);
      put_cs(sm.cs[warp][buf], lane, c, s);
    }
    __syncwarp();
    turn_columns<NPAD, ODD>(a, v, sm.cs[warp][buf], C::dead(ODD, r));
    rotate<NPAD>(a);
    rotate<NPAD>(v);
    buf ^= 1;
    r = r + 1 == C::kM ? 0 : r + 1;
  }
  // Each thread touched only its own tile row since the load.
  put_row<NPAD>(sm.tile[i], a);
  __syncthreads();
  if (i < NPAD) {
    float ss = 0.f;
    for (int row = 0; row < n; ++row) ss += sm.tile[row][i] * sm.tile[row][i];
    sm.sigma[i] = sqrtf(ss);
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < NPAD; ++c) {
    const float sig = sm.sigma[c];
    a[c] = a[c] / (sig > 0.f ? sig : 1.f);
  }
  if (i < n) m.d[bi * n + i] = sm.sigma[i];
  put_row<NPAD>(sm.tile[i], a);
  __syncthreads();
  store_tile(sm.tile, m.u + off, n);
  __syncthreads();
  put_row<NPAD>(sm.tile[i], v);
  __syncthreads();
  store_tile(sm.tile, m.v + off, n);
}

template <int NPAD, bool ODD>
cudaError_t launch_block(bool svd, const Matrices& m, int64_t batch, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(batch);
  if (svd)
    gesvd_block_kernel<NPAD, ODD><<<blocks, kThreads, 0, stream>>>(m);
  else
    syevd_block_kernel<NPAD, ODD><<<blocks, kThreads, 0, stream>>>(m);
  return cudaGetLastError();
}

// One instantiation for each n from 33 to 64: each even NPAD from 34 to 64,
// odd n or not.
template <int NPAD = kWarpN + 2>
cudaError_t launch_padded(bool svd, const Matrices& m, int64_t batch, cudaStream_t stream) {
  if (m.n == NPAD) return launch_block<NPAD, false>(svd, m, batch, stream);
  if (m.n == NPAD - 1) return launch_block<NPAD, true>(svd, m, batch, stream);
  if constexpr (NPAD < kMaxN) return launch_padded<NPAD + 2>(svd, m, batch, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t launch_block_route(bool svd, const float* a, float* u, float* d, float* v,
                               int64_t batch, int n, int sweeps, cudaStream_t stream) {
  return launch_padded(svd, Matrices{a, u, d, v, n, sweeps}, batch, stream);
}

}  // namespace tml_jacobi
