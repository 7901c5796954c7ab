// The warp routes of batched Householder QR and of applying its Q, for
// Hopper (sm_90a), called by tml_geqrf_batched and tml_unmqr_batched
// (csrc/dx_solver.cu, which holds the C entry points and the block routes):
//
//   geqrf_warp_kernel: (QR, tau) of f32 (n, n) matrices, n <= 32, in
//                      LAPACK geqrf layout.
//   unmqr_warp_kernel: Q^T C or Q C from geqrf's reflectors, QR (m, n) with
//                      m <= 64 and n <= 32, C (m, k) for any k.
//
// They replace, for those sizes, the TPU kernels of tpumathlib/dx/solver.py:
// geqrf_batched's pallas_call (_run_batched :222, for geqrf_batched :374;
// body _geqrf_body :157) and unmqr_batched's (:597, body _apply_q_body
// :538). The function is that of dx/solver.py's _geqrf_plain and
// _apply_q_plain, with geqrf_steps' dlarfg (csrc/dx_qr_warp.cuh): sign(0) =
// +1, a zero tail gives tau = 0 and leaves its column as it is, the
// reflector stored with v_j = 1 and tau = tau_h v_j^2; reflectors j >= m are
// empty.
//
// Layout: a warp a matrix, kWarpMatrices (4) matrices a block, no block
// barrier, so a NaN stays in its own matrix.
// - geqrf: lane c holds column c in registers, loaded a row of A at a time
//   (coalesced), and runs gels's QR steps (gels_qr_steps<1, FULL>, FULL for
//   n = 32); then each lane divides its column below the diagonal by its
//   v_j and writes QR a row at a time, lane j writing tau_j.
// - unmqr: QR's entries below the diagonal are loaded a row at a time into
//   the warp's tile (m x 33: a column's reads fall on distinct banks), tau
//   beside it; lane r holds rows r and r + 32 of C, 4 columns at a time, as
//   gels_warp_kernel takes B. Reflector j (ascending for Q^T C, descending
//   for Q C): each lane forms its rows' share of v^T C's four sums (v_j = 1,
//   below it the tile's column j), a transposing reduction adds them over
//   the lanes (warp_sums4: halving the four sums over lane bits 16 and 8,
//   then adding over 4, 2 and 1, then handing them back over 8 and 16: 9
//   shuffles where four butterflies take 20, the same sum tree, so the
//   same bits), and each lane updates its rows.
//
// What bounds them: at batch 8192 x n 32, geqrf reads A and writes QR and tau,
// 67.6 MB, 0.020 ms at 3.35 TB/s, against 4n^3/3 flop a matrix (0.005 ms at
// 67 TFLOP/s); unmqr at 8192 x 32 x 32, k = 4, reads the reflectors below
// the diagonal, tau and C and writes X, 25.7 MB, 0.008 ms. Bytes bound both;
// the instructions a warp issues for its matrix's dependent steps pace them:
// geqrf some 4-5k a matrix (each step a lane's dlarfg, then every lane's
// sum and update of its column), unmqr some 70 a reflector and 4 columns.

#include "dx_qr_warp.cuh"

namespace tml_qr {
namespace {

__global__ void __launch_bounds__(kWarpMatrices * 32, 4)
    geqrf_warp_kernel(const float* __restrict__ a, float* __restrict__ qr, float* __restrict__ tau,
                      int n, int64_t batch) {
  __shared__ __align__(16) float slices[kWarpMatrices][2 * kWarpN + 4];   // v, its copy, 4 scalars
  __shared__ float tau_of[kWarpMatrices][kWarpN];
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int64_t bi = int64_t(blockIdx.x) * kWarpMatrices + wi;
  if (bi >= batch) return;
  const float* A = a + bi * n * n;
  float col[kWarpN];
#pragma unroll
  for (int r = 0; r < kWarpN; ++r) col[r] = lane < n && r < n ? __ldg(A + r * n + lane) : 0.f;
  float vdiv = 1.f;
  if (n == kWarpN)
    gels_qr_steps<1, true>(col, slices[wi], tau_of[wi], vdiv, lane, n, n);
  else
    gels_qr_steps<1, false>(col, slices[wi], tau_of[wi], vdiv, lane, n, n);
  float* out = qr + bi * n * n;
#pragma unroll
  for (int r = 0; r < kWarpN; ++r) {   // the reflectors: v_r / v_j below the diagonal, as stored
    if (r > lane) col[r] = col[r] / vdiv;
    if (r < n && lane < n) out[r * n + lane] = col[r];
  }
  if (lane < n) tau[bi * n + lane] = tau_of[wi][lane];
}

template <int R>
__global__ void __launch_bounds__(kWarpMatrices * 32, 4)
    unmqr_warp_kernel(const float* __restrict__ qr, const float* __restrict__ tau,
                      const float* __restrict__ c, float* __restrict__ x, int m, int n, int k,
                      bool trans, int64_t batch) {
  constexpr int M = 32 * R, KG = 4;   // KG: C's columns in registers at a time
  __shared__ float tiles[kWarpMatrices][M][kWarpN + 1];   // QR below the diagonal
  __shared__ float tau_of[kWarpMatrices][kWarpN];
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int64_t bi = int64_t(blockIdx.x) * kWarpMatrices + wi;
  if (bi >= batch) return;
  float (*t)[kWarpN + 1] = tiles[wi];
  const int steps = min(m, n);
  const float* Q = qr + bi * m * n;
  for (int r = 1; r < m; ++r)   // row r's reflector entries: columns < min(r, steps)
    if (lane < min(r, steps)) t[r][lane] = __ldg(Q + r * n + lane);
  if (lane < steps) tau_of[wi][lane] = __ldg(tau + bi * n + lane);
  __syncwarp();
  const float* C = c + bi * m * k;
  float* X = x + bi * m * k;
  for (int c0 = 0; c0 < k; c0 += KG) {
    float xv[R][KG];
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int cc = 0; cc < KG; ++cc)
        xv[q][cc] = lane + 32 * q < m && c0 + cc < k ? __ldg(C + (lane + 32 * q) * k + c0 + cc) : 0.f;
    for (int i = 0; i < steps; ++i) {   // H_j = I - tau_j v v^T
      const int j = trans ? i : steps - 1 - i;
      const float tj = tau_of[wi][j];
      float vr[R];
      bool on[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int r = lane + 32 * q;
        on[q] = r >= j && r < m;
        vr[q] = r == j ? 1.f : on[q] ? t[r][j] : 0.f;
      }
      float s[KG];
#pragma unroll
      for (int cc = 0; cc < KG; ++cc) {
        s[cc] = 0.f;
#pragma unroll
        for (int q = 0; q < R; ++q)
          if (on[q]) s[cc] = fmaf(vr[q], xv[q][cc], s[cc]);
      }
      warp_sums4(s, lane);
#pragma unroll
      for (int cc = 0; cc < KG; ++cc) {
        const float wq = s[cc] * tj;
#pragma unroll
        for (int q = 0; q < R; ++q)
          if (on[q]) xv[q][cc] = fmaf(-vr[q], wq, xv[q][cc]);
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int cc = 0; cc < KG; ++cc)
        if (lane + 32 * q < m && c0 + cc < k) X[(lane + 32 * q) * k + c0 + cc] = xv[q][cc];
  }
}

unsigned warp_blocks(int64_t batch) {
  return static_cast<unsigned>((batch + kWarpMatrices - 1) / kWarpMatrices);
}

}  // namespace

cudaError_t launch_geqrf_warp(const float* a, float* qr, float* tau, int64_t batch, int n,
                              cudaStream_t stream) {
  geqrf_warp_kernel<<<warp_blocks(batch), kWarpMatrices * 32, 0, stream>>>(a, qr, tau, n, batch);
  return cudaGetLastError();
}

cudaError_t launch_unmqr_warp(const float* qr, const float* tau, const float* c, float* x,
                              int64_t batch, int m, int n, int k, bool trans, cudaStream_t stream) {
  auto kernel = m <= kWarpN ? unmqr_warp_kernel<1> : unmqr_warp_kernel<2>;
  kernel<<<warp_blocks(batch), kWarpMatrices * 32, 0, stream>>>(qr, tau, c, x, m, n, k, trans, batch);
  return cudaGetLastError();
}

}  // namespace tml_qr
