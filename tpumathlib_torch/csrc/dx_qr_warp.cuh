// The warp QR core of the batched solvers, a warp a matrix (csrc/dx_solver.cu:
// gels_warp_kernel and the C entry points; csrc/dx_qr_warp.cu: geqrf's and
// unmqr's warp routes): dlarfg's scalars, the Householder steps on columns
// held in the lanes' registers, the four sums of warp_sums4, the route
// rules, and the launchers of csrc/dx_qr_warp.cu and csrc/dx_qr_panel.cu
// (geqrf's and unmqr's panel routes).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tml_qr {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpN = 32;         // the warp routes' largest n
constexpr int kWarpMatrices = 4;   // matrices (warps) a block on the warp routes

// Four partial sums by row mod 4, added as (s0 + s1) + (s2 + s3).
__device__ __forceinline__ float sum4(const float (&s)[4]) { return (s[0] + s[1]) + (s[2] + s[3]); }

// The sums of four columns' partial sums s over the warp's 32 lanes, every
// lane left with all four: lanes exchange half of their sums over lane bit
// 16 and half of the rest over bit 8, so each lane holds one column's sum
// over its four lanes; a butterfly over bits 4, 2 and 1 completes it, and
// two exchanges over 8 and 16 hand the four sums back to every lane. Each
// sum takes the butterfly's tree (lane l's and lane l ^ 16's, then those of
// l and l ^ 8, ...), and an addition's result does not depend on the order
// of its operands, so the sums equal four butterflies' bit for bit.
__device__ __forceinline__ void warp_sums4(float (&s)[4], int lane) {
  const bool h = lane & 16, b = lane & 8;
  const float k0 = (h ? s[2] : s[0]) + __shfl_xor_sync(kFull, h ? s[0] : s[2], 16);
  const float k1 = (h ? s[3] : s[1]) + __shfl_xor_sync(kFull, h ? s[1] : s[3], 16);
  float w = (b ? k1 : k0) + __shfl_xor_sync(kFull, b ? k0 : k1, 8);   // column 2 h + b
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) w += __shfl_xor_sync(kFull, w, off);
  const float o = __shfl_xor_sync(kFull, w, 8);
  const float p0 = b ? o : w, p1 = b ? w : o;   // columns 2 h and 2 h + 1
  const float q0 = __shfl_xor_sync(kFull, p0, 16), q1 = __shfl_xor_sync(kFull, p1, 16);
  s[0] = h ? q0 : p0;
  s[1] = h ? q1 : p1;
  s[2] = h ? p0 : q0;
  s[3] = h ? p1 : q1;
}

// dlarfg of a column whose entry j is xj and whose tail's sum of squares is
// ts, as geqrf_steps forms it: returns v_j, and through the references tau_h,
// tau (= tau_h v_j^2, 0 where unsafe) and whether the tail is zero.
__device__ __forceinline__ float dlarfg(float xj, float ts, float& tau_h, float& tau, bool& degenerate) {
  const float ss = fmaf(xj, xj, ts);
  degenerate = ts == 0.f;
  const float sign = xj > 0.f ? 1.f : xj < 0.f ? -1.f : xj == 0.f ? 1.f : xj;
  const float alpha = degenerate ? xj : -sign * sqrtf(ss);
  const float vj = xj - alpha;
  const float vsq = degenerate ? 0.f : ts + vj * vj;
  const bool safe = vsq > 0.f;
  tau_h = safe ? 2.f / vsq : 0.f;
  tau = safe ? tau_h * vj * vj : 0.f;
  return vj;
}

// The QR steps on lane `lane`'s column a (32 R rows: zeros past m and n that
// take no part); FULL: m = 32 R, no row needs testing. Step j: lane j sums
// its tail's squares (four partial sums by row mod 4), forms dlarfg's scalars
// with geqrf_steps' formulas (sign(0) = +1, a zero tail gives tau = 0) and
// writes v (v_j = x_j - alpha, below it the column; zeros for a zero tail)
// twice and the scalars to the warp's slice v; after a __syncwarp each lane
// c > j (and lane j for its row j) forms w_c = tau_h sum_r v_r a_rc over its
// own registers (four partial sums likewise) from the one copy and subtracts
// v_r w_c reading the other: from one copy the compiler keeps all of v in
// registers between the two passes and spills. v: v, its copy, then 4
// scalars. Leaves R above the diagonal, v below it (the stored reflector
// times v_j, returned in vdiv: dividing by it gives geqrf's layout), tau in
// taus[j], written by lane j.
template <int R, bool FULL>
__device__ __forceinline__ void gels_qr_steps(float (&a)[32 * R], float* v, float* taus, float& vdiv,
                                              int lane, int m, int n) {
  constexpr int M = 32 * R;
  auto real = [m](int r) { return FULL || r < 32 * (R - 1) || r < m; };
#pragma unroll
  for (int j = 0; j < kWarpN; ++j) {
    if (j >= n) break;
    if (lane == j) {
      float sq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = j + 1; r < M; ++r)
        if (real(r)) sq[r & 3] = fmaf(a[r], a[r], sq[r & 3]);
      float tau_h, tau;
      bool degenerate;
      const float vj = dlarfg(a[j], sum4(sq), tau_h, tau, degenerate);
      vdiv = vj == 0.f ? 1.f : vj;
      taus[j] = tau;
#pragma unroll
      for (int q = j / 4; q < M / 4; ++q) {   // v: zero for a zero tail (rows < j unread)
        float e4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 4 * q + e;
          e4[e] = degenerate ? 0.f : r == j ? vj : a[r];
        }
        reinterpret_cast<float4*>(v)[q] = make_float4(e4[0], e4[1], e4[2], e4[3]);
        reinterpret_cast<float4*>(v + M)[q] = make_float4(e4[0], e4[1], e4[2], e4[3]);
      }
#pragma unroll
      for (int r = j + 1; r < M; ++r)
        if (degenerate) a[r] = 0.f;
      reinterpret_cast<float4*>(v + 2 * M)[0] = make_float4(tau_h, 0.f, 0.f, degenerate ? 1.f : 0.f);
    }
    __syncwarp();
    const float4 sc = reinterpret_cast<const float4*>(v + 2 * M)[0];
    float part[4] = {0.f, 0.f, 0.f, 0.f};   // v^T a_c over rows >= j
#pragma unroll
    for (int q = j / 4; q < M / 4; ++q) {
      const float4 vq = reinterpret_cast<const float4*>(v)[q];
      const float ve[4] = {vq.x, vq.y, vq.z, vq.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e >= j && real(4 * q + e)) part[e] = fmaf(ve[e], a[4 * q + e], part[e]);
    }
    const float wc = sc.w != 0.f ? 0.f : sum4(part) * sc.x;
    const bool update = lane > j && lane < n;   // and lane j its row j (R's entry)
#pragma unroll
    for (int q = j / 4; q < M / 4; ++q) {
      const float4 vq = reinterpret_cast<const float4*>(v + M)[q];
      const float ve[4] = {vq.x, vq.y, vq.z, vq.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 4 * q + e;
        if (r >= j && real(r) && (update || (lane == j && r == j))) a[r] = fmaf(-ve[e], wc, a[r]);
      }
    }
    __syncwarp();
  }
}

// The route rules (dx/solver.py's _geqrf_route and _unmqr_route mirror
// them): geqrf of (n, n) takes a warp a matrix for n <= 32, 32-column panels
// in a block's shared memory for n <= 224 (geqrf_panel_bytes fits there);
// unmqr of QR (m, n) a warp a matrix for m <= 64 and n <= 32, whatever C's
// k, else the panel route for m <= 224. The rest take csrc/dx_solver.cu's
// block kernels.
constexpr int kPanel = 32;           // the panel routes' panel width
constexpr int kPanelMaxN = 224;      // their largest n (geqrf) and m (unmqr): 7 warps of rows
constexpr int64_t kPanelSmem = 232448;   // a block's opt-in shared memory on sm_90
inline int64_t panel_rows(int64_t n) { return (n + kPanel - 1) / kPanel * kPanel; }
// geqrf's panel route: the matrix padded to np = n rounded up to 32, rows of
// np + 4 floats; two sets of the warps' 32 partial sums and of row j's 32
// entries; the panel's 32 tau.
inline int64_t geqrf_panel_bytes(int64_t n) {
  const int64_t np = panel_rows(n);
  return 4 * (np * (np + 4) + 2 * (kPanelMaxN / 32) * kPanel + 2 * kPanel + kPanel);
}
inline bool geqrf_warp_route(int64_t n) { return n <= kWarpN; }
inline bool geqrf_panel_route(int64_t n) {
  return n <= kPanelMaxN && geqrf_panel_bytes(n) <= kPanelSmem;
}
inline bool unmqr_warp_route(int64_t m, int64_t n) { return m <= 2 * kWarpN && n <= kWarpN; }
inline bool unmqr_panel_route(int64_t m) { return m <= kPanelMaxN; }

// geqrf's warp route: `batch` f32 (n, n) matrices at a, n <= 32, into qr
// (batch, n, n) and tau (batch, n), on `stream`.
cudaError_t launch_geqrf_warp(const float* a, float* qr, float* tau, int64_t batch, int n,
                              cudaStream_t stream);

// unmqr's warp route: QR (batch, m, n) and tau (batch, n) as geqrf leaves
// them, m <= 64 and n <= 32, C (batch, m, k) into x (batch, m, k): Q^T C
// (trans) or Q C, on `stream`.
cudaError_t launch_unmqr_warp(const float* qr, const float* tau, const float* c, float* x,
                              int64_t batch, int m, int n, int k, bool trans, cudaStream_t stream);

// geqrf's panel route: `batch` f32 (n, n) matrices, 32 < n <= 224, as
// launch_geqrf_warp.
cudaError_t launch_geqrf_panel(const float* a, float* qr, float* tau, int64_t batch, int n,
                               cudaStream_t stream);

// unmqr's panel route: as launch_unmqr_warp for m <= 224, any n and k.
cudaError_t launch_unmqr_panel(const float* qr, const float* tau, const float* c, float* x,
                               int64_t batch, int m, int n, int k, bool trans, cudaStream_t stream);

}  // namespace tml_qr
