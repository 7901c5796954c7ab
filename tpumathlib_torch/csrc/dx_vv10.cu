// The VV10 pairwise sums of the nonlocal-correlation energy, for Hopper
// (sm_90a), f32:
//
//   tml_vv10_fwd: inner_i = sum_j wr_j phi_ij
//   tml_vv10_bwd: s1_i = sum_j wr_j pgi_ij r2_ij,  s2_i = sum_j wr_j pgi_ij,
//                 (sx, sy, sz)_i = 2 sum_j wr_j (pgi_ij w0_i + pgj_ij w0_j) (p_i - p_j)
//
// with r2 = |p_i - p_j|^2, g_i = w0_i r2 + kappa_i, g_j = w0_j r2 + kappa_j,
// phi = -1.5 / (g_i g_j (g_i + g_j)), pgi = -phi (1/g_i + 1/(g_i + g_j)) and
// pgj = -phi (1/g_j + 1/(g_i + g_j)), over all i, j < G (i == j included).
//
// Replace the TPU kernels of tpumathlib/dx/vv10.py: the pallas_call at :121
// with the bodies _fwd_kernel (:53-69) and _bwd_kernel (:72-98). The TPU grid
// is (i blocks, j tiles) with j the minor, sequential axis revisiting the
// output; here one block of 64 i-rows sweeps every j itself, in tiles of 256
// j staged in shared memory, and the sums over j stay in registers (the
// j-grid axis becomes the loop inside the block). Four threads share an i,
// each taking every fourth j of a tile, and add their partial sums by warp
// shuffles at the end, so 4 G threads are in flight (160 k at G = 40960: all
// resident on 132 SMs at once). j >= G is masked as the reference pads, with
// wr = 0 and w0 = kappa = 1, so G needs no padding and the sums equal the
// padded reference's. tpumathlib_torch/dx/vv10.py holds the wrappers, the
// plain PyTorch versions and the autograd Function that calls both kernels.
//
// Each pair takes one reciprocal, r = 1 / (g_i g_j (g_i + g_j)): phi = -1.5 r,
// and in the backward 1/g_i = g_j (g_i + g_j) r, 1/g_j = g_i (g_i + g_j) r
// and 1/(g_i + g_j) = g_i g_j r, so that
//   wr_j pgi = 1.5 (wr_j r g_j) (r (2 g_i + g_j)),
//   wr_j pgj = 1.5 (wr_j r g_i) (r (g_i + 2 g_j)),
// where each factor is at most twice a reciprocal of two of g_i, g_j and
// g_i + g_j, so none overflows where the terms do not (r^2 would). The constant -1.5 (1.5, 3 for the point sums) multiplies each
// sum once, after the loop. The reciprocal is IEEE (nvcc's default
// -prec-div=true: MUFU.RCP, a Newton correction and a range check), not
// __frcp approximate or __fdividef: the energy is held to 1e-7 of the
// reference's, and 2-ulp quotients, which also flush for denominators above
// 2^126, would spend that margin.
//
// What bounds them: the pairs' arithmetic (an FMA counts as 2 flop), as the
// bodies below do it. Both sweeps: 3 differences, r2 (1 MUL + 2 FMA), g_i
// and g_j (2 FMA), g_i + g_j, its two products: 15 flop, then the one
// reciprocal. Forward: the sum (1 FMA), 17 flop a pair. Backward: wr_j r, and
// each of the two weights above (2 MUL + 1 ADD + 1 MUL), s1 (1 FMA), s2 (1
// ADD), tij (1 MUL + 1 FMA), sx, sy, sz (3 FMA): 36 flop a pair. At G = 40960
// (1.68e9 pairs) and 67 TFLOP/s that is 0.43 ms forward and 0.90 ms
// backward; the special-function units (16 MUFU.RCP a clock an SM) need
// 0.40 ms for either at 1.98 GHz, so both are bound by their flop.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 4;                  // threads sharing one i
constexpr int kRows = 64;                  // i a block
constexpr int kThreads = kRows * kLanes;   // 256
constexpr int kTile = kThreads;            // j a shared-memory tile: one a thread to load

struct Channels {
  const float* wr;
  const float* w0;
  const float* kappa;
  const float* pts;   // (G, 3)
  int64_t g;
};

// Stages j0 .. j0 + kTile of the channels: (x, y, z, w0) and (kappa, wr);
// slots past G are the reference's padding, wr = 0 and w0 = kappa = 1.
__device__ __forceinline__ void stage(const Channels& c, int64_t j0, float4* pj, float2* qj) {
  const int64_t j = j0 + threadIdx.x;
  if (j < c.g) {
    pj[threadIdx.x] = make_float4(c.pts[3 * j], c.pts[3 * j + 1], c.pts[3 * j + 2], c.w0[j]);
    qj[threadIdx.x] = make_float2(c.kappa[j], c.wr[j]);
  } else {
    pj[threadIdx.x] = make_float4(0.f, 0.f, 0.f, 1.f);
    qj[threadIdx.x] = make_float2(1.f, 0.f);
  }
}

// The sum of v over the kLanes neighbouring threads of one i.
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads) vv10_fwd_kernel(Channels c, float* __restrict__ inner) {
  __shared__ float4 pj[kTile];
  __shared__ float2 qj[kTile];
  const int lane = threadIdx.x % kLanes;
  const int64_t i = int64_t(blockIdx.x) * kRows + threadIdx.x / kLanes;
  const bool live = i < c.g;
  float xi = 0.f, yi = 0.f, zi = 0.f, w0i = 1.f, ki = 1.f;
  if (live) {
    xi = c.pts[3 * i];
    yi = c.pts[3 * i + 1];
    zi = c.pts[3 * i + 2];
    w0i = c.w0[i];
    ki = c.kappa[i];
  }
  float acc = 0.f;
  for (int64_t j0 = 0; j0 < c.g; j0 += kTile) {
    stage(c, j0, pj, qj);
    __syncthreads();
#pragma unroll 4
    for (int jj = lane; jj < kTile; jj += kLanes) {
      const float4 p = pj[jj];
      const float2 q = qj[jj];
      const float dx = xi - p.x, dy = yi - p.y, dz = zi - p.z;
      const float r2 = dx * dx + dy * dy + dz * dz;
      const float gi = w0i * r2 + ki, gj = p.w * r2 + q.x;
      acc += q.y * (1.f / (gi * gj * (gi + gj)));   // wr_j phi / -1.5
    }
    __syncthreads();
  }
  acc = lanes_sum(acc);
  if (live && lane == 0) inner[i] = -1.5f * acc;
}

__global__ void __launch_bounds__(kThreads) vv10_bwd_kernel(Channels c, float* __restrict__ sums) {
  __shared__ float4 pj[kTile];
  __shared__ float2 qj[kTile];
  const int lane = threadIdx.x % kLanes;
  const int64_t i = int64_t(blockIdx.x) * kRows + threadIdx.x / kLanes;
  const bool live = i < c.g;
  float xi = 0.f, yi = 0.f, zi = 0.f, w0i = 1.f, ki = 1.f;
  if (live) {
    xi = c.pts[3 * i];
    yi = c.pts[3 * i + 1];
    zi = c.pts[3 * i + 2];
    w0i = c.w0[i];
    ki = c.kappa[i];
  }
  float s1 = 0.f, s2 = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
  for (int64_t j0 = 0; j0 < c.g; j0 += kTile) {
    stage(c, j0, pj, qj);
    __syncthreads();
#pragma unroll 2
    for (int jj = lane; jj < kTile; jj += kLanes) {
      const float4 p = pj[jj];
      const float2 q = qj[jj];
      const float dx = xi - p.x, dy = yi - p.y, dz = zi - p.z;
      const float r2 = dx * dx + dy * dy + dz * dz;
      const float gi = w0i * r2 + ki, gj = p.w * r2 + q.x;
      const float gij = gi + gj;
      const float r = 1.f / (gi * gj * gij);
      const float x = q.y * r;
      const float wp = (x * gj) * (r * (gi + gij));   // wr_j pgi / 1.5
      const float wq = (x * gi) * (r * (gj + gij));   // wr_j pgj / 1.5
      s1 += wp * r2;
      s2 += wp;
      const float tij = wp * w0i + wq * p.w;
      sx += tij * dx;
      sy += tij * dy;
      sz += tij * dz;
    }
    __syncthreads();
  }
  s1 = lanes_sum(s1);
  s2 = lanes_sum(s2);
  sx = lanes_sum(sx);
  sy = lanes_sum(sy);
  sz = lanes_sum(sz);
  if (live && lane == 0) {
    sums[i] = 1.5f * s1;
    sums[c.g + i] = 1.5f * s2;
    sums[2 * c.g + i] = 3.f * sx;
    sums[3 * c.g + i] = 3.f * sy;
    sums[4 * c.g + i] = 3.f * sz;
  }
}

cudaError_t check_args(const void* wr, const void* w0, const void* kappa, const void* pts,
                       const void* out, int64_t g) {
  if (wr == nullptr || w0 == nullptr || kappa == nullptr || pts == nullptr || out == nullptr ||
      g < 0 || (g + kRows - 1) / kRows > 0x7fffffff)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

Channels channels(const void* wr, const void* w0, const void* kappa, const void* pts, int64_t g) {
  return Channels{static_cast<const float*>(wr), static_cast<const float*>(w0),
                  static_cast<const float*>(kappa), static_cast<const float*>(pts), g};
}

}  // namespace

extern "C" {

// wr, w0, kappa (G,) and pts (G, 3), f32 contiguous; writes inner (G,) f32.
// Launches on `stream`; returns the CUDA status (0 on success).
int tml_vv10_fwd(const void* wr, const void* w0, const void* kappa, const void* pts, void* inner,
                 int64_t g, void* stream) {
  const cudaError_t e = check_args(wr, w0, kappa, pts, inner, g);
  if (e != cudaSuccess) return e;
  if (g == 0) return cudaSuccess;
  vv10_fwd_kernel<<<static_cast<unsigned>((g + kRows - 1) / kRows), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(channels(wr, w0, kappa, pts, g),
                                                         static_cast<float*>(inner));
  return cudaGetLastError();
}

// The same inputs; writes sums (5, G) f32: s1, s2, sx, sy, sz.
int tml_vv10_bwd(const void* wr, const void* w0, const void* kappa, const void* pts, void* sums,
                 int64_t g, void* stream) {
  const cudaError_t e = check_args(wr, w0, kappa, pts, sums, g);
  if (e != cudaSuccess) return e;
  if (g == 0) return cudaSuccess;
  vv10_bwd_kernel<<<static_cast<unsigned>((g + kRows - 1) / kRows), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(channels(wr, w0, kappa, pts, g),
                                                         static_cast<float*>(sums));
  return cudaGetLastError();
}

}  // extern "C"
