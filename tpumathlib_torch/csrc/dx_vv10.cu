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
// output; here one block of 64 i sweeps every j itself, in tiles of 256 j
// staged in shared memory, and the sums over j stay in registers (the j-grid
// axis becomes the loop inside the block). j >= G is masked as the reference
// pads, with wr = 0 and w0 = kappa = 1, so G needs no padding and the sums
// equal the padded reference's. tpumathlib_torch/dx/vv10.py holds the
// wrappers, the plain PyTorch versions and the autograd Function that calls
// both kernels.
//
// Each pair takes one reciprocal, r = 1 / (g_i g_j (g_i + g_j)): phi = -1.5 r,
// and in the backward 1/g_i = g_j (g_i + g_j) r, 1/g_j = g_i (g_i + g_j) r
// and 1/(g_i + g_j) = g_i g_j r, so that
//   wr_j pgi = 1.5 (wr_j r g_j) (r (2 g_i + g_j)),
//   wr_j pgj = 1.5 (wr_j r g_i) (r (g_i + 2 g_j)),
// where each factor is at most twice a reciprocal of two of g_i, g_j and
// g_i + g_j, so none overflows where the terms do not (r^2 would). r2 is
// summed from the differences, never as |p_i|^2 + |p_j|^2 - 2 p_i.p_j,
// which cancels for close points. The constant -1.5 (1.5, 3 for the point
// sums) multiplies each sum once, after the loop.
//
// The reciprocal is lean: rcp.approx.ftz.f32 (MUFU.RCP, within 1 ulp) and
// one Newton step, r = r + r (1 - d r), which leaves it within about 1 ulp
// of the IEEE one; no division subroutine and no branch a pair. It is exact
// enough: the kernels are held on the card at VV10_TOL (1e-5) of the plain
// version and of float64 (chip_smoke.py), some 100 times an f32 sum's
// error; the tighter CPU parity of tests/test_torch_dx_vv10.py binds the
// plain versions, which divide. Its range is that of normal numbers: ftz
// reads a subnormal d as 0, and 1/d flushes to 0 for d >= 2^126, where an
// IEEE reciprocal (and a term wr_j r) may still be normal. So a tile of j
// takes it only where every pair of the block and the tile has g_i and g_j
// in [2^-41, 2^41), which puts d in [2^-122, 2^124): the staging threads
// bound g from each j's w0, kappa and |p|^2 and the block's largest
// (|p_i|^2, w0_i, kappa_i), with r2 <= 2 (|p_i|^2 + |p_j|^2), and the
// barrier that ends the tile (__syncthreads_or) tells every thread whether
// the next tile may take it; else that tile runs the IEEE reciprocal
// (__frcp_rn). A negative w0 or kappa, a NaN or an infinity sends its tiles
// there too. The test and bench inputs (w0 and kappa between about 0.5 and
// 3, points within some 20 of the origin) never leave the fast path; a w0
// past 2^41 / r2 (a density of some 1e-6 with a steep gradient) sends its
// tiles to the IEEE one, whose result they keep.
//
// What bounds them: the pairs' arithmetic (an FMA counts as 2 flop), as the
// bodies below do it. Both sweeps: 3 differences, r2 (1 MUL + 2 FMA), g_i
// and g_j (2 FMA), g_i + g_j, its two products: 15 flop, then the one
// reciprocal. Forward: the sum (1 FMA), 17 flop a pair. Backward: wr_j r, and
// each of the two weights above (2 MUL + 1 ADD + 1 MUL), s1 (1 FMA), s2 (1
// ADD), tij (1 MUL + 1 FMA), sx, sy, sz (3 FMA): 36 flop a pair. At G = 40960
// (1.68e9 pairs) and 67 TFLOP/s that is 0.43 ms forward and 0.90 ms
// backward. By issue slots (an FADD or FMUL takes one as an FFMA does;
// Hopper has no paired f32 issue) a pair is 15 instructions forward (with
// the reciprocal's MUFU and two Newton FMAs) and 30 backward, plus half a
// shared-memory load: some 0.8 and 1.6 ms at 1.98 GHz, the card's top
// clock. So the kernels are bound by issue, and reach some 80 % of it:
// 1.04–1.07 and 1.94–1.99 ms on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 32). On that card the IEEE reciprocal in place of
// the lean one was the slower design by far, and leaving out the Newton
// step would not have met 0.8 / 1.6 ms either.
//
// Design: registers hold the i side. A block of 128 threads (4 warps) owns
// 64 i, and every warp holds all 64: its lanes are 16 groups of 2, each
// thread 4 i (i0 + group + 16 r). A j tile's 256 points are split among the
// 8 threads that share an i set (warp w takes the tile's w-th quarter, its
// two lanes of a group alternate), so each j read from shared memory (a
// float4 and a float2, broadcast: a warp reads two neighbouring j at a
// step) serves 4 pairs: half a load a pair, where each pair loaded a j
// before. Tiles are double-buffered: a tile's global loads are issued
// before the sweep of the one staged before it and stored after it, and one
// barrier a tile ends both. At the end the 8 partial sums of each i are
// added in a fixed order (the lane pair by a shuffle, then the warps in
// turn through shared memory): deterministic, no atomics. At G = 40960,
// 640 blocks: the forward (81 registers) holds 6 an SM, so all run at once;
// the backward (122 registers under launch bounds of 4 blocks an SM, its
// sweep unrolled 8 j deep) holds 4, so 528 run first and 112 after, and was
// still faster on that card than at 5 an SM with 96 registers and no tail.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;                 // warps a block, each over a quarter of every tile
constexpr int kThreads = 32 * kWarps;     // 128
constexpr int kPair = 2;                  // lanes of a warp sharing an i set
constexpr int kGroups = 32 / kPair;       // i groups a warp
constexpr int kR = 4;                     // i a thread, in registers
constexpr int kRows = kGroups * kR;       // i a block: 64
constexpr int kTile = 256;                // j a shared-memory tile: two a thread to stage
constexpr int kStage = kTile / kThreads;  // j a thread stages a tile
constexpr int kSteps = kTile / (kWarps * kPair);  // j a thread sweeps a tile: 32
constexpr int kBlocksPerSM = 4;           // launch bounds: up to 128 registers a thread

constexpr float kLow = 0x1p-41f, kHigh = 0x1p41f;  // the lean reciprocal's range of g

struct Channels {
  const float* __restrict__ wr;
  const float* __restrict__ w0;
  const float* __restrict__ kappa;
  const float* __restrict__ pts;  // (G, 3)
  int64_t g;
};

// A thread's 4 i: points, w0 and kappa (i >= G reads as a pad: 0, 1, 1).
struct Rows {
  float x[kR], y[kR], z[kR], w0[kR], k[kR];
};

// The block's largest |p_i|^2, w0_i and kappa_i, and whether every i has
// w0_i >= 0 and kappa_i >= kLow. Every warp holds all the block's i, so a
// warp's reduction is the block's.
struct Bounds {
  float q, a, k;
  bool ok;
};

// The j a thread stages, (x, y, z, w0) and (kappa, wr); slots past G are
// the reference's padding, wr = 0 and w0 = kappa = 1.
struct Staged {
  float4 p[kStage];
  float2 q[kStage];
};

__device__ __forceinline__ Rows load_rows(const Channels& c, int64_t i0, int group) {
  Rows in;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int64_t i = i0 + group + kGroups * r;
    const bool live = i < c.g;
    in.x[r] = live ? __ldg(c.pts + 3 * i) : 0.f;
    in.y[r] = live ? __ldg(c.pts + 3 * i + 1) : 0.f;
    in.z[r] = live ? __ldg(c.pts + 3 * i + 2) : 0.f;
    in.w0[r] = live ? __ldg(c.w0 + i) : 1.f;
    in.k[r] = live ? __ldg(c.kappa + i) : 1.f;
  }
  return in;
}

// The largest of nonnegative floats over the warp, by their bits.
__device__ __forceinline__ float warp_max(float v) {
  return __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(v)));
}

__device__ __forceinline__ Bounds bounds_of(const Rows& in) {
  float q = 0.f, a = 0.f, k = 0.f;
  bool ok = true;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const float p2 = in.x[r] * in.x[r] + in.y[r] * in.y[r] + in.z[r] * in.z[r];
    q = fmaxf(q, p2);
    a = fmaxf(a, in.w0[r]);
    k = fmaxf(k, in.k[r]);
    // fmaxf drops a NaN: ok keeps it (a comparison with NaN is false)
    ok = ok && p2 < kHigh && in.w0[r] >= 0.f && in.k[r] >= kLow;
  }
  return Bounds{warp_max(q), warp_max(a), warp_max(k), __all_sync(0xffffffffu, ok) != 0};
}

__device__ __forceinline__ void fetch(const Channels& c, int64_t j0, Staged& st) {
#pragma unroll
  for (int h = 0; h < kStage; ++h) {
    const int64_t j = j0 + threadIdx.x + h * kThreads;
    if (j < c.g) {
      st.p[h] = make_float4(__ldg(c.pts + 3 * j), __ldg(c.pts + 3 * j + 1), __ldg(c.pts + 3 * j + 2),
                            __ldg(c.w0 + j));
      st.q[h] = make_float2(__ldg(c.kappa + j), __ldg(c.wr + j));
    } else {
      st.p[h] = make_float4(0.f, 0.f, 0.f, 1.f);
      st.q[h] = make_float2(1.f, 0.f);
    }
  }
}

// Stores the staged j into a tile buffer and returns whether every pair of
// them with the block's i has g_i and g_j in [kLow, kHigh) (NaN: no).
__device__ __forceinline__ bool stage(const Staged& st, const Bounds& b, float4* pj, float2* qj) {
  bool ok = b.ok;
#pragma unroll
  for (int h = 0; h < kStage; ++h) {
    const float4 p = st.p[h];
    const float2 q = st.q[h];
    pj[threadIdx.x + h * kThreads] = p;
    qj[threadIdx.x + h * kThreads] = q;
    const float r2 = 2.f * (b.q + (p.x * p.x + p.y * p.y + p.z * p.z));
    const float gi = fmaf(b.a, r2, b.k), gj = fmaf(p.w, r2, q.x);
    ok = ok && p.w >= 0.f && q.x >= kLow && gi < kHigh && gj < kHigh;
  }
  return ok;
}

// 1 / d. FAST: MUFU.RCP (ftz) and one Newton step, for normal d whose
// reciprocal is normal; else the IEEE reciprocal.
template <bool FAST>
__device__ __forceinline__ float recip(float d) {
  if constexpr (FAST) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(d));
    return fmaf(r, fmaf(-d, r, 1.f), r);
  } else {
    return __frcp_rn(d);
  }
}

// This thread's j of a tile: the warp's quarter, the lane's every other j.
__device__ __forceinline__ int first_j() {
  return (threadIdx.x / 32) * (kTile / kWarps) + threadIdx.x % kPair;
}

template <bool FAST>
__device__ __forceinline__ void fwd_tile(const Rows& in, const float4* pj, const float2* qj,
                                         float (&acc)[kR]) {
  const int j0 = first_j();
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const float4 p = pj[j0 + kPair * s];
    const float2 q = qj[j0 + kPair * s];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float dx = in.x[r] - p.x, dy = in.y[r] - p.y, dz = in.z[r] - p.z;
      const float r2 = dx * dx + dy * dy + dz * dz;
      const float gi = fmaf(in.w0[r], r2, in.k[r]), gj = fmaf(p.w, r2, q.x);
      acc[r] = fmaf(q.y, recip<FAST>(gi * gj * (gi + gj)), acc[r]);   // wr_j phi / -1.5
    }
  }
}

// s[0..4][r]: s1, s2, sx, sy, sz of the thread's i r.
template <bool FAST>
__device__ __forceinline__ void bwd_tile(const Rows& in, const float4* pj, const float2* qj,
                                         float (&s)[5][kR]) {
  const int j0 = first_j();
#pragma unroll 8
  for (int t = 0; t < kSteps; ++t) {
    const float4 p = pj[j0 + kPair * t];
    const float2 q = qj[j0 + kPair * t];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float dx = in.x[r] - p.x, dy = in.y[r] - p.y, dz = in.z[r] - p.z;
      const float r2 = dx * dx + dy * dy + dz * dz;
      const float gi = fmaf(in.w0[r], r2, in.k[r]), gj = fmaf(p.w, r2, q.x);
      const float gij = gi + gj;
      const float rr = recip<FAST>(gi * gj * gij);
      const float x = q.y * rr;
      const float wp = (x * gj) * (rr * (gi + gij));   // wr_j pgi / 1.5
      const float wq = (x * gi) * (rr * (gj + gij));   // wr_j pgj / 1.5
      s[0][r] = fmaf(wp, r2, s[0][r]);
      s[1][r] += wp;
      const float tij = fmaf(wp, in.w0[r], wq * p.w);
      s[2][r] = fmaf(tij, dx, s[2][r]);
      s[3][r] = fmaf(tij, dy, s[3][r]);
      s[4][r] = fmaf(tij, dz, s[4][r]);
    }
  }
}

// The block's sweep over every j tile: sweep(fast, pj, qj) runs a tile on
// the lean reciprocal where fast, else on the IEEE one. Two buffers, one
// barrier a tile.
template <typename Sweep>
__device__ __forceinline__ void sweep_tiles(const Channels& c, const Bounds& b, Sweep sweep) {
  __shared__ float4 pj[2][kTile];
  __shared__ float2 qj[2][kTile];
  Staged st;
  fetch(c, 0, st);
  bool fast = __syncthreads_or(!stage(st, b, pj[0], qj[0])) == 0;
  int buf = 0;
  for (int64_t j0 = 0; j0 < c.g; j0 += kTile, buf ^= 1) {
    const bool next = j0 + kTile < c.g;
    if (next) fetch(c, j0 + kTile, st);   // in flight during the sweep
    sweep(fast, pj[buf], qj[buf]);
    const bool ok = next ? stage(st, b, pj[buf ^ 1], qj[buf ^ 1]) : true;
    fast = __syncthreads_or(!ok) == 0;
  }
}

// Adds each i's partial sums (NV of them) in a fixed order and writes
// out[v * g + i]: the lanes of a group by shuffles, then the warps in turn.
template <int NV>
__device__ __forceinline__ void reduce_store(float (&v)[NV][kR], const float (&scale)[NV],
                                             int64_t i0, int64_t g, float* __restrict__ out) {
  __shared__ float part[kWarps][NV][kRows];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, group = lane / kPair;
#pragma unroll
  for (int o = 1; o < kPair; o <<= 1)
#pragma unroll
    for (int u = 0; u < NV; ++u)
#pragma unroll
      for (int r = 0; r < kR; ++r) v[u][r] += __shfl_xor_sync(0xffffffffu, v[u][r], o);
  if (lane % kPair == 0) {
#pragma unroll
    for (int u = 0; u < NV; ++u)
#pragma unroll
      for (int r = 0; r < kR; ++r) part[warp][u][group + kGroups * r] = v[u][r];
  }
  __syncthreads();
  if (threadIdx.x < kRows && i0 + threadIdx.x < g) {
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      float sum = part[0][u][threadIdx.x];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += part[w][u][threadIdx.x];
      out[u * g + i0 + threadIdx.x] = scale[u] * sum;
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
vv10_fwd_kernel(Channels c, float* __restrict__ inner) {
  const int64_t i0 = int64_t(blockIdx.x) * kRows;
  const Rows in = load_rows(c, i0, (threadIdx.x % 32) / kPair);
  const Bounds b = bounds_of(in);
  float acc[1][kR] = {};
  sweep_tiles(c, b, [&](bool fast, const float4* pj, const float2* qj) {
    if (fast) {
      fwd_tile<true>(in, pj, qj, acc[0]);
    } else {
      fwd_tile<false>(in, pj, qj, acc[0]);
    }
  });
  const float scale[1] = {-1.5f};
  reduce_store<1>(acc, scale, i0, c.g, inner);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
vv10_bwd_kernel(Channels c, float* __restrict__ sums) {
  const int64_t i0 = int64_t(blockIdx.x) * kRows;
  const Rows in = load_rows(c, i0, (threadIdx.x % 32) / kPair);
  const Bounds b = bounds_of(in);
  float s[5][kR] = {};
  sweep_tiles(c, b, [&](bool fast, const float4* pj, const float2* qj) {
    if (fast) {
      bwd_tile<true>(in, pj, qj, s);
    } else {
      bwd_tile<false>(in, pj, qj, s);
    }
  });
  const float scale[5] = {1.5f, 1.5f, 3.f, 3.f, 3.f};
  reduce_store<5>(s, scale, i0, c.g, sums);
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
