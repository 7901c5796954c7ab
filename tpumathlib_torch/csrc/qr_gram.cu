// The split-K Gram product of the blocked Householder QR, for Hopper (sm_90a):
//
//   tml_gram_tn:  D = alpha * X^T Y + beta * C  in f32, X (K, m) and Y (K, n)
//                 row-major, K a multiple of 128, m and n multiples of 64.
//
// Replaces the products that contract over the rows in the TPU kernel bodies
// tpumathlib/solver/qr_onelaunch.py::_geqrf_kernel (:174, pallas_call :318:
// G = B^T B and Q1^T Q1 in _qr_block128 :104, S = V^T V in _t_from_v :159,
// V0^T V1 and W = T^T (V^T C) in the panel loop) and _orgqr_kernel (:345,
// pallas_call :439). tpumathlib_torch/solver/qr_onelaunch.py drives it.
//
// Accuracy. Each output is summed in two levels, as the driver's plain
// version (_gram_tn_plain: a batched product of 128-row chunks, then the sum
// of the partial products) sums it: a fresh f32 register over each 128-row
// chunk (FMAs in row order), then the chunk sums in chunk order. One f32
// accumulator along K = 4096 is an order of magnitude less accurate, and
// through the Gram matrices' Cholesky factors that puts rel(Q R - A) at
// n = 4096 near the test bound of 5e-5.
//
// Design. A thread block of 256 threads sums one 64 x 64 tile of D, each
// thread a 4 x 4 block of it, over the chunks of its K slice: 32 rows of X
// and Y a step go through shared memory (two coalesced float4s each a
// thread), two steps' loads in flight while a step computes. A 128 x 128
// Gram has 4 tiles, far too few for 132 SMs, so K is split across blocks
// (blockIdx.y is the slice, a run of consecutive chunks) until about two
// blocks an SM are busy. A slice sums its chunks in order and writes its
// partial tile to the caller's work space; the last block of a tile to
// finish (a __threadfence and an atomic counter) sums the partials in slice
// order, writes D and resets the counter, so that the result does not
// depend on which block finishes last and needs no second launch. With one
// slice, or one chunk a slice, the sum is the chunk sums in chunk order
// exactly; in between, each slice's sum comes first.
//
// Options, so that the driver needs no eager op for them:
// - rows below `top` rows of X (or Y) may come from a second matrix: rows r
//   < xtop_rows are read at xtop + r * ldxt, the rest at x + r * ldx (the
//   driver's unit-lower top of V sits in scratch, its rows below in the
//   output);
// - kHalfDiag halves D's diagonal (T^-1 = strict_upper(S) + diag(S) / 2);
// - kRidge (m == n) adds ridge * trace(D) + 1e-30 to D's diagonal, the
//   CholeskyQR2 shift; the last tile to finish (a second counter) adds it.
//
// What bounds it: 2 K m n flop on SIMT FMA (3xTF32 on the tensor cores is
// later work). At K = 4096, m = 256, n = 3840 that is 8.1 GFLOP, 0.12 ms at
// 67 TFLOP/s; a 128 x 128 Gram at K = 4096 is 0.13 GFLOP, 2.1 MB of X read
// once, 0.6 us on bytes, but bound in practice by its slices' latency and
// the last block's reading of the partials (chip_smoke.py phase 11 times
// both shapes against torch.matmul).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;            // D's tile edge
constexpr int kChunk = 128;          // rows of a chunk: one fresh accumulator
constexpr int kStep = 32;            // rows through shared memory a step
constexpr int kThreads = 256;        // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTargetBlocks = 264;   // two blocks on each of the H100's 132 SMs
constexpr int kBatch = 4;            // partial tiles in flight at once in a tile's last block
constexpr int kHalfDiag = 1;
constexpr int kRidge = 2;

struct Operand {
  const float* p;    // row r >= top at p + r * ld
  const float* t;    // row r < top at t + r * ldt
  int64_t ld, ldt;
  int top;
  __device__ __forceinline__ const float* row(int r) const { return r < top ? t + r * ldt : p + r * ld; }
};

struct GramArgs {
  Operand x, y;
  const float* c;   // may be null
  float* d;
  int64_t ldc, ldd;
  int chunks, m, n, slices, flags;
  float alpha, beta, ridge;
  float* work;             // (tiles, slices, 64, 64) partials where slices > 1
  unsigned* counters;      // tiles + 1 counters, zero between launches
};

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

// True in every thread of the block when this block is the last of `total`
// to pass the counter; the block's writes before the call are visible to
// that last block.
__device__ __forceinline__ bool last_to_arrive(unsigned* counter, unsigned total, unsigned* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1u) == total - 1 ? 1u : 0u;
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

__global__ void __launch_bounds__(kThreads) gram_kernel(const GramArgs p) {
  __shared__ __align__(16) float xs[kStep][kTile];
  __shared__ __align__(16) float ys[kStep][kTile];
  __shared__ unsigned s_last;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int tiles_n = p.n / kTile, tiles = (p.m / kTile) * tiles_n;
  const int tile = blockIdx.x, slice = blockIdx.y;
  const int i0 = tile / tiles_n * kTile, j0 = tile % tiles_n * kTile;
  const int first = slice * p.chunks / p.slices, last = (slice + 1) * p.chunks / p.slices;
  const int lr = tid / 16, lc = tid % 16 * 4;   // this thread's float4s of a step: rows lr, lr + 16
  const int steps = (last - first) * (kChunk / kStep);

  float tot[4][4], acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) tot[a][b] = 0.f;
  // Two steps' loads in flight: the registers of step s + 2 are filled while
  // step s computes, from the set that step s was stored from (the loop
  // runs two steps a turn, so each set is a fixed set of registers).
  const int row0 = first * kChunk + lr;
  float4 bufa[4], bufb[4];   // x, y at rows lr and lr + 16
  auto load = [&](float4 (&buf)[4], int s) {
    const int r = row0 + s * kStep;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      buf[h] = ld4(p.x.row(r + 16 * h) + i0 + lc);
      buf[2 + h] = ld4(p.y.row(r + 16 * h) + j0 + lc);
    }
  };
  auto step = [&](float4 (&buf)[4], int s) {
    __syncthreads();   // the last step's reads of xs and ys are done
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float4*>(&xs[lr + 16 * h][lc]) = buf[h];
      *reinterpret_cast<float4*>(&ys[lr + 16 * h][lc]) = buf[2 + h];
    }
    __syncthreads();
    if (s + 2 < steps) load(buf, s + 2);
    if (s % (kChunk / kStep) == 0) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kStep; ++kk) {
      const float4 fx = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 fy = *reinterpret_cast<const float4*>(&ys[kk][tx * 4]);
      const float vx[4] = {fx.x, fx.y, fx.z, fx.w}, vy[4] = {fy.x, fy.y, fy.z, fy.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(vx[a], vy[b], acc[a][b]);
    }
    if (s % (kChunk / kStep) == kChunk / kStep - 1) {   // a chunk done: add it in order
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) tot[a][b] += acc[a][b];
    }
  };
  load(bufa, 0);
  load(bufb, 1);   // steps is a multiple of kChunk / kStep = 4
  for (int s = 0; s < steps; s += 2) {
    step(bufa, s);
    step(bufb, s + 1);
  }

  if (p.slices > 1) {   // the partials in slice order, by the tile's last block
    float* part = p.work + (static_cast<int64_t>(tile) * p.slices + slice) * kTile * kTile;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<float4*>(part + (ty * 4 + a) * kTile + tx * 4) =
          make_float4(tot[a][0], tot[a][1], tot[a][2], tot[a][3]);
    if (!last_to_arrive(p.counters + tile, p.slices, &s_last)) return;
    // kBatch partials' 16 outputs of this thread in flight at once (one at a
    // time, each would wait on L2), then added in slice order
    const float* parts = p.work + static_cast<int64_t>(tile) * p.slices * kTile * kTile +
                         ty * 4 * kTile + tx * 4;
    for (int q0 = 0; q0 < p.slices; q0 += kBatch) {
      float4 v[kBatch][4];
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
#pragma unroll
        for (int a = 0; a < 4; ++a)
          if (q0 + q < p.slices) v[q][a] = ldcg4(parts + ((q0 + q) * kTile + a) * kTile);
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (q0 + q >= p.slices) break;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float w[4] = {v[q][a].x, v[q][a].y, v[q][a].z, v[q][a].w};
#pragma unroll
          for (int b = 0; b < 4; ++b) tot[a][b] = q0 + q ? tot[a][b] + w[b] : w[b];
        }
      }
    }
    if (tid == 0) p.counters[tile] = 0u;
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
    float v[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tx * 4 + b;
      v[b] = __fmul_rn(p.alpha, tot[a][b]);
      if (p.c != nullptr) v[b] = __fadd_rn(v[b], __fmul_rn(p.beta, p.c[i * p.ldc + j]));
      if ((p.flags & kHalfDiag) && i == j) v[b] *= 0.5f;
    }
    *reinterpret_cast<float4*>(p.d + i * p.ldd + j0 + tx * 4) = make_float4(v[0], v[1], v[2], v[3]);
  }

  if (p.flags & kRidge) {   // the last tile adds ridge * trace + 1e-30 to the diagonal
    if (!last_to_arrive(p.counters + tiles, tiles, &s_last)) return;
    if (tid < 32) {
      float tr = 0.f;
      for (int i = tid; i < p.m; i += 32) tr += __ldcg(p.d + i * p.ldd + i);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) tr += __shfl_xor_sync(0xffffffffu, tr, off);
      const float add = __fadd_rn(__fmul_rn(p.ridge, tr), 1e-30f);
      for (int i = tid; i < p.m; i += 32) p.d[i * p.ldd + i] = __fadd_rn(__ldcg(p.d + i * p.ldd + i), add);
      if (tid == 0) p.counters[tiles] = 0u;
    }
  }
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// x (k, m) and y (k, n) f32 row-major with row strides ldx and ldy; rows r <
// xtop_rows of x (ytop_rows of y) are read from xtop (ytop) with row stride
// ldxt (ldyt) instead. c (m, n, row stride ldc) may be null, and may be d.
// k and the top rows multiples of 128, m and n of 64, every pointer 16-byte
// aligned and every row stride a multiple of 4. flags: 1 halves D's
// diagonal, 2 (m == n) adds ridge * trace(D) + 1e-30 to it. work holds
// work_tiles 64 x 64 f32 tiles of partials, counters ncounters unsigned
// that are zero (and are left zero); the K split takes at most work_tiles
// tiles of partials, none where work is null, and kRidge or a split needs
// counters for every tile plus one. Launches on `stream`; returns the CUDA
// status (0 on success).
int tml_gram_tn(const float* x, int64_t ldx, const float* xtop, int64_t ldxt, int64_t xtop_rows,
                const float* y, int64_t ldy, const float* ytop, int64_t ldyt, int64_t ytop_rows,
                const float* c, int64_t ldc, float* d, int64_t ldd, int64_t k, int64_t m, int64_t n,
                float alpha, float beta, float ridge, int flags, float* work, int64_t work_tiles,
                unsigned* counters, int64_t ncounters, void* stream) {
  const bool shapes = k >= kChunk && k % kChunk == 0 && k <= (int64_t{1} << 24) && m >= kTile &&
                      m % kTile == 0 && n >= kTile && n % kTile == 0 && m * n <= (int64_t{1} << 30) &&
                      xtop_rows >= 0 && xtop_rows <= k && xtop_rows % kChunk == 0 &&
                      ytop_rows >= 0 && ytop_rows <= k && ytop_rows % kChunk == 0;
  const bool layout = x != nullptr && y != nullptr && d != nullptr && aligned(x) && aligned(y) &&
                      aligned(d) && (c == nullptr || aligned(c)) && ldx % 4 == 0 &&
                      ldy % 4 == 0 && ldd % 4 == 0 && (c == nullptr || ldc % 4 == 0) &&
                      (xtop_rows == 0 || (xtop != nullptr && aligned(xtop) && ldxt % 4 == 0)) &&
                      (ytop_rows == 0 || (ytop != nullptr && aligned(ytop) && ldyt % 4 == 0));
  if (!shapes || !layout || ((flags & kRidge) && m != n)) return cudaErrorInvalidValue;
  const int64_t tiles = (m / kTile) * (n / kTile), chunks = k / kChunk;
  const bool counted = counters != nullptr && ncounters >= tiles + 1;
  if ((flags & kRidge) && !counted) return cudaErrorInvalidValue;
  int64_t slices = 1;
  if (work != nullptr && counted) {
    slices = kTargetBlocks / tiles;
    if (work_tiles / tiles < slices) slices = work_tiles / tiles;
    if (chunks < slices) slices = chunks;
    if (slices < 1) slices = 1;
  }
  GramArgs p{};
  p.x = Operand{x, xtop, ldx, ldxt, static_cast<int>(xtop_rows)};
  p.y = Operand{y, ytop, ldy, ldyt, static_cast<int>(ytop_rows)};
  p.c = c;
  p.d = d;
  p.ldc = ldc;
  p.ldd = ldd;
  p.chunks = static_cast<int>(chunks);
  p.m = static_cast<int>(m);
  p.n = static_cast<int>(n);
  p.slices = static_cast<int>(slices);
  p.flags = flags;
  p.alpha = alpha;
  p.beta = beta;
  p.ridge = ridge;
  p.work = work;
  p.counters = counters;
  gram_kernel<<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(slices)), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // extern "C"
