// The fused GEMM -> row FFT of the MathDx tier, for Hopper (sm_90a):
//
//   tml_gemm_fft:      for f32 A (m, k), k <= 1024, and B (k, n), n <= 256:
//                      the TF32 hi and lo planes of B^T (n, k) into the
//                      caller's scratch (tml_split_tf32, gemm_tf32x3.cu), then
//                      C = epilogue(A B) on the tensor cores (3xTF32) and the
//                      forward n-point FFT of each row of C, (yr, yi) f32 (m,
//                      n): two launches, one call;
//   tml_gemm_fft_simt: the same function for f32 B (k, n), n <= 1024, the
//                      product in f32 FMA.
//
// Both take the table of the n forward roots tab[j] = w^j, w = exp(-2 pi i /
// n) (interleaved (re, im) f32, built in float64: fft/kernels.py::_roots_on)
// and the row FFT's plan words, (n, threads, points, npasses, radices...),
// built by dx/fused.py::_gemm_fft_plan on fft/kernels.py::_radix_passes.
//
// Replaces the TPU kernel of tpumathlib/dx/fused.py: gemm_fft's pallas_call
// (:70, kernel body :54), which keeps the (bm, n) product tile in VMEM
// through the epilogue and computes the row FFT as two DFT products, the
// MXU's way round the TPU's lack of a gather. tpumathlib_torch/dx/fused.py
// holds the wrapper, the size rule that picks the route (_gemm_fft_route)
// and the plain PyTorch version (_gemm_fft_plain, the reference's DFT
// products).
//
// The epilogue codes: 1 is max(c, 0), a NaN kept as jnp.maximum keeps it; 2 is
// 0.5 c (1 + tanh(0.7978845608028654 (c + 0.044715 c c c))); anything else is
// none, as the reference ignores every other string (ROADMAP C14).
//
// What bounds the function: the product's 2 m k n flop, run as three TF32
// products (3 * 2 m k n at 495 TFLOP/s), and an FFT's 5 n log2 n a row at the
// f32 rate: 0.026 + 0.005 = 0.031 ms at m = 32768, k = n = 256; its bytes (A
// and B read, Y written) take 0.030 ms.
//
// The tensor-core route (n <= 256): one block of 384 threads takes 64 rows of
// A and every column. One thread of its third warpgroup keeps TMA loads of 3 stages
// in flight, each A's 64 x 32 in f32 and B^T's hi and lo 256 x 32 (zero past
// n), 72 KB; the two consumer warpgroups each take 128 columns, split A in
// registers and run three wgmma m64n128k8 tf32 a k8 step into a fresh
// partial a stage, summed into the accumulator in f32 (hopper_ring.cuh's
// stage_tf32x3_at: the 3xTF32 ring of gemm_tf32x3.cu). Once every product is
// done the ring is free, and the consumers write epilogue(C) from their
// accumulators into it as the radix passes read a row: a real plane and a
// zero imaginary plane of lp.ld floats, the power-of-two family's pad after
// every 32 (150 KB at n = 256). Then all 384 threads run the passes of
// stockham_passes.cuh over the 64 rows, n / points threads a row, a group of
// rows at a time (threads past the last row work on a spare row that nobody
// reads, so every thread meets every barrier); the last pass writes y,
// coalesced, in natural order. C never reaches device memory, and the FFT
// does 5 n log2 n flop a row, not the reference's 4 n^2.
//
// The SIMT route (any n <= 1024, where 64 rows of n do not fit): one block of
// 256 threads takes 16 rows, stages them in shared memory (16 x k), and thread
// t sums the columns t, t + 256, ... of its 16 rows in f32 FMA over k,
// reading A by broadcast float4 loads and its own column of B from device
// memory (shared with the other blocks through L2); epilogue(C) goes to the
// rows the passes read, and the same passes follow. Shared memory 64 k + 68
// (2 lp.ld + 1) bytes, 209 KB at k = n = 1024.
//
// The plan: a power-of-two n >= 4 takes 16 points a thread (radices 16, then
// 8, 4 or 2), any other n 32 (also radix 3 and 5 passes, a direct pass for
// each larger prime factor, and a copy first where the plan opens with a
// direct pass or has none): 32, not the four-step kernel's 64, so that the
// passes fit the tensor-core route's 168 registers a thread. Twiddles come
// from the root table (two loads a butterfly).

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "hopper_ring.cuh"
#include "stockham_passes.cuh"

namespace {

using namespace tml_ring;
using tml_stockham::Launch;
using tml_stockham::Pass;
using tml_stockham::Row;
using tml_stockham::kPointsPow2;
using tml_stockham::ilog2;
using tml_stockham::register_radix;

constexpr int kMaxDim = 1024;        // the most k and n may be
constexpr int kPointsMixed = 32;     // points a thread for any n that is not a power of two >= 4
constexpr int kSmemMax = 232448;     // the shared memory a block may use on sm_90

// the tensor-core route
constexpr int kTcMaxN = 256;                                  // columns: two consumers of 128
constexpr int kTcBM = 64;                                     // rows of A a block
constexpr int kTcBN = 256;                                    // B^T's rows a stage
constexpr int kTcStages = 3;
constexpr uint32_t kTcABytes = kTcBM * kRowBytes;             // A's 64 x 32 f32, 8 KB
constexpr uint32_t kTcPlaneBytes = kTcBN * kRowBytes;         // one plane of B^T's 256 x 32, 32 KB
constexpr uint32_t kTcStageBytes = kTcABytes + 2 * kTcPlaneBytes;   // 72 KB
constexpr int kTcConsumers = 256;                             // two warpgroups, then the producer's
constexpr int kTcThreads = kTcConsumers + 128;
constexpr int kTcSmem = kTcStages * static_cast<int>(kTcStageBytes) + 1024;

// the SIMT route
constexpr int kSimtBM = 16;
constexpr int kSimtThreads = 256;

__device__ __forceinline__ float epilogue(float c, int act) {
  if (act == kRelu) return relu(c);
  if (act == kGelu) return gelu(c);
  return c;
}

// Floats of one row of C in shared memory: its real plane, its imaginary
// plane (lp.ld each) and one float between rows.
__host__ __device__ inline int row_floats(const Launch& lp) { return 2 * lp.ld + 1; }

// The FFTs of the block's bm rows of C (row r's planes at c + r * row_floats,
// each entry at the family's smem_index), written to rows row0 + r < m of
// (yr, yi). Every thread of the block runs every pass: blockDim.x /
// lp.threads rows a group, the groups in turn; a thread past the block's
// rows works on `spare`, whose results are never stored.
template <int P>
__device__ __forceinline__ void row_ffts(const Launch& lp, float* c, int bm, int64_t row0, int64_t m,
                                         float* __restrict__ yr, float* __restrict__ yi,
                                         const float2* __restrict__ tab) {
  using namespace tml_stockham;
  const int group = blockDim.x / lp.threads, sub = threadIdx.x / lp.threads;
  float* spare = c + bm * row_floats(lp);
  const float* none = nullptr;   // the first pass reads C from shared memory, not x
  for (int g0 = 0; g0 < bm; g0 += group) {
    const int r = g0 + sub;
    const bool mine = sub < group && r < bm;
    Row w;
    w.t = threadIdx.x - sub * lp.threads;
    w.live = mine && row0 + r < m;
    w.off = w.out = (w.live ? row0 + r : 0) * lp.n;
    w.sr = mine ? c + r * row_floats(lp) : spare;
    for (int p = 0; p < lp.npasses; ++p) {
      const Pass ps = lp.pass[p];
      const bool last = p + 1 == lp.npasses;
      switch (ps.radix) {
        case 2: radix_pass<2, P>(lp, ps, w, false, last, none, none, yr, yi, tab); break;
        case 4: radix_pass<4, P>(lp, ps, w, false, last, none, none, yr, yi, tab); break;
        case 8: radix_pass<8, P>(lp, ps, w, false, last, none, none, yr, yi, tab); break;
        case 16: radix_pass<16, P>(lp, ps, w, false, last, none, none, yr, yi, tab); break;
        default:
          if constexpr (P != kPointsPow2) {
            if (ps.radix == 1) radix_pass<1, P>(lp, ps, w, false, last, none, none, yr, yi, tab);
            else if (ps.radix == 3) radix_pass<3, P>(lp, ps, w, false, last, none, none, yr, yi, tab);
            else if (ps.radix == 5) radix_pass<5, P>(lp, ps, w, false, last, none, none, yr, yi, tab);
            else direct_pass<P>(lp, ps, w, last, yr, yi, tab);
          }
      }
    }
  }
}

// epilogue(v) and a zero imaginary part to column col of C's row `row`.
template <int P>
__device__ __forceinline__ void put_c(const Launch& lp, float* c, int row, int col, float v, int act) {
  float* sr = c + row * row_floats(lp);
  const int s = tml_stockham::smem_index<P == kPointsPow2>(col);
  sr[s] = epilogue(v, act);
  sr[lp.ld + s] = 0.f;
}

template <int P>
__global__ void __launch_bounds__(kTcThreads, 1)
gemm_fft_tc_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_bh,
                   const __grid_constant__ CUtensorMap map_bl, const __grid_constant__ Launch lp,
                   float* __restrict__ yr, float* __restrict__ yi, const float2* __restrict__ tab,
                   int64_t m, int k, int act) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kTcStages], empty[kTcStages];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle repeats every 1024 bytes
  float* c = reinterpret_cast<float*>(smem_raw + (ring - smem_u32(smem_raw)));
  const int nk = (k + kBK32 - 1) / kBK32;
  const int64_t m0 = int64_t(blockIdx.x) * kTcBM;
  init_ring(full, empty);

  float acc[64];   // consumer cg's 64 x 128: columns 128 cg ..
  const int cg = threadIdx.x / 128;
  if (threadIdx.x >= kTcConsumers) {   // the producer warpgroup; it joins the passes after
    if (threadIdx.x == kTcConsumers) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % kTcStages, k0 = kb * kBK32;
        const uint32_t bar = smem_u32(&full[s]), sa = ring + s * kTcStageBytes;
        mbar_wait(smem_u32(&empty[s]), ((kb / kTcStages) & 1) ^ 1);   // the first round passes
        mbar_expect_tx(bar, kTcStageBytes);
        tma_load(sa, &map_a, k0, static_cast<int>(m0), 0, bar);
        tma_load(sa + kTcABytes, &map_bh, k0, 0, 0, bar);
        tma_load(sa + kTcABytes + kTcPlaneBytes, &map_bl, k0, 0, 0, bar);
      }
    }
  } else {
    float part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % kTcStages;
      const uint32_t sa = ring + s * kTcStageBytes, sb = sa + kTcABytes + cg * 128 * kRowBytes;
      mbar_wait(smem_u32(&full[s]), (kb / kTcStages) & 1);
      stage_tf32x3_at(part, sa, sb, sb + kTcPlaneBytes);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fold(acc, part);
      if (threadIdx.x % 32 == 0) mbar_arrive(smem_u32(&empty[s]));
    }
  }
  __syncthreads();   // every product done and every load landed: the ring holds C now
  if (threadIdx.x < kTcConsumers) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int2 rc = frag_pos(i);
      const int col = cg * 128 + rc.y;
      if (col < lp.n) put_c<P>(lp, c, rc.x, col, acc[i], act);
    }
  }
  __syncthreads();
  row_ffts<P>(lp, c, kTcBM, m0, m, yr, yi, tab);
}

template <int P>
__global__ void __launch_bounds__(kSimtThreads)
gemm_fft_simt_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const __grid_constant__ Launch lp, float* __restrict__ yr,
                     float* __restrict__ yi, const float2* __restrict__ tab, int64_t m, int k, int act) {
  extern __shared__ float4 smem4[];
  const int kpad = (k + 3) & ~3, n = lp.n;
  float* a_s = reinterpret_cast<float*>(smem4);   // (kSimtBM, kpad)
  float* c = a_s + kSimtBM * kpad;                // kSimtBM + 1 rows of row_floats
  const int64_t row0 = int64_t(blockIdx.x) * kSimtBM;
  for (int e = threadIdx.x; e < kSimtBM * kpad; e += kSimtThreads) {
    const int r = e / kpad, kk = e - r * kpad;
    a_s[e] = row0 + r < m && kk < k ? a[(row0 + r) * k + kk] : 0.f;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kSimtThreads) {
    float acc[kSimtBM] = {};
    for (int kk = 0; kk < kpad; kk += 4) {
      float bv[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) bv[t] = kk + t < k ? b[(kk + t) * n + j] : 0.f;
#pragma unroll
      for (int r = 0; r < kSimtBM; ++r) {
        const float4 av = *reinterpret_cast<const float4*>(a_s + r * kpad + kk);
        acc[r] = fmaf(av.x, bv[0], acc[r]);
        acc[r] = fmaf(av.y, bv[1], acc[r]);
        acc[r] = fmaf(av.z, bv[2], acc[r]);
        acc[r] = fmaf(av.w, bv[3], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kSimtBM; ++r) put_c<P>(lp, c, r, j, acc[r], act);
  }
  __syncthreads();
  row_ffts<P>(lp, c, kSimtBM, row0, m, yr, yi, tab);
}

// Reads the plan words (n, threads, points, npasses, radices...) for rows of
// n points whose blocks have block_threads threads. False where they do not
// describe passes the kernels run: a copy pass is put first where the plan
// opens with a direct pass or has none (fft_four_step.cu's rule).
bool parse_plan(const int32_t* words, int64_t count, int n, int block_threads, Launch& lp) {
  lp = Launch{};
  if (words == nullptr || count < 4 || words[0] != n) return false;
  const int threads = words[1], points = words[2], np = words[3];
  const bool pow2 = n >= 4 && (n & (n - 1)) == 0;
  if (points != (pow2 ? kPointsPow2 : kPointsMixed) || np < 0 || np >= tml_stockham::kMaxPasses ||
      count != 4 + np || threads < 1 || threads > block_threads || int64_t(threads) * points < n)
    return false;
  lp.n = lp.len = n;
  lp.lanes = 1;
  lp.log_len = ilog2(n);
  lp.threads = threads;
  lp.points = points;
  lp.ld = (n + n / 32 + 1 + 31) / 32 * 32;
  int p = 0, ns = 1;
  if (np == 0 || !register_radix(words[4])) {
    if (pow2) return false;
    lp.pass[p++] = Pass{1, 1, n};
  }
  for (int i = 0; i < np; ++i) {
    const int r = words[4 + i];
    if (r < 2 || int64_t(ns) * r > n || n % (ns * r) != 0) return false;
    if (pow2 && r != 2 && r != 4 && r != 8 && r != 16) return false;
    lp.pass[p++] = Pass{r, ns, n / (ns * r)};
    ns *= r;
  }
  if (ns != n) return false;
  lp.npasses = p;
  return true;
}

bool aligned16(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; }

constexpr int kSplitTranspose = 1;   // tml_split_tf32's flag

template <int P>
cudaError_t launch_tc(const CUtensorMap (&maps)[3], const Launch& lp, float* yr, float* yi,
                      const float2* tab, int64_t m, int k, int act, cudaStream_t s) {
  static std::atomic<uint64_t> raised{0};
  auto* kernel = gemm_fft_tc_kernel<P>;
  const cudaError_t e = raise_smem_once(reinterpret_cast<const void*>(kernel), kTcSmem, raised);
  if (e != cudaSuccess) return e;
  const int64_t blocks = (m + kTcBM - 1) / kTcBM;
  kernel<<<static_cast<unsigned>(blocks), kTcThreads, kTcSmem, s>>>(maps[0], maps[1], maps[2], lp, yr,
                                                                   yi, tab, m, k, act);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_simt(const float* a, const float* b, const Launch& lp, float* yr, float* yi,
                        const float2* tab, int64_t m, int k, int act, cudaStream_t s) {
  static std::atomic<uint64_t> raised{0};
  auto* kernel = gemm_fft_simt_kernel<P>;
  const size_t smem = sizeof(float) * (kSimtBM * ((k + 3) & ~3) + (kSimtBM + 1) * row_floats(lp));
  if (smem > size_t(kSmemMax)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = raise_smem_once(reinterpret_cast<const void*>(kernel), kSmemMax, raised);
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks = (m + kSimtBM - 1) / kSimtBM;
  kernel<<<static_cast<unsigned>(blocks), kSimtThreads, smem, s>>>(a, b, lp, yr, yi, tab, m, k, act);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// gemm_tf32x3.cu's split pass (its contract there).
int tml_split_tf32(const float* x, int64_t ldx, float* hi, float* lo, int64_t ldo, int64_t rows,
                   int64_t cols, int flags, void* stream);

// a (m, k) f32 with row stride lda (a multiple of 4, 16-byte aligned: TMA's);
// b (k, n) f32 contiguous; bt_hi, bt_lo the caller's scratch for the TF32
// planes of B^T (n, k), row stride ldt (the same rule); k <= 1024, 1 <= n <=
// 256; tab the n forward roots (n, 2) f32; plan, plan_len the row FFT's words.
// Writes the planes (where k > 0), then yr and yi (m, n) f32, contiguous. act:
// 1 relu, 2 gelu, else none. Launches on `stream`; returns 0, or a CUDA
// error: cudaErrorInvalidValue for an argument it does not take,
// cudaErrorSymbolNotFound where the driver has no tensor-map encoder,
// cudaErrorInvalidPitchValue where it refuses a map.
int tml_gemm_fft(const float* a, int64_t lda, const float* b, float* bt_hi, float* bt_lo, int64_t ldt,
                 const void* tab, const int32_t* plan, int64_t plan_len, void* yr, void* yi, int64_t m,
                 int64_t k, int64_t n, int act, void* stream) {
  Launch lp;
  if (a == nullptr || b == nullptr || bt_hi == nullptr || bt_lo == nullptr || tab == nullptr ||
      yr == nullptr || yi == nullptr || m < 0 || m > 0x7fffffffLL || k < 0 || k > kMaxDim || n < 1 ||
      n > kTcMaxN || lda < k || ldt < k || lda % 4 || ldt % 4 || !aligned16(a) ||
      !aligned16(bt_hi) || !aligned16(bt_lo) ||
      !parse_plan(plan, plan_len, static_cast<int>(n), kTcThreads, lp) ||
      (kTcBM + 1) * row_floats(lp) * 4 > kTcStages * static_cast<int>(kTcStageBytes))
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  CUtensorMap maps[3] = {};   // unread when k == 0: no stage is loaded
  if (k > 0) {
    const int split = tml_split_tf32(b, n, bt_hi, bt_lo, ldt, k, n, kSplitTranspose, stream);
    if (split != cudaSuccess) return split;
    if (!encode_tiled()) return cudaErrorSymbolNotFound;
    const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    if (encode(&maps[0], f32, a, k, m, lda, 1, 0, false, kBK32, kTcBM, 4) != CUDA_SUCCESS ||
        encode(&maps[1], f32, bt_hi, k, n, ldt, 1, 0, false, kBK32, kTcBN, 4) != CUDA_SUCCESS ||
        encode(&maps[2], f32, bt_lo, k, n, ldt, 1, 0, false, kBK32, kTcBN, 4) != CUDA_SUCCESS)
      return cudaErrorInvalidPitchValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* y_re = static_cast<float*>(yr);
  float* y_im = static_cast<float*>(yi);
  const float2* roots = static_cast<const float2*>(tab);
  const int kk = static_cast<int>(k);
  return lp.points == kPointsPow2 ? launch_tc<kPointsPow2>(maps, lp, y_re, y_im, roots, m, kk, act, s)
                                  : launch_tc<kPointsMixed>(maps, lp, y_re, y_im, roots, m, kk, act, s);
}

// a (m, k), b (k, n), f32 contiguous; k <= 1024, 1 <= n <= 1024; tab, plan as
// for tml_gemm_fft. Writes yr and yi (m, n) f32. Returns 0 or a CUDA error
// (cudaErrorInvalidValue for an argument it does not take).
int tml_gemm_fft_simt(const float* a, const float* b, const void* tab, const int32_t* plan,
                      int64_t plan_len, void* yr, void* yi, int64_t m, int64_t k, int64_t n, int act,
                      void* stream) {
  Launch lp;
  if (a == nullptr || b == nullptr || tab == nullptr || yr == nullptr || yi == nullptr || m < 0 ||
      m > 0x7fffffffLL * kSimtBM || k < 0 || k > kMaxDim || n < 1 || n > kMaxDim ||
      !parse_plan(plan, plan_len, static_cast<int>(n), kSimtThreads, lp))
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* y_re = static_cast<float*>(yr);
  float* y_im = static_cast<float*>(yi);
  const float2* roots = static_cast<const float2*>(tab);
  const int kk = static_cast<int>(k);
  return lp.points == kPointsPow2
             ? launch_simt<kPointsPow2>(a, b, lp, y_re, y_im, roots, m, kk, act, s)
             : launch_simt<kPointsMixed>(a, b, lp, y_re, y_im, roots, m, kk, act, s);
}

}  // extern "C"
