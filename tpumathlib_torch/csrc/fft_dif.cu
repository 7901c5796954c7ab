// Planar complex-to-complex FFT over the last axis, for Hopper (sm_90a):
//
//   tml_dif_fft: (yr, yi) = DFT(xr + i xi) of every row of a (rows, N) pair
//                of f32 or bf16 planes, N a power of two >= 256, unnormalised
//                in both directions (the sign of the twiddle table picks the
//                direction), written in natural or in the reference's raw
//                order.
//
// Replaces the TPU kernel tpumathlib/fft/stockham.py::dif_fft (:335; body
// _pipeline_kernel :265 and _fft_chunk :191, pallas_call :382).
// tpumathlib_torch/fft/stockham.py::dif_fft is its wrapper.
//
// What bounds it: an FFT does 5 N log2 N flops for 8 N bytes of f32 planes
// read and written, so on this card it is bound by device memory: one read
// and one write of the planes at 3.35 TB/s is 0.080 ms for 4096 rows of
// N = 4096 in f32, 0.040 ms in bf16 planes; the flops (1.0e9 at 67 TFLOP/s
// f32) take 0.015 ms. Design: each row (or, above N = 16384, each 16384-long
// segment) is transformed by one thread block in shared memory, so the
// planes cross device memory once each way. The log2 N radix-2
// decimation-in-frequency stages run in passes of up to four stages: a
// thread holds 16 elements in registers for a pass, so shared memory is read
// and written once per four stages. The first pass reads device memory
// straight into registers; the output is gathered from shared memory and
// written in the order asked for, coalesced, with no separate permutation
// pass (the reference's gather epilogue works around the TPU's lane layout).
// Shared-memory indices are padded (pad()) so that the strided accesses of
// the late passes and the bit-reversed gather hit distinct banks.
//
// The arithmetic: stage s with half-size H maps a pair (a, b) = (x[j],
// x[j + H]) with j mod 2H < H to (a + b, (a - b) w^(j mod 2H)), w =
// exp(-+2 pi i / 2H), as the reference's stage A does; the twiddles come from
// a table of N/2 values exp(-+2 pi i k / N), built in float64 and rounded to
// f32 by the wrapper. After all stages element j holds X[bitrev(j)]. The
// reference stops its radix-2 stages at groups of L = 128 collapse and does
// one L-point DFT per group instead, so its raw order puts frequency
// f = p G + r (G = N / L) at bitrev_s(r) L + p (shuffle_perm); that is
// element (bitrev_s(r) L + bitrev_logL(p)) here, so raw position
// (g, p) reads element g L + bitrev_logL(p). Natural order is raw order with
// L = N.
//
// Above N = 16384 the first log2(N / 16384) stages run as passes over device
// memory into an f32 complex scratch buffer (global_pass); after them each
// contiguous 16384-long segment is an independent transform, done in shared
// memory as above, and each segment's block writes the output positions whose
// values it holds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLogSeg = 14;  // 16384 complex f32 = 128 KB of shared memory
constexpr int kMaxRadixLog = 4; // 16 elements a thread per pass
constexpr int kPassThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// bits-wide bit reversal of x (0 for bits == 0)
__device__ __forceinline__ int brev(int x, int bits) {
  return bits ? static_cast<int>(__brev(static_cast<unsigned>(x)) >> (32 - bits)) : 0;
}

// padded shared-memory index of element i of a segment of 2^log_s elements
__device__ __forceinline__ int pad(int i, int log_s) { return i + (i >> 4) + (i >> (log_s - 5)); }

// R radix-2 DIF stages on e[t] = x[k + t h], k mod (2^R h) = k0 < h = 2^log_h;
// stage s pairs t with t + T, T = 2^(R-1-s), half-size H = T h, and the
// twiddle of offset k0 + (t mod T) h in the span 2H is tw[offset * N / 2H].
template <int R>
__device__ __forceinline__ void butterflies(float2 (&e)[1 << R], int k0, int log_h, int log_n,
                                            const float2* __restrict__ tw) {
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int T = 1 << (R - 1 - s);
    const int shift = log_n - 1 - log_h - (R - 1 - s);
#pragma unroll
    for (int t = 0; t < (1 << R); ++t) {
      if (t & T) continue;
      const float2 a = e[t], b = e[t + T];
      const float2 w = __ldg(tw + ((k0 + ((t & (T - 1)) << log_h)) << shift));
      const float dr = a.x - b.x, di = a.y - b.y;
      e[t] = make_float2(a.x + b.x, a.y + b.y);
      e[t + T] = make_float2(dr * w.x - di * w.y, dr * w.y + di * w.x);
    }
  }
}

// One pass of R stages over the segment held in shared memory (or, for the
// first pass, read from device memory at `src`: the planes, or the scratch
// buffer when `scratch` is set).
template <int R, typename P>
__device__ void segment_pass(float2* sm, int log_s, int log_h, int log_n, bool first,
                             const P* xr, const P* xi, const float2* scratch, int64_t base,
                             const float2* __restrict__ tw) {
  const int groups = 1 << (log_s - R);
  const int h = 1 << log_h;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int k0 = g & (h - 1);
    const int k = ((g >> log_h) << (log_h + R)) + k0;
    float2 e[1 << R];
#pragma unroll
    for (int t = 0; t < (1 << R); ++t) {
      const int idx = k + (t << log_h);
      if (!first) {
        e[t] = sm[pad(idx, log_s)];
      } else if (scratch) {
        e[t] = scratch[base + idx];
      } else {
        e[t] = make_float2(to_f32(xr[base + idx]), to_f32(xi[base + idx]));
      }
    }
    butterflies<R>(e, k0, log_h, log_n, tw);
#pragma unroll
    for (int t = 0; t < (1 << R); ++t) sm[pad(k + (t << log_h), log_s)] = e[t];
  }
  __syncthreads();
}

// One block per segment of 2^log_s elements of a row: the remaining log_s
// stages in shared memory, then the gather into natural (log_l == log_n) or
// raw order (L = 2^log_l).
template <typename P>
__global__ void __launch_bounds__(1024)
segment_kernel(const P* xr, const P* xi, const float2* scratch, P* yr, P* yi,
               const float2* __restrict__ tw, int log_n, int log_s, int log_l) {
  extern __shared__ float2 sm[];
  const int log_seg = log_n - log_s;  // segments per row, log2
  const int64_t row = blockIdx.x >> log_seg;
  const int seg = blockIdx.x & ((1 << log_seg) - 1);
  const int64_t rbase = row << log_n;
  const int64_t base = rbase + (static_cast<int64_t>(seg) << log_s);

  bool first = true;
  for (int done = 0; done < log_s;) {
    const int passes_left = (log_s - done + kMaxRadixLog - 1) / kMaxRadixLog;
    const int r = (log_s - done + passes_left - 1) / passes_left;
    const int log_h = log_s - done - r;
    switch (r) {
      case 4: segment_pass<4>(sm, log_s, log_h, log_n, first, xr, xi, scratch, base, tw); break;
      case 3: segment_pass<3>(sm, log_s, log_h, log_n, first, xr, xi, scratch, base, tw); break;
      case 2: segment_pass<2>(sm, log_s, log_h, log_n, first, xr, xi, scratch, base, tw); break;
      default: segment_pass<1>(sm, log_s, log_h, log_n, first, xr, xi, scratch, base, tw); break;
    }
    first = false;
    done += r;
  }

  const int s = 1 << log_s;
  for (int u = threadIdx.x; u < s; u += blockDim.x) {
    int64_t pos;
    int q;
    if (log_l >= log_s) {  // a group of L spans 2^c segments; this one holds p = brev_c(v) + 2^c u
      const int c = log_l - log_s;
      const int v = seg & ((1 << c) - 1);
      pos = (static_cast<int64_t>(seg >> c) << log_l) + brev(v, c) + (static_cast<int64_t>(u) << c);
      q = brev(u, log_s);
    } else {  // the segment holds whole groups of L
      const int l = 1 << log_l;
      pos = (static_cast<int64_t>(seg) << log_s) + u;
      q = (u & ~(l - 1)) | brev(u & (l - 1), log_l);
    }
    const float2 v = sm[pad(q, log_s)];
    store(yr + rbase + pos, v.x);
    store(yi + rbase + pos, v.y);
  }
}

// R stages [s0, s0 + R) over whole rows in device memory, one group of 2^R
// elements a thread, into the f32 complex scratch buffer (in place after the
// first pass, which reads the planes).
template <int R, typename P>
__global__ void __launch_bounds__(kPassThreads)
global_pass(const P* xr, const P* xi, float2* scratch, const float2* __restrict__ tw,
            int64_t rows, int log_n, int s0) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int log_groups = log_n - R;
  if (g >= (rows << log_groups)) return;
  const int64_t base = (g >> log_groups) << log_n;
  const int gl = static_cast<int>(g & ((int64_t{1} << log_groups) - 1));
  const int log_h = log_n - s0 - R;
  const int k0 = gl & ((1 << log_h) - 1);
  const int k = ((gl >> log_h) << (log_h + R)) + k0;
  float2 e[1 << R];
#pragma unroll
  for (int t = 0; t < (1 << R); ++t) {
    const int64_t idx = base + k + (t << log_h);
    e[t] = s0 == 0 ? make_float2(to_f32(xr[idx]), to_f32(xi[idx])) : scratch[idx];
  }
  butterflies<R>(e, k0, log_h, log_n, tw);
#pragma unroll
  for (int t = 0; t < (1 << R); ++t) scratch[base + k + (t << log_h)] = e[t];
}

template <int R, typename P>
cudaError_t launch_global_pass(const P* xr, const P* xi, float2* scratch, const float2* tw,
                               int64_t rows, int log_n, int s0, cudaStream_t stream) {
  const int64_t threads = rows << (log_n - R);
  const int64_t blocks = (threads + kPassThreads - 1) / kPassThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  global_pass<R, P><<<static_cast<unsigned>(blocks), kPassThreads, 0, stream>>>(
      xr, xi, scratch, tw, rows, log_n, s0);
  return cudaGetLastError();
}

template <typename P>
cudaError_t run(const P* xr, const P* xi, P* yr, P* yi, float2* scratch, const float2* tw,
                int64_t rows, int log_n, int log_l, cudaStream_t stream) {
  const int log_s = log_n < kMaxLogSeg ? log_n : kMaxLogSeg;
  const int e = log_n - log_s;
  if (e > 0 && scratch == nullptr) return cudaErrorInvalidValue;
  for (int s0 = 0; s0 < e;) {
    const int r = e - s0 < kMaxRadixLog ? e - s0 : kMaxRadixLog;
    cudaError_t err;
    switch (r) {
      case 4: err = launch_global_pass<4>(xr, xi, scratch, tw, rows, log_n, s0, stream); break;
      case 3: err = launch_global_pass<3>(xr, xi, scratch, tw, rows, log_n, s0, stream); break;
      case 2: err = launch_global_pass<2>(xr, xi, scratch, tw, rows, log_n, s0, stream); break;
      default: err = launch_global_pass<1>(xr, xi, scratch, tw, rows, log_n, s0, stream); break;
    }
    if (err != cudaSuccess) return err;
    s0 += r;
  }
  const int64_t blocks = rows << e;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const int s = 1 << log_s;
  const int threads = s >> kMaxRadixLog < 32 ? 32 : s >> kMaxRadixLog;
  const size_t smem = sizeof(float2) * (s + (s >> 4) + 32);
  cudaError_t err = cudaFuncSetAttribute(segment_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  segment_kernel<P><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      xr, xi, e > 0 ? scratch : nullptr, yr, yi, tw, log_n, log_s, log_l);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xr, xi: (rows, 2^log_n) contiguous planes, f32 (bf16 == 0) or bf16; yr, yi:
// fresh outputs of the same type and shape (never the inputs); tw: 2^(log_n-1)
// f32 complex twiddles exp(-+2 pi i k / N), interleaved (re, im); scratch:
// rows x N f32 complex, needed only when N > 16384 (else may be null).
// log_l = log_n gives natural order, 7 <= log_l < log_n the raw order of
// groups of L = 2^log_l. Launches on `stream` and returns cudaGetLastError().
int tml_dif_fft(const void* xr, const void* xi, void* yr, void* yi, void* scratch, const void* tw,
                int64_t rows, int log_n, int log_l, int bf16, void* stream) {
  if (log_n < 8 || log_n > 30 || log_l < 7 || log_l > log_n || rows < 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<float2*>(scratch);
  auto t = static_cast<const float2*>(tw);
  if (bf16) {
    return run(static_cast<const __nv_bfloat16*>(xr), static_cast<const __nv_bfloat16*>(xi),
               static_cast<__nv_bfloat16*>(yr), static_cast<__nv_bfloat16*>(yi), sc, t, rows,
               log_n, log_l, st);
  }
  return run(static_cast<const float*>(xr), static_cast<const float*>(xi), static_cast<float*>(yr),
             static_cast<float*>(yi), sc, t, rows, log_n, log_l, st);
}

}  // extern "C"
