// The fused GEMM -> row FFT of the MathDx tier, for Hopper (sm_90a):
//
//   tml_gemm_fft: for f32 A (m, k), B (k, n), n, k <= 1024, and the forward
//                 n-point DFT matrix (Wr, Wi) (n, n), C = epilogue(A B) and
//                 (yr, yi) = (C Wr, C Wi), f32 (m, n): the FFT of each row of C,
//                 as DFT products (W is symmetric, so FFT over rows = C W).
//
// Replaces the TPU kernel of tpumathlib/dx/fused.py: gemm_fft's pallas_call
// (:70, kernel body :54), which keeps the (bm, n) product tile in VMEM
// through the epilogue and both DFT matmuls. tpumathlib_torch/dx/fused.py
// holds the wrapper and the plain PyTorch version (_gemm_fft_plain).
//
// The epilogue codes: 1 is max(c, 0), a NaN kept as jnp.maximum keeps it; 2 is
// 0.5 c (1 + tanh(0.7978845608028654 (c + 0.044715 c c c))); anything else is
// none, as the reference ignores every other string (ROADMAP C14).
//
// One block of 256 threads takes 16 rows of A. It stages them in shared memory
// (16 x k, zero past m), then builds C = A B for its rows in shared memory (16 x
// n): thread t owns columns t, t + 256, ..., and for each sums 16 rows in f32
// FMA over k, reading A's rows as broadcast float4 loads and its own column
// of B from device memory (no other thread of the block reads it, so staging
// it in shared memory would buy nothing; the blocks share B through L2). The
// epilogue is applied as C is written. After a barrier the same mapping
// computes C Wr and C Wi, 32 sums a column, and writes them out. C never
// reaches device memory. Shared memory is 64 (k + n) bytes, 128 KB at
// k = n = 1024.
//
// What bounds the function: the product's 2 m k n flop and an FFT's 5 n log2 n
// a row, 4.6 GFLOP at m = 32768, k = n = 256, 0.069 ms at 67 TFLOP/s; its bytes
// (A and B read, Y written) take 0.030 ms. This kernel does the row FFT as two
// DFT products, 4 m n^2 flop, 4 n / (5 log2 n) = 25.6 times an FFT's work at
// n = 256: 12.9 GFLOP in all. Each block reads B, Wr and Wi once from L2
// (768 KB at n = 256), and each 4-step of k issues 64 (C) or 128 (Y) FMA a
// thread for 16 broadcast shared-memory loads and 4 or 8 loads from L2.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kBM = 16;        // rows of A a block
constexpr int kThreads = 256;  // columns a pass of the block
constexpr int kMaxDim = 1024;  // the most k and n may be

__device__ __forceinline__ float epilogue(float c, int act) {
  if (act == 1) return c < 0.f ? 0.f : c;
  if (act == 2) return 0.5f * c * (1.f + tanhf(0.7978845608028654f * (c + 0.044715f * c * c * c)));
  return c;
}

__device__ __forceinline__ float lane_of(const float4& v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads)
gemm_fft_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ wr, const float* __restrict__ wi, float* __restrict__ yr,
                float* __restrict__ yi, int64_t m, int k, int n, int act) {
  extern __shared__ float4 smem4[];
  const int kpad = (k + 3) & ~3, npad = (n + 3) & ~3;
  float* a_s = reinterpret_cast<float*>(smem4);   // (kBM, kpad)
  float* c_s = a_s + kBM * kpad;                  // (kBM, npad)
  const int64_t row0 = int64_t(blockIdx.x) * kBM;
  for (int e = threadIdx.x; e < kBM * kpad; e += kThreads) {
    const int r = e / kpad, kk = e - r * kpad;
    a_s[e] = row0 + r < m && kk < k ? a[(row0 + r) * k + kk] : 0.f;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < npad; j += kThreads) {
    float acc[kBM] = {};
    if (j < n) {
      for (int kk = 0; kk < kpad; kk += 4) {
        float bv[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) bv[t] = kk + t < k ? b[(kk + t) * n + j] : 0.f;
#pragma unroll
        for (int r = 0; r < kBM; ++r) {
          const float4 av = *reinterpret_cast<const float4*>(a_s + r * kpad + kk);
#pragma unroll
          for (int t = 0; t < 4; ++t) acc[r] = fmaf(lane_of(av, t), bv[t], acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kBM; ++r) c_s[r * npad + j] = j < n ? epilogue(acc[r], act) : 0.f;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kThreads) {
    float sr[kBM] = {}, si[kBM] = {};
    for (int kk = 0; kk < npad; kk += 4) {
      float vr[4], vi[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const bool in = kk + t < n;
        vr[t] = in ? wr[(kk + t) * n + j] : 0.f;
        vi[t] = in ? wi[(kk + t) * n + j] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kBM; ++r) {
        const float4 cv = *reinterpret_cast<const float4*>(c_s + r * npad + kk);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          sr[r] = fmaf(lane_of(cv, t), vr[t], sr[r]);
          si[r] = fmaf(lane_of(cv, t), vi[t], si[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kBM; ++r) {
      if (row0 + r < m) {
        yr[(row0 + r) * n + j] = sr[r];
        yi[(row0 + r) * n + j] = si[r];
      }
    }
  }
}

// Lets gemm_fft_kernel take the shared memory of k = n = 1024. The attribute
// is kept per function and device, so it is set once a device (one bit each).
cudaError_t allow_max_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(gemm_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(sizeof(float) * kBM * (kMaxDim + kMaxDim)));
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

}  // namespace

extern "C" {

// a (m, k), b (k, n), wr and wi (n, n), all f32 contiguous; n, k <= 1024.
// Writes yr and yi (m, n) f32. act: 1 relu, 2 gelu, else none. Launches on
// `stream`; returns the CUDA status (0 on success).
int tml_gemm_fft(const void* a, const void* b, const void* wr, const void* wi, void* yr, void* yi,
                 int64_t m, int64_t k, int64_t n, int act, void* stream) {
  if (a == nullptr || b == nullptr || wr == nullptr || wi == nullptr || yr == nullptr ||
      yi == nullptr || m < 0 || k < 0 || k > kMaxDim || n < 0 || n > kMaxDim)
    return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  const int64_t blocks = (m + kBM - 1) / kBM;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kBM * (((k + 3) & ~3) + ((n + 3) & ~3));
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_max_smem();
    if (e != cudaSuccess) return e;
  }
  gemm_fft_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const float*>(wr),
      static_cast<const float*>(wi), static_cast<float*>(yr), static_cast<float*>(yi), m,
      static_cast<int>(k), static_cast<int>(n), act);
  return cudaGetLastError();
}

}  // extern "C"
