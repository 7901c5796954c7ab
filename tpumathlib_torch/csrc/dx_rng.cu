// The in-kernel random numbers of the cuRANDDx tier, for Hopper (sm_90a):
//
//   tml_random_uniform: out[w] = ((word w & 0xFFFFFF) + 1) * 2^-24, f32 on
//                       (0, 1], for w < n;
//   tml_dropout_matmul: out = where(u > rate, (A B) / (1 - rate), 0), f32
//                       (m, n), the product of f32 or bf16 A (m, k) and B
//                       (k, n) summed in f32, u the uniforms of
//                       tml_random_uniform over the flat (m, n) output.
//
// Replace the TPU kernels of tpumathlib/dx/rng.py: random_uniform_kernel's
// pallas_call (:44) and dropout_matmul_kernel's (:70), which seed the TPU's
// own PRNG. No card reproduces those bits. The stream here is
// Philox4x32-10, the generator of cuRAND and cuRANDDx, drawn as the port's
// rand.PhiloxGenerator(seed) draws it: word w of the flat output is word
// w % 4 of the block with counter (w / 4 low word, high word, 0, 0) and key
// (seed low word, seed high word). Those words are mapped to uniforms as the
// TPU kernel maps its bits (_uniform_from_bits, :21-25); the map is exact in
// f32. The dropout kernel draws the same words for the same (seed, m, n), so
// its mask is exactly tml_random_uniform(seed, m * n) > rate.
// tpumathlib_torch/dx/rng.py holds the wrappers and the plain PyTorch
// versions.
//
// tml_random_uniform: one thread a Philox block, 4 outputs written as one
// 16-byte store. It writes 4 bytes an output and reads nothing; the ten
// rounds are two 32 x 32 -> 64 products, two three-way XORs and two key
// additions each. Which of the bytes (0.080 ms for 64 Mi outputs at
// 3.35 TB/s) or the integer pipes bound it is read from this kernel's SASS.
//
// tml_dropout_matmul: the product is computed here, as the TPU kernel
// computes jnp.dot in its body, by the SIMT main loop of simt_gemm.cuh that
// B1 (gemm_epilogue.cu) also runs: one 256-thread block a 128 x 128 tile of
// the output, a loop over k in steps of 8 (the TPU kernel holds the whole
// operands in VMEM; on this card the k loop takes its place), each thread
// summing an 8 x 8 block in f32 FMA (never TF32). The epilogue draws, for
// each run of 4 columns of a row, the one or two Philox blocks that hold
// their flat indices (any n, ragged edges masked), and keeps or drops each
// sum. What bounds it is the product's 2 m k n flop at the f32 rate (2.05 ms
// at 4096^3 and 67 TFLOP/s); the Philox work is m n / 4 to m n / 2 blocks,
// under 1 % of the flop there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "simt_gemm.cuh"

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

// Philox4x32-10 of the counter (block low word, block high word, 0, 0).
__device__ __forceinline__ uint4 philox(uint64_t block, uint32_t k0, uint32_t k1) {
  uint32_t c0 = static_cast<uint32_t>(block), c1 = static_cast<uint32_t>(block >> 32);
  uint32_t c2 = 0, c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  return make_uint4(c0, c1, c2, c3);
}

// ((w & 0xFFFFFF) + 1) * 2^-24: exact in f32, on (0, 1].
__device__ __forceinline__ float to_uniform(uint32_t w) {
  return __uint2float_rn((w & 0xFFFFFFu) + 1u) * (1.0f / 16777216.0f);
}

constexpr int kUniformThreads = 256;

__global__ void __launch_bounds__(kUniformThreads)
uniform_kernel(float* __restrict__ out, int64_t n, uint32_t k0, uint32_t k1) {
  const int64_t blk = int64_t(blockIdx.x) * kUniformThreads + threadIdx.x;
  const int64_t i = blk * 4;
  if (i >= n) return;
  const uint4 w = philox(static_cast<uint64_t>(blk), k0, k1);
  if (i + 4 <= n) {
    reinterpret_cast<float4*>(out)[blk] =
        make_float4(to_uniform(w.x), to_uniform(w.y), to_uniform(w.z), to_uniform(w.w));
  } else {
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (i + t < n) out[i + t] = to_uniform(ws[t]);
  }
}

constexpr int kBM = 128, kBN = 128, kBK = 8, kTM = 8, kTN = 8;
using DropoutTile = tml_simt::Tile<kBM, kBN, kBK, kTM, kTN>;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// ws[idx] for idx in 0..7 without a local-memory array: idx is known only at
// run time, so the word is selected.
__device__ __forceinline__ uint32_t pick(const uint32_t (&ws)[8], int idx) {
  uint32_t v = ws[0];
#pragma unroll
  for (int q = 1; q < 8; ++q) v = idx == q ? ws[q] : v;
  return v;
}

template <typename T>
__global__ void __launch_bounds__(DropoutTile::kThreads)
dropout_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ out,
                      int64_t m, int64_t k, int64_t n, uint32_t k0, uint32_t k1, float rate,
                      float den) {
  const int64_t m0 = int64_t(blockIdx.y) * kBM, n0 = int64_t(blockIdx.x) * kBN;
  float acc[kTM][kTN];
  tml_simt::mainloop<kBM, kBN, kBK, kTM, kTN>(
      acc, k,
      [&](int r, int64_t gk) {
        const int64_t gm = m0 + r;
        return gm < m && gk < k ? to_f32(a[gm * k + gk]) : 0.f;
      },
      [&](int64_t gk, int c) {
        const int64_t gn = n0 + c;
        return gk < k && gn < n ? to_f32(b[gk * n + gn]) : 0.f;
      });

  // epilogue: keep or drop each sum by the uniform of its flat index
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t gm = m0 + DropoutTile::row(i);
    if (gm >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t gn0 = n0 + DropoutTile::col(h * 4);   // 4 columns from here
      if (gn0 >= n) continue;
      const int64_t w0 = gm * n + gn0;
      const uint64_t blk = static_cast<uint64_t>(w0) >> 2;
      const int off = static_cast<int>(w0 & 3);
      const uint4 x = philox(blk, k0, k1);
      const uint4 y = off ? philox(blk + 1, k0, k1) : x;
      const uint32_t ws[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (gn0 + t >= n) break;
        const float u = to_uniform(pick(ws, off + t));
        out[w0 + t] = u > rate ? acc[i][h * 4 + t] / den : 0.f;
      }
    }
  }
}

template <typename T>
cudaError_t launch_dropout(const void* a, const void* b, float* out, int64_t m, int64_t k,
                           int64_t n, uint32_t k0, uint32_t k1, float rate, float den,
                           cudaStream_t stream) {
  const int64_t gx = (n + kBN - 1) / kBN, gy = (m + kBM - 1) / kBM;
  if (gx > 0x7fffffff || gy > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  dropout_matmul_kernel<T><<<grid, DropoutTile::kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), out, m, k, n, k0, k1, rate, den);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out: n f32, 16-byte aligned. key0, key1: the seed's low and high words.
// Launches on `stream`; returns the CUDA status (0 on success).
int tml_random_uniform(void* out, int64_t n, uint32_t key0, uint32_t key1, void* stream) {
  if (out == nullptr || n < 0 || (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int64_t blocks = ((n + 3) / 4 + kUniformThreads - 1) / kUniformThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  uniform_kernel<<<static_cast<unsigned>(blocks), kUniformThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(out), n, key0, key1);
  return cudaGetLastError();
}

// a (m, k), b (k, n) contiguous, both f32 (dtype 0) or both bf16 (dtype 1);
// out (m, n) f32. den is 1 - rate, rounded to f32 by the caller.
int tml_dropout_matmul(const void* a, const void* b, void* out, int64_t m, int64_t k, int64_t n,
                       uint32_t key0, uint32_t key1, float rate, float den, int dtype,
                       void* stream) {
  if (a == nullptr || b == nullptr || out == nullptr || m < 0 || k < 0 || n < 0)
    return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (dtype) {
    case 0: return launch_dropout<float>(a, b, o, m, k, n, key0, key1, rate, den, s);
    case 1: return launch_dropout<__nv_bfloat16>(a, b, o, m, k, n, key0, key1, rate, den, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
