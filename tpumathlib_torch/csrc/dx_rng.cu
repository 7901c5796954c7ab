// The in-kernel uniforms of the cuRANDDx tier, for Hopper (sm_90a):
//
//   tml_random_uniform: out[w] = ((word w & 0xFFFFFF) + 1) * 2^-24, f32 on
//                       (0, 1], for w < n.
//
// Replaces the TPU kernel of tpumathlib/dx/rng.py: random_uniform_kernel's
// pallas_call (:44), which seeds the TPU's own PRNG. No card reproduces
// those bits. The stream here is Philox4x32-10, the generator of cuRAND and
// cuRANDDx (philox.cuh, the one copy of it): word w of the flat output is
// word w % 4 of the block with counter (w / 4 low word, high word, 0, 0) and
// key (seed low word, seed high word), as the port's rand.PhiloxGenerator
// draws it, mapped to uniforms as the TPU kernel maps its bits
// (_uniform_from_bits, :21-25); the map is exact in f32. B10b's dropout
// (dropout_matmul_kernel, :70) is an epilogue of the 3xTF32 product in
// gemm_tf32x3.cu that draws the same words from the same header, so its
// mask is exactly tml_random_uniform(seed, m * n) > rate.
// tpumathlib_torch/dx/rng.py holds the wrappers and the plain PyTorch
// versions.
//
// One thread a Philox block, 4 outputs written as one 16-byte store. It
// writes 4 bytes an output and reads nothing; the ten rounds are two
// 32 x 32 -> 64 products, two three-way XORs and two key additions each.
// Which of the bytes (0.080 ms for 64 Mi outputs at 3.35 TB/s) or the
// integer pipes bound it is read from this kernel's SASS.

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

using tml_philox::philox;
using tml_philox::to_uniform;

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

}  // extern "C"
