// Philox4x32-10 and the 24-bit uniform map: the one copy of the generator
// that B10a (dx_rng.cu, tml_random_uniform) and B10b's dropout epilogue
// (gemm_tf32x3.cu, tml_dropout_matmul) draw from, so that the dropout's mask
// is exactly tml_random_uniform(seed, m * n) > rate.
//
// Word w of a flat output of n words is word w % 4 of the block with counter
// (w / 4 low word, high word, 0, 0) and key (seed low word, seed high word),
// as the port's rand.PhiloxGenerator(seed) draws it; the word maps to
// ((w & 0xFFFFFF) + 1) * 2^-24, as the TPU kernel maps its bits
// (tpumathlib/dx/rng.py::_uniform_from_bits).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tml_philox {

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

// ws[idx] for idx in 0..7 without a local-memory array: idx is known only at
// run time, so the word is selected.
__device__ __forceinline__ uint32_t pick(const uint32_t (&ws)[8], int idx) {
  uint32_t v = ws[0];
#pragma unroll
  for (int q = 1; q < 8; ++q) v = idx == q ? ws[q] : v;
  return v;
}

// The uniforms of flat words w0 .. w0 + 3: the one Philox block that holds
// them where w0 is a multiple of 4, else the two that do.
__device__ __forceinline__ void uniforms4(uint64_t w0, uint32_t k0, uint32_t k1, float (&u)[4]) {
  const uint64_t blk = w0 >> 2;
  const int off = static_cast<int>(w0 & 3);
  const uint4 x = philox(blk, k0, k1);
  const uint4 y = off ? philox(blk + 1, k0, k1) : x;
  const uint32_t ws[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) u[t] = to_uniform(pick(ws, off + t));
}

}  // namespace tml_philox
