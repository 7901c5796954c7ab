// Shared pieces of the 128x128 block sweeps of qr_block.cu (dense_block.cu
// keeps its tile in registers instead).
//
// One thread block of 1024 threads holds 128x128 f32 tiles in shared memory,
// each row padded to 129 floats so that a column walk hits every bank once.
// Thread t owns column t % 128 and every 8th row from t / 128, so one step of
// a sweep is at most 16 FMAs a thread and one __syncthreads().

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tml_block {

constexpr int kNB = 128;          // block edge
constexpr int kLD = kNB + 1;      // padded row of a shared-memory tile
constexpr int kThreads = 1024;
constexpr int kRowStep = kThreads / kNB;  // 8 rows in flight per column
constexpr size_t kTileBytes = sizeof(float) * kNB * kLD;

__device__ inline void load_block(float* d, const float* a, int64_t lda) {
  for (int e = threadIdx.x; e < kNB * kNB; e += kThreads) {
    const int i = e / kNB, k = e % kNB;
    d[i * kLD + k] = a[i * lda + k];
  }
}

__device__ inline void identity(float* w) {
  for (int e = threadIdx.x; e < kNB * kNB; e += kThreads) {
    const int i = e / kNB, k = e % kNB;
    w[i * kLD + k] = i == k ? 1.f : 0.f;
  }
}

// inv(upper(u)) as the reference's _inv_upper128 computes it: with
// dinv_k = 1 / u[k][k], for k from 127 down to 1,
//   r[i][c] -= (u[i][k] dinv_k) r[k][c]    for i < k, c >= k,
// starting from r = I; then inv(U)[i][c] = r[i][c] dinv_i (store_scaled).
// Only the upper triangle of u is read. Starts with a barrier, so u may have
// been written and r read by the caller just before.
__device__ inline void inv_upper_sweep(const float* u, float* r, float* dinv) {
  __syncthreads();
  if (threadIdx.x < kNB) dinv[threadIdx.x] = 1.f / u[threadIdx.x * kLD + threadIdx.x];
  identity(r);
  __syncthreads();
  const int kc = threadIdx.x % kNB;
  const int r0 = threadIdx.x / kNB;
  for (int k = kNB - 1; k > 0; --k) {
    if (kc >= k) {
      const float wk = r[k * kLD + kc];
      for (int i = r0; i < k; i += kRowStep)
        r[i * kLD + kc] -= (u[i * kLD + k] * dinv[k]) * wk;
    }
    __syncthreads();
  }
}

// w[i][c] = r[i][c] dinv[i]: the last step of inv_upper_sweep.
__device__ inline void store_scaled(float* w, int64_t ldw, const float* r, const float* dinv) {
  for (int e = threadIdx.x; e < kNB * kNB; e += kThreads) {
    const int i = e / kNB, c = e % kNB;
    w[i * ldw + c] = r[i * kLD + c] * dinv[i];
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace tml_block
