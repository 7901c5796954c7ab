// The 128x128 diagonal-block sweeps of the one-launch dense solvers, for
// Hopper (sm_90a):
//
//   tml_chol_inv_block: L = chol(A) (lower, strict upper exactly 0) and
//                       W = inv(L), from an SPD block A.
//   tml_lu_inv_block:   compact L\U of the no-pivot LU of A (unit-lower L),
//                       WL = inv(L) and WU = inv(U).
//
// Replace the TPU sweeps tpumathlib/solver/blocked.py::_chol_inv128 (:96),
// used by the kernel body tpumathlib/solver/onelaunch.py::_onelaunch_kernel
// (:108, pallas_call :231), and onelaunch.py::_lu128 (:290),
// _inv_unit_lower128 (:306) and _inv_upper128 (:325), used by _getrf_kernel
// (:343, pallas_call :481). The matrix products around the sweeps go through
// gemm_epilogue.cu; tpumathlib_torch/solver/onelaunch.py drives both.
//
// What bounds it: a sweep is 128 dependent rank-1 steps on a 64 KB tile
// (about 0.7 MFLOP per block), so it is bound by the latency of one step
// (shared-memory loads, FMAs and a barrier), not by bytes or FLOPs. Design:
// one thread block of 1024 threads per call holds the whole block and one
// inverse in shared memory (2 x 66 KB, above the 48 KB static limit, so the
// launch raises cudaFuncAttributeMaxDynamicSharedMemorySize first). Thread
// t owns column t % 128 and every 8th row from t / 128, so a step is at most
// 16 FMAs a thread and one __syncthreads(). The inverse is carried in the
// same step as the factorization: the columns left of the pivot update the
// inverse while the columns right of it update the trailing block, so no
// step waits on a reduction.
//
// Each step keeps the pivot column unscaled and divides at the store (its
// entries are never touched again), so no thread writes what another reads
// within a step. A non-SPD block takes 1/sqrt of a negative pivot and turns
// the rest of L non-finite, as the reference does: nothing is clamped, so
// the drivers' info sees it.

#include <cuda_runtime.h>

#include <cstdint>

#include "block_sweep.cuh"

namespace {

using namespace tml_block;

constexpr size_t kSmemBytes = 2 * kTileBytes + sizeof(float) * kNB;

// Fused Cholesky + inverse. Step j, with rs = 1 / sqrt(d[j][j]):
//   d[i][k] -= (d[i][j] rs) (d[j][k] rs)   for i, k > j  (trailing block)
//   r[i][c] -= (d[i][j] rs) (r[j][c] rs)   for i > j, c <= j
// where r starts as I; at the end L[i][c] = d[c][i] rs_c (the rows of d
// hold L's columns, as the reference's U storage does) and
// W[i][c] = r[i][c] rs_i, since row i of r is final once step i begins.
__global__ void __launch_bounds__(kThreads)
chol_inv_kernel(const float* a, int64_t lda, float* l, int64_t ldl, float* w, int64_t ldw) {
  extern __shared__ float smem[];
  float* d = smem;
  float* r = smem + kNB * kLD;
  float* rs_of = smem + 2 * kNB * kLD;
  load_block(d, a, lda);
  identity(r);
  __syncthreads();

  const int kc = threadIdx.x % kNB;
  const int r0 = threadIdx.x / kNB;
  for (int j = 0; j < kNB; ++j) {
    const float rs = 1.f / sqrtf(d[j * kLD + j]);  // NaN for a negative pivot
    if (threadIdx.x == 0) rs_of[j] = rs;
    if (kc > j) {
      const float vr = d[j * kLD + kc] * rs;
      for (int i = j + 1 + r0; i < kNB; i += kRowStep)
        d[i * kLD + kc] -= (d[i * kLD + j] * rs) * vr;
    } else {
      const float wj = r[j * kLD + kc] * rs;
      for (int i = j + 1 + r0; i < kNB; i += kRowStep)
        r[i * kLD + kc] -= (d[i * kLD + j] * rs) * wj;
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < kNB * kNB; e += kThreads) {
    const int i = e / kNB, c = e % kNB;
    l[i * ldl + c] = i >= c ? d[c * kLD + i] * rs_of[c] : 0.f;
    w[i * ldw + c] = i >= c ? r[i * kLD + c] * rs_of[i] : 0.f;
  }
}

// No-pivot LU with both triangular inverses. Step j, with p = d[j][j]:
//   d[i][k] -= (d[i][j] / p) d[j][k]       for i, k > j
//   r[i][c] -= (d[i][j] / p) r[j][c]       for i > j, c <= j
// The second line applies _inv_unit_lower128's elementary factors in
// ascending j, which is what makes r = inv(L) (descending gives 2I - L).
// Then inv(U) as _inv_upper128 does: with dinv_k = 1 / U[k][k], for k from
// 127 down to 1, r[i][c] -= (U[i][k] dinv_k) r[k][c] for i < k, c >= k;
// finally WU[i][c] = r[i][c] dinv_i.
__global__ void __launch_bounds__(kThreads)
lu_inv_kernel(const float* a, int64_t lda, float* lu, int64_t ldlu, float* wl, int64_t ldwl,
              float* wu, int64_t ldwu) {
  extern __shared__ float smem[];
  float* d = smem;
  float* r = smem + kNB * kLD;
  float* dinv = smem + 2 * kNB * kLD;
  load_block(d, a, lda);
  identity(r);
  __syncthreads();

  const int kc = threadIdx.x % kNB;
  const int r0 = threadIdx.x / kNB;
  for (int j = 0; j < kNB; ++j) {
    const float p = d[j * kLD + j];
    if (kc > j) {
      const float u = d[j * kLD + kc];
      for (int i = j + 1 + r0; i < kNB; i += kRowStep)
        d[i * kLD + kc] -= (d[i * kLD + j] / p) * u;
    } else {
      const float wj = r[j * kLD + kc];
      for (int i = j + 1 + r0; i < kNB; i += kRowStep)
        r[i * kLD + kc] -= (d[i * kLD + j] / p) * wj;
    }
    __syncthreads();
  }

  // store L\U and inv(L); then reuse r for inv(U) (the sweep starts with a barrier)
  for (int e = threadIdx.x; e < kNB * kNB; e += kThreads) {
    const int i = e / kNB, c = e % kNB;
    const float v = d[i * kLD + c];
    lu[i * ldlu + c] = i > c ? v / d[c * kLD + c] : v;
    wl[i * ldwl + c] = r[i * kLD + c];
  }
  inv_upper_sweep(d, r, dinv);
  store_scaled(wu, ldwu, r, dinv);
}

}  // namespace

extern "C" {

// Each entry point takes one 128x128 f32 block with unit column stride and
// the given row strides (in elements), launches one thread block on
// `stream`, and returns cudaGetLastError() (0 on success). An output may be
// the input block itself: the block is read whole before anything is stored.
int tml_chol_inv_block(const float* a, int64_t lda, float* l, int64_t ldl, float* w,
                       int64_t ldw, void* stream) {
  cudaError_t err = allow_smem(chol_inv_kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  chol_inv_kernel<<<1, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      a, lda, l, ldl, w, ldw);
  return cudaGetLastError();
}

int tml_lu_inv_block(const float* a, int64_t lda, float* lu, int64_t ldlu, float* wl,
                     int64_t ldwl, float* wu, int64_t ldwu, void* stream) {
  cudaError_t err = allow_smem(lu_inv_kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  lu_inv_kernel<<<1, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      a, lda, lu, ldlu, wl, ldwl, wu, ldwu);
  return cudaGetLastError();
}

}  // extern "C"
