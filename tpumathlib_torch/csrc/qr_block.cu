// The 128x128 block sweeps of the blocked Householder QR, for Hopper (sm_90a):
//
//   tml_hh_recon_block:  the Householder reconstruction of one panel block
//                        (Ballard et al., "Reconstructing Householder Vectors
//                        from Tall-Skinny QR", IPDPS 2014): from Qtop, rows
//                        j0 .. j0+127 of the orthonormal panel basis, the
//                        no-pivot elimination E1 - Q D = V M with the signs D
//                        chosen on the fly. Outputs the multipliers V1
//                        (strictly lower, exact zeros elsewhere), the 128
//                        signs d (+-1) and inv(M), M = upper(Ea - Qa D).
//   tml_inv_upper_block: inv(upper(U)) of one block (the strict lower part of
//                        U is not read).
//
// Replace the sweeps of the TPU kernel body
// tpumathlib/solver/qr_onelaunch.py::_geqrf_kernel (:174, pallas_call :318):
// the reconstruction loop of _qr_block128 (:137-153) with its inverse of M
// (:152-153), and tpumathlib/solver/onelaunch.py::_inv_upper128 (:325) as
// _t_from_v (:159-171) uses it for T = inv(strict_upper(S) + diag(S)/2). The
// CholeskyQR2 sweeps are tml_chol_inv_block (dense_block.cu); the products
// over the rows are qr_gram.cu's split-K Gram kernel and every other product
// goes through gemm_epilogue.cu; tpumathlib_torch/solver/qr_onelaunch.py
// drives them, the sweeps on raw addresses (hh_recon writes V1 straight into
// the panel's unit-lower V top). On the QR's critical path: 8 sweeps a
// 256-wide panel, one block each, so these two set the pace of geqrf at
// n = 4096 beside the Cholesky sweep (PERF.md section 5).
//
// What bounds it: 128 dependent steps on 64 KB tiles (about 2 MFLOP per
// block), so the latency of one step (shared-memory loads, FMAs, one
// barrier), not bytes or FLOPs. Design, as dense_block.cu: one thread block
// of 1024 threads holds the tiles in shared memory (2 x 66 KB, above the
// 48 KB static limit, so the launch raises
// cudaFuncAttributeMaxDynamicSharedMemorySize first). The reconstruction
// keeps Ea and Qa as two separate tiles, since d_j needs both diagonal
// entries at step j. Step j:
//   d_j   = -1 if Ea[j][j] Qa[j][j] > 0, else +1
//   p_j   = Ea[j][j] - d_j Qa[j][j]                        (|p_j| >= 1)
//   m_i   = (Ea[i][j] - d_j Qa[i][j]) / p_j                (i > j)
//   Ea[i][k] -= m_i Ea[j][k],  Qa[i][k] -= m_i Qa[j][k]    (i > j, k > j)
// Only the columns k > j of rows i > j are read afterwards (M is the upper
// triangle), so the other entries are left as they are. The thread that owns
// column j stores m into V1 and touches neither tile, so no thread writes
// what another reads within a step. Then M = upper(Ea - Qa D) overwrites Ea,
// and inv(M) is the same sweep as tml_inv_upper_block, with Qa's tile reused
// for the inverse: the two are fused so that a block costs one launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "block_sweep.cuh"

namespace {

using namespace tml_block;

constexpr size_t kSmemBytes = 2 * kTileBytes + 2 * sizeof(float) * kNB;

__global__ void __launch_bounds__(kThreads)
hh_recon_kernel(const float* qtop, int64_t ldq, float* v1, int64_t ldv1, float* minv,
                int64_t ldm, float* d_out) {
  extern __shared__ float smem[];
  float* ea = smem;
  float* qa = smem + kNB * kLD;
  float* d = smem + 2 * kNB * kLD;
  float* dinv = d + kNB;
  identity(ea);
  load_block(qa, qtop, ldq);
  for (int e = threadIdx.x; e < kNB * kNB; e += kThreads) {
    const int i = e / kNB, c = e % kNB;
    if (i <= c) v1[i * ldv1 + c] = 0.f;
  }
  __syncthreads();

  const int kc = threadIdx.x % kNB;
  const int r0 = threadIdx.x / kNB;
  for (int j = 0; j < kNB; ++j) {
    const float eaj = ea[j * kLD + j], qaj = qa[j * kLD + j];
    const float dj = eaj * qaj > 0.f ? -1.f : 1.f;
    const float p = eaj - dj * qaj;
    if (threadIdx.x == 0) d[j] = dj;
    if (kc > j) {
      const float er = ea[j * kLD + kc], qr = qa[j * kLD + kc];
      for (int i = j + 1 + r0; i < kNB; i += kRowStep) {
        const float m = (ea[i * kLD + j] - dj * qa[i * kLD + j]) / p;
        ea[i * kLD + kc] -= m * er;
        qa[i * kLD + kc] -= m * qr;
      }
    } else if (kc == j) {
      for (int i = j + 1 + r0; i < kNB; i += kRowStep)
        v1[i * ldv1 + j] = (ea[i * kLD + j] - dj * qa[i * kLD + j]) / p;
    }
    __syncthreads();
  }

  // M = upper(Ea - Qa D) in Ea's tile; inv(M) in Qa's (the sweep starts with
  // a barrier, so Qa is read here before it is overwritten)
  for (int e = threadIdx.x; e < kNB * kNB; e += kThreads) {
    const int i = e / kNB, c = e % kNB;
    ea[i * kLD + c] = i <= c ? ea[i * kLD + c] - qa[i * kLD + c] * d[c] : 0.f;
  }
  inv_upper_sweep(ea, qa, dinv);
  store_scaled(minv, ldm, qa, dinv);
  if (threadIdx.x < kNB) d_out[threadIdx.x] = d[threadIdx.x];
}

__global__ void __launch_bounds__(kThreads)
inv_upper_kernel(const float* a, int64_t lda, float* w, int64_t ldw) {
  extern __shared__ float smem[];
  float* u = smem;
  float* r = smem + kNB * kLD;
  float* dinv = smem + 2 * kNB * kLD;
  load_block(u, a, lda);
  inv_upper_sweep(u, r, dinv);
  store_scaled(w, ldw, r, dinv);
}

}  // namespace

extern "C" {

// Each entry point takes 128x128 f32 blocks with unit column stride and the
// given row strides (in elements), launches one thread block on `stream`,
// and returns cudaGetLastError() (0 on success). `d` holds 128 floats.
int tml_hh_recon_block(const float* qtop, int64_t ldq, float* v1, int64_t ldv1, float* minv,
                       int64_t ldm, float* d, void* stream) {
  cudaError_t err = allow_smem(hh_recon_kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  hh_recon_kernel<<<1, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      qtop, ldq, v1, ldv1, minv, ldm, d);
  return cudaGetLastError();
}

int tml_inv_upper_block(const float* a, int64_t lda, float* w, int64_t ldw, void* stream) {
  cudaError_t err = allow_smem(inv_upper_kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  inv_upper_kernel<<<1, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      a, lda, w, ldw);
  return cudaGetLastError();
}

}  // extern "C"
