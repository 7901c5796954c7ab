// The ring kernels of the Mp tier's overlapped tensor-parallel matmul, for
// Hopper (sm_90a):
//
//   tml_ring_gemm:       D = A B, A (m, k) and B (k, n) of f32 or bf16,
//                        summed in f32, D written as f32 or bf16; A, B and D
//                        row-major with row strides lda, ldb, ldd;
//   tml_ring_accumulate: slot += partial (f32), or D = slot + partial in
//                        D's dtype (f32 or bf16), over `count` elements.
//
// Replace the TPU kernels of tpumathlib/mp/overlap.py: _ring_ag_gemm_kernel
// (:48, launched by the pallas_call at :112, B12a) and _ring_rs_gemm_kernel
// (:136, the pallas_call at :190, B12b). Those kernels also move the ring's
// chunks between TPUs, by remote DMA under semaphores, from inside the
// kernel. Here the copies are stream-ordered copies between the ranks'
// buffers, issued by tpumathlib_torch/mp/overlap.py on each rank's comm
// stream, with CUDA events in place of the semaphores. So these kernels do
// only a ring step's arithmetic, on the stream they are given, and never
// wait on another launch: ranks that share a card cannot deadlock it.
//
// tml_ring_gemm: a step's product, one chunk of A (a slot, or a row block
// of the rank's A piece: a row offset is a pointer offset) times the rank's
// B, into a row block of D (B12a) or into an f32 slot (B12b). It runs the
// SIMT main loop of simt_gemm.cuh that B1 and B10b share: one 256-thread
// block a 128 x 128 tile of D, a loop over k in steps of 16 (B1's first
// tile; steps of 8, B10b's, took 27 % longer here), each thread summing an
// 8 x 8 block in f32 FMA (never TF32), in k order: where cuBLAS does not
// split k it gives the same bits as torch.matmul. Writing D's dtype at the
// store does the reference's closing cast (overlap.py:126) without a pass.
// What bounds it is the product's 2 m k n flop at the f32 rate: a step at
// (2048, 4096) @ (4096, 4096) is 68.7 GFLOP, 1.03 ms at 67 TFLOP/s.
//
// tml_ring_accumulate: B12b's add of a rank's own partial into the slot the
// left neighbour sent (overlap.py:168-169). It stays a kernel of its own on
// purpose: fused into the GEMM, the GEMM would have to wait for the copy,
// and the overlap of the next partial with the copy would be lost. It
// moves 12 bytes an element (8 at the last step into bf16), as 16-byte
// vectors where every pointer allows them; bound by bytes, 0.030 ms for a
// (2048, 4096) f32 slot at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "simt_gemm.cuh"

namespace {

enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr int kBM = 128, kBN = 128, kBK = 16, kTM = 8, kTN = 8;
using RingTile = tml_simt::Tile<kBM, kBN, kBK, kTM, kTN>;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct GemmArgs {
  const void* a;
  const void* b;
  void* d;
  int64_t m, n, k;
  int64_t lda, ldb, ldd;   // row strides in elements; every column stride is 1
};

template <typename TAB, typename TD>
__global__ void __launch_bounds__(RingTile::kThreads) ring_gemm_kernel(const GemmArgs p) {
  const TAB* __restrict__ a = static_cast<const TAB*>(p.a);
  const TAB* __restrict__ b = static_cast<const TAB*>(p.b);
  TD* __restrict__ d = static_cast<TD*>(p.d);
  const int64_t m0 = int64_t(blockIdx.y) * kBM, n0 = int64_t(blockIdx.x) * kBN;
  float acc[kTM][kTN];
  tml_simt::mainloop<kBM, kBN, kBK, kTM, kTN>(
      acc, p.k,
      [&](int r, int64_t gk) {
        const int64_t gm = m0 + r;
        return gm < p.m && gk < p.k ? to_f32(a[gm * p.lda + gk]) : 0.f;
      },
      [&](int64_t gk, int c) {
        const int64_t gn = n0 + c;
        return gk < p.k && gn < p.n ? to_f32(b[gk * p.ldb + gn]) : 0.f;
      });
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t gm = m0 + RingTile::row(i);
    if (gm >= p.m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int64_t gn = n0 + RingTile::col(j);
      if (gn < p.n) store(d + gm * p.ldd + gn, acc[i][j]);
    }
  }
}

template <typename TAB, typename TD>
cudaError_t launch_gemm(const GemmArgs& p, cudaStream_t stream) {
  const int64_t gx = (p.n + kBN - 1) / kBN, gy = (p.m + kBM - 1) / kBM;
  if (gx > 0x7fffffff || gy > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  ring_gemm_kernel<TAB, TD><<<grid, RingTile::kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

constexpr int kAccThreads = 256;
constexpr int64_t kAccMaxBlocks = 132 * 16;   // a grid-stride loop over the SMs

__device__ __forceinline__ void store4(float* d, int64_t i, float4 v) {
  reinterpret_cast<float4*>(d)[i] = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* d, int64_t i, float4 v) {
  __nv_bfloat162* pair = reinterpret_cast<__nv_bfloat162*>(d) + 2 * i;
  pair[0] = __floats2bfloat162_rn(v.x, v.y);
  pair[1] = __floats2bfloat162_rn(v.z, v.w);
}

// slot (or d) = slot + partial over count elements: 16-byte vectors for the
// first count / 4 groups when `vec`, the rest one element a thread.
template <typename TD>
__global__ void __launch_bounds__(kAccThreads)
ring_accumulate_kernel(const float* __restrict__ partial, float* slot, TD* d, int64_t count,
                       bool vec) {
  const int64_t stride = int64_t(gridDim.x) * kAccThreads;
  const int64_t first = int64_t(blockIdx.x) * kAccThreads + threadIdx.x;
  const int64_t groups = vec ? count / 4 : 0;
  for (int64_t g = first; g < groups; g += stride) {
    float4 s = reinterpret_cast<const float4*>(slot)[g];
    const float4 q = reinterpret_cast<const float4*>(partial)[g];
    s.x += q.x;
    s.y += q.y;
    s.z += q.z;
    s.w += q.w;
    if (d == nullptr) {
      reinterpret_cast<float4*>(slot)[g] = s;
    } else {
      store4(d, g, s);
    }
  }
  for (int64_t i = 4 * groups + first; i < count; i += stride) {
    const float s = slot[i] + partial[i];
    if (d == nullptr) {
      slot[i] = s;
    } else {
      store(d + i, s);
    }
  }
}

template <typename TD>
cudaError_t launch_accumulate(const float* partial, float* slot, TD* d, int64_t count,
                              cudaStream_t stream) {
  const auto aligned = [](const void* p, uintptr_t n) {
    return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
  };
  const bool vec = aligned(partial, 16) && aligned(slot, 16) &&
                   (d == nullptr || aligned(d, 4 * sizeof(TD)));
  const int64_t per_block = int64_t(kAccThreads) * (vec ? 4 : 1);
  int64_t blocks = (count + per_block - 1) / per_block;
  if (blocks > kAccMaxBlocks) blocks = kAccMaxBlocks;
  ring_accumulate_kernel<TD><<<static_cast<unsigned>(blocks), kAccThreads, 0, stream>>>(
      partial, slot, d, count, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a (m, k) with row stride lda, b (k, n) with ldb, d (m, n) with ldd, each
// with unit column stride; ab_dtype and d_dtype 0 (f32) or 1 (bf16).
// Launches on `stream`; returns the CUDA status (0 on success).
int tml_ring_gemm(const void* a, const void* b, void* d, int64_t m, int64_t n, int64_t k,
                  int64_t lda, int64_t ldb, int64_t ldd, int ab_dtype, int d_dtype,
                  void* stream) {
  if (a == nullptr || b == nullptr || d == nullptr || m < 0 || n < 0 || k < 0 || lda < k ||
      ldb < n || ldd < n)
    return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  const GemmArgs p{a, b, d, m, n, k, lda, ldb, ldd};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ab_dtype == kF32 && d_dtype == kF32) return launch_gemm<float, float>(p, s);
  if (ab_dtype == kF32 && d_dtype == kBF16) return launch_gemm<float, __nv_bfloat16>(p, s);
  if (ab_dtype == kBF16 && d_dtype == kF32) return launch_gemm<__nv_bfloat16, float>(p, s);
  if (ab_dtype == kBF16 && d_dtype == kBF16)
    return launch_gemm<__nv_bfloat16, __nv_bfloat16>(p, s);
  return cudaErrorInvalidValue;
}

// partial, slot: count f32, contiguous. d null: slot += partial in place;
// else d (count elements of d_dtype, contiguous) = slot + partial.
int tml_ring_accumulate(const void* partial, void* slot, void* d, int64_t count, int d_dtype,
                        void* stream) {
  if (partial == nullptr || slot == nullptr || count < 0) return cudaErrorInvalidValue;
  if (count == 0) return cudaSuccess;
  const float* q = static_cast<const float*>(partial);
  float* s = static_cast<float*>(slot);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == nullptr || d_dtype == kF32)
    return launch_accumulate<float>(q, s, static_cast<float*>(d), count, st);
  if (d_dtype == kBF16)
    return launch_accumulate<__nv_bfloat16>(q, s, static_cast<__nv_bfloat16*>(d), count, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
