// The ring kernel of the Mp tier's overlapped GEMM + ReduceScatter, for
// Hopper (sm_90a):
//
//   tml_ring_accumulate: slot += partial (f32), or D = slot + partial in
//                        D's dtype (f32 or bf16), over `count` elements.
//
// With the ring GEMMs, it replaces the TPU kernels of
// tpumathlib/mp/overlap.py: _ring_ag_gemm_kernel (:48, launched by the
// pallas_call at :112, B12a) and _ring_rs_gemm_kernel (:136, the
// pallas_call at :190, B12b). Those kernels also move the ring's chunks
// between TPUs, by remote DMA under semaphores, from inside the kernel.
// Here the copies are stream-ordered copies between the ranks' buffers,
// issued by tpumathlib_torch/mp/overlap.py on each rank's comm stream, with
// CUDA events in place of the semaphores. So the kernels do only a ring
// step's arithmetic, on the stream they are given, and never wait on
// another launch: ranks that share a card cannot deadlock it. A step's
// product is gemm_tf32x3.cu's 3xTF32 kernel for f32 operands and
// gemm_wgmma.cu's bf16 kernel for bf16 ones (mp/overlap.py::_ring_gemm).
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

namespace {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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
