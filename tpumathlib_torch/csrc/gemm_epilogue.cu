// Tiled GEMM with a fused epilogue, for Hopper (sm_90a):
//
//   D = epilogue(alpha * A @ B + beta * C + bias)   [+ aux = pre-activation]
//
// Replaces the TPU kernel tpumathlib/dx/gemm.py::pallas_matmul (kernel body
// at :193) on B1's SIMT route: int8 operands, 16-bit ones in layouts the
// tensor-core route refuses, the host loops' small f32 products (the size
// rule of dx/gemm.py::_into_route) and explicit SIMT configs; f32 operands
// otherwise take gemm_tf32x3.cu. A is (batch, M, K), B is (batch, K, N); C is broadcast to
// (batch, M, N) by its strides; bias is (N,) f32. Epilogues: none, relu,
// gelu (tanh approximation), each with an optional bias add and an optional
// f32 store of the pre-activation (aux).
//
// What bounds it: at 4096^3 in bf16 the product is 2 * 4096^3 = 137 GFLOP
// against about 100 MB of device-memory traffic (A, B and D once each),
// over 1000 flop per byte, so the work is compute-bound on this card.
//
// Design. One thread block computes one (BM, BN) tile of D with the SIMT
// main loop of simt_gemm.cuh: its
// loop over K in steps of BK takes the place of the TPU kernel's sequential
// ("arbitrary") K grid axis, whose f32 VMEM accumulator becomes TM x TN f32
// registers per thread. Operands are converted to f32 on load; products
// accumulate as f32 FMA (no TF32, no bf16 sums), so int8 operands stay exact
// up to 2^24. The ragged M, N and K edges are masked by the loaders, in place
// of the TPU kernel's pad-to-tile copies. blockIdx.z is the batch index, and
// every operand carries its own batch, row and column strides, so a
// broadcast B or C costs a stride of 0.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "simt_gemm.cuh"

namespace {

// dtype codes, as tpumathlib_torch/dx/gemm.py passes them
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };
// activation codes
enum Act : int { kNone = 0, kRelu = 1, kGelu = 2 };

struct Params {
  const void* a;
  const void* b;
  const void* c;       // may be null
  const float* bias;   // may be null
  void* d;
  float* aux;          // may be null
  int64_t m, n, k;
  int64_t a_sb, a_sm, a_sk;  // strides in elements: batch, row, column
  int64_t b_sb, b_sk, b_sn;
  int64_t c_sb, c_sm, c_sn;
  int64_t d_sb, d_sm;        // D and aux share one layout, unit column stride
  float alpha, beta;
  int act;
  int c_dtype;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half_rn(v); }

__device__ __forceinline__ float load_c(const void* c, int dtype, int64_t i) {
  switch (dtype) {
    case kBF16: return to_f32(static_cast<const __nv_bfloat16*>(c)[i]);
    case kF16: return to_f32(static_cast<const __half*>(c)[i]);
    case kI8: return to_f32(static_cast<const int8_t*>(c)[i]);
    default: return static_cast<const float*>(c)[i];
  }
}

template <typename TAB, typename TD, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gemm_epilogue_kernel(const Params p) {
  using Tile = tml_simt::Tile<BM, BN, BK, TM, TN>;
  const int64_t bz = blockIdx.z;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;
  const TAB* A = static_cast<const TAB*>(p.a) + bz * p.a_sb;
  const TAB* B = static_cast<const TAB*>(p.b) + bz * p.b_sb;

  float acc[TM][TN];
  tml_simt::mainloop<BM, BN, BK, TM, TN>(
      acc, p.k,
      [&](int r, int64_t gk) {
        const int64_t gm = m0 + r;
        return gm < p.m && gk < p.k ? to_f32(A[gm * p.a_sm + gk * p.a_sk]) : 0.f;
      },
      [&](int64_t gk, int c) {
        const int64_t gn = n0 + c;
        return gk < p.k && gn < p.n ? to_f32(B[gk * p.b_sk + gn * p.b_sn]) : 0.f;
      });

  // fused epilogue, in registers
  TD* D = static_cast<TD*>(p.d) + bz * p.d_sb;
  float* AUX = p.aux ? p.aux + bz * p.d_sb : nullptr;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gm = m0 + Tile::row(i);
    if (gm >= p.m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gn = n0 + Tile::col(j);
      if (gn >= p.n) continue;
      float v = p.alpha * acc[i][j];
      if (p.c) v += p.beta * load_c(p.c, p.c_dtype, bz * p.c_sb + gm * p.c_sm + gn * p.c_sn);
      if (p.bias) v += p.bias[gn];
      if (AUX) AUX[gm * p.d_sm + gn] = v;
      if (p.act == kRelu) {
        v = v < 0.f ? 0.f : v;  // NaN passes through, as in the plain version
      } else if (p.act == kGelu) {
        v = 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
      }
      store(D + gm * p.d_sm + gn, v);
    }
  }
}

// The compiled tile configs: (BM, BN, BK, TM, TN). Config ids index this
// table; MatmulConfig in dx/gemm.py lists the same (BM, BN, BK) in order.
constexpr int kConfigs[][5] = {
    {128, 128, 16, 8, 8},
    {128, 64, 16, 8, 4},
    {64, 64, 16, 4, 4},
};
constexpr int kNumConfigs = sizeof(kConfigs) / sizeof(kConfigs[0]);

template <typename TAB, typename TD, int CFG>
cudaError_t launch(const Params& p, int64_t batch, cudaStream_t stream) {
  constexpr int BM = kConfigs[CFG][0], BN = kConfigs[CFG][1], BK = kConfigs[CFG][2];
  constexpr int TM = kConfigs[CFG][3], TN = kConfigs[CFG][4];
  const int64_t gx = (p.n + BN - 1) / BN, gy = (p.m + BM - 1) / BM;
  if (gx > 2147483647LL || gy > 65535 || batch > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                  static_cast<unsigned>(batch));
  gemm_epilogue_kernel<TAB, TD, BM, BN, BK, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename TAB, typename TD>
cudaError_t by_config(int config, const Params& p, int64_t batch, cudaStream_t s) {
  switch (config) {
    case 0: return launch<TAB, TD, 0>(p, batch, s);
    case 1: return launch<TAB, TD, 1>(p, batch, s);
    case 2: return launch<TAB, TD, 2>(p, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TAB>
cudaError_t by_out(int d_dtype, int config, const Params& p, int64_t batch, cudaStream_t s) {
  switch (d_dtype) {
    case kF32: return by_config<TAB, float>(config, p, batch, s);
    case kBF16: return by_config<TAB, __nv_bfloat16>(config, p, batch, s);
    case kF16: return by_config<TAB, __half>(config, p, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Number of compiled tile configs; writes (BM, BN, BK) of each into
// out[3 * i .. 3 * i + 2] for i < cap.
int tml_gemm_configs(int* out, int cap) {
  for (int i = 0; i < kNumConfigs && i < cap; ++i)
    for (int j = 0; j < 3; ++j) out[3 * i + j] = kConfigs[i][j];
  return kNumConfigs;
}

const char* tml_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). strides: a_sb, a_sm, a_sk, b_sb, b_sk, b_sn, c_sb, c_sm, c_sn,
// d_sb, d_sm, in elements.
int tml_gemm_epilogue(const void* a, const void* b, const void* c, const float* bias,
                      void* d, float* aux, int64_t batch, int64_t m, int64_t n, int64_t k,
                      const int64_t* strides, float alpha, float beta, int act,
                      int ab_dtype, int c_dtype, int d_dtype, int config, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return cudaSuccess;
  Params p;
  p.a = a; p.b = b; p.c = c; p.bias = bias; p.d = d; p.aux = aux;
  p.m = m; p.n = n; p.k = k;
  p.a_sb = strides[0]; p.a_sm = strides[1]; p.a_sk = strides[2];
  p.b_sb = strides[3]; p.b_sk = strides[4]; p.b_sn = strides[5];
  p.c_sb = strides[6]; p.c_sm = strides[7]; p.c_sn = strides[8];
  p.d_sb = strides[9]; p.d_sm = strides[10];
  p.alpha = alpha; p.beta = beta;
  p.act = act; p.c_dtype = c_dtype;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ab_dtype) {
    case kF32: return by_out<float>(d_dtype, config, p, batch, s);
    case kBF16: return by_out<__nv_bfloat16>(d_dtype, config, p, batch, s);
    case kF16: return by_out<__half>(d_dtype, config, p, batch, s);
    case kI8: return by_out<int8_t>(d_dtype, config, p, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
