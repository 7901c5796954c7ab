// The SIMT f32 GEMM main loop of gemm_epilogue.cu, B1's SIMT route (int8
// operands, 16-bit ones in layouts the tensor-core route refuses, the host
// loops' small f32 products, explicit SIMT configs).
//
// One thread block of (BM / TM) * (BN / TN) threads sums one (BM, BN) tile of
// A B over k in steps of BK; that loop takes the place of the TPU kernels'
// sequential K axis (or of their whole operands held in VMEM). Each step's
// operands are read from device memory into registers one step ahead (kLA
// consecutive k of one row of A and kLB consecutive n of one row of B a
// thread), converted to f32 by the caller's loaders, and stored to shared
// memory, A transposed. Each thread sums a TM x TN block in f32 FMA (never
// TF32), in k order, so a sum does not depend on the tile: rows
// ty * TM/2 + {0 .. TM/2 - 1} and BM/2 + the same, columns likewise with tx,
// so that its shared-memory reads are TM/2- and TN/2-wide vectors. The
// loaders mask the ragged edges, giving 0 outside the operands.
//
// This leaves the tensor cores idle, on purpose: it is the simple, right
// first loop of the port; wgmma and TMA are later work.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tml_simt {

template <int BM, int BN, int BK, int TM, int TN>
struct Tile {
  static constexpr int kTX = BN / TN;                    // threads along N
  static constexpr int kThreads = (BM / TM) * kTX;
  static constexpr int kLA = BM * BK / kThreads;         // A's loads a thread a step
  static constexpr int kLB = BK * BN / kThreads;         // B's
  static_assert(TM % 2 == 0 && TN % 2 == 0, "a thread's rows and columns come in two halves");
  static_assert(BM * BK % kThreads == 0 && BK % kLA == 0 && BK * BN % kThreads == 0 &&
                    BN % kLB == 0,
                "each thread loads whole runs of one row");

  // the tile row of a thread's accumulator row i, and the tile column of its column j
  __device__ static int row(int i) {
    const int ty = threadIdx.x / kTX;
    return i < TM / 2 ? ty * (TM / 2) + i : BM / 2 + ty * (TM / 2) + i - TM / 2;
  }
  __device__ static int col(int j) {
    const int tx = threadIdx.x % kTX;
    return j < TN / 2 ? tx * (TN / 2) + j : BN / 2 + tx * (TN / 2) + j - TN / 2;
  }
};

// Registers r[0 .. N) from shared memory s[0 .. N), and back, as 16- or
// 8-byte vectors where N is a multiple of 4 or 2 and s is aligned to them.
// The vectors are built from and taken apart into the elements, so r stays
// in registers.
template <int N>
__device__ __forceinline__ void lds(float* r, const float* s) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int t = 0; t < N; t += 4) {
      const float4 v = *reinterpret_cast<const float4*>(s + t);
      r[t] = v.x, r[t + 1] = v.y, r[t + 2] = v.z, r[t + 3] = v.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int t = 0; t < N; t += 2) {
      const float2 v = *reinterpret_cast<const float2*>(s + t);
      r[t] = v.x, r[t + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int t = 0; t < N; ++t) r[t] = s[t];
  }
}

template <int N>
__device__ __forceinline__ void sts(float* s, const float* r) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int t = 0; t < N; t += 4)
      *reinterpret_cast<float4*>(s + t) = make_float4(r[t], r[t + 1], r[t + 2], r[t + 3]);
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int t = 0; t < N; t += 2) *reinterpret_cast<float2*>(s + t) = make_float2(r[t], r[t + 1]);
  } else {
#pragma unroll
    for (int t = 0; t < N; ++t) s[t] = r[t];
  }
}

// acc[i][j] = sum over kk < k of A[row(i), kk] B[kk, col(j)]. load_a(r, kk)
// is A at tile row r and column kk, load_b(kk, c) is B at row kk and tile
// column c, both f32 and 0 outside the operands.
template <int BM, int BN, int BK, int TM, int TN, typename LoadA, typename LoadB>
__device__ __forceinline__ void mainloop(float (&acc)[TM][TN], int64_t k, LoadA load_a,
                                         LoadB load_b) {
  using T = Tile<BM, BN, BK, TM, TN>;
  __shared__ __align__(16) float as[BK][BM];   // A's tile, transposed
  __shared__ __align__(16) float bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % T::kTX, ty = tid / T::kTX;
  // this thread's share of each tile load
  const int ar = tid / (BK / T::kLA), ac = (tid % (BK / T::kLA)) * T::kLA;
  const int br = tid / (BN / T::kLB), bc = (tid % (BN / T::kLB)) * T::kLB;
  float ra[T::kLA], rb[T::kLB];
  auto load = [&](int64_t k0) {
#pragma unroll
    for (int t = 0; t < T::kLA; ++t) ra[t] = load_a(ar, k0 + ac + t);
#pragma unroll
    for (int t = 0; t < T::kLB; ++t) rb[t] = load_b(k0 + br, bc + t);
  };
  auto store = [&]() {
#pragma unroll
    for (int t = 0; t < T::kLA; ++t) as[ac + t][ar] = ra[t];
    sts<T::kLB>(&bs[br][bc], rb);
  };

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (k > 0) {
    load(0);
    store();
    __syncthreads();
  }
  for (int64_t k0 = 0; k0 < k; k0 += BK) {
    const bool more = k0 + BK < k;
    if (more) load(k0 + BK);   // in flight while this step computes
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float fa[TM], fb[TN];
      lds<TM / 2>(fa, &as[kk][ty * (TM / 2)]);
      lds<TM / 2>(fa + TM / 2, &as[kk][BM / 2 + ty * (TM / 2)]);
      lds<TN / 2>(fb, &bs[kk][tx * (TN / 2)]);
      lds<TN / 2>(fb + TN / 2, &bs[kk][BN / 2 + tx * (TN / 2)]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }
}

}  // namespace tml_simt
