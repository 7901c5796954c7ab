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
// (about 1.4 MFLOP for the LU with both inverses), so the latency of one
// step (a barrier, the shared-memory loads of what the step hands on, the
// FMAs of the busiest scheduler), not bytes or FLOPs. On the card a step
// still costs several times its issue slots; PERF.md §6 lists the layouts
// measured.
//
// Design: one block of 1024 threads holds the tile in registers, 16
// consecutive rows of one column a thread (Place, below). A step hands on
// only the pivot column (as it is, and with its rows up to k zeroed), the
// pivot row and one scalar, through a double-buffered Step in shared
// memory, so a step costs one __syncthreads(); the factor being built is
// staged in shared memory too, since a global store before a barrier holds
// the barrier until it lands. The diagonal's owner takes one reciprocal a
// pivot (1/p, or 1/sqrt(p) for the Cholesky); every other thread scales the
// one pivot-row value it needs and does 16 FMAs with no predicate (the
// zeroed column leaves the rows that must not change as they are), or skips
// the step when none of its rows changes. The step loop is unrolled by 16,
// so the pivot's row in a thread's registers is known at compile time and
// the code that hands a step on has no select chains; the 8 lanes that own
// the pivot column hold up their warps, so the warps that hold a column
// block are spread over the SM's four schedulers rather than queued on one.
//
// The inverses ride along in the same registers, so there is no second
// sweep. Each column is, above the current step k, a column of inv(U) and,
// below it, a column of the trailing block (columns right of k) or of inv(L)
// (columns left of k). At step k:
//   column k:      U[k][k] and the multipliers m_i = d[i][k] / p go out; the
//                  column becomes inv(U)'s column k (its rows above k times
//                  1/p, and 1/p on the diagonal) over inv(L)'s (-m_i below);
//   columns c > k: U[k][c] goes out and row k starts inv(U)'s row k at 0;
//                  then v[i] -= col[i] U[k][c] / p for every row i: the
//                  trailing update below k, and inv(U)'s column operation
//                  W[:, c] -= W[:, k] U[k][c] / p above it (col[k] = 1);
//   columns c < k: v[i] -= m_i r[k][c] for i > k, which builds inv(L) as
//                  _inv_unit_lower128 does, in ascending k.
// inv(U) = inv(R_0) inv(R_1) ... inv(R_127), R_k the identity with row k
// replaced by U's, so each factor needs only U's row k, known at step k.
// The Cholesky is the symmetric case: the same sweep on the lower triangle
// with U[k][c] = d[c][k] (no inv(U)), then L = Lu sqrt(D) and
// inv(L) = inv(sqrt(D)) inv(Lu). Its update uses 1/p = rs rs, so a
// negative pivot's NaN reaches every later column, as the reference's does.
//
// Nothing is clamped: a non-SPD or zero-pivot block turns the rest of the
// factor non-finite, and the drivers' info sees it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNB = 128;                       // block edge
constexpr int kThreads = 1024;
constexpr int kRows = kNB * kNB / kThreads;    // 16 consecutive rows of one column a thread
constexpr int kStageBytes = sizeof(float) * kNB * kNB;   // the staged L\U or L

// What step k hands every thread. Two of them alternate, so that the owners
// of step k + 1 can write theirs while the others still read step k's.
struct __align__(16) Step {
  float col[kNB];     // the pivot column as its owners hold it; col[k] = 1 (LU)
  float below[kNB];   // the same with the rows up to k set to 0
  float row[kNB];     // the pivot row: U[k][c] or r[k][c]
  float scale;        // 1 / p (LU) or 1 / sqrt(p) (Cholesky)
};

// This thread's place: column c, row group g, rows r0 .. r0 + 15. Lanes
// take 32 consecutive columns (coalesced loads, broadcast reads of the
// column); warp w takes row group g = w / 4 and column block (w + g) % 4, so
// the 8 warps of a column block (whose lanes own the pivot column in turn)
// are spread over the SM's four schedulers, two on each.
struct Place {
  int c, g, r0;
  __device__ Place() {
    const int w = threadIdx.x / 32;
    g = w / 4;
    c = (w + g) % 4 * 32 + threadIdx.x % 32;
    r0 = g * kRows;
  }
};

__device__ __forceinline__ void load_column(float (&v)[kRows], const float* a, int64_t lda,
                                            const Place& p) {
  const float* src = a + p.r0 * lda + p.c;
#pragma unroll
  for (int s = 0; s < kRows; ++s) v[s] = src[s * lda];
}

__device__ __forceinline__ void put(float* dst, const float (&t)[kRows]) {
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q)
    reinterpret_cast<float4*>(dst)[q] = make_float4(t[4 * q], t[4 * q + 1], t[4 * q + 2],
                                                    t[4 * q + 3]);
}

// Column k = 16 g1 + s1's owners hand on the column: as it is (col, with
// col[k] = 1 for the LU) and with its rows up to k zeroed (below); s1 is
// known at compile time, g against g1 is one branch of the thread.
template <bool kUnit>
__device__ __forceinline__ void put_column(Step& st, const float (&v)[kRows], int g1, int s1,
                                           const Place& p) {
  float t[kRows], b[kRows];
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    if (p.g < g1) {
      t[s] = v[s], b[s] = 0.f;
    } else if (p.g > g1) {
      t[s] = v[s], b[s] = v[s];
    } else {
      t[s] = kUnit && s == s1 ? 1.f : v[s];
      b[s] = s > s1 ? v[s] : 0.f;
    }
  }
  if (kUnit) put(st.col + p.r0, t);
  put(st.below + p.r0, b);
}

// v[s] -= src[r0 + s] * rr for all 16 rows: src is col or below, whose zeros
// leave the rows that must not change as they are.
__device__ __forceinline__ void update(float (&v)[kRows], const float* src, float rr,
                                       const Place& p) {
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q) {
    const float4 m = reinterpret_cast<const float4*>(src + p.r0)[q];
    v[4 * q] = fmaf(-m.x, rr, v[4 * q]);
    v[4 * q + 1] = fmaf(-m.y, rr, v[4 * q + 1]);
    v[4 * q + 2] = fmaf(-m.z, rr, v[4 * q + 2]);
    v[4 * q + 3] = fmaf(-m.w, rr, v[4 * q + 3]);
  }
}

// Each thread stores the rows r0 .. r0 + 15 of its column of a staged
// (128, 128) tile to `out`.
__device__ __forceinline__ void store_stage(float* out, int64_t ld, const float* stage,
                                            const Place& p) {
#pragma unroll
  for (int s = 0; s < kRows; ++s) out[(p.r0 + s) * ld + p.c] = stage[(p.r0 + s) * kNB + p.c];
}

// Hands on step k1 = 16 g1 + s1 of the LU: the diagonal's owner takes 1/p
// first, then column k1's owners hand on the column and row k1's the row.
// Row k1 of a column right of the pivot is U's: it goes to the staged L\U,
// and its slot becomes inv(U)'s row k1, which starts at 0.
__device__ __forceinline__ void lu_hand_on(Step& st, float (&v)[kRows], float* stage, int k1,
                                           int g1, int s1, const Place& p) {
  if (p.c == k1) {
    if (p.g == g1) st.scale = __frcp_rn(v[s1]);
    put_column<true>(st, v, g1, s1, p);
  } else if (p.g == g1) {
    const float x = v[s1];
    st.row[p.c] = x;
    if (p.c > k1) {
      stage[k1 * kNB + p.c] = x;
      v[s1] = 0.f;
    }
  }
}

// Column k = 16 kb + kk of the LU: U[k][k] and the multipliers go to the
// staged L\U; the column becomes inv(U)'s column k over inv(L)'s.
__device__ __forceinline__ void lu_pivot(float (&v)[kRows], float* stage, float rp, int k,
                                         int kb, int kk, const Place& p) {
  float* out = stage + p.r0 * kNB + k;
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    const float m = v[s] * rp;
    if (p.g < kb || (p.g == kb && s < kk)) {
      v[s] = m;
    } else if (p.g == kb && s == kk) {
      out[s * kNB] = v[s];
      v[s] = rp;
    } else {
      out[s * kNB] = m;
      v[s] = -m;
    }
  }
}

// No-pivot LU with both triangular inverses (see the header). lu may be a
// itself: nothing is stored before the sweep ends.
__global__ void __launch_bounds__(kThreads)
lu_inv_kernel(const float* a, int64_t lda, float* lu, int64_t ldlu, float* wl, int64_t ldwl,
              float* wu, int64_t ldwu) {
  extern __shared__ __align__(16) float stage[];   // L\U
  __shared__ Step st[2];
  const Place p;
  float v[kRows];
  load_column(v, a, lda, p);
  lu_hand_on(st[0], v, stage, 0, 0, 0, p);
  __syncthreads();

  for (int kb = 0; kb < kNB / kRows; ++kb) {
#pragma unroll
    for (int kk = 0; kk < kRows; ++kk) {
      const int k = kb * kRows + kk;
      const Step& cur = st[kk & 1];
      const float rp = cur.scale;
      if (p.c == k) {
        lu_pivot(v, stage, rp, k, kb, kk, p);
      } else if (p.c > k) {
        update(v, cur.col, cur.row[p.c] * rp, p);
      } else if (p.g > kb || (p.g == kb && kk + 1 < kRows)) {   // inv(L)'s rows below k
        update(v, cur.below, cur.row[p.c] * rp, p);
      }
      if (k + 1 < kNB)
        lu_hand_on(st[(kk + 1) & 1], v, stage, k + 1, kb + (kk + 1) / kRows,
                   (kk + 1) % kRows, p);
      __syncthreads();
    }
  }

  store_stage(lu, ldlu, stage, p);
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    const int i = p.r0 + s;
    wl[i * ldwl + p.c] = i > p.c ? v[s] : (i == p.c ? 1.f : 0.f);
    wu[i * ldwu + p.c] = i <= p.c ? v[s] : 0.f;
  }
}

// Hands on step k1 = 16 g1 + s1 of the Cholesky: the diagonal's owner takes
// 1/sqrt(p) first, then column k1's owners hand on the column and, left of
// the pivot, row k1's owners row k1 of inv(Lu). Right of the pivot the row
// is the column (A is symmetric).
__device__ __forceinline__ void chol_hand_on(Step& st, float* rs_of, const float (&v)[kRows],
                                             int k1, int g1, int s1, const Place& p) {
  if (p.c == k1) {
    if (p.g == g1) {
      const float rs = __frcp_rn(__fsqrt_rn(v[s1]));   // NaN for p < 0
      st.scale = rs;
      rs_of[k1] = rs;
    }
    put_column<false>(st, v, g1, s1, p);
  } else if (p.c < k1 && p.g == g1) {
    st.row[p.c] = v[s1];
  }
}

// Column k = 16 kb + kk of the Cholesky: L's column k goes to the staged L
// (0 above the diagonal); the column becomes inv(Lu)'s column k (1, then
// -m_i; the rows above k are not read again).
__device__ __forceinline__ void chol_pivot(float (&v)[kRows], float* stage, float rs, float rp,
                                           int k, int kb, int kk, const Place& p) {
  float* out = stage + p.r0 * kNB + k;
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    if (p.g < kb || (p.g == kb && s < kk)) {
      out[s * kNB] = 0.f;
    } else if (p.g == kb && s == kk) {
      out[s * kNB] = v[s] * rs;
      v[s] = 1.f;
    } else {
      out[s * kNB] = v[s] * rs;
      v[s] = -(v[s] * rp);
    }
  }
}

// Fused Cholesky + inverse (see the header). Only the lower triangle of a is
// used; l may be a itself.
__global__ void __launch_bounds__(kThreads)
chol_inv_kernel(const float* a, int64_t lda, float* l, int64_t ldl, float* w, int64_t ldw) {
  extern __shared__ __align__(16) float stage[];   // L
  __shared__ Step st[2];
  __shared__ float rs_of[kNB];
  const Place p;
  float v[kRows];
  load_column(v, a, lda, p);
  chol_hand_on(st[0], rs_of, v, 0, 0, 0, p);
  __syncthreads();

  const int last = p.r0 + kRows - 1;
  for (int kb = 0; kb < kNB / kRows; ++kb) {
#pragma unroll
    for (int kk = 0; kk < kRows; ++kk) {
      const int k = kb * kRows + kk;
      const Step& cur = st[kk & 1];
      const float rs = cur.scale;
      const float rp = rs * rs;
      if (p.c == k) {
        chol_pivot(v, stage, rs, rp, k, kb, kk, p);
      } else if ((p.g > kb || (p.g == kb && kk + 1 < kRows)) && (p.c < k || last >= p.c)) {
        // rows below k: right of the pivot the trailing block's lower
        // triangle, left of it inv(Lu)
        update(v, cur.below, (p.c > k ? cur.below[p.c] : cur.row[p.c]) * rp, p);
      }
      if (k + 1 < kNB)
        chol_hand_on(st[(kk + 1) & 1], rs_of, v, k + 1, kb + (kk + 1) / kRows,
                     (kk + 1) % kRows, p);
      __syncthreads();
    }
  }

  store_stage(l, ldl, stage, p);
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    const int i = p.r0 + s;
    w[i * ldw + p.c] = i >= p.c ? v[s] * rs_of[i] : 0.f;
  }
}

}  // namespace

extern "C" {

// Each entry point takes one 128x128 f32 block with unit column stride and
// the given row strides (in elements), launches one thread block on
// `stream`, and returns cudaGetLastError() (0 on success). The first output
// (L\U or L) may be the input block itself.
int tml_chol_inv_block(const float* a, int64_t lda, float* l, int64_t ldl, float* w,
                       int64_t ldw, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      chol_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes);
  if (err != cudaSuccess) return err;
  chol_inv_kernel<<<1, kThreads, kStageBytes, static_cast<cudaStream_t>(stream)>>>(
      a, lda, l, ldl, w, ldw);
  return cudaGetLastError();
}

int tml_lu_inv_block(const float* a, int64_t lda, float* lu, int64_t ldlu, float* wl,
                     int64_t ldwl, float* wu, int64_t ldwu, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      lu_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes);
  if (err != cudaSuccess) return err;
  lu_inv_kernel<<<1, kThreads, kStageBytes, static_cast<cudaStream_t>(stream)>>>(
      a, lda, lu, ldlu, wl, ldwl, wu, ldwu);
  return cudaGetLastError();
}

}  // extern "C"
