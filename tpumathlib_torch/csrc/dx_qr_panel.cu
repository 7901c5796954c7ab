// The panel routes of batched Householder QR and of applying its Q, for
// Hopper (sm_90a), called by tml_geqrf_batched and tml_unmqr_batched
// (csrc/dx_solver.cu, which holds the C entry points and the block routes):
//
//   geqrf_panel_kernel: (QR, tau) of f32 (n, n) matrices, 32 < n <= 224, in
//                       LAPACK geqrf layout.
//   unmqr_panel_kernel: Q^T C or Q C from geqrf's reflectors, QR (m, n) with
//                       m <= 224 beyond the warp route (m > 64 or n > 32), C
//                       (m, k) for any k.
//
// They replace, for those sizes, the TPU kernels of tpumathlib/dx/solver.py:
// geqrf_batched's pallas_call (_run_batched :222, for geqrf_batched :374;
// body _geqrf_body :157) and unmqr_batched's (:597, body _apply_q_body
// :538). The function is that of dx/solver.py's _geqrf_plain and
// _apply_q_plain, with geqrf_steps' dlarfg (csrc/dx_qr_warp.cuh): sign(0) =
// +1, a zero tail gives tau = 0 and leaves its column as it is (its stored
// reflector zero), the reflector stored with v_j = 1 and tau = tau_h v_j^2;
// reflectors j >= m are empty.
//
// geqrf: a block a matrix, a row a thread (np = n rounded up to 32 threads),
// the matrix in shared memory padded with zeros to np x np, rows of np + 4
// floats (getrf_panel_kernel's layout: a multiple of 4 and 4 mod 32, so a
// warp's float4 reads of its rows miss no bank). Right-looking in 32-column
// panels; a panel p0 takes one barrier a column and two more:
// 1. The panel's column steps (panel_steps), in a loop that is not unrolled
//    (with the steps and the reflector loop unrolled the kernel took 2.71 ms
//    at 1024 x 128 on an H100, slower than the block route it replaces;
//    rolled, 1.28 ms, and 0.68 once the products left local memory). Thread
//    r holds row r's panel entries in 32 registers, shifted down one slot a
//    step, so that slot s holds column j + s at step j and every index is
//    known at compile time. Step j forms, in one pass,
//    the tail's sum of squares and the sums x_r a_rc of the later panel
//    columns over the rows r > j: each thread its row's products, a
//    transposing reduction over its warp's lanes (31 shuffles: lane s ends
//    with slot s's sum), the warps' sums to shared memory beside row j's
//    entries (two sets, alternate columns), one barrier; then every thread
//    adds the warps' sums of its lane's slot in warp order, forms dlarfg's
//    scalars from the tail's sum and x_j (every thread the same), lane s
//    forms w = tau_h (s_s + v_j a_j(j+s)), as sum_r v_r a_rc with row j's
//    term last, and hands it to the other lanes by shuffles; each row r >= j
//    subtracts v_r w, the rows below j store v_r / v_j, and row j stores its
//    R entries and drops out (its registers zeroed). Warps whose rows all lie
//    above the panel only keep the barriers. A barrier closes the panel.
// 2. The trailing columns, once a panel (trailing_update): a warp takes 8
//    columns at a time, the rows from p0 in its lanes' registers (lane l rows
//    p0 + l + 32 q), and applies the panel's stored reflectors in order
//    (apply_panel); then a barrier.
// unmqr: a block of 4 warps (8 where C has more than 7 groups of columns),
// C's columns 8 at a time a warp (4 where k = 4 or less), all m rows in its
// lanes' registers (lane l rows l + 32 q), as the warp route holds them.
// The block stages the reflectors one panel at a time by cp.async (every
// copy in flight at once), rows of 36 floats (32 reflectors and 4 of
// padding: float4 reads of four reflectors a row, as geqrf's rows), and
// tau; a barrier; each warp applies the panel's reflectors to its columns
// (apply_panel, j ascending for Q^T, descending for Q), no barrier a
// reflector; a barrier before the next panel. Where C has fewer groups than
// the block has warps a block holds several matrices (4 / groups of them),
// each warp one group of one matrix.
// apply_panel, shared by both, loops over the panel's reflectors 4 at a
// time (a loop that is not unrolled: its code stays small): a float4 read
// a row of the lane's rows, then reflector by reflector the lane's share of
// v^T x's sums (rows in order), each 4 columns' sums over the warp by
// warp_sums4 (every lane gets them) and the update of the lane's rows. Rows
// above a reflector's j take no part, so a NaN there stays there, as in the
// plain version.
//
// What bounds them: at batch 1024 x n 128, geqrf reads A and writes QR and
// tau, 134.7 MB, 0.040 ms at 3.35 TB/s, against 4n^3/3 flop a matrix, 2.9
// GFLOP, 0.043 ms at 67 TFLOP/s: operations, barely. unmqr at 1024 x 128 x
// 128, k = 4, reads QR's lower triangle, tau and C and writes X, 38.5 MB,
// 0.011 ms (bytes); Q I at k = 128 does 4k(mn - n^2/2) flop a matrix, 4.3
// GFLOP, 0.064 ms (operations). What paces them is the chain of dependent
// steps: geqrf's 128 column steps, each a reduction, a barrier and a
// square root, and, in both, each reflector's four sums over a warp. On an
// H100 (700 W; chip_smoke.py phases 20 and 23) geqrf at 1024 x 128 takes
// some 0.68 ms (the block route 2.5), unmqr at k = 4 some 0.05 ms each way
// (the block route 0.34) and Q I some 0.72 ms (8.5).

#include "dx_qr_warp.cuh"

namespace tml_qr {
namespace {

constexpr int kPanelWarps = kPanelMaxN / 32;   // geqrf: a row a thread, 7 warps at most
constexpr int kTile = kPanel + 4;              // unmqr's staged rows: 32 reflectors, 4 mod 32

__host__ __device__ inline int rows_of(int n) { return (n + kPanel - 1) / kPanel * kPanel; }

// A 4-byte copy from device memory to shared memory that does not wait
// (cp.async); copies_done waits for all of this thread's.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copies_done() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// Reflectors j0 + jj (jj < cnt) of a panel applied in order (ascending for
// Q^T, descending for Q) to x, NG groups of 4 columns whose rows r = r0 +
// lane + 32 q (q < R) the lane holds; rows >= m take no part. Reflector j0 +
// jj: 1 at row j0 + jj, below it V(r, jj) = V[r * ldv + jj] (rows 16-byte
// aligned), tau tau[jj]. Chunks of rows wholly above j0 are skipped.
template <int R, int NG, bool ASC>
__device__ __forceinline__ void apply_panel(const float* V, int ldv, const float* tau, int j0,
                                            int cnt, float (&x)[NG][R][4], int lane, int r0,
                                            int m) {
  const int qlo = max(0, (j0 - r0) / 32), quads = (cnt + 3) / 4;
#pragma unroll 1
  for (int i = 0; i < quads; ++i) {
    const int jq = ASC ? i : quads - 1 - i;
    float4 vq[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = r0 + lane + 32 * q;
      vq[q] = q >= qlo && r < m ? *reinterpret_cast<const float4*>(V + r * ldv + 4 * jq)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int ei = 0; ei < 4; ++ei) {
      const int e = ASC ? ei : 3 - ei, jj = 4 * jq + e, j = j0 + jj;
      if (jj >= cnt) continue;
      const float tj = tau[jj];
      float v[R];
      bool on[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int r = r0 + lane + 32 * q;
        const float ve = e == 0 ? vq[q].x : e == 1 ? vq[q].y : e == 2 ? vq[q].z : vq[q].w;
        on[q] = q >= qlo && r >= j && r < m;
        v[q] = r == j ? 1.f : ve;
      }
      float s[NG][4];
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          s[g][cc] = 0.f;
#pragma unroll
          for (int q = 0; q < R; ++q)
            if (on[q]) s[g][cc] = fmaf(v[q], x[g][q][cc], s[g][cc]);
        }
#pragma unroll
      for (int g = 0; g < NG; ++g) warp_sums4(s[g], lane);
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float wq = s[g][cc] * tj;
#pragma unroll
          for (int q = 0; q < R; ++q)
            if (on[q]) x[g][q][cc] = fmaf(-v[q], wq, x[g][q][cc]);
        }
    }
  }
}

// geqrf's trailing update of a panel p0 (whole: it has trailing columns):
// warp `warp` of nw takes the 8-column groups from column p0 + 32 on (the
// last may reach into the padding), rows p0 ... np - 1 (R chunks of 32) from
// shared memory, applies the panel's 32 reflectors (ascending) and writes
// them back.
template <int R>
__device__ void trailing_update(float* A, int ld, int n, int p0, const float* taus, int warp,
                                int nw, int lane) {
  constexpr int NG = 2;
  const int c_beg = p0 + kPanel, groups = (n - c_beg + 4 * NG - 1) / (4 * NG);
  for (int g = warp; g < groups; g += nw) {
    const int c0 = c_beg + 4 * NG * g;
    float x[NG][R][4];
#pragma unroll
    for (int h = 0; h < NG; ++h)
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(A + (p0 + lane + 32 * q) * ld + c0 + 4 * h);
        x[h][q][0] = v.x;
        x[h][q][1] = v.y;
        x[h][q][2] = v.z;
        x[h][q][3] = v.w;
      }
    apply_panel<R, NG, true>(A + p0, ld, taus, p0, kPanel, x, lane, p0, n);
#pragma unroll
    for (int h = 0; h < NG; ++h)
#pragma unroll
      for (int q = 0; q < R; ++q)
        *reinterpret_cast<float4*>(A + (p0 + lane + 32 * q) * ld + c0 + 4 * h) =
            make_float4(x[h][q][0], x[h][q][1], x[h][q][2], x[h][q][3]);
  }
}

// One exchange over lane bit OFF: a lane keeps the half of slots 0 ... 2 OFF
// - 1 its bit selects and adds the partner's. A template, so that every
// slot's index is known at compile time (with the stage a loop variable the
// inner loop stayed a loop, and p went to local memory).
template <int OFF>
__device__ __forceinline__ void transpose_stage(float (&p)[kPanel], int lane) {
  const bool hi = lane & OFF;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float keep = hi ? p[i + OFF] : p[i];
    const float send = hi ? p[i] : p[i + OFF];
    p[i] = keep + __shfl_xor_sync(kFull, send, OFF);
  }
}

// After the five exchanges lane l holds the sum over the warp's lanes of
// p[l], each slot's terms added in the 5-step butterfly's tree (lane l's and
// lane l ^ 16's first).
__device__ __forceinline__ void transpose_sums(float (&p)[kPanel], int lane) {
  transpose_stage<16>(p, lane);
  transpose_stage<8>(p, lane);
  transpose_stage<4>(p, lane);
  transpose_stage<2>(p, lane);
  transpose_stage<1>(p, lane);
}

// The column steps of panel p0 (see the file header, 1): thread tid holds
// row tid, live when p0 <= tid < n. part: two sets of the warps' 32 sums;
// rowj: two sets of row j's 32 slots; taus: the panel's tau (shared), tau
// the matrix's (device memory).
__device__ __forceinline__ void panel_steps(float* A, int ld, int n, int p0, float* part,
                                            float* rowj, float* taus, float* tau, int tid,
                                            int lane, int warp, int nw) {
  const int w0 = p0 / 32;            // the first warp holding rows >= p0
  const bool active = warp >= w0;
  const bool live = tid >= p0 && tid < n;
  float row[kPanel];                 // slot s: column p0 + jj + s at step jj; 0 past the panel
  const float4* mine = reinterpret_cast<const float4*>(A + tid * ld + p0);
#pragma unroll
  for (int q = 0; q < kPanel / 4; ++q) {
    const float4 v = live ? mine[q] : make_float4(0.f, 0.f, 0.f, 0.f);
    row[4 * q] = v.x;
    row[4 * q + 1] = v.y;
    row[4 * q + 2] = v.z;
    row[4 * q + 3] = v.w;
  }
  const int cnt = min(kPanel, n - p0);
#pragma unroll 1
  for (int jj = 0; jj < cnt; ++jj) {
    const int j = p0 + jj;
    float* pj = part + (jj & 1) * kPanelWarps * kPanel;
    float* rj = rowj + (jj & 1) * kPanel;
    const bool tail = live && tid > j;   // this row is below j: its products count
    const float xr = tail ? row[0] : 0.f;
    if (active) {
      float p[kPanel];
#pragma unroll
      for (int c = 0; c < kPanel; ++c) p[c] = tail ? xr * row[c] : 0.f;
      transpose_sums(p, lane);
      pj[warp * kPanel + lane] = p[0];
      if (tid == j) {
#pragma unroll
        for (int q = 0; q < kPanel / 4; ++q)
          reinterpret_cast<float4*>(rj)[q] =
              make_float4(row[4 * q], row[4 * q + 1], row[4 * q + 2], row[4 * q + 3]);
      }
    }
    __syncthreads();
    if (!active) continue;
    float s = 0.f;   // slot `lane`'s sum over the rows below j
    for (int w = w0; w < nw; ++w) s += pj[w * kPanel + lane];
    float tau_h, tau_j;
    bool degenerate;
    const float vj = dlarfg(rj[0], __shfl_sync(kFull, s, 0), tau_h, tau_j, degenerate);
    const float vdiv = vj == 0.f ? 1.f : vj;
    const bool own = live && tid == j;
    if (!degenerate) {
      const float wl = tau_h * fmaf(vj, rj[lane], s);   // w of slot `lane`
      const float vr = own ? vj : xr;
#pragma unroll
      for (int c = 0; c < kPanel; ++c) {
        const float wc = __shfl_sync(kFull, wl, c);
        if ((c > 0 && tail) || own) row[c] = fmaf(-vr, wc, row[c]);
      }
    }
    if (tail) A[tid * ld + j] = (degenerate ? 0.f : xr) / vdiv;
    if (own) {   // row j's R entries, then it drops out
      taus[jj] = tau_j;
      tau[j] = tau_j;
#pragma unroll
      for (int c = 0; c < kPanel; ++c) {
        if (c < kPanel - jj) A[tid * ld + j + c] = row[c];
        row[c] = 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c + 1 < kPanel; ++c) row[c] = row[c + 1];
    row[kPanel - 1] = 0.f;
  }
}

// 168 registers a thread let three blocks of 128 threads share an SM (n =
// 128: shared memory allows three).
__global__ void __maxnreg__(168) geqrf_panel_kernel(const float* __restrict__ a,
                                                    float* __restrict__ qr,
                                                    float* __restrict__ tau, int n) {
  extern __shared__ __align__(16) float smem[];
  const int np = rows_of(n), ld = np + 4, nw = np / 32;
  float* A = smem;
  float* part = A + np * ld;
  float* rowj = part + 2 * kPanelWarps * kPanel;
  float* taus = rowj + 2 * kPanel;
  const int64_t bi = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* src = a + bi * n * n;
  if (n % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int cq = tid % (np / 4), c = 4 * cq;   // thread t: float4 column cq, rows r0 + 4 i
#pragma unroll 4
    for (int r = tid / (np / 4); r < np; r += 4) {
      const float4 v = r < n && c < n ? __ldg(reinterpret_cast<const float4*>(src + r * n) + cq)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(A + r * ld + c) = v;
    }
  } else {
#pragma unroll 8
    for (int r = 0; r < np; ++r)   // thread t loads column t, 8 rows in flight
      A[r * ld + tid] = r < n && tid < n ? __ldg(src + r * n + tid) : 0.f;
  }
  __syncthreads();
  float* t = tau + bi * n;
  for (int p0 = 0; p0 < n; p0 += kPanel) {
    panel_steps(A, ld, n, p0, part, rowj, taus, t, tid, lane, warp, nw);
    __syncthreads();
    if (p0 + kPanel < n) {
      switch ((n - p0 + 31) / 32) {   // rows from p0, in chunks of 32
        case 2: trailing_update<2>(A, ld, n, p0, taus, warp, nw, lane); break;
        case 3: trailing_update<3>(A, ld, n, p0, taus, warp, nw, lane); break;
        case 4: trailing_update<4>(A, ld, n, p0, taus, warp, nw, lane); break;
        case 5: trailing_update<5>(A, ld, n, p0, taus, warp, nw, lane); break;
        case 6: trailing_update<6>(A, ld, n, p0, taus, warp, nw, lane); break;
        default: trailing_update<7>(A, ld, n, p0, taus, warp, nw, lane); break;
      }
      __syncthreads();
    }
  }
  float* o = qr + bi * n * n;
  if (n % 4 == 0 && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
    const int cq = tid % (np / 4), c = 4 * cq;
    for (int r = tid / (np / 4); r < n && c < n; r += 4)
      reinterpret_cast<float4*>(o + r * n)[cq] = *reinterpret_cast<const float4*>(A + r * ld + c);
  } else if (tid < n) {
    for (int r = 0; r < n; ++r) o[r * n + tid] = A[r * ld + tid];
  }
}

// unmqr's launch: 4-column groups a warp takes at once, warps a block,
// matrices a block, warps a matrix (each warp one unit of NG groups of C's
// columns at a time).
struct UnmqrShape {
  int ng, warps, mats, per_mat;
};

__host__ __device__ inline UnmqrShape unmqr_shape(int k) {
  const int ng = k > 4 ? 2 : 1, units = (k + 4 * ng - 1) / (4 * ng);
  const int warps = units > 7 ? 8 : 4;
  return units >= warps ? UnmqrShape{ng, warps, 1, warps}
                        : UnmqrShape{ng, warps, warps / units, units};
}

// R = rows of 32 holding m, NG = groups of 4 columns a warp, TRANS: Q^T C
// (reflectors ascending) or Q C. Shared memory: for each matrix of the
// block its staged panel (m x kTile) and the panel's 32 tau. With launch
// bounds of 256 threads alone ptxas held some instantiations to 64 or 80
// registers and spilled a few loop-invariant values; one block an SM lets
// it take what it needs.
template <int R, int NG, bool TRANS>
__global__ void __launch_bounds__(256, 1) unmqr_panel_kernel(const float* __restrict__ qr,
                                                          const float* __restrict__ tau,
                                                          const float* __restrict__ c,
                                                          float* __restrict__ x, int m, int n,
                                                          int k, int64_t batch) {
  extern __shared__ __align__(16) float smem[];
  const UnmqrShape sh = unmqr_shape(k);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  const int steps = min(m, n), units = (k + 4 * NG - 1) / (4 * NG), tile = m * kTile;
  float* tiles = smem;
  float* taus = smem + sh.mats * tile;
  const int slot = warp / sh.per_mat;            // this warp's matrix in the block
  const int64_t b0 = int64_t(blockIdx.x) * sh.mats, bi = b0 + slot;
  const bool mine = slot < sh.mats && bi < batch;
  const float* C = c + bi * m * k;
  float* X = x + bi * m * k;
  const int npanels = (steps + kPanel - 1) / kPanel;
  for (int u0 = 0; u0 < units; u0 += sh.per_mat) {
    const int c0 = 4 * NG * (u0 + warp % sh.per_mat);
    const bool work = mine && c0 < k;
    float xv[NG][R][4];
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int r = lane + 32 * q, col = c0 + 4 * g + cc;
          xv[g][q][cc] = work && r < m && col < k ? __ldg(C + r * k + col) : 0.f;
        }
    for (int i = 0; i < npanels; ++i) {
      const int p0 = (TRANS ? i : npanels - 1 - i) * kPanel, cnt = min(kPanel, steps - p0);
      for (int s = 0; s < sh.mats; ++s) {   // lane jj copies reflector jj's entries
        const bool copy = b0 + s < batch && lane < cnt;
        const float* q = qr + (b0 + s) * m * n + p0 + lane;
        for (int r = p0 + warp; r < m; r += warps)
          if (copy) copy_async(tiles + s * tile + r * kTile + lane, q + r * n);
        if (copy && warp == 0) copy_async(taus + s * kPanel + lane, tau + (b0 + s) * n + p0 + lane);
      }
      copies_done();
      __syncthreads();
      if (work)
        apply_panel<R, NG, TRANS>(tiles + slot * tile, kTile, taus + slot * kPanel, p0, cnt, xv,
                                  lane, 0, m);
      __syncthreads();
    }
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int r = lane + 32 * q, col = c0 + 4 * g + cc;
          if (work && r < m && col < k) X[r * k + col] = xv[g][q][cc];
        }
  }
}

template <class Kernel>
cudaError_t smem_for(Kernel kernel, int64_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

using UnmqrKernel = void (*)(const float*, const float*, const float*, float*, int, int, int,
                             int64_t);

template <int NG, bool TRANS>
UnmqrKernel unmqr_kernel_for(int m) {
  static const UnmqrKernel kernels[kPanelWarps] = {
      unmqr_panel_kernel<1, NG, TRANS>, unmqr_panel_kernel<2, NG, TRANS>,
      unmqr_panel_kernel<3, NG, TRANS>, unmqr_panel_kernel<4, NG, TRANS>,
      unmqr_panel_kernel<5, NG, TRANS>, unmqr_panel_kernel<6, NG, TRANS>,
      unmqr_panel_kernel<7, NG, TRANS>};
  return kernels[(m + 31) / 32 - 1];
}

}  // namespace

cudaError_t launch_geqrf_panel(const float* a, float* qr, float* tau, int64_t batch, int n,
                               cudaStream_t stream) {
  const int64_t bytes = geqrf_panel_bytes(n);
  const cudaError_t e = smem_for(geqrf_panel_kernel, bytes);
  if (e != cudaSuccess) return e;
  geqrf_panel_kernel<<<static_cast<unsigned>(batch), rows_of(n), static_cast<size_t>(bytes), stream>>>(a, qr, tau, n);
  return cudaGetLastError();
}

cudaError_t launch_unmqr_panel(const float* qr, const float* tau, const float* c, float* x,
                               int64_t batch, int m, int n, int k, bool trans, cudaStream_t stream) {
  if (k == 0) return cudaSuccess;
  const UnmqrShape sh = unmqr_shape(k);
  UnmqrKernel kernel;
  switch (sh.ng) {
    case 1: kernel = trans ? unmqr_kernel_for<1, true>(m) : unmqr_kernel_for<1, false>(m); break;
    default: kernel = trans ? unmqr_kernel_for<2, true>(m) : unmqr_kernel_for<2, false>(m); break;
  }
  const int64_t bytes = 4 * int64_t(sh.mats) * (int64_t(m) * kTile + kPanel);
  const cudaError_t e = smem_for(kernel, bytes);
  if (e != cudaSuccess) return e;
  const unsigned blocks = static_cast<unsigned>((batch + sh.mats - 1) / sh.mats);
  kernel<<<blocks, sh.warps * 32, static_cast<size_t>(bytes), stream>>>(qr, tau, c, x, m, n, k, batch);
  return cudaGetLastError();
}

}  // namespace tml_qr
