// What both routes of the batched Jacobi kernels share (csrc/dx_jacobi.cu:
// the warp route and the C entry points; csrc/dx_jacobi_block.cu: the block
// route): the rotation of a pair, the circle method's slots, and the turns,
// rotations and column sums of rows held in registers.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tml_jacobi {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxN = 64;    // the largest n of both routes
constexpr int kWarpN = 32;   // the warp route's largest n

__host__ __device__ constexpr int ceil_log2(int n) {
  return n <= 1 ? 0 : 1 + ceil_log2((n + 1) / 2);
}

// The rotation of one pair, from its two diagonal entries (or squared column
// norms) and its coupling.
__device__ __forceinline__ void rot_coeffs(float app, float aqq, float apq, float& c, float& s) {
  if (!(fabsf(apq) > 1e-30f)) {
    c = 1.f;
    s = 0.f;
    return;
  }
  const float tau = (aqq - app) / (2.f * apq);
  const float t = tau == 0.f ? 1.f : copysignf(1.f, tau) / (fabsf(tau) + sqrtf(1.f + tau * tau));
  c = rsqrtf(1.f + t * t);
  s = t * c;
}

// _roundrobin(NPAD) as the circle method lays it out. Index 0 stays in slot
// 0; in round r (0 <= r < kM) slot s >= 1 holds index 1 + (s - 1 + r) mod kM,
// so between rounds slot s takes what slot s + 1 held and slot kM what slot
// 1 held. Pair k takes slots (0, 1) for k = 0 and (1 + k, NPAD - k)
// otherwise, its p first: round r's pairs in _roundrobin's order and roles.
// For odd n (= kM) the spare index kM sits in slot kM - r. Thread (or lane)
// i < NPAD holds row i; nothing here depends on how many threads there are.
template <int NPAD>
struct Circle {
  static constexpr int kM = NPAD - 1;
  static constexpr int kPairs = NPAD / 2;
  __host__ __device__ static constexpr int p_slot(int k) { return k == 0 ? 0 : 1 + k; }
  __host__ __device__ static constexpr int q_slot(int k) { return k == 0 ? 1 : NPAD - k; }
  __device__ static int index_at(int s, int r) {
    const int i = s - 1 + r;
    return s == 0 ? 0 : 1 + (i >= kM ? i - kM : i);
  }
  __device__ static int slot_of(int i, int r) {
    const int d = i - 1 - r;
    return i == 0 ? 0 : 1 + (d < 0 ? d + kM : d);
  }
  __device__ static int partner_slot(int s) { return s == 0 ? 1 : s == 1 ? 0 : NPAD + 1 - s; }
  __device__ static int pair_of(int s) { return s <= 1 ? 0 : s <= kPairs ? s - 1 : NPAD - s; }
  __device__ static bool holds_p(int s) { return s == 0 || (s >= 2 && s <= kPairs); }
  // The slot that holds, a round earlier, what slot s holds.
  __device__ static int earlier(int s) { return s == 0 ? 0 : s == kM ? 1 : s + 1; }
  // The pair of the spare index in round r for odd n, which no column turn
  // touches; -1 for even n.
  __device__ static int dead(bool odd, int r) { return odd ? pair_of(kM - r) : -1; }
};

__device__ __forceinline__ void turn(float& x, float& y, float c, float s) {
  const float x0 = x, y0 = y;
  x = c * x0 - s * y0;
  y = s * x0 + c * y0;
}

// Columns p and q of A's and V's rows for every pair but `dead` (the spare
// index's, for odd n; -1 for even n), with the round's (c, s) from cs: pair
// k's at cs[k / 2] (.x, .y for even k, .z, .w for odd). SKIP false: no pair
// is dead (even n), and none is tested, so that no branch splits the turns.
template <int NPAD, bool SKIP = true>
__device__ __forceinline__ void turn_columns(float (&a)[NPAD], float (&v)[NPAD], const float4* cs,
                                             int dead) {
  using C = Circle<NPAD>;
#pragma unroll
  for (int k = 0; k < C::kPairs; k += 2) {
    const float4 q = cs[k / 2];
    if (!SKIP || k != dead) {
      turn(a[C::p_slot(k)], a[C::q_slot(k)], q.x, q.y);
      turn(v[C::p_slot(k)], v[C::q_slot(k)], q.x, q.y);
    }
    if (k + 1 < C::kPairs && (!SKIP || k + 1 != dead)) {
      constexpr int kLast = C::kPairs - 1;   // k + 1 past the pairs is never read
      const int k1 = k + 1 < C::kPairs ? k + 1 : kLast;
      turn(a[C::p_slot(k1)], a[C::q_slot(k1)], q.z, q.w);
      turn(v[C::p_slot(k1)], v[C::q_slot(k1)], q.z, q.w);
    }
  }
}

// Slots 1 .. kM move down by one: slot s takes slot s + 1's column.
template <int NPAD>
__device__ __forceinline__ void rotate(float (&x)[NPAD]) {
  const float first = x[1];
#pragma unroll
  for (int s = 1; s + 1 < NPAD; ++s) x[s] = x[s + 1];
  x[NPAD - 1] = first;
}

// One step of summing a value held in every lane over the warp's lanes: a
// lane keeps lo, or hi where its lane bit `mask` is set, and adds its xor
// partner's copy of it, one shuffle a value kept. halve_pairs takes the
// steps from MASK down to 1 on HALF values at a time, each step halving the
// pairs a lane holds; the steps recurse on HALF so that every index is known
// at compile time.
__device__ __forceinline__ void halve(float& lo, float hi, bool up, int mask) {
  const float keep = up ? hi : lo, send = up ? lo : hi;
  lo = keep + __shfl_xor_sync(kFull, send, mask);
}

template <int HALF, int H, int MASK>
__device__ __forceinline__ void halve_pairs(float (&al)[H], float (&be)[H], float (&ga)[H],
                                            int lane) {
  if constexpr (HALF >= 1) {
    const bool up = lane & MASK;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      halve(al[i], al[i + HALF], up, MASK);
      halve(be[i], be[i + HALF], up, MASK);
      halve(ga[i], ga[i + HALF], up, MASK);
    }
    halve_pairs<HALF / 2, H, MASK / 2>(al, be, ga, lane);
  }
}

// The block route (csrc/dx_jacobi_block.cu), 33 <= n <= 64: syevd (svd
// false: d = w) or gesvd (u, d = s) of `batch` f32 (n, n) matrices at a,
// `sweeps` sweeps, on `stream`.
cudaError_t launch_block_route(bool svd, const float* a, float* u, float* d, float* v,
                               int64_t batch, int n, int sweeps, cudaStream_t stream);

}  // namespace tml_jacobi
