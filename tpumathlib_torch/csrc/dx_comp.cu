// The cascaded codec of the nvCOMPDx tier, for Hopper (sm_90a):
//
//   tml_cascaded_encode:     int32 values -> for each row of 128 values,
//                            4 * bits packed uint32 words and an int32 leader;
//   tml_cascaded_decode:     the inverse, int32 values;
//   tml_cascaded_decode_dot: the decode fused with (values * scale) @ W, the
//                            128 values of a row against W (128, N), f32 out.
//
// Replaces the TPU kernels of tpumathlib/dx/comp.py: dx_compress's pallas_call
// (:233), dx_decompress's (:186) and dx_decompress_dot's (:302). There the word
// to lane spreading and the row prefix sums are one-hot matmuls on the MXU,
// because Mosaic cannot gather lanes; here each lane reads its fields
// directly and the prefix sum is a warp scan. tpumathlib_torch/dx/comp.py
// holds the wrappers and the plain PyTorch versions (_dx_compress_plain,
// _dx_decompress_plain, _dx_decompress_dot_plain).
//
// The format. In a row, delta 0 is 0 and delta j = v[j] - v[j-1], wrapping as
// int32 does; each delta is zigzagged, z = (d << 1) ^ (d >> 31), and packed at
// `bits` (1..32) bits a value: value j of each 32-value group g takes the
// group's bits j*bits .. j*bits + bits - 1, so word g*bits + (j*bits)/32 from
// shift (j*bits)%32, with the low bits of the next word where the field
// crosses. The leader is the row's first value. Decoding sums the zigzag-
// decoded deltas over the row and adds the leader, all in uint32, so it wraps
// mod 2^32 as the reference's sums do. A field is read with a 64-bit funnel
// shift and a mask that is 0xffffffff at bits = 32, so nothing shifts by 32.
//
// The kernels:
//   decode:     one warp a row, 8 rows a block. The warp copies the row's
//               4*bits words to shared memory; lane l decodes values 4l..4l+3,
//               sums its 4, and an inclusive __shfl_up_sync scan over the warp
//               gives each lane the sum before its first value; lane l stores
//               its 4 values as one int4. Only the first `count` values are
//               written.
//   encode:     one warp a row. Lane l reads values 4l..4l+3 (indices past n
//               clamp to n - 1, so a partial last row is padded with the last
//               value and needs no padded copy), takes the previous value of
//               its first one from lane l - 1 by shuffle, zigzags the deltas
//               into shared memory, and each lane ORs the at most
//               ceil(32/bits) + 1 fields that overlap each of its words.
//   decode_dot: persistent blocks of 384 threads, one an SM for each
//               128-column tile of W (grid: SMs x ceil(N / 128)), each walking
//               64-row tiles blockIdx.x, + gridDim.x, ... In its prologue a
//               block stages its column tile of W (zero past N) and writes the
//               TF32 hi and lo planes of its transpose (K-major, TMA's
//               128-byte swizzle: what wgmma's descriptor reads), 128 KB that
//               stay resident for the walk. Four decode warps are the
//               producers, a pair a tile: each warp decodes 32 rows, a row
//               a lane (the row is one bitstream: value j at bits j bits ..
//               of its 4 bits words; the running sum stays in a register,
//               no shuffle), its rows' words staged from registers into the
//               warp's shared area with an odd row stride so that the
//               lanes' reads fall in distinct banks, the next words loading
//               meanwhile; it writes float(v) * scale (in that order, as the
//               reference's vals.astype(f32) * scale) into the pair's A
//               tile (64 x 128 f32, the same swizzle), one 16-byte store a
//               lane, and hands each 32-value k chunk over as soon as it is
//               written. The two consumer warpgroups take alternate tiles,
//               each from its pair's A tile: they split A in registers and
//               run three wgmma m64n128k8 tf32 a k8 step (hopper_ring.cuh's
//               stage_tf32x3_at), each 32-deep stage into a fresh partial
//               summed into the accumulator in f32 (the tensor cores' own
//               sums do not round to nearest), release each chunk to the
//               decoders once its fragments are read, and store their 64 x
//               128 from registers while the other warpgroup's products
//               run.
//               mbarriers hand each chunk over (full: the pair's 64
//               threads; empty: the consumer's 128). Ragged N and the last
//               tile's rows are masked. The decoded matrix never reaches
//               device memory.
//
// What bounds them: decode and encode move bytes and do a few integer
// operations a value. At 64 Mi values and bits = 8 that is 268 MB of int32, 67
// MB of words and 2 MB of leaders, 0.101 ms at 3.35 TB/s. decode_dot at 524288
// rows and N = 128 runs its 17.2 GFLOP as three TF32 products, 51.5 GFLOP,
// 0.104 ms at 495 TFLOP/s; its bytes (the words, the leaders, W and the 268
// MB of f32 output) take 0.101 ms, so its output's stores have to overlap the
// products.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "hopper_ring.cuh"

namespace {

constexpr int kRow = 128;               // values a row
constexpr int kMaxWords = 128;          // 4 * bits at bits = 32
constexpr int kWarps = 8;               // warps (rows) a block of encode and decode
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t field_mask(int bits) {
  return bits == 32 ? 0xffffffffu : (1u << bits) - 1u;
}

__device__ __forceinline__ int32_t zigzag_dec(uint32_t z) {
  return static_cast<int32_t>(z >> 1) ^ -static_cast<int32_t>(z & 1u);
}

__device__ __forceinline__ uint32_t zigzag_enc(int32_t d) {
  return (static_cast<uint32_t>(d) << 1) ^ static_cast<uint32_t>(d >> 31);
}

// Value j of a row whose 4*bits words are in w.
__device__ __forceinline__ uint32_t unpack(const uint32_t* w, int bits, int j) {
  const int bit = (j & 31) * bits;
  const int wi = (j >> 5) * bits + (bit >> 5);
  const uint32_t hi = wi + 1 < 4 * bits ? w[wi + 1] : 0u;
  return __funnelshift_r(w[wi], hi, bit & 31) & field_mask(bits);
}

// The warp copies row `row`'s words to w.
__device__ __forceinline__ void stage_row(const uint32_t* __restrict__ packed, int64_t row,
                                          int bits, uint32_t* w, int lane) {
  const int nw = 4 * bits;
  const uint32_t* src = packed + row * nw;
  for (int i = lane; i < nw; i += 32) w[i] = src[i];
  __syncwarp();
}

// Decodes the row staged in w: lane gets values 4*lane .. 4*lane + 3 in v.
__device__ __forceinline__ void decode4(const uint32_t* w, int bits, uint32_t leader, int lane,
                                        uint32_t v[4]) {
  uint32_t s = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    s += static_cast<uint32_t>(zigzag_dec(unpack(w, bits, 4 * lane + t)));
    v[t] = s;
  }
  uint32_t x = s;   // inclusive scan of the lanes' sums
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  const uint32_t base = leader + x - s;
#pragma unroll
  for (int t = 0; t < 4; ++t) v[t] += base;
}

__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const uint32_t* __restrict__ packed, const int32_t* __restrict__ leaders,
              int32_t* __restrict__ out, int64_t rows, int64_t count, int bits, bool vec) {
  __shared__ uint32_t words[kWarps][kMaxWords];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = int64_t(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;   // the whole warp, which shares no barrier with the others
  stage_row(packed, row, bits, words[warp], lane);
  uint32_t v[4];
  decode4(words[warp], bits, static_cast<uint32_t>(leaders[row]), lane, v);
  const int64_t i0 = row * kRow + 4 * lane;
  if (vec && i0 + 4 <= count) {
    *reinterpret_cast<int4*>(out + i0) =
        make_int4(static_cast<int>(v[0]), static_cast<int>(v[1]), static_cast<int>(v[2]),
                  static_cast<int>(v[3]));
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (i0 + t < count) out[i0 + t] = static_cast<int32_t>(v[t]);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
encode_kernel(const int32_t* __restrict__ values, uint32_t* __restrict__ packed,
              int32_t* __restrict__ leaders, int64_t n, int64_t rows, int bits, bool vec) {
  __shared__ uint32_t zz[kWarps][kRow];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = int64_t(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;
  const int64_t i0 = row * kRow + 4 * lane;
  int32_t v[4];
  if (vec && i0 + 4 <= n) {
    const int4 q = *reinterpret_cast<const int4*>(values + i0);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) v[t] = values[i0 + t < n ? i0 + t : n - 1];
  }
  const int32_t before = __shfl_up_sync(kFull, v[3], 1);
  uint32_t* z = zz[warp];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int32_t prev = t ? v[t - 1] : before;
    const uint32_t d = lane == 0 && t == 0 ? 0u
                                           : static_cast<uint32_t>(v[t]) - static_cast<uint32_t>(prev);
    z[4 * lane + t] = zigzag_enc(static_cast<int32_t>(d));
  }
  __syncwarp();
  const int nw = 4 * bits;
  const uint32_t mask = field_mask(bits);
  for (int w = lane; w < nw; w += 32) {
    const int g = w / bits;
    const int b0 = 32 * (w - g * bits);   // the word's first bit in its group
    const int j1 = min(31, (b0 + 31) / bits);
    uint32_t word = 0;
    for (int j = b0 / bits; j <= j1; ++j) {
      const uint32_t f = z[32 * g + j] & mask;
      const int p = j * bits;
      word |= p >= b0 ? f << (p - b0) : f >> (b0 - p);
    }
    packed[row * nw + w] = word;
  }
  if (lane == 0) leaders[row] = v[0];
}

// decode_dot's block: two consumer warpgroups, then four decode warps.
constexpr int kDotRows = 64;                            // rows a tile: one warpgroup's m64
constexpr int kDotCols = 128;                           // W's columns a block: m64n128
constexpr int kDotConsumers = 256;
constexpr int kDotThreads = kDotConsumers + 128;
constexpr uint32_t kDotChunk = kDotRows * 128;          // 64 rows x 32 values of A, 8 KB
constexpr uint32_t kDotTile = 4 * kDotChunk;            // the tile's 64 x 128 values, 32 KB
constexpr uint32_t kDotWChunk = kDotCols * 128;         // 128 rows x 32 values of a plane of W^T
constexpr uint32_t kDotW = 8 * kDotWChunk;              // hi and lo planes of W^T, 128 KB
constexpr int kDotStage = 32 * 33;                       // a staging buffer: 32 rows of 32 words, odd stride
constexpr int kDotSmem = static_cast<int>(kDotW + 2 * kDotTile) + 4 * 2 * 4 * kDotStage + 1024;

// The 32 values of a staged group of a row at w (its bits words): each field
// zigzag-decoded and summed onto `sum` in uint32, v[j] = float(sum) * scale
// (the reference's f32(v) * scale). Value j's field starts at bit j bits and
// takes the next word's low bits where it crosses (w[wi + 1] past the group
// is the pad or the next row's first word, masked off).
__device__ __forceinline__ void decode_group(const uint32_t* w, int bits, uint32_t& sum, float scale,
                                             float (&v)[32]) {
  const uint32_t mask = field_mask(bits);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int bit = j * bits, wi = bit >> 5;
    sum += static_cast<uint32_t>(zigzag_dec(__funnelshift_r(w[wi], w[wi + 1], bit & 31) & mask));
    v[j] = float(static_cast<int32_t>(sum)) * scale;
  }
}

// The same for a power-of-two width BITS, known at compile time: no field
// crosses a word, and each word is loaded once.
template <int BITS>
__device__ __forceinline__ void decode_group(const uint32_t* w, uint32_t& sum, float scale,
                                             float (&v)[32]) {
  constexpr uint32_t kMask = BITS == 32 ? 0xffffffffu : (1u << BITS) - 1u;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    sum += static_cast<uint32_t>(zigzag_dec((w[j * BITS / 32] >> (j * BITS % 32)) & kMask));
    v[j] = float(static_cast<int32_t>(sum)) * scale;
  }
}

// A 4-byte copy from device memory into shared memory, asynchronous (its
// completion waited for by cp_async_wait1 after a later commit).
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(tml_ring::smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Returns once every commit group of this thread but the newest is done.
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A load that the compiler keeps where it is written (a volatile asm), so
// that it flies while the code after it runs.
__device__ __forceinline__ int32_t ld_global_nc(const int32_t* p) {
  int32_t v;
  asm volatile("ld.global.nc.s32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

// Stages W's column tile and writes the TF32 planes of its transpose into
// the resident W^T: plane p (0 hi, 1 lo), k chunk q at w_s + (4 p + q)
// kDotWChunk, element (n, c) at swizzled(n, c). W goes first, coalesced, to
// `staged` as (k, n ^ (k mod 32)), so that both the staging and the
// transposed reads (a warp a row n, lanes along k) are free of bank conflicts.
__device__ __forceinline__ void stage_w(const float* __restrict__ wm, int64_t ncols, int64_t col0,
                                        float* staged, uint8_t* w_s) {
  for (int e = threadIdx.x; e < kRow * kDotCols; e += kDotThreads) {
    const int kk = e / kDotCols, c = e % kDotCols;
    staged[kk * kDotCols + (c ^ (kk & 31))] = col0 + c < ncols ? wm[kk * ncols + col0 + c] : 0.f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kRow * kDotCols; e += kDotThreads) {
    const int c = e & 31, n = (e >> 5) % kDotCols, q = (e >> 5) / kDotCols, kk = 32 * q + c;
    const float v = staged[kk * kDotCols + (n ^ c)];
    const uint32_t hi = tml_ring::rna_tf32(v), lo = tml_ring::rna_tf32(v - __uint_as_float(hi));
    *reinterpret_cast<uint32_t*>(w_s + q * kDotWChunk + tml_ring::swizzled(n, c)) = hi;
    *reinterpret_cast<uint32_t*>(w_s + (4 + q) * kDotWChunk + tml_ring::swizzled(n, c)) = lo;
  }
  tml_ring::fence_proxy_async();   // the planes are wgmma's operands
  __syncthreads();
}

__global__ void __launch_bounds__(kDotThreads, 1)
decode_dot_kernel(const uint32_t* __restrict__ packed, const int32_t* __restrict__ leaders,
                  const float* __restrict__ wm, float* __restrict__ out, int64_t rows,
                  int64_t ncols, int bits, float scale, bool out8) {
  using namespace tml_ring;
  extern __shared__ uint8_t smem_raw[];
  // full[b][q] / empty[b][q]: k chunk q of A tile b written / read
  __shared__ __align__(8) uint64_t full[2][4], empty[2][4];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;   // the swizzle repeats every 1024 bytes
  uint8_t* w_s = smem_raw + (base - smem_u32(smem_raw));
  uint8_t* a_s = w_s + kDotW;                                   // two A tiles
  uint32_t* words_s = reinterpret_cast<uint32_t*>(a_s + 2 * kDotTile);
  const uint32_t w_u = base, a_u = base + kDotW;
  const int64_t ntiles = (rows + kDotRows - 1) / kDotRows, col0 = int64_t(blockIdx.y) * kDotCols;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      for (int q = 0; q < 4; ++q) {
        mbar_init(smem_u32(&full[b][q]), 64);    // the tile's two decode warps
        mbar_init(smem_u32(&empty[b][q]), 128);  // the tile's consumer warpgroup
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  stage_w(wm, ncols, col0, reinterpret_cast<float*>(a_s), w_s);   // A's tiles stage W first

  if (threadIdx.x >= kDotConsumers) {
    // Decode warp dw: the pair p = dw / 2 decodes the tiles i = p, p + 2, ...
    // of the block into A tile p, warp h = dw % 2 rows 32 h .. 32 h + 31 of
    // each, a row a lane: the row is one bitstream (value j at bits j bits ..
    // of its 4 bits words), decoded in order with the running sum in a
    // register, k chunk q (values 32 q ..) handed over as soon as it is
    // written. The rows' words come by cp.async into one of the warp's two
    // staging buffers, `groups` groups (at most 32 words) a row at a time,
    // with an odd row stride so that the lanes' reads of their rows fall in
    // distinct banks; the next groups' copies fly while these decode.
    const int dw = (threadIdx.x - kDotConsumers) / 32, lane = threadIdx.x % 32;
    const int p = dw >> 1, h = dw & 1, nw = 4 * bits;
    const int groups = bits <= 8 ? 4 : bits <= 16 ? 2 : 1;
    const int gb = groups * bits, stride = gb | 1;   // words a row staged, their row stride
    uint32_t* area = words_s + dw * 2 * kDotStage;
    auto copy_words = [&](int64_t tile, int g0, int buf) {   // one commit group
      const int64_t r0 = tile * kDotRows + 32 * h;
      uint32_t* dst = area + buf * kDotStage + lane;
      const uint32_t* src = packed + r0 * nw + g0 * bits + lane;
      if (lane < gb) {
#pragma unroll 8
        for (int rr = 0; rr < 32; ++rr)
          if (r0 + rr < rows) cp_async4(dst + rr * stride, src + rr * nw);
      }
      cp_async_commit();
    };
    auto leader = [&](int64_t tile) {
      const int64_t row = tile * kDotRows + 32 * h + lane;
      return row < rows ? ld_global_nc(leaders + row) : 0;
    };
    int64_t t = blockIdx.x + int64_t(p) * gridDim.x;
    int32_t lead = 0, lead_next = 0;
    if (t < ntiles) {
      copy_words(t, 0, 0);
      lead = leader(t);
    }
    for (int i = p, k = 0; t < ntiles; i += 2, t += 2 * int64_t(gridDim.x)) {
      const int r = 32 * h + lane;   // the lane's row of the tile
      const bool live = t * kDotRows + r < rows;
      uint32_t sum = static_cast<uint32_t>(lead);
      for (int g0 = 0; g0 < 4; g0 += groups, ++k) {
        // the next staged groups: this tile's, or the pair's next tile's first
        const bool same = g0 + groups < 4;
        const int64_t tn = same ? t : t + 2 * int64_t(gridDim.x);
        if (tn < ntiles) {
          copy_words(tn, same ? g0 + groups : 0, (k + 1) & 1);
          if (!same) lead_next = leader(tn);
        } else {
          cp_async_commit();   // an empty group, so that one wait serves every step
        }
        cp_async_wait1();      // every group but the newest: these words landed
        __syncwarp();
        const uint32_t* w = area + (k & 1) * kDotStage + lane * stride;
        for (int q = g0; q < g0 + groups; ++q) {
          mbar_wait(smem_u32(&empty[p][q]), ((i >> 1) & 1) ^ 1);   // the first round passes
          uint8_t* chunk = a_s + p * kDotTile + q * kDotChunk;
          const int w0 = (q - g0) * bits;   // the group's first staged word
          float v[32];
          switch (bits) {   // a power-of-two width at compile time: each word loaded once
            case 1: decode_group<1>(w + w0, sum, scale, v); break;
            case 2: decode_group<2>(w + w0, sum, scale, v); break;
            case 4: decode_group<4>(w + w0, sum, scale, v); break;
            case 8: decode_group<8>(w + w0, sum, scale, v); break;
            case 16: decode_group<16>(w + w0, sum, scale, v); break;
            case 32: decode_group<32>(w + w0, sum, scale, v); break;
            default: decode_group(w + w0, bits, sum, scale, v);
          }
#pragma unroll
          for (int j = 0; j < 32; j += 4) {
            const float4 q4 = live ? make_float4(v[j], v[j + 1], v[j + 2], v[j + 3])
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
            *reinterpret_cast<float4*>(chunk + swizzled(r, j)) = q4;
          }
          mbar_arrive(smem_u32(&full[p][q]));
        }
        __syncwarp();   // the buffer is read before the copies after next overwrite it
      }
      lead = lead_next;
    }
    return;
  }

  // consumer cg: tiles i = cg, cg + 2, ... of the block, from A tile cg,
  // each k chunk released once its fragments are read
  const int cg = threadIdx.x / 128;
  const uint32_t tile = a_u + cg * kDotTile;
  const bool two = out8 && ncols % 2 == 0;
  int i = cg;
  for (int64_t t = blockIdx.x + int64_t(cg) * gridDim.x; t < ntiles; t += 2 * int64_t(gridDim.x), i += 2) {
    // consume_tf32x3's sums: each 32-deep stage's products into a fresh
    // partial, added into acc in f32
    float acc[64], part[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.f;
#pragma unroll 1
    for (int q = 0; q < 4; ++q) {
      mbar_wait(smem_u32(&full[cg][q]), (i >> 1) & 1);
      stage_tf32x3_at(part, tile + q * kDotChunk, w_u + q * kDotWChunk, w_u + (4 + q) * kDotWChunk);
      mbar_arrive(smem_u32(&empty[cg][q]));   // every read of the chunk done
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fold(acc, part);
    }
#pragma unroll
    for (int j = 0; j < 64; j += 2) {
      const int2 rc = frag_pos(j);
      const int64_t row = t * kDotRows + rc.x, col = col0 + rc.y;
      if (row < rows && col < ncols)
        store_pair(out, row * ncols + col, acc[j], acc[j + 1], col + 1 < ncols, two);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool bad_bits(int bits) { return bits < 1 || bits > 32; }

}  // namespace

extern "C" {

// packed: (rows, 4 * bits) uint32 contiguous; leaders: (rows,) int32. Writes
// the first `count` <= rows * 128 decoded int32 values to out. Launches on
// `stream`; returns the CUDA status (0 on success).
int tml_cascaded_decode(const void* packed, const void* leaders, void* out, int64_t rows,
                        int64_t count, int bits, void* stream) {
  if (packed == nullptr || leaders == nullptr || out == nullptr || bad_bits(bits) || rows < 0 ||
      count < 0 || count > rows * kRow)
    return cudaErrorInvalidValue;
  const int64_t live = (count + kRow - 1) / kRow;   // rows holding a value to write
  if (live == 0) return cudaSuccess;
  const int64_t blocks = (live + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  decode_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(leaders),
      static_cast<int32_t*>(out), live, count, bits, aligned16(out));
  return cudaGetLastError();
}

// values: (n,) int32 contiguous. Writes packed (ceil(n / 128), 4 * bits) uint32
// and leaders (ceil(n / 128),) int32; a partial last row is padded with
// values[n - 1].
int tml_cascaded_encode(const void* values, void* packed, void* leaders, int64_t n, int bits,
                        void* stream) {
  if (values == nullptr || packed == nullptr || leaders == nullptr || bad_bits(bits) || n < 0)
    return cudaErrorInvalidValue;
  const int64_t rows = (n + kRow - 1) / kRow;
  if (rows == 0) return cudaSuccess;
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  encode_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(values), static_cast<uint32_t*>(packed),
      static_cast<int32_t*>(leaders), n, rows, bits, aligned16(values));
  return cudaGetLastError();
}

// packed, leaders as for tml_cascaded_decode; w: (128, ncols) f32 contiguous.
// Writes out (rows, ncols) f32 = (values (rows, 128) * scale) @ w, each
// value float(v) * scale before the 3xTF32 product.
int tml_cascaded_decode_dot(const void* packed, const void* leaders, const void* w, void* out,
                            int64_t rows, int64_t ncols, int bits, float scale, void* stream) {
  if (packed == nullptr || leaders == nullptr || w == nullptr || out == nullptr ||
      bad_bits(bits) || rows < 0 || ncols < 0)
    return cudaErrorInvalidValue;
  if (rows == 0 || ncols == 0) return cudaSuccess;
  const int64_t ntiles = (rows + kDotRows - 1) / kDotRows, gy = (ncols + kDotCols - 1) / kDotCols;
  if (gy > 65535) return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  static std::atomic<uint64_t> raised{0};
  e = tml_ring::raise_smem_once(reinterpret_cast<const void*>(decode_dot_kernel), kDotSmem, raised);
  if (e != cudaSuccess) return e;
  const unsigned gx = static_cast<unsigned>(ntiles < sms ? ntiles : sms);   // persistent: a block an SM
  decode_dot_kernel<<<dim3(gx, static_cast<unsigned>(gy)), kDotThreads, kDotSmem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(leaders),
      static_cast<const float*>(w), static_cast<float*>(out), rows, ncols, bits, scale,
      reinterpret_cast<uintptr_t>(out) % 8 == 0);
  return cudaGetLastError();
}

}  // extern "C"
