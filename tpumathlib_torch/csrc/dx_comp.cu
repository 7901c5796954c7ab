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
//   decode_dot: a block decodes 64 rows (8 warps, 8 rows each, with the
//               decode's device function) into shared memory as float(v) *
//               scale (32 KB), stages a 128 x 128 column tile of W (64 KB,
//               zero past N), and each warp multiplies its 8 rows by the
//               tile, lane l owning columns l + 32c, c < 4: 32 f32 FMA sums a
//               thread over k = 128. Grid (ceil(rows / 64), ceil(N / 128)). The
//               decoded matrix never reaches device memory.
//
// What bounds them: decode and encode move bytes and do a few integer
// operations a value. At 64 Mi values and bits = 8 that is 268 MB of int32, 67
// MB of words and 2 MB of leaders, 0.101 ms at 3.35 TB/s. decode_dot at 524288
// rows and N = 128 does 17.2 GFLOP in f32 FMA, 0.256 ms at 67 TFLOP/s (its
// bytes take 0.101 ms): operations bound it, and every four steps of k a
// thread issues 128 FMA for 8 broadcast float4 and 16 plain shared-memory
// loads.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kRow = 128;               // values a row
constexpr int kMaxWords = 128;          // 4 * bits at bits = 32
constexpr int kWarps = 8;               // warps (rows) a block of encode and decode
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDotRows = 64;            // rows a decode_dot block
constexpr int kDotCols = 128;           // W's columns a decode_dot block
constexpr size_t kDotSmem =
    sizeof(float) * (kDotRows * kRow + kRow * kDotCols) + sizeof(uint32_t) * kWarps * kMaxWords;

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

__global__ void __launch_bounds__(kWarps * 32)
decode_dot_kernel(const uint32_t* __restrict__ packed, const int32_t* __restrict__ leaders,
                  const float* __restrict__ wm, float* __restrict__ out, int64_t rows,
                  int64_t ncols, int bits, float scale) {
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);   // (kDotRows, 128)
  float* w_s = a_s + kDotRows * kRow;             // (128, kDotCols)
  uint32_t* words = reinterpret_cast<uint32_t*>(w_s + kRow * kDotCols) + (threadIdx.x >> 5) * kMaxWords;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row0 = int64_t(blockIdx.x) * kDotRows;
  const int64_t col0 = int64_t(blockIdx.y) * kDotCols;
  for (int e = threadIdx.x; e < kRow * kDotCols; e += kWarps * 32) {
    const int kk = e / kDotCols, c = e % kDotCols;
    w_s[e] = col0 + c < ncols ? wm[kk * ncols + col0 + c] : 0.f;
  }
  constexpr int kWarpRows = kDotRows / kWarps;
  for (int r = warp * kWarpRows; r < (warp + 1) * kWarpRows; ++r) {
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) {   // the same for the whole warp
      stage_row(packed, row0 + r, bits, words, lane);
      uint32_t v[4];
      decode4(words, bits, static_cast<uint32_t>(leaders[row0 + r]), lane, v);
      q = make_float4(float(static_cast<int32_t>(v[0])) * scale,
                      float(static_cast<int32_t>(v[1])) * scale,
                      float(static_cast<int32_t>(v[2])) * scale,
                      float(static_cast<int32_t>(v[3])) * scale);
      __syncwarp();   // the next row's words overwrite these
    }
    reinterpret_cast<float4*>(a_s + r * kRow)[lane] = q;
  }
  __syncthreads();
  float acc[kWarpRows][4] = {};
  const float* a_w = a_s + warp * kWarpRows * kRow;
  for (int kk = 0; kk < kRow; kk += 4) {
    float4 av[kWarpRows];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) av[i] = *reinterpret_cast<const float4*>(a_w + i * kRow + kk);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float bv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = w_s[(kk + t) * kDotCols + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) {
        const float ai = t == 0 ? av[i].x : t == 1 ? av[i].y : t == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(ai, bv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    const int64_t row = row0 + warp * kWarpRows + i;
    if (row >= rows) break;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int64_t col = col0 + lane + 32 * c;
      if (col < ncols) out[row * ncols + col] = acc[i][c];
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool bad_bits(int bits) { return bits < 1 || bits > 32; }

// Lets decode_dot_kernel take kDotSmem of dynamic shared memory. The attribute
// is kept per function and device, so it is set once a device (one bit each).
cudaError_t allow_dot_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(decode_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kDotSmem));
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

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
// Writes out (rows, ncols) f32 = (values (rows, 128) * scale) @ w.
int tml_cascaded_decode_dot(const void* packed, const void* leaders, const void* w, void* out,
                            int64_t rows, int64_t ncols, int bits, float scale, void* stream) {
  if (packed == nullptr || leaders == nullptr || w == nullptr || out == nullptr ||
      bad_bits(bits) || rows < 0 || ncols < 0)
    return cudaErrorInvalidValue;
  if (rows == 0 || ncols == 0) return cudaSuccess;
  const int64_t gx = (rows + kDotRows - 1) / kDotRows, gy = (ncols + kDotCols - 1) / kDotCols;
  if (gx > 0x7fffffff || gy > 65535) return cudaErrorInvalidValue;
  const cudaError_t e = allow_dot_smem();
  if (e != cudaSuccess) return e;
  decode_dot_kernel<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)), kWarps * 32,
                      kDotSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(leaders),
      static_cast<const float*>(w), static_cast<float*>(out), rows, ncols, bits, scale);
  return cudaGetLastError();
}

}  // extern "C"
