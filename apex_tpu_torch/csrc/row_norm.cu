// Row LayerNorm (N1) and row RMSNorm (N2), for Hopper (sm_90a).
//
// Replaces the Pallas row kernels of apex_tpu/ops/pallas_norm.py:
//   N1 _ln_kernel  (pallas_layer_norm): per row, fp32 mean, the two-pass
//      centred variance mean((x - mean)^2), rsqrt(var + eps), then
//      * w + b in fp32 and one cast to x's dtype;
//   N2 _rms_kernel (pallas_rms_norm): per row, fp32 mean(x^2),
//      x * rsqrt(ms + eps) * w in fp32, one cast to x's dtype.
//
// What bounds both on the H100: bytes.  Per element each reads x once and
// writes y once, for about eight fp32 operations (N1) or four (N2): far
// below the card's operations-per-byte balance point.  So the gain is in
// keeping loads in flight, not in arithmetic.
//
// Both run on one kernel, rows_norm_kernel<LN, ...>: the row stays in
// registers, in its storage type, between the statistics and the write;
// nothing goes through shared memory on the narrow path.
//   - A row whose 16-byte chunks number at most 32 * 16 (bf16 and fp16 up
//     to 4096, fp32 up to 2048) is one warp's: lane t holds chunks t,
//     t + 32, ..., all loaded before the first is used, and the sums are
//     reduced with shuffles only.  A CTA of eight warps walks the rows
//     grid-stride, with as many CTAs as the SMs hold at once, so the
//     launch is one wave of about a thousand CTAs, not one CTA per row.
//     Up to 96 chunks a row (768 bf16: three 16-byte loads a lane) N2 is
//     held to 32 registers, so that eight CTAs, the SM's 64 warps, are
//     resident (a fourth chunk a lane spilled under that cap); N1, which
//     keeps the mean and reads b too, spilled at 32 and 36 registers and
//     is held to 40 (six CTAs an SM).  The wider warp instance is left
//     uncapped: held to 128 registers, N1's spilled and ran slower.  w
//     and b are read for each row from L1 (every warp of the SM reads the
//     same few KB): kept in registers instead, as fp32, w took 24 more
//     registers a lane and halved the resident warps, which was slower on
//     the card.
//   - A wider row is one CTA's (up to 1024 threads, eight chunks a thread,
//     block reductions), up to kMaxHidden.
//   - 16-byte vector loads and stores only where every row start is
//     16-byte aligned (aligned x, y, w and b, and hidden * sizeof(x) a
//     multiple of 16); otherwise the same two shapes run on single
//     elements (a warp up to 1024 of them, a CTA up to kMaxHidden, which
//     reads x again for each pass instead of holding 32 values a thread
//     under the 64-register cap of 1024 threads).
// N1 takes the two passes of the TPU kernel over the held values, first
// the mean, then mean((x - mean)^2): not Welford and not E[x^2] - E[x]^2,
// so fp32 results stay with the reference.  N2 takes the sum of squares
// (its "mean" is 0).  The sums run in another order than the plain
// version (each lane's chunks in turn, then the shuffle tree, then, on
// the CTA path, the warps in order), which stays within the fp32
// rounding of the plain output.
//
// Template parameters: TX the type of x and y (fp32, bf16, fp16), TW the
// type of the parameters (fp32 or TX).  The launcher is a plain C function
// that returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxHidden = 32768;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum over the CTA in a fixed order; every thread gets the total.
__device__ __forceinline__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  x = warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float total = 0.f;
  const int warps = blockDim.x / 32;
  for (int w = 0; w < warps; ++w) total += red[w];
  __syncthreads();  // red is reused by the next reduction
  return total;
}

// ------------------------------------------------------- N1 and N2

constexpr int kRowsThreads = 256;     // eight warps, a row each at a time
constexpr int kWarpChunks = 16;       // chunks a lane holds on the warp path
constexpr int kNarrowChunks = 3;      // ... on its narrow-row instance,
constexpr int kNarrowMinBlocks = 8;   // N2's fills the SM: 64 warps, 32 registers;
constexpr int kLnNarrowMinBlocks = 6; // N1's (the mean, b): 48 warps, 40 registers
constexpr int kBlockChunks = 8;       // chunks a thread holds on the CTA path
constexpr int kScalarChunks = 32;     // elements a lane / thread holds unaligned

// A chunk: 16 bytes of T (VEC = 16 / sizeof(T) values) or one value.
template <typename T, int VEC>
struct Chunk {
  uint4 raw;
  __device__ __forceinline__ void load(const T* p) { raw = __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ __forceinline__ void to_float(float (&f)[VEC]) const;
  __device__ __forceinline__ static void store(T* p, const float (&f)[VEC]);
};

template <typename T>
struct Chunk<T, 1> {
  T raw;
  __device__ __forceinline__ void load(const T* p) { raw = p[0]; }
  __device__ __forceinline__ void to_float(float (&f)[1]) const { f[0] = ::to_float(raw); }
  __device__ __forceinline__ static void store(T* p, const float (&f)[1]) { ::store(p, f[0]); }
};

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : (i == 1 ? r.y : (i == 2 ? r.z : r.w));
}

template <>
__device__ __forceinline__ void Chunk<float, 4>::to_float(float (&f)[4]) const {
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(word(raw, i));
}
template <>
__device__ __forceinline__ void Chunk<float, 4>::store(float* p, const float (&f)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                                            __float_as_uint(f[2]), __float_as_uint(f[3]));
}

template <>
__device__ __forceinline__ void Chunk<__nv_bfloat16, 8>::to_float(float (&f)[8]) const {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(word(raw, i) << 16);
    f[2 * i + 1] = __uint_as_float(word(raw, i) & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void Chunk<__nv_bfloat16, 8>::store(__nv_bfloat16* p,
                                                               const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[2 * i])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1])) << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <>
__device__ __forceinline__ void Chunk<__half, 8>::to_float(float (&f)[8]) const {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __half2float(__ushort_as_half((unsigned short)(word(raw, i) & 0xffffu)));
    f[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(word(raw, i) >> 16)));
  }
}
template <>
__device__ __forceinline__ void Chunk<__half, 8>::store(__half* p, const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)__half_as_ushort(__float2half(f[2 * i])) |
           ((uint32_t)__half_as_ushort(__float2half(f[2 * i + 1])) << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// VEC parameters as fp32, from 16-byte loads where VEC > 1 (an fp32 w
// under bf16 or fp16 x is two of them).
template <typename TW, int VEC>
__device__ __forceinline__ void load_w(const TW* p, float (&f)[VEC]) {
  if constexpr (VEC == 1 || sizeof(TW) * VEC == 16) {
    Chunk<TW, VEC> c;
    c.load(p);
    c.to_float(f);
  } else {
    static_assert(sizeof(TW) == 4 && VEC == 8, "fp32 w under a 2-byte x");
    float lo[4], hi[4];
    Chunk<float, 4> c;
    c.load(p);
    c.to_float(lo);
    c.load(p + 4);
    c.to_float(hi);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = lo[i];
      f[4 + i] = hi[i];
    }
  }
}

// One row per warp (WARP) or per CTA; each thread of the row's unit holds
// up to MAXV chunks of VEC values, all loaded before the first is used.
// LN: N1 (the mean, then the centred sum of squares; b added), else N2.
// MINB: CTAs an SM must hold at once (ptxas then caps the registers at
// 65536 / (threads * MINB)).
template <bool LN, typename TX, typename TW, int VEC, int MAXV, bool WARP, int MINB>
__global__ void __launch_bounds__(WARP ? kRowsThreads : kMaxThreads, MINB) rows_norm_kernel(
    const TX* __restrict__ x,     // [rows, hidden]
    const TW* __restrict__ w,     // [hidden]
    const TW* __restrict__ b,     // [hidden] (N1; unread by N2)
    TX* __restrict__ y,           // [rows, hidden]
    int rows, int hidden, float eps) {
  __shared__ float red[WARP ? 1 : kMaxThreads / 32];
  const int chunks = hidden / VEC;
  const int unit = WARP ? 32 : blockDim.x;
  const int t = WARP ? threadIdx.x % 32 : threadIdx.x;
  const int per_cta = WARP ? blockDim.x / 32 : 1;
  const int stride = gridDim.x * per_cta;

  // the unaligned CTA path (up to 32 values a thread under the 64-register
  // cap of 1024 threads) reads x again for each pass instead of holding it,
  // in loops left rolled (unrolled, the compiler keeps the values anyway)
  constexpr bool kHold = WARP || VEC > 1;
  constexpr int kUnroll = kHold ? MAXV : 1;
  for (int row = blockIdx.x * per_cta + (WARP ? threadIdx.x / 32 : 0); row < rows;
       row += stride) {
    const TX* xr = x + (size_t)row * hidden;
    TX* yr = y + (size_t)row * hidden;
    Chunk<TX, VEC> xc[kHold ? MAXV : 1];
    if constexpr (kHold) {
#pragma unroll
      for (int i = 0; i < MAXV; ++i)
        if (i * unit + t < chunks) xc[i].load(xr + (size_t)(i * unit + t) * VEC);
    }
    // chunk i of this thread as fp32
    auto values = [&](int i, float (&f)[VEC]) {
      if constexpr (!kHold) xc[0].load(xr + (size_t)(i * unit + t) * VEC);
      xc[kHold ? i : 0].to_float(f);
    };
    auto row_sum = [&](float v) {
      if constexpr (WARP) return warp_sum(v);
      else return block_sum(v, red);
    };
    float mean = 0.f;
    if constexpr (LN) {
      float s = 0.f;
#pragma unroll (kUnroll)
      for (int i = 0; i < MAXV; ++i)
        if (i * unit + t < chunks) {
          float f[VEC];
          values(i, f);
#pragma unroll
          for (int j = 0; j < VEC; ++j) s += f[j];
        }
      mean = row_sum(s) / (float)hidden;
    }
    float ss = 0.f;
#pragma unroll (kUnroll)
    for (int i = 0; i < MAXV; ++i)
      if (i * unit + t < chunks) {
        float f[VEC];
        values(i, f);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = f[j] - mean;
          ss += d * d;
        }
      }
    const float inv = rsqrtf(row_sum(ss) / (float)hidden + eps);
#pragma unroll (kUnroll)
    for (int i = 0; i < MAXV; ++i) {
      const int c = i * unit + t;
      if (c < chunks) {
        float f[VEC], wv[VEC];
        values(i, f);
        load_w<TW, VEC>(w + (size_t)c * VEC, wv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) f[j] = (f[j] - mean) * inv * wv[j];
        if constexpr (LN) {
          load_w<TW, VEC>(b + (size_t)c * VEC, wv);
#pragma unroll
          for (int j = 0; j < VEC; ++j) f[j] += wv[j];
        }
        Chunk<TX, VEC>::store(yr + (size_t)c * VEC, f);
      }
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms;
}

template <bool LN, typename TX, typename TW, int VEC, int MAXV, bool WARP, int MINB = 1>
cudaError_t launch_shape(const void* x, const void* w, const void* b, void* y, int rows,
                         int hidden, float eps, cudaStream_t stream) {
  auto kernel = rows_norm_kernel<LN, TX, TW, VEC, MAXV, WARP, MINB>;
  int blocks, threads;
  if (WARP) {
    // one wave: as many CTAs as the SMs hold at once (asked once per
    // instance), each walking rows grid-stride
    static int per_sm = 0;
    if (per_sm == 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &per_sm, kernel, kRowsThreads, 0) != cudaSuccess)
      per_sm = 2048 / kRowsThreads;
    constexpr int per_cta = kRowsThreads / 32;
    threads = kRowsThreads;
    blocks = (rows + per_cta - 1) / per_cta;
    const int most = sm_count() * (per_sm > 0 ? per_sm : 1);
    blocks = blocks < most ? blocks : most;
  } else {
    const int chunks = hidden / VEC;
    threads = ((chunks + MAXV - 1) / MAXV + 31) / 32 * 32;
    threads = threads < 32 ? 32 : threads;
    blocks = rows;
  }
  kernel<<<blocks, threads, 0, stream>>>(static_cast<const TX*>(x), static_cast<const TW*>(w),
                                         static_cast<const TW*>(b), static_cast<TX*>(y), rows,
                                         hidden, eps);
  return cudaGetLastError();
}

template <bool LN, typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, int rows, int hidden,
                   float eps, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(TX);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(b)) %
                        16) == 0 &&
                       hidden % kVec == 0;
  if (aligned) {
    const int chunks = hidden / kVec;
    if (chunks <= 32 * kNarrowChunks)
      return launch_shape<LN, TX, TW, kVec, kNarrowChunks, true,
                          LN ? kLnNarrowMinBlocks : kNarrowMinBlocks>(x, w, b, y, rows, hidden,
                                                                      eps, s);
    if (chunks <= 32 * kWarpChunks)
      return launch_shape<LN, TX, TW, kVec, kWarpChunks, true>(x, w, b, y, rows, hidden, eps, s);
    return launch_shape<LN, TX, TW, kVec, kBlockChunks, false>(x, w, b, y, rows, hidden, eps, s);
  }
  if (hidden <= 32 * kScalarChunks)
    return launch_shape<LN, TX, TW, 1, kScalarChunks, true>(x, w, b, y, rows, hidden, eps, s);
  return launch_shape<LN, TX, TW, 1, kScalarChunks, false>(x, w, b, y, rows, hidden, eps, s);
}

}  // namespace

// rms = 0: N1 (LayerNorm, b read); rms = 1: N2 (RMSNorm, b unread, may be null).
extern "C" int apex_row_norm(int rms, int x_dtype, int w_dtype, const void* x, const void* w,
                             const void* b, void* y, int rows, int hidden, float eps,
                             void* stream) {
  if (hidden < 1 || hidden > kMaxHidden || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define APEX_ROW_NORM_CASE(XT, WT, TX_, TW_)                                   \
  if (x_dtype == XT && w_dtype == WT)                                          \
    return (int)(rms ? launch<false, TX_, TW_>(x, w, nullptr, y, rows, hidden, eps, s) \
                     : launch<true, TX_, TW_>(x, w, b, y, rows, hidden, eps, s));
  APEX_ROW_NORM_CASE(kF32, kF32, float, float)
  APEX_ROW_NORM_CASE(kBF16, kF32, __nv_bfloat16, float)
  APEX_ROW_NORM_CASE(kBF16, kBF16, __nv_bfloat16, __nv_bfloat16)
  APEX_ROW_NORM_CASE(kF16, kF32, __half, float)
  APEX_ROW_NORM_CASE(kF16, kF16, __half, __half)
#undef APEX_ROW_NORM_CASE
  return (int)cudaErrorInvalidValue;
}
