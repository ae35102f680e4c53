// Fused bias + residual + LayerNorm epilogue (K3), for Hopper (sm_90a).
//
// Replaces apex_tpu/serving/fused_ops.py::_kernel (fused_residual_norm):
// per row, upcast x to fp32, add the optional skip bias, add the residual,
// take the fp32 mean and the two-pass centred variance mean((r - mean)^2)
// (not Welford and not E[r^2] - E[r]^2), rsqrt(var + eps), * w + b in fp32;
// write the normed row in x's dtype and r in the residual's dtype.
//
// What bounds it on the H100: at the serving widths (8, 40 and 1024 rows
// of 768) nothing but latency.  The bytes (x and the residual in, two rows
// out) take 0.00002-0.004 ms at 3.35 TB/s, the launch and one cold trip to
// device memory several microseconds.  So the design is for latency:
//   - A row is one warp's, in registers: at hidden 768 a lane holds 24 fp32
//     sums (three chunks of 8 values; x, the residual and the parameters
//     come in 16-byte loads, so an fp32 residual is six loads a lane).  The
//     sums are reduced with shuffles only: no shared memory, no block
//     barrier, no dynamic shared memory and so no per-launch
//     cudaFuncSetAttribute.
//   - One device-memory round trip.  Every load a row needs (the bias, w and
//     b, which a warp keeps in registers for all its rows, the residual and
//     x) is in flight before the first is used, so the statistics and the
//     writes wait on one trip, not two.
//   - The rows are spread over as many SMs as there are rows, up to the
//     card's: a CTA holds ceil(rows / SMs) warps (at most eight), so 8 rows
//     are eight CTAs of one warp on eight SMs, and 1024 rows 128 CTAs of
//     eight warps.  Beyond 8 rows an SM, CTAs of eight warps walk the rows
//     grid-stride, as many as the SMs hold at once.
//   - The launch chain: K3 is launched with programmatic dependent launch
//     (cudaLaunchAttributeProgrammaticStreamSerialization), the only kernel
//     of the port that is, so its CTAs start while the kernel ahead of it on
//     the stream (the dense projection that makes x) drains, and wait in
//     griddepcontrol.wait before their first read.  Nothing is read or
//     written before the wait, so any operand may come from that kernel.
//     On the card the projection + K3 chain took about 1 us less with it
//     (testing/kernel_ab.py); reading the parameters and the first
//     residual before the wait gained nothing more in the chain and cost
//     the kernel alone 0.6 us.
//   - Rows wider than a warp's register budget (1024 values) are one CTA's,
//     up to 1024 threads of 32 values each, with block reductions in a
//     fixed order.  Under the 64-register cap of 1024 threads the CTA does
//     not hold the row: it reads x, the bias and the residual again for
//     each pass, and the parameters where they are used (held, the row
//     spilled).  Rows whose starts are not 16-byte aligned take the same
//     two shapes on single values (a warp up to 768 of them).
// The sums run in another order than the plain version (each lane's chunks
// in turn, then the shuffle tree, then the warps in order), which stays
// within the fp32 rounding of the plain output; the new residual is the
// same fp32 adds in the same order, so it is exact.
//
// Template parameters: TX the type of x, the skip bias and the normed row;
// TR the type of the residual and the new residual (each fp32, bf16 or
// fp16); TW the type of w and b (fp32 or TX).  The launcher is a plain C
// function that returns the launch's error.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxHidden = 32768;
constexpr int kMaxThreads = 1024;
constexpr int kRowWarps = 8;       // warps a CTA of the warp path holds at most
constexpr int kVec = 8;            // values a chunk (one 16-byte load of a 2-byte type)
constexpr int kWarpChunks = 4;     // chunks a lane holds on the warp path (rows up to 1024)
constexpr int kScalarValues = 24;  // values a lane holds on the unaligned warp path
constexpr int kBlockValues = 32;   // values a thread takes on the CTA paths

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// A value's bits (in the low bits of h) as fp32, and back.
template <typename T>
__device__ __forceinline__ float bits_to_float(uint32_t h) {
  if constexpr (std::is_same_v<T, float>) return __uint_as_float(h);
  else if constexpr (std::is_same_v<T, __nv_bfloat16>) return __uint_as_float(h << 16);
  else return __half2float(__ushort_as_half((unsigned short)h));
}

template <typename T>
__device__ __forceinline__ uint32_t float_to_bits(float f) {
  if constexpr (std::is_same_v<T, float>) return __float_as_uint(f);
  else if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return __bfloat16_as_ushort(__float2bfloat16(f));
  else return __half_as_ushort(__float2half(f));
}

// N values of T (N = kVec, in 16-byte loads; or N = 1) as raw 32-bit words.
template <typename T, int N>
struct Raw {
  static constexpr int kWords = N == 1 ? 1 : N * (int)sizeof(T) / 4;
  uint32_t w[kWords];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (N == 1) {
      if constexpr (sizeof(T) == 4) w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
      else w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    } else {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
    }
  }

  __device__ __forceinline__ float get(int i) const {
    if constexpr (sizeof(T) == 4 || N == 1) return bits_to_float<T>(w[i]);
    else return bits_to_float<T>(i % 2 ? w[i / 2] >> 16 : w[i / 2] & 0xffffu);
  }

  __device__ __forceinline__ static void store(T* p, const float (&f)[N]) {
    if constexpr (N == 1) {
      if constexpr (sizeof(T) == 4) *reinterpret_cast<unsigned*>(p) = float_to_bits<T>(f[0]);
      else *reinterpret_cast<unsigned short*>(p) = (unsigned short)float_to_bits<T>(f[0]);
    } else {
      uint32_t o[kWords];
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        o[i] = sizeof(T) == 4 ? float_to_bits<T>(f[i])
                              : float_to_bits<T>(f[2 * i]) | (float_to_bits<T>(f[2 * i + 1]) << 16);
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i)
        reinterpret_cast<uint4*>(p)[i] = make_uint4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
    }
  }
};

// Programmatic dependent launch: wait until the kernel before this one on
// the stream has finished and its writes are visible (returns at once when
// the launch did not overlap it).  Called before the first read, so the
// launch overlaps only the tail of that kernel, never its writes.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

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

// One row per warp (WARP) or per CTA; each thread of the row's unit takes
// up to MAXV chunks of VEC values.  On the warp path the summed row stays
// in registers between the passes (HOLD); on the aligned warp path the
// bias, w and b too, loaded once per warp (PARAMS).
template <typename TX, typename TR, typename TW, int VEC, int MAXV, bool WARP>
__global__ void __launch_bounds__(WARP ? kRowWarps * 32 : kMaxThreads, 1) residual_norm_kernel(
    const TX* __restrict__ x,         // [rows, hidden]
    const TR* __restrict__ res,       // [rows, hidden]
    const TX* __restrict__ bias,      // [hidden] or null
    const TW* __restrict__ w,         // [hidden]
    const TW* __restrict__ b,         // [hidden]
    TX* __restrict__ y,               // [rows, hidden]
    TR* __restrict__ new_res,         // [rows, hidden]
    int rows, int hidden, float eps) {
  constexpr bool kHold = WARP;
  constexpr bool kParams = WARP && VEC > 1;
  constexpr int kUnroll = kHold ? MAXV : 1;
  __shared__ float red[WARP ? 1 : kMaxThreads / 32];
  const int chunks = hidden / VEC;
  const int unit = WARP ? 32 : blockDim.x;
  const int t = WARP ? threadIdx.x % 32 : threadIdx.x;
  const int per_cta = WARP ? blockDim.x / 32 : 1;
  const int stride = gridDim.x * per_cta;
  const bool has_bias = bias != nullptr;

  grid_dependency_wait();
  Raw<TW, VEC> wv[kParams ? MAXV : 1], bv[kParams ? MAXV : 1];
  Raw<TX, VEC> cv[kParams ? MAXV : 1];
  if constexpr (kParams) {
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int c = i * unit + t;
      if (c < chunks) {
        wv[i].load(w + (size_t)c * VEC);
        bv[i].load(b + (size_t)c * VEC);
        if (has_bias) cv[i].load(bias + (size_t)c * VEC);
      }
    }
  }

  for (int row = blockIdx.x * per_cta + (WARP ? threadIdx.x / 32 : 0); row < rows;
       row += stride) {
    const TX* xr = x + (size_t)row * hidden;
    const TR* rr = res + (size_t)row * hidden;
    float v[kHold ? MAXV : 1][VEC];
    // chunk i of this thread's summed row (x [+ bias] + residual, in fp32)
    // on the CTA path, which does not hold it
    auto sum_chunk = [&](int i, float (&f)[VEC]) {
      const int c = i * unit + t;
      Raw<TX, VEC> xc, bc;
      Raw<TR, VEC> r1;
      xc.load(xr + (size_t)c * VEC);
      r1.load(rr + (size_t)c * VEC);
      if (has_bias) bc.load(bias + (size_t)c * VEC);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float s = xc.get(j);
        if (has_bias) s += bc.get(j);
        f[j] = s + r1.get(j);
      }
    };
    auto values = [&](int i, float (&f)[VEC]) {
      if constexpr (kHold) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) f[j] = v[i][j];
      } else {
        sum_chunk(i, f);
      }
    };
    auto row_sum = [&](float s) {
      if constexpr (WARP) return warp_sum(s);
      else return block_sum(s, red);
    };

    float s = 0.f;
    if constexpr (kHold) {
      // every load of the row in flight before the first is used
      Raw<TX, VEC> xc[MAXV], bc[MAXV];
      Raw<TR, VEC> rc[MAXV];
#pragma unroll
      for (int i = 0; i < MAXV; ++i) {
        const int c = i * unit + t;
        if (c < chunks) {
          xc[i].load(xr + (size_t)c * VEC);
          rc[i].load(rr + (size_t)c * VEC);
          if constexpr (kParams) bc[i] = cv[i];
          else if (has_bias) bc[i].load(bias + (size_t)c * VEC);
        }
      }
#pragma unroll
      for (int i = 0; i < MAXV; ++i) {
        if (i * unit + t < chunks) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            float r = xc[i].get(j);
            if (has_bias) r += bc[i].get(j);
            r += rc[i].get(j);
            v[i][j] = r;
            s += r;
          }
        }
      }
    } else {
#pragma unroll 1
      for (int i = 0; i < MAXV; ++i)
        if (i * unit + t < chunks) {
          float f[VEC];
          sum_chunk(i, f);
#pragma unroll
          for (int j = 0; j < VEC; ++j) s += f[j];
        }
    }
    const float mean = row_sum(s) / (float)hidden;
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
        float f[VEC], o[VEC];
        values(i, f);
        Raw<TW, VEC> wc, bc;
        if constexpr (kParams) {
          wc = wv[i];
          bc = bv[i];
        } else {
          wc.load(w + (size_t)c * VEC);
          bc.load(b + (size_t)c * VEC);
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) o[j] = (f[j] - mean) * inv * wc.get(j) + bc.get(j);
        Raw<TX, VEC>::store(y + (size_t)row * hidden + (size_t)c * VEC, o);
        Raw<TR, VEC>::store(new_res + (size_t)row * hidden + (size_t)c * VEC, f);
      }
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

template <typename TX, typename TR, typename TW, int VEC, int MAXV, bool WARP>
cudaError_t launch_shape(const void* x, const void* res, const void* bias, const void* w,
                         const void* b, void* y, void* new_res, int rows, int hidden, float eps,
                         cudaStream_t stream) {
  auto kernel = residual_norm_kernel<TX, TR, TW, VEC, MAXV, WARP>;
  int blocks, threads;
  if (WARP) {
    const int sms = sm_count();
    if (rows <= sms * kRowWarps) {
      // a warp a row, the rows spread over as many SMs as they fill
      const int warps = (rows + sms - 1) / sms;
      threads = 32 * warps;
      blocks = (rows + warps - 1) / warps;
    } else {
      // CTAs of eight warps walking the rows grid-stride, one wave of them
      // (the SM's share asked once per instance)
      static int per_sm = 0;
      if (per_sm == 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                             &per_sm, kernel, kRowWarps * 32, 0) != cudaSuccess)
        per_sm = 1;
      threads = kRowWarps * 32;
      blocks = (rows + kRowWarps - 1) / kRowWarps;
      const int most = sms * (per_sm > 0 ? per_sm : 1);
      blocks = blocks < most ? blocks : most;
    }
  } else {
    const int chunks = hidden / VEC;
    threads = ((chunks + MAXV - 1) / MAXV + 31) / 32 * 32;
    blocks = rows;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TX*>(x), static_cast<const TR*>(res),
      static_cast<const TX*>(bias), static_cast<const TW*>(w), static_cast<const TW*>(b),
      static_cast<TX*>(y), static_cast<TR*>(new_res), rows, hidden, eps);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TX, typename TR, typename TW>
cudaError_t launch(const void* x, const void* res, const void* bias, const void* w, const void* b,
                   void* y, void* new_res, int rows, int hidden, float eps, cudaStream_t s) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(res) |
                         reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(new_res)) %
                        16) == 0 &&
                       hidden % kVec == 0;
  if (aligned) {
    if (hidden <= 32 * kWarpChunks * kVec)
      return launch_shape<TX, TR, TW, kVec, kWarpChunks, true>(x, res, bias, w, b, y, new_res,
                                                               rows, hidden, eps, s);
    return launch_shape<TX, TR, TW, kVec, kBlockValues / kVec, false>(
        x, res, bias, w, b, y, new_res, rows, hidden, eps, s);
  }
  if (hidden <= 32 * kScalarValues)
    return launch_shape<TX, TR, TW, 1, kScalarValues, true>(x, res, bias, w, b, y, new_res, rows,
                                                            hidden, eps, s);
  return launch_shape<TX, TR, TW, 1, kBlockValues, false>(x, res, bias, w, b, y, new_res, rows,
                                                          hidden, eps, s);
}

template <typename TX, typename TR>
cudaError_t launch_w(int w_dtype, const void* x, const void* res, const void* bias, const void* w,
                     const void* b, void* y, void* new_res, int rows, int hidden, float eps,
                     cudaStream_t s) {
  if (w_dtype == kF32)
    return launch<TX, TR, float>(x, res, bias, w, b, y, new_res, rows, hidden, eps, s);
  if constexpr (!std::is_same_v<TX, float>) {
    if (w_dtype == (std::is_same_v<TX, __nv_bfloat16> ? kBF16 : kF16))
      return launch<TX, TR, TX>(x, res, bias, w, b, y, new_res, rows, hidden, eps, s);
  }
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t launch_r(int r_dtype, int w_dtype, const void* x, const void* res, const void* bias,
                     const void* w, const void* b, void* y, void* new_res, int rows, int hidden,
                     float eps, cudaStream_t s) {
  switch (r_dtype) {
    case kF32:
      return launch_w<TX, float>(w_dtype, x, res, bias, w, b, y, new_res, rows, hidden, eps, s);
    case kBF16:
      return launch_w<TX, __nv_bfloat16>(w_dtype, x, res, bias, w, b, y, new_res, rows, hidden,
                                         eps, s);
    case kF16:
      return launch_w<TX, __half>(w_dtype, x, res, bias, w, b, y, new_res, rows, hidden, eps, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x and the skip bias in x_dtype, the residual in r_dtype, w and b in
// w_dtype (fp32 or x_dtype); codes 0 fp32, 1 bf16, 2 fp16.
extern "C" int apex_fused_residual_norm(int x_dtype, int r_dtype, int w_dtype, const void* x,
                                        const void* res, const void* bias, const void* weight,
                                        const void* beta, void* normed, void* new_res, int rows,
                                        int hidden, float eps, void* stream) {
  if (hidden < 1 || hidden > kMaxHidden || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kF32:
      return (int)launch_r<float>(r_dtype, w_dtype, x, res, bias, weight, beta, normed, new_res,
                                  rows, hidden, eps, s);
    case kBF16:
      return (int)launch_r<__nv_bfloat16>(r_dtype, w_dtype, x, res, bias, weight, beta, normed,
                                          new_res, rows, hidden, eps, s);
    case kF16:
      return (int)launch_r<__half>(r_dtype, w_dtype, x, res, bias, weight, beta, normed, new_res,
                                   rows, hidden, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}
