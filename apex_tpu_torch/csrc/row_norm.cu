// Row LayerNorm (N1) and row RMSNorm (N2), for Hopper (sm_90a).
//
// Replaces the Pallas row kernels of apex_tpu/ops/pallas_norm.py:
//   N1 _ln_kernel  (pallas_layer_norm): per row, fp32 mean, the two-pass
//      centred variance mean((x - mean)^2), rsqrt(var + eps), then
//      * w + b in fp32 and one cast to x's dtype;
//   N2 _rms_kernel (pallas_rms_norm): per row, fp32 mean(x^2),
//      x * rsqrt(ms + eps) * w in fp32, one cast to x's dtype.
//
// What bounds it on the H100: bytes.  Per element it reads x once and
// writes y once, for about eight fp32 operations: far below the card's
// operations-per-byte balance point.  The design touches device memory
// once per element each way: one CTA per row upcasts the row into
// dynamic shared memory in fp32, takes the statistics from there with
// block reductions (the two passes of the TPU kernel for LayerNorm, not
// Welford and not E[x^2] - E[x]^2, so fp32 results stay with the
// reference), and writes the normalised row in the same pass that
// applies the affine.  The row lives in shared memory rather than being
// reread from L2: from 48 KB on (hidden 12288 and up, with the block's
// static reduction scratch) the launcher raises the kernel's dynamic
// shared-memory limit with cudaFuncSetAttribute, up to kMaxHidden fp32
// values (128 KB).
//
// The block has about four elements per thread (32 to 1024 threads), so
// narrow rows do not idle a 256-thread block and wide rows do not loop
// long.  Any hidden from 1 to kMaxHidden is taken; no vector loads, so
// widths off the vector width (96, 100) need no tail code.
//
// Template parameters: TX the type of x and y (fp32, bf16, fp16), TW the
// type of the parameters (fp32 or TX), RMS the kernel (N2, no bias).
// The launcher is a plain C function that returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxHidden = 32768;
constexpr int kDefaultSmem = 48 * 1024;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half(x); }

// Sum over the CTA in a fixed order; every thread gets the total.
__device__ __forceinline__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float total = 0.f;
  const int warps = blockDim.x / 32;
  for (int w = 0; w < warps; ++w) total += red[w];
  __syncthreads();  // red is reused by the next reduction
  return total;
}

template <typename TX, typename TW, bool RMS>
__global__ void __launch_bounds__(kMaxThreads) row_norm_kernel(
    const TX* __restrict__ x,     // [rows, hidden]
    const TW* __restrict__ w,     // [hidden]
    const TW* __restrict__ b,     // [hidden], unread when RMS
    TX* __restrict__ y,           // [rows, hidden]
    int hidden, float eps) {
  extern __shared__ float row[];  // the row, fp32
  __shared__ float red[kMaxThreads / 32];
  const size_t off = (size_t)blockIdx.x * hidden;

  float acc = 0.f;
  for (int c = threadIdx.x; c < hidden; c += blockDim.x) {
    const float v = to_float(x[off + c]);
    row[c] = v;
    acc += RMS ? v * v : v;
  }
  if constexpr (RMS) {
    const float inv = rsqrtf(block_sum(acc, red) / (float)hidden + eps);
    for (int c = threadIdx.x; c < hidden; c += blockDim.x)
      store(y + off + c, row[c] * inv * to_float(w[c]));
    return;
  }
  const float mean = block_sum(acc, red) / (float)hidden;
  float sq = 0.f;
  for (int c = threadIdx.x; c < hidden; c += blockDim.x) {
    const float xc = row[c] - mean;
    sq += xc * xc;
  }
  const float inv = rsqrtf(block_sum(sq, red) / (float)hidden + eps);
  for (int c = threadIdx.x; c < hidden; c += blockDim.x)
    store(y + off + c, (row[c] - mean) * inv * to_float(w[c]) + to_float(b[c]));
}

template <typename TX, typename TW, bool RMS>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, int rows, int hidden,
                   float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)hidden;
  auto kernel = row_norm_kernel<TX, TW, RMS>;
  // the 48 KB default covers dynamic and static shared memory together
  if (smem + sizeof(float) * (kMaxThreads / 32) > (size_t)kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  // about four elements per thread, whole warps, 32..1024 threads
  int threads = ((hidden + 3) / 4 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  kernel<<<rows, threads, smem, stream>>>(static_cast<const TX*>(x), static_cast<const TW*>(w),
                                          static_cast<const TW*>(b), static_cast<TX*>(y), hidden,
                                          eps);
  return cudaGetLastError();
}

template <bool RMS>
cudaError_t dispatch(int x_dtype, int w_dtype, const void* x, const void* w, const void* b,
                     void* y, int rows, int hidden, float eps, cudaStream_t s) {
#define APEX_ROW_NORM_CASE(XT, WT, TX_, TW_) \
  if (x_dtype == XT && w_dtype == WT) return launch<TX_, TW_, RMS>(x, w, b, y, rows, hidden, eps, s);
  APEX_ROW_NORM_CASE(kF32, kF32, float, float)
  APEX_ROW_NORM_CASE(kBF16, kF32, __nv_bfloat16, float)
  APEX_ROW_NORM_CASE(kBF16, kBF16, __nv_bfloat16, __nv_bfloat16)
  APEX_ROW_NORM_CASE(kF16, kF32, __half, float)
  APEX_ROW_NORM_CASE(kF16, kF16, __half, __half)
#undef APEX_ROW_NORM_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// rms = 0: N1 (LayerNorm, b read); rms = 1: N2 (RMSNorm, b unread, may be null).
extern "C" int apex_row_norm(int rms, int x_dtype, int w_dtype, const void* x, const void* w,
                             const void* b, void* y, int rows, int hidden, float eps,
                             void* stream) {
  if (hidden < 1 || hidden > kMaxHidden || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(rms ? dispatch<true>(x_dtype, w_dtype, x, w, b, y, rows, hidden, eps, s)
                   : dispatch<false>(x_dtype, w_dtype, x, w, b, y, rows, hidden, eps, s));
}
