// Fused bias + residual + LayerNorm epilogue, for Hopper (sm_90a).
//
// Replaces K3 of the TPU port, apex_tpu/serving/fused_ops.py::_kernel
// (fused_residual_norm): per row, upcast x to fp32, add the optional skip
// bias, add the residual, then LayerNorm with fp32 statistics; write the
// normed row in x's dtype and the new residual in the residual's dtype.
//
// What bounds it on the H100: bytes.  Per element it reads x and the
// residual and writes two outputs, for about ten fp32 operations: two
// orders of magnitude below the card's operations-per-byte balance point.
// The design therefore touches device memory once per element each way:
// one CTA per row keeps the summed row in shared memory in fp32, takes the
// mean and the variance from it with two block reductions (the two-pass
// form of the TPU kernel, not E[x^2] - E[x]^2), and writes both outputs in
// the same pass that normalises.  Nothing intermediate reaches device
// memory.
//
// The launcher is a plain C function that returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Sum over the CTA; every thread gets the total.
__device__ __forceinline__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  __syncthreads();  // red is reused by the next reduction
  return total;
}

template <typename TX, typename TR>
__global__ void __launch_bounds__(kThreads) fused_residual_norm_kernel(
    const TX* __restrict__ x,          // [rows, hidden]
    const TR* __restrict__ residual,   // [rows, hidden]
    const TX* __restrict__ bias,       // [hidden] or null
    const float* __restrict__ weight,  // [hidden]
    const float* __restrict__ beta,    // [hidden]
    TX* __restrict__ normed,           // [rows, hidden]
    TR* __restrict__ new_residual,     // [rows, hidden]
    int hidden, float eps) {
  extern __shared__ float r_s[];  // the summed row, fp32
  __shared__ float red[kThreads / 32];
  const size_t off = (size_t)blockIdx.x * hidden;

  float sum = 0.f;
  for (int c = threadIdx.x; c < hidden; c += kThreads) {
    float v = to_float(x[off + c]);
    if (bias) v += to_float(bias[c]);
    v += to_float(residual[off + c]);
    r_s[c] = v;
    sum += v;
  }
  const float mean = block_sum(sum, red) / hidden;
  float sq = 0.f;
  for (int c = threadIdx.x; c < hidden; c += kThreads) {
    const float rc = r_s[c] - mean;
    sq += rc * rc;
  }
  const float inv = rsqrtf(block_sum(sq, red) / hidden + eps);
  for (int c = threadIdx.x; c < hidden; c += kThreads) {
    const float r = r_s[c];
    store(normed + off + c, (r - mean) * inv * weight[c] + beta[c]);
    store(new_residual + off + c, r);
  }
}

template <typename TX, typename TR>
cudaError_t launch(const void* x, const void* res, const void* bias, const void* w,
                   const void* beta, void* y, void* new_res, int rows, int hidden, float eps,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)hidden;
  auto kernel = fused_residual_norm_kernel<TX, TR>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<rows, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TR*>(res), static_cast<const TX*>(bias),
      static_cast<const float*>(w), static_cast<const float*>(beta), static_cast<TX*>(y),
      static_cast<TR*>(new_res), hidden, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int apex_fused_residual_norm(int x_dtype, int r_dtype, const void* x, const void* res,
                                        const void* bias, const void* weight, const void* beta,
                                        void* normed, void* new_res, int rows, int hidden,
                                        float eps, void* stream) {
  if (rows == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define APEX_RN_CASE(XT, RT, TX_, TR_) \
  if (x_dtype == XT && r_dtype == RT)  \
    return (int)launch<TX_, TR_>(x, res, bias, weight, beta, normed, new_res, rows, hidden, eps, s);
  APEX_RN_CASE(kF32, kF32, float, float)
  APEX_RN_CASE(kF32, kBF16, float, __nv_bfloat16)
  APEX_RN_CASE(kBF16, kF32, __nv_bfloat16, float)
  APEX_RN_CASE(kBF16, kBF16, __nv_bfloat16, __nv_bfloat16)
#undef APEX_RN_CASE
  return (int)cudaErrorInvalidValue;
}
