// Gathered multi-LoRA delta for Hopper (sm_90a).
//
// Replaces one TPU kernel of apex_tpu/serving/lora.py:
//   L1  _delta_kernel  (lora_delta_fused)  per batch slot i,
//       y[:, i] = (x[:, i] @ A[slots[i]]) @ B[slots[i]]
//       both products in fp32, cast once to x's dtype
// x [S, B, in] is sequence-major (strides taken, not copied), A [n_slots,
// in, r], B [n_slots, r, out] (pre-scaled by alpha / rank), slots [B] int32,
// y [S, B, out] contiguous.  S is 1 in decode, k + 1 in the speculative
// verify and the chunk width in prefill.
//
// What bounds it on the H100: bytes, and at decode shapes launch latency.
// A rank-r bypass does 2 r multiply-adds per (row, in + out) element: at
// rank 8 about 16 operations for each x element and each A/B element it
// reads, far below the ~295 operations per byte where the tensor cores
// would be the limit.  The design keeps it simple and on chip:
//   - one CTA per (batch slot, tile of 256 output columns, tile of 16 rows of
//     S); the CTA reads slots[i] from device memory itself (no host sync, no
//     loop over slots on the host), as the TPU kernel's index maps do with
//     the scalar-prefetched slot vector;
//   - phase 1: t = x[rows, i, :] @ A[slot] into fp32 shared memory (never
//     rounded to bf16, as on the TPU).  Each warp takes a (row, slice of in)
//     task; lanes read consecutive x elements and consecutive A rows (r
//     contiguous values each), so both loads coalesce; partial sums meet in
//     shared memory and are added in a fixed order (deterministic);
//   - phase 2: each thread owns one output column, reads its B column once
//     per rank index (coalesced across the warp) and keeps the 16 rows'
//     sums in registers; one cast and one store per output element.
//   Every output tile recomputes its rows' t: that is r / 256 of its own
//   work per column tile and keeps the kernel to one launch.
// Ragged edges of S, out and r are masked.  A slot outside [0, n_slots)
// writes NaN rows, so a bad slot vector shows instead of reading stray
// memory.  The zero adapter (all-zero A and B) gives exact zeros.
//
// The launcher is a plain C function that returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 16;        // rows of S per CTA
constexpr int kColTile = kThreads;  // output columns per CTA, one a thread
constexpr int kRankChunk = 8;       // rank values accumulated per pass
// tasks of phase 1 never exceed max(kWarps, kRowTile)
constexpr int kMaxTasks = kWarps > kRowTile ? kWarps : kRowTile;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory of one CTA, in floats: t [kRowTile, r] and the phase-1
// partial sums [kMaxTasks, r].
inline size_t smem_bytes(int r) { return sizeof(float) * (size_t)(kRowTile + kMaxTasks) * r; }

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads) lora_delta_kernel(
    const TX* __restrict__ x,        // [S, B, in], strides (sx_s, sx_b, 1)
    const TW* __restrict__ a,        // [n_slots, in, r]
    const TW* __restrict__ b,        // [n_slots, r, out]
    const int* __restrict__ slots,   // [B]
    TX* __restrict__ y,              // [S, B, out]
    int S, int B, int n_in, int r, int n_out, int n_slots, long long sx_s, long long sx_b) {
  const int i = blockIdx.x;
  const int c = blockIdx.y * kColTile + threadIdx.x;
  const int s0 = blockIdx.z * kRowTile;
  const int rows = min(kRowTile, S - s0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slot = slots[i];

  if (slot < 0 || slot >= n_slots) {  // the same branch for the whole CTA
    if (c < n_out)
      for (int row = 0; row < rows; ++row)
        store(y + ((size_t)(s0 + row) * B + i) * n_out + c, __int_as_float(0x7fffffff));
    return;
  }

  extern __shared__ float smem[];
  float* t_s = smem;                    // [kRowTile, r]
  float* part = smem + kRowTile * r;    // [kMaxTasks, r]

  // Phase 1: t[row, :] = x[s0 + row, i, :] @ A[slot].  With fewer rows
  // than warps, the in dim is split over nsplit warps per row.
  const int nsplit = rows >= kWarps ? 1 : kWarps / rows;
  const int tasks = rows * nsplit;
  const TW* a_slot = a + (size_t)slot * n_in * r;
  for (int task = warp; task < tasks; task += kWarps) {
    const int row = task % rows, split = task / rows;
    const TX* xr = x + (size_t)(s0 + row) * sx_s + (size_t)i * sx_b;
    for (int j0 = 0; j0 < r; j0 += kRankChunk) {
      float acc[kRankChunk];
#pragma unroll
      for (int jj = 0; jj < kRankChunk; ++jj) acc[jj] = 0.f;
      for (int k = split * 32 + lane; k < n_in; k += nsplit * 32) {
        const float xv = to_float(xr[k]);
        const TW* ar = a_slot + (size_t)k * r + j0;
#pragma unroll
        for (int jj = 0; jj < kRankChunk; ++jj)
          if (j0 + jj < r) acc[jj] += xv * to_float(ar[jj]);
      }
#pragma unroll
      for (int jj = 0; jj < kRankChunk; ++jj) acc[jj] = warp_sum(acc[jj]);
      if (lane == 0) {
#pragma unroll
        for (int jj = 0; jj < kRankChunk; ++jj)
          if (j0 + jj < r) part[task * r + j0 + jj] = acc[jj];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * r; e += kThreads) {
    const int row = e / r, j = e % r;
    float sum = 0.f;
    for (int split = 0; split < nsplit; ++split) sum += part[(split * rows + row) * r + j];
    t_s[e] = sum;
  }
  __syncthreads();

  // Phase 2: y[s0 + row, i, c] = t[row, :] @ B[slot][:, c].
  if (c >= n_out) return;
  const TW* b_col = b + (size_t)slot * r * n_out + c;
  float acc[kRowTile];
#pragma unroll
  for (int row = 0; row < kRowTile; ++row) acc[row] = 0.f;
  for (int j = 0; j < r; ++j) {
    const float bv = to_float(b_col[(size_t)j * n_out]);
#pragma unroll
    for (int row = 0; row < kRowTile; ++row)
      if (row < rows) acc[row] += t_s[row * r + j] * bv;
  }
#pragma unroll
  for (int row = 0; row < kRowTile; ++row)
    if (row < rows) store(y + ((size_t)(s0 + row) * B + i) * n_out + c, acc[row]);
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* a, const void* b, const void* slots, void* y, int S,
                   int B, int n_in, int r, int n_out, int n_slots, long long sx_s, long long sx_b,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(r);
  auto kernel = lora_delta_kernel<TX, TW>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B, (n_out + kColTile - 1) / kColTile, (S + kRowTile - 1) / kRowTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(a), static_cast<const TW*>(b),
      static_cast<const int*>(slots), static_cast<TX*>(y), S, B, n_in, r, n_out, n_slots, sx_s,
      sx_b);
  return cudaGetLastError();
}

}  // namespace

extern "C" int apex_lora_delta(int x_dtype, int w_dtype, const void* x, const void* a,
                               const void* b, const void* slots, void* y, int S, int B, int n_in,
                               int r, int n_out, int n_slots, long long sx_s, long long sx_b,
                               void* stream) {
  if (S == 0 || B == 0 || n_out == 0) return (int)cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define APEX_LORA_CASE(XT, WT, TX_, TW_)                                                 \
  if (x_dtype == XT && w_dtype == WT)                                                    \
    return (int)launch<TX_, TW_>(x, a, b, slots, y, S, B, n_in, r, n_out, n_slots, sx_s, \
                                 sx_b, st);
  APEX_LORA_CASE(kF32, kF32, float, float)
  APEX_LORA_CASE(kF32, kBF16, float, __nv_bfloat16)
  APEX_LORA_CASE(kBF16, kF32, __nv_bfloat16, float)
  APEX_LORA_CASE(kBF16, kBF16, __nv_bfloat16, __nv_bfloat16)
#undef APEX_LORA_CASE
  return (int)cudaErrorInvalidValue;
}
