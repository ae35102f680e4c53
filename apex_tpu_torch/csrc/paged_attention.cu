// Paged attention over the block-table KV cache, for Hopper (sm_90a).
//
// Replaces two TPU kernels of apex_tpu/serving/paged_attention.py:
//   K1  _decode_kernel   (paged_attention_decode)  one query token per slot
//   K2  _prefill_kernel  (_multi_query_attention)  T query tokens per slot,
//                                                  each with its own causal limit
// Both are one templated kernel here; the decode launcher instantiates it
// with MULTI = false (every row's limit is the slot's length), the prefill
// launcher with MULTI = true (per-token limits).
//
// What bounds it on the H100: bytes.  At serving shapes (head_dim 64, one
// query token per head, or a 128-token chunk) each K/V element read from
// device memory feeds 2 multiply-adds per query row sharing its KV group,
// far below the ~295 operations per byte where the tensor cores would be
// the limit.  So the design reads every live K/V row once per CTA, in its
// storage dtype (bf16 and int8 caches move half and a quarter of the fp32
// bytes), and never materialises a gathered copy of the cache:
//   - one CTA per (slot, kv group[, tile of query tokens]); the CTA reads its
//     own block-table row and loops over the live blocks only
//     (j < ceil(min(length, largest limit of the tile) / block_size)), so
//     table entries past the live range are never read;
//   - each step stages TILE cache rows of K and V in shared memory as fp32
//     with 16-byte loads (the int8 dequant, value * row scale, happens on
//     the way in), and all hpg query heads of the group (times the query
//     tile for K2) use them: the GQA saving of the TPU kernel;
//   - the online-softmax state (m, l, acc) stays on chip in fp32 for the
//     whole sweep; the output is written once, in q's dtype.
// Semantics kept from the TPU kernel: scale 1/sqrt(d) by default, mask value
// -1e30 with the all-masked guard (m_safe) and l == 0 -> 1 at the end, so a
// length or limit of 0 gives exact zeros.
//
// Each launcher is a plain C function that returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kTile = 64;  // cache rows staged in shared memory per step

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes of storage-dtype values -> fp32 in shared memory, times `mul`
// (the int8 row scale; 1 otherwise, which is exact).
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst, float mul) {
  constexpr int kVec = 16 / sizeof(T);
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) dst[i] = to_float(vals[i]) * mul;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory of one CTA, in floats: q and acc [rows, d], scores
// [rows, kTile], m / l / alpha / limit [rows], K tile [kTile, d + 1] (padded
// so the score loop's column walk is free of bank conflicts), V tile
// [kTile, d].
inline size_t smem_bytes(int rows, int d) {
  return sizeof(float) * (2 * (size_t)rows * d + (size_t)rows * kTile + 4 * (size_t)rows +
                          (size_t)kTile * (d + 1) + (size_t)kTile * d);
}

template <typename TQ, typename TKV, bool MULTI>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const TQ* __restrict__ q,             // [B, T, n, d]
    const TKV* __restrict__ k_arena,      // [n_blocks, bs, g, d]
    const TKV* __restrict__ v_arena,      // [n_blocks, bs, g, d]
    const float* __restrict__ k_scales,   // [n_blocks, bs, g] or null
    const float* __restrict__ v_scales,   // [n_blocks, bs, g] or null
    const int* __restrict__ tables,       // [B, max_blocks]
    const int* __restrict__ lengths,      // [B]
    const int* __restrict__ limits,       // [B, T] (MULTI only)
    TQ* __restrict__ out,                 // [B, T, n, d]
    int T, int n, int g, int d, int bs, int max_blocks, int q_tile, float scale) {
  constexpr int kVec = 16 / sizeof(TKV);
  const int b = blockIdx.x;
  const int grp = blockIdx.y;
  const int t0 = blockIdx.z * q_tile;
  const int hpg = n / g;
  const int rows = q_tile * hpg;  // row r: query token t0 + r / hpg, head grp*hpg + r % hpg
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* acc = q_s + rows * d;
  float* s_s = acc + rows * d;
  float* m_s = s_s + rows * kTile;
  float* l_s = m_s + rows;
  float* a_s = l_s + rows;
  int* lim_s = reinterpret_cast<int*>(a_s + rows);
  float* k_s = reinterpret_cast<float*>(lim_s + rows);
  float* v_s = k_s + kTile * (d + 1);

  const int length = lengths[b];
  for (int r = tid; r < rows; r += kThreads) {
    const int t = t0 + r / hpg;
    int lim = 0;
    if (t < T) lim = MULTI ? limits[(size_t)b * T + t] : length;
    lim_s[r] = lim;
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  for (int e = tid; e < rows * d; e += kThreads) {
    const int r = e / d, c = e % d;
    const int t = t0 + r / hpg, h = grp * hpg + r % hpg;
    q_s[e] = t < T ? to_float(q[(((size_t)b * T + t) * n + h) * d + c]) : 0.f;
    acc[e] = 0.f;
  }
  __syncthreads();

  // Sweep the live blocks up to the tile's largest limit.
  int max_lim = 0;
  for (int r = 0; r < rows; ++r) max_lim = max(max_lim, lim_s[r]);
  const int live_blocks = min((max(length, 0) + bs - 1) / bs, max_blocks);
  const int sweep = min(live_blocks, (max_lim + bs - 1) / bs) * bs;
  const int chunks = d / kVec;
  const int* table = tables + (size_t)b * max_blocks;

  for (int base = 0; base < sweep; base += kTile) {
    const int ntok = min(kTile, sweep - base);
    for (int e = tid; e < kTile * chunks; e += kThreads) {
      const int t = e / chunks, c0 = (e % chunks) * kVec;
      float* kd = k_s + t * (d + 1) + c0;
      float* vd = v_s + t * d + c0;
      if (t < ntok) {
        const int pos = base + t;
        const size_t row = ((size_t)table[pos / bs] * bs + pos % bs) * g + grp;
        load16(k_arena + row * d + c0, kd, k_scales ? k_scales[row] : 1.f);
        load16(v_arena + row * d + c0, vd, v_scales ? v_scales[row] : 1.f);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kd[i] = vd[i] = 0.f;
      }
    }
    __syncthreads();

    for (int e = tid; e < rows * kTile; e += kThreads) {
      const int r = e / kTile, t = e % kTile;
      float s = kNegInf;
      if (t < ntok && base + t < lim_s[r]) {
        const float* qr = q_s + r * d;
        const float* kr = k_s + t * (d + 1);
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot += qr[c] * kr[c];
        s = dot * scale;
      }
      s_s[e] = s;
    }
    __syncthreads();

    // Online softmax, one warp per row.
    for (int r = warp; r < rows; r += kThreads / 32) {
      float* sr = s_s + r * kTile;
      float mx = kNegInf;
      for (int t = lane; t < kTile; t += 32) mx = fmaxf(mx, sr[t]);
      mx = warp_max(mx);
      const float m = m_s[r];
      const float m_new = fmaxf(m, mx);
      const float m_safe = m_new <= kNegInf * 0.5f ? 0.f : m_new;
      float sum = 0.f;
      for (int t = lane; t < kTile; t += 32) {
        const float p = expf(sr[t] - m_safe);
        sr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(fminf(m - m_new, 0.f));
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < rows * d; e += kThreads) {
      const int r = e / d, c = e % d;
      const float* pr = s_s + r * kTile;
      float a = acc[e] * a_s[r];
      for (int t = 0; t < ntok; ++t) a += pr[t] * v_s[t * d + c];
      acc[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < rows * d; e += kThreads) {
    const int r = e / d, c = e % d;
    const int t = t0 + r / hpg, h = grp * hpg + r % hpg;
    if (t >= T) continue;
    const float l = l_s[r];
    store(out + (((size_t)b * T + t) * n + h) * d + c, acc[e] / (l == 0.f ? 1.f : l));
  }
}

template <typename TQ, typename TKV, bool MULTI>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                   const void* tables, const void* lengths, const void* limits, void* out,
                   int B, int T, int n, int g, int d, int bs, int max_blocks, int q_tile,
                   float scale, cudaStream_t stream) {
  const int rows = q_tile * (n / g);
  const size_t smem = smem_bytes(rows, d);
  auto kernel = paged_attention_kernel<TQ, TKV, MULTI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, g, (T + q_tile - 1) / q_tile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<const int*>(limits), static_cast<TQ*>(out), T, n, g, d, bs, max_blocks, q_tile,
      scale);
  return cudaGetLastError();
}

template <bool MULTI>
cudaError_t dispatch(int q_dtype, int kv_dtype, const void* q, const void* k, const void* v,
                     const void* ks, const void* vs, const void* tables, const void* lengths,
                     const void* limits, void* out, int B, int T, int n, int g, int d, int bs,
                     int max_blocks, int q_tile, float scale, cudaStream_t stream) {
  if (B == 0 || T == 0) return cudaSuccess;
#define APEX_PA_CASE(QT, KT, TQ_, TKV_)                                                     \
  if (q_dtype == QT && kv_dtype == KT)                                                      \
    return launch<TQ_, TKV_, MULTI>(q, k, v, ks, vs, tables, lengths, limits, out, B, T, n, \
                                    g, d, bs, max_blocks, q_tile, scale, stream);
  APEX_PA_CASE(kF32, kF32, float, float)
  APEX_PA_CASE(kF32, kBF16, float, __nv_bfloat16)
  APEX_PA_CASE(kF32, kI8, float, int8_t)
  APEX_PA_CASE(kBF16, kF32, __nv_bfloat16, float)
  APEX_PA_CASE(kBF16, kBF16, __nv_bfloat16, __nv_bfloat16)
  APEX_PA_CASE(kBF16, kI8, __nv_bfloat16, int8_t)
#undef APEX_PA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int apex_paged_attention_decode(
    int q_dtype, int kv_dtype, const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* tables, const void* lengths, void* out, int B, int n, int g,
    int d, int bs, int max_blocks, float scale, void* stream) {
  return (int)dispatch<false>(q_dtype, kv_dtype, q, k, v, ks, vs, tables, lengths, nullptr, out,
                              B, 1, n, g, d, bs, max_blocks, 1, scale,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int apex_paged_attention_prefill(
    int q_dtype, int kv_dtype, const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* tables, const void* lengths, const void* limits, void* out,
    int B, int T, int n, int g, int d, int bs, int max_blocks, int q_tile, float scale,
    void* stream) {
  return (int)dispatch<true>(q_dtype, kv_dtype, q, k, v, ks, vs, tables, lengths, limits, out,
                             B, T, n, g, d, bs, max_blocks, q_tile, scale,
                             static_cast<cudaStream_t>(stream));
}
