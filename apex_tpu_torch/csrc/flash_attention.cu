// Flash attention forward and backward, for Hopper (sm_90a).
//
// Replaces three TPU kernels of apex_tpu/ops/flash_attention.py:
//   F1  _fwd_kernel  (flash_attention_with_lse)  out and lse of one q tile
//   F2  _dq_kernel   (dq_chunk)                  dq of one q tile
//   F3  _dkv_kernel  (dkv_chunk)                 dk and dv of one k tile
// with the same semantics: optional causal mask in global coordinates
// (q_offset / kv_offset), segment ids, the counter-hash attention dropout
// (murmur3 finaliser over (seed, batch*heads, row, col), regenerated
// bit-identically in the backward), mask value -1e30 with the all-masked
// guards (m_safe; l == 0 -> output 0 and lse -1e30; lse <= -5e29 -> 0 in
// the backward), and the TPU kernels' bf16 rounding points: P is rounded to
// V's dtype before P.V, dS to K's dtype for dq and to Q's dtype for dk, the
// dropped P to dO's dtype for dV, and every output is written in its
// input's dtype.  Scores, softmax statistics and all accumulators are fp32.
//
// What bounds it on the H100: operations.  At the training shape (head_dim
// 64, sequence 1024) every K/V element read feeds 64 query rows of a tile,
// far above the card's operations-per-byte balance point.  These first
// versions do the products in fp32 on the CUDA cores, not the tensor
// cores, so they sit well above the bf16 tensor-core bound; the forward's
// tensor-core route is below, the backward's is later work.  What the
// design does keep is the flash structure:
//   - one CTA of 256 threads per (batch*head, 64-row tile); the sweep over
//     the other sequence is a loop inside the CTA (the TPU grid's
//     sequential axis), with the running state in registers, so nothing of
//     size [sq, sk] ever reaches device memory and no atomics are needed
//     (F3 owns its k tile's dk/dv outright, as on the TPU);
//   - causal block skipping: F1/F2 stop at the last k tile any row of the
//     q tile can see, F3 starts at the first q tile that can see its k
//     tile; rows and keys past the sequence ends are bounded by length,
//     never read, never padded in device memory;
//   - tiles staged in shared memory as fp32 with rows padded to an odd
//     stride, and a 4x4 (or 4 x D/16) register tile per thread, so the
//     inner product loops read shared memory without bank conflicts;
//   - heavy tiles first: F1/F2 hand the last q tiles (the longest causal
//     sweeps) to the first CTAs, F3's first k tiles are its longest.
// Head dims up to 128 are taken: the tiles are compiled for 64 or 128
// columns and a smaller head dim is zero-filled in shared memory.
//
// F1 has a second route, flash_fwd_tc_kernel, for bf16 q, k and v with a
// head dim that is a multiple of 8 up to 128 (the Python wrapper's
// fwd_route() chooses it; fp32 and other head dims stay on the kernel
// above).  It is built on the shared Hopper core (attention_core.cuh):
//   - one CTA per (batch*head, 128 query rows): two consumer warpgroups of
//     64 rows each and one producer warp; heavy tiles first, as above;
//   - the producer loads the Q tile once and then K and V tiles of 64 keys
//     with TMA through 3-D tensor maps over [b*h, s, d] (rows past a
//     head's sk and columns past d arrive as zeros, never from the next
//     head) into a two-stage ring with a full and an empty mbarrier per
//     stage, the tile's segment ids beside it;
//   - the consumers run S = Q K^T and O += P V as wgmma on the tensor
//     cores, the masks, scale and online softmax on the fp32 accumulator
//     fragment, and the dropout hash per fragment element at its global
//     (row, col), after the row sum and before P is rounded to bf16: the
//     same rounding points, guards and dropout bits as the kernel above;
//     a tile with nothing to mask (inside the causal triangle, no
//     segments, not ragged) only scales;
//   - at head dim 64 two CTAs share an SM, so one CTA's softmax runs while
//     the other's products occupy the tensor cores.
// What bounds it: against the tensor cores' bf16 rate, the bytes of q, k,
// v and out (read and written once) and the products are about even at
// the training shape; what holds this version back is latency: within a
// warpgroup the products, the softmax and the waits run one after another
// (issuing tile j + 1's Q K^T beside tile j's P V needs about 16 more
// registers a thread, which spill under the two-CTA cap of 112).
//
// Each launcher is a plain C function that returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_core.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;  // 16 x 16: ty owns 4 rows, tx strided columns
constexpr int kTile = 64;      // rows of a q tile and of a k tile
constexpr int kLdS = kTile + 1;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// x rounded to T's precision and back (the TPU kernels' .astype points).
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

// murmur3 finaliser (apex_tpu/ops/flash_attention.py::_mix32).
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The per-(seed, batch*head) prefix of _keep_mask's hash chain.
__device__ __forceinline__ uint32_t head_hash(const int* seed, int bh) {
  return mix32(mix32(static_cast<uint32_t>(*seed) ^ 0x9E3779B9u) + static_cast<uint32_t>(bh));
}

__device__ __forceinline__ bool keep(uint32_t head, int row, int col, uint32_t thresh) {
  return mix32(mix32(head + static_cast<uint32_t>(row)) + static_cast<uint32_t>(col)) >= thresh;
}

// Sum / max over the 16 lanes that share a row group (a half-warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// acc[i][j] += sum_k A(4*ty + i, k) * B(k, tx + 16*j), both in shared
// memory: A(r, k) = a[r * a_r + k * a_k], B(k, c) = b[k * b_k + c * b_c].
template <int NJ, int K>
__device__ __forceinline__ void tile_mma(float (&acc)[4][NJ], const float* a, int a_r, int a_k,
                                         const float* b, int b_k, int b_c, int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    float av[4], bv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(4 * ty + i) * a_r + k * a_k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = b[k * b_k + (tx + 16 * j) * b_c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Rows [row0, row0 + 64) of a [rows, d] matrix into a [64][D + 1] fp32
// tile; rows past `rows` and columns past `d` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int rows, int d) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = (row < rows && c < d) ? to_float(src[(size_t)row * d + c]) : 0.f;
  }
}

struct Params {
  int heads, sq, sk, d;
  float scale;
  int causal, q_offset, kv_offset;
  const int* seg_q;  // [batch, sq] or null
  const int* seg_k;  // [batch, sk] or null
  const int* seed;   // [1] or null (no dropout)
  uint32_t thresh;   // keep iff hash >= thresh
  float inv_keep;    // 1 / (1 - rate)
};

// Number of k tiles any row of the q tile at row0 can see.
__device__ __forceinline__ int live_k_tiles(const Params& p, int row0) {
  const int n = (p.sk + kTile - 1) / kTile;
  if (!p.causal) return n;
  const int last_row = min(row0 + kTile, p.sq) - 1;
  const int last_col = p.q_offset + last_row - p.kv_offset;
  return last_col < 0 ? 0 : min(n, last_col / kTile + 1);
}

// First q tile with a row that can see the k tile at col0.
__device__ __forceinline__ int first_q_tile(const Params& p, int col0) {
  if (!p.causal) return 0;
  const int need = p.kv_offset + col0 - p.q_offset;  // first row seeing col0
  return need <= 0 ? 0 : need / kTile;
}

__device__ __forceinline__ bool visible(const Params& p, int row, int col, const int* seg_q_s,
                                        const int* seg_k_s, int r, int c) {
  if (col >= p.sk) return false;
  if (p.causal && p.q_offset + row < p.kv_offset + col) return false;
  if (p.seg_q && seg_q_s[r] != seg_k_s[c]) return false;
  return true;
}

__device__ __forceinline__ void load_segments(int* dst, const int* seg, int b, int len, int start) {
  if (!seg) return;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int pos = start + i;
    dst[i] = pos < len ? seg[(size_t)b * len + pos] : -1;
  }
}

inline size_t tile_bytes(int D) { return sizeof(float) * (size_t)kTile * (D + 1); }
inline size_t score_bytes() { return sizeof(float) * (size_t)kTile * kLdS; }

// ------------------------------------------------------------------ F1

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, Params p) {
  constexpr int NJ = D / 16;
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sP = sV + kTile * LD;
  __shared__ int seg_q_s[kTile], seg_k_s[kTile];

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest sweeps first
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* qb = q + (size_t)bh * p.sq * p.d;
  const T* kb = k + (size_t)bh * p.sk * p.d;
  const T* vb = v + (size_t)bh * p.sk * p.d;
  const uint32_t head = p.seed ? head_hash(p.seed, bh) : 0u;

  load_tile<T, D>(sQ, qb, row0, p.sq, p.d);
  load_segments(seg_q_s, p.seg_q, b, p.sq, row0);

  float acc[4][NJ], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int n_live = live_k_tiles(p, row0);
  for (int jt = 0; jt < n_live; ++jt) {
    const int col0 = jt * kTile;
    __syncthreads();  // the previous step is done with sK / sV / sP
    load_tile<T, D>(sK, kb, col0, p.sk, p.d);
    load_tile<T, D>(sV, vb, col0, p.sk, p.d);
    load_segments(seg_k_s, p.seg_k, b, p.sk, col0);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    tile_mma<4, D>(s, sQ, LD, 1, sK, 1, LD, ty, tx);  // Q K^T

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i, row = row0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        s[i][j] = visible(p, row, col0 + c, seg_q_s, seg_k_s, r, c) ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float m_safe = m_new <= kNegInf * 0.5f ? 0.f : m_new;
      const float alpha = expf(fminf(m[i] - m_new, 0.f));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float e = expf(s[i][j] - m_safe);
        sum += e;
        float pa = e;
        if (p.seed) pa = keep(head, p.q_offset + row, p.kv_offset + col0 + c, p.thresh) ? e * p.inv_keep : 0.f;
        sP[r * kLdS + c] = round_to(pa, T());
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_mma<NJ, kTile>(acc, sP, kLdS, 1, sV, LD, 1, ty, tx);  // P V
  }

  T* ob = out + (size_t)bh * p.sq * p.d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    if (row >= p.sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < p.d) store(ob + (size_t)row * p.d + c, acc[i][j] / l_safe);
    }
    if (tx == 0) lse[(size_t)bh * p.sq + row] = l[i] == 0.f ? kNegInf : m[i] + logf(l_safe);
  }
}

// ------------------------------------------------------------------ F2

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, Params p) {
  constexpr int NJ = D / 16;
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kTile * LD;
  float* sK = sDO + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sDS = sV + kTile * LD;
  __shared__ int seg_q_s[kTile], seg_k_s[kTile];

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qoff = (size_t)bh * p.sq * p.d, koff = (size_t)bh * p.sk * p.d;
  const uint32_t head = p.seed ? head_hash(p.seed, bh) : 0u;

  load_tile<T, D>(sQ, q + qoff, row0, p.sq, p.d);
  load_tile<T, D>(sDO, dout + qoff, row0, p.sq, p.d);
  load_segments(seg_q_s, p.seg_q, b, p.sq, row0);
  float lse_safe[4], dlt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    const float x = row < p.sq ? lse[(size_t)bh * p.sq + row] : 0.f;
    lse_safe[i] = x <= kNegInf * 0.5f ? 0.f : x;
    dlt[i] = row < p.sq ? delta[(size_t)bh * p.sq + row] : 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int n_live = live_k_tiles(p, row0);
  for (int jt = 0; jt < n_live; ++jt) {
    const int col0 = jt * kTile;
    __syncthreads();
    load_tile<T, D>(sK, k + koff, col0, p.sk, p.d);
    load_tile<T, D>(sV, v + koff, col0, p.sk, p.d);
    load_segments(seg_k_s, p.seg_k, b, p.sk, col0);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_mma<4, D>(s, sQ, LD, 1, sK, 1, LD, ty, tx);    // Q K^T
    tile_mma<4, D>(dp, sDO, LD, 1, sV, 1, LD, ty, tx);  // dO V^T

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i, row = row0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, col = col0 + c;
        const bool vis = visible(p, row, col, seg_q_s, seg_k_s, r, c);
        const float pr = vis ? expf(s[i][j] * p.scale - lse_safe[i]) : 0.f;
        float g = dp[i][j];
        if (p.seed) g = keep(head, p.q_offset + row, p.kv_offset + col, p.thresh) ? g * p.inv_keep : 0.f;
        sDS[r * kLdS + c] = round_to(pr * (g - dlt[i]) * p.scale, T());
      }
    }
    __syncthreads();
    tile_mma<NJ, kTile>(acc, sDS, kLdS, 1, sK, LD, 1, ty, tx);  // dS K
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    if (row >= p.sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < p.d) store(dq + qoff + (size_t)row * p.d + c, acc[i][j]);
    }
  }
}

// ------------------------------------------------------------------ F3

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, Params p) {
  constexpr int NJ = D / 16;
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * LD;
  float* sQ = sV + kTile * LD;
  float* sDO = sQ + kTile * LD;
  float* sP = sDO + kTile * LD;  // [key][query], dropped P in dO's precision
  float* sDS = sP + kTile * kLdS;  // [key][query], dS in Q's precision
  __shared__ int seg_q_s[kTile], seg_k_s[kTile];
  __shared__ float lse_s[kTile], delta_s[kTile];

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int col0 = blockIdx.y * kTile;  // early k tiles have the longest sweeps
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qoff = (size_t)bh * p.sq * p.d, koff = (size_t)bh * p.sk * p.d;
  const uint32_t head = p.seed ? head_hash(p.seed, bh) : 0u;

  load_tile<T, D>(sK, k + koff, col0, p.sk, p.d);
  load_tile<T, D>(sV, v + koff, col0, p.sk, p.d);
  load_segments(seg_k_s, p.seg_k, b, p.sk, col0);

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int n_qt = (p.sq + kTile - 1) / kTile;
  for (int it = first_q_tile(p, col0); it < n_qt; ++it) {
    const int row0 = it * kTile;
    __syncthreads();
    load_tile<T, D>(sQ, q + qoff, row0, p.sq, p.d);
    load_tile<T, D>(sDO, dout + qoff, row0, p.sq, p.d);
    load_segments(seg_q_s, p.seg_q, b, p.sq, row0);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int row = row0 + i;
      const float x = row < p.sq ? lse[(size_t)bh * p.sq + row] : 0.f;
      lse_s[i] = x <= kNegInf * 0.5f ? 0.f : x;
      delta_s[i] = row < p.sq ? delta[(size_t)bh * p.sq + row] : 0.f;
    }
    __syncthreads();

    // transposed scores: this thread's rows are keys, its columns queries
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
    tile_mma<4, D>(st, sK, LD, 1, sQ, 1, LD, ty, tx);   // (Q K^T)^T
    tile_mma<4, D>(dpt, sV, LD, 1, sDO, 1, LD, ty, tx);  // (dO V^T)^T

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = 4 * ty + i, col = col0 + kr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j, row = row0 + qc;
        const bool vis = row < p.sq && visible(p, row, col, seg_q_s, seg_k_s, qc, kr);
        const float pr = vis ? expf(st[i][j] * p.scale - lse_s[qc]) : 0.f;
        float pd = pr, g = dpt[i][j];
        if (p.seed) {
          const bool kept = keep(head, p.q_offset + row, p.kv_offset + col, p.thresh);
          pd = kept ? pr * p.inv_keep : 0.f;
          g = kept ? g * p.inv_keep : 0.f;
        }
        sP[kr * kLdS + qc] = round_to(pd, T());
        sDS[kr * kLdS + qc] = round_to(pr * (g - delta_s[qc]) * p.scale, T());
      }
    }
    __syncthreads();
    tile_mma<NJ, kTile>(dv_acc, sP, kLdS, 1, sDO, LD, 1, ty, tx);  // P^T dO
    tile_mma<NJ, kTile>(dk_acc, sDS, kLdS, 1, sQ, LD, 1, ty, tx);  // dS^T Q
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = col0 + 4 * ty + i;
    if (col >= p.sk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < p.d) {
        store(dk + koff + (size_t)col * p.d + c, dk_acc[i][j]);
        store(dv + koff + (size_t)col * p.d + c, dv_acc[i][j]);
      }
    }
  }
}


// ------------------------------------------------- F1 on the tensor cores

constexpr int kTcStages = 2;                   // K/V ring depth
constexpr int kTcConsumers = 256;              // two warpgroups of 64 query rows
constexpr int kTcThreads = kTcConsumers + 32;  // and one producer warp
constexpr int kTcRows = 128;                   // query rows of a CTA

// Shared memory of flash_fwd_tc_kernel, as offsets from a 1024-byte-aligned
// base: Q [128 x D], the ring's K and V tiles [64 x D] (swizzled bf16
// panels), the ring's segment ids [64], then the mbarriers.
template <int D>
struct FwdTcSmem {
  static constexpr uint32_t kTile = (D / 64) * apex_core::kPanelBytes;
  static constexpr uint32_t q = 0;
  static constexpr uint32_t k = 2 * kTile;
  static constexpr uint32_t v = k + kTcStages * kTile;
  static constexpr uint32_t seg = v + kTcStages * kTile;
  static constexpr uint32_t bars = seg + kTcStages * 64 * sizeof(int);
  static constexpr size_t bytes = bars + (2 * kTcStages + 1) * sizeof(uint64_t) + 1024;
};

// Number of 64-key tiles any row of the 128-row q tile at row0 can see.
__device__ __forceinline__ int live_k_tiles_tc(const Params& p, int row0) {
  const int n = (p.sk + kTile - 1) / kTile;
  if (!p.causal) return n;
  const int last_row = min(row0 + kTcRows, p.sq) - 1;
  const int last_col = p.q_offset + last_row - p.kv_offset;
  return last_col < 0 ? 0 : min(n, last_col / kTile + 1);
}

// At D = 64 two CTAs share an SM (96 registers a thread, no spills), so
// one CTA's softmax overlaps the other's products on the tensor cores.
template <int D>
__global__ void __launch_bounds__(kTcThreads, D == 64 ? 2 : 1) flash_fwd_tc_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, Params p) {
  using L = FwdTcSmem<D>;
  using namespace apex_core;
  constexpr int kPanels = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  int* seg_s = reinterpret_cast<int*>(smem + L::seg);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + kTcStages;
  uint64_t* q_full = empty + kTcStages;

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;  // longest sweeps first
  const int n_live = live_k_tiles_tc(p, row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kTcStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kTcConsumers);
    }
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kTcConsumers / 32) {  // the producer warp
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, 2 * L::kTile);
      for (int w = 0; w < 2; ++w)
        for (int pn = 0; pn < kPanels; ++pn)
          tma_load_3d(smem + L::q + w * L::kTile + pn * kPanelBytes, &q_map, q_full, pn * 64,
                      row0 + 64 * w, bh);
    }
    for (int jt = 0; jt < n_live; ++jt) {
      const int st = jt % kTcStages;
      if (jt >= kTcStages) mbar_wait(&empty[st], (jt / kTcStages - 1) & 1);
      const int col0 = jt * kTile;
      if (p.seg_k)
        for (int i = lane; i < kTile; i += 32) {
          const int pos = col0 + i;
          seg_s[st * kTile + i] = pos < p.sk ? p.seg_k[(size_t)b * p.sk + pos] : -1;
        }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[st], 2 * L::kTile);
        for (int pn = 0; pn < kPanels; ++pn) {
          tma_load_3d(smem + L::k + st * L::kTile + pn * kPanelBytes, &k_map, &full[st], pn * 64,
                      col0, bh);
          tma_load_3d(smem + L::v + st * L::kTile + pn * kPanelBytes, &v_map, &full[st], pn * 64,
                      col0, bh);
        }
      }
    }
    return;
  }

  // the consumer warpgroups: wg owns query rows row0 + 64 wg + [0, 64)
  const int wg = warp / 4;
  const int rows[2] = {row0 + 64 * wg + frag_row(0), row0 + 64 * wg + frag_row(2)};
  int seg_q[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    seg_q[h] = p.seg_q && rows[h] < p.sq ? p.seg_q[(size_t)b * p.sq + rows[h]] : -2;
  const uint32_t head = p.seed ? head_hash(p.seed, bh) : 0u;
  const uint32_t q_tile = smem_addr(smem + L::q + wg * L::kTile);

  TileCore<D> core;
  core.init();
  mbar_wait(q_full, 0);
  for (int jt = 0; jt < n_live; ++jt) {
    const int st = jt % kTcStages;
    const int col0 = jt * kTile;
    mbar_wait(&full[st], (jt / kTcStages) & 1);
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    TileCore<D>::scores(s, q_tile, kPanelBytes, smem_addr(smem + L::k + st * L::kTile),
                        kPanelBytes);
    // only a ragged, segmented or diagonal tile has entries to mask
    const bool masked = col0 + kTile > p.sk || p.seg_q ||
                        (p.causal && p.kv_offset + col0 + kTile - 1 > p.q_offset + row0 + 64 * wg);
    if (masked) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1, c = frag_col(i), col = col0 + c;
        const bool vis = col < p.sk && !(p.causal && p.q_offset + rows[h] < p.kv_offset + col) &&
                         (!p.seg_q || seg_q[h] == seg_s[st * kTile + c]);
        s[i] = vis ? s[i] * p.scale : kNegInf;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= p.scale;
    }
    core.softmax(s);
    if (p.seed) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1, col = col0 + frag_col(i);
        s[i] = keep(head, p.q_offset + rows[h], p.kv_offset + col, p.thresh) ? s[i] * p.inv_keep
                                                                            : 0.f;
      }
    }
    core.accumulate(s, smem_addr(smem + L::v + st * L::kTile), kPanelBytes);
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rows[h];
    if (row >= p.sq) continue;
    const float l_safe = core.l[h] == 0.f ? 1.f : core.l[h];
    __nv_bfloat16* orow = out + ((size_t)bh * p.sq + row) * p.d;
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn)
#pragma unroll
      for (int i = 2 * h; i < 32; i += 4) {
        const int c = pn * 64 + frag_col(i);
        if (c < p.d)
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(core.o[pn][i] / l_safe, core.o[pn][i + 1] / l_safe);
      }
    if (lane % 4 == 0)
      lse[(size_t)bh * p.sq + row] = core.l[h] == 0.f ? kNegInf : core.m[h] + logf(l_safe);
  }
}

// ------------------------------------------------------------ launchers

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

Params make_params(int heads, int sq, int sk, int d, float scale, int causal, int q_offset,
                   int kv_offset, const void* seg_q, const void* seg_k, const void* seed,
                   unsigned int thresh, float inv_keep) {
  Params p;
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.scale = scale;
  p.causal = causal;
  p.q_offset = q_offset;
  p.kv_offset = kv_offset;
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_k = static_cast<const int*>(seg_k);
  p.seed = static_cast<const int*>(seed);
  p.thresh = thresh;
  p.inv_keep = inv_keep;
  return p;
}

template <typename T, int D>
cudaError_t launch_fwd(int bh, const Params& p, const void* q, const void* k, const void* v,
                       void* out, void* lse, cudaStream_t s) {
  const size_t smem = 3 * tile_bytes(D) + score_bytes();
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.sq + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                      static_cast<const T*>(v), static_cast<T*>(out),
                                      static_cast<float*>(lse), p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(int bh, const Params& p, const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta, void* dq,
                      cudaStream_t s) {
  const size_t smem = 4 * tile_bytes(D) + score_bytes();
  auto kernel = flash_dq_kernel<T, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.sq + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(int bh, const Params& p, const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta, void* dk,
                       void* dv, cudaStream_t s) {
  const size_t smem = 4 * tile_bytes(D) + 2 * score_bytes();
  auto kernel = flash_dkv_kernel<T, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.sk + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), p);
  return cudaGetLastError();
}


template <int D>
cudaError_t launch_fwd_tc(int bh, const Params& p, const void* q, const void* k, const void* v,
                          void* out, void* lse, cudaStream_t s) {
  using apex_core::make_map_3d;
  const uint64_t row = (uint64_t)p.d * sizeof(__nv_bfloat16);
  CUtensorMap qm, km, vm;
  cudaError_t err = make_map_3d(&qm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, p.d, p.sq, bh, row,
                                row * p.sq, 64, 64, 1, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = make_map_3d(&km, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, k, p.d, p.sk, bh, row, row * p.sk,
                      64, 64, 1, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = make_map_3d(&vm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, v, p.d, p.sk, bh, row, row * p.sk,
                      64, 64, 1, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const size_t smem = FwdTcSmem<D>::bytes;
  auto kernel = flash_fwd_tc_kernel<D>;
  err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.sq + kTcRows - 1) / kTcRows);
  kernel<<<grid, kTcThreads, smem, s>>>(qm, km, vm, static_cast<__nv_bfloat16*>(out),
                                        static_cast<float*>(lse), p);
  return cudaGetLastError();
}

}  // namespace

// Dispatch on (dtype, head dim <= 64 or <= 128); anything else is refused.
#define APEX_FLASH_DISPATCH(CALL)                                 \
  if (d < 1 || d > 128) return (int)cudaErrorInvalidValue;        \
  if (dtype == kF32 && d <= 64) return (int)CALL(float, 64);      \
  if (dtype == kF32) return (int)CALL(float, 128);                \
  if (dtype == kBF16 && d <= 64) return (int)CALL(__nv_bfloat16, 64); \
  if (dtype == kBF16) return (int)CALL(__nv_bfloat16, 128);       \
  return (int)cudaErrorInvalidValue;

extern "C" int apex_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                              const void* seg_q, const void* seg_k, const void* seed, void* out,
                              void* lse, int bh, int heads, int sq, int sk, int d, int causal,
                              int q_offset, int kv_offset, float scale, unsigned int thresh,
                              float inv_keep, void* stream) {
  if (bh == 0 || sq == 0) return (int)cudaSuccess;
  const Params p = make_params(heads, sq, sk, d, scale, causal, q_offset, kv_offset, seg_q, seg_k,
                               seed, thresh, inv_keep);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define APEX_FWD(T, D) launch_fwd<T, D>(bh, p, q, k, v, out, lse, s)
  APEX_FLASH_DISPATCH(APEX_FWD)
#undef APEX_FWD
}

// F1 on the tensor cores: bf16 q, k, v ([b*h, s, d] contiguous, 16-byte
// aligned), d a multiple of 8 up to 128, sk > 0; anything else is refused.
extern "C" int apex_flash_fwd_tc(const void* q, const void* k, const void* v, const void* seg_q,
                                 const void* seg_k, const void* seed, void* out, void* lse, int bh,
                                 int heads, int sq, int sk, int d, int causal, int q_offset,
                                 int kv_offset, float scale, unsigned int thresh, float inv_keep,
                                 void* stream) {
  if (bh == 0 || sq == 0) return (int)cudaSuccess;
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v)) %
                        16) == 0;
  if (d < 8 || d > 128 || d % 8 || sk < 1 || !aligned) return (int)cudaErrorInvalidValue;
  const Params p = make_params(heads, sq, sk, d, scale, causal, q_offset, kv_offset, seg_q, seg_k,
                               seed, thresh, inv_keep);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return (int)launch_fwd_tc<64>(bh, p, q, k, v, out, lse, s);
  return (int)launch_fwd_tc<128>(bh, p, q, k, v, out, lse, s);
}

// Dynamic shared memory of flash_fwd_tc_kernel for head dim d (bytes).
extern "C" int apex_flash_fwd_tc_smem(int d) {
  return (int)(d <= 64 ? FwdTcSmem<64>::bytes : FwdTcSmem<128>::bytes);
}

extern "C" int apex_flash_dq(int dtype, const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta,
                             const void* seg_q, const void* seg_k, const void* seed, void* dq,
                             int bh, int heads, int sq, int sk, int d, int causal, int q_offset,
                             int kv_offset, float scale, unsigned int thresh, float inv_keep,
                             void* stream) {
  if (bh == 0 || sq == 0) return (int)cudaSuccess;
  const Params p = make_params(heads, sq, sk, d, scale, causal, q_offset, kv_offset, seg_q, seg_k,
                               seed, thresh, inv_keep);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define APEX_DQ(T, D) launch_dq<T, D>(bh, p, q, k, v, dout, lse, delta, dq, s)
  APEX_FLASH_DISPATCH(APEX_DQ)
#undef APEX_DQ
}

extern "C" int apex_flash_dkv(int dtype, const void* q, const void* k, const void* v,
                              const void* dout, const void* lse, const void* delta,
                              const void* seg_q, const void* seg_k, const void* seed, void* dk,
                              void* dv, int bh, int heads, int sq, int sk, int d, int causal,
                              int q_offset, int kv_offset, float scale, unsigned int thresh,
                              float inv_keep, void* stream) {
  if (bh == 0 || sk == 0) return (int)cudaSuccess;
  const Params p = make_params(heads, sq, sk, d, scale, causal, q_offset, kv_offset, seg_q, seg_k,
                               seed, thresh, inv_keep);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define APEX_DKV(T, D) launch_dkv<T, D>(bh, p, q, k, v, dout, lse, delta, dk, dv, s)
  APEX_FLASH_DISPATCH(APEX_DKV)
#undef APEX_DKV
}

#undef APEX_FLASH_DISPATCH
