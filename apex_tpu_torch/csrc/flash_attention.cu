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
// far above the card's operations-per-byte balance point.  The first
// versions below (the "simt" route) do the products in fp32 on the CUDA
// cores, not the tensor cores, so they sit well above the bf16
// tensor-core bound.  What their design keeps is the flash structure:
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
// Each of F1, F2 and F3 has a second route, a tensor-core kernel, for bf16
// operands with a head dim that is a multiple of 8 up to 128 (the Python
// wrappers' fwd_route() and bwd_route() choose it; fp32 and other head
// dims stay on the kernels above).  All three are built on the shared
// Hopper core (attention_core.cuh) and share its frame:
//   - one CTA per (batch*head, 128 rows of the outer sequence): two
//     consumer warpgroups of 64 rows each and one producer warp (F3: a
//     producer warpgroup, below); heavy tiles first, as above;
//   - the producer loads the CTA's own operands once and then 64-row tiles
//     of the other sequence with TMA through 3-D tensor maps over
//     [b*h, s, d] (rows past a head's length and columns past d arrive as
//     zeros, never from the next head) into a two-stage ring with a full
//     and an empty mbarrier per stage, the tile's per-row values beside
//     it;
//   - every product is a wgmma on the tensor cores, with the masks, scale,
//     exponent and dropout on the fp32 accumulator fragment at each
//     element's global (row, col): the same rounding points, guards and
//     dropout bits as the kernels above; a tile with nothing to mask
//     (inside the causal triangle, no segments, not ragged) only scales,
//     and a warpgroup skips the products of a tile it cannot see;
//   - the exponent is the hardware's (__expf: ex2.approx, a few ulp), as
//     in the forward: P feeds a bf16 rounding right after.
// flash_fwd_tc_kernel (F1): the CTA loads its 128 query rows of Q; the
// ring carries K and V tiles and their segment ids; S = Q K^T, the online
// softmax, dropout after the row sum, and O += P V (P rounded to bf16 in
// registers).  At head dim 64 two CTAs share an SM, so one CTA's softmax
// runs while the other's products occupy the tensor cores.  Against the
// tensor cores' bf16 rate, the bytes of q, k, v and out and the products
// are about even at the training shape; what holds this version back is
// latency: within a warpgroup the products, the softmax and the waits
// run one after another (starting tile j + 1's Q K^T beside tile j's P V
// needs about 16 more registers a thread, which spill under the two-CTA
// cap of 112).
// flash_dq_tc_kernel (F2): the CTA loads Q and dO of its 128 rows; the ring
// carries K and V tiles and the keys' segment ids; a thread's two rows'
// lse and delta stay in registers.  Per tile: S = Q K^T and dP = dO V^T
// in flight together, dS = P (dP - delta) scale, dq += dS K (dS rounded
// to K's bf16 in registers, K the MN-major B operand from the tile that
// served Q K^T).
// flash_dkv_tc_kernel (F3): the CTA loads K and V of its 128 keys and owns
// their dk and dv (no atomics, deterministic); the ring carries Q and dO
// tiles with the queries' lse_safe, delta and segment ids, and the sweep
// starts at the first query tile that can see the CTA's first key.  Per
// tile: S^T = K Q^T and dP^T = V dO^T in flight together (the fragment's
// rows are keys, its columns queries), P_drop and dS on the fragment, then
// dv += P_drop^T dO and dk += dS^T Q (both rounded to bf16 in registers,
// dO and Q the MN-major B operands).  dk and dv are fp32 sums in the
// tensor cores' order, so they are not bit-identical to the plain
// version's; the rounding points are.
// The backward kernels hold two accumulator fragments per tile beside
// their outputs (F2 at head dim 64: 153 registers a thread), more than
// the two-CTA cap of 112 allows, so one CTA runs per SM; F3 holds dk and
// dv too and takes registers from its producer warpgroup (setmaxnreg).
// What bounds them: the tensor cores' bf16 rate (14 d operations per
// visible (row, key) pair over F2 and F3, of which the two recomputed
// score products are 4 d); as in the forward, what holds them back is
// latency within a warpgroup, where the products, the elementwise work
// and the waits run one after another.
//
// Each launcher is a plain C function that returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

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

// ---------------------------------------------- F2, F3 on the tensor cores

// Shared memory of flash_dq_tc_kernel and flash_dkv_tc_kernel, as offsets
// from a 1024-byte-aligned base: the two operands a CTA loads once
// ([128 x D] each: F2's Q and dO, F3's K and V), the ring's two operands
// ([64 x D] a stage: F2's K and V tiles, F3's Q and dO tiles), three
// 64-entry rows a stage (F2: the keys' segment ids; F3: the queries'
// lse_safe, delta and segment ids), then the mbarriers.
template <int D>
struct BwdTcSmem {
  static constexpr uint32_t kTile = (D / 64) * apex_core::kPanelBytes;  // [64 x D]
  static constexpr uint32_t a = 0;
  static constexpr uint32_t b = 2 * kTile;
  static constexpr uint32_t ring_a = 4 * kTile;
  static constexpr uint32_t ring_b = ring_a + kTcStages * kTile;
  static constexpr uint32_t rows = ring_b + kTcStages * kTile;
  static constexpr uint32_t bars = rows + 3 * kTcStages * 64 * 4;
  static constexpr size_t bytes = bars + (2 * kTcStages + 1) * sizeof(uint64_t) + 1024;
};

// The barriers of a backward CTA: full / empty per ring stage, and one for
// the operands loaded once.
struct BwdBars {
  uint64_t *full, *empty, *once;
};

__device__ __forceinline__ BwdBars bwd_bars(uint8_t* base) {
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  BwdBars bars{full, full + kTcStages, full + 2 * kTcStages};
  if (threadIdx.x == 0) {
    for (int st = 0; st < kTcStages; ++st) {
      apex_core::mbar_init(&bars.full[st], 1);
      apex_core::mbar_init(&bars.empty[st], kTcConsumers);
    }
    apex_core::mbar_init(bars.once, 1);
    apex_core::fence_barrier_init();
  }
  __syncthreads();
  return bars;
}

// TMA loads of rows [row0, row0 + 128) of one head of `map` into two
// [64 x D] blocks at dst (the operands a CTA loads once), counted on `bar`
// (the caller expects the bytes).
template <int D>
__device__ __forceinline__ void load_once(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int row0, int bh) {
  for (int w = 0; w < 2; ++w)
    for (int pn = 0; pn < D / 64; ++pn)
      apex_core::tma_load_3d(dst + w * BwdTcSmem<D>::kTile + pn * apex_core::kPanelBytes, map, bar,
                             pn * 64, row0 + 64 * w, bh);
}

// TMA loads of rows [row0, row0 + 64) of one head of `map` into one
// [64 x D] ring tile at dst.
template <int D>
__device__ __forceinline__ void load_tile_tc(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                             int row0, int bh) {
  for (int pn = 0; pn < D / 64; ++pn)
    apex_core::tma_load_3d(dst + pn * apex_core::kPanelBytes, map, bar, pn * 64, row0, bh);
}

// F2: dq of 128 query rows (two consumer warpgroups of 64) over the key
// tiles they can see.  Per tile: S = Q K^T and dP = dO V^T in flight
// together, then P = exp(S scale - lse_safe) masked, dropout on dP, dS =
// P (dP - delta) scale on the fp32 fragment, and dq += dS K with dS
// rounded to bf16 as the register operand and K read MN-major from the
// same ring tile that served Q K^T.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1) flash_dq_tc_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, Params p) {
  using L = BwdTcSmem<D>;
  using namespace apex_core;
  constexpr int kPanels = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  int* seg_s = reinterpret_cast<int*>(smem + L::rows);
  const BwdBars bars = bwd_bars(smem + L::bars);

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;  // longest sweeps first
  const int n_live = live_k_tiles_tc(p, row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == kTcConsumers / 32) {  // the producer warp
    if (lane == 0) {
      mbar_arrive_expect_tx(bars.once, 4 * L::kTile);
      load_once<D>(smem + L::a, &q_map, bars.once, row0, bh);
      load_once<D>(smem + L::b, &do_map, bars.once, row0, bh);
    }
    for (int jt = 0; jt < n_live; ++jt) {
      const int st = jt % kTcStages;
      if (jt >= kTcStages) mbar_wait(&bars.empty[st], (jt / kTcStages - 1) & 1);
      const int col0 = jt * kTile;
      if (p.seg_k)
        for (int i = lane; i < kTile; i += 32) {
          const int pos = col0 + i;
          seg_s[st * kTile + i] = pos < p.sk ? p.seg_k[(size_t)b * p.sk + pos] : -1;
        }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_expect_tx(&bars.full[st], 2 * L::kTile);
        load_tile_tc<D>(smem + L::ring_a + st * L::kTile, &k_map, &bars.full[st], col0, bh);
        load_tile_tc<D>(smem + L::ring_b + st * L::kTile, &v_map, &bars.full[st], col0, bh);
      }
    }
    return;
  }

  // the consumer warpgroups: wg owns query rows r_lo + [0, 64); a thread's
  // two rows' lse_safe, delta and segment id stay in registers
  const int wg = warp / 4;
  const int r_lo = row0 + 64 * wg;
  const int rows[2] = {r_lo + frag_row(0), r_lo + frag_row(2)};
  float lse_safe[2], dlt[2];
  int seg_q[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = rows[h] < p.sq;
    const float x = in ? lse[(size_t)bh * p.sq + rows[h]] : 0.f;
    lse_safe[h] = x <= kNegInf * 0.5f ? 0.f : x;
    dlt[h] = in ? delta[(size_t)bh * p.sq + rows[h]] : 0.f;
    seg_q[h] = p.seg_q && in ? p.seg_q[(size_t)b * p.sq + rows[h]] : -2;
  }
  const uint32_t head = p.seed ? head_hash(p.seed, bh) : 0u;
  const int last_row = min(r_lo + 63, p.sq - 1);  // of this warpgroup
  const uint32_t q_tile = smem_addr(smem + L::a + wg * L::kTile);
  const uint32_t do_tile = smem_addr(smem + L::b + wg * L::kTile);

  float acc[kPanels][32];
#pragma unroll
  for (int pn = 0; pn < kPanels; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pn][i] = 0.f;
  mbar_wait(bars.once, 0);
  for (int jt = 0; jt < n_live; ++jt) {
    const int st = jt % kTcStages;
    const int col0 = jt * kTile;
    mbar_wait(&bars.full[st], (jt / kTcStages) & 1);
    // a tile none of this warpgroup's rows can see adds nothing to dq
    const bool blind = r_lo >= p.sq || (p.causal && p.q_offset + last_row < p.kv_offset + col0);
    if (!blind) {
      const uint32_t k_tile = smem_addr(smem + L::ring_a + st * L::kTile);
      const uint32_t v_tile = smem_addr(smem + L::ring_b + st * L::kTile);
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
      abt_async<D>(s, q_tile, kPanelBytes, k_tile, kPanelBytes);
      abt_async<D>(dp, do_tile, kPanelBytes, v_tile, kPanelBytes);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      // only a ragged, segmented or diagonal tile has entries to mask
      const bool masked = col0 + kTile > p.sk || p.seg_q ||
                          (p.causal && p.kv_offset + col0 + kTile - 1 > p.q_offset + r_lo);
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
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        const float pr = __expf(s[i] - lse_safe[h]);  // masked: exp(-1e30 - x) = 0
        float g = dp[i];
        if (p.seed)
          g = keep(head, p.q_offset + rows[h], p.kv_offset + col0 + frag_col(i), p.thresh)
                  ? g * p.inv_keep
                  : 0.f;
        s[i] = pr * (g - dlt[h]) * p.scale;
      }
      mma_rs<kPanels>(acc, s, k_tile, kPanelBytes);
    }
    mbar_arrive(&bars.empty[st]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= p.sq) continue;
    __nv_bfloat16* orow = dq + ((size_t)bh * p.sq + rows[h]) * p.d;
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn)
#pragma unroll
      for (int i = 2 * h; i < 32; i += 4) {
        const int c = pn * 64 + frag_col(i);
        if (c < p.d)
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(acc[pn][i], acc[pn][i + 1]);
      }
  }
}

// F3 holds dk and dv beside the S^T and dP^T fragments (192 fp32 a thread
// at head dim 128), more than the 168 registers a thread that 288 threads
// get (a quarter of the SM's registers for each of its four schedulers,
// three warps on one of them).  So its producer is a whole warpgroup that
// gives registers away: 384 threads enter with 168 each, the producer
// warpgroup drops to 40 and the consumers rise to 232 (the CTA's total is
// unchanged: 128 x 128 = 256 x 64).
constexpr int kDkvTcThreads = kTcConsumers + 128;
constexpr int kDkvProducerRegs = 40;
constexpr int kDkvConsumerRegs = 232;

// F3: dk and dv of 128 keys (two consumer warpgroups of 64) over the query
// tiles that can see them; the CTA owns its keys' dk and dv outright (no
// atomics).  The fragment's rows are keys and its columns queries, so the
// per-query lse_safe, delta and segment ids come from the ring's rows by
// column.  Per tile: S^T = K Q^T and dP^T = V dO^T in flight together,
// P, dropout and dS on the fp32 fragment (P_drop left in S^T's registers,
// dS in dP^T's), then dv += P_drop^T dO and dk += dS^T Q with the
// fragments rounded to bf16 and dO, Q read MN-major from the ring tiles
// that served the scores.
template <int D>
__global__ void __launch_bounds__(kDkvTcThreads, 1) flash_dkv_tc_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, Params p) {
  using L = BwdTcSmem<D>;
  using namespace apex_core;
  constexpr int kPanels = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  float* lse_s = reinterpret_cast<float*>(smem + L::rows);
  float* delta_s = lse_s + kTcStages * kTile;
  int* seg_s = reinterpret_cast<int*>(delta_s + kTcStages * kTile);
  const BwdBars bars = bwd_bars(smem + L::bars);

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int col0 = blockIdx.y * kTcRows;  // early keys have the longest causal sweeps
  const int first = first_q_tile(p, col0);
  const int n_tiles = max((p.sq + kTile - 1) / kTile - first, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= kTcConsumers / 32) {  // the producer warpgroup: one warp loads
    setmaxnreg_dec<kDkvProducerRegs>();
    if (warp > kTcConsumers / 32) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(bars.once, 4 * L::kTile);
      load_once<D>(smem + L::a, &k_map, bars.once, col0, bh);
      load_once<D>(smem + L::b, &v_map, bars.once, col0, bh);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kTcStages;
      if (j >= kTcStages) mbar_wait(&bars.empty[st], (j / kTcStages - 1) & 1);
      const int row0 = (first + j) * kTile;
      for (int i = lane; i < kTile; i += 32) {
        const int pos = row0 + i;
        const bool in = pos < p.sq;
        const float x = in ? lse[(size_t)bh * p.sq + pos] : 0.f;
        lse_s[st * kTile + i] = x <= kNegInf * 0.5f ? 0.f : x;
        delta_s[st * kTile + i] = in ? delta[(size_t)bh * p.sq + pos] : 0.f;
        if (p.seg_q) seg_s[st * kTile + i] = in ? p.seg_q[(size_t)b * p.sq + pos] : -1;
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_expect_tx(&bars.full[st], 2 * L::kTile);
        load_tile_tc<D>(smem + L::ring_a + st * L::kTile, &q_map, &bars.full[st], row0, bh);
        load_tile_tc<D>(smem + L::ring_b + st * L::kTile, &do_map, &bars.full[st], row0, bh);
      }
    }
    return;
  }

  // the consumer warpgroups: wg owns keys k_lo + [0, 64)
  setmaxnreg_inc<kDkvConsumerRegs>();
  const int wg = warp / 4;
  const int k_lo = col0 + 64 * wg;
  const int keys[2] = {k_lo + frag_row(0), k_lo + frag_row(2)};
  int seg_k[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    seg_k[h] = p.seg_k && keys[h] < p.sk ? p.seg_k[(size_t)b * p.sk + keys[h]] : -2;
  const uint32_t head = p.seed ? head_hash(p.seed, bh) : 0u;
  const uint32_t k_tile = smem_addr(smem + L::a + wg * L::kTile);
  const uint32_t v_tile = smem_addr(smem + L::b + wg * L::kTile);

  float dk_acc[kPanels][32], dv_acc[kPanels][32];
#pragma unroll
  for (int pn = 0; pn < kPanels; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[pn][i] = dv_acc[pn][i] = 0.f;
  mbar_wait(bars.once, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kTcStages;
    const int row0 = (first + j) * kTile;
    mbar_wait(&bars.full[st], (j / kTcStages) & 1);
    // a tile whose queries see none of this warpgroup's keys adds nothing
    const bool blind = k_lo >= p.sk ||
                       (p.causal && p.q_offset + min(row0 + kTile, p.sq) - 1 < p.kv_offset + k_lo);
    if (!blind) {
      const uint32_t q_tile = smem_addr(smem + L::ring_a + st * L::kTile);
      const uint32_t do_tile = smem_addr(smem + L::ring_b + st * L::kTile);
      const float* lse_t = lse_s + st * kTile;
      const float* delta_t = delta_s + st * kTile;
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
      abt_async<D>(s, k_tile, kPanelBytes, q_tile, kPanelBytes);
      abt_async<D>(dp, v_tile, kPanelBytes, do_tile, kPanelBytes);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      const bool masked = row0 + kTile > p.sq || k_lo + kTile > p.sk || p.seg_q ||
                          (p.causal && p.kv_offset + k_lo + kTile - 1 > p.q_offset + row0);
      if (masked) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int h = (i >> 1) & 1, c = frag_col(i), row = row0 + c;
          const bool vis = row < p.sq && keys[h] < p.sk &&
                           !(p.causal && p.q_offset + row < p.kv_offset + keys[h]) &&
                           (!p.seg_q || seg_s[st * kTile + c] == seg_k[h]);
          s[i] = vis ? s[i] * p.scale : kNegInf;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] *= p.scale;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = frag_col(i);
        const float pr = __expf(s[i] - lse_t[c]);  // masked: exp(-1e30 - x) = 0
        float pd = pr, g = dp[i];
        if (p.seed) {
          const bool kept =
              keep(head, p.q_offset + row0 + c, p.kv_offset + keys[(i >> 1) & 1], p.thresh);
          pd = kept ? pr * p.inv_keep : 0.f;
          g = kept ? g * p.inv_keep : 0.f;
        }
        s[i] = pd;
        dp[i] = pr * (g - delta_t[c]) * p.scale;
      }
      mma_rs<kPanels>(dv_acc, s, do_tile, kPanelBytes);
      mma_rs<kPanels>(dk_acc, dp, q_tile, kPanelBytes);
    }
    mbar_arrive(&bars.empty[st]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (keys[h] >= p.sk) continue;
    const size_t off = ((size_t)bh * p.sk + keys[h]) * p.d;
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn)
#pragma unroll
      for (int i = 2 * h; i < 32; i += 4) {
        const int c = pn * 64 + frag_col(i);
        if (c < p.d) {
          *reinterpret_cast<__nv_bfloat162*>(dk + off + c) =
              __floats2bfloat162_rn(dk_acc[pn][i], dk_acc[pn][i + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + c) =
              __floats2bfloat162_rn(dv_acc[pn][i], dv_acc[pn][i + 1]);
        }
      }
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


// A 3-D tensor map over a bf16 [bh, rows, d] tensor in 64 x 64 boxes with
// the 128-byte swizzle: rows past a head's `rows` and columns past d
// arrive as zeros, never from the next head.
cudaError_t head_map(CUtensorMap* map, const void* base, int rows, int bh, int d) {
  const uint64_t row = (uint64_t)d * sizeof(__nv_bfloat16);
  return apex_core::make_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, d, rows, bh, row,
                                row * rows, 64, 64, 1, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D>
cudaError_t launch_fwd_tc(int bh, const Params& p, const void* q, const void* k, const void* v,
                          void* out, void* lse, cudaStream_t s) {
  CUtensorMap qm, km, vm;
  cudaError_t err = head_map(&qm, q, p.sq, bh, p.d);
  if (err == cudaSuccess) err = head_map(&km, k, p.sk, bh, p.d);
  if (err == cudaSuccess) err = head_map(&vm, v, p.sk, bh, p.d);
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

// The four tensor maps of a backward launch: q, k, v, dout.
cudaError_t bwd_maps(CUtensorMap (&m)[4], int bh, const Params& p, const void* q, const void* k,
                     const void* v, const void* dout) {
  cudaError_t err = head_map(&m[0], q, p.sq, bh, p.d);
  if (err == cudaSuccess) err = head_map(&m[1], k, p.sk, bh, p.d);
  if (err == cudaSuccess) err = head_map(&m[2], v, p.sk, bh, p.d);
  if (err == cudaSuccess) err = head_map(&m[3], dout, p.sq, bh, p.d);
  return err;
}

template <int D>
cudaError_t launch_dq_tc(int bh, const Params& p, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta, void* dq,
                         cudaStream_t s) {
  CUtensorMap m[4];
  cudaError_t err = bwd_maps(m, bh, p, q, k, v, dout);
  if (err != cudaSuccess) return err;
  const size_t smem = BwdTcSmem<D>::bytes;
  auto kernel = flash_dq_tc_kernel<D>;
  err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.sq + kTcRows - 1) / kTcRows);
  kernel<<<grid, kTcThreads, smem, s>>>(m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
                                        static_cast<const float*>(delta),
                                        static_cast<__nv_bfloat16*>(dq), p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_tc(int bh, const Params& p, const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* delta, void* dk,
                          void* dv, cudaStream_t s) {
  CUtensorMap m[4];
  cudaError_t err = bwd_maps(m, bh, p, q, k, v, dout);
  if (err != cudaSuccess) return err;
  const size_t smem = BwdTcSmem<D>::bytes;
  auto kernel = flash_dkv_tc_kernel<D>;
  err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.sk + kTcRows - 1) / kTcRows);
  kernel<<<grid, kDkvTcThreads, smem, s>>>(m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
                                           static_cast<const float*>(delta),
                                           static_cast<__nv_bfloat16*>(dk),
                                           static_cast<__nv_bfloat16*>(dv), p);
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

// What the tensor-core kernels take: bf16 operands ([b*h, s, d]
// contiguous, 16-byte aligned), d a multiple of 8 up to 128, sk > 0.
static bool tc_operands(std::initializer_list<const void*> ptrs, int d, int sk) {
  uintptr_t bits = 0;
  for (const void* ptr : ptrs) bits |= reinterpret_cast<uintptr_t>(ptr);
  return bits % 16 == 0 && d >= 8 && d <= 128 && d % 8 == 0 && sk >= 1;
}

// F1 on the tensor cores; operands tc_operands refuses are refused.
extern "C" int apex_flash_fwd_tc(const void* q, const void* k, const void* v, const void* seg_q,
                                 const void* seg_k, const void* seed, void* out, void* lse, int bh,
                                 int heads, int sq, int sk, int d, int causal, int q_offset,
                                 int kv_offset, float scale, unsigned int thresh, float inv_keep,
                                 void* stream) {
  if (bh == 0 || sq == 0) return (int)cudaSuccess;
  if (!tc_operands({q, k, v}, d, sk)) return (int)cudaErrorInvalidValue;
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

// F2 on the tensor cores; operands tc_operands refuses are refused.
extern "C" int apex_flash_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, const void* seg_q,
                                const void* seg_k, const void* seed, void* dq, int bh, int heads,
                                int sq, int sk, int d, int causal, int q_offset, int kv_offset,
                                float scale, unsigned int thresh, float inv_keep, void* stream) {
  if (bh == 0 || sq == 0) return (int)cudaSuccess;
  if (!tc_operands({q, k, v, dout}, d, sk)) return (int)cudaErrorInvalidValue;
  const Params p = make_params(heads, sq, sk, d, scale, causal, q_offset, kv_offset, seg_q, seg_k,
                               seed, thresh, inv_keep);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return (int)launch_dq_tc<64>(bh, p, q, k, v, dout, lse, delta, dq, s);
  return (int)launch_dq_tc<128>(bh, p, q, k, v, dout, lse, delta, dq, s);
}

// F3 on the tensor cores; operands tc_operands refuses are refused.  With
// no query rows dk and dv are zeros (a tensor map needs every dimension
// positive, so no kernel runs).
extern "C" int apex_flash_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, const void* seg_q,
                                 const void* seg_k, const void* seed, void* dk, void* dv, int bh,
                                 int heads, int sq, int sk, int d, int causal, int q_offset,
                                 int kv_offset, float scale, unsigned int thresh, float inv_keep,
                                 void* stream) {
  if (bh == 0 || sk == 0) return (int)cudaSuccess;
  if (!tc_operands({q, k, v, dout}, d, sk)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sq == 0) {
    const size_t bytes = (size_t)bh * sk * d * sizeof(__nv_bfloat16);
    cudaError_t err = cudaMemsetAsync(dk, 0, bytes, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, bytes, s);
    return (int)err;
  }
  const Params p = make_params(heads, sq, sk, d, scale, causal, q_offset, kv_offset, seg_q, seg_k,
                               seed, thresh, inv_keep);
  if (d <= 64) return (int)launch_dkv_tc<64>(bh, p, q, k, v, dout, lse, delta, dk, dv, s);
  return (int)launch_dkv_tc<128>(bh, p, q, k, v, dout, lse, delta, dk, dv, s);
}

// Dynamic shared memory of flash_dq_tc_kernel / flash_dkv_tc_kernel for
// head dim d (bytes; the two share one layout).
extern "C" int apex_flash_dq_tc_smem(int d) {
  return (int)(d <= 64 ? BwdTcSmem<64>::bytes : BwdTcSmem<128>::bytes);
}
extern "C" int apex_flash_dkv_tc_smem(int d) { return apex_flash_dq_tc_smem(d); }

#undef APEX_FLASH_DISPATCH
