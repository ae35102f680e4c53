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
// What bounds it on the H100: latency, then bytes.  A rank-r bypass does
// 2 r multiply-adds per (row, in + out) element: at rank 8 about 16
// operations for each x element and each A/B element it reads, far below
// the ~295 operations per byte where the tensor cores would be the limit;
// and at the serving widths (8 slots, S = 1, 5, 128) the bytes are well
// under a few MB, so the launch and the chain of dependent loads set the
// time.  Two kernels, chosen by the wrapper (lora_route):
//
// lora_cluster_kernel<TX, TW, R, ROWS> (route "cluster", rank R of 4, 8 or
// 16, 16-byte-aligned A and B): a thread-block cluster of kRanks CTAs per
// (batch slot, tile of ROWS rows of S); ROWS is 8 up to S = 8 (decode and
// the k + 1 verify) and 16 above (prefill chunks).  CTA q of the cluster
// takes the q-th slice of `in` and the q-th slice of `out`:
//   - the CTA reads slots[i] itself (no host sync), then asks L2 for its
//     rows of A[slot] and columns of B[slot] (prefetch), so those loads
//     overlap the staging of x and the first product;
//   - phase 1: its partial t = x[rows, i, slice] @ A[slot][slice, :] in
//     fp32 (never rounded to bf16, as on the TPU).  The x tile is staged
//     in shared memory in 16-byte loads, 512 values of `in` at a time; a
//     warp takes up to two rows (or, with fewer rows than warps, a row in
//     one of several splits of k), its lanes consecutive k, so A's R-wide
//     rows come in coalesced 16-byte (or 8-byte) loads and serve every
//     row of the warp; a lane sums its k in order, the warp's lanes meet
//     in the shuffle tree, the splits in order;
//   - the partial is pushed into every CTA of the cluster through
//     distributed shared memory, one barrier.cluster, and each CTA adds
//     the kRanks partials in rank order: every CTA holds the same t, bit
//     for bit, computed once per (slot, row tile) instead of once per
//     column tile;
//   - phase 2: a thread takes 8 (fp32 y: 4) output columns of up to four
//     rows, reads B's rows for them in 16-byte loads, and writes y in
//     16-byte stores.
//   Every sum runs in a fixed order, so a second call is bit for bit the
//   first.  Unaligned x rows, y rows and B rows (in, out not multiples of
//   the chunk, a misaligned view) take single-element loads and stores.
//
// lora_delta_kernel<TX, TW> (route "simt", any rank): one CTA per (batch
// slot, tile of 256 output columns, tile of 16 rows of S):
//   - phase 1: t = x[rows, i, :] @ A[slot] into fp32 shared memory.  Each
//     warp takes a (row, slice of in) task; lanes read consecutive x
//     elements and consecutive A rows (r contiguous values each), so both
//     loads coalesce; partial sums meet in shared memory and are added in
//     a fixed order (deterministic);
//   - phase 2: each thread owns one output column, reads its B column once
//     per rank index (coalesced across the warp) and keeps the 16 rows'
//     sums in registers; one cast and one store per output element.
//   Every output tile recomputes its rows' t over the whole of `in`.
// In both, ragged edges of S, in, out and r are masked.  A slot outside
// [0, n_slots) writes NaN rows, so a bad slot vector shows instead of
// reading stray memory.  The zero adapter (all-zero A and B) gives exact
// zeros.
//
// The launchers are plain C functions that return cudaGetLastError().

#include <cooperative_groups.h>
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
cudaError_t launch_simt(const void* x, const void* a, const void* b, const void* slots, void* y,
                        int S, int B, int n_in, int r, int n_out, int n_slots, long long sx_s,
                        long long sx_b, cudaStream_t stream) {
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

// ------------------------------------------------------ route "cluster"

constexpr int kRanks = 8;     // CTAs of a cluster: slices of in and of out
constexpr int kRowGroup = 4;  // rows a thread carries in phase 2
constexpr int kKBlock = 512;  // values of in staged at a time (a GPT-124M slice: one)

// N consecutive values of T at p, aligned to min(16, N * sizeof(T)) bytes,
// as fp32, in 16-byte (or 8-byte) loads.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  static_assert(kBytes % 8 == 0, "whole 8-byte words");
  uint32_t u[kBytes / 4];
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
      u[4 * i] = v.x;
      u[4 * i + 1] = v.y;
      u[4 * i + 2] = v.z;
      u[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kBytes / 8; ++i) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + i);
      u[2 * i] = v.x;
      u[2 * i + 1] = v.y;
    }
  }
#pragma unroll
  for (int i = 0; i < kBytes / 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      f[i] = __uint_as_float(u[i]);
    } else {  // two bf16, the first in the low half
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
}

// 16 bytes of T at p (16-byte aligned) from fp32, in one store.
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[N]) {
  static_assert(N * sizeof(T) == 16, "one 16-byte store");
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4)
      u[i] = __float_as_uint(f[i]);
    else
      u[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1])) << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// The first half of a cluster barrier (no ordering), and the wait that
// ends it.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Three CTAs an SM (80 registers): with no minimum ptxas held the
// fp32-x, bf16-arena, rank-4 instance to 40 registers and spilled; with
// one or two it took 95-127 and the 128-row calls ran 25% slower; four
// spilled.
template <typename TX, typename TW, int R, int ROWS>
__global__ void __cluster_dims__(kRanks, 1, 1) __launch_bounds__(kThreads, 3) lora_cluster_kernel(
    const TX* __restrict__ x,        // [S, B, in], strides (sx_s, sx_b, 1)
    const TW* __restrict__ a,        // [n_slots, in, R], 16-byte aligned
    const TW* __restrict__ b,        // [n_slots, R, out], 16-byte aligned
    const int* __restrict__ slots,   // [B]
    TX* __restrict__ y,              // [S, B, out], 16-byte aligned
    int S, int B, int n_in, int n_out, int n_slots, long long sx_s, long long sx_b) {
  namespace cg = cooperative_groups;
  constexpr int XV = 16 / sizeof(TX);   // x (and y) values in 16 bytes
  constexpr int kTasks = ROWS > kWarps ? ROWS : kWarps;
  __shared__ float part[kRanks][ROWS * R];   // each rank's partial t, pushed by that rank
  __shared__ float split[kTasks][R];         // phase 1's (row, split) sums
  __shared__ float t_s[ROWS * R];
  __shared__ __align__(16) unsigned char x_raw[ROWS * kKBlock * sizeof(TX)];
  TX* x_s = reinterpret_cast<TX*>(x_raw);    // [ROWS, kKBlock], a block of x
  cg::cluster_group cluster = cg::this_cluster();
  const int q = blockIdx.x;   // the rank: the grid is one cluster wide
  const int i = blockIdx.y;
  const int s0 = blockIdx.z * ROWS;
  const int rows = min(ROWS, S - s0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this CTA's slices of in and of out, in whole 16-byte chunks of x and y
  const int k_per = (n_in + kRanks * XV - 1) / (kRanks * XV) * XV;
  const int k0 = min(n_in, q * k_per), k1 = min(n_in, k0 + k_per);
  const int c_per = (n_out + kRanks * XV - 1) / (kRanks * XV) * XV;
  const int c0 = min(n_out, q * c_per), c1 = min(n_out, c0 + c_per);
  TX* yi = y + (size_t)i * n_out;
  const size_t y_step = (size_t)B * n_out;   // y's stride along S
  const int slot = slots[i];

  if (slot < 0 || slot >= n_slots) {  // the same branch for the whole cluster
    const int cols = c1 - c0;
    for (int e = threadIdx.x; e < rows * cols; e += kThreads)
      store(yi + (size_t)(s0 + e / cols) * y_step + c0 + e % cols, __int_as_float(0x7fffffff));
    return;
  }
  cluster_arrive_relaxed();   // every CTA of the cluster has started (waited on below)
  const TW* a_slot = a + (size_t)slot * n_in * R;
  const TW* b_slot = b + (size_t)slot * R * n_out;
  {  // this CTA's A rows (contiguous) and B columns into L2 while x is staged
    constexpr int kLine = 128 / sizeof(TW);
    const int a_lines = ((k1 - k0) * R + kLine - 1) / kLine;
    for (int e = threadIdx.x; e < a_lines; e += kThreads)
      prefetch_l2(a_slot + (size_t)k0 * R + e * kLine);
    const int lines = (c1 - c0 + kLine - 1) / kLine;
    for (int e = threadIdx.x; e < R * lines; e += kThreads)
      prefetch_l2(b_slot + (size_t)(e / lines) * n_out + c0 + (e % lines) * kLine);
  }

  // Phase 1: this CTA's partial t[row, :] = x[s0 + row, i, k0:k1] @
  // A[slot][k0:k1], kKBlock values of k at a time: the x tile is staged in
  // shared memory in 16-byte loads, then lane l of a warp takes k = l,
  // l + 32 nsplit, ... of the block, so a warp's A loads are consecutive
  // R-wide rows; warp w takes the rows w, w + groups, ... (up to two), or,
  // with fewer rows than warps, a row in one of nsplit splits of k.
  const int groups = rows < kWarps ? rows : kWarps;
  const int nsplit = kWarps / groups;
  const int wg = warp % groups, sp = warp / groups;
  float acc[ROWS / kWarps][R];
#pragma unroll
  for (int rr = 0; rr < ROWS / kWarps; ++rr)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[rr][j] = 0.f;
  for (int kb = k0; kb < k1; kb += kKBlock) {
    const int kn = min(kKBlock, k1 - kb);
    const int row_chunks = (kn + XV - 1) / XV;
    for (int e = threadIdx.x; e < rows * row_chunks; e += kThreads) {
      const int row = e / row_chunks, c = (e % row_chunks) * XV;
      const TX* src = x + (size_t)(s0 + row) * sx_s + (size_t)i * sx_b + kb + c;
      TX* dst = x_s + row * kKBlock + c;
      if (c + XV <= kn && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
        *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        for (int v = 0; v < XV && c + v < kn; ++v) dst[v] = src[v];
      }
    }
    __syncthreads();
    if (sp < nsplit) {
#pragma unroll 4
      for (int k = sp * 32 + lane; k < kn; k += nsplit * 32) {
        float av[R];
        load_vec<TW, R>(a_slot + (size_t)(kb + k) * R, av);
#pragma unroll
        for (int rr = 0; rr < ROWS / kWarps; ++rr) {
          const int row = wg + rr * groups;
          if (row < rows) {
            const float xv = to_float(x_s[row * kKBlock + k]);
#pragma unroll
            for (int j = 0; j < R; ++j) acc[rr][j] += xv * av[j];
          }
        }
      }
    }
    __syncthreads();   // x_s is restaged for the next block
  }
#pragma unroll
  for (int rr = 0; rr < ROWS / kWarps; ++rr) {
    const int row = wg + rr * groups;
#pragma unroll
    for (int j = 0; j < R; ++j) acc[rr][j] = warp_sum(acc[rr][j]);
    if (sp < nsplit && row < rows && lane == 0) {
#pragma unroll
      for (int j = 0; j < R; ++j) split[sp * rows + row][j] = acc[rr][j];
    }
  }
  __syncthreads();
  cluster_wait();
  // The partial (its splits in order) into part[q] of every CTA of the
  // cluster; after the barrier each CTA adds the ranks' partials in order.
  for (int e = threadIdx.x; e < rows * R; e += kThreads) {
    const int row = e / R, j = e % R;
    float sum = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) sum += split[sp * rows + row][j];
#pragma unroll
    for (int dst = 0; dst < kRanks; ++dst) cluster.map_shared_rank(part[q], dst)[e] = sum;
  }
  cluster.sync();
  for (int e = threadIdx.x; e < rows * R; e += kThreads) {
    float t = part[0][e];
#pragma unroll
    for (int src = 1; src < kRanks; ++src) t += part[src][e];
    t_s[e] = t;
  }
  __syncthreads();

  // Phase 2: y[s0 + row, i, c0:c1] = t[row, :] @ B[slot][:, c0:c1]; a task
  // is XV columns of up to kRowGroup rows.
  const bool b_vec = (n_out * sizeof(TW)) % 16 == 0;
  const bool y_vec = (n_out * sizeof(TX)) % 16 == 0;
  const int col_chunks = (c1 - c0 + XV - 1) / XV;
  const int row_groups = (rows + kRowGroup - 1) / kRowGroup;
  for (int task = threadIdx.x; task < col_chunks * row_groups; task += kThreads) {
    const int c = c0 + (task % col_chunks) * XV, g0 = (task / col_chunks) * kRowGroup;
    const bool whole = c + XV <= c1;
    float acc[kRowGroup][XV];
#pragma unroll
    for (int g = 0; g < kRowGroup; ++g)
#pragma unroll
      for (int v = 0; v < XV; ++v) acc[g][v] = 0.f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float bv[XV];
      const TW* br = b_slot + (size_t)j * n_out + c;
      if (b_vec && whole) {
        load_vec<TW, XV>(br, bv);
      } else {
#pragma unroll
        for (int v = 0; v < XV; ++v) bv[v] = c + v < c1 ? to_float(br[v]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < kRowGroup; ++g) {
        const float tv = g0 + g < rows ? t_s[(g0 + g) * R + j] : 0.f;
#pragma unroll
        for (int v = 0; v < XV; ++v) acc[g][v] += tv * bv[v];
      }
    }
#pragma unroll
    for (int g = 0; g < kRowGroup; ++g) {
      if (g0 + g >= rows) break;
      TX* yr = yi + (size_t)(s0 + g0 + g) * y_step + c;
      if (y_vec && whole) {
        store_vec<TX, XV>(yr, acc[g]);
      } else {
#pragma unroll
        for (int v = 0; v < XV; ++v)
          if (c + v < c1) store(yr + v, acc[g][v]);
      }
    }
  }
}

template <typename TX, typename TW, int R, int ROWS>
cudaError_t launch_cluster_shape(const void* x, const void* a, const void* b, const void* slots,
                                 void* y, int S, int B, int n_in, int n_out, int n_slots,
                                 long long sx_s, long long sx_b, cudaStream_t stream) {
  const dim3 grid(kRanks, B, (S + ROWS - 1) / ROWS);
  lora_cluster_kernel<TX, TW, R, ROWS><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(a), static_cast<const TW*>(b),
      static_cast<const int*>(slots), static_cast<TX*>(y), S, B, n_in, n_out, n_slots, sx_s,
      sx_b);
  return cudaGetLastError();
}

// Rows of S per cluster: 8 up to S = 8 (decode, the k + 1 verify), else 16.
template <typename TX, typename TW, int R>
cudaError_t launch_cluster_rank(const void* x, const void* a, const void* b, const void* slots,
                                void* y, int S, int B, int n_in, int n_out, int n_slots,
                                long long sx_s, long long sx_b, cudaStream_t stream) {
  if (S <= 8)
    return launch_cluster_shape<TX, TW, R, 8>(x, a, b, slots, y, S, B, n_in, n_out, n_slots,
                                              sx_s, sx_b, stream);
  return launch_cluster_shape<TX, TW, R, 16>(x, a, b, slots, y, S, B, n_in, n_out, n_slots,
                                             sx_s, sx_b, stream);
}

template <typename TX, typename TW>
cudaError_t launch_cluster(const void* x, const void* a, const void* b, const void* slots,
                           void* y, int S, int B, int n_in, int r, int n_out, int n_slots,
                           long long sx_s, long long sx_b, cudaStream_t stream) {
  switch (r) {
    case 4:
      return launch_cluster_rank<TX, TW, 4>(x, a, b, slots, y, S, B, n_in, n_out, n_slots,
                                            sx_s, sx_b, stream);
    case 8:
      return launch_cluster_rank<TX, TW, 8>(x, a, b, slots, y, S, B, n_in, n_out, n_slots,
                                            sx_s, sx_b, stream);
    case 16:
      return launch_cluster_rank<TX, TW, 16>(x, a, b, slots, y, S, B, n_in, n_out, n_slots,
                                             sx_s, sx_b, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Route "simt" (lora_delta_kernel, any rank).
extern "C" int apex_lora_delta(int x_dtype, int w_dtype, const void* x, const void* a,
                               const void* b, const void* slots, void* y, int S, int B, int n_in,
                               int r, int n_out, int n_slots, long long sx_s, long long sx_b,
                               void* stream) {
  if (S == 0 || B == 0 || n_out == 0) return (int)cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define APEX_LORA_CASE(LAUNCH, XT, WT, TX_, TW_)                                          \
  if (x_dtype == XT && w_dtype == WT)                                                     \
    return (int)LAUNCH<TX_, TW_>(x, a, b, slots, y, S, B, n_in, r, n_out, n_slots, sx_s, \
                                 sx_b, st);
#define APEX_LORA_CASES(LAUNCH)                                 \
  APEX_LORA_CASE(LAUNCH, kF32, kF32, float, float)              \
  APEX_LORA_CASE(LAUNCH, kF32, kBF16, float, __nv_bfloat16)     \
  APEX_LORA_CASE(LAUNCH, kBF16, kF32, __nv_bfloat16, float)     \
  APEX_LORA_CASE(LAUNCH, kBF16, kBF16, __nv_bfloat16, __nv_bfloat16)
  APEX_LORA_CASES(launch_simt)
  return (int)cudaErrorInvalidValue;
}

// Route "cluster" (lora_cluster_kernel): rank 4, 8 or 16, a and b 16-byte
// aligned; the same arguments.
extern "C" int apex_lora_delta_cluster(int x_dtype, int w_dtype, const void* x, const void* a,
                                       const void* b, const void* slots, void* y, int S, int B,
                                       int n_in, int r, int n_out, int n_slots, long long sx_s,
                                       long long sx_b, void* stream) {
  if (S == 0 || B == 0 || n_out == 0) return (int)cudaSuccess;
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(y)) % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  APEX_LORA_CASES(launch_cluster)
#undef APEX_LORA_CASES
#undef APEX_LORA_CASE
  return (int)cudaErrorInvalidValue;
}
