// Paged attention over the block-table KV cache, for Hopper (sm_90a).
//
// Replaces two TPU kernels of apex_tpu/serving/paged_attention.py:
//   K1  _decode_kernel   (paged_attention_decode)  one query token per slot
//   K2  _prefill_kernel  (_multi_query_attention)  T query tokens per slot,
//                                                  each with its own causal limit
// Each has two routes, which the Python wrapper chooses from the operands
// (decode_route(), prefill_route()); neither falls back to the other.
//
// What bounds both on the H100: bytes.  At serving shapes (head_dim 64, one
// query token per head, or a 128-token chunk) each K/V element read from
// device memory feeds 2 multiply-adds per query row sharing its KV group,
// far below the ~295 operations per byte where the tensor cores would be
// the limit.  So every route reads each live K/V row once per CTA, in its
// storage dtype (bf16 and int8 caches move half and a quarter of the fp32
// bytes), never materialises a gathered copy of the cache, and never reads
// a table entry past the slot's live blocks.
// Semantics kept from the TPU kernel on every route: scale 1/sqrt(d) by
// default, mask value -1e30 with the all-masked guard (m_safe) and l == 0
// -> 1 at the end, so a length or limit of 0 gives exact zeros.
//
// The "simt" route of both, paged_attention_kernel<TQ, TKV, MULTI>, is the
// first kernel: K1 is its MULTI = false instance (every row's limit is the
// slot's length), K2's simt route its MULTI = true instance (per-token
// limits).  It takes fp32 and every shape the other routes refuse:
//   - one CTA per (slot, kv group[, tile of query tokens]); the CTA reads its
//     own block-table row and loops over the live blocks only
//     (j < ceil(min(length, largest limit of the tile) / block_size));
//   - each step stages TILE cache rows of K and V in shared memory as fp32
//     with 16-byte loads (the int8 dequant, value * row scale, happens on
//     the way in), and all hpg query heads of the group (times the query
//     tile for K2) use them: the GQA saving of the TPU kernel;
//   - the online-softmax state (m, l, acc) stays on chip in fp32 for the
//     whole sweep; the output is written once, in q's dtype.
// At decode it holds one CTA to its slot's whole context, 64 keys and four
// barriers a step: a 1024-token slot is 16 steps in a row while short
// slots leave their SMs idle, so it is bound by latency and imbalance, not
// by bytes.
//
// K1's "split" route, paged_decode_split_kernel, for bf16 q over a bf16 or
// int8 cache (head dim a multiple of 8 up to 128, up to 8 query heads per
// kv head), is flash-decoding:
//   - the grid is (slot, kv group, span of kSpan = 128 cache positions);
//     the number of spans comes from the table's width (max_blocks * bs),
//     never from the lengths, so the host reads nothing of the device; a
//     span that starts at or past the slot's length exits at once;
//   - inside a CTA the K/V rows go straight to registers: a group of KL
//     lanes reads one cache row (8 columns a lane: 16-byte bf16 or 8-byte
//     int8 loads; a 64-wide bf16 row is 8 lanes, so a warp reads 4 keys an
//     instruction), each lane loads U keys (8 for up to 2 query heads per
//     kv head) before using any, the dot products reduce with shuffles
//     inside the group, and all hpg query rows of the group, kept in
//     registers, use each K/V row;
//   - each group keeps its own online softmax in fp32 (P stays fp32, as in
//     the TPU kernel: one query row per head would waste 63 of wgmma's 64
//     rows); int8 rows are dequantised by folding the row scale into the
//     score and into P; the groups merge with shuffles and the four warps
//     once, through shared memory, at the end of the span;
//   - a slot whose live context is one span writes its output directly;
//     otherwise each span writes (m, l, acc[d]) in fp32 to a partials
//     buffer and takes a ticket (an atomic add after __threadfence) for its
//     (slot, kv group): the last one combines the spans under the same
//     m_safe guard, writes the output in bf16 and resets the ticket, so K1
//     stays one launch per call and the tickets stay zeroed between
//     launches.
// It differs from the simt route and the plain version only in the order
// of its fp32 sums.
//
// K2's "tc" route, paged_prefill_tc_kernel, for bf16 q over a bf16 or int8
// cache with a head dim that is a multiple of 8 (bf16) or 16 (int8) up to
// 128 and a block size that divides 64 in multiples of 8 (fp32 and other
// shapes stay on the simt route, bit for bit).  It is built on the shared
// Hopper core (attention_core.cuh):
//   - one CTA per (slot, kv group, 64 query rows), rows being (token, head
//     of the group) pairs as above: one consumer warpgroup and one
//     producer warp;
//   - the producer reads the slot's block-table row and brings each live
//     page of K and V in with one TMA load per page (a 3-D tensor map over
//     the arena as [n_blocks * bs, g, d], a box of [bs, 1, d]) into a
//     two-stage ring with full/empty mbarriers, 64 keys per stage; page
//     slots past the sweep load out of bounds and arrive as zeros.  The
//     sweep is min(live blocks, ceil(largest limit of the tile / bs))
//     pages, as above;
//   - the consumers run Q K^T and P V as wgmma, with the per-row limits,
//     the scale and the online softmax on the fp32 accumulator fragment;
//   - an int8 cache is not dequantised into bf16: its values are exact in
//     bf16, so the consumers copy each int8 page into a bf16 tile unscaled
//     (then fence.proxy.async before the wgmma reads it), fold the K row
//     scale into the score column, s = scale * k_scale[c] * (q . k[c]),
//     and the V row scale into P before its rounding, P'[r, c] =
//     P[r, c] * v_scale[c];
//   - rounding point: P (P' for int8) is rounded to bf16 before P V.  The
//     simt and split routes and the TPU kernel's einsum("tns,snd->tnd",
//     p, v) take P in fp32; bf16 P is the rounding F1 and SDPA make, and
//     the one the TPU's MXU makes for an fp32 einsum at default precision.
// What bounds it: bytes, as above; each CTA reads its slot's live pages
// once per 64 query rows.
//
// Each launcher is a plain C function that returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_core.cuh"

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


// ------------------------------------------------- K2 on the tensor cores

constexpr int kPfStages = 2;                   // K/V ring depth
constexpr int kPfConsumers = 128;              // one warpgroup of 64 query rows
constexpr int kPfThreads = kPfConsumers + 32;  // and one producer warp

// Shared memory of paged_prefill_tc_kernel, as offsets from a
// 1024-byte-aligned base: Q [64 x D] (swizzled bf16 panels); the ring's K
// and V tiles of 64 keys, as swizzled bf16 panels or, for an int8 cache,
// as raw [64 x D] bytes with the bf16 tiles they are copied into and the
// tile's K and V row scales; then the mbarriers.
template <bool INT8, int D>
struct PrefillTcSmem {
  static constexpr uint32_t kTile = (D / 64) * apex_core::kPanelBytes;
  static constexpr uint32_t kStage = INT8 ? 64 * D : kTile;
  static constexpr uint32_t q = 0;
  static constexpr uint32_t k = kTile;
  static constexpr uint32_t v = k + kPfStages * kStage;
  static constexpr uint32_t conv_k = v + kPfStages * kStage;
  static constexpr uint32_t conv_v = conv_k + (INT8 ? kTile : 0);
  static constexpr uint32_t scales = conv_v + (INT8 ? kTile : 0);
  static constexpr uint32_t bars = scales + (INT8 ? kPfStages * 2 * 64 * sizeof(float) : 0);
  static constexpr size_t bytes = bars + 2 * kPfStages * sizeof(uint64_t) + 1024;
};

// The sweep of one tile of query rows, computed by a whole warp: the
// number of cache positions swept (whole live blocks up to the largest
// limit of the tile's tokens) and of 64-key tiles.
struct Sweep {
  int tokens, tiles;
};

__device__ __forceinline__ Sweep prefill_sweep(const int* limits, int length, int b, int T,
                                               int hpg, int bs, int max_blocks) {
  const int t_lo = blockIdx.z * 64 / hpg;
  const int t_hi = min(T - 1, (blockIdx.z * 64 + 63) / hpg);
  int max_lim = 0;
  for (int t = t_lo + threadIdx.x % 32; t <= t_hi; t += 32)
    max_lim = max(max_lim, limits[(size_t)b * T + t]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) max_lim = max(max_lim, __shfl_xor_sync(0xffffffffu, max_lim, o));
  const int live_blocks = min((max(length, 0) + bs - 1) / bs, max_blocks);
  const int blocks = min(live_blocks, (max_lim + bs - 1) / bs);
  return {blocks * bs, (blocks * bs + 63) / 64};
}

// 16 int8 values of a raw tile row -> 16 bf16 at column c (a multiple of
// 16) of row r of a swizzled tile.
__device__ __forceinline__ void int8_to_bf16(uint8_t* tile, const int8_t* src, int r, int c) {
  const int4 raw = *reinterpret_cast<const int4*>(src);
  const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = apex_core::pack_bf16((float)x[2 * i], (float)x[2 * i + 1]);
  uint8_t* panel = tile + (c / 64) * apex_core::kPanelBytes;
  *reinterpret_cast<uint4*>(panel + apex_core::swizzled(r, c % 64)) =
      make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(panel + apex_core::swizzled(r, c % 64 + 8)) =
      make_uint4(w[4], w[5], w[6], w[7]);
}

template <bool INT8, int D>
__global__ void __launch_bounds__(kPfThreads) paged_prefill_tc_kernel(
    const __grid_constant__ CUtensorMap k_map,  // [n_blocks * bs, g, d]
    const __grid_constant__ CUtensorMap v_map,
    const __nv_bfloat16* __restrict__ q,   // [B, T, n, d]
    const float* __restrict__ k_scales,    // [n_blocks, bs, g] (int8 only)
    const float* __restrict__ v_scales,
    const int* __restrict__ tables,        // [B, max_blocks]
    const int* __restrict__ lengths,       // [B]
    const int* __restrict__ limits,        // [B, T]
    __nv_bfloat16* __restrict__ out,       // [B, T, n, d]
    int T, int n, int g, int d, int bs, int max_blocks, int cache_rows, float scale) {
  using L = PrefillTcSmem<INT8, D>;
  using namespace apex_core;
  constexpr int kPanels = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  float* scales = reinterpret_cast<float*>(smem + L::scales);  // [stage][k, v][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + kPfStages;

  const int b = blockIdx.x, grp = blockIdx.y;
  const int hpg = n / g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* table = tables + (size_t)b * max_blocks;
  const Sweep sweep = prefill_sweep(limits, lengths[b], b, T, hpg, bs, max_blocks);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kPfStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kPfConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kPfConsumers / 32) {  // the producer warp
    const int pages = 64 / bs;      // pages per 64-key tile
    const int live_pages = sweep.tokens / bs;
    for (int jt = 0; jt < sweep.tiles; ++jt) {
      const int st = jt % kPfStages;
      if (jt >= kPfStages) mbar_wait(&empty[st], (jt / kPfStages - 1) & 1);
      if (INT8)
        for (int i = lane; i < 64; i += 32) {
          const int pos = jt * 64 + i;
          float ks = 0.f, vs = 0.f;
          if (pos < sweep.tokens) {
            const size_t row = ((size_t)table[pos / bs] * bs + pos % bs) * g + grp;
            ks = k_scales[row];
            vs = v_scales[row];
          }
          scales[(st * 2) * 64 + i] = ks;
          scales[(st * 2 + 1) * 64 + i] = vs;
        }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[st], 2 * L::kStage);
        for (int pg = 0; pg < pages; ++pg) {
          const int page = jt * pages + pg;
          const int row = page < live_pages ? table[page] * bs : cache_rows;  // else all zeros
          if (INT8) {
            const uint32_t off = st * L::kStage + pg * bs * D;
            tma_load_3d(smem + L::k + off, &k_map, &full[st], 0, grp, row);
            tma_load_3d(smem + L::v + off, &v_map, &full[st], 0, grp, row);
          } else {
            for (int pn = 0; pn < kPanels; ++pn) {
              const uint32_t off = st * L::kStage + pn * kPanelBytes + pg * bs * 128;
              tma_load_3d(smem + L::k + off, &k_map, &full[st], pn * 64, grp, row);
              tma_load_3d(smem + L::v + off, &v_map, &full[st], pn * 64, grp, row);
            }
          }
        }
      }
    }
    return;
  }

  // the consumer warpgroup: rows r = z * 64 + [0, 64) are (token r / hpg,
  // head grp * hpg + r % hpg)
  const int tid = threadIdx.x;
  const int r0 = blockIdx.z * 64;
  for (int idx = tid; idx < 64 * (D / 8); idx += kPfConsumers) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const int t = (r0 + r) / hpg, h = grp * hpg + (r0 + r) % hpg;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t < T && c < d) val = *reinterpret_cast<const uint4*>(q + (((size_t)b * T + t) * n + h) * d + c);
    *reinterpret_cast<uint4*>(smem + L::q + (c / 64) * kPanelBytes + swizzled(r, c % 64)) = val;
  }
  fence_proxy_async();
  named_barrier(1, kPfConsumers);

  int tok[2], head[2], lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + frag_row(2 * h);
    tok[h] = r / hpg;
    head[h] = grp * hpg + r % hpg;
    lim[h] = tok[h] < T ? limits[(size_t)b * T + tok[h]] : 0;
  }

  TileCore<D> core;
  core.init();
  for (int jt = 0; jt < sweep.tiles; ++jt) {
    const int st = jt % kPfStages;
    mbar_wait(&full[st], (jt / kPfStages) & 1);
    uint32_t k_tile = smem_addr(smem + L::k + st * L::kStage);
    uint32_t v_tile = smem_addr(smem + L::v + st * L::kStage);
    if (INT8) {
      named_barrier(1, kPfConsumers);  // the last tile's products are done with conv_k/v
      const int8_t* rk = reinterpret_cast<const int8_t*>(smem + L::k + st * L::kStage);
      const int8_t* rv = reinterpret_cast<const int8_t*>(smem + L::v + st * L::kStage);
      for (int idx = tid; idx < 64 * (D / 16); idx += kPfConsumers) {
        const int r = idx / (D / 16), c = (idx % (D / 16)) * 16;
        int8_to_bf16(smem + L::conv_k, rk + r * D + c, r, c);
        int8_to_bf16(smem + L::conv_v, rv + r * D + c, r, c);
      }
      fence_proxy_async();
      named_barrier(1, kPfConsumers);
      k_tile = smem_addr(smem + L::conv_k);
      v_tile = smem_addr(smem + L::conv_v);
    }
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    TileCore<D>::scores(s, smem_addr(smem + L::q), kPanelBytes, k_tile, kPanelBytes);
    const float* ks = scales + (st * 2) * 64;
    const float* vs = ks + 64;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1, c = frag_col(i), pos = jt * 64 + c;
      const bool live = pos < lim[h] && pos < sweep.tokens;
      s[i] = live ? s[i] * (INT8 ? scale * ks[c] : scale) : kNegInf;
    }
    core.softmax(s);
    if (INT8) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= vs[frag_col(i)];
    }
    core.accumulate(s, v_tile, kPanelBytes);
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (tok[h] >= T) continue;
    const float l_safe = core.l[h] == 0.f ? 1.f : core.l[h];
    __nv_bfloat16* orow = out + (((size_t)b * T + tok[h]) * n + head[h]) * d;
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn)
#pragma unroll
      for (int i = 2 * h; i < 32; i += 4) {
        const int c = pn * 64 + frag_col(i);
        if (c < d)
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(core.o[pn][i] / l_safe, core.o[pn][i + 1] / l_safe);
      }
  }
}

template <bool INT8, int D>
cudaError_t launch_prefill_tc(const void* q, const void* k, const void* v, const void* ks,
                              const void* vs, const void* tables, const void* lengths,
                              const void* limits, void* out, int B, int T, int n, int g, int d,
                              int bs, int max_blocks, int n_blocks, float scale,
                              cudaStream_t stream) {
  using apex_core::make_map_3d;
  const CUtensorMapDataType type =
      INT8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint64_t es = INT8 ? 1 : 2;
  const uint64_t rows = (uint64_t)n_blocks * bs;
  const uint32_t box0 = INT8 ? D : 64;
  const CUtensorMapSwizzle swz = INT8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap km, vm;
  cudaError_t err = make_map_3d(&km, type, k, d, g, rows, d * es, (uint64_t)g * d * es, box0, 1,
                                bs, swz);
  if (err == cudaSuccess)
    err = make_map_3d(&vm, type, v, d, g, rows, d * es, (uint64_t)g * d * es, box0, 1, bs, swz);
  if (err != cudaSuccess) return err;
  const size_t smem = PrefillTcSmem<INT8, D>::bytes;
  auto kernel = paged_prefill_tc_kernel<INT8, D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, g, (T * (n / g) + 63) / 64);
  kernel<<<grid, kPfThreads, smem, stream>>>(
      km, vm, static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<const int*>(limits),
      static_cast<__nv_bfloat16*>(out), T, n, g, d, bs, max_blocks, (int)rows, scale);
  return cudaGetLastError();
}


// ------------------------------------------ K1's split-context route

constexpr int kSplitThreads = 128;                 // four warps
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSpan = 128;                         // cache positions per CTA
constexpr unsigned kFull = 0xffffffffu;

// 8 storage values -> fp32: bf16 from 16 bytes (uint4), int8 from 8 (uint2).
template <typename TKV>
struct Row8;

template <>
struct Row8<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { raw = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void to_float(float (&f)[8]) const {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Row8<int8_t> {
  uint2 raw;
  __device__ __forceinline__ void load(const int8_t* p) {
    raw = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void zero() { raw = make_uint2(0, 0); }
  __device__ __forceinline__ void to_float(float (&f)[8]) const {
    const uint32_t w[2] = {raw.x, raw.y};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      f[i] = static_cast<float>(static_cast<int>(w[i / 4] << (24 - 8 * (i % 4))) >> 24);
  }
};

struct DecodeSplitArgs {
  const __nv_bfloat16* q;   // [B, n, d]
  const void* k;            // [n_blocks, bs, g, d] bf16 or int8
  const void* v;
  const float* k_scales;    // [n_blocks, bs, g] (int8 only)
  const float* v_scales;
  const int* tables;        // [B, max_blocks]
  const int* lengths;       // [B]
  float* part;              // [B, g, splits, hpg, d + 2]: acc[d], m, l
  int* tickets;             // [B * g], 0 between launches
  __nv_bfloat16* out;       // [B, n, d]
  int n, g, d, bs, max_blocks;
  float scale;
};

// One CTA per (slot, kv group, span of kSpan cache positions).  A group of
// KL lanes reads one cache row, 8 columns a lane (16-byte bf16 or 8-byte
// int8 loads), and keeps its own online softmax over the keys it reads for
// the ROWS (>= hpg) query heads of the kv group; U keys are loaded before
// any is used.  The groups merge with shuffles, the warps through shared
// memory, and the span's (m, l, acc) goes to `part`; the last CTA of the
// (slot, group) to take a ticket combines the spans.  A slot whose live
// context fits one span writes its output directly.
template <typename TKV, int KL, int ROWS>
__global__ void __launch_bounds__(kSplitThreads) paged_decode_split_kernel(
    const DecodeSplitArgs a) {
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  constexpr int kGroups = 32 / KL;                    // keys a warp reads at once
  constexpr int kAllGroups = kGroups * kSplitWarps;
  constexpr int U = ROWS <= 2 ? 8 : (ROWS <= 4 ? 4 : 2);
  constexpr int kPadD = KL * 8;
  __shared__ int blk[kSpan + 1];
  __shared__ float red_ml[kSplitWarps][ROWS][2];
  __shared__ float red_acc[kSplitWarps][ROWS][kPadD];
  __shared__ int last;

  const int b = blockIdx.x, grp = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int g = a.g, d = a.d, bs = a.bs;
  const int hpg = a.n / g;
  const int length = min(max(a.lengths[b], 0), a.max_blocks * bs);
  const int n_live = max(1, (length + kSpan - 1) / kSpan);
  if (split >= n_live) return;                        // past the live context
  const int s0 = split * kSpan;
  const int count = min(kSpan, length - s0);          // <= 0 only for length 0

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp_lane = lane % KL;
  const int c0 = grp_lane * 8;                        // this lane's 8 columns
  const bool cols_live = c0 < d;
  const int key0 = warp * kGroups + lane / KL;        // this group's first key

  // the span's live block ids (only entries below the live range are read)
  const int j0 = s0 / bs;
  const int nblk = count > 0 ? (s0 + count - 1) / bs - j0 + 1 : 0;
  for (int i = tid; i < nblk; i += kSplitThreads)
    blk[i] = a.tables[(size_t)b * a.max_blocks + j0 + i];

  float qr[ROWS][8], acc[ROWS][8], m[ROWS], l[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    Row8<__nv_bfloat16> qv;
    qv.zero();
    if (r < hpg && cols_live) qv.load(a.q + ((size_t)b * a.n + grp * hpg + r) * d + c0);
    qv.to_float(qr[r]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      qr[r][i] *= a.scale;
      acc[r][i] = 0.f;
    }
  }
  __syncthreads();

  const TKV* k_arena = static_cast<const TKV*>(a.k);
  const TKV* v_arena = static_cast<const TKV*>(a.v);
  for (int base = 0; base < count; base += U * kAllGroups) {
    Row8<TKV> kr[U], vr[U];
    float ks[U], vs[U];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = base + u * kAllGroups + key0;
      live[u] = key < count;
      kr[u].zero();
      vr[u].zero();
      ks[u] = vs[u] = 1.f;
      if (live[u]) {
        const int pos = s0 + key;
        const size_t row = ((size_t)blk[pos / bs - j0] * bs + pos % bs) * g + grp;
        if (cols_live) {
          kr[u].load(k_arena + row * d + c0);
          vr[u].load(v_arena + row * d + c0);
        }
        if (kInt8) {
          ks[u] = __ldg(a.k_scales + row);
          vs[u] = __ldg(a.v_scales + row);
        }
      }
    }
    float s[U][ROWS];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8];
      kr[u].to_float(kf);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) dot += qr[r][i] * kf[i];
        s[u][r] = dot;
      }
    }
#pragma unroll
    for (int o = KL / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < ROWS; ++r) s[u][r] += __shfl_xor_sync(kFull, s[u][r], o);
    // online softmax over the U keys, per query row (TPU kernel's guards)
    float m_safe[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][r] = live[u] ? s[u][r] * ks[u] : kNegInf;
        mx = fmaxf(mx, s[u][r]);
      }
      const float alpha = __expf(fminf(m[r] - mx, 0.f));
      m_safe[r] = mx <= kNegInf * 0.5f ? 0.f : mx;
      m[r] = mx;
      l[r] *= alpha;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[r][i] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[8];
      vr[u].to_float(vf);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = __expf(s[u][r] - m_safe[r]);
        l[r] += p;
        const float pv = p * vs[u];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[r][i] += pv * vf[i];
      }
    }
  }

  // merge the groups of a warp (lane i of every group holds the same columns)
#pragma unroll
  for (int o = KL; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float mo = __shfl_xor_sync(kFull, m[r], o);
      const float lo = __shfl_xor_sync(kFull, l[r], o);
      const float mn = fmaxf(m[r], mo);
      const float sa = __expf(m[r] - mn), sb = __expf(mo - mn);
      l[r] = l[r] * sa + lo * sb;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[r][i] = acc[r][i] * sa + __shfl_xor_sync(kFull, acc[r][i], o) * sb;
      m[r] = mn;
    }
  if (lane < KL) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (lane == 0) {
        red_ml[warp][r][0] = m[r];
        red_ml[warp][r][1] = l[r];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) red_acc[warp][r][c0 + i] = acc[r][i];
    }
  }
  __syncthreads();

  // merge the warps: this span's (m, l, acc), or the output if it is the only one
  const size_t slot_group = (size_t)b * g + grp;
  for (int e = tid; e < hpg * d; e += kSplitThreads) {
    const int r = e / d, c = e % d;
    float mx = red_ml[0][r][0];
#pragma unroll
    for (int w = 1; w < kSplitWarps; ++w) mx = fmaxf(mx, red_ml[w][r][0]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float sc = __expf(red_ml[w][r][0] - mx);
      L += red_ml[w][r][1] * sc;
      A += red_acc[w][r][c] * sc;
    }
    if (n_live == 1) {
      a.out[((size_t)b * a.n + grp * hpg + r) * d + c] = __float2bfloat16(A / (L == 0.f ? 1.f : L));
    } else {
      float* p = a.part + ((slot_group * splits + split) * hpg + r) * (d + 2);
      p[c] = A;
      if (c == 0) {
        p[d] = mx;
        p[d + 1] = L;
      }
    }
  }
  if (n_live == 1) return;

  // the last span of the (slot, group) to finish combines all of them
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(a.tickets + slot_group, 1) == n_live - 1;
    if (last) a.tickets[slot_group] = 0;               // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* parts = a.part + slot_group * splits * hpg * (d + 2);
  for (int e = tid; e < hpg * d; e += kSplitThreads) {
    const int r = e / d, c = e % d;
    float M = kNegInf, L = 0.f, A = 0.f;
    for (int j = 0; j < n_live; ++j) {
      const float* p = parts + ((size_t)j * hpg + r) * (d + 2);
      const float mj = __ldcg(p + d), lj = __ldcg(p + d + 1), aj = __ldcg(p + c);
      const float mn = fmaxf(M, mj);
      const float sa = __expf(M - mn), sb = __expf(mj - mn);
      L = L * sa + lj * sb;
      A = A * sa + aj * sb;
      M = mn;
    }
    a.out[((size_t)b * a.n + grp * hpg + r) * d + c] = __float2bfloat16(A / (L == 0.f ? 1.f : L));
  }
}

template <typename TKV, int KL, int ROWS>
cudaError_t launch_decode_split(const DecodeSplitArgs& a, int B, int splits, cudaStream_t stream) {
  paged_decode_split_kernel<TKV, KL, ROWS><<<dim3(B, a.g, splits), kSplitThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename TKV, int KL>
cudaError_t decode_split_rows(const DecodeSplitArgs& a, int B, int splits, cudaStream_t s) {
  const int hpg = a.n / a.g;
  if (hpg == 1) return launch_decode_split<TKV, KL, 1>(a, B, splits, s);
  if (hpg == 2) return launch_decode_split<TKV, KL, 2>(a, B, splits, s);
  if (hpg <= 4) return launch_decode_split<TKV, KL, 4>(a, B, splits, s);
  return launch_decode_split<TKV, KL, 8>(a, B, splits, s);
}

template <typename TKV>
cudaError_t decode_split_cols(const DecodeSplitArgs& a, int B, int splits, cudaStream_t s) {
  if (a.d <= 32) return decode_split_rows<TKV, 4>(a, B, splits, s);
  if (a.d <= 64) return decode_split_rows<TKV, 8>(a, B, splits, s);
  return decode_split_rows<TKV, 16>(a, B, splits, s);
}

int decode_splits(int context) {
  const int spans = (context + kSpan - 1) / kSpan;
  return spans > 1 ? spans : 1;
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


// K2 on the tensor cores: bf16 q over a bf16 (kv_dtype 1) or int8 (2, with
// its fp32 row scales) cache; d a multiple of 8 (bf16) or 16 (int8) up to
// 128, bs a multiple of 8 dividing 64, 16-byte-aligned q and arenas;
// anything else is refused.
extern "C" int apex_paged_prefill_tc(int kv_dtype, const void* q, const void* k, const void* v,
                                     const void* ks, const void* vs, const void* tables,
                                     const void* lengths, const void* limits, void* out, int B,
                                     int T, int n, int g, int d, int bs, int max_blocks,
                                     int n_blocks, float scale, void* stream) {
  if (B == 0 || T == 0) return (int)cudaSuccess;
  const bool int8 = kv_dtype == kI8;
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v)) %
                        16) == 0;
  if ((kv_dtype != kBF16 && !int8) || (int8 && (!ks || !vs)) || d < 8 || d > 128 ||
      d % (int8 ? 16 : 8) || bs < 8 || bs % 8 || 64 % bs || g < 1 || n % g || n_blocks < 1 ||
      !aligned)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define APEX_PF_TC(I8, D_)                                                                    \
  launch_prefill_tc<I8, D_>(q, k, v, ks, vs, tables, lengths, limits, out, B, T, n, g, d, bs, \
                            max_blocks, n_blocks, scale, s)
  if (int8) return (int)(d <= 64 ? APEX_PF_TC(true, 64) : APEX_PF_TC(true, 128));
  return (int)(d <= 64 ? APEX_PF_TC(false, 64) : APEX_PF_TC(false, 128));
#undef APEX_PF_TC
}

// K1's split route: bf16 q over a bf16 (kv_dtype 1) or int8 (2, with its
// fp32 row scales) cache; d a multiple of 8 up to 128, hpg = n / g up to 8,
// 16-byte-aligned q and arenas; `splits` from apex_paged_decode_splits of
// the table's positions (max_blocks * bs), `part` of B * n * splits *
// (d + 2) fp32 when splits > 1, `tickets` B * g zeroed ints (left zeroed);
// anything else is refused.
extern "C" int apex_paged_decode_split(int kv_dtype, const void* q, const void* k, const void* v,
                                       const void* ks, const void* vs, const void* tables,
                                       const void* lengths, void* part, void* tickets, void* out,
                                       int B, int n, int g, int d, int bs, int max_blocks,
                                       int splits, float scale, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  const bool int8 = kv_dtype == kI8;
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v)) %
                        16) == 0;
  if ((kv_dtype != kBF16 && !int8) || (int8 && (!ks || !vs)) || d < 8 || d > 128 || d % 8 ||
      g < 1 || n % g || n / g > 8 || bs < 1 || max_blocks < 0 || !tickets || !aligned ||
      splits != decode_splits(max_blocks * bs) || (splits > 1 && !part))
    return (int)cudaErrorInvalidValue;
  const DecodeSplitArgs a{static_cast<const __nv_bfloat16*>(q), k, v,
                          static_cast<const float*>(ks), static_cast<const float*>(vs),
                          static_cast<const int*>(tables), static_cast<const int*>(lengths),
                          static_cast<float*>(part), static_cast<int*>(tickets),
                          static_cast<__nv_bfloat16*>(out), n, g, d, bs, max_blocks, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(int8 ? decode_split_cols<int8_t>(a, B, splits, s)
                    : decode_split_cols<__nv_bfloat16>(a, B, splits, s));
}

// CTAs along the context of K1's split route for a table of `context`
// cache positions: one per kSpan positions, at least one.
extern "C" int apex_paged_decode_splits(int context) { return decode_splits(context); }

// Dynamic shared memory of paged_prefill_tc_kernel for a cache dtype and
// head dim d (bytes).
extern "C" int apex_paged_prefill_tc_smem(int kv_dtype, int d) {
  if (kv_dtype == kI8)
    return (int)(d <= 64 ? PrefillTcSmem<true, 64>::bytes : PrefillTcSmem<true, 128>::bytes);
  return (int)(d <= 64 ? PrefillTcSmem<false, 64>::bytes : PrefillTcSmem<false, 128>::bytes);
}
