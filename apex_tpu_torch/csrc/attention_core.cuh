// The Hopper attention core shared by the tensor-core flash forward (F1)
// and backward (F2, F3) in flash_attention.cu and the tensor-core paged
// chunked prefill / k+1 verify (K2, paged_attention.cu).
//
// The forward kernels are one algorithm with two loaders: a tile of 64
// query rows per consumer warpgroup sweeps 64-key tiles of K and V with
// the online softmax.  The backward kernels sweep the same tiles with the
// same two product shapes.  This header holds what they share, written
// from raw PTX (no CuTe, no CUTLASS), so a source that includes it builds
// in seconds:
//   - mbarriers (init, arrive, arrive with an expected byte count, a
//     parity wait) and the proxy fence a generic-proxy store to shared
//     memory needs before a wgmma or TMA reads it; setmaxnreg, which
//     moves registers from a producer warpgroup to the consumers;
//   - TMA tile loads (cp.async.bulk.tensor.3d) from a CUtensorMap passed
//     as a __grid_constant__ kernel parameter, and the host-side encoder,
//     reached through cudaGetDriverEntryPoint so the library links
//     without -lcuda;
//   - wgmma descriptors for 128-byte-swizzled bf16 tiles: K-major (Q and
//     K, the head dim contiguous) and MN-major (V as the B operand of
//     P.V, read transposed through the descriptor);
//   - the two products: abt_async, s = A B^T (wgmma m64n64k16, both
//     operands K-major in shared memory: Q K^T, dO V^T and their
//     transposes), and mma_rs, acc += A B (wgmma m64n64k16 with A a fp32
//     fragment rounded to bf16 in registers and B MN-major, one product
//     per 64-column panel: P V, dS K, P^T dO, dS^T Q);
//   - TileCore: S = Q K^T, the online softmax on the fp32 accumulator
//     fragment, and O += P V.
//
// Tile layout in shared memory.  A [rows x 64] bf16 panel holds 128-byte
// rows; the 16-byte chunk c of row r sits at chunk c ^ (r % 8) (the
// SWIZZLE_128B pattern TMA writes for a box whose inner dimension is 64
// bf16), and every panel starts on a 1024-byte boundary, so 8-row groups
// are 1024 bytes apart.  A head dim of up to 128 is two panels; columns
// past the real head dim are zero (TMA's out-of-bounds fill).
//
// The accumulator fragment of wgmma m64nNk16 (fp32): thread t of the
// warpgroup (warp w = t / 32, lane l) holds d[i], i < N / 2, at
//   row 16 w + l / 4 + 8 ((i / 2) % 2),  column 8 (i / 4) + 2 (l % 4) + i % 2,
// so each thread owns two rows (a = l / 4, b = a + 8 within its warp's 16)
// and each row's 64 columns are spread over the four lanes of a quad.
// The A fragment of a k16 step is the same map over 16 columns, which is
// why S's accumulator becomes P's A operand without leaving registers.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace apex_core {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;          // query rows of one consumer warpgroup
constexpr int kKeys = 64;          // keys of one K/V tile
constexpr int kPanelBytes = 64 * 128;  // one [64 x 64] bf16 panel

// ----------------------------------------------------------- primitives

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Generic-proxy stores to shared memory become visible to the async proxy
// (wgmma operand reads, TMA) only after this fence.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Move registers between the warpgroups of a CTA: a warpgroup lowers its
// per-thread count to N (giving the rest to the CTA's pool) or raises it
// to N (waiting for the pool).  Every thread of the warpgroup runs it.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// A barrier among `threads` threads only (id 0 is __syncthreads').
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// One TMA tile load of a 3-D tensor map into shared memory; completion
// counts the box's bytes on `bar`.  Coordinates are innermost first and
// may lie out of bounds: those elements arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Byte offset of bf16 element (r, c), c < 64, in a 128-byte-swizzled panel.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// ---------------------------------------------------------------- wgmma

__device__ __forceinline__ uint64_t desc_field(uint32_t bytes) {
  return static_cast<uint64_t>((bytes & 0x3FFFF) >> 4);
}

// K-major operand (rows of 64 contiguous bf16), 128-byte swizzle: 8-row
// groups 1024 bytes apart; the leading offset is unused.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc_field(addr) | (desc_field(16) << 16) | (desc_field(1024) << 32) | (1ull << 62);
}

// MN-major operand (V as B of P.V: 64 contiguous columns of the head dim
// per key row), 128-byte swizzle: 64-column panels `panel` bytes apart,
// 8-key groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr, uint32_t panel) {
  return desc_field(addr) | (desc_field(panel) << 16) | (desc_field(1024) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of an accumulator or an A
// fragment across the asynchronous wgmma boundary.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define APEX_WG_D32                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define APEX_WG_OUT32(d)                                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (+)= A B, A and B K-major in shared memory; m64n64k16, bf16 in, fp32 out.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " APEX_WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : APEX_WG_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, A (four bf16x2 registers per thread) from registers, B
// MN-major in shared memory (transposed by the instruction).
__device__ __forceinline__ void wgmma_rs_bt(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " APEX_WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : APEX_WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef APEX_WG_D32
#undef APEX_WG_OUT32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------------------ products
//
// The two shapes every attention product here takes, as free functions so
// that the forward's TileCore and the backward kernels share them.

// Start s (+)= A B^T, m64n64 over a depth of D (D / 16 k16 steps): A [64 x
// D] and B [64 x D] both K-major in swizzled panels `a_panel` / `b_panel`
// bytes apart.  The caller fences before and commits and waits after, so
// two such products can be in flight together.
template <int D>
__device__ __forceinline__ void abt_async(float (&s)[32], uint32_t a, uint32_t a_panel, uint32_t b,
                                          uint32_t b_panel) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    wgmma_ss(s, desc_kmajor(a + (kk >> 2) * a_panel + off), desc_kmajor(b + (kk >> 2) * b_panel + off),
             kk > 0);
  }
}

// acc[q] += A B_q for each 64-column panel q of B: A [64 x 64] is a fp32
// accumulator fragment of the warpgroup, rounded to bf16 as the register
// operand (the fragment of a k16 step has the accumulator's map over 16
// columns); B [64 x 64 kPanels] lies MN-major (its 64 rows are the depth)
// in swizzled panels `b_panel` bytes apart.  Returns after the products
// land.
template <int kPanels>
__device__ __forceinline__ void mma_rs(float (&acc)[kPanels][32], const float (&a32)[32], uint32_t b,
                                       uint32_t b_panel) {
  uint32_t a[16];  // the four k16 steps' A fragments
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16(a32[2 * i], a32[2 * i + 1]);
  fence_regs(a);
#pragma unroll
  for (int q = 0; q < kPanels; ++q) fence_regs(acc[q]);
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < kPanels; ++q)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t frag[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
      wgmma_rs_bt(acc[q], frag, desc_mnmajor(b + q * b_panel + kk * 16 * 128, b_panel));
    }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int q = 0; q < kPanels; ++q) fence_regs(acc[q]);
}

// ------------------------------------------------------------- the core

// Fragment coordinates of accumulator element i of this thread: its row
// within the warpgroup's 64 and its column within the tile's 64.
__device__ __forceinline__ int frag_row(int i) {
  const int t = threadIdx.x % 128;
  return 16 * (t / 32) + (t % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x % 4) + (i & 1);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The state of one consumer warpgroup's 64 query rows over a head dim of
// D = 64 or 128 columns (D / 64 panels): O in fp32 registers, and the
// running max m and sum l of the thread's two rows.
template <int D>
struct TileCore {
  static constexpr int kPanels = D / 64;
  float o[kPanels][32];
  float m[2], l[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  // s = Q K^T: Q [64 x D] and K [64 keys x D] as swizzled panels
  // `q_panel` / `k_panel` bytes apart.  Returns after the products land.
  __device__ __forceinline__ static void scores(float (&s)[32], uint32_t q, uint32_t q_panel,
                                                uint32_t k, uint32_t k_panel) {
    wgmma_fence();
    abt_async<D>(s, q, q_panel, k, k_panel);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
  }

  // The online softmax over a masked, scaled score tile (masked entries
  // hold kNegInf), with the TPU kernels' guards: m_safe for a row that has
  // seen no key, alpha = exp(min(m - m_new, 0)).  Leaves exp(s - m_safe)
  // in s, folds its row sums into l and rescales O by alpha.  The
  // exponent is the hardware's (__expf: ex2.approx of x log2 e, a few
  // ulp): P is rounded to bf16 right after, and the exponent is what the
  // CUDA cores spend most of a tile on.
  __device__ __forceinline__ void softmax(float (&s)[32]) {
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float m_safe[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      m_safe[h] = m_new <= kNegInf * 0.5f ? 0.f : m_new;
      alpha[h] = expf(fminf(m[h] - m_new, 0.f));
      m[h] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      s[i] = __expf(s[i] - m_safe[h]);
      sum[h] += s[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(sum[h]);
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] *= alpha[(i >> 1) & 1];
  }

  // O += P V: P (the fp32 tile in s) rounded to bf16 as the A operand;
  // V [64 keys x D] as swizzled panels `v_panel` bytes apart.
  __device__ __forceinline__ void accumulate(const float (&p)[32], uint32_t v, uint32_t v_panel) {
    mma_rs<kPanels>(o, p, v, v_panel);
  }

  // 1 / l with l == 0 -> 1, so a row that saw no key gives exact zeros.
  __device__ __forceinline__ float inv_l(int h) const { return 1.f / (l[h] == 0.f ? 1.f : l[h]); }
};

// ----------------------------------------------------------------- host

// cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point (no -lcuda on the link line).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 3-D tensor map over `base` with dims {d0, d1, d2} (innermost first),
// byte strides s1, s2 of dims 1 and 2, a box of {b0, b1, b2} elements,
// out-of-bounds elements filled with zeros.
static inline cudaError_t make_map_3d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                                      uint64_t d0, uint64_t d1, uint64_t d2, uint64_t s1,
                                      uint64_t s2, uint32_t b0, uint32_t b1, uint32_t b2,
                                      CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {b0, b1, b2};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace apex_core
