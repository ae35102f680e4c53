"""The port's paged attention (K1 decode, K2 chunked prefill) against the
JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in Pallas interpret mode, as ``tests/test_serving.py`` runs
them.  Inputs come from one numpy seed and go to both sides.

Tolerance: atol = rtol = 1e-5.  Both sides compute in fp32 from the same
fp32 values (bf16 and int8 cache values are exactly representable and
dequantize identically), so they differ only in the order of the fp32
sums: the JAX kernel folds the softmax block by block, the plain version
in one pass.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.serving import paged_attention as jax_pa
from apex_tpu_torch.serving import paged_attention as pa

TOL = dict(atol=1e-5, rtol=1e-5)
BS, G, D, N_BLOCKS, MAX_BLOCKS = 4, 2, 16, 12, 4
# 0 (inactive slot), 1, a multiple of the block size, and not a multiple
LENGTHS = np.array([0, 1, 8, 11], np.int32)


def _cache(rng, cache_dtype):
    """Arenas (+ int8 scales) as (numpy fp32 values, jax arrays, torch)."""
    shape = (N_BLOCKS, BS, G, D)
    if cache_dtype == "int8":
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32)
        jx = (jnp.asarray(k), jnp.asarray(v),
              dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs)))
        th = (torch.from_numpy(k), torch.from_numpy(v),
              dict(k_scales=torch.from_numpy(ks),
                   v_scales=torch.from_numpy(vs)))
        return jx, th
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    if cache_dtype == "bf16":
        # round once so both sides hold the same bf16 values
        k = torch.from_numpy(k).bfloat16().float().numpy()
        v = torch.from_numpy(v).bfloat16().float().numpy()
        jx = (jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), {})
        th = (torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16(),
              {})
        return jx, th
    return ((jnp.asarray(k), jnp.asarray(v), {}),
            (torch.from_numpy(k), torch.from_numpy(v), {}))


def _tables(rng, lengths):
    """Distinct physical blocks for the live range of every slot, and
    in-range garbage past it (the kernels must never read it)."""
    b = len(lengths)
    tables = rng.integers(0, N_BLOCKS, (b, MAX_BLOCKS)).astype(np.int32)
    perm = rng.permutation(N_BLOCKS)
    nxt = 0
    for i, n in enumerate(lengths):
        live = -(-int(n) // BS)
        tables[i, :live] = perm[nxt:nxt + live]
        nxt += live
    return tables


def _to_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("hpg", [1, 2])
@pytest.mark.parametrize("cache_dtype", ["fp32", "bf16", "int8"])
def test_decode_matches_jax(cache_dtype, hpg):
    rng = np.random.default_rng(10 + hpg)
    (jk, jv, jsc), (tk, tv, tsc) = _cache(rng, cache_dtype)
    b, n = len(LENGTHS), G * hpg
    q = rng.standard_normal((b, n, D)).astype(np.float32)
    tables = _tables(rng, LENGTHS)
    want = jax_pa.paged_attention_decode(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(LENGTHS),
        **jsc)
    got = pa.paged_attention_decode(
        torch.from_numpy(q), tk, tv, torch.from_numpy(tables),
        torch.from_numpy(LENGTHS), **tsc)
    assert got.dtype == torch.float32 and got.shape == (b, n, D)
    np.testing.assert_allclose(got.numpy(), _to_np(want), **TOL)
    assert not got[0].any(), "a slot of length 0 must give exact zeros"
    assert pa.DECODE_LAUNCHES == 0


@pytest.mark.parametrize("hpg", [1, 2])
@pytest.mark.parametrize("cache_dtype", ["fp32", "bf16", "int8"])
def test_prefill_matches_jax(cache_dtype, hpg):
    rng = np.random.default_rng(20 + hpg)
    (jk, jv, jsc), (tk, tv, tsc) = _cache(rng, cache_dtype)
    T = 5
    b, n = len(LENGTHS), G * hpg
    q = rng.standard_normal((b, T, n, D)).astype(np.float32)
    tables = _tables(rng, LENGTHS)
    # chunks ending at each slot's length, padding rows (limit 0) after
    limits = np.zeros((b, T), np.int32)
    for i, length in enumerate(LENGTHS):
        chunk = min(int(length), T - 1 if i % 2 else T)
        limits[i, :chunk] = np.arange(length - chunk + 1, length + 1)
    want = jax_pa.paged_prefill_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(LENGTHS),
        jnp.asarray(limits), **jsc)
    got = pa.paged_prefill_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(tables),
        torch.from_numpy(LENGTHS), torch.from_numpy(limits), **tsc)
    assert got.dtype == torch.float32 and got.shape == (b, T, n, D)
    np.testing.assert_allclose(got.numpy(), _to_np(want), **TOL)
    pad = torch.from_numpy(limits == 0)
    assert not got[pad].any(), "padding rows (limit 0) must give exact zeros"
    assert pa.PREFILL_LAUNCHES == 0


def test_decode_bf16_query_keeps_its_dtype():
    """A bf16 query returns bf16 (the output takes q's dtype)."""
    rng = np.random.default_rng(3)
    _, (tk, tv, _) = _cache(rng, "bf16")
    q = torch.from_numpy(rng.standard_normal((4, G, D)).astype(np.float32))
    tables = torch.from_numpy(_tables(rng, LENGTHS))
    lengths = torch.from_numpy(LENGTHS)
    got = pa.paged_attention_decode(q.bfloat16(), tk, tv, tables, lengths)
    ref = pa.paged_attention_decode(q.bfloat16().float(), tk, tv, tables,
                                    lengths)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, ref.bfloat16(), atol=0, rtol=0)


def test_wrapper_rejects_bad_operands():
    rng = np.random.default_rng(4)
    _, (tk, tv, _) = _cache(rng, "fp32")
    tables = torch.from_numpy(_tables(rng, LENGTHS))
    lengths = torch.from_numpy(LENGTHS)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention_decode(torch.zeros(4, G, D + 1), tk, tv, tables,
                                  lengths)
    with pytest.raises(ValueError, match="multiple of kv_heads"):
        pa.paged_attention_decode(torch.zeros(4, 3, D), tk, tv, tables,
                                  lengths)
    with pytest.raises(ValueError, match="k_scales and v_scales"):
        pa.paged_attention_decode(torch.zeros(4, G, D), tk, tv, tables,
                                  lengths, k_scales=torch.ones(tk.shape[:-1]))
    with pytest.raises(ValueError, match="verify"):
        pa.paged_attention_decode(torch.zeros(4, 1, G, D), tk, tv, tables,
                                  lengths)


def test_wrappers_raise_off_the_cpu_without_a_kernel():
    """Only CPU tensors take the plain version; any other device
    launches a kernel or raises (here: no kernel for "meta")."""
    from apex_tpu_torch.serving import fused_ops

    meta = dict(device="meta")
    k = torch.empty(N_BLOCKS, BS, G, D, **meta)
    tables = torch.empty(4, MAX_BLOCKS, dtype=torch.int32, **meta)
    lengths = torch.empty(4, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="no kernel"):
        pa.paged_attention_decode(torch.empty(4, G, D, **meta), k, k, tables,
                                  lengths)
    with pytest.raises(ValueError, match="no kernel"):
        pa.paged_prefill_attention(torch.empty(4, 3, G, D, **meta), k, k,
                                   tables, lengths, torch.empty(
                                       4, 3, dtype=torch.int32, **meta))
    x = torch.empty(2, 8, **meta)
    with pytest.raises(ValueError, match="no kernel"):
        fused_ops.fused_residual_norm(x, x, torch.empty(8, **meta),
                                      torch.empty(8, **meta))
    assert (pa.DECODE_LAUNCHES, pa.PREFILL_LAUNCHES,
            fused_ops.RESIDUAL_NORM_LAUNCHES) == (0, 0, 0)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The build never falls back: no nvcc is an error."""
    from apex_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not any(tmp_path.iterdir())


def _route_operands(q_dtype, cache_dtype, d, bs=16, offset=False):
    dt = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
    q = torch.zeros((2, 5, 4, d), dtype=dt[q_dtype])
    if offset:
        q = torch.zeros(q.numel() + 8, dtype=q.dtype)[1:q.numel() + 1].view(
            q.shape)
    k, v = (torch.zeros((6, bs, 2, d), dtype=dt[cache_dtype])
            for _ in range(2))
    return q, k, v


# (q dtype, cache dtype, head dim, block size, layout) -> K2's route
PREFILL_ROUTES = [
    ("bf16", "bf16", 24, 16, "aligned", "tc"),
    ("bf16", "bf16", 64, 16, "aligned", "tc"),
    ("bf16", "bf16", 80, 16, "aligned", "tc"),
    ("bf16", "bf16", 128, 16, "aligned", "tc"),
    ("bf16", "int8", 64, 16, "aligned", "tc"),
    ("bf16", "int8", 128, 8, "aligned", "tc"),
    ("bf16", "bf16", 64, 64, "aligned", "tc"),
    ("fp32", "fp32", 64, 16, "aligned", "simt"),
    ("fp32", "bf16", 64, 16, "aligned", "simt"),
    ("fp32", "int8", 64, 16, "aligned", "simt"),
    ("bf16", "bf16", 20, 16, "aligned", "simt"),
    ("bf16", "fp32", 64, 16, "aligned", "simt"),
    ("bf16", "int8", 24, 16, "aligned", "simt"),
    ("bf16", "bf16", 64, 4, "aligned", "simt"),
    ("bf16", "bf16", 64, 24, "aligned", "simt"),
    ("bf16", "bf16", 136, 16, "aligned", "simt"),
    ("bf16", "bf16", 64, 16, "offset", "simt"),
]


@pytest.mark.parametrize("q_dtype, cache_dtype, d, bs, layout, route",
                         PREFILL_ROUTES)
def test_prefill_route(q_dtype, cache_dtype, d, bs, layout, route):
    """bf16 q over a bf16 or int8 cache takes the tensor-core kernel when
    TMA can load its pages (rows a multiple of 16 bytes, 16-byte-aligned
    storage) and a block size divides the 64-key tile in multiples of 8;
    fp32 (exact fp32) and every other shape take the CUDA-core one."""
    q, k, v = _route_operands(q_dtype, cache_dtype, d, bs,
                              offset=layout == "offset")
    assert pa.prefill_route(q, k, v) == route
    assert (pa.PREFILL_LAUNCHES, pa.PREFILL_TC_LAUNCHES,
            pa.PREFILL_SIMT_LAUNCHES) == (0, 0, 0)


# the tensor-core route's arithmetic (csrc/paged_attention.cu,
# paged_prefill_tc_kernel), in plain torch: 64-key tiles with the online
# softmax, raw cache values (int8 unscaled) against bf16 q, the K row
# scale on the score column, P * v_scale rounded to bf16 before P.V, fp32
# accumulation, l summing the unscaled P
TC_TILE = 64


def _tc_rounding(q, k_arena, v_arena, tables, lengths, limits, k_scales,
                 v_scales, scale):
    b, T, n, d = q.shape
    _, bs, g, _ = k_arena.shape
    hpg = n // g
    idx = tables.long()
    k = k_arena[idx].float().reshape(b, -1, g, d).repeat_interleave(hpg, 2)
    v = v_arena[idx].float().reshape(b, -1, g, d).repeat_interleave(hpg, 2)
    s_len = k.shape[1]
    ks = vs = torch.ones((b, s_len, n))
    if k_scales is not None:
        ks = k_scales[idx].reshape(b, -1, g).repeat_interleave(hpg, 2)
        vs = v_scales[idx].reshape(b, -1, g).repeat_interleave(hpg, 2)
    qf = q.bfloat16().float()
    m = torch.full((b, T, n), NEG)
    l = torch.zeros((b, T, n))
    acc = torch.zeros((b, T, n, d))
    for j0 in range(0, s_len, TC_TILE):
        j1 = min(j0 + TC_TILE, s_len)
        s = torch.einsum("btnd,bsnd->btns", qf, k[:, j0:j1])
        s = s * (scale * ks[:, j0:j1].permute(0, 2, 1)[:, None])
        cols = torch.arange(j0, j1)
        s = torch.where(cols < limits.long()[:, :, None, None], s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(m_new <= NEG * 0.5, 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        alpha = torch.exp(torch.clamp(m - m_new, max=0.0))
        l = l * alpha + p.sum(-1)
        p = (p * vs[:, j0:j1].permute(0, 2, 1)[:, None]).bfloat16().float()
        acc = acc * alpha[..., None] + torch.einsum("btns,bsnd->btnd", p,
                                                     v[:, j0:j1])
        m = m_new
    return (acc / torch.where(l == 0.0, 1.0, l)[..., None]).bfloat16()


NEG = -1e30


@pytest.mark.parametrize("hpg", [1, 2])
@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_tc_rounding_contract_matches_jax(cache_dtype, hpg):
    """The tensor-core route's rounding (bf16 P, scales folded into the
    score column and into P) stays within the card's 2e-2 of the JAX
    kernel (Pallas in interpret mode, fp32 P), on a verify-style batch:
    ragged draft counts, padding rows of limit 0, two 64-key tiles."""
    rng = np.random.default_rng(40 + hpg)
    bs, g, d, n_blocks, max_blocks = 16, 2, 16, 24, 6
    shape = (n_blocks, bs, g, d)
    if cache_dtype == "int8":
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32)
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        jsc = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
        tks, tvs = torch.from_numpy(ks), torch.from_numpy(vs)
    else:
        k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        tk, tv = k.bfloat16(), v.bfloat16()
        jk = jnp.asarray(tk.float().numpy(), jnp.bfloat16)
        jv = jnp.asarray(tv.float().numpy(), jnp.bfloat16)
        jsc, tks, tvs = {}, None, None
    lengths = np.array([0, 9, 70, 96], np.int32)
    b, T, n = len(lengths), 5, g * hpg
    tables = np.stack([rng.permutation(n_blocks)[:max_blocks]
                       for _ in range(b)]).astype(np.int32)
    limits = np.zeros((b, T), np.int32)
    for i, length in enumerate(lengths):
        if length:
            w = min(i + 1, T, int(length))      # drafts 0..3 plus one
            limits[i, :w] = np.arange(length - w + 1, length + 1)
    q = torch.from_numpy(rng.standard_normal((b, T, n, d)).astype(
        np.float32)).bfloat16()
    want = jax_pa.paged_prefill_attention(
        jnp.asarray(q.float().numpy(), jnp.bfloat16), jk, jv,
        jnp.asarray(tables), jnp.asarray(lengths), jnp.asarray(limits), **jsc)
    got = _tc_rounding(q, tk, tv, torch.from_numpy(tables),
                       torch.from_numpy(lengths), torch.from_numpy(limits),
                       tks, tvs, 1.0 / d ** 0.5)
    np.testing.assert_allclose(got.float().numpy(), _to_np(want), atol=2e-2,
                               rtol=2e-2)
    pad = torch.from_numpy(limits == 0)
    assert int(pad.sum()) > b and not got[pad].any()
    # the contract is not the plain version's: P is rounded (the check
    # would hold a kernel that kept fp32 P to nothing)
    plain = pa.paged_prefill_attention_plain(
        q, tk, tv, torch.from_numpy(tables), torch.from_numpy(lengths),
        torch.from_numpy(limits),
        **({} if tks is None else dict(k_scales=tks, v_scales=tvs)))
    assert not torch.equal(got, plain)


def _decode_route_operands(q_dtype, cache_dtype, d, hpg, offset=False):
    dt = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
    g = 2
    q = torch.zeros((3, g * hpg, d), dtype=dt[q_dtype])
    if offset:
        q = torch.zeros(q.numel() + 8, dtype=q.dtype)[1:q.numel() + 1].view(
            q.shape)
    k, v = (torch.zeros((6, 16, g, d), dtype=dt[cache_dtype])
            for _ in range(2))
    return q, k, v


# (q dtype, cache dtype, head dim, heads per KV group, layout) -> K1's route
DECODE_ROUTES = [
    ("bf16", "bf16", 64, 1, "aligned", "split"),
    ("bf16", "bf16", 128, 1, "aligned", "split"),
    ("bf16", "int8", 64, 1, "aligned", "split"),
    ("bf16", "int8", 128, 2, "aligned", "split"),
    ("bf16", "bf16", 8, 1, "aligned", "split"),
    ("bf16", "bf16", 24, 4, "aligned", "split"),
    ("bf16", "bf16", 80, 2, "aligned", "split"),
    ("bf16", "bf16", 64, 3, "aligned", "split"),
    ("bf16", "int8", 64, 8, "aligned", "split"),
    ("bf16", "bf16", 64, 16, "aligned", "simt"),
    ("fp32", "fp32", 64, 1, "aligned", "simt"),
    ("fp32", "bf16", 64, 1, "aligned", "simt"),
    ("fp32", "int8", 64, 2, "aligned", "simt"),
    ("bf16", "fp32", 64, 1, "aligned", "simt"),
    ("bf16", "bf16", 136, 1, "aligned", "simt"),
    ("bf16", "bf16", 20, 1, "aligned", "simt"),
    ("bf16", "bf16", 64, 1, "offset", "simt"),
]


@pytest.mark.parametrize("q_dtype, cache_dtype, d, hpg, layout, route",
                         DECODE_ROUTES)
def test_decode_route(q_dtype, cache_dtype, d, hpg, layout, route):
    """bf16 q over a bf16 or int8 cache takes the split-context kernel for
    a head dim that is a multiple of 8 up to 128, at most 8 query heads
    per KV head and 16-byte-aligned storage; fp32 and every other shape
    take the first kernel."""
    q, k, v = _decode_route_operands(q_dtype, cache_dtype, d, hpg,
                                     offset=layout == "offset")
    assert pa.decode_route(q, k, v) == route
    assert (pa.DECODE_LAUNCHES, pa.DECODE_SPLIT_LAUNCHES,
            pa.DECODE_SIMT_LAUNCHES) == (0, 0, 0)


# the split route's arithmetic (csrc/paged_attention.cu,
# paged_decode_split_kernel), in plain torch: spans of 128 cache positions,
# each with its own fp32 (m, l, acc) over the positions below the length,
# int8 scales folded into the score and into P (fp32 P), the spans
# combined by their maxima; a length of 0 is one empty span
SPLIT_SPAN = 128


def _split_decode(q, k_arena, v_arena, tables, lengths, k_scales, v_scales,
                  scale):
    b, n, d = q.shape
    _, bs, g, _ = k_arena.shape
    hpg = n // g
    idx = tables.long()
    k = k_arena[idx].float().reshape(b, -1, g, d).repeat_interleave(hpg, 2)
    v = v_arena[idx].float().reshape(b, -1, g, d).repeat_interleave(hpg, 2)
    positions = k.shape[1]
    ks = vs = torch.ones((b, positions, n))
    if k_scales is not None:
        ks = k_scales[idx].reshape(b, -1, g).repeat_interleave(hpg, 2)
        vs = v_scales[idx].reshape(b, -1, g).repeat_interleave(hpg, 2)
    qf = q.float() * scale
    out = torch.zeros((b, n, d))
    for i in range(b):
        length = min(int(lengths[i]), positions)
        spans = []
        for s0 in range(0, max(length, 1), SPLIT_SPAN):
            s1 = min(s0 + SPLIT_SPAN, length)
            s = torch.einsum("nd,snd->ns", qf[i], k[i, s0:s1]) * ks[i, s0:s1].T
            m = s.amax(-1) if s1 > s0 else torch.full((n,), NEG)
            p = torch.exp(s - m[:, None])
            spans.append((m, p.sum(-1), torch.einsum(
                "ns,snd->nd", p * vs[i, s0:s1].T, v[i, s0:s1])))
        m_all = torch.stack([m for m, _, _ in spans]).amax(0)
        l_all = sum(l * torch.exp(m - m_all) for m, l, _ in spans)
        acc = sum(a * torch.exp(m - m_all)[:, None] for m, _, a in spans)
        out[i] = acc / torch.where(l_all == 0.0, 1.0, l_all)[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("hpg", [1, 3])
@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_split_decode_contract_matches_jax(cache_dtype, hpg):
    """The split route's decomposition (128-position spans combined by
    their maxima, fp32 P) stays within the card's 2e-2 of the JAX kernel
    (Pallas in interpret mode) for lengths of 0, 1, at, below and above a
    span boundary and the whole table; a length of 0 gives exact zeros."""
    rng = np.random.default_rng(50 + hpg)
    bs, g, d, n_blocks, max_blocks = 16, 2, 16, 160, 24
    shape = (n_blocks, bs, g, d)
    if cache_dtype == "int8":
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32)
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        jsc = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
        tks, tvs = torch.from_numpy(ks), torch.from_numpy(vs)
    else:
        k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        tk, tv = k.bfloat16(), v.bfloat16()
        jk = jnp.asarray(tk.float().numpy(), jnp.bfloat16)
        jv = jnp.asarray(tv.float().numpy(), jnp.bfloat16)
        jsc, tks, tvs = {}, None, None
    lengths = np.array([0, 1, 128, 127, 129, 300, 384], np.int32)
    b, n = len(lengths), g * hpg
    tables = np.stack([rng.permutation(n_blocks)[:max_blocks]
                       for _ in range(b)]).astype(np.int32)
    q = torch.from_numpy(rng.standard_normal((b, n, d)).astype(
        np.float32)).bfloat16()
    want = jax_pa.paged_attention_decode(
        jnp.asarray(q.float().numpy(), jnp.bfloat16), jk, jv,
        jnp.asarray(tables), jnp.asarray(lengths), **jsc)
    got = _split_decode(q, tk, tv, torch.from_numpy(tables),
                        torch.from_numpy(lengths), tks, tvs, 1.0 / d ** 0.5)
    np.testing.assert_allclose(got.float().numpy(), _to_np(want), atol=2e-2,
                               rtol=2e-2)
    assert not got[0].any(), "a slot of length 0 must give exact zeros"
    plain = pa.paged_attention_decode(
        q, tk, tv, torch.from_numpy(tables), torch.from_numpy(lengths),
        **({} if tks is None else dict(k_scales=tks, v_scales=tvs)))
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               atol=2e-2, rtol=2e-2)
