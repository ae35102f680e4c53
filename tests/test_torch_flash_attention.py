"""The port's flash attention (F1-F3) against the JAX package's Pallas
kernels.

The JAX side runs as its own tests run it on the CPU: the Pallas kernels
in interpret mode.  The port runs on CPU tensors, where each kernel
wrapper takes its plain version, through the autograd Function.  Inputs
come from numpy seeds and go to both sides.  Tolerances follow the JAX
package's flash tests: 2e-5 on the forward, 2e-4 on the gradients in
fp32.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# the modules (each ops package re-exports a function under the same name)
fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
jax_fa = importlib.import_module("apex_tpu.ops.flash_attention")

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal(s).astype(np.float32)
                  for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d),
                            (b, h, sq, d)))
    return q, k, v, w


def _both(q, k, v, w, dtype=torch.float32, **kw):
    """(out, lse, dq, dk, dv) of the JAX kernels and of the port, for the
    cotangent ``w`` of ``out``."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jkw = dict(kw)
    tkw = dict(kw)
    for name in ("segment_ids_q", "segment_ids_kv"):
        if kw.get(name) is not None:
            jkw[name] = jnp.asarray(kw[name])
            tkw[name] = torch.from_numpy(kw[name])

    def jfn(q, k, v):
        return jax_fa.flash_attention_with_lse(q, k, v, **jkw)

    (jout, jlse), vjp = jax.vjp(jfn, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    jgrads = vjp((jnp.asarray(w, jdt), jnp.zeros_like(jlse)))

    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_()
                  for x in (q, k, v))
    out, lse = fa.flash_attention_with_lse(tq, tk, tv, **tkw)
    out.backward(torch.from_numpy(w).to(dtype))
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert tq.grad.dtype == dtype
    want = [_np(x) for x in (jout, jlse, *jgrads)]
    got = [t.detach().float().numpy()
           for t in (out, lse, tq.grad, tk.grad, tv.grad)]
    return want, got


def _check(want, got, fwd=FWD_TOL, grad=GRAD_TOL):
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g, w, **(fwd if i < 2 else grad),
                                   err_msg=["out", "lse", "dq", "dk", "dv"][i])


@pytest.mark.parametrize("causal,sq,sk", [
    (False, 37, 37), (True, 130, 130), (True, 37, 130), (False, 130, 37)])
def test_matches_jax(causal, sq, sk):
    """Causal and not, lengths that are not block multiples, sq != sk."""
    q, k, v, w = _inputs(0, 1, 2, sq, sk, 16)
    _check(*_both(q, k, v, w, causal=causal))


def test_segment_ids():
    """Packed segments, with a q segment that has no key (its rows are
    fully masked)."""
    q, k, v, w = _inputs(1, 2, 2, 40, 40, 16)
    seg = np.zeros((2, 40), np.int32)
    seg[0, 15:] = 1
    seg[1, 10:30] = 2
    seg[1, 30:] = 3
    seg_q = seg.copy()
    seg_q[1, 35:] = 7                 # no key carries segment 7
    want, got = _both(q, k, v, w, causal=True, segment_ids_q=seg_q,
                      segment_ids_kv=seg)
    _check(want, got)
    assert not got[0][1, :, 35:].any()
    assert (got[1][1, :, 35:] == fa.NEG_INF).all()


def test_offsets_and_fully_masked_rows():
    """Global causal coordinates: with kv_offset past q_offset the first
    rows see no key: output 0, lse -1e30, zero gradients."""
    q, k, v, w = _inputs(2, 1, 2, 37, 70, 16)
    want, got = _both(q, k, v, w, causal=True, q_offset=3, kv_offset=20)
    _check(want, got)
    assert not got[0][:, :, :17].any()
    assert (got[1][:, :, :17] == fa.NEG_INF).all()
    assert not got[2][:, :, :17].any()
    want, got = _both(q, k, v, w, causal=True, q_offset=64, kv_offset=0)
    _check(want, got)


def test_chunk_entry_points_match_jax():
    """dq_chunk / dkv_chunk with a given (lse, delta), as ring attention
    re-drives them per visiting chunk."""
    q, k, v, do = _inputs(3, 1, 2, 37, 50, 16)
    rng = np.random.default_rng(4)
    lse = rng.standard_normal((1, 2, 37)).astype(np.float32) + 3.0
    lse[0, 0, :4] = fa.NEG_INF
    delta = rng.standard_normal((1, 2, 37)).astype(np.float32)
    kw = dict(causal=True, q_offset=50, kv_offset=30)
    args = (q, k, v, do, lse, delta)
    jdq = jax_fa.dq_chunk(*map(jnp.asarray, args), **kw)
    jdk, jdv = jax_fa.dkv_chunk(*map(jnp.asarray, args), **kw)
    targs = [torch.from_numpy(x) for x in args]
    dq = fa.dq_chunk(*targs, **kw)
    dk, dv = fa.dkv_chunk(*targs, **kw)
    for g, w in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(g.numpy(), _np(w), **GRAD_TOL)


def test_dropout_keep_mask_is_bit_identical():
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 1 << 20, (64, 1)).astype(np.int32)
    cols = rng.integers(0, 1 << 20, (1, 64)).astype(np.int32)
    for seed, bh, rate in ((0, 0, 0.1), (-123456789, 7, 0.5),
                           (2 ** 31 - 1, 95, 0.9)):
        want = np.asarray(jax_fa._keep_mask(
            jnp.asarray(seed, jnp.int32), bh, jnp.asarray(rows),
            jnp.asarray(cols), rate))
        got = fa.keep_mask(torch.tensor(seed, dtype=torch.int32),
                           torch.tensor(bh), torch.from_numpy(rows),
                           torch.from_numpy(cols), rate).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0.0 < got.mean() < 1.0


def test_dropout_matches_jax():
    """Same seed, same dropped entries: out and all grads agree."""
    q, k, v, w = _inputs(6, 2, 2, 40, 40, 16)
    _check(*_both(q, k, v, w, causal=True, dropout_rate=0.3,
                  dropout_seed=1234))
    with pytest.raises(ValueError, match="dropout_seed"):
        fa.flash_attention(torch.zeros(1, 1, 4, 8), torch.zeros(1, 1, 4, 8),
                           torch.zeros(1, 1, 4, 8), dropout_rate=0.1)


def test_bf16_matches_jax():
    """bf16 inputs: both sides round P, dS and the outputs to bf16 at the
    same points, so they differ by a few bf16 steps (2**-8 relative) of
    values of order 1, not by the fp32 noise: atol/rtol 2e-2 on out and
    the gradients, 1e-3 on the fp32 lse (computed from bf16 q, k)."""
    q, k, v, w = _inputs(7, 1, 2, 130, 130, 16)
    want, got = _both(q, k, v, w, dtype=torch.bfloat16, causal=True)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3, atol=1e-3)
    for i in (0, 2, 3, 4):
        np.testing.assert_allclose(got[i], want[i], rtol=2e-2, atol=2e-2)


def test_mismatched_shapes_raise_before_any_kernel():
    """The shape checks run on every device, ahead of the pointers the
    kernels would be handed."""
    x = torch.zeros(1, 2, 8, 16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="alike"):
        fa.flash_attention(x, x, torch.zeros(1, 2, 9, 16))
    with pytest.raises(ValueError, match="segment_ids_kv"):
        fa.flash_attention(x, x, x, segment_ids_kv=torch.zeros(1, 7))
    with pytest.raises(ValueError, match="lse and delta"):
        fa.dq_chunk(x, x, x, x, lse[..., :4], lse, causal=True)
    with pytest.raises(ValueError, match="lse and delta"):
        fa.dkv_chunk(x, x, x, x[:, :, :4], lse, lse, causal=True)


def test_wrappers_raise_off_the_cpu_without_a_kernel():
    """Only CPU tensors take the plain versions; any other device launches
    a kernel or raises (here: no kernel for "meta")."""
    x = torch.empty(1, 2, 8, 16, device="meta")
    lse = torch.empty(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="no kernel"):
        fa.dq_chunk(x, x, x, x, lse, lse, causal=True)
    with pytest.raises(ValueError, match="no kernel"):
        fa.dkv_chunk(x, x, x, x, lse, lse, causal=True)
    assert (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES) == (0, 0, 0)


def _unaligned(shape, dtype):
    """A tensor of ``shape`` whose storage starts 2 bytes off a 16-byte
    boundary (a view with an offset)."""
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=dtype)[1:n + 1].view(shape)


# (q dtype, head dim, keys, layout) -> the F1 route a CUDA call takes
FWD_ROUTES = [
    ("bf16", 24, 70, "aligned", "tc"),
    ("bf16", 64, 1024, "aligned", "tc"),
    ("bf16", 80, 130, "aligned", "tc"),
    ("bf16", 128, 200, "aligned", "tc"),
    ("fp32", 64, 1024, "aligned", "simt"),
    ("fp32", 128, 200, "aligned", "simt"),
    ("bf16", 20, 70, "aligned", "simt"),
    ("bf16", 136, 70, "aligned", "simt"),
    ("bf16", 64, 0, "aligned", "simt"),
    ("bf16", 64, 70, "offset", "simt"),
]


@pytest.mark.parametrize("dtype, d, sk, layout, route", FWD_ROUTES)
def test_fwd_route(dtype, d, sk, layout, route):
    """bf16 with a head dim that is a multiple of 8 up to 128 (TMA's
    16-byte row rule) takes the tensor-core kernel; fp32 (exact fp32),
    other head dims, no keys and storage off a 16-byte boundary take the
    CUDA-core one."""
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    make = _unaligned if layout == "offset" else (
        lambda shape, dtype: torch.zeros(shape, dtype=dtype))
    q = make((1, 2, 37, d), dt)
    k, v = (make((1, 2, sk, d), dt) for _ in range(2))
    assert fa.fwd_route(q, k, v) == route
    # the route is the operands' property: the CPU path ignores it
    if sk:
        out, _ = fa.flash_attention_with_lse(q.float(), k.float(), v.float())
        assert out.shape == q.shape
    assert (fa.FWD_LAUNCHES, fa.FWD_TC_LAUNCHES, fa.FWD_SIMT_LAUNCHES) == (
        0, 0, 0)


# (operands' dtype, head dim, keys, layout) -> the F2/F3 route a CUDA call
# takes
BWD_ROUTES = [
    ("bf16", 24, 70, "aligned", "tc"),
    ("bf16", 64, 1024, "aligned", "tc"),
    ("bf16", 80, 130, "aligned", "tc"),
    ("bf16", 128, 200, "aligned", "tc"),
    ("fp32", 64, 1024, "aligned", "simt"),
    ("bf16", 20, 70, "aligned", "simt"),
    ("bf16", 136, 70, "aligned", "simt"),
    ("bf16", 64, 0, "aligned", "simt"),
    ("bf16", 64, 70, "offset", "simt"),
    ("bf16", 64, 70, "offset do", "simt"),
]


@pytest.mark.parametrize("dtype, d, sk, layout, route", BWD_ROUTES)
def test_bwd_route(dtype, d, sk, layout, route):
    """F2 and F3 take the tensor-core kernels by F1's rule over q, k, v
    and do: bf16, a head dim that is a multiple of 8 up to 128, at least
    one key, 16-byte-aligned storage; anything else the CUDA-core ones.
    On the CPU the route is ignored and no launch is counted."""
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32

    def make(shape, offset):
        if not offset:
            return torch.zeros(shape, dtype=dt)
        return _unaligned(shape, dt)

    q = make((1, 2, 37, d), layout == "offset")
    k, v = (make((1, 2, sk, d), layout == "offset") for _ in range(2))
    do = make((1, 2, 37, d), layout.startswith("offset"))
    assert fa.bwd_route(q, k, v, do) == route
    if sk:
        args = [t.float() for t in (q, k, v, do)]
        lse = torch.zeros(1, 2, 37)
        kw = dict(causal=True, scale=None, q_offset=0, kv_offset=0,
                  dropout_rate=0.0)
        for r in ("tc", "simt"):
            dq = fa._dq(*args, lse, lse, None, None, None, route=r, **kw)
            dk, dv = fa._dkv(*args, lse, lse, None, None, None, route=r,
                             **kw)
            assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert (fa.DQ_LAUNCHES, fa.DQ_TC_LAUNCHES, fa.DQ_SIMT_LAUNCHES,
            fa.DKV_LAUNCHES, fa.DKV_TC_LAUNCHES,
            fa.DKV_SIMT_LAUNCHES) == (0,) * 6


@pytest.mark.parametrize("entry, blocks", [
    ("flash_attention_with_lse", (128, 256)),
    ("flash_attention", (128, 128)),
])
def test_positional_block_sizes_match_jax(entry, blocks):
    """``block_q`` and ``block_k`` sit where the JAX package puts them, so
    a JAX-style positional call binds them as block sizes, not as the
    causal offsets; the port validates them and tiles its own way."""
    q, k, v, w = _inputs(8, 1, 1, 256, 256, 64)

    def jfn(q, k, v):
        out = getattr(jax_fa, entry)(q, k, v, True, None, *blocks)
        return out[0] if isinstance(out, tuple) else out

    jout, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(w))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = getattr(fa, entry)(tq, tk, tv, True, None, *blocks)
    out = out[0] if isinstance(out, tuple) else out
    out.backward(torch.from_numpy(w))
    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.detach().numpy(), _np(jout), **tol)
    for name, g, jg in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(g.numpy(), _np(jg), err_msg=f"d{name}",
                                   **tol)
    for bad in (0, -64, 2.5, True):
        with pytest.raises(ValueError, match="block_"):
            getattr(fa, entry)(tq, tk, tv, True, None, blocks[0], bad)
    with pytest.raises(ValueError, match="block_q"):
        fa.dq_chunk(tq, tk, tv, tq, tq[..., 0], tq[..., 0], causal=True,
                    block_q=0)
