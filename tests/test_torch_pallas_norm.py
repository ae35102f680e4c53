"""The port's row norms N1/N2 (``apex_tpu_torch.ops.pallas_norm``) against
the JAX package's Pallas kernels (interpret mode on the CPU, as
``tests/test_pallas_norm.py`` runs them), forward and backward.

On CPU tensors the port runs the kernels' plain versions, so these tests
hold the arithmetic and the autograd wiring; the CUDA kernels themselves
are held against the plain versions on the card by ``chip_smoke.py``.

Tolerances: fp32 forward atol = rtol = 1e-5 and gradients rtol 1e-4 /
atol 1e-5 (those of the JAX package's own norm tests: the same fp32
arithmetic, reductions summed in another order).  A bf16 result may sit
one bf16 step away (2**-7 of the element's magnitude, plus 1e-6 near 0),
since an fp32 value that differs in its last bits can round the other
way; the fp32 parameter gradients keep the fp32 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import pallas_norm as jax_pn
from apex_tpu_torch.ops import pallas_norm

BF16_STEP = dict(rtol=2.0 ** -7, atol=1e-6)
FP32_FWD = dict(rtol=1e-5, atol=1e-5)
FP32_GRAD = dict(rtol=1e-4, atol=1e-5)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tnp(t):
    return t.detach().float().numpy()


@pytest.fixture(autouse=True)
def _no_launch_on_the_cpu():
    before = (pallas_norm.LAYER_NORM_LAUNCHES, pallas_norm.RMS_NORM_LAUNCHES)
    yield
    assert (pallas_norm.LAYER_NORM_LAUNCHES,
            pallas_norm.RMS_NORM_LAUNCHES) == before


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    hidden = shape[-1]
    x = (2.0 * rng.standard_normal(shape) + 0.5).astype(np.float32)
    w = rng.uniform(0.5, 1.5, hidden).astype(np.float32)
    b = (0.1 * rng.standard_normal(hidden)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, w, b, g


def _run_both(kind, x, w, b, g, dtype):
    """``(y, dx, dw[, db])`` of ``sum(y * g)`` from JAX (interpret mode)
    and from the port, as numpy fp32."""
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    jx, jg = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    if kind == "ln":
        def jfn(x_, w_, b_):
            return jax_pn.pallas_layer_norm(x_, w_, b_, 1e-5, interpret=True)
        jargs = (jx, jnp.asarray(w), jnp.asarray(b))
    else:
        def jfn(x_, w_):
            return jax_pn.pallas_rms_norm(x_, w_, 1e-5, interpret=True)
        jargs = (jx, jnp.asarray(w))
    jy, vjp = jax.vjp(jfn, *jargs)
    jgrads = vjp(jg)

    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    if kind == "ln":
        ty = pallas_norm.pallas_layer_norm(tx, tw, tb, 1e-5)
        leaves = (tx, tw, tb)
    else:
        ty = pallas_norm.pallas_rms_norm(tx, tw, 1e-5)
        leaves = (tx, tw)
    ty.backward(torch.from_numpy(g).to(tdt))
    assert ty.dtype == tdt and ty.shape == tx.shape
    assert tx.grad.dtype == tdt and tw.grad.dtype == torch.float32
    want = [_np(jy)] + [_np(t) for t in jgrads]
    got = [_tnp(ty)] + [_tnp(t.grad) for t in leaves]
    return got, want


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(70, 96), (1, 128), (2, 3, 768)],
                         ids=["rows70-h96", "rows1-h128", "3d-h768"])
@pytest.mark.parametrize("kind", ["ln", "rms"])
def test_row_norm_matches_jax(kind, shape, dtype):
    x, w, b, g = _inputs(shape, seed=shape[-1] + len(shape))
    got, want = _run_both(kind, x, w, b, g, dtype)
    names = ["y", "dx", "dw", "db"]
    for name, gv, wv in zip(names, got, want):
        if dtype == "bf16" and name in ("y", "dx"):
            tol = BF16_STEP
        else:
            tol = FP32_FWD if name == "y" else FP32_GRAD
        np.testing.assert_allclose(gv, wv, err_msg=name, **tol)


@pytest.mark.parametrize("kind", ["ln", "rms"])
def test_one_dim_x_is_one_row(kind):
    x, w, b, g = _inputs((128,), seed=3)
    got, want = _run_both(kind, x, w, b, g, "fp32")
    for gv, wv in zip(got, want):
        np.testing.assert_allclose(gv, wv, **FP32_GRAD)


@pytest.mark.parametrize("kind", ["ln", "rms"])
def test_non_contiguous_x(kind):
    """A transposed view normalises the rows it shows."""
    x, w, b, _ = _inputs((6, 96), seed=4)
    tx = torch.from_numpy(np.ascontiguousarray(x.T)).t()
    assert not tx.is_contiguous()
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    if kind == "ln":
        got = pallas_norm.pallas_layer_norm(tx, tw, tb)
        want = jax_pn.pallas_layer_norm(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(b), interpret=True)
    else:
        got = pallas_norm.pallas_rms_norm(tx, tw)
        want = jax_pn.pallas_rms_norm(jnp.asarray(x), jnp.asarray(w),
                                      interpret=True)
    np.testing.assert_allclose(_tnp(got), _np(want), **FP32_FWD)


def test_parameters_of_any_float_dtype_enter_as_fp32():
    """bf16 parameters on an fp32 x: the same result as their fp32 values."""
    x, w, b, _ = _inputs((5, 96), seed=5)
    tx = torch.from_numpy(x)
    wb, bb = (torch.from_numpy(a).to(torch.bfloat16) for a in (w, b))
    got = pallas_norm.pallas_layer_norm(tx, wb, bb)
    want = jax_pn.pallas_layer_norm(jnp.asarray(x), jnp.asarray(w, jnp.bfloat16),
                                    jnp.asarray(b, jnp.bfloat16), interpret=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_tnp(got), _np(want), **FP32_FWD)
    torch.testing.assert_close(
        got, pallas_norm.layer_norm_plain(tx, wb.float(), bb.float()),
        rtol=0, atol=0)


@pytest.mark.parametrize("hidden", [1, 96, 100, 128, 768, 1000, 1024, 12288])
def test_is_available_answers_as_the_reference(hidden):
    assert pallas_norm.is_available(hidden) == jax_pn.is_available(hidden)


def test_zero_rows_give_an_empty_result():
    x = torch.zeros((0, 96))
    w, b = torch.ones(96), torch.zeros(96)
    assert pallas_norm.pallas_layer_norm(x, w, b).shape == (0, 96)
    assert pallas_norm.pallas_rms_norm(x, w).shape == (0, 96)


def test_a_device_without_a_kernel_raises():
    """No fallback: a tensor on neither the CPU nor a CUDA device finds no
    kernel and no plain version."""
    x = torch.empty((4, 96), device="meta")
    w, b = torch.empty(96, device="meta"), torch.empty(96, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pallas_norm.pallas_layer_norm(x, w, b)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pallas_norm.pallas_rms_norm(x, w)


@pytest.mark.parametrize("kind", ["ln", "rms"])
def test_backward_does_not_depend_on_the_forward(kind):
    """The Function's gradients are the same, bit for bit, whichever
    forward it is given (on the card: N1/N2 or the plain version)."""
    x, w, b, g = _inputs((9, 96), seed=6)
    grads = []
    for forward_fn in ("entry", "zeros"):
        tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
        if kind == "ln":
            fn = (pallas_norm.layer_norm_plain if forward_fn == "entry"
                  else lambda x_, w_, b_, eps: torch.zeros_like(x_))
            y = pallas_norm.LayerNormKernelFunction.apply(tx, tw, tb, 1e-5, fn)
            leaves = (tx, tw, tb)
        else:
            fn = (pallas_norm.rms_norm_plain if forward_fn == "entry"
                  else lambda x_, w_, eps: torch.zeros_like(x_))
            y = pallas_norm.RMSNormKernelFunction.apply(tx, tw, 1e-5, fn)
            leaves = (tx, tw)
        y.backward(torch.from_numpy(g))
        grads.append([t.grad for t in leaves])
    for a, c in zip(*grads):
        assert torch.equal(a, c)


# N1's arithmetic on the card (csrc/row_norm.cu, rows_norm_kernel<LN>), in
# plain torch: the launcher's shape for the row (a warp holding three or up
# to sixteen 16-byte chunks a lane, a CTA holding eight a thread, or single
# values where a row is not 16-byte aligned), each thread's sum over its
# chunks in order, the xor-shuffle tree in each warp, on the CTA path the
# warps in order; first the mean, then the centred sum of squares, both
# from the held values
def _row_shape(hidden, itemsize):
    """(values a chunk, chunks a thread, threads a row) as launched."""
    def warps_for(chunks, per_thread):       # whole warps, at least one
        threads = -(-chunks // per_thread)
        return max(32, (threads + 31) // 32 * 32)

    vec = 16 // itemsize
    if hidden % vec == 0:                 # contiguous rows start aligned
        chunks = hidden // vec
        if chunks <= 32 * 16:
            return vec, 3 if chunks <= 32 * 3 else 16, 32
        return vec, 8, warps_for(chunks, 8)
    if hidden <= 32 * 32:
        return 1, 32, 32
    return 1, 32, warps_for(hidden, 32)


def _row_sum(v, live):
    """Per thread in order, then the shuffle tree, then the warps in order:
    ``v`` [rows, chunks a thread, threads, values a chunk]."""
    rows, maxv, unit, vec = v.shape
    part = torch.zeros((rows, unit))
    for i in range(maxv):
        for j in range(vec):
            part = part + torch.where(live[i][None, :], v[:, i, :, j], 0.0)
    warps = part.reshape(rows, unit // 32, 32)
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        warps = warps + warps[..., lanes ^ o]
    total = torch.zeros(rows)
    for w in range(unit // 32):
        total = total + warps[:, w, 0]
    return total


def _rows_layer_norm(x, w, b, eps):
    rows, hidden = x.shape
    vec, maxv, unit = _row_shape(hidden, x.element_size())
    idx = ((torch.arange(maxv)[:, None] * unit + torch.arange(unit)[None, :])
           [:, :, None] * vec + torch.arange(vec))       # [maxv, unit, vec]
    live = idx[..., 0] < hidden
    v = x.float()[:, torch.where(idx < hidden, idx, 0)]
    mean = _row_sum(v, live) / hidden
    d = v - mean[:, None, None, None]
    inv = torch.rsqrt(_row_sum(d * d, live) / hidden + eps)
    y = torch.empty((rows, hidden))
    y[:, idx[live]] = (d * inv[:, None, None, None])[:, live]
    return (y * w.float() + b.float()).to(x.dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("hidden", [768, 1500, 4096])
def test_layer_norm_rows_contract_matches_jax(hidden, dtype):
    """N1's decomposition on the card (per-thread sums, the shuffle tree,
    the warps in order, the two passes over the held values), for each
    shape the launcher picks at these widths, stays within fp32 1e-6 (bf16:
    one step) of ``_ln_kernel`` in interpret mode."""
    x, w, b, _ = _inputs((6, hidden), seed=hidden)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    tx = torch.from_numpy(x).to(tdt)
    got = _rows_layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    want = jax_pn.pallas_layer_norm(jnp.asarray(tx.float().numpy(), jdt),
                                    jnp.asarray(w), jnp.asarray(b), 1e-5,
                                    interpret=True)
    tol = BF16_STEP if dtype == "bf16" else dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_tnp(got), _np(want), **tol)
