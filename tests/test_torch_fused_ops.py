"""The port's fused residual/LayerNorm epilogue (K3) and its unfused twin
against the JAX package's (the Pallas kernel in interpret mode on the
CPU), and the port's LayerNorm against the JAX ``FusedLayerNorm`` forward.

Tolerance: the normed rows agree to atol = rtol = 1e-5 in fp32 (the same
fp32 arithmetic, with reductions summed in another order); in bf16 to
one bf16 rounding step (atol = rtol = 1e-2) and in fp16 to one fp16 step
(atol = rtol = 1e-3), since a last-bit difference in fp32 can round the
other way.  The new residual is exact: it is a sum of the same values in
the same order, rounded once to the same type.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.normalization.fused_layer_norm import (
    fused_layer_norm_affine as jax_layer_norm,
)
from apex_tpu.serving.fused_ops import fused_residual_norm as jax_frn
from apex_tpu.serving.fused_ops import residual_norm_unfused as jax_unfused
from apex_tpu_torch.normalization.fused_layer_norm import (
    fused_layer_norm_affine,
)
from apex_tpu_torch.serving import fused_ops
from torch_threads import one_torch_thread  # noqa: F401

HIDDEN = 96
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "fp16": (jnp.float16, torch.float16)}
TOL = {"fp32": dict(atol=1e-5, rtol=1e-5), "bf16": dict(atol=1e-2, rtol=1e-2),
       "fp16": dict(atol=1e-3, rtol=1e-3)}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _operands(rows, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, HIDDEN)).astype(np.float32)
    res = (3.0 * rng.standard_normal((rows, HIDDEN))).astype(np.float32)
    w = rng.uniform(0.5, 1.5, HIDDEN).astype(np.float32)
    beta = (0.1 * rng.standard_normal(HIDDEN)).astype(np.float32)
    bias = rng.standard_normal(HIDDEN).astype(np.float32)
    return x, res, w, beta, bias


def _both(arrays, dtypes):
    """Each numpy array as (jax, torch) in its dtype name."""
    return ([jnp.asarray(a, DTYPES[d][0]) for a, d in zip(arrays, dtypes)],
            [torch.from_numpy(a).to(DTYPES[d][1]) for a, d in zip(arrays, dtypes)])


# x in fp32/bf16/fp16, the residual fp32 or bf16, w and b fp32 or x's dtype
# (the same for an fp32 x), with and without the skip bias
_CASES = [(x, r, w, bias) for x, r, w, bias in itertools.product(
    ["fp32", "bf16", "fp16"], ["fp32", "bf16"], ["fp32", "x"], [False, True])
    if not (x == "fp32" and w == "x")]


@pytest.mark.parametrize("x_dtype,r_dtype,w_dtype,with_bias", _CASES)
def test_fused_residual_norm_matches_jax(x_dtype, r_dtype, w_dtype,
                                         with_bias):
    w_dtype = x_dtype if w_dtype == "x" else w_dtype
    x, res, w, beta, bias = _operands(12)
    x, res = x.reshape(3, 4, HIDDEN), res.reshape(3, 4, HIDDEN)
    (xj, rj, wj, bj, cj), (xt, rt, wt, bt, ct) = _both(
        (x, res, w, beta, bias), (x_dtype, r_dtype, w_dtype, w_dtype, x_dtype))
    kw_j = dict(bias=cj) if with_bias else {}
    kw_t = dict(bias=ct) if with_bias else {}
    y_j, r_j = jax_frn(xj, rj, wj, bj, **kw_j)
    y_t, r_t = fused_ops.fused_residual_norm(xt, rt, wt, bt, **kw_t)
    assert y_t.dtype == DTYPES[x_dtype][1] and r_t.dtype == DTYPES[r_dtype][1]
    assert y_t.shape == r_t.shape == (3, 4, HIDDEN)
    np.testing.assert_allclose(y_t.float().numpy(), _np(y_j), **TOL[x_dtype])
    np.testing.assert_array_equal(r_t.float().numpy(), _np(r_j))
    assert fused_ops.RESIDUAL_NORM_LAUNCHES == 0


@pytest.mark.parametrize("block_rows", [5, 256])
def test_block_rows_is_accepted_and_changes_nothing(block_rows):
    """The reference's row tile: 12 rows in tiles of 5 (the last ragged)
    or one tile give the same result on both sides."""
    x, res, w, beta, bias = _operands(12, seed=8)
    (xj, rj, wj, bj, cj), (xt, rt, wt, bt, ct) = _both(
        (x, res, w, beta, bias), ("bf16", "fp32", "fp32", "fp32", "bf16"))
    y_j, r_j = jax_frn(xj, rj, wj, bj, bias=cj, block_rows=block_rows)
    y_t, r_t = fused_ops.fused_residual_norm(xt, rt, wt, bt, bias=ct,
                                             block_rows=block_rows)
    y_d, r_d = fused_ops.fused_residual_norm(xt, rt, wt, bt, bias=ct)
    np.testing.assert_allclose(y_t.float().numpy(), _np(y_j), **TOL["bf16"])
    np.testing.assert_array_equal(r_t.numpy(), _np(r_j))
    assert torch.equal(y_t, y_d) and torch.equal(r_t, r_d)


@pytest.mark.parametrize("block_rows", [0, -3, 2.0, True, None])
def test_block_rows_must_be_a_positive_int(block_rows):
    x = torch.zeros(2, HIDDEN)
    w = torch.ones(HIDDEN)
    with pytest.raises(ValueError, match="block_rows"):
        fused_ops.fused_residual_norm(x, x, w, w, block_rows=block_rows)


def test_operand_dtypes_outside_the_reference_rules_raise():
    """What the kernel does not take raises on every device: an int x, a
    weight in a third float type, a skip bias not in x's dtype."""
    x = torch.zeros(2, HIDDEN, dtype=torch.bfloat16)
    w = torch.ones(HIDDEN)
    with pytest.raises(TypeError, match="x and residual"):
        fused_ops.fused_residual_norm(x.int(), x, w, w)
    with pytest.raises(TypeError, match="weight"):
        fused_ops.fused_residual_norm(x, x, w.half(), w)
    with pytest.raises(TypeError, match="bias"):
        fused_ops.fused_residual_norm(x, x, w, w, bias=w)
    with pytest.raises(ValueError, match="differ"):
        fused_ops.fused_residual_norm(x, x[:1], w, w)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_residual_norm_unfused_matches_jax(dtype, with_bias):
    """The reference's separate-ops lowering, rounding where it rounds:
    the bias added in x's dtype, the residual with the type promotion."""
    x, res, w, beta, bias = _operands(6, seed=9)
    (xj, rj, wj, bj, cj), (xt, rt, wt, bt, ct) = _both(
        (x, res, w, beta, bias), (dtype, dtype, "fp32", "fp32", dtype))
    kw_j = dict(bias=cj) if with_bias else {}
    kw_t = dict(bias=ct) if with_bias else {}
    y_j, r_j = jax_unfused(xj, rj, wj, bj, **kw_j)
    y_t, r_t = fused_ops.residual_norm_unfused(xt, rt, wt, bt, **kw_t)
    assert y_t.dtype == r_t.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(r_t.float().numpy(), _np(r_j))
    np.testing.assert_allclose(y_t.float().numpy(), _np(y_j), **TOL[dtype])
    if dtype == "bf16" and with_bias:
        # the bias rounded in bf16 before the residual: not the kernel's sum
        _, r_fused = fused_ops.residual_norm_plain(xt, rt, wt, bt, bias=ct)
        assert not torch.equal(r_t, r_fused)
    assert fused_ops.RESIDUAL_NORM_LAUNCHES == 0


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(6)
    x = (2.0 * rng.standard_normal((5, HIDDEN)) + 1.0).astype(np.float32)
    w = rng.uniform(0.5, 1.5, HIDDEN).astype(np.float32)
    b = (0.1 * rng.standard_normal(HIDDEN)).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    want = jax_layer_norm(jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(b),
                          (HIDDEN,))
    got = fused_layer_norm_affine(torch.from_numpy(x).to(tdt),
                                  torch.from_numpy(w), torch.from_numpy(b),
                                  (HIDDEN,))
    assert got.dtype == tdt
    tol = dict(atol=1e-2, rtol=1e-2) if dtype == "bf16" else \
        dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)
