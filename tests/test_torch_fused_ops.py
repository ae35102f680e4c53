"""The port's fused residual/LayerNorm epilogue (K3) against the JAX
package's Pallas kernel (interpret mode on the CPU), and the port's
LayerNorm against the JAX ``FusedLayerNorm`` forward.

Tolerance: the normed rows agree to atol = rtol = 1e-5 in fp32 (the same
fp32 arithmetic, with reductions summed in another order); in bf16 to
one bf16 rounding step (atol = rtol = 1e-2), since a last-bit difference
in fp32 can round the other way.  The new residual is exact: it is a sum
of the same values in the same order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.normalization.fused_layer_norm import (
    fused_layer_norm_affine as jax_layer_norm,
)
from apex_tpu.serving.fused_ops import fused_residual_norm as jax_frn
from apex_tpu_torch.normalization.fused_layer_norm import (
    fused_layer_norm_affine,
)
from apex_tpu_torch.serving import fused_ops

HIDDEN = 96


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("x_dtype", ["fp32", "bf16"])
def test_fused_residual_norm_matches_jax(x_dtype, with_bias):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 4, HIDDEN)).astype(np.float32)
    res = (3.0 * rng.standard_normal((3, 4, HIDDEN))).astype(np.float32)
    w = rng.uniform(0.5, 1.5, HIDDEN).astype(np.float32)
    beta = (0.1 * rng.standard_normal(HIDDEN)).astype(np.float32)
    bias = rng.standard_normal(HIDDEN).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if x_dtype == "bf16"
                else (jnp.float32, torch.float32))
    kw_j = dict(bias=jnp.asarray(bias, jdt)) if with_bias else {}
    kw_t = (dict(bias=torch.from_numpy(bias).to(tdt)) if with_bias else {})
    y_j, r_j = jax_frn(jnp.asarray(x, jdt), jnp.asarray(res),
                       jnp.asarray(w), jnp.asarray(beta), **kw_j)
    y_t, r_t = fused_ops.fused_residual_norm(
        torch.from_numpy(x).to(tdt), torch.from_numpy(res),
        torch.from_numpy(w), torch.from_numpy(beta), **kw_t)
    assert y_t.dtype == tdt and r_t.dtype == torch.float32
    tol = dict(atol=1e-2, rtol=1e-2) if x_dtype == "bf16" else \
        dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(y_t.float().numpy(), _np(y_j), **tol)
    np.testing.assert_array_equal(r_t.numpy(), _np(r_j))
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
