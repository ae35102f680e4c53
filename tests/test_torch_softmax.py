"""The port's scale/mask softmax family and the default attention core
against the JAX package on the same inputs.

Inputs come from numpy seeds; the port runs on the CPU.  fp32 results
must match JAX at 1e-6 (the core at 1e-5); bf16 results within one bf16
step: of each element for the softmax, of the output's RMS for the core
(both round to bf16 at the same points, but their fp32 sums run in
another order, so a value next to a rounding boundary may round the
other way).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops import softmax as jsm
from apex_tpu.transformer.testing.standalone_transformer_lm import (
    CoreAttention as JaxCoreAttention,
)
from apex_tpu.transformer.testing import TransformerConfig as JaxConfig
from apex_tpu_torch.ops import softmax as sm
from apex_tpu_torch.transformer import functional
from apex_tpu_torch.transformer.enums import ModelType
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    CoreAttention,
    TransformerConfig,
)
from torch_threads import one_torch_thread  # noqa: F401

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _bf16_step(m):
    """One bf16 step (2**-7 relative, to the binade) at magnitude ``m``."""
    m = np.maximum(np.abs(m), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(m)) - 7)


def assert_close(got, want, dtype, tol=1e-6):
    got = got.detach().float().numpy()
    want = _np(want)
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        step = _bf16_step(np.maximum(np.abs(got), np.abs(want)))
        bad = np.abs(got - want) > step
        assert not bad.any(), (
            f"{bad.sum()} of {bad.size} elements more than one bf16 step "
            f"apart; largest gap {np.abs(got - want).max()}")


def _inputs(seed, shape=(2, 3, 8, 8)):
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    mask = rng.random((shape[0], 1) + shape[2:]) < 0.3
    mask[0, 0, 2] = True                 # one fully masked row
    return x, dy, mask


FUNCS = {
    "scaled_softmax": (lambda f, x, m, s: f.scaled_softmax(x, s)),
    "scaled_masked_softmax": (
        lambda f, x, m, s: f.scaled_masked_softmax(x, m, s)),
    "scaled_upper_triang_masked_softmax": (
        lambda f, x, m, s: f.scaled_upper_triang_masked_softmax(x, s)),
    "generic_scaled_masked_softmax": (
        lambda f, x, m, s: f.generic_scaled_masked_softmax(x, m, s)),
}


@pytest.mark.parametrize("scale", [1.0, 0.37], ids=["unscaled", "scaled"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("name", list(FUNCS))
def test_softmax_family_matches_jax(name, dtype, scale):
    """Forward and the gradient of x, through each Function's backward."""
    x, dy, mask = _inputs(0)
    jdt, tdt = DTYPES[dtype]
    call = FUNCS[name]
    jy, vjp = jax.vjp(lambda x: call(jsm, x, jnp.asarray(mask), scale),
                      jnp.asarray(x, jdt))
    (jdx,) = vjp(jnp.asarray(dy, jdt))
    tx = _t(x, tdt).requires_grad_()
    y = call(sm, tx, torch.from_numpy(mask), scale)
    y.backward(_t(dy, tdt))
    assert y.dtype == tdt and tx.grad.dtype == tdt
    assert_close(y, jy, dtype)
    assert_close(tx.grad, jdx, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_fully_masked_row_is_uniform(dtype):
    """The finite -10000 fill: a row with every key masked comes out
    uniform, 1/sk, as in JAX, never NaN."""
    x, _, mask = _inputs(1)
    jdt, tdt = DTYPES[dtype]
    y = sm.scaled_masked_softmax(_t(x, tdt), torch.from_numpy(mask), 0.5)
    want = jsm.scaled_masked_softmax(jnp.asarray(x, jdt), jnp.asarray(mask),
                                     0.5)
    assert torch.isfinite(y).all()
    row = y[0, :, 2].float()
    assert torch.equal(row, torch.full_like(row, 1.0 / 8))
    assert_close(y, want, dtype)


def test_causal_upper_triangle_is_exactly_zero():
    x, dy, _ = _inputs(2, (6, 8, 8))
    tx = torch.from_numpy(x).requires_grad_()
    y = sm.scaled_upper_triang_masked_softmax(tx, 2.0)
    y.backward(torch.from_numpy(dy))
    upper = torch.ones(8, 8, dtype=torch.bool).triu(1)
    assert (y[:, upper] == 0).all() and (tx.grad[:, upper] == 0).all()
    np.testing.assert_allclose(y.sum(-1).detach().numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("name", list(FUNCS))
def test_functions_save_only_the_output(name):
    """The backward's residual is ``y`` alone, in the output dtype."""
    x, _, mask = _inputs(3)
    tx = _t(x, torch.bfloat16).requires_grad_()
    y = FUNCS[name](sm, tx, torch.from_numpy(mask), 0.5)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 1
    assert saved[0].dtype == torch.bfloat16 and torch.equal(saved[0], y)


# (constructor keywords, x dtype, with a mask): the fused paths, and the
# unfused fallback's reference behaviours
DISPATCH = {
    "fused_causal": (dict(attn_mask_type=sm.AttnMaskType.causal, scale=2.0),
                     "bf16", False),
    "fused_padding": (dict(scale=0.5), "bf16", True),
    "fused_padding_no_mask": (dict(input_in_bf16=False), "fp32", False),
    "unfused_causal_without_mask_is_unmasked": (
        dict(attn_mask_type=sm.AttnMaskType.causal,
             scaled_masked_softmax_fusion=False), "bf16", False),
    "unfused_padding": (dict(scaled_masked_softmax_fusion=False, scale=3.0),
                        "bf16", True),
    "unfused_casts_to_declared_bf16": (
        dict(scaled_masked_softmax_fusion=False), "fp32", True),
    "unfused_casts_to_declared_fp16": (
        dict(input_in_fp16=True, input_in_bf16=False,
             scaled_masked_softmax_fusion=False), "fp32", True),
    "unfused_in_x_dtype": (
        dict(input_in_bf16=False, scaled_masked_softmax_fusion=False),
        "bf16", True),
    "unfused_mask_func": (
        dict(scaled_masked_softmax_fusion=False,
             mask_func="fill"), "fp32", True),
}


@pytest.mark.parametrize("case", list(DISPATCH))
def test_fused_scale_mask_softmax_matches_jax(case):
    kw, dtype, with_mask = DISPATCH[case]
    x, _, mask = _inputs(4)
    jdt, tdt = DTYPES[dtype]
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("attn_mask_type") is not None:
        jkw["attn_mask_type"] = jsm.AttnMaskType.causal
    if kw.get("mask_func") == "fill":
        jkw["mask_func"] = lambda s, m: jnp.where(m, -30.0, s)
        tkw["mask_func"] = lambda s, m: s.masked_fill(m, -30.0)
    jy = jsm.FusedScaleMaskSoftmax(**jkw)(
        jnp.asarray(x, jdt), jnp.asarray(mask) if with_mask else None)
    mod = functional.FusedScaleMaskSoftmax(**tkw)
    y = mod(_t(x, tdt), torch.from_numpy(mask) if with_mask else None)
    assert str(y.dtype).split(".")[-1] == jnp.dtype(jy.dtype).name
    assert_close(y, jy, "fp32" if y.dtype == torch.float32 else "bf16")
    assert mod.is_kernel_available(None, 2, 3, 8, 8) == (
        kw.get("scaled_masked_softmax_fusion", True))


def test_fused_scale_mask_softmax_constructor_errors():
    with pytest.raises(RuntimeError, match="both fp16 and bf16"):
        sm.FusedScaleMaskSoftmax(input_in_fp16=True, input_in_bf16=True)
    with pytest.raises(RuntimeError, match="fp32 when scaled"):
        sm.FusedScaleMaskSoftmax(softmax_in_fp32=False, scale=2.0)
    with pytest.raises(ValueError, match="sq == sk"):
        sm.FusedScaleMaskSoftmax(attn_mask_type=sm.AttnMaskType.causal)(
            torch.zeros(1, 1, 4, 5), None)
    assert [m.value for m in ModelType] == [1, 2]


SMALL = dict(hidden_size=32, num_layers=3, num_attention_heads=4,
             padded_vocab_size=64, max_position_embeddings=16,
             hidden_dropout=0.0, attention_dropout=0.0)


@pytest.mark.parametrize("mask", ["causal", "padding"])
@pytest.mark.parametrize("softmax_in_fp32", [False, True],
                         ids=["softmax_in_dtype", "softmax_in_fp32"])
@pytest.mark.parametrize("scaling", [True, False],
                         ids=["layer_scaling", "no_layer_scaling"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_core_attention_default_branch_matches_jax(dtype, scaling,
                                                   softmax_in_fp32, mask):
    """The fused-softmax core at layer 3 (``coeff`` 3 with layer
    scaling): the context and the gradients of q, k and v, with the
    causal mask or an arbitrary padding mask ``[b, 1, sq, sk]``."""
    s, b, n, d = 10, 2, 4, 8
    rng = np.random.default_rng(5)
    q, k, v, dout = (rng.standard_normal(shape).astype(np.float32)
                     for shape in [(s, b, n, d)] * 3 + [(s, b, n * d)])
    pad = rng.random((b, 1, s, s)) < 0.25
    pad[1, 0, 4] = True                  # a fully masked query row
    jdt, tdt = DTYPES[dtype]
    kw = dict(SMALL, apply_query_key_layer_scaling=scaling,
              attention_softmax_in_fp32=softmax_in_fp32)
    causal = mask == "causal"
    jcore = JaxCoreAttention(
        JaxConfig(**kw, tensor_axis=None, dtype=jdt), layer_number=3,
        attn_mask_type=(jsm.AttnMaskType.causal if causal
                        else jsm.AttnMaskType.padding))
    jmask = None if causal else jnp.asarray(pad)
    jout, vjp = jax.vjp(lambda q, k, v: jcore.apply({}, q, k, v, jmask),
                        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(dout, jdt))
    core = CoreAttention(
        TransformerConfig(**kw, dtype=tdt), layer_number=3,
        attn_mask_type=(sm.AttnMaskType.causal if causal
                        else sm.AttnMaskType.padding))
    tq, tk, tv = (_t(a, tdt).requires_grad_() for a in (q, k, v))
    out = core(tq, tk, tv, None if causal else torch.from_numpy(pad))
    out.backward(_t(dout, tdt))
    assert out.dtype == tdt and out.shape == (s, b, n * d)
    for got, want in [(out, jout)] + list(zip((tq.grad, tk.grad, tv.grad),
                                               jgrads)):
        got, want = got.detach().float().numpy(), _np(want)
        if dtype == "fp32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            step = _bf16_step(np.sqrt(np.mean(want ** 2)))
            assert np.abs(got - want).max() <= step, (
                np.abs(got - want).max(), step)
