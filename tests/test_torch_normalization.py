"""Every name of ``apex_tpu.normalization`` against its port in
``apex_tpu_torch.normalization``, forward and backward, on the same
inputs made with numpy.

Tolerances: fp32 forward atol = rtol = 1e-5 and gradients rtol 1e-4 /
atol 1e-5, those of the JAX package's own norm tests (the same fp32
arithmetic, reductions summed in another order).  A bf16 result may sit
one bf16 step away (2**-7 of the element's magnitude, plus 1e-6 near 0):
an fp32 value that differs in its last bits can round the other way.

The near-zero gammas that exercise the memory-efficient backward's clamp
are an exact 0 (with a bias) and 1e-6 (with a zero bias): the recompute
``(y - beta) / clamp(gamma)`` divides by 1e-5, so a last-bit difference
in ``y - beta`` of a large beta would be magnified 1e5 times on either
side alike and compare noise, not the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.normalization as jn
import apex_tpu_torch.normalization as tn
from apex_tpu_torch.serving.bridge import from_flax_norm
from apex_tpu_torch.transformer import layers as tlayers

BF16_STEP = dict(rtol=2.0 ** -7, atol=1e-6)
FP32_FWD = dict(rtol=1e-5, atol=1e-5)
FP32_GRAD = dict(rtol=1e-4, atol=1e-5)
SHAPE = (3, 4, 48)
NSHAPES = {"int": 48, "tuple": (4, 48)}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tnp(t):
    return t.detach().float().numpy()


def _inputs(shape, nshape, seed, near_zero=True):
    rng = np.random.default_rng(seed)
    pshape = (nshape,) if isinstance(nshape, int) else nshape
    x = (2.0 * rng.standard_normal(shape) + 0.5).astype(np.float32)
    w = rng.uniform(0.5, 1.5, pshape).astype(np.float32)
    b = (0.1 * rng.standard_normal(pshape)).astype(np.float32)
    if near_zero:
        w.reshape(-1)[3] = 0.0
        w.reshape(-1)[7] = 1e-6
        b.reshape(-1)[7] = 0.0
    g = rng.standard_normal(shape).astype(np.float32)
    return x, w, b, g


def _check(got, want, names, bf16=()):
    for name, gv, wv in zip(names, got, want):
        tol = (BF16_STEP if name in bf16
               else FP32_FWD if name == "y" else FP32_GRAD)
        np.testing.assert_allclose(gv, wv, err_msg=name, **tol)


@pytest.mark.parametrize("memory_efficient", [False, True])
@pytest.mark.parametrize("nshape", ["int", "tuple"])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("kind", ["ln", "rms"])
def test_functions_match_jax(kind, affine, nshape, memory_efficient):
    ns = NSHAPES[nshape]
    x, w, b, g = _inputs(SHAPE, ns, seed=11)
    me = memory_efficient
    if kind == "ln" and affine:
        jf = lambda x_, w_, b_: jn.fused_layer_norm_affine(x_, w_, b_, ns, 1e-5, me)  # noqa: E731
        tf = lambda x_, w_, b_: tn.fused_layer_norm_affine(x_, w_, b_, ns, 1e-5, me)  # noqa: E731
        args = (x, w, b)
    elif kind == "ln":
        jf = lambda x_: jn.fused_layer_norm(x_, ns, 1e-5, me)  # noqa: E731
        tf = lambda x_: tn.fused_layer_norm(x_, ns, 1e-5, me)  # noqa: E731
        args = (x,)
    elif affine:
        jf = lambda x_, w_: jn.fused_rms_norm_affine(x_, w_, ns, 1e-5, me)  # noqa: E731
        tf = lambda x_, w_: tn.fused_rms_norm_affine(x_, w_, ns, 1e-5, me)  # noqa: E731
        args = (x, w)
    else:
        jf = lambda x_: jn.fused_rms_norm(x_, ns, 1e-5, me)  # noqa: E731
        tf = lambda x_: tn.fused_rms_norm(x_, ns, 1e-5, me)  # noqa: E731
        args = (x,)
    jy, vjp = jax.vjp(jf, *map(jnp.asarray, args))
    jgrads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    ty = tf(*leaves)
    ty.backward(torch.from_numpy(g))
    _check([_tnp(ty)] + [_tnp(t.grad) for t in leaves],
           [_np(jy)] + [_np(t) for t in jgrads], ["y", "dx", "dw", "db"])


@pytest.mark.parametrize("kind", ["ln", "rms"])
def test_bf16_input_fp32_parameters(kind):
    """bf16 x over fp32 parameters: statistics in fp32, y and dx in bf16,
    the parameter gradients in fp32."""
    x, w, b, g = _inputs(SHAPE, 48, seed=12, near_zero=False)
    jx, jg = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tw, tb = (torch.from_numpy(a).requires_grad_() for a in (w, b))
    if kind == "ln":
        jy, vjp = jax.vjp(lambda *a: jn.fused_layer_norm_affine(*a, (48,)),
                          jx, jnp.asarray(w), jnp.asarray(b))
        ty = tn.fused_layer_norm_affine(tx, tw, tb, (48,))
        leaves = (tx, tw, tb)
    else:
        jy, vjp = jax.vjp(lambda *a: jn.fused_rms_norm_affine(*a, (48,)),
                          jx, jnp.asarray(w))
        ty = tn.fused_rms_norm_affine(tx, tw, (48,))
        leaves = (tx, tw)
    ty.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert ty.dtype == tx.grad.dtype == torch.bfloat16
    assert tw.grad.dtype == torch.float32
    _check([_tnp(ty)] + [_tnp(t.grad) for t in leaves],
           [_np(jy)] + [_np(t) for t in vjp(jg)], ["y", "dx", "dw", "db"],
           bf16=("y", "dx"))


def test_jax_style_call_at_gpt_width():
    """``fused_layer_norm_affine(x, w, b, (768,))``, the JAX signature."""
    x, w, b, _ = _inputs((2, 5, 768), 768, seed=13, near_zero=False)
    want = jn.fused_layer_norm_affine(*map(jnp.asarray, (x, w, b)), (768,))
    got = tn.fused_layer_norm_affine(*map(torch.from_numpy, (x, w, b)), (768,))
    np.testing.assert_allclose(_tnp(got), _np(want), **FP32_FWD)


MODULES = ["FusedLayerNorm", "FusedRMSNorm", "MixedFusedLayerNorm",
           "MixedFusedRMSNorm"]


def _module_case(name, ns, kw, tkw, x, g, seed, x_dtype="fp32"):
    """Forward and gradients (x and every parameter) of the flax module
    and of the port's module loaded through ``from_flax_norm``."""
    jmod = getattr(jn, name)(ns, **kw)
    jdt = jnp.bfloat16 if x_dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if x_dtype == "bf16" else torch.float32
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x, jdt)).get(
        "params", {})
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.uniform(0.5, 1.5, p.shape), p.dtype),
        params)
    jy, vjp = jax.vjp(lambda p, x_: jmod.apply({"params": p}, x_), params,
                      jnp.asarray(x, jdt))
    jparams, jdx = vjp(jnp.asarray(g, jdt))

    tmod = getattr(tn, name)(ns, device="cpu", **tkw)
    tmod.load_state_dict(from_flax_norm({"params": params}))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    ty = tmod(tx)
    ty.backward(torch.from_numpy(g).to(tdt))
    names = sorted(jparams)
    assert sorted(n for n, _ in tmod.named_parameters()) == names
    got = [_tnp(ty), _tnp(tx.grad)] + [
        _tnp(dict(tmod.named_parameters())[n].grad) for n in names]
    want = [_np(jy), _np(jdx)] + [_np(jparams[n]) for n in names]
    return got, want, ["y", "dx"] + names


@pytest.mark.parametrize("nshape", ["int", "tuple"])
@pytest.mark.parametrize("name", MODULES)
def test_modules_match_flax(name, nshape):
    ns = NSHAPES[nshape]
    x, _, _, g = _inputs(SHAPE, ns, seed=14)
    got, want, names = _module_case(name, ns, {}, {}, x, g, seed=15)
    _check(got, want, names)


@pytest.mark.parametrize("memory_efficient", [False, True])
@pytest.mark.parametrize("name", ["FusedLayerNorm", "FusedRMSNorm"])
def test_non_affine_modules_have_no_parameters(name, memory_efficient):
    x, _, _, g = _inputs(SHAPE, 48, seed=16)
    kw = dict(elementwise_affine=False, memory_efficient=memory_efficient)
    got, want, names = _module_case(name, 48, kw, kw, x, g, seed=17)
    assert names == ["y", "dx"]
    _check(got, want, names)


@pytest.mark.parametrize("name", ["FusedLayerNorm", "FusedRMSNorm"])
def test_bf16_parameters_and_input(name):
    """``param_dtype=bf16`` on a bf16 x: every result in bf16."""
    x, _, _, g = _inputs(SHAPE, 48, seed=18)
    got, want, names = _module_case(
        name, 48, dict(param_dtype=jnp.bfloat16),
        dict(param_dtype=torch.bfloat16), x, g, seed=19, x_dtype="bf16")
    _check(got, want, names, bf16=names)


def test_mixed_modules_pin_fp32_parameters():
    for cls in (tn.MixedFusedLayerNorm, tn.MixedFusedRMSNorm):
        mod = cls((4, 48), device="cpu")
        assert all(p.dtype == torch.float32 for p in mod.parameters())
        assert mod.scale.shape == (4, 48)
        with pytest.raises(TypeError):
            cls(48, param_dtype=torch.bfloat16, device="cpu")


@pytest.mark.parametrize("weight", ["fp32", "none"])
@pytest.mark.parametrize("x_dtype", ["fp32", "bf16"])
def test_manual_rms_norm_matches_jax(x_dtype, weight):
    """The cast to x's dtype comes before the weight multiply, so a bf16 x
    with an fp32 weight returns fp32 on both sides."""
    x, w, _, _ = _inputs(SHAPE, 48, seed=20, near_zero=False)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if x_dtype == "bf16"
                else (jnp.float32, torch.float32))
    jw = None if weight == "none" else jnp.asarray(w)
    tw = None if weight == "none" else torch.from_numpy(w)
    want = jn.manual_rms_norm(jnp.asarray(x, jdt), (48,), jw, 1e-5)
    got = tn.manual_rms_norm(torch.from_numpy(x).to(tdt), (48,), tw, 1e-5)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    tol = BF16_STEP if x_dtype == "bf16" else FP32_FWD
    np.testing.assert_allclose(_tnp(got), _np(want), **tol)


@pytest.mark.parametrize("call", ["ln_affine", "ln", "rms_affine", "rms",
                                  "manual", "module"])
def test_shape_mismatch_raises_value_error(call):
    x = np.zeros(SHAPE, np.float32)
    w = np.ones(5, np.float32)
    calls = {
        "ln_affine": lambda m, x_, w_: m.fused_layer_norm_affine(x_, w_, w_, (5,)),
        "ln": lambda m, x_, w_: m.fused_layer_norm(x_, 5),
        "rms_affine": lambda m, x_, w_: m.fused_rms_norm_affine(x_, w_, (5,)),
        "rms": lambda m, x_, w_: m.fused_rms_norm(x_, (2, 3, 4, 48)),
        "manual": lambda m, x_, w_: m.manual_rms_norm(x_, (4, 5), w_, 1e-5),
    }
    if call == "module":
        with pytest.raises(ValueError):
            jn.FusedLayerNorm(5).init(jax.random.PRNGKey(0), jnp.asarray(x))
        with pytest.raises(ValueError):
            tn.FusedLayerNorm(5, device="cpu")(torch.from_numpy(x))
        return
    with pytest.raises(ValueError):
        calls[call](jn, jnp.asarray(x), jnp.asarray(w))
    with pytest.raises(ValueError):
        calls[call](tn, torch.from_numpy(x), torch.from_numpy(w))


def test_the_port_exports_the_jax_names():
    names = {n for n in dir(jn) if not n.startswith("_")}
    assert len(names) == 9 and set(tn.__all__) == names
    assert all(callable(getattr(tn, n)) for n in names)


def test_transformer_layers_names():
    assert tlayers.FastLayerNorm is tn.FusedLayerNorm
    assert tlayers.FusedRMSNorm is tn.FusedRMSNorm
    assert tlayers.MixedFusedLayerNorm is tn.MixedFusedLayerNorm
    assert tlayers.MixedFusedRMSNorm is tn.MixedFusedRMSNorm
    from apex_tpu.transformer.layers.layer_norm import (
        mark_sequence_parallel_params as jax_mark,
    )
    for path in ("layers_0/input_layernorm/scale", "final_layer_norm/bias",
                 "mlp/dense_h_to_4h/kernel", "attention/RMSNorm_0/scale",
                 "embedding/word_embeddings"):
        assert tlayers.mark_sequence_parallel_params(path) == jax_mark(path)
