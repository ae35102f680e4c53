"""The port's training slice against the JAX package on the same weights.

The JAX side runs as its own tests run it on the CPU (Pallas flash in
interpret mode where a config asks for flash).  The port runs with
``device="cpu"``, where the flash wrappers take their plain versions.
Initial weights come from the JAX model's init and cross over through
:func:`from_flax_gpt`; other inputs come from numpy seeds.
"""

import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.amp import fp8 as jfp8
from apex_tpu.normalization.fused_layer_norm import (
    fused_layer_norm_affine as jax_layer_norm,
)
from apex_tpu.ops.xentropy import softmax_cross_entropy_loss as jax_xentropy
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.testing import l1 as jax_l1
from apex_tpu.transformer.testing import GPTModel as JaxGPTModel
from apex_tpu.transformer.testing import TransformerConfig as JaxConfig
from apex_tpu_torch.amp import fp8
from apex_tpu_torch.normalization import fused_layer_norm_affine
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.serving.bridge import from_flax_fp8_meta, from_flax_gpt
from apex_tpu_torch.testing import l1
from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
    init_gpt_params,
)
from apex_tpu_torch.transformer.testing.standalone_gpt import GPTModel
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    TransformerConfig,
)
from torch_threads import one_torch_thread  # noqa: F401

# the module (apex_tpu_torch.ops re-exports the function under its name)
fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

VOCAB = 128
GPT = dict(hidden_size=64, num_layers=2, num_attention_heads=4,
           padded_vocab_size=VOCAB, max_position_embeddings=32)
MODERN = dict(GPT, position_embedding_type="rope", num_query_groups=2,
              swiglu=True)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _port_name(flax_name):
    """Flax ``language_model.encoder.layers_1.mlp...`` -> the port's
    ``language_model.encoder.layers.1.mlp...``."""
    parts = flax_name.split(".")
    out = []
    for p in parts:
        out += p.split("_", 1) if p.startswith("layers_") else [p]
    return ".".join(out)


@pytest.mark.parametrize("shape", [GPT, MODERN], ids=["learned_mha",
                                                      "rope_gqa_swiglu"])
def test_gpt_logits_loss_and_grads_match_jax(shape):
    """fp32: logits, per-token loss and every parameter's gradient of the
    mean loss against the JAX GPTModel (its fused-softmax core; the port
    runs flash) on bridged weights."""
    _check_gpt_against_jax(shape, use_flash_attention=True)


@pytest.mark.parametrize("shape", [GPT, MODERN], ids=["learned_mha",
                                                      "rope_gqa_swiglu"])
def test_default_core_gpt_logits_loss_and_grads_match_jax(shape):
    """The same with the port's default (fused-softmax) core, the one the
    JAX GPTModel runs by default."""
    _check_gpt_against_jax(shape, use_flash_attention=False)


def _check_gpt_against_jax(shape, use_flash_attention):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, VOCAB, (3, 24)).astype(np.int32)
    jcfg = JaxConfig(**shape, hidden_dropout=0.0, attention_dropout=0.0,
                     tensor_axis=None)
    jmodel = JaxGPTModel(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(tokens))["params"]
    # non-trivial biases and norm affines, so their grads are checked too
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32)), params)

    @jax.jit
    def jfn(p, t):
        def mean_loss(p):
            losses = jmodel.apply({"params": p}, t, labels=t)
            return jnp.mean(losses), losses

        (_, losses), grads = jax.value_and_grad(mean_loss, has_aux=True)(p)
        return jmodel.apply({"params": p}, t), losses, grads

    jlogits, jlosses, jgrads = jfn(params, jnp.asarray(tokens))
    jgrads = _flat(jgrads)

    model = GPTModel(TransformerConfig(
        **shape, hidden_dropout=0.0, attention_dropout=0.0,
        use_flash_attention=use_flash_attention), device="cpu")
    model.load_params(from_flax_gpt(jax.tree_util.tree_map(np.asarray,
                                                            params)))
    t = torch.from_numpy(tokens).long()
    np.testing.assert_allclose(model(t).detach().numpy(), _np(jlogits),
                               rtol=1e-4, atol=1e-4)
    losses = model(t, labels=t)
    assert losses.shape == (3, 23) and losses.dtype == torch.float32
    np.testing.assert_allclose(losses.detach().numpy(), _np(jlosses),
                               rtol=1e-4, atol=1e-4)
    losses.mean().backward()
    got = {n: p.grad for n, p in model.named_parameters()}
    assert len(got) == len(jgrads)
    for name, g in jgrads.items():
        port = got[_port_name(name)]
        assert port.dtype == torch.float32
        np.testing.assert_allclose(port.numpy(), _np(g), rtol=1e-3,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_xentropy_matches_jax(dtype, smoothing):
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((12, 50))).astype(np.float32)
    labels = rng.integers(0, 50, 12).astype(np.int32)
    labels[[2, 7]] = 0                               # padding rows
    dloss = rng.standard_normal(12).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))

    def jfn(x):
        return jax_xentropy(x, jnp.asarray(labels), smoothing, 0, True)

    jloss, vjp = jax.vjp(jfn, jnp.asarray(logits, jdt))
    (jgrad,) = vjp(jnp.asarray(dloss))
    x = torch.from_numpy(logits).to(tdt).requires_grad_()
    loss = softmax_cross_entropy_loss(x, torch.from_numpy(labels), smoothing,
                                      0, True)
    loss.backward(torch.from_numpy(dloss))
    assert loss.dtype == torch.float32 and x.grad.dtype == tdt
    assert not loss[[2, 7]].any() and not x.grad[[2, 7]].any()
    np.testing.assert_allclose(loss.detach().numpy(), _np(jloss), rtol=1e-5,
                               atol=1e-5)
    gtol = 1e-2 if dtype == "bf16" else 1e-6     # one bf16 rounding
    np.testing.assert_allclose(x.grad.float().numpy(), _np(jgrad), rtol=gtol,
                               atol=gtol)
    # without half_to_float, half logits give half losses
    half = softmax_cross_entropy_loss(x.detach(), torch.from_numpy(labels))
    assert half.dtype == tdt


@pytest.mark.parametrize("labels, padding_idx", [
    ([3, -100, 5, -100], -100),     # PyTorch's ignore index as padding
    ([-16, -17, -100, 15], 0),      # wrapped, beyond -C, far out, C - 1
])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_xentropy_labels_outside_the_classes_match_jax(labels, padding_idx,
                                                       smoothing):
    """Labels outside ``[0, C)`` as in the JAX package: padding rows give
    loss and gradient 0, a label in ``[-C, -1]`` counts from the end, one
    beyond ``[-C, C)`` gives a NaN loss; no one-hot term for either."""
    logits = np.random.RandomState(0).randn(4, 16).astype(np.float32)
    lab = np.asarray(labels, np.int32)
    dloss = np.random.RandomState(1).randn(4).astype(np.float32)

    def jfn(x):
        return jax_xentropy(x, jnp.asarray(lab), smoothing, padding_idx, True)

    jloss, vjp = jax.vjp(jfn, jnp.asarray(logits))
    (jgrad,) = vjp(jnp.asarray(dloss))
    x = torch.from_numpy(logits).requires_grad_()
    loss = softmax_cross_entropy_loss(x, torch.from_numpy(lab), smoothing,
                                      padding_idx, True)
    loss.backward(torch.from_numpy(dloss))
    np.testing.assert_allclose(loss.detach().numpy(), _np(jloss), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), _np(jgrad), rtol=1e-6,
                               atol=1e-6)
    pad = lab == padding_idx
    assert not loss[pad].any() and not x.grad[pad].any()


@pytest.mark.parametrize("memory_efficient", [False, True])
def test_layer_norm_backward_matches_jax(memory_efficient):
    rng = np.random.default_rng(2)
    x = (2.0 * rng.standard_normal((6, 5, 48)) + 1.0).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 48).astype(np.float32)
    w[3] = 0.0                          # clamped by magnitude in the recompute
    b = (0.1 * rng.standard_normal(48)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)

    def jfn(x, w, b):
        return jax_layer_norm(x, w, b, (48,), 1e-5, memory_efficient)

    jy, vjp = jax.vjp(jfn, *map(jnp.asarray, (x, w, b)))
    jgrads = vjp(jnp.asarray(dy))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = fused_layer_norm_affine(tx, tw, tb, (48,), 1e-5, memory_efficient)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), _np(jy), rtol=1e-5,
                               atol=1e-5)
    for got, want in zip((tx.grad, tw.grad, tb.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_fused_adam_steps_match_jax(adam_w_mode):
    """Two steps (bias correction at t = 1 and 2), with weight decay."""
    rng = np.random.default_rng(3)
    shapes = {"a": (7, 5), "b": (11,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(2)]
    kw = dict(lr=1e-2, betas=(0.8, 0.95), eps=1e-6, weight_decay=0.05,
              adam_w_mode=adam_w_mode)
    jopt = JaxFusedAdam(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = FusedAdam(list(tp.values()), **kw)
    for g in grads:
        jp, state = jopt.step({k: jnp.asarray(v) for k, v in g.items()},
                              state, jp)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), _np(jp[k]),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(list(tp.values()), amsgrad=True)


def _live_traces(name):
    """The JAX trace of ``name`` and the port's from the same initial
    weights and tokens (``_trace_gpt``'s own keys)."""
    return _port_trace(name), jax_l1.run_trace(name)


def _port_trace(name):
    """The port's trace of ``name`` from ``_trace_gpt``'s initial weights
    (``PRNGKey(2)``) and tokens (``PRNGKey(1)``) under the current JAX
    PRNG mode."""
    jkw = {"gpt_smoke": {}, "gpt_modern": dict(
        position_embedding_type="rope", num_query_groups=2, swiglu=True),
        "gpt_bf16": dict(dtype=jnp.bfloat16),
        "gpt_flash": dict(dtype=jnp.bfloat16, use_flash_attention=True)}[name]
    jcfg = JaxConfig(**GPT, hidden_dropout=0.0, attention_dropout=0.0,
                     tensor_axis=None, **jkw)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0, VOCAB)
    params = JaxGPTModel(jcfg).init(jax.random.PRNGKey(2), tokens)["params"]
    return l1.run_trace(name, device="cpu", params=from_flax_gpt(
        jax.tree_util.tree_map(np.asarray, params)),
        tokens=torch.from_numpy(np.array(tokens)))


@pytest.mark.parametrize("name", ["gpt_smoke", "gpt_modern"])
def test_fp32_trace_matches_live_jax(name):
    """Ten FusedAdam steps: loss within 1e-4 and grad norm within 1e-3
    (``compare_traces``' defaults) of a live JAX ``_trace_gpt``."""
    got, want = _live_traces(name)
    assert not l1.compare_traces(got, want)
    assert got["loss"][-1] < got["loss"][0]


def test_bf16_flash_trace_matches_live_jax():
    """``gpt_flash`` (bf16 compute, flash attention, fp32 parameters).

    Both sides round to bf16 after every op, but not at the same places:
    XLA fuses elementwise chains and rounds once per fusion, torch rounds
    after each op, and the flash kernels sweep keys in other blocks.  Each
    step's activations therefore differ by a few bf16 steps (2**-8
    relative); over ten steps that reached 1.1e-4 (loss) and 1.8e-3 (grad
    norm) relative when this test was written, so the tolerance is 1e-3
    on the loss and 1e-2 on the grad norm: ten times the bf16 spread
    measured, and a hundred times below the loss's fall over the trace."""
    got, want = _live_traces("gpt_flash")
    assert not l1.compare_traces(got, want, loss_rtol=1e-3, grad_rtol=1e-2)
    assert want["loss"][0] - want["loss"][-1] > 0.5


def test_bf16_trace_matches_live_jax():
    """``gpt_bf16`` (bf16 compute, the default fused-softmax core, fp32
    parameters) at ``gpt_flash``'s tolerances, for the same reasons: both
    sides round to bf16 after every op, XLA once per fusion and torch
    once per op."""
    got, want = _live_traces("gpt_bf16")
    assert not l1.compare_traces(got, want, loss_rtol=1e-3, grad_rtol=1e-2)
    assert want["loss"][0] - want["loss"][-1] > 0.5


@pytest.mark.parametrize("name, tols", [
    ("gpt_smoke", {}), ("gpt_bf16", dict(loss_rtol=1e-3, grad_rtol=1e-2))])
def test_trace_matches_the_stored_baseline(name, tols):
    """The port's trace from the baseline's initial weights against the
    JAX package's stored baseline (``tests/L1/baselines``): fp32 at
    ``compare_traces``' defaults, bf16 at the live bf16 tolerances."""
    path = Path(__file__).parent / "L1" / "baselines" / f"{name}.json"
    baseline = json.loads(path.read_text())
    # the baselines were recorded before JAX made its threefry PRNG
    # partitionable by default, which changed the values a key draws:
    # their initial weights and tokens come from the old mode
    with jax.threefry_partitionable(False):
        got = _port_trace(name)
    assert not l1.compare_traces(got, baseline, **tols)


# gpt_fp8 against the JAX package.  fp8 rounding makes the trace chaotic
# in its last bits: an fp32 sum that two implementations take in other
# orders (the same function to a few ulps) can land a value on the other
# side of an e4m3 or e5m2 rounding step, which moves that element by a
# whole fp8 step (6-25%), and the next steps carry it on.  The JAX package
# against itself, from initial weights each moved by at most one ulp
# (test_jax_fp8_trace_parts_from_itself_beyond_the_defaults), parts by
# 2.0e-4 in loss, 8.4e-3 in gradient norm and 3.0e-2 in the final scales
# over the ten steps; JAX 0.9 is 1.63e-4 / 1.79e-2 from the stored
# gpt_fp8.json (ISSUE 11's reading).  So no fp32 reimplementation can be
# held to compare_traces' defaults over ten steps: the traces are held at
# the stored-baseline limits below, above both spreads, the final scales
# at 1e-1, and the first step, before such a step can grow, tightly.
FP8_TRACE_TOL = dict(loss_rtol=5e-4, grad_rtol=5e-2)
FP8_SCALE_RTOL = 1e-1


def _jax_fp8_run():
    """``run_trace("gpt_fp8")`` with the outputs of each of its jitted
    steps kept, ``(params, optimizer state, fp8 metas, loss, grads)``,
    and the jitted step itself."""
    steps, jitted = [], []
    real_jit = jax.jit

    def spy(fun, *args, **kwargs):
        compiled = real_jit(fun, *args, **kwargs)
        if getattr(fun, "__name__", "") != "step":
            return compiled
        jitted.append(compiled)

        def run(*a):
            out = compiled(*a)
            steps.append(out)
            return out
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", spy)
        trace = jax_l1.run_trace("gpt_fp8")
    assert len(steps) == jax_l1.ITERS and len(jitted) == 1
    return trace, steps, jitted[0]


@pytest.fixture(scope="module")
def jax_fp8():
    """The live JAX ``gpt_fp8`` run, once for the module."""
    return _jax_fp8_run()


def _fp8_port_model(params):
    model = GPTModel(l1.trace_config("gpt_fp8"), device="cpu")
    model.load_params(from_flax_gpt(jax.tree_util.tree_map(np.asarray,
                                                           params)))
    return model


def _jax_fp8_init():
    """``_trace_gpt``'s initial weights and tokens, under the current JAX
    PRNG mode."""
    jcfg = JaxConfig(**GPT, hidden_dropout=0.0, attention_dropout=0.0,
                     tensor_axis=None, fp8=True)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0, VOCAB)
    params = JaxGPTModel(jcfg).init(jax.random.PRNGKey(2), tokens)["params"]
    return params, tokens


def _port_fp8_trace():
    params, tokens = _jax_fp8_init()
    return l1.run_trace("gpt_fp8", device="cpu", params=from_flax_gpt(
        jax.tree_util.tree_map(np.asarray, params)),
        tokens=torch.from_numpy(np.array(tokens)), with_fp8_meta=True)


def test_fp8_trace_matches_live_jax(jax_fp8):
    """Ten FusedAdam steps of ``gpt_fp8`` against a live JAX
    ``run_trace("gpt_fp8")`` from the same weights: the first step's loss
    and gradient norm at 1e-6, the trace at the limits above, and the
    final metas: the same buffers, scales within ``FP8_SCALE_RTOL``."""
    want, steps, _ = jax_fp8
    got, metas = _port_fp8_trace()
    np.testing.assert_allclose(got["loss"][0], want["loss"][0], rtol=1e-6)
    np.testing.assert_allclose(got["grad_norm"][0], want["grad_norm"][0],
                               rtol=1e-6)
    assert not l1.compare_traces(got, want, **FP8_TRACE_TOL)
    assert want["loss"][0] - want["loss"][-1] > 0.5
    jmetas = from_flax_fp8_meta(jax.tree_util.tree_map(np.asarray,
                                                       steps[-1][2]))
    assert set(metas) == set(jmetas) and len(metas) == 32
    for k, v in jmetas.items():
        if k.endswith(".scale"):
            np.testing.assert_allclose(metas[k].numpy(), v.numpy(),
                                       rtol=FP8_SCALE_RTOL, err_msg=k)


def test_fp8_first_step_matches_jax(jax_fp8):
    """One step of ``gpt_fp8`` from the JAX run's initial weights and
    metas: every gradient at 1e-5 of its largest value, the rolled metas
    at 1e-6 (the amaxes of activations that the two sides compute in
    other orders), and the quantized weights of the second step (the
    stepped weights under the rolled scales) bit for bit JAX's."""
    _, steps, _ = jax_fp8
    params, tokens = _jax_fp8_init()
    model = _fp8_port_model(params)
    opt = FusedAdam(model.parameters(), lr=1e-3)
    t = torch.from_numpy(np.array(tokens))
    l1.train_step(model, opt, t)
    jparams, _, jmeta_tree, _, jgrads = steps[0]
    jgrads = _flat(jax.tree_util.tree_map(np.asarray, dict(jgrads)))
    named = dict(model.named_parameters())
    for k, g in jgrads.items():
        np.testing.assert_allclose(named[_port_name(k)].grad.numpy(), g,
                                   rtol=1e-5, atol=1e-5 * np.abs(g).max(),
                                   err_msg=k)
    jmetas = from_flax_fp8_meta(jax.tree_util.tree_map(np.asarray,
                                                       jmeta_tree))
    metas = model.fp8_meta_state()
    for k, v in jmetas.items():
        np.testing.assert_allclose(metas[k].numpy(), v.numpy(), rtol=1e-6,
                                   err_msg=k)
    jkernels = _flat(jax.tree_util.tree_map(np.asarray, dict(jparams)))
    n = 0
    for name, mod in model.named_modules():
        if getattr(mod, "fp8_meta", None) is None:
            continue
        got = fp8._quantize(mod.kernel.detach(), mod.fp8_meta.w.scale,
                            fp8.E4M3)
        flax = name.replace("layers.", "layers_")
        want = jfp8._quantize(
            jnp.asarray(jkernels[f"{flax}.kernel"]),
            jnp.asarray(jmetas[f"{name}.fp8_meta.w.scale"]), jfp8.E4M3)
        np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                      np.asarray(want).view(np.uint8))
        n += 1
    assert n == 8


def test_jax_fp8_trace_parts_from_itself_beyond_the_defaults(jax_fp8):
    """The measurement behind the limits above: JAX's own ``gpt_fp8``
    step (the live run's, compiled once) from initial weights each moved
    by at most one ulp (seeded) fails ``compare_traces``' defaults against
    the live trace, and holds the fp8 limits, final scales included."""
    want, steps, step = jax_fp8
    params, tokens = _jax_fp8_init()
    rng = np.random.default_rng(0)

    def nudge(x):
        x = np.asarray(x)
        d = rng.integers(-1, 2, x.shape)
        up = np.nextafter(x, np.float32(np.inf))
        down = np.nextafter(x, np.float32(-np.inf))
        return jnp.asarray(np.where(d > 0, up, np.where(d < 0, down, x)))

    jcfg = JaxConfig(**GPT, hidden_dropout=0.0, attention_dropout=0.0,
                     tensor_axis=None, fp8=True)
    metas = dict(JaxGPTModel(jcfg).init(jax.random.PRNGKey(2),
                                        tokens)["fp8_meta"])
    p = jax.tree_util.tree_map(nudge, params)
    state = JaxFusedAdam(lr=1e-3).init(p)
    got = {"loss": [], "grad_norm": []}
    for _ in range(jax_l1.ITERS):
        p, state, metas, loss, grads = step(p, state, metas)
        got["loss"].append(float(loss))
        got["grad_norm"].append(jax_l1._global_grad_norm(grads))
    assert l1.compare_traces(got, want)
    assert not l1.compare_traces(got, want, **FP8_TRACE_TOL)
    final = from_flax_fp8_meta(jax.tree_util.tree_map(np.asarray, metas))
    live = from_flax_fp8_meta(jax.tree_util.tree_map(np.asarray,
                                                     steps[-1][2]))
    for k, v in live.items():
        if k.endswith(".scale"):
            np.testing.assert_allclose(final[k].numpy(), v.numpy(),
                                       rtol=FP8_SCALE_RTOL, err_msg=k)


def test_fp8_trace_matches_the_stored_baseline():
    """The port's ``gpt_fp8`` from the baseline's initial weights (drawn
    under the old threefry mode, as for ``gpt_smoke``) against
    ``tests/L1/baselines/gpt_fp8.json`` at the limits above; the live JAX
    trace from the same weights is within them too, so a failure here is
    the port's and not the stored file's age."""
    path = Path(__file__).parent / "L1" / "baselines" / "gpt_fp8.json"
    baseline = json.loads(path.read_text())
    with jax.threefry_partitionable(False):
        got, _ = _port_fp8_trace()
        live = jax_l1.run_trace("gpt_fp8")
    assert not l1.compare_traces(live, baseline, **FP8_TRACE_TOL)
    assert not l1.compare_traces(got, baseline, **FP8_TRACE_TOL)


def test_dropout_is_seeded_by_the_generator():
    """With dropout on, a generator seed fixes the step (hidden dropout
    masks and the flash kernels' dropout seed); another seed or
    ``generator=None`` (deterministic) gives another loss."""
    cfg = TransformerConfig(**GPT, hidden_dropout=0.2, attention_dropout=0.3,
                            use_flash_attention=True)
    model = GPTModel(cfg, device="cpu")
    model.load_params(init_gpt_params(cfg, 0, device="cpu"))
    tokens = torch.randint(0, VOCAB, (2, 16),
                           generator=torch.Generator().manual_seed(0))

    def loss(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return model(tokens, labels=tokens, generator=gen).mean()

    a, b, c, d = loss(1), loss(1), loss(2), loss(None)
    assert torch.isfinite(a) and a == b
    assert a != c and a != d
    a.backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_default_config_trains_on_cpu():
    """``TransformerConfig``'s defaults (the fused-softmax core, hidden and
    attention dropout 0.1) train: finite losses that fall over five
    FusedAdam steps with a seeded generator, and no flash launch."""
    cfg = TransformerConfig(**GPT)
    assert not cfg.use_flash_attention and cfg.attention_dropout == 0.1
    model = GPTModel(cfg, device="cpu")
    model.load_params(init_gpt_params(cfg, 0, device="cpu"))
    opt = FusedAdam(model.parameters(), lr=3e-3)
    tokens = torch.randint(0, VOCAB, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    losses = [float(l1.train_step(model, opt, tokens, gen))
              for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.1, losses
    assert (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES) == (0, 0, 0)


def test_trace_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTModel(l1.trace_config("gpt_smoke"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        l1.trace_gpt("gpt_smoke")
    assert (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES) == (0, 0, 0)
