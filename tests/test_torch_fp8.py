"""The port's fp8 training pieces against the JAX package's on the same
inputs.

The JAX side runs as ``tests/test_fp8.py`` runs it on the CPU (plain
XLA; fp8 has no Pallas kernel).  The port runs on CPU tensors, where
``fp8_matmul_t`` takes its plain version.  Inputs come from numpy seeds;
cotangents are given, so the e5m2 quantization of the gradient sees the
same values on both sides.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.amp import fp8 as jfp8
from apex_tpu.transformer.tensor_parallel import (
    ColumnParallelLinear as JaxColumn,
    RowParallelLinear as JaxRow,
)
from apex_tpu.transformer.testing import GPTModel as JaxGPTModel
from apex_tpu.transformer.testing import TransformerConfig as JaxConfig
from apex_tpu_torch.amp import fp8
from apex_tpu_torch.serving import KVCacheConfig, init_kv_arena
from apex_tpu_torch.serving.bridge import from_flax_fp8_meta, from_flax_gpt
from apex_tpu_torch.serving.model import DecodeModel, serving_config
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    linear_with_grad_accumulation,
)
from apex_tpu_torch.transformer.testing.standalone_gpt import GPTModel
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    TransformerConfig,
)
from torch_threads import one_torch_thread  # noqa: F401

DTYPES = {"e4m3": (fp8.E4M3, jfp8.E4M3), "e5m2": (fp8.E5M2, jfp8.E5M2)}
GPT = dict(hidden_size=64, num_layers=2, num_attention_heads=4,
           padded_vocab_size=128, max_position_embeddings=32,
           hidden_dropout=0.0, attention_dropout=0.0)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bits(q):
    """The bytes of an fp8 array of either package."""
    if isinstance(q, torch.Tensor):
        return q.view(torch.uint8).numpy()
    return np.asarray(q).view(np.uint8)


def _metas(scale_x, scale_w, history=16):
    """The same pair of metas in both packages, at the given scales."""
    def both(s):
        return (fp8.Fp8Meta(torch.zeros(history), torch.tensor(s)),
                jfp8.Fp8Meta(jnp.zeros((history,), jnp.float32),
                             jnp.float32(s)))
    return both(np.float32(scale_x)), both(np.float32(scale_w))


def _values(n=20000, seed=0):
    """Seeded values over 1e-3 to 4e2 in magnitude, with 0, -0, each
    format's largest value and values past it, infinities, a tie of
    e4m3 (232 lies between 224 and 240) and subnormals of both."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 2.6, n)
    specials = [0.0, -0.0, 448.0, -448.0, 449.0, -500.0, 464.0, 57344.0,
                -57344.0, 61440.0, 1e6, -1e6, np.inf, -np.inf, 232.0,
                -232.0, 2.0 ** -7, 2.0 ** -9, 3 * 2.0 ** -10, 2.0 ** -14,
                2.0 ** -16, 3 * 2.0 ** -17, 1e-30]
    return np.concatenate([v, specials]).astype(np.float32)


@pytest.mark.parametrize("x_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("dtype", ["e4m3", "e5m2"])
def test_quantize_matches_jax_bit_for_bit(dtype, x_dtype):
    """``cast(clip(v * scale, +-max))``: the same bytes in both packages,
    at scale 1 (the specials as they are) and at a scale that is not."""
    tdt, jdt = DTYPES[dtype]
    tx = torch.from_numpy(_values())
    if x_dtype == "bf16":
        tx = tx.to(torch.bfloat16)
    jx = jnp.asarray(tx.float().numpy(),
                     jnp.bfloat16 if x_dtype == "bf16" else jnp.float32)
    for scale in (1.0, 1.7, 3.1e-3):
        got = fp8._quantize(tx, torch.tensor(np.float32(scale)), tdt)
        want = jfp8._quantize(jx, jnp.float32(scale), jdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(_bits(got), _bits(want))
    q, amax = fp8.fp8_quantize(tx, fp8.Fp8Meta.init(device="cpu"), tdt)
    jq, jamax = jfp8.fp8_quantize(jx, jfp8.Fp8Meta.init(), jdt)
    np.testing.assert_array_equal(_bits(q), _bits(jq))
    assert amax.dtype == torch.float32 and amax.shape == ()
    assert float(amax) == float(jamax)


@pytest.mark.parametrize("history", [4, 16])
@pytest.mark.parametrize("dtype", ["e4m3", "e5m2"])
def test_update_meta_matches_jax_exactly(dtype, history):
    """Twenty rolls, every history and scale bit for bit: an amax of 0
    keeps the scale, an infinite one makes it 0 while it stays in the
    history, a NaN keeps it; the old meta is left as it was."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    amaxes = [0.0, 2.0, 8.0, 1.0, 1.0, 1.0, 1.0, np.inf, 3.0, 3.0, 3.0,
              3.0, 5.0, np.nan, 0.5, 0.5, 0.5, 0.5, 0.25, 0.0]
    amaxes = np.array([a * rng.uniform(0.9, 1.1) for a in amaxes],
                      np.float32)
    tm = fp8.Fp8Meta.init(history, device="cpu")
    jm = jfp8.Fp8Meta.init(history)
    scales = []
    for a in amaxes:
        old = tm
        tm = fp8.update_meta(tm, torch.tensor(a), tdt)
        jm = jfp8.update_meta(jm, jnp.float32(a), jdt)
        np.testing.assert_array_equal(
            tm.amax_history.numpy().view(np.uint32),
            _np(jm.amax_history).view(np.uint32))
        assert tm.scale.shape == () and tm.scale.dtype == torch.float32
        assert tm.scale.numpy().view(np.uint32) == \
            _np(jm.scale).view(np.uint32), (a, tm.scale, jm.scale)
        assert old.amax_history is not tm.amax_history
        scales.append(float(tm.scale))
    assert scales[0] == 1.0 and scales[7] == 0.0
    assert scales[13] == scales[12]


def _matmul_inputs(x_dtype, seed=2):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((3, 8, 48)) * 2.0).astype(np.float32)
    w = (rng.standard_normal((40, 48)) * 0.05).astype(np.float32)
    g = (rng.standard_normal((3, 8, 40)) * 1e-2).astype(np.float32)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    if x_dtype == "bf16":
        tx, tg = tx.to(torch.bfloat16), tg.to(torch.bfloat16)
    jdt = jnp.bfloat16 if x_dtype == "bf16" else jnp.float32
    jx = jnp.asarray(tx.float().numpy(), jdt)
    jg = jnp.asarray(tg.float().numpy(), jdt)
    # scales that are not 1: x's clips its largest values
    sx = 448.0 / (0.8 * np.abs(x).max())
    sw = 448.0 / (1.3 * np.abs(w).max())
    return (tx, torch.from_numpy(w), tg), (jx, jnp.asarray(w), jg), \
        _metas(sx, sw)


@pytest.mark.parametrize("x_dtype", ["fp32", "bf16"])
def test_fp8_matmul_t_matches_jax_vjp(x_dtype):
    """Forward, dx and dw of ``fp8_matmul_t`` against ``jax.vjp`` of the
    reference on the same operands, metas and cotangent: fp32 at 1e-6 of
    the largest value (the fp32 sums run in another order); with a bf16
    ``x`` the output and dx within two bf16 steps (each side rounds its
    fp32 sum once), dw (fp32, as w) at 1e-6.  On CPU tensors no fp8
    GEMM is counted, and the card route raises."""
    (tx, tw, tg), (jx, jw, jg), ((txm, jxm), (twm, jwm)) = \
        _matmul_inputs(x_dtype)
    y, vjp = jax.vjp(lambda x, w: jfp8.fp8_matmul_t(x, w, jxm, jwm), jx, jw)
    jdx, jdw = vjp(jg)
    x, w = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    counts = (fp8.FWD_GEMMS, fp8.BWD_GEMMS)
    ty = fp8.fp8_matmul_t(x, w, txm, twm)
    tdx, tdw = torch.autograd.grad(ty, (x, w), tg)
    assert (fp8.FWD_GEMMS, fp8.BWD_GEMMS) == counts
    assert ty.dtype == tdx.dtype == tx.dtype and tdw.dtype == torch.float32
    assert ty.shape == (3, 8, 40) and tdx.shape == tx.shape
    rtol = 1e-6 if x_dtype == "fp32" else 2.0 ** -7
    for got, want, tol in ((ty, y, rtol), (tdx, jdx, rtol), (tdw, jdw, 1e-6)):
        want = _np(want)
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   rtol=tol, atol=tol * np.abs(want).max())
    with pytest.raises(ValueError, match="CUDA tensors"):
        fp8._fp8_matmul_t(tx, tw, txm, twm, "card")


def _load(module, tensors):
    with torch.no_grad():
        for name, value in tensors.items():
            module.get_parameter(name).copy_(torch.from_numpy(
                np.array(value)))


def _port_metas(state):
    """``{"x": Fp8Meta, "w": Fp8Meta}`` of a port module's ``fp8_meta``."""
    return {k: (state.get_submodule(k).amax_history,
                state.get_submodule(k).scale) for k in ("x", "w")}


def _assert_same_metas(port_state, jax_metas):
    for k, (hist, scale) in _port_metas(port_state).items():
        np.testing.assert_array_equal(hist.numpy(),
                                      _np(jax_metas[k].amax_history))
        assert scale.numpy() == _np(jax_metas[k].scale), k


def test_fp8_dense_matches_flax_over_three_steps():
    """Three training forwards of ``Fp8Dense`` with new inputs each: the
    output, dx and the kernel's and bias's gradients at 1e-6, and the
    rolled metas bit for bit; then an ``eval()`` forward is the Flax
    ``apply`` without a mutable collection, and leaves the metas."""
    rng = np.random.default_rng(3)
    jmod = jfp8.Fp8Dense(features=24)
    x0 = rng.standard_normal((2, 5, 16)).astype(np.float32)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x0))
    params = dict(variables["params"])
    params["bias"] = jnp.asarray(rng.standard_normal(24).astype(np.float32))
    metas = variables["fp8_meta"]
    port = fp8.Fp8Dense(16, 24, device="cpu")
    assert port.kernel.shape == (16, 24)
    _load(port, params)

    def jax_fwd(p, x, metas):
        y, mut = jmod.apply({"params": p, "fp8_meta": metas}, x,
                            mutable=["fp8_meta"])
        return y, mut["fp8_meta"]

    for step in range(3):
        x = (rng.standard_normal((2, 5, 16)) * (step + 1)).astype(np.float32)
        g = rng.standard_normal((2, 5, 24)).astype(np.float32)
        y, vjp, metas = jax.vjp(jax_fwd, params, jnp.asarray(x), metas,
                                has_aux=True)
        jgp, jgx, _ = vjp(jnp.asarray(g))
        tx = torch.from_numpy(x).requires_grad_()
        ty = port(tx)
        tgx, tgk, tgb = torch.autograd.grad(
            ty, (tx, port.kernel, port.bias), torch.from_numpy(g))
        for got, want in ((ty, y), (tgx, jgx), (tgk, jgp["kernel"]),
                          (tgb, jgp["bias"])):
            want = _np(want)
            np.testing.assert_allclose(got.detach().numpy(), want,
                                       rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
        _assert_same_metas(port.fp8_meta, metas["metas"])

    frozen = {k: v.clone() for k, v in port.state_dict().items()}
    port.eval()
    x = rng.standard_normal((3, 16)).astype(np.float32)
    y = jmod.apply({"params": params, "fp8_meta": metas}, jnp.asarray(x))
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                               _np(y), rtol=1e-6, atol=1e-6)
    assert all(torch.equal(frozen[k], v)
               for k, v in port.state_dict().items())


@pytest.mark.parametrize("skip_bias_add", [False, True],
                         ids=["bias", "skip_bias_add"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["column", "row"])
def test_parallel_linear_fp8_matches_jax(kind, dtype, skip_bias_add):
    """``ColumnParallelLinear``/``RowParallelLinear`` with ``fp8=True`` at
    tp = 1 against the JAX layers, two training forwards: the output (and
    the bias ``skip_bias_add`` returns), dx and the parameters' gradients
    (fp32 at 1e-6; bf16 within two bf16 steps), and the rolled metas bit
    for bit, whose weight amax is taken after the cast to the compute
    dtype (fp32 parameters under bf16 compute)."""
    rng = np.random.default_rng(4)
    jcls, tcls = {"column": (JaxColumn, ColumnParallelLinear),
                  "row": (JaxRow, RowParallelLinear)}[kind]
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jmod = jcls(input_size=32, output_size=24, axis=None, fp8=True,
                skip_bias_add=skip_bias_add, dtype=jdt)
    x0 = jnp.zeros((6, 32), jdt)
    variables = jmod.init(jax.random.PRNGKey(1), x0)
    params = {"kernel": rng.standard_normal((24, 32)).astype(np.float32)
              * 0.1, "bias": rng.standard_normal(24).astype(np.float32)}
    metas = variables["fp8_meta"]
    port = tcls(32, 24, skip_bias_add=skip_bias_add, dtype=tdt,
                param_dtype=torch.float32, fp8=True, device="cpu")
    _load(port, params)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}

    def jax_fwd(p, x, metas):
        out, mut = jmod.apply({"params": p, "fp8_meta": metas}, x,
                              mutable=["fp8_meta"])
        y = out[0] if skip_bias_add else out
        return y, (mut["fp8_meta"], out[1] if skip_bias_add else None)

    tol = 1e-6 if dtype == "fp32" else 2.0 ** -7
    for step in range(2):
        tx = torch.from_numpy(rng.standard_normal((6, 32)).astype(
            np.float32) * (step + 1)).to(tdt)
        g = torch.from_numpy(rng.standard_normal((6, 24)).astype(
            np.float32)).to(tdt)
        jx = jnp.asarray(tx.float().numpy(), jdt)
        y, vjp, (metas, jbias) = jax.vjp(jax_fwd, jparams, jx, metas,
                                         has_aux=True)
        jgp, jgx, _ = vjp(jnp.asarray(g.float().numpy(), jdt))
        x = tx.clone().requires_grad_()
        out = port(x)
        ty = out[0] if skip_bias_add else out
        if skip_bias_add:
            np.testing.assert_array_equal(out[1].float().detach().numpy(),
                                          _np(jbias))
        tgx, tgk, tgb = torch.autograd.grad(
            ty, (x, port.kernel, port.bias), g, allow_unused=True)
        checks = [(ty, y, tol), (tgx, jgx, tol), (tgk, jgp["kernel"], tol)]
        if skip_bias_add:
            assert tgb is None
        else:
            # under bf16 compute a sum of six bf16 rows, which XLA rounds
            # after each add and torch once
            checks.append((tgb, jgp["bias"], 1e-6 if dtype == "fp32"
                           else 6 * 2.0 ** -8))
        for got, want, t in checks:
            want = _np(want)
            np.testing.assert_allclose(got.detach().float().numpy(), want,
                                       rtol=t, atol=t * np.abs(want).max())
        _assert_same_metas(port.fp8_meta, metas["metas"])


def _perturbed(tree, rng):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.5, 2.0, np.shape(a)).astype(
            np.float32), tree)


def test_from_flax_fp8_meta_round_trips_a_gpt_init():
    """The ``"fp8_meta"`` collection of a Flax fp8 ``GPTModel.init`` (made
    distinct leaf by leaf) loads into the port's GPT buffer by buffer, by
    layer path, and comes back from ``fp8_meta_state()`` as it went in;
    the metas appear in ``state_dict()``; a wrong set of names raises."""
    jcfg = JaxConfig(**GPT, tensor_axis=None, fp8=True)
    tokens = jnp.zeros((2, 8), jnp.int32)
    collection = jax.jit(JaxGPTModel(jcfg).init)(jax.random.PRNGKey(0),
                                                 tokens)["fp8_meta"]
    collection = _perturbed(collection, np.random.default_rng(5))
    metas = from_flax_fp8_meta(collection)
    # 2 layers x 4 linears x {x, w} x {amax_history, scale}
    assert len(metas) == 32
    model = GPTModel(TransformerConfig(**GPT, fp8=True), device="cpu")
    model.load_fp8_meta(metas)
    state = model.fp8_meta_state()
    assert set(state) == set(metas) and set(state) <= set(model.state_dict())
    flat = jax.tree_util.tree_flatten_with_path(collection)[0]
    for path, leaf in flat:
        keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
        name = ".".join(k.replace("layers_", "layers.") if k.startswith(
            "layers_") else ("fp8_meta" if k == "metas" else k) for k in keys)
        np.testing.assert_array_equal(state[name].numpy(), np.asarray(leaf))
    with pytest.raises(RuntimeError, match="missing"):
        model.load_fp8_meta(dict(list(metas.items())[1:]))
    assert not GPTModel(TransformerConfig(**GPT),
                        device="cpu").fp8_meta_state()


@pytest.mark.parametrize("call", ["update_meta", "Fp8Dense",
                                  "linear axis", "sequence_parallel",
                                  "overlap_comm"])
def test_model_parallel_options_raise(call):
    """The model-parallel options raise where they cannot run: sharing
    the amax over a tensor axis, or a sequence-parallel gather, with no
    rank grid set up; sequence parallelism with no tensor axis (as the
    reference), with the overlapped collectives too (they are ported, and
    with no grid they are the one local GEMM, as the reference's are
    unbound).  With a grid they run: the gloo tests of
    ``test_torch_tensor_parallel.py`` and ``test_torch_pipeline.py`` hold
    them against JAX."""
    x, w = torch.ones(2, 4), torch.ones(3, 4)
    calls = {
        "update_meta": (lambda: fp8.update_meta(
            fp8.Fp8Meta.init(device="cpu"), 1.0, axis="tp"),
            RuntimeError, "not initialized"),
        "Fp8Dense": (lambda: fp8.Fp8Dense(4, 3, axis="tp", device="cpu")(x),
                     RuntimeError, "not initialized"),
        "linear axis": (lambda: linear_with_grad_accumulation(
            x, w, sequence_parallel=True, axis="tp"),
            RuntimeError, "not initialized"),
        "sequence_parallel": (lambda: linear_with_grad_accumulation(
            x, w, sequence_parallel=True, axis=None),
            ValueError, "requires a tensor axis"),
        "overlap_comm": (lambda: linear_with_grad_accumulation(
            x, w, sequence_parallel=True, axis=None, overlap_comm=True),
            ValueError, "requires a tensor axis"),
    }
    fn, error, match = calls[call]
    with pytest.raises(error, match=match):
        fn()


def test_serving_config_serves_an_fp8_checkpoint_unchanged():
    """``serving_config`` turns fp8 off and nothing else, so the decode
    model of an fp8 config holds no fp8 state and serves the same logits
    from the same weights as the config without fp8."""
    cfg8 = TransformerConfig(**GPT, fp8=True)
    cfg = dataclasses.replace(cfg8, fp8=False)
    assert serving_config(cfg8) == serving_config(cfg) == cfg
    jcfg = JaxConfig(**GPT, tensor_axis=None)
    params = from_flax_gpt(jax.tree_util.tree_map(np.asarray, jax.jit(
        JaxGPTModel(jcfg).init)(jax.random.PRNGKey(3),
                                jnp.zeros((1, 8), jnp.int32))["params"]))
    cache = KVCacheConfig(n_layers=2, n_blocks=4, block_size=4, kv_heads=4,
                          head_dim=16, max_seq=16, dtype=torch.float32)
    rng = np.random.default_rng(6)
    n, T = 6, 8
    tokens = np.zeros((1, T), np.int64)
    tokens[0, :n] = rng.integers(1, 128, n)
    pos = np.zeros((1, T), np.int64)
    pos[0, :n] = np.arange(n)
    limits = np.zeros((1, T), np.int64)
    limits[0, :n] = np.arange(1, n + 1)
    db = np.full((1, T), cache.n_blocks, np.int64)
    db[0, :n] = np.arange(n) // 4
    do = np.zeros((1, T), np.int64)
    do[0, :n] = np.arange(n) % 4
    tables = np.zeros((1, cache.max_blocks_per_request), np.int64)
    tables[0, :2] = [0, 1]
    args = [torch.from_numpy(a) for a in (
        tokens, pos, tables, np.array([n]), limits, db, do,
        np.array([n - 1]))]
    greedy = [torch.zeros(1), torch.zeros(1, dtype=torch.int64),
              torch.ones(1), torch.zeros(1, dtype=torch.int64),
              torch.zeros(1, dtype=torch.int64)]
    logits = []
    for c in (cfg8, cfg):
        model = DecodeModel(c, cache, device="cpu")
        assert not any(".fp8_meta." in k for k in model.state_dict())
        model.load_params(params)
        logits.append(model.prefill(init_kv_arena(cache, device="cpu"),
                                    *args, *greedy)[1])
    assert torch.isfinite(logits[0]).all()
    assert torch.equal(logits[0], logits[1])
