"""The port's amp layer and FusedAdam's amp surface against the JAX
package on the same inputs.

Inputs come from numpy seeds; the port runs on the CPU (``device="cpu"``).
Scaler states are compared field by field, exactly; parameter trees leaf
by leaf (dtype and value); FusedAdam at 1e-6 in fp32, and within one bf16
step for bf16 parameters (their fp32 masters at 1e-6).
"""

import copy
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import amp as jamp
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.transformer.amp import GradScaler as JaxGradScaler
from apex_tpu.transformer.testing import GPTModel as JaxGPTModel
from apex_tpu.transformer.testing import TransformerConfig as JaxConfig
from apex_tpu_torch import amp
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.serving.bridge import from_flax_gpt
from apex_tpu_torch.testing import l1
from apex_tpu_torch.transformer.amp import GradScaler
from apex_tpu_torch.transformer.testing.standalone_gpt import GPTModel
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    TransformerConfig,
)

VOCAB = 128
GPT = dict(hidden_size=64, num_layers=2, num_attention_heads=4,
           padded_vocab_size=VOCAB, max_position_embeddings=32,
           hidden_dropout=0.0, attention_dropout=0.0)
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float16": torch.float16, "int32": torch.int32,
               "bool": torch.bool}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _to_torch(tree):
    """A JAX tree (dicts of arrays) as the same tree of CPU tensors."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return torch.from_numpy(a.astype(np.float32)).to(
        TORCH_DTYPE[a.dtype.name])


def _assert_same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}.{k}")
        return
    assert got.dtype == TORCH_DTYPE[jnp.dtype(want.dtype).name], path
    np.testing.assert_array_equal(got.float().numpy(), _np(want),
                                  err_msg=path)


def _assert_same_state(got, want):
    for field in ("scale", "growth_tracker", "hysteresis_tracker",
                  "found_inf"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.dtype == TORCH_DTYPE[w.dtype.name], field
        assert g.item() == w.item(), (field, g.item(), w.item())


def _flax_gpt_params():
    cfg = JaxConfig(**GPT, tensor_axis=None)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0, VOCAB)
    return cfg, tokens, JaxGPTModel(cfg).init(jax.random.PRNGKey(2),
                                              tokens)["params"]


# finite flags: growth at every 3rd clean step, single overflows absorbed
# by the hysteresis, pairs backing off, a run of overflows to the floor
SCRIPT = ([True] * 7 + [False] + [True] * 2 + [False, False] + [True] * 3
          + [False] * 12 + [True] * 4 + [False, True, False, False])


@pytest.mark.parametrize("kind", ["dynamic", "grad_scaler"])
def test_dynamic_loss_scale_update_matches_jax(kind):
    """``update`` over a scripted sequence of finite and overflowing
    steps, every field of every state exact; ``GradScaler``'s defaults
    are the JAX ones (hysteresis 2)."""
    if kind == "dynamic":
        kw = dict(init_scale=2.0 ** 4, growth_interval=3, hysteresis=2,
                  min_scale=0.25, max_scale=2.0 ** 7)
        scaler, jscaler = amp.DynamicLossScale(**kw), jamp.DynamicLossScale(
            **kw)
    else:
        scaler, jscaler = GradScaler(growth_interval=3), JaxGradScaler(
            growth_interval=3)
        for field in ("init_scale", "growth_factor", "backoff_factor",
                      "hysteresis", "min_scale", "max_scale"):
            assert getattr(GradScaler(), field) == getattr(JaxGradScaler(),
                                                           field)
        assert GradScaler().hysteresis == 2
    state, jstate = scaler.init("cpu"), jscaler.init()
    _assert_same_state(state, jstate)
    scales = set()
    for finite in SCRIPT:
        grads = {"w": torch.tensor([1.0, np.inf if not finite else 2.0])}
        flag = (scaler.all_finite(grads) if kind == "grad_scaler"
                else amp.all_finite(grads))
        assert flag.item() == finite
        state = scaler.update(state, flag)
        jstate = jscaler.update(jstate, jnp.asarray(finite))
        _assert_same_state(state, jstate)
        scales.add(state.scale.item())
    assert len(SCRIPT) >= 20 and len(scales) >= 4


def test_static_and_noop_scalers_match_jax():
    for scaler, jscaler in ((amp.StaticLossScale(128.0),
                             jamp.StaticLossScale(128.0)),
                            (amp.NoOpLossScale(), jamp.NoOpLossScale())):
        state, jstate = scaler.init("cpu"), jscaler.init()
        for finite in (True, False, True):
            state = scaler.update(state, torch.tensor(finite))
            jstate = jscaler.update(jstate, jnp.asarray(finite))
            _assert_same_state(state, jstate)
        loss = torch.tensor(3.0, dtype=torch.bfloat16)
        assert amp.scale_loss(loss, state).item() == float(
            jamp.scale_loss(jnp.asarray(3.0, jnp.bfloat16), jstate))
        g = {"a": torch.tensor([256.0, -3.0])}
        np.testing.assert_array_equal(
            scaler.unscale(g, state)["a"].numpy(),
            _np(jscaler.unscale({"a": jnp.asarray([256.0, -3.0])},
                                jstate)["a"]))
    assert amp.all_finite({}).item() and amp.all_finite(
        {"i": torch.tensor([1]), "f": torch.tensor([np.nan])}).item() is False


@pytest.mark.parametrize("half", ["bfloat16", "float16"])
@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
def test_cast_to_param_matches_jax_on_the_flax_gpt_tree(level, half):
    """Leaf by leaf over the Flax GPT parameter tree, the norm exemption
    included, and the other two casts."""
    _, _, params = _flax_gpt_params()
    jpol = jamp.policy(level, getattr(jnp, half))
    pol = amp.policy(level, TORCH_DTYPE[half])
    assert (pol.master_weights, pol.loss_scale, pol.uses_half_params) == (
        jpol.master_weights, jpol.loss_scale, jpol.uses_half_params)
    tree = _to_torch(params)
    _assert_same_tree(pol.cast_to_param(tree), jpol.cast_to_param(params))
    _assert_same_tree(amp.cast_to_compute(tree, pol),
                      jamp.cast_to_compute(params, jpol))
    _assert_same_tree(amp.cast_to_output(tree, pol),
                      jamp.cast_to_output(params, jpol))
    with pytest.raises(ValueError, match="opt_level"):
        amp.policy("O4")


def test_o2_keeps_every_layernorm_of_the_port_gpt_in_fp32():
    """``apply_policy`` over the port's own parameter names: exactly the
    LayerNorm parameters stay fp32 under O2, the same leaves the JAX
    policy exempts on the Flax tree."""
    _, _, params = _flax_gpt_params()
    model = GPTModel(TransformerConfig(**GPT), device="cpu")
    model.load_params(from_flax_gpt(jax.tree_util.tree_map(np.asarray,
                                                            params)))
    l1.apply_policy(model, amp.O2)
    fp32 = {n for n, p in model.named_parameters()
            if p.dtype == torch.float32}
    assert all(p.dtype == torch.bfloat16 for n, p in model.named_parameters()
               if n not in fp32)
    norms = {n for n, _ in model.named_parameters() if "layernorm" in n}
    assert fp32 == norms and len(norms) == 2 * (2 * 2 + 1)
    jcast = jax.tree_util.tree_leaves_with_path(jamp.O2.cast_to_param(params))
    jfp32 = [p for p, x in jcast if x.dtype == jnp.float32]
    assert len(jfp32) == len(fp32)


def test_make_master_and_master_to_model_match_jax():
    """On the O2-cast GPT tree, and on a tree whose first leaf (sorted
    keys) is a norm parameter: the model dtype is then fp32 and every
    float leaf comes back in fp32, in both packages."""
    _, _, params = _flax_gpt_params()
    rng = np.random.default_rng(7)
    odd = {"a_layernorm": {"scale": rng.standard_normal(4).astype(
        np.float32)},
        "dense": {"kernel": jnp.asarray(rng.standard_normal((3, 4)),
                                        jnp.bfloat16)},
        "step": np.int32(3)}
    for tree, jtree in ((_to_torch(jamp.O2.cast_to_param(params)),
                         jamp.O2.cast_to_param(params)),
                        (_to_torch(odd), odd)):
        master = amp.make_master(tree)
        jmaster = jamp.make_master(jtree)
        assert master.model_dtype == TORCH_DTYPE[jnp.dtype(
            jmaster.model_dtype).name]
        _assert_same_tree(master.params, jmaster.params)
        _assert_same_tree(amp.master_to_model(master),
                          jamp.master_to_model(jmaster))
    assert amp.make_master(_to_torch(odd)).model_dtype == torch.float32
    leaf = tree["a_layernorm"]["scale"]
    assert amp.make_master(tree).params["a_layernorm"]["scale"] is not leaf


def test_initialize_and_state_dict_match_jax():
    """``initialize`` (O2 with fp16, a policy override, two losses), the
    state dict, and a resume into another ``num_losses``: a warning and
    the overlapping prefix, as in JAX."""
    _, _, params = _flax_gpt_params()
    kw = dict(opt_level="O2", num_losses=2, output_dtype=torch.bfloat16)
    conf, state = amp.initialize(_to_torch(params), half_dtype=torch.float16,
                                 **kw)
    jconf, jstate = jamp.initialize(params, half_dtype=jnp.float16,
                                    **dict(kw, output_dtype=jnp.bfloat16))
    assert conf.policy.output_dtype == torch.bfloat16
    assert type(conf.loss_scaler).__name__ == type(
        jconf.loss_scaler).__name__
    _assert_same_tree(state.master.params, jstate.master.params)
    assert state.scaler[0].scale.device.type == "cpu"
    # advance the second loss's scaler: two overflows, then a clean step
    for finite in (False, False, True):
        state = state._replace(scaler=(state.scaler[0], conf.loss_scaler
                                       .update(state.scaler[1],
                                               torch.tensor(finite))))
        jstate = jstate._replace(scaler=(jstate.scaler[0], jconf.loss_scaler
                                         .update(jstate.scaler[1],
                                                 jnp.asarray(finite))))
    sd, jsd = amp.state_dict(state), jamp.state_dict(jstate)
    assert len(sd) == len(jsd) == 2
    for n in (1, 3):
        _, fresh = amp.initialize(None, "O2", num_losses=n, device="cpu")
        _, jfresh = jamp.initialize(None, "O2", num_losses=n)
        with pytest.warns(UserWarning, match="overlapping prefix"):
            got = amp.load_state_dict(fresh, sd)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jamp.load_state_dict(jfresh, jsd)
        got_states = ([got.scaler] if n == 1 else list(got.scaler))
        want_states = ([want.scaler] if n == 1 else list(want.scaler))
        assert len(got_states) == n
        for g, w in zip(got_states, want_states):
            _assert_same_state(g, w)
    _, one = amp.initialize(None, "O1", device="cpu")
    assert isinstance(amp.state_dict(one), dict)
    with pytest.raises(ValueError, match="num_losses"):
        amp.initialize(None, num_losses=0, device="cpu")


# per step: (lr override, grad scale, skip_update)
ADAM_SCHEDULE = [(None, None, None), (5e-3, 1024.0, False),
                 (None, 2.0 ** 12, True), (2e-3, 512.0, False),
                 (None, 8.0, True)]


@pytest.mark.parametrize("flat", [False, True], ids=["per_tensor", "flat"])
@pytest.mark.parametrize("master", [False, True], ids=["no_master", "master"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_fused_adam_amp_surface_matches_jax(dtype, master, flat):
    """Five steps of FusedAdam with ``master_weights``, ``flat`` and
    ``step``'s ``lr``, ``grad_scale`` and ``skip_update`` (two skipped
    steps) against the JAX ``FusedAdam.step``: parameters, masters, both
    moments and the step count."""
    rng = np.random.default_rng(8)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 2, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    kw = dict(lr=1e-2, betas=(0.8, 0.95), eps=1e-6, weight_decay=0.05)
    jopt = JaxFusedAdam(**kw, master_weights=master, flat=flat)
    jp = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    jstate = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(np.array(
        jp[k].astype(jnp.float32))).to(TORCH_DTYPE[jnp.dtype(jdt).name]))
        for k in shapes}
    opt = FusedAdam(list(tp.values()), **kw, master_weights=master,
                    flat=flat)
    for lr, scale, skip in ADAM_SCHEDULE:
        g = {k: (rng.standard_normal(s) * (scale or 1.0)).astype(np.float32)
             for k, s in shapes.items()}
        jg = {k: jnp.asarray(v, jdt) for k, v in g.items()}
        jp, jstate = jopt.step(jg, jstate, jp, lr=lr, grad_scale=scale,
                               skip_update=skip)
        for k, p in tp.items():
            p.grad = torch.from_numpy(np.array(_np(jg[k]))).to(p.dtype)
        opt.step(lr=lr, grad_scale=scale, skip_update=skip)
    for k, p in tp.items():
        st = opt.state[p]
        if dtype == "fp32":
            np.testing.assert_allclose(p.detach().numpy(), _np(jp[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            assert p.dtype == torch.bfloat16
            got, want = p.detach().float().numpy(), _np(jp[k])
            step = np.exp2(np.floor(np.log2(np.maximum(
                np.abs(want), 1e-30))) - 7)
            assert (np.abs(got - want) <= step).all(), k
        for name, want in (("exp_avg", jstate.slots["exp_avg"][k]),
                           ("exp_avg_sq", jstate.slots["exp_avg_sq"][k])):
            np.testing.assert_allclose(st[name].numpy(), _np(want),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
        if master:
            np.testing.assert_allclose(st["master"].numpy(),
                                       _np(jstate.master[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        else:
            assert "master" not in st
    assert int(opt.param_groups[0]["step"]) == int(jstate.step) == 3


@pytest.mark.parametrize("master", [False, True], ids=["no_master", "master"])
def test_fused_adam_skip_keeps_everything_bitwise(master):
    """A skipped step leaves parameters, masters, moments and the step
    count bit for bit; ``skip_update=False`` steps as no flag does."""
    rng = np.random.default_rng(9)
    base = rng.standard_normal((6, 4)).astype(np.float32)
    grads = [rng.standard_normal((6, 4)).astype(np.float32) for _ in range(3)]

    def run(flags):
        p = torch.nn.Parameter(torch.from_numpy(base).to(torch.bfloat16))
        opt = FusedAdam([p], lr=1e-2, master_weights=master)
        for g, flag in zip(grads, flags):
            p.grad = torch.from_numpy(g).to(torch.bfloat16)
            before = {k: v.clone() if isinstance(v, torch.Tensor) else v
                      for k, v in opt.state[p].items()}
            step_before = opt.param_groups[0].get("step", 0)
            p_before = p.detach().clone()
            opt.step(skip_update=flag)
            if flag is True:
                assert torch.equal(p, p_before)
                for k, v in before.items():
                    assert torch.equal(torch.as_tensor(opt.state[p][k]),
                                       torch.as_tensor(v)), k
                assert int(opt.param_groups[0]["step"]) == int(step_before)
        return p.detach(), opt.state[p], opt.param_groups[0]["step"]

    p_none, st_none, step_none = run([None, None, None])
    p_false, st_false, step_false = run([False, False, False])
    assert torch.equal(p_none, p_false)
    for k in ("exp_avg", "exp_avg_sq"):
        assert torch.equal(st_none[k], st_false[k])
    assert step_none == int(step_false) == 3
    p_skip, st_skip, step_skip = run([False, True, False])
    assert int(step_skip) == 2


@pytest.mark.parametrize("skip", [None, False],
                         ids=["host_count", "device_count"])
def test_fused_adam_counts_steps_per_group_when_a_gradient_comes_late(skip):
    """One step count per parameter group, as Apex keeps it: the first
    parameter has no gradient at step 1, so its state starts at step 2,
    where it must take the group's bias corrections (t = 2), not restart
    them.  JAX gets a zero gradient where the port has none (a zero
    gradient leaves Adam's first update at 0, as ``None`` does).  With a
    ``skip_update`` flag the count is a device tensor; ``state_dict``
    carries it, and a loaded optimizer steps on as the first one does."""
    init = [np.array([1.0, -2.0], np.float32),
            np.array([0.5, 3.0], np.float32)]
    schedule = [[None, [0.3, -0.2]], [[0.1, 0.4], [-0.1, 0.2]]]
    jopt = JaxFusedAdam(lr=0.1)
    jp = [jnp.asarray(x) for x in init]
    jstate = jopt.init(jp)
    ps = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in init]
    opt = FusedAdam(ps, lr=0.1)
    for grads in schedule:
        jg = [jnp.zeros(2, jnp.float32) if g is None
              else jnp.asarray(g, jnp.float32) for g in grads]
        jp, jstate = jopt.step(jg, jstate, jp)
        for p, g in zip(ps, grads):
            p.grad = None if g is None else torch.tensor(g)
        opt.step(skip_update=skip)
    for p, j, want in zip(ps, jp, [[0.92559, -2.07441], [0.35998, 3.09474]]):
        np.testing.assert_allclose(p.detach().numpy(), _np(j), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(p.detach().numpy(), want, atol=1e-5)
    assert int(opt.param_groups[0]["step"]) == int(jstate.step) == 2

    copies = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    loaded = FusedAdam(copies, lr=0.1)
    loaded.load_state_dict(copy.deepcopy(opt.state_dict()))   # as saved
    assert int(loaded.param_groups[0]["step"]) == 2
    for o, params in ((opt, ps), (loaded, copies)):
        for p, g in zip(params, ([0.2, -0.1], [0.05, 0.3])):
            p.grad = torch.tensor(g)
        o.step(skip_update=skip)
    assert all(torch.equal(a, b) for a, b in zip(ps, copies))
    assert int(loaded.param_groups[0]["step"]) == 3


def test_compare_traces_reports_a_differing_loss_scale():
    """The exact ``loss_scale`` series of the JAX ``compare_traces``: one
    differing scale is a problem, equal series are none."""
    trace = {"loss": [2.0, 1.5], "grad_norm": [1.0, 0.5],
             "loss_scale": [1024.0, 2048.0]}
    assert not l1.compare_traces(trace, dict(trace))
    other = dict(trace, loss_scale=[1024.0, 1024.0])
    assert l1.compare_traces(trace, other) == [
        "loss_scale[1]: 2048.0 vs baseline 1024.0 (rtol 0.0)"]
    from apex_tpu.testing.l1 import compare_traces as jax_compare
    assert jax_compare(trace, other) == l1.compare_traces(trace, other)
    assert l1.compare_traces({"loss": [2.0], "grad_norm": [1.0]},
                             {"loss": [2.0], "grad_norm": [1.0],
                              "loss_scale": [8.0]}) == [
        "loss_scale: 0 iters vs baseline 1"]


def _jax_o2_trace(cfg, tokens, params, scaler, steps):
    """The JAX composition of ``_trace_rn50``'s local step, for the GPT:
    scaled loss, gradients, ``all_finite``, ``FusedAdam.step`` with the
    scale and the skip, the scaler's update, the unscaled grad norm."""
    model = JaxGPTModel(cfg)
    opt = JaxFusedAdam(lr=1e-3, master_weights=True)
    state, sstate = opt.init(params), scaler.init()

    @jax.jit
    def step(p, state, sstate):
        def scaled(p):
            loss = jnp.mean(model.apply({"params": p}, tokens, labels=tokens))
            return scaler.scale(loss, sstate), loss

        grads, loss = jax.grad(scaled, has_aux=True)(p)
        finite = jamp.all_finite(grads)
        p, state = opt.step(grads, state, p, grad_scale=sstate.scale,
                            skip_update=~finite)
        g32 = scaler.unscale(grads, sstate)
        norm = jnp.sqrt(sum(jnp.sum(jnp.square(g))
                            for g in jax.tree_util.tree_leaves(g32)))
        return p, state, scaler.update(sstate, finite), loss, norm

    out = {"loss": [], "grad_norm": [], "loss_scale": []}
    for _ in range(steps):
        params, state, sstate, loss, norm = step(params, state, sstate)
        out["loss"].append(float(loss))
        out["grad_norm"].append(float(norm))
        out["loss_scale"].append(float(sstate.scale))
    return out, int(state.step)


def test_amp_train_step_o2_matches_the_jax_composition():
    """Ten ``amp_train_step`` steps of the tiny GPT under O2 against the
    same composition of the JAX pieces, from the same weights and tokens.

    The half dtype is fp16: bf16 has fp32's exponent range, and no fp32
    scale overflows this model's bf16 gradients (the largest is 2**-2.7
    of the scale, so 2**127 stays finite).  In fp16 the largest gradient
    reaches 65504 between the scales 2**18 and 2**19, so from 2**20
    (``growth_interval`` 4) the first steps overflow and are skipped, and
    the scale settles where the gradients fit.  The ``loss_scale`` series
    must be equal, the loss within 1e-3 and the grad norm within 1e-2 at
    the steps where it is finite (the bf16 trace's tolerances: fp16
    rounds after every op on both sides too), and non-finite at the same
    steps."""
    cfg, tokens, params = _flax_gpt_params()
    cfg = JaxConfig(**GPT, tensor_axis=None, dtype=jnp.float16)
    jpol = jamp.policy("O2", jnp.float16)
    kw = dict(init_scale=2.0 ** 20, growth_interval=4)
    want, jsteps = _jax_o2_trace(cfg, tokens, jpol.cast_to_param(params),
                                 jamp.DynamicLossScale(**kw), l1.ITERS)

    model = GPTModel(TransformerConfig(**GPT, dtype=torch.float16),
                     device="cpu")
    model.load_params(from_flax_gpt(jax.tree_util.tree_map(np.asarray,
                                                            params)))
    l1.apply_policy(model, amp.policy("O2", torch.float16))
    opt = FusedAdam(model.parameters(), lr=1e-3, master_weights=True)
    scaler = amp.DynamicLossScale(**kw)
    state = scaler.init("cpu")
    t = torch.from_numpy(np.array(tokens)).long()
    got = {"loss": [], "grad_norm": [], "loss_scale": []}
    for _ in range(l1.ITERS):
        loss, norm, state = l1.amp_train_step(model, opt, t, scaler, state)
        got["loss"].append(float(loss))
        got["grad_norm"].append(float(norm))
        got["loss_scale"].append(float(state.scale))
    assert got["loss_scale"] == want["loss_scale"], (got, want)
    overflow = [not np.isfinite(x) for x in want["grad_norm"]]
    assert [not np.isfinite(x) for x in got["grad_norm"]] == overflow
    assert overflow[0] and not all(overflow)
    keep = [i for i, o in enumerate(overflow) if not o]
    assert not l1.compare_traces(
        {k: [got[k][i] for i in keep] for k in got},
        {k: [want[k][i] for i in keep] for k in want},
        loss_rtol=1e-3, grad_rtol=1e-2)
    step = opt.param_groups[0]["step"]
    assert int(step) == jsteps == len(keep)
