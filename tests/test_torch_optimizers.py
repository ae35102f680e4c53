"""The port's optimizer family against the JAX package's, on one small
mixed-dtype tree.

Every optimizer of ``apex_tpu.optimizers.__all__`` (FusedAdam, FusedSGD,
FusedLAMB, FusedMixedPrecisionLamb, FusedLion, FusedAdagrad,
FusedNovoGrad, LARC, ``clip_grad_norm``, ``global_grad_norm``,
``fused_step``) runs five steps from the same weights and gradients
(numpy, seeded) in both packages: with and without fp32 master weights,
and plain or with the loss scale folded in (``grad_scale=8`` on
gradients eight times larger) and the first and third steps skipped
(``skip_update``: SGD's first momentum step and LAMB's bias corrections
wait for the first applied update).  The parameters, the state as the
reference's ``OptState`` (``opt_state``) and one more step after
``load_opt_state`` into a new optimizer are held against JAX's.  The
chunked buffers of ``apex_tpu_torch.utils.tree`` are held against
``apex_tpu.utils.tree``.

Tolerances: fp32 values at rtol 2e-5 / atol 1e-6 (the same fp32 ops in
another order); a bf16 parameter updated without masters at one bf16
step (rtol 8e-3: the fp32 update it is rounded from may differ in its
last bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import apex_tpu.optimizers as jopt
from apex_tpu.utils import tree as jtree
import apex_tpu_torch.optimizers as topt
from apex_tpu_torch.amp._tree import tree_leaves, tree_map
from apex_tpu_torch.optimizers._common import OptState
from apex_tpu_torch.utils import tree as ttree

STEPS = 5
SKIPPED = (0, 2)
SCALE = 8.0
SHAPES = {"a": ((4, 5), "float32"), "b": ((7,), "bfloat16"),
          "c": {"d": ((3, 3, 2), "float32"), "e": ((300,), "bfloat16")},
          "z": ((6,), "float32")}   # a zero tensor: LARC and LAMB skip it

# name -> (the class's name in both packages, keywords)
CASES = {
    "adam": ("FusedAdam", dict(lr=1e-2, weight_decay=1e-2)),
    "sgd": ("FusedSGD", dict(lr=0.1, momentum=0.9, weight_decay=1e-2)),
    "sgd_nesterov": ("FusedSGD", dict(lr=0.1, momentum=0.9, nesterov=True)),
    "sgd_damp_wd_after": ("FusedSGD", dict(
        lr=0.1, momentum=0.9, dampening=0.3, weight_decay=1e-2,
        wd_after_momentum=True)),
    "sgd_no_momentum": ("FusedSGD", dict(lr=0.1, weight_decay=1e-2)),
    "lamb": ("FusedLAMB", dict(lr=1e-2, weight_decay=1e-2)),
    "lamb_per_leaf": ("FusedLAMB", dict(lr=1e-2, weight_decay=1e-2,
                                        flat=False)),
    "lamb_mode0_no_avg": ("FusedLAMB", dict(
        lr=1e-2, weight_decay=1e-2, adam_w_mode=False,
        grad_averaging=False, max_grad_norm=50.0)),
    "lamb_nvlamb_no_clip": ("FusedLAMB", dict(
        lr=1e-2, weight_decay=0.0, use_nvlamb=True, max_grad_norm=0.0)),
    "lamb_nvlamb_per_leaf": ("FusedLAMB", dict(
        lr=1e-2, weight_decay=0.0, use_nvlamb=True, flat=False)),
    "mixed_precision_lamb": ("FusedMixedPrecisionLamb", dict(
        lr=1e-2, weight_decay=1e-2)),
    "lion": ("FusedLion", dict(lr=1e-2, weight_decay=1e-2)),
    "lion_l2": ("FusedLion", dict(lr=1e-2, weight_decay=1e-2,
                                  lion_w_mode=False)),
    "adagrad": ("FusedAdagrad", dict(lr=0.1, weight_decay=1e-2)),
    "adagrad_w": ("FusedAdagrad", dict(lr=0.1, weight_decay=1e-2,
                                       adagrad_w_mode=True)),
    "novograd": ("FusedNovoGrad", dict(lr=1e-2, weight_decay=1e-2)),
    "novograd_inf_inside_per_leaf": ("FusedNovoGrad", dict(
        lr=1e-2, weight_decay=1e-2, norm_type=0, reg_inside_moment=True,
        flat=False)),
    "novograd_init_zero_no_avg": ("FusedNovoGrad", dict(
        lr=1e-2, init_zero=True, grad_averaging=False,
        bias_correction=False)),
}
MODES = ("plain", "scaled_skips")


def _nested(fn, shapes=SHAPES, path=()):
    return {k: (_nested(fn, v, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), *v)) for k, v in shapes.items()}


def _values(seed, scale=1.0):
    """A numpy tree of the shapes (fp32 values; ``z`` all zeros)."""
    rng = np.random.RandomState(seed)

    def leaf(path, shape, dtype):
        if path == ("z",) and seed == 0:
            return np.zeros(shape, np.float32)
        return (rng.randn(*shape) * scale).astype(np.float32)

    return _nested(leaf)


def _dtypes():
    return _nested(lambda path, shape, dtype: dtype)


def _jax_tree(values):
    return jax.tree_util.tree_map(
        lambda v, d: jnp.asarray(v, getattr(jnp, d)), values, _dtypes())


def _torch_tree(values):
    return tree_map(lambda v, d: torch.tensor(v).to(getattr(torch, d)),
                    values, _dtypes())


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, what, bf16_steps=False):
    got_l, want_l = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l), what
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        loose = bf16_steps and getattr(w, "dtype", None) == jnp.bfloat16
        np.testing.assert_allclose(
            _np(g), _np(w), rtol=8e-3 if loose else 2e-5,
            atol=1e-2 if loose else 1e-6, err_msg=f"{what} leaf {i}")


def _grads(step, mode):
    return _values(100 + step, SCALE if mode == "scaled_skips" else 1.0)


def _kw(step, mode):
    if mode == "plain":
        return {}
    return {"grad_scale": SCALE, "skip_update": step in SKIPPED}


def _run_jax(cls, kw, steps, mode):
    opt = getattr(jopt, cls)(**kw)
    params = _jax_tree(_values(0))
    state = opt.init(params)
    for i in range(steps):
        extra = _kw(i, mode)
        if "skip_update" in extra:
            extra["skip_update"] = jnp.asarray(extra["skip_update"])
        params, state = opt.step(_jax_tree(_grads(i, mode)), state, params,
                                 **extra)
    return opt, params, state


def _port_opt(cls, kw, params):
    return getattr(topt, cls)(tree_leaves(params), **kw)


def _run_port(cls, kw, steps, mode, params=None, opt=None, start=0):
    params = _torch_tree(_values(0)) if params is None else params
    opt = _port_opt(cls, kw, params) if opt is None else opt
    for i in range(start, start + steps):
        grads = _torch_tree(_grads(i, mode))
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            p.grad = g
        opt.step(**_kw(i, mode))
    return opt, params


# FusedMixedPrecisionLamb always keeps masters
RUNS = [(case, master, mode) for case in CASES for master in (False, True)
        for mode in MODES
        if master or CASES[case][0] != "FusedMixedPrecisionLamb"]


@pytest.mark.parametrize("case,master,mode", RUNS, ids=[
    f"{c}-{'master' if m else 'no_master'}-{mode}" for c, m, mode in RUNS])
def test_optimizer_matches_jax(case, master, mode):
    cls, kw = CASES[case]
    kw = dict(kw, master_weights=master) \
        if cls != "FusedMixedPrecisionLamb" else kw
    _, jparams, jstate = _run_jax(cls, kw, STEPS, mode)
    opt, params = _run_port(cls, kw, STEPS, mode)
    _close(params, jparams, "params", bf16_steps=not master)
    state = opt.opt_state(params)
    assert int(state.step) == int(jstate.step)
    assert set(state.slots) == set(jstate.slots)
    for name in state.slots:
        _close(state.slots[name], jstate.slots[name], name)
    assert (state.master is None) == (jstate.master is None)
    if state.master is not None:
        _close(state.master, jstate.master, "master")

    # the state round trip: a new optimizer loaded with it takes the
    # sixth step as JAX does
    copy = tree_map(lambda p: p.detach().clone(), params)
    fresh = _port_opt(cls, kw, copy)
    fresh.load_opt_state(copy, OptState(
        step=state.step.clone(), slots=tree_map(torch.clone, state.slots),
        master=None if state.master is None else tree_map(torch.clone,
                                                          state.master)))
    _run_port(cls, kw, 1, mode, params=copy, opt=fresh, start=STEPS)
    _, jparams6, _ = _run_jax(cls, kw, STEPS + 1, mode)
    _close(copy, jparams6, "params after load_opt_state",
           bf16_steps=not master)


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "per_leaf"])
@pytest.mark.parametrize("clip", [True, False], ids=["clip", "no_clip"])
def test_larc_transform_matches_jax(flat, clip):
    """Per tensor ``tc * ||p|| / (||g|| + wd ||p|| + eps)``, clipped at
    ``lr``; the zero tensor ``z`` passes its gradient untouched."""
    params, grads = _values(0), _values(7)
    kw = dict(trust_coefficient=0.02, clip=clip, weight_decay=1e-2,
              flat=flat)
    want = jopt.LARC(**kw).transform_grads(
        _jax_tree(grads), _jax_tree(params), lr=0.1)
    got = topt.LARC(**kw).transform_grads(
        _torch_tree(grads), _torch_tree(params), lr=0.1)
    assert all(g.dtype == torch.float32 for g in tree_leaves(got))
    _close(got, want, "larc grads")
    z = tree_leaves(got)[-1]
    np.testing.assert_array_equal(_np(z), _values(7)["z"])


@pytest.mark.parametrize("mode", MODES)
def test_larc_wrapper_takes_the_weight_decay_and_unscales(mode):
    """``LARC(FusedSGD(weight_decay=wd))``: LARC takes the decay over (the
    inner group's is 0 after) and divides the gradients by ``grad_scale``
    before its norms."""
    sgd = dict(lr=0.1, momentum=0.9, weight_decay=1e-2)
    jlarc = jopt.LARC(jopt.FusedSGD(**sgd), trust_coefficient=0.02)
    params = _jax_tree(_values(0))
    state = jlarc.init(params)
    for i in range(STEPS):
        extra = _kw(i, mode)
        if "skip_update" in extra:
            extra["skip_update"] = jnp.asarray(extra["skip_update"])
        params, state = jlarc.step(_jax_tree(_grads(i, mode)), state,
                                   params, **extra)
    tparams = _torch_tree(_values(0))
    inner = topt.FusedSGD(tree_leaves(tparams), **sgd)
    larc = topt.LARC(inner, trust_coefficient=0.02)
    assert inner.param_groups[0]["weight_decay"] == 0.0
    assert larc.param_groups is inner.param_groups
    _run_port(None, None, STEPS, mode, params=tparams, opt=larc)
    _close(tparams, params, "params", bf16_steps=True)


@pytest.mark.parametrize("norm_type", [2.0, float("inf"), 1.5],
                         ids=["l2", "inf", "p1.5"])
def test_clip_grad_norm_matches_jax(norm_type):
    grads = _values(3, scale=4.0)
    jt, tt = _jax_tree(grads), _torch_tree(grads)
    np.testing.assert_allclose(
        float(topt.global_grad_norm(tt, norm_type)),
        float(jopt.global_grad_norm(jt, norm_type)), rtol=1e-6)
    for max_norm in (1.0, 1e4):            # clipping, and a no-op
        got, total = topt.clip_grad_norm(tt, max_norm, norm_type)
        want, jtotal = jopt.clip_grad_norm(jt, max_norm, norm_type)
        np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6)
        assert [g.dtype for g in tree_leaves(got)] == \
            [g.dtype for g in tree_leaves(tt)]
        _close(got, want, f"clipped at {max_norm}", bf16_steps=True)


def test_fused_step_is_the_optimizers_step():
    params = _torch_tree(_values(0))
    twin = tree_map(lambda p: p.detach().clone(), params)
    kw = dict(lr=0.1, momentum=0.9)
    a = topt.FusedSGD(tree_leaves(params), **kw)
    b = topt.FusedSGD(tree_leaves(twin), **kw)
    step = topt.fused_step(a)
    for i in range(3):
        g = _torch_tree(_grads(i, "scaled_skips"))
        for ps in (params, twin):
            for p, gi in zip(tree_leaves(ps), tree_leaves(g)):
                p.grad = gi.clone()
        step(**_kw(i, "scaled_skips"))
        b.step(**_kw(i, "scaled_skips"))
    for p, q in zip(tree_leaves(params), tree_leaves(twin)):
        assert torch.equal(p, q)


@pytest.mark.parametrize("pad_rows_to", [1, 4])
def test_chunked_buffers_match_jax(pad_rows_to):
    """``flatten_to_chunked`` and its metadata, the per-tensor sums of
    squares and max-abs, and the round trip, against
    ``apex_tpu.utils.tree``, with a zero-size leaf."""
    values = dict(_values(5), empty=np.zeros((0, 3), np.float32))
    jt = jax.tree_util.tree_map(jnp.asarray, values)
    tt = tree_map(torch.tensor, values)
    jbuf, jmeta = jtree.flatten_to_chunked(jt, pad_rows_to=pad_rows_to)
    tbuf, tmeta = ttree.flatten_to_chunked(tt, pad_rows_to=pad_rows_to)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    assert tmeta.row_offsets == jmeta.row_offsets
    assert tmeta.n_rows == jmeta.n_rows
    np.testing.assert_array_equal(tmeta.leaf_ids, jmeta.leaf_ids)
    np.testing.assert_allclose(
        ttree.chunked_per_leaf_sumsq(tbuf, tmeta).numpy(),
        np.asarray(jtree.chunked_per_leaf_sumsq(jbuf, jmeta)), rtol=1e-6)
    np.testing.assert_array_equal(
        ttree.chunked_per_leaf_max_abs(tbuf, tmeta).numpy(),
        np.asarray(jtree.chunked_per_leaf_max_abs(jbuf, jmeta)))
    back = ttree.unflatten_from_chunked(tbuf, tmeta)
    for a, b in zip(tree_leaves(back), tree_leaves(tt)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    meta = ttree.chunked_meta(None, tmeta.shapes, tmeta.dtypes,
                              pad_rows_to=pad_rows_to)
    np.testing.assert_array_equal(meta.leaf_ids, tmeta.leaf_ids)


def test_tree_norms_and_flat_buffer_match_jax():
    values = _values(6)
    jt, tt = _jax_tree(values), _torch_tree(values)
    np.testing.assert_allclose(float(ttree.tree_l2_norm(tt)),
                               float(jtree.tree_l2_norm(jt)), rtol=1e-6)
    np.testing.assert_allclose(
        [float(x) for x in ttree.per_leaf_l2_norms(tt)],
        [float(x) for x in jtree.per_leaf_l2_norms(jt)], rtol=1e-6)
    assert ttree.tree_size(tt) == jtree.tree_size(jt)
    with pytest.raises(ValueError):
        ttree.flatten_to_buffer(tt)        # mixed dtypes need dtype=
    buf, meta = ttree.flatten_to_buffer(tt, dtype=torch.float32, pad_to=64)
    jbuf, jmeta = jtree.flatten_to_buffer(jt, dtype=jnp.float32, pad_to=64)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    assert (meta.offsets, meta.total, meta.pad_to) == \
        (jmeta.offsets, jmeta.total, jmeta.pad_to)
    back = ttree.unflatten_from_buffer(buf, meta)
    for a, b in zip(tree_leaves(back), tree_leaves(tt)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_common_tree_helpers_match_jax():
    """``tree_f32`` (fp32 copies, never aliases), ``tree_zeros_f32`` and
    ``tree_map_multi`` against the JAX package's ``_common``."""
    from apex_tpu.optimizers import _common as jc
    from apex_tpu_torch.optimizers import _common as tc

    values = _values(8)
    jt, tt = _jax_tree(values), _torch_tree(values)
    got, want = tc.tree_f32(tt), jc.tree_f32(jt)
    _close(got, want, "tree_f32")
    for a, b in zip(tree_leaves(got), tree_leaves(tt)):
        assert a.dtype == torch.float32 and a.data_ptr() != b.data_ptr()
    zeros = tc.tree_zeros_f32(tt)
    _close(zeros, jc.tree_zeros_f32(jt), "tree_zeros_f32")
    got = tc.tree_map_multi(lambda a, b: (a.float() * 2 + b, a.float() - b),
                            2, tt, zeros)
    want = jc.tree_map_multi(lambda a, b: (jc.f32(a) * 2 + b, jc.f32(a) - b),
                             2, jt, jc.tree_zeros_f32(jt))
    for g, w in zip(got, want):
        _close(g, w, "tree_map_multi")
