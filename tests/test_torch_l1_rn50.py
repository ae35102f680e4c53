"""The port's eight ``rn50_*`` L1 traces held against live JAX traces.

``tests/L1/baselines/rn50_*.json`` are not reproduced by the JAX package
today, under the default threefry or ``jax.threefry_partitionable(False)``
(the latter gives the stored initial loss to 4e-5 and then parts), and
the ten-step traces are chaotic: from weights moved by one ulp the JAX
package misses its own O0 trace by 9e-2 at step 1.  So each cell is held
step by step against one live JAX ``_trace_rn50`` run: a spy on
``jax.jit`` takes the state the JAX step is given at each of the first
``REPLAY_STEPS`` of its ten steps (parameters, BN statistics, the
optimizer's slots, masters and step count, scaler; the first scale
growth among them) and what the step returns, the port's
:class:`~apex_tpu_torch.testing.l1.RN50Trainer` is restored to it
(:func:`~apex_tpu_torch.models.resnet.from_flax_resnet`) and runs one
step, and its loss, gradient norm and loss scale are held against the
JAX step's.  Over the first ``OPT_STEPS`` the update is held against the
JAX step's new parameters, slots and masters too: the port's own, and
the port's optimizer given JAX's gradients
(``test_rn50_optimizer_step_matches_the_jax_step``).

Twins share a JAX run: ``rn50_smoke`` and ``rn50_O2_static128`` are held
against ``rn50_O2_dynamic``'s, ``rn50_O2_syncbn`` against
``rn50_O2_dynamic_syncbn``'s (a power-of-two scale changes no bit: the
stored baselines of each pair have the same loss series, checked below).

Tolerances:

- O0 (fp32): the loss at ``compare_traces``' default (1e-4); the
  gradient norm at 5e-3, since the JAX package's own gradient norm moves
  by more than the default 1e-3 from weights moved by one ulp (3.8e-3 at
  step 0 with this seed; ``test_jax_rn50_grad_norm_parts_from_itself``).
  Per-tensor gradients differ by a few percent either way: the BN layers
  over a batch of 8 at 1 x 1 to 8 x 8 pixels amplify rounding.
- bf16 (O2, O3, LAMB, SyncBN): XLA's CPU backend keeps fp32 between fused
  ops where the program rounds to bf16 (``--xla_allow_excess_precision``,
  on by default; off, the JAX O2 step-0 loss moves from 3.48 to 2.66),
  and the BN layers amplify each rounding, so a bf16 step's loss and
  gradient norm sit 0.1-26% from the fp32 evaluation of the same weights
  (the port's O0 step) in either package.  Each bf16 cell is held on the
  RMS over its steps of that relative distance: the port's within a
  factor ``BF16_RMS_RATIO`` (4) of the JAX package's, either way (a bf16
  cell that computed in fp32 would sit near 0): the port rounds to
  bf16 at every op boundary the program names, so its losses sit 1.0-2.7
  times as far from fp32 as XLA's over these five steps (O3 the most),
  its gradient norms 0.8-1.3 times.  A bf16 path gone wrong (statistics
  or BN parameters in bf16, a lost master) lands far outside.

The SyncBN cells replay ``SYNCBN_STEPS`` steps (the first scale growth
among them) on eight gloo ranks, one image each.  The reference's own
slow-tier L1 test stays as it is.
"""

import json
import os
import tempfile

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from apex_tpu.parallel import mesh as jmesh
from apex_tpu.testing import l1 as jl1
from apex_tpu_torch.amp.scaler import LossScaleState, all_finite
from apex_tpu_torch.models.resnet import from_flax_resnet
from apex_tpu_torch.optimizers._common import OptState
from apex_tpu_torch.parallel.launch import start_multiprocess
from apex_tpu_torch.testing import l1

import torch_rn50_ranks as ranks

BASELINES = os.path.join(os.path.dirname(__file__), "L1", "baselines")
# the live JAX run each cell is held against
JAX_RUN = {"rn50_O0": "rn50_O0", "rn50_O3": "rn50_O3",
           "rn50_O2_lamb": "rn50_O2_lamb",
           "rn50_smoke": "rn50_O2_dynamic",
           "rn50_O2_static128": "rn50_O2_dynamic",
           "rn50_O2_dynamic": "rn50_O2_dynamic",
           "rn50_O2_syncbn": "rn50_O2_dynamic_syncbn",
           "rn50_O2_dynamic_syncbn": "rn50_O2_dynamic_syncbn"}
O0_LOSS_RTOL, O0_GRAD_RTOL, O0_UPDATE_RTOL = 1e-4, 5e-3, 5e-2
OPT_RTOL, OPT_BF16_GRAD_RTOL, OPT_BF16_PARAM_RTOL = 1e-6, 2e-2, 2.0 ** -6
BF16_RMS_RATIO = 4.0
REPLAY_STEPS, SYNCBN_STEPS, OPT_STEPS = 5, 4, 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _by_name(tree):
    """A Flax tree shaped as the parameters, by the port's names."""
    return from_flax_resnet({"params": tree})


def _opt_state(state):
    """A JAX ``OptState`` (numpy) as the port's, by parameter name."""
    return OptState(step=torch.tensor(int(state.step)),
                    slots={k: _by_name(v) for k, v in state.slots.items()},
                    master=(None if state.master is None
                            else _by_name(state.master)))


def _snapshot(p, stats, state, sstate, with_opt=True):
    """A JAX step's input state (numpy) as an ``RN50Trainer.snapshot``:
    the parameters and BN statistics, the optimizer's state (step count,
    slots, masters; ``None`` without ``with_opt``) and the scaler."""
    return {"model": from_flax_resnet({"params": p, "batch_stats": stats}),
            "opt": _opt_state(state) if with_opt else None,
            "scaler": None if sstate is None else LossScaleState(
                *(torch.tensor(np.asarray(v)) for v in sstate))}


def _live(name, on_step):
    """The JAX package's ``run_trace(name)``, with ``on_step(i, inputs,
    outputs)`` called after each jitted step with its inputs and outputs;
    also returns the jitted step and its first inputs."""
    orig, seen = jax.jit, {}

    def spy(fn, *a, **kw):
        jitted = orig(fn, *a, **kw)

        def call(*args):
            i = seen.setdefault("n", 0)
            if i == 0:
                if jmesh.model_parallel_is_initialized():
                    # place the first inputs as the step's outputs are
                    # placed, so the second step does not compile again
                    rep = jax.sharding.NamedSharding(
                        jmesh.get_mesh(), jax.sharding.PartitionSpec())
                    args = (*jax.device_put(args[:4], rep), *args[4:])
                seen["step"], seen["args"] = jitted, args
            seen["n"] = i + 1
            out = jitted(*args)
            if i == 0:
                seen["out"] = out
            on_step(i, args, out)
            return out

        return call

    jax.jit = spy
    try:
        trace = jl1.run_trace(name)
    finally:
        jax.jit = orig
    return trace, seen


def _rel(got, want):
    """``max |got - want|`` over ``max |want|``, in fp32."""
    got, want = got.detach().float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def _jax_grads_step(tr, grads):
    """The trainer's optimizer step on JAX's unscaled gradients (fp32
    values, as the JAX step's update took them): times the trainer's
    scale (a power of two: no bit changes), with ``grad_scale`` and the
    overflow skip where it has a scaler."""
    params = dict(tr.model.named_parameters())
    scale = tr.sstate.scale if tr.scaler else None
    g = {params[n]: t.float() * (1.0 if scale is None else scale)
         for n, t in _by_name(grads).items()}
    if scale is None:
        tr.opt.step(grads=g)
    else:
        finite = all_finite(list(g.values()))
        tr.opt.step(grads=g, grad_scale=scale, skip_update=~finite)


@torch.no_grad()
def _update_errors(tr, snap, want):
    """The port's state after a step against the JAX step's output
    ``want`` (its new parameters and ``OptState``, by name): per kind of
    tensor the largest per-leaf distance relative to the leaf's largest
    element (``params``, each slot, ``master``), ``step`` (the counts
    agree), and ``update``, the global relative distance of the port's
    fp32 update (masters, else the parameters) from JAX's, from the
    input state ``snap``."""
    want_p, want_opt = want
    params = dict(tr.model.named_parameters())
    got = tr.opt.opt_state(params)
    err = {"params": max(_rel(params[n], want_p[n]) for n in params),
           "step": int(got.step) == int(want_opt.step)}
    for k, want_slot in want_opt.slots.items():
        err[k] = max(_rel(got.slots[k][n], want_slot[n]) for n in params)
    if want_opt.master is not None:
        err["master"] = max(_rel(got.master[n], want_opt.master[n])
                            for n in params)
        new, ref, old = got.master, want_opt.master, snap["opt"].master
    else:
        new, ref, old = params, want_p, snap["model"]
    num = sum(float(((new[n].float() - old[n].float())
                     - (ref[n].float() - old[n].float())).square().sum())
              for n in params)
    den = sum(float((ref[n].float() - old[n].float()).square().sum())
              for n in params)
    err["update"] = float(np.sqrt(num / den))
    return err


def _replay(cells, x, y):
    """``on_step`` running each ``(key, trainer, keep_scaler)`` of
    ``cells`` from the JAX state, the dict of their rows, and the dict of
    the optimizer's errors of the local cells over the first
    ``OPT_STEPS`` steps: ``[(own, jax_grads)]``, the
    :func:`_update_errors` after the port's own step and after its
    update on JAX's gradients.  ``"fp32"`` is the fp32 evaluation: its
    loss and gradient norm only."""
    rows = {key: [] for key, _, _ in cells}
    errors = {key: [] for key, _, _ in cells if key != "fp32"}

    def on_step(i, args, out):
        if i >= REPLAY_STEPS:
            return
        with_opt = bool(errors) and i < OPT_STEPS
        snap = _snapshot(*_np(args[:4]), with_opt=with_opt)
        if with_opt:
            p2, _, state2 = _np(out[:3])
            want, grads = (_by_name(p2), _opt_state(state2)), _np(out[5])
        for key, tr, keep_scaler in cells:
            s = dict(snap, scaler=snap["scaler"] if keep_scaler else None)
            if key == "fp32":
                s["opt"] = None
            tr.restore(s)
            loss, grad_norm = tr.step(x, y)
            rows[key].append((float(loss), float(grad_norm),
                              float(tr.sstate.scale) if tr.scaler else None))
            if key == "fp32" or not with_opt:
                continue
            own = _update_errors(tr, snap, want)
            tr.restore(s)
            _jax_grads_step(tr, grads)
            errors[key].append((own, _update_errors(tr, snap, want)))

    return on_step, rows, errors


def _batch(tr):
    x_np, y_np = l1.rn50_batch()
    return tr.images(x_np), torch.as_tensor(y_np)


_RUNS = {}
_GROUPS = []      # each rank's grouped SyncBatchNorm results, by rank


def _run(jax_name):
    """The live JAX run ``jax_name`` and the port's replay of every cell
    held against it, plus the port's fp32 evaluation of each state."""
    if jax_name in _RUNS:
        return _RUNS[jax_name]
    cells = [c for c, j in JAX_RUN.items() if j == jax_name]
    f32 = l1.RN50Trainer("rn50_O0", device="cpu", seed=None)
    x, y = _batch(f32)
    local = [(c, l1.RN50Trainer(c, device="cpu", seed=None),
              l1.RN50_CONFIGS[c][1] == "dynamic")
             for c in cells if not l1.RN50_CONFIGS[c][2]]
    if jax_name != "rn50_O0":
        local.append(("fp32", f32, False))
    on_step, rows, errors = _replay(local, x, y)
    state_dir = None
    if l1.RN50_CONFIGS[jax_name][2]:
        state_dir = tempfile.mkdtemp()

        def save(i, args, out, on_step=on_step):
            if i < SYNCBN_STEPS:     # the ranks replay loss and gradients
                snap = _snapshot(*_np(args[:4]), with_opt=False)
                torch.save(snap, os.path.join(state_dir, f"{i}.pt"))
            on_step(i, args, out)

        trace, seen = _live(jax_name, save)
        job = start_multiprocess(ranks.syncbn_steps, 8,
                                 args=(state_dir, cells, SYNCBN_STEPS),
                                 timeout=240.0, num_threads=1)
        try:
            per_rank = job.join()
        finally:
            for f in os.listdir(state_dir):
                os.remove(os.path.join(state_dir, f))
            os.rmdir(state_dir)
        assert all(r[c] == per_rank[0][c] for r in per_rank for c in cells), \
            "the ranks' losses and gradient norms differ"
        rows.update({c: per_rank[0][c] for c in cells})
        _GROUPS.extend(r["groups"] for r in per_rank)
    else:
        trace, seen = _live(jax_name, on_step)
    if jax_name not in ("rn50_O0", "rn50_O2_dynamic"):
        seen = None               # only these two runs' steps are used again
    _RUNS[jax_name] = (trace, rows, seen, errors)
    return _RUNS[jax_name]


def _series(rows, k):
    return [r[k] for r in rows]


@pytest.mark.parametrize("cell", list(JAX_RUN))
def test_rn50_trace_replays_the_live_jax_steps(cell):
    trace, rows, _, _ = _run(JAX_RUN[cell])
    got = rows[cell]
    n = len(got)
    assert n == (SYNCBN_STEPS if l1.RN50_CONFIGS[cell][2] else REPLAY_STEPS)
    want = {k: trace[k][:n] for k in ("loss", "grad_norm")}
    mine = {"loss": _series(got, 0), "grad_norm": _series(got, 1)}
    kind = l1.RN50_CONFIGS[cell][1]
    if kind is not None:
        scales = (trace["loss_scale"] if kind == "dynamic"
                  else json.load(open(os.path.join(
                      BASELINES, f"{cell}.json")))["loss_scale"])
        assert _series(got, 2) == scales[:n], "the loss-scale series"
    if cell == "rn50_O0":
        assert not l1.compare_traces(mine, want, loss_rtol=O0_LOSS_RTOL,
                                     grad_rtol=O0_GRAD_RTOL)
        return
    fp32 = {"loss": _series(rows["fp32"], 0)[:n],
            "grad_norm": _series(rows["fp32"], 1)[:n]}
    for key in ("loss", "grad_norm"):
        f = np.asarray(fp32[key])
        port = _rms((np.asarray(mine[key]) - f) / f)
        ref = _rms((np.asarray(want[key]) - f) / f)
        assert np.all(np.isfinite(mine[key]))
        assert ref / BF16_RMS_RATIO <= port <= BF16_RMS_RATIO * ref, (
            f"{cell} {key}: the port's bf16 steps are {port:.3e} (RMS, "
            f"relative) from the fp32 evaluation, the JAX package's {ref:.3e}")


LOCAL_CELLS = [c for c in JAX_RUN if not l1.RN50_CONFIGS[c][2]]


@pytest.mark.parametrize("cell", LOCAL_CELLS)
def test_rn50_optimizer_step_matches_the_jax_step(cell):
    """The optimizer's update at the ResNet-50 tree (161 leaves; FusedSGD
    or flat FusedLAMB, masters, weight decay, the scale and the skip)
    against the JAX step's output over the first ``OPT_STEPS`` replayed
    steps, from the same state (parameters, slots, masters, step count):

    - given JAX's gradients: the step count exactly; the masters, slots
      and fp32 parameters at ``OPT_RTOL`` where JAX's fp32 gradients are
      seen (O0, and a scaled cell, whose output is the unscaled fp32
      gradient its update took), else at ``OPT_BF16_GRAD_RTOL`` (the
      step returns the gradients rounded to bf16, while XLA's update
      took them before the rounding; the port given the rounded ones
      differs by it); bf16 parameters within ``OPT_BF16_PARAM_RTOL``;
    - after the port's own step (its own gradients), O0's update within
      ``O0_UPDATE_RTOL`` of JAX's, relative.  A bf16 cell's own update
      is not held: its gradients part from JAX's by more than their size
      (0.5-1.4, relative), as the bf16 steps part from the fp32
      evaluation; their loss and gradient norm are held above.

    Every distance is the largest over leaves of ``max |port - JAX|``
    over the leaf's ``max |JAX|``, the update's the global one."""
    _, _, _, errors = _run(JAX_RUN[cell])
    policy, loss_scale = l1.RN50_CONFIGS[cell][:2]
    exact = policy == "O0" or loss_scale is not None
    assert len(errors[cell]) == OPT_STEPS
    for i, (own, jax_grads) in enumerate(errors[cell]):
        assert jax_grads.pop("step") and own.pop("step"), f"step {i}"
        params = jax_grads.pop("params")
        assert params <= (OPT_RTOL if policy == "O0"
                          else OPT_BF16_PARAM_RTOL), (i, params)
        for key, err in jax_grads.items():
            assert err <= (OPT_RTOL if exact else OPT_BF16_GRAD_RTOL), (
                f"{cell} step {i} {key}: {err:.3e}")
        if policy == "O0":
            assert own["update"] <= O0_UPDATE_RTOL, (i, own)


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a))))


_FREE = {}
SNAPSHOT_STEPS = (3, 4)


def _free_run():
    """The port's own ``rn50_O2_dynamic`` trace from the JAX run's
    initial weights (``run_trace``), and the same run driven a step at a
    time up to two steps past the last of ``SNAPSHOT_STEPS``: its rows
    ``(loss, grad norm, scale)`` and its snapshots before those steps."""
    if not _FREE:
        _, _, seen, _ = _run("rn50_O2_dynamic")
        p, stats = _np(seen["args"][:2])
        variables = {"params": p, "batch_stats": stats}
        _FREE["trace"] = l1.run_trace("rn50_O2_dynamic", device="cpu",
                                      variables=variables)
        tr = l1.RN50Trainer("rn50_O2_dynamic", device="cpu",
                            variables=variables)
        x, y = _batch(tr)
        rows, snaps = [], {}
        for i in range(max(SNAPSHOT_STEPS) + 2):
            if i in SNAPSHOT_STEPS:
                snaps[i] = tr.snapshot()
            loss, grad_norm = tr.step(x, y)
            rows.append((float(loss), float(grad_norm),
                         float(tr.sstate.scale)))
        _FREE["rows"], _FREE["snaps"] = rows, snaps
    return _FREE["trace"], _FREE["rows"], _FREE["snaps"]


def test_rn50_free_running_trace_starts_at_the_replayed_step():
    """``trace_rn50`` itself (through ``run_trace``), from the JAX run's
    initial weights: its first step is the replay's first step bit for
    bit, and its loss-scale series is the JAX trace's (the losses part
    later: the trace is chaotic)."""
    trace, rows, _, _ = _run("rn50_O2_dynamic")
    got, _, _ = _free_run()
    assert got["loss"][0] == rows["rn50_O2_dynamic"][0][0]
    assert got["grad_norm"][0] == rows["rn50_O2_dynamic"][0][1]
    assert got["loss_scale"] == trace["loss_scale"]
    assert all(np.isfinite(got["loss"]))


@pytest.mark.parametrize("step", SNAPSHOT_STEPS)
def test_rn50_snapshot_restores_the_whole_training_state(step):
    """A fresh trainer restored from the ``snapshot`` before ``step``
    (parameters, BN statistics, momentum buffers, masters, the step
    count, the scaler; the scale grows at step 3) runs that step and the
    next bit for bit as the run it was taken from, which is the
    ``run_trace`` run, bit for bit."""
    trace, rows, snaps = _free_run()
    assert rows == list(zip(trace["loss"], trace["grad_norm"],
                            trace["loss_scale"]))[:len(rows)]
    tr = l1.RN50Trainer("rn50_O2_dynamic", device="cpu", seed=None)
    x, y = _batch(tr)
    tr.restore(snaps[step])
    for i in (step, step + 1):
        loss, grad_norm = tr.step(x, y)
        assert (float(loss), float(grad_norm),
                float(tr.sstate.scale)) == rows[i], i


def test_jax_rn50_grad_norm_parts_from_itself():
    """Why O0's gradient norm is held at 5e-3 and its own update at 5e-2:
    the JAX package's own O0 step, from its step-0 weights moved by one
    ulp, moves the gradient norm by more than ``compare_traces``' default
    1e-3 (3.8e-3) and the whole gradient by more than 1e-2 (3.1e-2,
    relative)."""
    trace, _, seen, _ = _run("rn50_O0")
    p, stats, state, sstate, x, y = seen["args"]
    rng = np.random.RandomState(1)
    moved = jax.tree_util.tree_map(
        lambda a: np.nextafter(np.asarray(a), np.asarray(a) + rng.choice(
            [-1, 1], size=np.shape(a)).astype(np.float32) * np.float32(
                np.inf)), p)
    grads = seen["step"](moved, stats, state, sstate, x, y)[5]
    spread = abs(jl1._global_grad_norm(grads) - trace["grad_norm"][0]) \
        / trace["grad_norm"][0]
    assert 1e-3 < spread < O0_GRAD_RTOL
    flat = lambda t: np.concatenate([  # noqa: E731
        np.ravel(np.asarray(v)) for v in jax.tree_util.tree_leaves(t)])
    a, b = flat(grads), flat(seen["out"][5])
    assert 1e-2 < np.linalg.norm(a - b) / np.linalg.norm(b) < O0_UPDATE_RTOL


def test_stored_twin_baselines_agree():
    """The stored baselines of the cells that share a JAX run have the
    same loss series (a power-of-two loss scale changes no bit)."""
    def loss(name):
        with open(os.path.join(BASELINES, f"{name}.json")) as f:
            return json.load(f)["loss"]

    for cell, run in JAX_RUN.items():
        assert loss(cell) == loss(run)


def test_sync_batchnorm_sums_within_its_index_groups():
    """``SyncBatchNorm(axis_index_groups=[[0..3], [4..7]])`` on the eight
    ranks, one image a rank: each rank's output, input gradient and
    running statistics are those of local BN over its group's four
    images (forward and backward summed within the group, not beyond
    it), and the ranks' parameter-gradient shares sum to that BN's, at
    1e-5.  (The local BN is held against Flax in
    ``test_torch_resnet.py``.)"""
    from apex_tpu_torch.parallel import SyncBatchNorm

    _run("rn50_O2_dynamic_syncbn")
    assert len(_GROUPS) == 8
    x, g, scale, bias = ranks.group_inputs()
    for group in ranks.GROUPS:
        m = SyncBatchNorm(6, momentum=0.2, fuse_relu=True, device="cpu")
        with torch.no_grad():
            m.scale.copy_(torch.from_numpy(scale))
            m.bias.copy_(torch.from_numpy(bias))
        xt = torch.tensor(x[group], requires_grad=True)
        y = m(xt)
        (y * torch.from_numpy(g[group])).sum().backward()
        for i, r in enumerate(group):
            got = _GROUPS[r]
            np.testing.assert_allclose(got["y"][0], y[i].detach().numpy(),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got["dx"][0], xt.grad[i].numpy(),
                                       rtol=1e-5, atol=1e-5)
            for k in ("running_mean", "running_var"):
                np.testing.assert_allclose(got[k], getattr(m, k).numpy(),
                                           rtol=1e-5, atol=1e-6)
        for k, want in (("dscale", m.scale.grad), ("dbias", m.bias.grad)):
            np.testing.assert_allclose(
                sum(_GROUPS[r][k] for r in group), want.numpy(), rtol=1e-5,
                atol=1e-5)
