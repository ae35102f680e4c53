"""The serving restores and the crash/resume harness of the port.

- ``restore_gpt_for_serving``: a train state saved with the layer stack
  ``[vpp 1, pp 2]`` lands as the serving ``[L, 1, ...]`` stack bit for
  bit, past a corrupt newest step, and the engine on it serves the
  streams of an engine on the in-memory weights (the tp 2 case against
  JAX's engine is in ``test_torch_checkpoint.py``'s four-rank spawn).
- ``restore_adapter_for_serving``: the twin of ``tests/test_lora.py``'s
  corrupt-newest case, the port's and the reference's restore of the same
  directory equal.
- ``_build_engine`` with ``ckpt_dir``, in process on the CPU, reports
  the step it serves.
- ``FusedAdam.opt_state``: the reference's ``OptState`` tree, read by
  the reference's ``restore_checkpoint`` into its own ``FusedAdam``'s.
- ``testing/crash_resume.py``: one spawned CPU child (the reference's
  tiny shapes) SIGKILLed after a committed save; the resume in this
  process, and another past a corrupted newest step, log the hex losses
  of an uninterrupted run, and their fingerprints are equal.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from apex_tpu_torch import checkpoint as ckpt
from apex_tpu_torch.amp._tree import tree_leaves, tree_map
from apex_tpu_torch.observability.metrics import MetricRegistry
from apex_tpu_torch.resilience import CheckpointManager, build_spec
from apex_tpu_torch.serving import (
    LoRAConfig,
    ServingConfig,
    ServingEngine,
    restore_adapter_for_serving,
    restore_gpt_for_serving,
)
from apex_tpu_torch.serving.lora import adapter_shapes, init_adapter_weights
from apex_tpu_torch.serving.replica import ReplicaSpec, _build_engine
from apex_tpu_torch.testing import crash_resume, faults
from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
    gpt3d_logical_folds,
    init_gpt_params,
)
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    TransformerConfig,
)
from torch_threads import one_torch_thread  # noqa: F401

from test_torch_serving import GPT, WAVE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVING = dict(max_batch=3, block_size=4, max_seq=32, prefill_len=6,
               n_blocks=16)
CFG = TransformerConfig(**GPT, hidden_dropout=0.0, attention_dropout=0.0)


def _serve(engine, wave):
    reqs, pending, step = [], list(wave), 0
    while pending or not engine.scheduler.idle:
        while pending and pending[0][0] <= step:
            _, prompt, n_new = pending.pop(0)
            reqs.append(engine.submit(prompt, n_new))
        engine.step()
        step += 1
    return [r.output_tokens for r in reqs]


def _train_state(seed):
    """A train state with the stack in the pipeline form ``[1, 2, ...]``
    (vpp 1, pp 2), an optimizer state and a counter."""
    params = init_gpt_params(CFG, seed, device="cpu")
    params = params._replace(layers=tree_map(
        lambda t: t.reshape((1, 2) + t.shape[1:]), params.layers))
    tree = {"params": params, "opt": {"exp_avg": tree_map(
        torch.zeros_like, params)}, "count": torch.tensor(seed)}
    return tree, build_spec(tree, folds=gpt3d_logical_folds(tree))


def test_restore_train_stack_for_serving_past_a_corrupt_step(tmp_path):
    root = str(tmp_path / "run")
    trees = {}
    for step in (3, 5):
        tree, spec = _train_state(step)
        CheckpointManager(root, sharded=True, spec=spec).save(tree, step)
        trees[step] = tree
    faults.corrupt_checkpoint(CheckpointManager(
        root, sharded=True).step_path(5))
    params, specs, step = restore_gpt_for_serving(
        root, CFG, with_step=True, device="cpu")
    assert step == 3
    want = trees[3]["params"]
    L = CFG.num_layers
    for a, b in zip(tree_leaves(want.layers), tree_leaves(params.layers)):
        assert b.shape[:2] == (L, 1)
        assert torch.equal(a.reshape((L,) + a.shape[2:]),
                           b.reshape((L,) + b.shape[2:]))
    for a, b in zip(tree_leaves(want.embedding) + tree_leaves(want.final_ln),
                    tree_leaves(params.embedding)
                    + tree_leaves(params.final_ln)):
        assert torch.equal(a, b)
    assert specs.embedding["word_embeddings"]["embedding"] == ("tp", None)
    restored = ServingEngine(CFG, ServingConfig(**SERVING), params,
                             device="cpu")
    memory = ServingEngine(CFG, ServingConfig(**SERVING), want,
                           device="cpu")
    assert _serve(restored, WAVE) == _serve(memory, WAVE)
    with pytest.raises(FileNotFoundError, match="restorable for serving"):
        restore_gpt_for_serving(str(tmp_path / "empty"), CFG, device="cpu")


def test_restore_adapter_round_trip_with_corrupt_fallback(tmp_path):
    """Two adapter steps, the newest torn: the port's and the
    reference's restore fall back to the intact step with the weights
    bit for bit, and the port's engine registers them."""
    from apex_tpu.serving.lora import LoRAConfig as JaxLoRAConfig
    from apex_tpu.serving.lora import (
        restore_adapter_for_serving as j_restore_adapter,
    )
    from apex_tpu.transformer.testing.standalone_transformer_lm import (
        TransformerConfig as JaxTransformerConfig,
    )

    lora = LoRAConfig(rank=4, max_adapters=2)
    root = str(tmp_path / "adapters")

    def tree(seed):
        w = init_adapter_weights(CFG, lora, seed=seed)
        return w, {"lora": {proj: {"a": torch.from_numpy(a),
                                   "b": torch.from_numpy(b)}
                            for proj, (a, b) in w.items()}}

    mgr = CheckpointManager(root, sharded=False)
    w0, t0 = tree(seed=0)
    mgr.save(t0, 0)
    _, t1 = tree(seed=1)
    path1 = mgr.save(t1, 1)
    with open(path1, "r+b") as f:             # torn newest
        f.seek(0)
        f.write(b"\x00" * 64)
    weights, step = restore_adapter_for_serving(
        root, CFG, lora, sharded=False, with_step=True)
    assert step == 0
    jweights, jstep = j_restore_adapter(
        root, JaxTransformerConfig(**GPT), JaxLoRAConfig(rank=4,
                                                         max_adapters=2),
        sharded=False, with_step=True)
    assert jstep == 0
    shapes = adapter_shapes(CFG, lora)
    for proj, (a, b) in weights.items():
        np.testing.assert_array_equal(a, w0[proj][0], err_msg=proj)
        np.testing.assert_array_equal(b, w0[proj][1], err_msg=proj)
        np.testing.assert_array_equal(a, jweights[proj][0])
        np.testing.assert_array_equal(b, jweights[proj][1])
        assert a.shape == (CFG.num_layers,) + shapes[proj][0]
    eng = ServingEngine(CFG, ServingConfig(**SERVING, lora=lora),
                        init_gpt_params(CFG, 0, device="cpu"), device="cpu")
    slot = eng.register_adapter("restored", weights=weights)
    assert 0 < slot < eng.lora.n_slots
    with pytest.raises(FileNotFoundError, match="no adapter checkpoint"):
        restore_adapter_for_serving(str(tmp_path / "empty"), CFG, lora,
                                    sharded=False)


def test_replica_engine_from_ckpt_dir_reports_its_step(tmp_path):
    """``_build_engine`` with ``ckpt_dir`` restores the newest intact step
    and reports it; the engine serves the restored weights' streams."""
    root = str(tmp_path / "run")
    tree, spec = _train_state(4)
    CheckpointManager(root, sharded=True, spec=spec).save(tree, 4)
    rspec = ReplicaSpec(config=CFG, serving=ServingConfig(**SERVING),
                        ckpt_dir=root, device="cpu")
    engine, step = _build_engine(rspec, MetricRegistry(), None)
    assert step == 4
    memory = ServingEngine(CFG, ServingConfig(**SERVING),
                           tree["params"], device="cpu")
    assert _serve(engine, WAVE[:2]) == _serve(memory, WAVE[:2])


def test_fused_adam_opt_state_is_the_reference_tree(tmp_path):
    """``opt_state`` is the reference's ``OptState`` (paths ``.step``,
    ``.slots/exp_avg/...``; ``master`` only with master weights): a
    stepped port optimizer's checkpoint restores into the reference's
    ``FusedAdam.init`` template, and ``load_opt_state`` puts it back."""
    import jax
    import jax.numpy as jnp

    from apex_tpu import checkpoint as jck
    from apex_tpu.optimizers import FusedAdam as JaxAdam

    from apex_tpu_torch.optimizers import FusedAdam

    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(4, 3, generator=gen).requires_grad_(True),
              "b": torch.randn(3, generator=gen).requires_grad_(True)}
    for master in (False, True):
        opt = FusedAdam(tree_leaves(params), lr=1e-2, master_weights=master)
        for _ in range(2):
            for p in tree_leaves(params):
                p.grad = torch.ones_like(p)
            opt.step()
        state = opt.opt_state(params)
        assert int(state.step) == 2 and state.step.dtype == torch.int32
        path = str(tmp_path / f"o{master}.npz")
        ckpt.save_checkpoint(path, {"opt": state}, step=2)
        paths = [r["path"] for r in ckpt.verify_checkpoint(path)["leaves"]]
        jparams = {k: jnp.asarray(v.detach().numpy())
                   for k, v in params.items()}
        like = {"opt": JaxAdam(lr=1e-2, master_weights=master).init(jparams)}
        assert paths == [jck._path_str(p) for p, _ in
                         jax.tree_util.tree_leaves_with_path(like)]
        got, _ = jck.restore_checkpoint(path, like)
        assert int(got["opt"].step) == 2
        for k in params:
            np.testing.assert_array_equal(
                np.asarray(got["opt"].slots["exp_avg"][k]),
                opt.state[params[k]]["exp_avg"].numpy())
        fresh = FusedAdam(tree_leaves(params), lr=1e-2,
                          master_weights=master)
        fresh.load_opt_state(params, state)
        assert int(fresh.param_groups[0]["step"]) == 2
        for k in params:
            for s in opt.state[params[k]]:
                assert torch.equal(fresh.state[params[k]][s],
                                   opt.state[params[k]][s])


def _losses(path):
    with open(path) as f:
        return f.read().splitlines()


def _main(argv):
    """``crash_resume.main`` in this process, leaving torch's global
    determinism switch as it found it."""
    before = torch.are_deterministic_algorithms_enabled()
    try:
        assert crash_resume.main(argv) == 0
    finally:
        torch.use_deterministic_algorithms(before)


def test_crash_resume_after_sigkill_is_bit_exact(tmp_path):
    common = ["--config", "tiny", "--device", "cpu", "--steps", "6",
              "--save-every", "2"]
    ref = tmp_path / "ref"
    _main(["--ckpt-dir", str(ref), "--losses", str(tmp_path / "ref.txt"),
           "--fingerprint", str(tmp_path / "ref.fp")] + common)
    want = _losses(tmp_path / "ref.txt")
    assert [ln.split()[0] for ln in want] == [str(i) for i in range(1, 7)]

    run = tmp_path / "run"
    losses = tmp_path / "run.txt"
    env = dict(os.environ, PYTHONPATH=REPO)
    child = subprocess.Popen(
        [sys.executable, "-m", "apex_tpu_torch.testing.crash_resume",
         "--ckpt-dir", str(run), "--losses", str(losses),
         "--step-delay", "1.0"] + common, env=env, cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    commit = run / "step_00000004" / "manifest.json"
    deadline = time.monotonic() + 120
    try:
        while not commit.exists():
            assert child.poll() is None, child.stderr.read().decode()
            assert time.monotonic() < deadline, "no commit of step 4"
            time.sleep(0.02)
        child.send_signal(signal.SIGKILL)
    finally:
        child.kill()
        child.wait()
    assert child.returncode == -signal.SIGKILL
    mgr = CheckpointManager(str(run), sharded=True)
    assert [s for s in mgr.all_steps() if mgr._is_committed(s)][-1] == 4
    got = _losses(losses)
    assert got == want[:len(got)]

    _main(["--ckpt-dir", str(run), "--losses", str(losses), "--resume",
           "--fingerprint", str(tmp_path / "run.fp")] + common)
    assert _losses(losses) == want
    assert _losses(tmp_path / "run.fp") == _losses(tmp_path / "ref.fp")

    assert mgr.all_steps()[-1] == 6
    faults.corrupt_checkpoint(mgr.step_path(6))
    _main(["--ckpt-dir", str(run), "--losses", str(losses), "--resume",
           "--fingerprint", str(tmp_path / "run2.fp")] + common)
    assert _losses(losses) == want
    assert _losses(tmp_path / "run2.fp") == _losses(tmp_path / "ref.fp")
