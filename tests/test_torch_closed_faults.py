"""Surface faults of the port against the reference, each pinned where it
was closed: ``parallel_lm_logits``'s ``bias``, ``dp_shard_batch``'s
``local_ranks`` at world size 1, and ``run_multiprocess``'s script form
(the reference's contract: ``CompletedProcess`` results).  The LoRA A/B
switch is pinned in ``test_torch_lora.py``, the two-rank ``local_ranks``
case in ``test_torch_tensor_parallel.py``'s spawn."""

import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu import parallel as jparallel
from apex_tpu.parallel.distributed import dp_shard_batch as j_shard
from apex_tpu.parallel.distributed import host_dp_ranks as j_host_dp_ranks
from apex_tpu.transformer.testing.standalone_transformer_lm import (
    TransformerConfig as JaxConfig,
    parallel_lm_logits as j_lm_logits,
)
from apex_tpu_torch import parallel
from apex_tpu_torch.parallel.launch import run_multiprocess
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    TransformerConfig,
    parallel_lm_logits,
)
from torch_threads import one_torch_thread  # noqa: F401


def test_parallel_lm_logits_adds_its_bias_as_jax():
    """The tied head with a non-zero ``[vocab]`` bias (BERT's), and
    without one, against JAX's on the same operands."""
    kw = dict(num_layers=1, hidden_size=16, num_attention_heads=2,
              padded_vocab_size=40)
    rng = np.random.default_rng(5)
    hidden = rng.standard_normal((3, 2, 16)).astype(np.float32)
    table = rng.standard_normal((40, 16)).astype(np.float32)
    bias = rng.standard_normal((40,)).astype(np.float32)
    jcfg, tcfg = JaxConfig(**kw), TransformerConfig(**kw)
    jparallel.initialize_model_parallel(devices=jax.devices()[:1])
    try:
        for b in (bias, None):
            want = np.asarray(j_lm_logits(
                jnp.asarray(hidden), jnp.asarray(table), jcfg,
                None if b is None else jnp.asarray(b)))
            got = parallel_lm_logits(
                torch.from_numpy(hidden), torch.from_numpy(table), tcfg,
                None if b is None else torch.from_numpy(b))
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5,
                                       rtol=1e-5)
    finally:
        jparallel.destroy_model_parallel()
    assert not np.allclose(want, np.asarray(j_lm_logits(
        jnp.asarray(hidden), jnp.asarray(table), jcfg, jnp.asarray(bias))))


def test_dp_shard_batch_local_ranks_at_world_size_one():
    """The smallest input that was a ``TypeError``:
    ``dp_shard_batch(x, local_ranks=host_dp_ranks())`` in a one-process
    group keeps the host's rows, as JAX's one-process placement does; a
    rank outside ``local_ranks`` raises."""
    x = np.arange(12, dtype=np.int32).reshape(6, 2)
    jparallel.initialize_model_parallel(devices=jax.devices()[:1])
    try:
        want = np.asarray(j_shard(x, local_ranks=j_host_dp_ranks()))
    finally:
        jparallel.destroy_model_parallel()
    parallel.initialize_distributed(device="cpu")
    try:
        parallel.initialize_model_parallel()
        assert parallel.host_dp_ranks() == [0]
        got = parallel.dp_shard_batch(torch.from_numpy(x),
                                      local_ranks=parallel.host_dp_ranks())
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            parallel.dp_shard_batch(torch.from_numpy(x),
                                    local_ranks=[0, 1, 2]).numpy(), x[:2])
        with pytest.raises(ValueError, match="not among"):
            parallel.dp_shard_batch(torch.from_numpy(x), local_ranks=[1])
    finally:
        parallel.destroy_model_parallel()
        dist.destroy_process_group()


_RANK_SCRIPT = textwrap.dedent("""
    import os, sys
    import torch
    import torch.distributed as dist
    from apex_tpu_torch.parallel.launch import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(device="cpu")
    rank = dist.get_rank()
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    print(rank, dist.get_world_size(), int(t.item()), os.environ["EXTRA"],
          *sys.argv[1:])
    dist.destroy_process_group()
""")
# a rank that fails, without the cost of importing torch
_FAILING_SCRIPT = "import os, sys\nsys.exit(os.environ['PROCESS_ID'] == '1')\n"


def test_run_multiprocess_runs_a_script_as_the_reference(tmp_path):
    """A path runs ``num_processes`` ranks of ``python script
    *script_args`` with the environment ``initialize_distributed`` reads
    plus ``extra_env``, and returns their ``CompletedProcess`` results;
    a rank that exits non-zero raises; a device count other than the
    port's one a rank raises."""
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT)
    root = str(__import__("pathlib").Path(__file__).resolve().parents[1])
    env = {"EXTRA": "x", "PYTHONPATH": root}
    results = run_multiprocess(str(script), num_processes=2,
                               extra_env=env, script_args=["a", "b"],
                               timeout=120.0)
    assert [r.returncode for r in results] == [0, 0]
    assert [r.args[0] for r in results] == [sys.executable] * 2
    lines = sorted(r.stdout.decode().split() for r in results)
    assert lines == [["0", "2", "3", "x", "a", "b"],
                     ["1", "2", "3", "x", "a", "b"]]
    failing = tmp_path / "fail.py"
    failing.write_text(_FAILING_SCRIPT)
    with pytest.raises(RuntimeError, match="rank 1: 1"):
        run_multiprocess(str(failing), 2, timeout=120.0)
    with pytest.raises(ValueError, match="one device"):
        run_multiprocess(str(script), 2, devices_per_process=4)
