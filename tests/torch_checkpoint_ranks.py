"""Rank-side half of the port's checkpoint parity test
(``test_torch_checkpoint.py``).

:func:`checkpoint_cases` runs on the four ranks of a gloo group started
by :func:`apex_tpu_torch.parallel.launch.start_multiprocess`.  On the
(pp 2, tp 2, sequence-parallel) grid each rank places the numpy train
state the test sends (``build_gpt_3d``'s ``init_fn``), saves it sharded
(sync and async) and flat, and restores the reference's checkpoints of
the same state; on the (dp 2, tp 2) grid it restores them again with the
layer stack re-factored to ``[vpp 2, pp 1]``, and serves the port's own
checkpoint at tp = 2 through ``restore_gpt_for_serving``.  Torch and the
port only: the spawned ranks never import JAX.
"""

import torch
import torch.distributed as dist

from apex_tpu_torch import checkpoint as ckpt
from apex_tpu_torch import parallel
from apex_tpu_torch.amp._tree import tree_leaves
from apex_tpu_torch.amp.scaler import DynamicLossScale
from apex_tpu_torch.optimizers._common import OptState
from apex_tpu_torch.parallel.mesh import get_data_parallel_rank
from apex_tpu_torch.resilience import (
    CheckpointManager,
    build_spec,
    restore_resharded,
    sentinel_init,
)
from apex_tpu_torch.serving import (
    ServingConfig,
    ServingEngine,
    restore_gpt_for_serving,
)
from apex_tpu_torch.transformer.tensor_parallel.partition import (
    PartitionSpec,
)
from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
    GPT3DParams,
    build_gpt_3d,
    gpt3d_logical_folds,
)
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    TransformerConfig,
)


def _pack(cfg, spec, num_chunks, mesh):
    """This rank's train state and its ShardingSpec: the params, an
    ``OptState`` whose slots are the test's numpy trees, the sentinel."""
    init_fn, _, _ = build_gpt_3d(cfg, num_chunks=num_chunks,
                                 num_microbatches=1, device="cpu")
    params, specs = init_fn(params=GPT3DParams(**spec["tree"]))
    m, _ = init_fn(params=GPT3DParams(**spec["exp_avg"]))
    v, _ = init_fn(params=GPT3DParams(**spec["exp_avg_sq"]))
    pack = {"params": params,
            "opt": OptState(step=torch.tensor(spec["opt_step"],
                                              dtype=torch.int32),
                            slots={"exp_avg": m, "exp_avg_sq": v},
                            master=None),
            "sent": sentinel_init(DynamicLossScale(), "cpu")}
    rep = PartitionSpec()
    pack_specs = {"params": specs,
                  "opt": OptState(step=rep, slots={"exp_avg": specs,
                                                   "exp_avg_sq": specs},
                                  master=None),
                  "sent": rep}
    sspec = build_spec(pack, mesh=mesh, folds=gpt3d_logical_folds(pack),
                       specs=pack_specs)
    return pack, sspec


def _same(a, b) -> bool:
    la = [x for _, x in ckpt._leaves_with_path(a)]
    lb = [x for _, x in ckpt._leaves_with_path(b)]
    return len(la) == len(lb) and all(
        torch.equal(torch.as_tensor(x).detach(), torch.as_tensor(y).detach())
        for x, y in zip(la, lb))


def _serve(engine, wave):
    reqs, pending, step = [], list(wave), 0
    while pending or not engine.scheduler.idle:
        while pending and pending[0][0] <= step:
            _, prompt, n_new = pending.pop(0)
            reqs.append(engine.submit(prompt, n_new))
        engine.step()
        step += 1
        assert step < 500, "wave did not drain"
    return [r.output_tokens for r in reqs]


def checkpoint_cases(spec):
    rank = dist.get_rank()
    out = {"rank": rank}
    d = spec["dirs"]
    cfg = TransformerConfig(**spec["model"], hidden_dropout=0.0,
                            attention_dropout=0.0, tensor_axis="tp",
                            sequence_parallel=True)

    # the training grid: pp 2 x tp 2 (sequence parallel), one chunk each
    mesh = parallel.initialize_model_parallel(
        tensor_model_parallel_size=2, pipeline_model_parallel_size=2)
    pack, sspec = _pack(cfg, spec, 1, mesh)
    out["spec"] = sspec.to_json()
    ckpt.save_checkpoint_sharded(d["port_sharded"], pack, step=5,
                                 spec=sspec)
    ckpt.save_checkpoint_sharded_async(d["port_async"], pack, step=5,
                                       spec=sspec).finalize(timeout=60)
    ckpt.save_checkpoint(d["port_flat"], pack, step=5, spec=sspec)
    CheckpointManager(d["port_mgr"], sharded=True, spec=sspec).save(pack, 7)
    got, step = ckpt.restore_checkpoint_sharded(d["ref_sharded"], pack,
                                                spec=sspec)
    out["restore_sharded"] = (step, _same(got, pack))
    got, step = ckpt.restore_checkpoint(d["ref_flat"], pack, spec=sspec)
    out["restore_flat"] = (step, _same(got, pack))
    got, step = restore_resharded(d["ref_sharded"], pack, sspec)
    out["resharded_same_grid"] = (step, _same(got, pack))
    out["local_shapes"] = [list(x.shape) for x in tree_leaves(pack["params"])]
    parallel.destroy_model_parallel()

    # another grid: dp 2 x tp 2, the stack [vpp 2, pp 1]
    mesh = parallel.initialize_model_parallel(tensor_model_parallel_size=2)
    pack2, sspec2 = _pack(cfg, spec, 2, mesh)
    got, step = restore_resharded(d["ref_sharded"], pack2, sspec2)
    out["resharded_other_grid"] = (step, _same(got, pack2))

    # a leaf the source splits over dp and the target's spec gives no
    # record: placed as the target's spec says, whole on every rank
    full = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    dp = get_data_parallel_rank()
    split = {"w": full[4 * dp:4 * dp + 4].clone()}
    ckpt.save_checkpoint_sharded(
        d["port_split"], split, step=2,
        spec=build_spec(split, mesh=mesh,
                        specs={"w": PartitionSpec("dp", None)}))
    whole = {"w": torch.zeros(8, 3)}
    got, step = restore_resharded(d["port_split"], whole,
                                  build_spec(whole, mesh=mesh))
    out["replicated_from_split"] = (step, torch.equal(got["w"], full))

    # serving at tp 2 from the port's own training checkpoint
    serve_cfg = TransformerConfig(**spec["model"], hidden_dropout=0.0,
                                  attention_dropout=0.0)
    params, _, step = restore_gpt_for_serving(
        d["port_mgr"], serve_cfg, mesh=mesh, with_step=True, device="cpu")
    out["serving_step"] = step
    engine = ServingEngine(serve_cfg, ServingConfig(**spec["serving"]),
                           params, mesh=mesh, device="cpu")
    out["streams"] = _serve(engine, spec["wave"])
    out["serving_stack"] = list(params.layers["input_layernorm"]["scale"]
                                .shape)
    parallel.destroy_model_parallel()
    return out

