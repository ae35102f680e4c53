"""The port's packages export what the JAX package's do.

For every public name of ``apex_tpu.ops``, ``apex_tpu.serving``,
``apex_tpu.amp``, ``apex_tpu.parallel``, ``apex_tpu.transformer``,
``apex_tpu.transformer.tensor_parallel``,
``apex_tpu.transformer.context_parallel``, ``apex_tpu.transformer.moe``,
``apex_tpu.transformer.testing``, ``apex_tpu.observability`` and
``apex_tpu.resilience`` (its ``__all__``, or else every name without a
leading underscore), the port's package of the same place holds an object
of the same kind: a function stays a function, a class a class, a module a
module, a dtype a dtype.  Names whose modules are still queued in
``ROADMAP.md`` section A are left out, each with its item, and so are
the names with no counterpart in eager PyTorch (``NO_COUNTERPART``, each
with its reason); each of them must still be missing, so the lists can
only shrink.
"""

import importlib
import types

import numpy as np
import pytest
import torch

PAIRS = ["ops", "serving", "amp", "parallel", "transformer",
         "transformer.tensor_parallel", "transformer.context_parallel",
         "transformer.moe", "transformer.testing", "observability",
         "resilience"]

# name -> the ROADMAP.md section A item that ports its module
QUEUED = {
    "ops": {
        # ops/dense.py and ops/mlp.py
        "dense": "A.4", "FusedDense": "A.4", "FusedDenseGeluDense": "A.4",
        "fused_dense": "A.4", "fused_dense_gelu_dense": "A.4",
        "mlp": "A.4", "MLP": "A.4", "mlp_forward": "A.4",
    },
    "serving": {
        # serving/{autopilot,fleet,replica,transport,loader}.py and the
        # engine's checkpoint restores
        "AutopilotConfig": "A.3", "FleetAutopilot": "A.3",
        "trace_attribution": "A.3",
        "FleetRequest": "A.3", "FleetRouter": "A.3",
        "ReplicaProcess": "A.3", "ReplicaSpec": "A.3",
        "SocketTransport": "A.3", "TransportError": "A.3",
        "TransportServer": "A.3", "replica_serve": "A.3",
        "start_replica_server": "A.3",
        "restore_gpt_for_serving": "A.3",
        "restore_adapter_for_serving": "A.3",
    },
    "amp": {},
    "parallel": {
        # parallel/sync_batchnorm.py, the ZeRO pair of distributed.py and
        # optimizers/larc.py
        "SyncBatchNorm": "A.4", "sync_batch_norm_stats": "A.4",
        "sync_batchnorm": "A.4", "zero_init": "A.4",
        "zero_data_parallel_train_step": "A.4", "LARC": "A.4",
    },
    "transformer": {},
    "transformer.tensor_parallel": {},
    "transformer.context_parallel": {},
    "transformer.moe": {},
    "transformer.testing": {
        # standalone_transformer_lm.py's pooler and standalone_bert.py
        "Pooler": "A.4", "BertModel": "A.4",
        "bert_extended_attention_mask": "A.4",
    },
    "observability": {
        # observability/trainstats.py
        "TrainStats": "A.3", "PartialTrainStats": "A.3",
        "TrainStatsLogger": "A.3", "train_stats": "A.3",
        "partial_train_stats": "A.3", "device_partial_norms": "A.3",
        "local_grad_stats": "A.3", "pack_local_stats": "A.3",
        "stats_from_reduced": "A.3", "stats_partition_specs": "A.3",
        # observability/spans.py
        "named_span": "A.3", "span": "A.3", "step_trace": "A.3",
        "TraceWindow": "A.3",
        # observability/writers.py
        "JsonlWriter": "A.3", "read_jsonl": "A.3", "iter_jsonl": "A.3",
        # observability/debug_server.py
        "DebugServer": "A.3", "render_openmetrics": "A.3",
        # observability/trace.py
        "TRACE_HOP_BUCKETS": "A.3", "estimate_offset": "A.3",
        "stitch_traces": "A.3", "summarize_traces": "A.3",
        "merge_dir": "A.3", "format_trace_report": "A.3",
        "collect_slo_events": "A.3",
        # observability/timeseries.py and slo.py
        "MetricHistory": "A.3", "match_series": "A.3",
        "SLOPolicy": "A.3", "SLOEvaluator": "A.3",
    },
    "resilience": {
        # resilience/manager.py and reshard.py
        "CheckpointManager": "A.4", "ShardingSpec": "A.4",
        "build_spec": "A.4", "load_logical": "A.4",
        "restore_resharded": "A.4",
    },
}

# name -> why eager PyTorch has no counterpart
NO_COUNTERPART = {
    "observability": {
        "compiled_flops": "reads XLA's cost analysis of a compiled "
                          "program; the serving engine counts its FLOPs "
                          "from its shapes",
    },
}


def _public(module):
    names = getattr(module, "__all__", None)
    if names is None:
        names = [n for n in dir(module) if not n.startswith("_")]
    return sorted(names)


def _kind(obj) -> str:
    if isinstance(obj, types.ModuleType):
        return "module"
    if isinstance(obj, torch.dtype) or (
            isinstance(obj, type)
            and isinstance(getattr(obj, "dtype", None), np.dtype)):
        return "dtype"          # torch.float8_e4m3fn; jnp.float8_e4m3fn
    if isinstance(obj, type):
        return "class"
    if callable(obj):
        return "function"
    return "value"


@pytest.mark.parametrize("package", PAIRS)
def test_every_ported_name_is_exported_with_its_kind(package):
    ref = importlib.import_module(f"apex_tpu.{package}")
    port = importlib.import_module(f"apex_tpu_torch.{package}")
    queued = {**QUEUED[package], **NO_COUNTERPART.get(package, {})}
    wrong = []
    for name in _public(ref):
        if name in queued:
            continue
        want = _kind(getattr(ref, name))
        got = _kind(getattr(port, name)) if hasattr(port, name) else "missing"
        if got != want:
            wrong.append(f"{name}: {got}, the reference's a {want}")
    assert not wrong, wrong
    assert set(queued) <= set(_public(ref))
    ported = sorted(n for n in queued if hasattr(port, n))
    assert not ported, f"ported, so take them off the queued list: {ported}"


def test_the_kinds_tell_the_reexports_apart():
    """The checks this file rests on: ``flash_attention`` is a function in
    both ``ops`` packages (the module it comes from is not), and fp8's
    dtypes are dtypes in both ``amp`` packages."""
    from apex_tpu import amp as jamp
    from apex_tpu import ops as jops
    from apex_tpu_torch import amp, ops

    assert _kind(ops.flash_attention) == _kind(jops.flash_attention) \
        == "function"
    assert _kind(importlib.import_module(
        "apex_tpu_torch.ops.flash_attention")) == "module"
    assert _kind(amp.E4M3) == _kind(jamp.E4M3) == "dtype"
    assert _kind(amp.Fp8Dense) == _kind(ops.AttnMaskType) == "class"
