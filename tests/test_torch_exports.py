"""The port's packages export what the JAX package's do.

For every public name of ``apex_tpu.ops``, ``apex_tpu.serving``,
``apex_tpu.amp``, ``apex_tpu.parallel``, ``apex_tpu.transformer`` and
``apex_tpu.transformer.tensor_parallel`` (its ``__all__``, or else every
name without a leading underscore), the port's package of the same place
holds an object of the same kind: a function stays a function, a class a class, a module a
module, a dtype a dtype.  Names whose modules are still queued in
``ROADMAP.md`` section A are left out, each with its item; each of them
must still be missing, so the list can only shrink.
"""

import importlib
import types

import numpy as np
import pytest
import torch

PAIRS = ["ops", "serving", "amp", "parallel", "transformer",
         "transformer.tensor_parallel"]

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
        # engine items of A.3 (the unfused paged attention, the restores)
        "AutopilotConfig": "A.3", "FleetAutopilot": "A.3",
        "trace_attribution": "A.3",
        "FleetRequest": "A.3", "FleetRouter": "A.3",
        "ReplicaProcess": "A.3", "ReplicaSpec": "A.3",
        "SocketTransport": "A.3", "TransportError": "A.3",
        "TransportServer": "A.3", "replica_serve": "A.3",
        "start_replica_server": "A.3",
        "restore_gpt_for_serving": "A.3",
        "restore_adapter_for_serving": "A.3",
        "paged_attention_decode_unfused": "A.3",
        "paged_prefill_attention_unfused": "A.3",
    },
    "amp": {},
    "parallel": {
        # parallel/sync_batchnorm.py, the ZeRO pair of distributed.py and
        # optimizers/larc.py
        "SyncBatchNorm": "A.4", "sync_batch_norm_stats": "A.4",
        "sync_batchnorm": "A.4", "zero_init": "A.4",
        "zero_data_parallel_train_step": "A.4", "LARC": "A.4",
    },
    "transformer": {
        # context parallelism
        "context_parallel": "A.2",
    },
    "transformer.tensor_parallel": {},
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
    queued = QUEUED[package]
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
