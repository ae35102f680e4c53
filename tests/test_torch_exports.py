"""The port's packages export what the JAX package's do.

For every public name of ``apex_tpu.ops``, ``apex_tpu.serving``,
``apex_tpu.amp``, ``apex_tpu.parallel``, ``apex_tpu.transformer``,
``apex_tpu.transformer.tensor_parallel``,
``apex_tpu.transformer.context_parallel``, ``apex_tpu.transformer.moe``,
``apex_tpu.transformer.testing``, ``apex_tpu.observability``,
``apex_tpu.resilience``, ``apex_tpu.optimizers``, ``apex_tpu.models``,
``apex_tpu.utils`` and ``apex_tpu.data`` (its ``__all__``, or else every
name without a leading underscore once its submodules are imported), the
port's package of the same place holds an object
of the same kind: a function stays a function, a class a class, a module a
module, a dtype a dtype.  Names whose modules are still queued in
``ROADMAP.md`` section A are left out, each with its item, and so are
the names with no counterpart in eager PyTorch (``NO_COUNTERPART``, each
with its reason); each of them must still be missing, so the lists can
only shrink.
"""

import importlib
import pkgutil
import types

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

PAIRS = ["ops", "serving", "amp", "parallel", "transformer",
         "transformer.tensor_parallel", "transformer.context_parallel",
         "transformer.moe", "transformer.testing", "observability",
         "resilience", "optimizers", "models", "utils", "data"]

# name -> the ROADMAP.md section A item that ports its module
QUEUED = {
    "ops": {
        # ops/dense.py and ops/mlp.py
        "dense": "A.4", "FusedDense": "A.4", "FusedDenseGeluDense": "A.4",
        "fused_dense": "A.4", "fused_dense_gelu_dense": "A.4",
        "mlp": "A.4", "MLP": "A.4", "mlp_forward": "A.4",
    },
    "serving": {},
    "amp": {},
    "parallel": {
        # the ZeRO pair of distributed.py
        "zero_init": "A.5", "zero_data_parallel_train_step": "A.5",
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
    },
    "resilience": {},
    "optimizers": {},
    "models": {},
    "utils": {
        # utils/random.py, utils/timers.py and utils/flatten.py
        "random": "A.6", "RngPolicy": "A.6", "model_parallel_rngs": "A.6",
        "fold_in_axis": "A.6", "timers": "A.6", "Timers": "A.6",
        "get_timers": "A.6", "flatten": "A.6",
    },
    "data": {
        # the rest of data/image_folder.py, data/packed.py,
        # data/prefetch.py, data/service.py and data/sequence.py
        "ImageFolder": "A.4", "ImageFolderLoader": "A.4",
        "center_crop_resize": "A.4", "random_resized_crop": "A.4",
        "sample_crop_box": "A.4", "PackedImageDataset": "A.4",
        "PackedLoader": "A.4", "pack_image_folder": "A.4",
        "DevicePrefetcher": "A.4", "prefetch_to_device": "A.4",
        "DataService": "A.4", "PackedSequenceDataset": "A.4",
        "PackedSequenceLoader": "A.4", "pack_token_documents": "A.4",
        "synthetic_token_documents": "A.4",
    },
}

# name -> why eager PyTorch has no counterpart
NO_COUNTERPART = {
    "observability": {
        "compiled_flops": "reads XLA's cost analysis of a compiled "
                          "program; the serving engine counts its FLOPs "
                          "from its shapes",
    },
    "utils": {
        "platform": "probes JAX backends (the TPU plugin, the CPU "
                    "platform's device count); the port's device rule is "
                    "apex_tpu_torch._device.resolve_device",
        "tuning": "adopts tuned Pallas block sizes recorded for a TPU "
                  "generation; the port's kernels tile by fixed sizes",
    },
}


def _public(module):
    """``__all__``, or every name without a leading underscore after each
    submodule of the package is imported: a submodule becomes a name of
    its package when anything imports it, so without that the names
    would depend on what other tests of the worker imported first."""
    names = getattr(module, "__all__", None)
    if names is None:
        for sub in pkgutil.iter_modules(getattr(module, "__path__", [])):
            importlib.import_module(f"{module.__name__}.{sub.name}")
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
