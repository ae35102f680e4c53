"""Carry a JAX GPT checkpoint's weights into the port.

:func:`from_jax_params` takes the JAX package's ``GPT3DParams`` tree
(``embedding``, ``layers``, ``final_ln``) with numpy leaves (or anything
``numpy.asarray`` reads, such as JAX arrays) and returns the port's
:class:`~apex_tpu_torch.transformer.testing.gpt_parallel_train.GPT3DParams`
of CPU tensors, the layer stack merged from ``[vpp, pp, ...]`` to
``[L, ...]`` when it arrives in the pipeline form.

The leaves keep their names, values and layouts.  The JAX package's
parallel linears already store their kernels ``[out, in]``
(``ColumnParallelLinear`` and ``RowParallelLinear`` compute
``x @ kernel.T``), which is the port's layout too, so nothing is
transposed; and the fused QKV kernel keeps its group-major column order
(per K/V group its query heads, then one K and one V head), which the
decode model's split relies on.

:func:`from_flax_gpt` does the same for the parameter tree of a Flax
``GPTModel`` (``params["language_model"]["embedding" | "encoder"]``),
stacking its ``layers_<i>`` subtrees into the ``[L, ...]`` layer stack,
for :meth:`apex_tpu_torch.transformer.testing.standalone_gpt.GPTModel.
load_params` (or the serving engine).

:func:`from_flax_norm` turns a Flax norm module's parameters (``scale``
and, for LayerNorm, ``bias``) into the state dict of the port's module
of the same name (:mod:`apex_tpu_torch.normalization`).

:func:`from_flax_fp8_meta` turns the ``"fp8_meta"`` collection of an fp8
Flax model (its ``{"metas": {"x", "w"}}`` of ``Fp8Meta(amax_history,
scale)`` per layer) into the port's fp8 buffers by layer path, for
:meth:`~apex_tpu_torch.transformer.testing.standalone_gpt.GPTModel.
load_fp8_meta` or ``load_state_dict(..., strict=False)``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
    GPT3DParams,
    merge_layer_stack,
)

__all__ = ["from_jax_params", "from_flax_gpt", "from_flax_norm",
           "from_flax_fp8_meta"]


def _tree(tree) -> dict:
    if isinstance(tree, Mapping):
        return {str(k): _tree(v) for k, v in tree.items()}
    a = np.array(tree, copy=True)
    if a.dtype.name == "bfloat16":      # numpy has no bf16 of its own
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _part(tree: Any, name: str):
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def from_jax_params(tree: Any) -> GPT3DParams:
    """The port's parameters from a JAX ``GPT3DParams`` (or a dict with
    the same three keys)."""
    embedding = _tree(_part(tree, "embedding"))
    layers = _tree(_part(tree, "layers"))
    final_ln = _tree(_part(tree, "final_ln"))
    scale = layers["input_layernorm"]["scale"]
    num_layers = int(np.prod(scale.shape[:-1]))
    return GPT3DParams(embedding=embedding,
                       layers=merge_layer_stack(layers, num_layers),
                       final_ln=final_ln)


def from_flax_gpt(params: Any) -> GPT3DParams:
    """The port's parameters from a Flax ``GPTModel``'s ``params`` tree
    (numpy leaves, or anything ``numpy.asarray`` reads)."""
    lm = _part(params, "language_model")
    encoder = _tree(_part(lm, "encoder"))
    n = sum(1 for k in encoder if k.startswith("layers_"))
    per_layer = [encoder[f"layers_{i}"] for i in range(n)]

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    return GPT3DParams(embedding=_tree(_part(lm, "embedding")),
                       layers=stack(per_layer),
                       final_ln=encoder["final_layernorm"])


def from_flax_norm(params: Any) -> dict:
    """The state dict of the port's ``FusedLayerNorm``/``FusedRMSNorm``
    (and their mixed variants) from the Flax module's parameters: its
    ``{"scale", "bias"}`` leaves, or the ``{"params": ...}`` tree that
    ``init`` returns."""
    if isinstance(params, Mapping) and "params" in params:
        params = params["params"]
    return {name: _tree(params[name]) for name in ("scale", "bias")
            if name in params}


def _module_name(flax_name: str) -> str:
    """A Flax scope name in the port: ``layers_<i>`` is ``layers.<i>``
    (a ``ModuleList``), ``metas`` is the linear's ``fp8_meta``."""
    if flax_name.startswith("layers_"):
        return flax_name.replace("_", ".", 1)
    return "fp8_meta" if flax_name == "metas" else flax_name


def from_flax_fp8_meta(collection: Any) -> dict:
    """The port's fp8 buffers (``{"...query_key_value.fp8_meta.x.scale":
    tensor, ...}``) from a Flax ``"fp8_meta"`` collection whose leaves are
    numpy arrays (or anything ``numpy.asarray`` reads) and whose metas are
    ``Fp8Meta`` named tuples or mappings of their two fields."""
    out = {}

    def walk(node, path):
        if hasattr(node, "_asdict"):             # an Fp8Meta
            node = node._asdict()
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + [_module_name(str(k))])
        else:
            out[".".join(path)] = _tree(node)

    walk(collection, [])
    return out
