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

:func:`from_flax_gpt_cp` takes the tree of the JAX package's
context-parallel harness (``build_gpt_cp``'s ``{"embedding", "layer_<i>",
"final_ln"}``) into the port's tree of the same keys, for
:func:`apex_tpu_torch.transformer.testing.gpt_cp_train.build_gpt_cp`'s
``init_fn(params=...)``.

Mixture-of-experts layers carry their ``mlp/{router, w1, b1, w2, b2}``
leaves at the reference's layout (``router [h, E]``, ``w1 [E, h, ffn]``,
``w2 [E, ffn, h]``), which :class:`~apex_tpu_torch.transformer.moe.
SwitchMLP` keeps, so they pass through every function here as they are.

:func:`from_flax_norm` turns a Flax norm module's parameters (``scale``
and, for LayerNorm, ``bias``) into the state dict of the port's module
of the same name (:mod:`apex_tpu_torch.normalization`).

:func:`from_flax_bert` turns a Flax ``BertModel``'s ``params`` into the
state dict of :class:`~apex_tpu_torch.transformer.testing.BertModel`:
the parallel linears, norms and embeddings pass through under their
names (``layers_<i>`` becomes ``layers.<i>``), while the Flax
``nn.Dense`` layers, the pooler's ``dense``, ``lm_head/dense`` and
``binary_head``, store ``kernel [in, out]`` and become ``nn.Linear``
weights ``[out, in]``, transposed.  :func:`from_flax_multihead_attn`
does the same for :mod:`apex_tpu_torch.contrib.multihead_attn`'s
modules, whose projections are all ``nn.Dense`` and whose ``lyr_nrm``
keeps ``scale`` and ``bias``.

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

__all__ = ["from_jax_params", "from_flax_gpt", "from_flax_gpt_cp",
           "from_flax_norm", "from_flax_fp8_meta", "from_flax_bert",
           "from_flax_multihead_attn"]


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


def from_flax_gpt_cp(params: Any) -> dict:
    """The port's context-parallel parameters from the JAX harness's
    ``{"embedding", "layer_<i>", "final_ln"}`` tree (numpy leaves, or
    anything ``numpy.asarray`` reads)."""
    if not isinstance(params, Mapping) or "embedding" not in params:
        raise ValueError("expected build_gpt_cp's {'embedding', "
                         "'layer_<i>', 'final_ln'} tree")
    return _tree(params)


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


# the Flax ``nn.Dense`` scopes of a BertModel, by their path
_BERT_DENSE = ("language_model.pooler.dense", "lm_head.dense", "binary_head")


def _flax_state(tree, dense) -> dict:
    """A Flax parameter tree as a flat state dict: scope names through
    :func:`_module_name`, and in the scopes ``dense(path)`` names,
    ``kernel [in, out]`` as ``weight [out, in]``."""
    out = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + [_module_name(str(k))])
            return
        scope, leaf = ".".join(path[:-1]), path[-1]
        t = _tree(node)
        if dense(scope) and leaf == "kernel":
            leaf, t = "weight", t.t().contiguous()
        out[".".join(filter(None, [scope, leaf]))] = t

    walk(tree, [])
    return out


def from_flax_bert(params: Any) -> dict:
    """The state dict of the port's ``BertModel`` from a Flax
    ``BertModel``'s ``params`` tree (numpy leaves, or anything
    ``numpy.asarray`` reads)."""
    return _flax_state(params, lambda scope: scope in _BERT_DENSE)


def from_flax_multihead_attn(params: Any) -> dict:
    """The state dict of the port's ``SelfMultiheadAttn`` or
    ``EncdecMultiheadAttn`` from the Flax module's ``params`` tree (its
    ``in_proj`` or ``q_proj``/``kv_proj``, ``out_proj`` and, with
    ``include_norm_add``, ``lyr_nrm``)."""
    return _flax_state(params, lambda scope: scope.endswith("_proj"))
