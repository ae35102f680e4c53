"""Standalone GPT (port of :mod:`apex_tpu.transformer.testing.standalone_gpt`).

:class:`GPTModel` is a causal :class:`TransformerLanguageModel` with the
embedding-tied LM head; with ``labels`` (the raw tokens, shifted here) it
returns per-token next-token losses ``[b, s - 1]``.  The loss flattens the
``[s, b, v]`` logits in their own s-major order (only the small labels and
losses are transposed) and feeds half logits to the fused cross entropy
in their storage dtype, with fp32 losses out (``half_to_float``); the big
logits tensor is never transposed or upcast as a whole.  At tensor-parallel
size tp > 1 the logits are this rank's vocabulary shard and the loss is
:func:`~apex_tpu_torch.transformer.tensor_parallel.vocab_parallel_cross_entropy`
over the tensor axis.
"""

from __future__ import annotations

import torch
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.amp._tree import tree_map
from apex_tpu_torch.ops.softmax import AttnMaskType
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.partition import (
    infer_param_specs,
    shard_params,
)
from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
    GPT3DParams,
    init_gpt_params,
    merge_layer_stack,
)
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    ParallelTransformerLayer,
    TransformerConfig,
    TransformerLanguageModel,
    parallel_lm_logits,
)

__all__ = ["GPTModel", "gpt_loss", "gpt_next_token_loss",
           "init_gpt_layer_stack", "functional_layer"]


def _put(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


class GPTModel(nn.Module):
    """GPT LM: causal transformer + embedding-tied logits.

    ``forward(input_ids [b, s])`` returns logits ``[s, b, vocab]``, or with
    ``labels`` the per-token next-token loss ``[b, s - 1]`` (fp32).
    ``generator`` (a ``torch.Generator`` on the model's device) turns
    dropout on; ``None`` is deterministic.  Parameters are zero until
    :meth:`load_params`; ``device`` defaults to the CUDA device."""

    def __init__(self, config: TransformerConfig, *, device=None):
        super().__init__()
        self.config = config
        self.language_model = TransformerLanguageModel(
            config, self_attn_mask_type=AttnMaskType.causal,
            device=resolve_device(device))

    def load_params(self, params: GPT3DParams) -> None:
        """Copy a :class:`GPT3DParams` in (layer stack ``[L, ...]`` or
        ``[vpp, pp, ...]``), cast to each parameter's dtype; the fp8
        buffers, if any, are left as they are.  At tensor-parallel size
        tp > 1 the leaves are this rank's shards
        (:func:`~apex_tpu_torch.transformer.tensor_parallel.shard_params`)."""
        n = self.config.num_layers
        state = _flatten(params.embedding, "language_model.embedding.")
        for name, t in _flatten(merge_layer_stack(params.layers, n)).items():
            for i in range(n):
                state[f"language_model.encoder.layers.{i}.{name}"] = t[i]
        state.update(_flatten(params.final_ln,
                              "language_model.encoder.final_layernorm."))
        missing, unexpected = self.load_state_dict(state, strict=False)
        missing = [k for k in missing if ".fp8_meta." not in k]
        if missing or unexpected:
            raise RuntimeError(
                f"load_params: missing {missing}, unexpected {unexpected}")

    def export_params(self, grads: bool = False) -> GPT3DParams:
        """The inverse of :meth:`load_params`: this rank's parameters (or,
        with ``grads``, their ``.grad``, ``None`` where there is none) as
        a :class:`GPT3DParams` with the layers stacked ``[L, ...]``,
        detached."""
        n = self.config.num_layers
        prefix = "language_model."
        tree = {"embedding": {}, "layers": {}, "final_ln": {}}
        per_layer = {}
        for name, p in self.named_parameters():
            t = p.grad if grads else p
            t = None if t is None else t.detach()
            parts = name[len(prefix):].split(".")
            if parts[0] == "embedding":
                _put(tree["embedding"], parts[1:], t)
            elif parts[1] == "final_layernorm":
                _put(tree["final_ln"], parts[2:], t)
            else:
                per_layer.setdefault(".".join(parts[3:]), [None] * n)[
                    int(parts[2])] = t
        for name, ts in per_layer.items():
            _put(tree["layers"], name.split("."),
                 None if any(t is None for t in ts) else torch.stack(ts))
        return GPT3DParams(**tree)

    def fp8_meta_state(self) -> dict:
        """The fp8 linears' delayed-scaling buffers, by name (empty
        without ``config.fp8``)."""
        return {k: v for k, v in self.state_dict().items()
                if ".fp8_meta." in k}

    def load_fp8_meta(self, metas: dict) -> None:
        """Load every fp8 buffer from ``metas`` (as
        :func:`~apex_tpu_torch.serving.bridge.from_flax_fp8_meta` or
        :meth:`fp8_meta_state` gives them); a missing or unknown name
        raises."""
        want = set(self.fp8_meta_state())
        if set(metas) != want:
            raise RuntimeError(
                f"load_fp8_meta: missing {sorted(want - set(metas))}, "
                f"unexpected {sorted(set(metas) - want)}")
        self.load_state_dict(metas, strict=False)

    def forward(self, input_ids, position_ids=None, attention_mask=None,
                labels=None, generator=None):
        cfg = self.config
        hidden = self.language_model(input_ids, position_ids, attention_mask,
                                     generator)
        logits = parallel_lm_logits(
            hidden, self.language_model.embedding.word_embeddings.embedding,
            cfg)
        if labels is None:
            return logits
        return gpt_next_token_loss(logits, labels, cfg)


def gpt_next_token_loss(logits, tokens, config: TransformerConfig):
    """Shifted LM objective: position ``t`` predicts token ``t + 1``.
    ``logits [s, b, v]``, ``tokens [b, s]`` raw -> losses ``[b, s - 1]``."""
    return gpt_loss(logits[:-1], tokens[:, 1:], config)


def gpt_loss(logits, labels, config: TransformerConfig):
    """Per-token LM loss ``[b, s]`` from ``[s, b, v]`` logits through the
    fused cross entropy (no padding label; fp32 losses), or at tp > 1
    from this rank's ``[s, b, v/tp]`` through the vocab-parallel one."""
    v = logits.shape[-1]
    flat = logits.reshape(-1, v)                      # [s*b, v], no copy
    labels_sb = labels.t().reshape(-1)                # [b, s] -> [s*b]
    if config.tp_world > 1:
        loss = vocab_parallel_cross_entropy(flat, labels_sb,
                                            axis=config.tensor_axis)
    else:
        loss = softmax_cross_entropy_loss(flat, labels_sb, padding_idx=-1,
                                          half_to_float=True)
    return loss.reshape(logits.shape[0], labels.shape[0]).t()


def functional_layer(module: nn.Module, params: dict, *args):
    """``module(*args)`` with its parameters taken from the nested dict
    ``params`` (the JAX package's names: ``{"self_attention":
    {"dense": {"kernel": ...}}}``); the module's own parameters are not
    used, and gradients flow to the tensors of ``params``."""
    return torch.func.functional_call(module, _flatten(params, ""), args)


def init_gpt_layer_stack(seed: int, config: TransformerConfig,
                         sample_hidden=None, sample_mask=None, *,
                         device=None):
    """Per-layer parameters for the pipelined GPT and the stage function
    the rotation schedule takes.

    Returns ``(make_stage_fn, per_layer_params)``: the ``num_layers``
    transformer layers' parameters (nested dicts, drawn from ``seed`` as
    :func:`init_gpt_params` draws them; at tensor-parallel size tp > 1
    this rank's shards), and ``make_stage_fn(mask=None, generator=None,
    segment_ids=None)``, which gives ``stage_fn(layer_params, x)``, one
    :class:`ParallelTransformerLayer` (causal) applied with those
    parameters.  Mask and dropout are bound per call of
    ``make_stage_fn``, not at init (``generator=None`` is
    deterministic).  The embedding and the loss head run outside the
    pipeline, on every pipeline rank.  ``sample_hidden`` and
    ``sample_mask`` are accepted for the JAX package's signature (its
    init traces them); the shapes come from ``config``."""
    del sample_hidden, sample_mask
    cfg = config
    device = resolve_device(device)
    layers = init_gpt_params(cfg, seed, device=device).layers
    if cfg.tp_world > 1:
        from apex_tpu_torch.parallel.collectives import axis_index

        layers = shard_params(layers, infer_param_specs(layers),
                              axis_index(cfg.tensor_axis), cfg.tp_world)
    per_layer = [tree_map(lambda l, i=i: l[i].clone(), layers)
                 for i in range(cfg.num_layers)]
    layer = ParallelTransformerLayer(
        cfg, self_attn_mask_type=AttnMaskType.causal, device=device)

    def make_stage_fn(mask=None, generator=None, segment_ids=None):
        def stage_fn(layer_params, x):
            return functional_layer(layer, layer_params, x, mask, generator,
                                    segment_ids)
        return stage_fn

    return make_stage_fn, per_layer
