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
from apex_tpu_torch.ops.softmax import AttnMaskType
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
    GPT3DParams,
    merge_layer_stack,
)
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    TransformerConfig,
    TransformerLanguageModel,
    parallel_lm_logits,
)

__all__ = ["GPTModel", "gpt_loss", "gpt_next_token_loss"]


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
