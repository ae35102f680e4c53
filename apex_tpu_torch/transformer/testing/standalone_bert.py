"""Standalone BERT (port of
:mod:`apex_tpu.transformer.testing.standalone_bert`).

:class:`BertModel` is a bidirectional
:class:`~apex_tpu_torch.transformer.testing.standalone_transformer_lm.TransformerLanguageModel`
with the pooler, the LM head (dense, tanh-approximate GeLU, LayerNorm,
then the embedding-tied logits plus a vocabulary bias) and the binary
(sentence-order) head.  The padding mask ``[b, s]`` (1 = a real token)
becomes :func:`bert_extended_attention_mask` for the default core, and
under ``use_flash_attention`` flash segment ids ``1 - mask``: real
tokens id 0, padding id 1, non-causal.  The flash kernels then keep
attention where both sides share an id, which is the extended mask at
every real position; a padding row attends the padding only, where the
default core's fully masked row gives a uniform mix.  Both are ignored
downstream.

The GeLUs differ on purpose: the LM head's is Flax's ``nn.gelu``, whose
default is the tanh approximation, while
:func:`apex_tpu_torch.ops.dense.fused_dense_gelu_dense` uses erf.

The pooler's, the LM head's and the binary head's dense layers are Flax
``nn.Dense`` in the reference (``kernel [in, out]``); here they are
:class:`~apex_tpu_torch.transformer.testing.standalone_transformer_lm.Dense`
(``weight [out, in]``), and
:func:`apex_tpu_torch.serving.bridge.from_flax_bert` transposes them.
The LM head's bias is ``[padded_vocab_size / tp]``, sharded over the
vocabulary like the embedding table.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.normalization.fused_layer_norm import FusedLayerNorm
from apex_tpu_torch.ops.softmax import AttnMaskType
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    Dense,
    TransformerConfig,
    TransformerLanguageModel,
    parallel_lm_logits,
)

__all__ = ["BertModel", "bert_extended_attention_mask"]


def bert_extended_attention_mask(attention_mask):
    """``[b, s]`` 1/0 padding mask -> ``[b, 1, s, s]`` bool mask, True
    where attention is masked out: kept only where both the query and the
    key position are real tokens."""
    m = attention_mask.bool()
    return ~(m[:, None, :, None] & m[:, None, None, :])


class BertLMHead(nn.Module):
    """Dense + tanh-GeLU + LayerNorm, then the logits against the tied
    embedding table plus ``bias [vocab / tp]``."""

    def __init__(self, config: TransformerConfig, *, device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size, dtype=cfg.dtype,
                           param_dtype=cfg.param_dtype, device=device)
        self.layernorm = FusedLayerNorm(cfg.hidden_size, cfg.layernorm_epsilon,
                                        param_dtype=cfg.param_dtype,
                                        device=device)
        self.bias = nn.Parameter(torch.zeros(
            cfg.padded_vocab_size // cfg.tp_world, dtype=cfg.param_dtype,
            device=device))

    def forward(self, hidden, word_embeddings):
        h = self.layernorm(F.gelu(self.dense(hidden), approximate="tanh"))
        return parallel_lm_logits(h, word_embeddings, self.config,
                                  bias=self.bias)


class BertModel(nn.Module):
    """Bidirectional LM + pooler + LM and binary heads.

    ``forward(input_ids [b, s], attention_mask [b, s])`` returns
    ``(lm_logits [s, b, vocab / tp], binary_logits [b, 2])`` (``None``
    for the second without ``add_binary_head``).  The LM logits are fp32
    when the parameters are (the bias promotes them, as in the JAX
    package).  ``generator`` (a ``torch.Generator`` on the model's device)
    turns dropout on; ``None`` is deterministic.  The model is built on
    ``device``, the card unless the caller names another (``"cpu"``),
    with weights drawn from ``seed`` (:meth:`reset_parameters`;
    ``seed=None`` leaves them to be loaded)."""

    def __init__(self, config: TransformerConfig, add_binary_head: bool = True,
                 *, device=None, seed: Optional[int] = 0):
        super().__init__()
        cfg = config
        device = resolve_device(device)
        self.config = cfg
        self.add_binary_head = add_binary_head
        self.language_model = TransformerLanguageModel(
            cfg, self_attn_mask_type=AttnMaskType.padding,
            add_pooler=add_binary_head, device=device)
        self.lm_head = BertLMHead(cfg, device=device)
        self.binary_head = (Dense(cfg.hidden_size, 2, dtype=cfg.dtype,
                                  param_dtype=cfg.param_dtype, device=device)
                            if add_binary_head else None)
        if seed is not None:
            self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """The JAX package's initializers, drawn from ``seed`` on the
        model's device: every weight and embedding normal with
        ``init_method_std``, the output-facing linears (the attention
        projections' ``dense``, ``dense_4h_to_h``) with ``std / sqrt(2
        L)``, biases 0, LayerNorm scales 1."""
        cfg = self.config
        std = cfg.init_method_std
        out_std = std / math.sqrt(2.0 * cfg.num_layers)
        device = self.lm_head.bias.device
        gen = torch.Generator(device=device).manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("layernorm.scale"):
                p.fill_(1.0)
            elif p.dim() == 1:
                p.zero_()
            else:
                s = (out_std if name.endswith(
                    ("attention.dense.kernel", "dense_4h_to_h.kernel"))
                    else std)
                p.copy_(torch.randn(p.shape, generator=gen, device=device)
                        .mul_(s))

    def forward(self, input_ids, attention_mask, position_ids=None,
                generator=None):
        cfg = self.config
        ext_mask = bert_extended_attention_mask(attention_mask)
        seg = ((1 - attention_mask.int())
               if cfg.use_flash_attention else None)
        out = self.language_model(input_ids, position_ids, ext_mask,
                                  generator, segment_ids=seg)
        hidden, pooled = out if self.add_binary_head else (out, None)
        lm_logits = self.lm_head(
            hidden, self.language_model.embedding.word_embeddings.embedding)
        binary_logits = (self.binary_head(pooled) if self.add_binary_head
                         else None)
        return lm_logits, binary_logits
