"""Fused multihead-attention modules (port of
:mod:`apex_tpu.contrib.multihead_attn`, the reference's
``apex/contrib/multihead_attn``): :class:`SelfMultiheadAttn` (one packed
QKV projection) and :class:`EncdecMultiheadAttn` (queries from the
decoder stream, packed K/V from the encoder's), in the ``[T, B, C]``
layout, with optional biases, a binary key-padding mask or an additive
mask, attention dropout, and the optional pre-LayerNorm + residual add
(``include_norm_add``: ``lyr_nrm`` before the projections, dropout and
the residual after the output projection).

Without an additive mask the core is
:func:`apex_tpu_torch.ops.flash_attention.flash_attention` (F1-F3 on the
card): the key padding becomes segment ids, 0 for every query and the
mask (1 = padding) for the keys, so a query sees the real keys only; a
batch row whose keys are all padding gives every query output 0, as the
JAX kernels do.  Dropout is the kernels' counter hash, seeded by one
int32 drawn from ``generator``.  An additive mask (``mask_additive`` for
the self-attention module, any ``attn_mask`` for the encoder-decoder one)
takes the plain softmax core: fp32 scores plus the mask, the key padding
at -1e30, the softmax, dropout on the probabilities.

The projections (``in_proj``, ``q_proj``, ``kv_proj``, ``out_proj``) are
Flax ``nn.Dense`` in the reference (``kernel [in, out]``, Xavier-uniform);
here they are
:class:`~apex_tpu_torch.transformer.testing.standalone_transformer_lm.Dense`
(``weight [out, in]``), which
:func:`apex_tpu_torch.serving.bridge.from_flax_multihead_attn` fills from
the Flax parameters.  As Flax's ``Dense``, a projection computes in the
promoted dtype of its input and its parameters: bf16 activations through
fp32 parameters compute in fp32, and the module runs in bf16 (the tensor
-core route of F1-F3) once its parameters are bf16
(``module.to(torch.bfloat16)``).  ``generator=None`` is deterministic.
The modules are built on ``device``, the card unless the caller names
another (``"cpu"``), with weights drawn from ``seed``.
"""

from __future__ import annotations

import torch
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.normalization.fused_layer_norm import FusedLayerNorm
from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    Dense,
    dropout,
)

__all__ = ["SelfMultiheadAttn", "EncdecMultiheadAttn"]


def _attention_core(q, k, v, *, scale, key_padding_mask, attn_mask,
                    dropout_rate, generator):
    """q/k/v ``[B, H, S, D]`` -> ``[B, H, Sq, D]``: flash without
    ``attn_mask``, the plain softmax core with it."""
    if attn_mask is None:
        kw = {}
        if key_padding_mask is not None:
            b, sq = q.shape[0], q.shape[2]
            kw["segment_ids_q"] = torch.zeros((b, sq), dtype=torch.int32,
                                              device=q.device)
            kw["segment_ids_kv"] = key_padding_mask.to(torch.int32)
        if dropout_rate > 0.0 and generator is not None:
            kw["dropout_rate"] = dropout_rate
            kw["dropout_seed"] = torch.randint(
                0, 2 ** 31 - 1, (1,), generator=generator, device=q.device,
                dtype=torch.int32)
        return flash_attention(q, k, v, causal=False, scale=scale, **kw)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    scores = scores + attn_mask.float()
    if key_padding_mask is not None:
        scores = torch.where(key_padding_mask[:, None, None, :].bool(),
                             -1e30, scores)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    probs = dropout(probs, dropout_rate, generator)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _split_heads(x, heads):
    t, b, c = x.shape                      # [T, B, C] -> [B, H, T, D]
    return x.reshape(t, b, heads, c // heads).permute(1, 2, 0, 3)


def _merge_heads(x):
    b, h, t, d = x.shape                   # [B, H, T, D] -> [T, B, C]
    return x.permute(2, 0, 1, 3).reshape(t, b, h * d)


class _MultiheadAttn(nn.Module):
    def __init__(self, embed_dim, num_heads, dropout, bias, include_norm_add,
                 projections, device, seed):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        device = resolve_device(device)
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout = dropout
        self.include_norm_add = include_norm_add
        if include_norm_add:
            self.lyr_nrm = FusedLayerNorm(embed_dim, device=device)
        gen = torch.Generator().manual_seed(seed)
        for name, n_out in projections + (("out_proj", embed_dim),):
            linear = Dense(embed_dim, n_out, bias, device=device)
            with torch.no_grad():
                cpu = torch.empty(linear.weight.shape)
                nn.init.xavier_uniform_(cpu, generator=gen)
                linear.weight.copy_(cpu)
                if bias:
                    linear.bias.zero_()
            self.add_module(name, linear)

    def _attend(self, query, q, k, v, key_padding_mask, attn_mask,
                generator):
        h = self.num_heads
        out = _attention_core(
            _split_heads(q, h), _split_heads(k, h), _split_heads(v, h),
            scale=(self.embed_dim // h) ** -0.5,
            key_padding_mask=key_padding_mask, attn_mask=attn_mask,
            dropout_rate=self.dropout, generator=generator)
        out = self.out_proj(_merge_heads(out))
        if self.include_norm_add:
            out = query + dropout(out, self.dropout, generator)
        return out


class SelfMultiheadAttn(_MultiheadAttn):
    """Self-attention over ``query [T, B, C]`` (``key`` and ``value`` are
    taken for the reference's signature and unused); ``in_proj`` packs
    Q, K and V.  ``mask_additive`` passes ``attn_mask`` (additive,
    broadcastable to ``[B, H, T, T]``) to the plain core; without it
    ``attn_mask`` is ignored.  ``mask_additive`` with
    ``include_norm_add`` raises, as in the reference."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 mask_additive: bool = False, *, device=None, seed: int = 0):
        if mask_additive and include_norm_add:
            raise ValueError(
                "additive mask not supported with layer norm (reference "
                "constraint)")
        super().__init__(embed_dim, num_heads, dropout, bias,
                         include_norm_add, (("in_proj", 3 * embed_dim),),
                         device, seed)
        self.mask_additive = mask_additive

    def forward(self, query, key=None, value=None, key_padding_mask=None,
                attn_mask=None, generator=None):
        del key, value
        x = self.lyr_nrm(query) if self.include_norm_add else query
        q, k, v = self.in_proj(x).chunk(3, dim=-1)
        return self._attend(query, q, k, v, key_padding_mask,
                            attn_mask if self.mask_additive else None,
                            generator)


class EncdecMultiheadAttn(_MultiheadAttn):
    """Encoder-decoder attention: ``q_proj`` on ``query [Tq, B, C]``,
    ``kv_proj`` (packed K/V) on ``key [Tk, B, C]`` (``value`` rides with
    ``key`` and is unused); ``key_padding_mask [B, Tk]``; an
    ``attn_mask`` takes the plain core."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False, *,
                 device=None, seed: int = 0):
        super().__init__(embed_dim, num_heads, dropout, bias,
                         include_norm_add,
                         (("q_proj", embed_dim), ("kv_proj", 2 * embed_dim)),
                         device, seed)

    def forward(self, query, key, value=None, key_padding_mask=None,
                attn_mask=None, generator=None):
        del value
        x = self.lyr_nrm(query) if self.include_norm_add else query
        q = self.q_proj(x)
        k, v = self.kv_proj(key).chunk(2, dim=-1)
        return self._attend(query, q, k, v, key_padding_mask, attn_mask,
                            generator)
