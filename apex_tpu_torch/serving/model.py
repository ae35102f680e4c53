"""Prefill/decode forward of a GPT over the paged KV cache.

Port of :mod:`apex_tpu.serving.model` at tensor-parallel size 1.  The
layers are the training stack's (column/row-parallel linears, the MLP,
the fused LayerNorm, the embedding and tied LM head) under the JAX
package's parameter names, driven through two inference entry points:

- :meth:`DecodeModel.prefill`: one ``[max_batch, chunk]`` slice of
  prompts, scattered into the cache at host-computed ``(block, offset)``
  destinations and attended with the chunked-prefill kernel; each
  token's causal limit covers the request's whole cached context (earlier
  chunks, shared prefix blocks and the in-chunk triangle) in one sweep.
- :meth:`DecodeModel.decode_step`: one token per slot with per-slot
  positions, block tables and an active mask; inactive slots are data
  (their cache writes are dropped, their length is 0).

Both write the new K/V rows into the arenas **in place** (the JAX package
donates the arenas through ``jit`` for the same effect; the cache is
never copied) and sample in place of returning logits to the host.  Rows
bound for the out-of-range block ``n_blocks`` (inactive slots, padding)
are dropped before the write, as ``.at[].set(mode="drop")`` drops them.
With an int8 cache the rows are quantized on write, one fp32 scale per
row.

The speculative k+1 verify (``decode_step`` with more than one token per
slot) and multi-LoRA are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.serving.fused_ops import fused_residual_norm
from apex_tpu_torch.serving.kv_cache import KVCacheConfig
from apex_tpu_torch.serving.paged_attention import (
    paged_attention_decode,
    paged_prefill_attention,
)
from apex_tpu_torch.serving.sampling import sample_tokens
from apex_tpu_torch.transformer.layers.layer_norm import FusedLayerNorm
from apex_tpu_torch.transformer.rope import (
    apply_rotary_decode,
    apply_rotary_packed,
    rotary_cos_sin,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import divide
from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
    GPT3DParams,
    merge_layer_stack,
)
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    Embedding,
    ParallelMLP,
    TransformerConfig,
    parallel_lm_logits,
)

__all__ = ["DecodeModel", "serving_config"]


def serving_config(config: TransformerConfig) -> TransformerConfig:
    """Check that the served config is one the decode path wires (the
    JAX function also turns dropout, sequence parallelism and fp8 off;
    the port's config has none of them)."""
    if config.apply_residual_connection_post_layernorm:
        raise NotImplementedError(
            "serving decode assumes the standard pre-LN residual; "
            "apply_residual_connection_post_layernorm is not wired")
    return config


def _quantize_rows(x):
    """Symmetric int8 row quantization: ``x [..., d]`` -> (int8 values,
    fp32 per-row scales ``[...]``); ``amax / 127`` floored at 1e-8,
    round half to even, clipped at +-127."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scales = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scales[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scales


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


class _Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        n, g, d = cfg.num_attention_heads, cfg.query_groups, cfg.head_dim
        self.query_key_value = ColumnParallelLinear(
            cfg.hidden_size, (n + 2 * g) * d, dtype=cfg.dtype, device=device)
        self.dense = RowParallelLinear(
            n * d, cfg.hidden_size, skip_bias_add=True, dtype=cfg.dtype,
            device=device)


class _Layer(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        eps = cfg.layernorm_epsilon
        kw = dict(param_dtype=cfg.param_dtype, device=device)
        self.input_layernorm = FusedLayerNorm(cfg.hidden_size, eps, **kw)
        self.self_attention = _Attention(cfg, device)
        self.post_attention_layernorm = FusedLayerNorm(cfg.hidden_size, eps,
                                                       **kw)
        self.mlp = ParallelMLP(cfg, param_dtype=cfg.dtype, device=device)


class DecodeModel(nn.Module):
    """A GPT's prefill/decode forward bound to a config and cache shape.

    The parameters live in the module (:meth:`load_params` copies a
    :class:`GPT3DParams` in); the cache arenas are arguments, updated in
    place.  ``device`` defaults to the CUDA device."""

    def __init__(self, config: TransformerConfig, cache: KVCacheConfig, *,
                 device=None):
        super().__init__()
        cfg = serving_config(config)
        device = resolve_device(device)
        self.cfg = cfg
        self.cache = cache
        self.device = device
        d = cfg.head_dim
        n, g = cfg.num_attention_heads, cfg.query_groups
        self.hpg = divide(n, g)
        if cache.kv_heads != g:
            raise ValueError(
                f"cache kv_heads ({cache.kv_heads}) != model query_groups "
                f"({g})")
        if cache.head_dim != d:
            raise ValueError(
                f"cache head_dim ({cache.head_dim}) != model head_dim ({d})")
        self.embedding = Embedding(cfg, param_dtype=cfg.dtype, device=device)
        self.layers = nn.ModuleList(
            _Layer(cfg, device) for _ in range(cfg.num_layers))
        self.final_ln = FusedLayerNorm(cfg.hidden_size,
                                       cfg.layernorm_epsilon,
                                       param_dtype=cfg.param_dtype,
                                       device=device)
        self.requires_grad_(False)          # serving: no parameter gradients

    def load_params(self, params: GPT3DParams) -> None:
        """Copy ``params`` in (layer stack ``[L, ...]`` or
        ``[vpp, pp, ...]``), cast to each parameter's dtype."""
        layers = merge_layer_stack(params.layers, self.cfg.num_layers)
        state = {}
        state.update(_flatten(params.embedding, "embedding."))
        for name, t in _flatten(layers).items():
            for i in range(self.cfg.num_layers):
                state[f"layers.{i}.{name}"] = t[i]
        state.update(_flatten(params.final_ln, "final_ln."))
        self.load_state_dict(state, strict=True)

    # ----------------------------------------------------------------- util

    def _split_qkv(self, qkv):
        """Group-major fused-QKV split: per K/V group its hpg query heads,
        then its one K and one V head."""
        cfg = self.cfg
        d = cfg.head_dim
        s, b = qkv.shape[0], qkv.shape[1]
        qkv = qkv.reshape(s, b, cfg.query_groups, (self.hpg + 2) * d)
        q = qkv[..., :self.hpg * d].reshape(s, b, cfg.num_attention_heads, d)
        k = qkv[..., self.hpg * d:(self.hpg + 1) * d]
        v = qkv[..., (self.hpg + 1) * d:]
        return q, k, v

    def _append_rows(self, layer_arenas, rows, dest, k, v):
        """Write the K/V rows of ``k``/``v`` ``[s, b, g, d]`` selected by
        ``rows`` (indices into the flattened ``[b, s]`` order) to the
        ``dest = (blocks, offsets)`` of one layer's arena slice, in place.
        The int8 cache quantizes on write and stores the row scales beside
        the rows."""
        g, d = k.shape[2], k.shape[3]
        k_rows = k.transpose(0, 1).reshape(-1, g, d).index_select(0, rows)
        v_rows = v.transpose(0, 1).reshape(-1, g, d).index_select(0, rows)
        if self.cache.quantized:
            k_layer, v_layer, ks_layer, vs_layer = layer_arenas
            qk, sk = _quantize_rows(k_rows)
            qv, sv = _quantize_rows(v_rows)
            k_layer.index_put_(dest, qk)
            v_layer.index_put_(dest, qv)
            ks_layer.index_put_(dest, sk)
            vs_layer.index_put_(dest, sv)
        else:
            k_layer, v_layer = layer_arenas
            k_layer.index_put_(dest, k_rows.to(k_layer.dtype))
            v_layer.index_put_(dest, v_rows.to(v_layer.dtype))

    def _attend_kwargs(self, layer_arenas):
        if self.cache.quantized:
            k_layer, v_layer, ks_layer, vs_layer = layer_arenas
            return (k_layer, v_layer), dict(k_scales=ks_layer,
                                            v_scales=vs_layer)
        return layer_arenas, {}

    def _layer_stack(self, x, arenas, attn_core):
        eps = self.cfg.layernorm_epsilon
        for i, layer in enumerate(self.layers):
            layer_arenas = tuple(a[i] for a in arenas)
            ln1 = layer.input_layernorm(x)
            qkv = layer.self_attention.query_key_value(ln1)
            q, k, v = self._split_qkv(qkv)
            ctx = attn_core(q, k, v, layer_arenas)
            y, y_bias = layer.self_attention.dense(ctx)
            ln2 = layer.post_attention_layernorm
            ln2_out, h = fused_residual_norm(y, x, ln2.scale, ln2.bias,
                                             bias=y_bias, eps=eps)
            m, m_bias = layer.mlp(ln2_out)
            x = h + m + m_bias
        return x

    def _head(self, x):
        """Final LN + tied LM head: ``logits [s, b, vocab]``."""
        hidden = self.final_ln(x)
        return parallel_lm_logits(
            hidden, self.embedding.word_embeddings.embedding, self.cfg)

    def _rope_tables(self, positions, dtype):
        cfg = self.cfg
        if cfg.position_embedding_type != "rope":
            return None
        return rotary_cos_sin(positions, cfg.rotary_dim, cfg.rotary_base,
                              dtype)

    @staticmethod
    def _live_rows(dest_blocks, n_blocks):
        """Indices of the rows whose destination block is in range (one
        host sync per call, not per layer)."""
        return (dest_blocks.reshape(-1) < n_blocks).nonzero().flatten()

    # ---------------------------------------------------------------- entry

    @torch.no_grad()
    def decode_step(self, arenas, tokens, positions, block_tables, active,
                    temperature, top_k, top_p, seeds, steps
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One continuously batched decode step.

        ``arenas``: ``(k, v)`` or ``(k, v, k_scales, v_scales)``, updated
        in place; ``tokens [max_batch, 1]`` (each slot's last token),
        ``positions [max_batch]`` (the cache index it is written at),
        ``block_tables [max_batch, max_blocks]`` int32, ``active
        [max_batch]`` bool and the ``[max_batch]`` sampling-policy
        tensors.  Returns ``(out_tokens [max_batch, 1], logits
        [max_batch, 1, vocab])``; inactive slots emit 0."""
        cfg = self.cfg
        cache = self.cache
        bs = cache.block_size
        B, S = tokens.shape
        if S != 1:
            raise NotImplementedError(
                "decode_step takes one token per slot; the speculative "
                "k+1 verify is not ported yet")
        pos = positions.long()
        lengths = torch.where(active, pos + 1, 0).to(torch.int32)
        logical = (pos // bs).clamp(0, block_tables.shape[1] - 1)
        phys = block_tables.gather(1, logical[:, None])[:, 0]
        rows = active.nonzero().flatten()
        dest = (phys.index_select(0, rows).long(),
                (pos % bs).index_select(0, rows))

        if cfg.position_embedding_type == "learned":
            x = self.embedding(tokens, pos[:, None])
        else:
            x = self.embedding(tokens)
        rope = self._rope_tables(pos, x.dtype)          # [B, half]

        def attn_core(q, k, v, layer_arenas):
            # q [1, B, n, d]; k/v [1, B, g, d]
            if rope is not None:
                q = apply_rotary_decode(q, *rope)
                k = apply_rotary_decode(k, *rope)
            # write this token's row first, so it attends to itself
            self._append_rows(layer_arenas, rows, dest, k, v)
            kv, sc = self._attend_kwargs(layer_arenas)
            ctx = paged_attention_decode(q[0].contiguous(), *kv,
                                         block_tables, lengths, **sc)
            return ctx.reshape(1, B, -1)

        x = self._layer_stack(x, arenas, attn_core)
        logits = self._head(x).transpose(0, 1)          # [B, 1, vocab]
        sampled = sample_tokens(logits[:, 0], temperature, top_k, top_p,
                                seeds, steps)
        out = torch.where(active, sampled, 0)[:, None]
        return out, logits

    @torch.no_grad()
    def prefill(self, arenas, tokens, position_ids, block_tables, lengths,
                limits, dest_blocks, dest_offsets, sample_index,
                temperature, top_k, top_p, seeds, steps
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched chunked prefill of one ``[max_batch, chunk]`` slice.

        Per slot: ``tokens``/``position_ids [max_batch, chunk]`` (this
        tick's slice of the prompt at its absolute positions);
        ``dest_blocks``/``dest_offsets [max_batch, chunk]`` (each token's
        cache destination; block ``n_blocks`` = dropped, for padding);
        ``block_tables [max_batch, max_blocks]``; ``lengths [max_batch]``
        (cache length including this chunk); ``limits [max_batch, chunk]``
        (per-token causal horizons, 0 = padding).  ``sample_index
        [max_batch]``: the in-chunk index of the last prompt token for
        slots whose prompt completes here (out of range = no sample).
        Returns ``(next_tokens [max_batch], logits [max_batch, chunk,
        vocab])``."""
        cfg = self.cfg
        B, T = tokens.shape
        rows = self._live_rows(dest_blocks, self.cache.n_blocks)
        dest = (dest_blocks.reshape(-1).index_select(0, rows).long(),
                dest_offsets.reshape(-1).index_select(0, rows).long())

        if cfg.position_embedding_type == "learned":
            x = self.embedding(tokens, position_ids.long())
        else:
            x = self.embedding(tokens)
        rope = None
        if cfg.position_embedding_type == "rope":
            cos, sin = self._rope_tables(position_ids.reshape(-1), x.dtype)
            rope = (cos.reshape(B, T, -1).transpose(0, 1),
                    sin.reshape(B, T, -1).transpose(0, 1))

        def attn_core(q, k, v, layer_arenas):
            # q [T, B, n, d]; k/v [T, B, g, d]
            if rope is not None:
                q = apply_rotary_packed(q, *rope)
                k = apply_rotary_packed(k, *rope)
            self._append_rows(layer_arenas, rows, dest, k, v)
            kv, sc = self._attend_kwargs(layer_arenas)
            ctx = paged_prefill_attention(
                q.transpose(0, 1).contiguous(), *kv, block_tables, lengths,
                limits, **sc)                            # [B, T, n, d]
            return ctx.transpose(0, 1).reshape(T, B, -1)

        x = self._layer_stack(x, arenas, attn_core)
        logits = self._head(x).transpose(0, 1)          # [B, T, vocab]
        si = sample_index.long()
        last = logits[torch.arange(B, device=logits.device),
                      si.clamp(0, T - 1)]
        sampled = sample_tokens(last, temperature, top_k, top_p, seeds,
                                steps)
        valid = (si >= 0) & (si < T)
        return torch.where(valid, sampled, 0), logits
