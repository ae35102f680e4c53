"""Prefill/decode forward of a GPT over the paged KV cache.

Port of :mod:`apex_tpu.serving.model`.  The layers are the training
stack's (column/row-parallel linears, the MLP, the fused LayerNorm, the
embedding and tied LM head) under the JAX package's parameter names,
driven through two inference entry points:

- :meth:`DecodeModel.prefill`: one ``[max_batch, chunk]`` slice of
  prompts, scattered into the cache at host-computed ``(block, offset)``
  destinations and attended with the chunked-prefill kernel; each
  token's causal limit covers the request's whole cached context (earlier
  chunks, shared prefix blocks and the in-chunk triangle) in one sweep.
- :meth:`DecodeModel.decode_step`: ``[max_batch, spec_width]`` tokens
  (``spec_width = k + 1`` with speculative decoding, 1 without) with
  per-slot positions, block tables, an active mask and a per-slot draft
  count; inactive slots and unused draft positions are data (their cache
  writes are dropped, their attention limit is 0).  With drafts the step
  is the **k+1 verify**: each slot's last token and its drafted
  continuations attend in one multi-query sweep (K2) with per-position
  causal limits, every position samples with the slot's policy at its
  own output counter, and the accepted count (the longest prefix of
  drafts matching the step's own outputs) is computed on the device.
  Rejected drafts need no undo: their rows sit past the host-side length,
  which does not advance over them, and the next step overwrites them.

Both write the new K/V rows into the arenas **in place** (the JAX package
donates the arenas through ``jit`` for the same effect; the cache is
never copied) and sample in place of returning logits to the host.  Rows
bound for the out-of-range block ``n_blocks`` (inactive slots, padding)
are dropped before the write, as ``.at[].set(mode="drop")`` drops them.
With an int8 cache the rows are quantized on write, one fp32 scale per
row.

With a :class:`~apex_tpu_torch.serving.lora.LoRAConfig` both entry points
also take ``adapters`` (the eight ``[L, n_slots, ...]`` arena tensors) and
``adapter_slots [max_batch]`` (each slot's arena row, data), and every
layer adds the gathered rank-r delta (L1) to its four projections.  The
adapter path repeats the bare path's operations in the same order, so the
zero adapter's exact-zero delta leaves every value bit for bit as it was.

**Tensor parallelism.**  With ``config.tensor_axis`` naming an axis of
size tp > 1 on the grid (:func:`~apex_tpu_torch.parallel.
initialize_model_parallel`), each rank holds its shard of the weights
(:meth:`DecodeModel.load_params` takes the full tree and keeps the
rank's) and of the cache: ``n/tp`` query heads and ``g/tp`` K/V groups,
whose rows K1 and K2 read; the row-parallel projections' outputs are
summed over tp inside the parallel linears, the row-parallel adapter
deltas by :meth:`DecodeModel._lora_psum`, and the LM head's vocabulary
shards are all-gathered (:meth:`DecodeModel._head`), so every rank
samples the same token from the full vocabulary.  K3 runs on the full
hidden row after the reduction, L1 on the rank's column split.

``fused_attention=False`` attends through the reference's separate-ops
lowering (:func:`~apex_tpu_torch.serving.paged_attention.
paged_attention_decode_unfused` and
:func:`~apex_tpu_torch.serving.paged_attention.
paged_prefill_attention_unfused`) instead of K1 and K2, the A/B switch
of the two kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.parallel import collectives as cc
from apex_tpu_torch.serving.fused_ops import (
    fused_residual_norm,
    residual_norm_unfused,
)
from apex_tpu_torch.serving.kv_cache import KVCacheConfig
from apex_tpu_torch.serving.lora import LoRAConfig, lora_delta
from apex_tpu_torch.serving.paged_attention import (
    paged_attention_decode,
    paged_attention_decode_unfused,
    paged_prefill_attention,
    paged_prefill_attention_unfused,
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
from apex_tpu_torch.transformer.tensor_parallel.partition import (
    infer_param_specs,
    shard_params,
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
    """The inference view of a training config: fp8 off (the
    delayed-scaling state is training-side, and the parameters are the
    same, so a checkpoint trained in fp8 serves unchanged), and sequence
    parallelism, its rings and context parallelism off (a decode step
    has no sequence dim to split; the parameters are the same).  The
    decode path takes no dropout generator, so dropout is off as the JAX
    function sets it."""
    if config.apply_residual_connection_post_layernorm:
        raise NotImplementedError(
            "serving decode assumes the standard pre-LN residual; "
            "apply_residual_connection_post_layernorm is not wired")
    if config.num_experts is not None:
        raise NotImplementedError(
            "MoE serving is not wired (the reference serves no experts "
            "either)")
    return dataclasses.replace(config, fp8=False, sequence_parallel=False,
                               overlap_comm=False, context_axis=None)


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
        axis = cfg.tensor_axis
        self.query_key_value = ColumnParallelLinear(
            cfg.hidden_size, (n + 2 * g) * d, axis=axis, dtype=cfg.dtype,
            device=device)
        self.dense = RowParallelLinear(
            n * d, cfg.hidden_size, skip_bias_add=True, axis=axis,
            dtype=cfg.dtype, device=device)


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
    place, and so are the adapter tensors when ``lora`` is set.  ``device``
    defaults to the CUDA device.  ``fuse_epilogue`` (the default) runs
    the bias/residual/LayerNorm epilogue through the K3 kernel; ``False``
    is the reference's separate-ops lowering
    (:func:`~apex_tpu_torch.serving.fused_ops.residual_norm_unfused`),
    chosen by the caller, never as a fallback; ``fused_attention=False``
    likewise attends through the unfused paged attention instead of K1
    and K2.  At tp > 1 (``config.tensor_axis`` on the grid) the module
    holds this rank's shard (see the module docstring)."""

    def __init__(self, config: TransformerConfig, cache: KVCacheConfig, *,
                 fused_attention: bool = True, fuse_epilogue: bool = True,
                 lora: Optional[LoRAConfig] = None, device=None):
        super().__init__()
        cfg = serving_config(config)
        device = resolve_device(device)
        self.cfg = cfg
        self.cache = cache
        self.fused_attention = fused_attention
        self.fuse_epilogue = fuse_epilogue
        self.lora = lora
        self.device = device
        d = cfg.head_dim
        n, g = cfg.num_attention_heads, cfg.query_groups
        self.hpg = divide(n, g)
        self.tp = cfg.tp_world
        self.n_local = divide(n, self.tp)
        self.g_local = divide(g, self.tp)
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
        ``[vpp, pp, ...]``), cast to each parameter's dtype.  ``params``
        is the full tree; at tp > 1 this rank keeps its shard, split as
        :func:`~apex_tpu_torch.transformer.tensor_parallel.partition.
        infer_param_specs` says."""
        layers = merge_layer_stack(params.layers, self.cfg.num_layers)
        params = params._replace(layers=layers)
        if self.tp > 1:
            axis = self.cfg.tensor_axis
            params = shard_params(
                params, infer_param_specs(params, axis=axis),
                cc.axis_index(axis), self.tp, axis=axis)
            layers = params.layers
        state = {}
        state.update(_flatten(params.embedding, "embedding."))
        for name, t in _flatten(layers).items():
            for i in range(self.cfg.num_layers):
                state[f"layers.{i}.{name}"] = t[i]
        state.update(_flatten(params.final_ln, "final_ln."))
        self.load_state_dict(state, strict=True)

    # ----------------------------------------------------------------- util

    def _split_qkv(self, qkv):
        """Group-major fused-QKV split of this rank's groups: per K/V
        group its hpg query heads, then its one K and one V head."""
        d = self.cfg.head_dim
        s, b = qkv.shape[0], qkv.shape[1]
        qkv = qkv.reshape(s, b, self.g_local, (self.hpg + 2) * d)
        q = qkv[..., :self.hpg * d].reshape(s, b, self.n_local, d)
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

    def _lora_psum(self, d):
        """Sum a row-parallel projection's partial deltas over tp (its A
        is split on the input dim, so each rank holds a partial sum): the
        one collective the adapter path adds, none at tp = 1."""
        if self.tp > 1:
            return cc.all_reduce(d, self.cfg.tensor_axis)
        return d

    def _mlp_with_adapter(self, mlp, x, fc1_a, fc1_b, fc2_a, fc2_b, slots):
        """``ParallelMLP`` replayed op for op with the gathered deltas
        added: fc1's (column-parallel, split like the base output) after
        its bias and before the activation, fc2's (row-parallel, summed
        over tp) to its output (the bias stays apart, skip-bias-add).  A
        zero-slot gather adds exact zeros, so the bare stream stays
        bitwise."""
        cfg = self.cfg
        h, bias = mlp.dense_h_to_4h(x)
        h = h + bias + lora_delta(x, fc1_a, fc1_b, slots,
                                  fused=self.lora.fused)
        if cfg.swiglu:
            gate, gate_bias = mlp.dense_h_to_4h_gate(x)
            h = F.silu(gate + gate_bias) * h
        else:
            h = F.gelu(h, approximate="tanh" if cfg.bias_gelu_fusion
                       else "none")
        out, out_bias = mlp.dense_4h_to_h(h)
        out = out + self._lora_psum(lora_delta(h, fc2_a, fc2_b, slots,
                                               fused=self.lora.fused))
        return out, out_bias

    def _layer_stack(self, x, arenas, attn_core, adapters=None,
                     adapter_slots=None):
        """Run the layers; with ``adapters`` (the eight arena tensors in
        :data:`~apex_tpu_torch.serving.lora.PROJECTIONS` order) every
        projection adds its slot-gathered delta."""
        eps = self.cfg.layernorm_epsilon
        for i, layer in enumerate(self.layers):
            layer_arenas = tuple(a[i] for a in arenas)
            ln1 = layer.input_layernorm(x)
            qkv = layer.self_attention.query_key_value(ln1)
            if adapters is not None:
                (qkv_a, qkv_b, dense_a, dense_b,
                 fc1_a, fc1_b, fc2_a, fc2_b) = (a[i] for a in adapters)
                qkv = qkv + lora_delta(ln1, qkv_a, qkv_b, adapter_slots,
                                       fused=self.lora.fused)
            q, k, v = self._split_qkv(qkv)
            ctx = attn_core(q, k, v, layer_arenas)
            y, y_bias = layer.self_attention.dense(ctx)
            if adapters is not None:
                y = y + self._lora_psum(
                    lora_delta(ctx, dense_a, dense_b, adapter_slots,
                               fused=self.lora.fused))
            ln2 = layer.post_attention_layernorm
            epilogue = (fused_residual_norm if self.fuse_epilogue
                        else residual_norm_unfused)
            ln2_out, h = epilogue(y, x, ln2.scale, ln2.bias, bias=y_bias,
                                  eps=eps)
            if adapters is not None:
                m, m_bias = self._mlp_with_adapter(
                    layer.mlp, ln2_out, fc1_a, fc1_b, fc2_a, fc2_b,
                    adapter_slots)
            else:
                m, m_bias = layer.mlp(ln2_out)
            x = h + m + m_bias
        return x

    def _check_adapters(self, adapters, adapter_slots):
        if (adapters is None) != (adapter_slots is None):
            raise ValueError("pass both adapters and adapter_slots or neither")
        if adapters is not None and self.lora is None:
            raise ValueError("adapters given to a model built without lora")

    def _head(self, x):
        """Final LN + tied LM head: ``logits [s, b, vocab]`` over the full
        vocabulary (at tp > 1 the shards all-gathered, so every rank
        samples in one id space)."""
        hidden = self.final_ln(x)
        logits = parallel_lm_logits(
            hidden, self.embedding.word_embeddings.embedding, self.cfg)
        if self.tp > 1:
            logits = cc.all_gather(logits, self.cfg.tensor_axis,
                                   concat_axis=-1)
        return logits

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
                    temperature, top_k, top_p, seeds, steps, *,
                    n_draft=None, adapters=None, adapter_slots=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One continuously batched decode or verify step.

        ``arenas``: ``(k, v)`` or ``(k, v, k_scales, v_scales)``, updated
        in place; ``tokens [max_batch, S]`` with ``S = spec_width``
        (column 0 each slot's last token, columns ``1..n_draft`` its
        drafts, the rest padding), ``positions [max_batch]`` (the cache
        index column 0 is written at), ``block_tables [max_batch,
        max_blocks]`` int32, ``active [max_batch]`` bool, ``n_draft
        [max_batch]`` (0..S-1, default zeros) and the ``[max_batch]``
        sampling-policy tensors (position t of the verify draws at
        counter ``steps + t``).  With LoRA, ``adapters`` and
        ``adapter_slots`` as in :meth:`_layer_stack`.

        Returns ``(out_tokens [max_batch, S], accepted [max_batch],
        logits [max_batch, S, vocab])``: ``accepted`` is the longest
        prefix of drafts matching the step's own outputs, so the host
        emits ``out_tokens[:, :accepted + 1]``; inactive slots and
        padding positions emit 0."""
        self._check_adapters(adapters, adapter_slots)
        cfg = self.cfg
        cache = self.cache
        bs = cache.block_size
        B, S = tokens.shape
        dev = tokens.device
        pos = positions.long()
        n_draft = (torch.zeros_like(pos) if n_draft is None
                   else n_draft.long())
        offsets = torch.arange(S, device=dev)[None, :]
        pos_ids = pos[:, None] + offsets                    # [B, S]
        live = active[:, None] & (offsets <= n_draft[:, None])
        # verify position t sees cache positions < pos + t + 1, its own
        # row included (written before the attention)
        limits = torch.where(live, pos_ids + 1, 0).to(torch.int32)
        lengths = torch.where(active, pos + n_draft + 1, 0).to(torch.int32)
        logical = (pos_ids // bs).clamp(0, block_tables.shape[1] - 1)
        phys = block_tables.gather(1, logical)
        rows = live.reshape(-1).nonzero().flatten()         # b-major
        dest = (phys.reshape(-1).index_select(0, rows).long(),
                (pos_ids % bs).reshape(-1).index_select(0, rows))

        if cfg.position_embedding_type == "learned":
            # padding positions may run past the table; their rows are
            # never written and attend to nothing
            x = self.embedding(
                tokens, pos_ids.clamp(max=cfg.max_position_embeddings - 1))
        else:
            x = self.embedding(tokens)
        rope = None                                     # x: [S, B, h]
        if cfg.position_embedding_type == "rope":
            if S == 1:
                rope = self._rope_tables(pos, x.dtype)          # [B, half]
            else:
                cos, sin = self._rope_tables(pos_ids.reshape(-1), x.dtype)
                rope = (cos.reshape(B, S, -1).transpose(0, 1),
                        sin.reshape(B, S, -1).transpose(0, 1))

        attend = (paged_attention_decode if self.fused_attention
                  else paged_attention_decode_unfused)

        def attn_core(q, k, v, layer_arenas):
            # q [S, B, n_local, d]; k/v [S, B, g_local, d]
            if rope is not None:
                rot = apply_rotary_decode if S == 1 else apply_rotary_packed
                q = rot(q, *rope)
                k = rot(k, *rope)
            # write the rows first, so each position attends to itself
            self._append_rows(layer_arenas, rows, dest, k, v)
            kv, sc = self._attend_kwargs(layer_arenas)
            if S == 1:
                ctx = attend(q[0].contiguous(), *kv, block_tables, lengths,
                             **sc)
                return ctx.reshape(1, B, -1)
            ctx = attend(
                q.transpose(0, 1).contiguous(), *kv, block_tables, lengths,
                limits=limits, **sc)                     # [B, S, n, d]
            return ctx.transpose(0, 1).reshape(S, B, -1)

        x = self._layer_stack(x, arenas, attn_core, adapters, adapter_slots)
        logits = self._head(x).transpose(0, 1)          # [B, S, vocab]

        def rep(t):
            return t.repeat_interleave(S, dim=0)

        sampled = sample_tokens(
            logits.reshape(B * S, -1), rep(temperature), rep(top_k),
            rep(top_p), rep(seeds), (steps[:, None] + offsets).reshape(-1))
        out = torch.where(live, sampled.reshape(B, S), 0)
        # accepted = longest prefix with draft t == output t - 1
        match = ((tokens[:, 1:] == out[:, :-1])
                 & (offsets[:, 1:] <= n_draft[:, None]))
        accepted = torch.cumprod(match.long(), dim=1).sum(dim=1)
        accepted = torch.where(active, accepted, 0)
        return out, accepted, logits

    @torch.no_grad()
    def prefill(self, arenas, tokens, position_ids, block_tables, lengths,
                limits, dest_blocks, dest_offsets, sample_index,
                temperature, top_k, top_p, seeds, steps, *, adapters=None,
                adapter_slots=None) -> Tuple[torch.Tensor, torch.Tensor]:
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
        With LoRA, ``adapters`` and ``adapter_slots`` as in
        :meth:`decode_step`.  Returns ``(next_tokens [max_batch], logits
        [max_batch, chunk, vocab])``."""
        self._check_adapters(adapters, adapter_slots)
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

        attend = (paged_prefill_attention if self.fused_attention
                  else paged_prefill_attention_unfused)

        def attn_core(q, k, v, layer_arenas):
            # q [T, B, n_local, d]; k/v [T, B, g_local, d]
            if rope is not None:
                q = apply_rotary_packed(q, *rope)
                k = apply_rotary_packed(k, *rope)
            self._append_rows(layer_arenas, rows, dest, k, v)
            kv, sc = self._attend_kwargs(layer_arenas)
            ctx = attend(q.transpose(0, 1).contiguous(), *kv, block_tables,
                         lengths, limits, **sc)          # [B, T, n, d]
            return ctx.transpose(0, 1).reshape(T, B, -1)

        x = self._layer_stack(x, arenas, attn_core, adapters, adapter_slots)
        logits = self._head(x).transpose(0, 1)          # [B, T, vocab]
        si = sample_index.long()
        last = logits[torch.arange(B, device=logits.device),
                      si.clamp(0, T - 1)]
        sampled = sample_tokens(last, temperature, top_k, top_p, seeds,
                                steps)
        valid = (si >= 0) & (si < T)
        return torch.where(valid, sampled, 0), logits
