"""Standalone Megatron-style transformer language model.

Port of :mod:`apex_tpu.transformer.testing.standalone_transformer_lm`:
the configuration, the MLP, the attention (self-attention with a fused
group-major QKV, RoPE and grouped-query K/V; cross attention over an
encoder's output; both cores: the default fused-softmax one and the
flash one), the pre-LN encoder and decoder layers and the stack, the
embedding, the pooler and the tied LM head.
Activations keep the JAX package's ``[s, b, h]`` (sequence-major) layout
and the modules its parameter names.

Tensor parallelism: with a grid set up
(:func:`apex_tpu_torch.parallel.initialize_model_parallel`) and
``config.tensor_axis`` of size tp > 1, the modules are built at their
local sizes and hold this rank's shards, as the reference's do inside
``shard_map``: ``heads / tp`` attention heads and ``query_groups / tp``
K/V groups (the group-major QKV layout hands each rank whole groups),
``ffn / tp`` MLP columns, ``vocab / tp`` embedding rows.  The attention
core (flash or default) runs on the local heads.  A size that tp cannot
divide raises ``ValueError``, as the reference's ``divide`` does.  With
``sequence_parallel`` the activations between the tensor-parallel
regions are this rank's ``[s/tp, b, h]`` sequence shard: the embedding
reduce-scatters onto it, each column linear all-gathers it, each row
linear reduce-scatters back, and the LM head gathers it; the LayerNorms,
the row-parallel biases and the position table are then marked
``sequence_parallel`` for
:func:`~apex_tpu_torch.transformer.layers.allreduce_sequence_parallel_gradients`.
Without a grid, or with ``tensor_axis=None``, the model is the
single-device one and calls no collective.

Parameters are held in ``config.param_dtype`` and cast to the compute
``config.dtype`` on every call (as Flax does); the serving model passes
``param_dtype=config.dtype`` to hold its weights in the compute dtype.

Dropout: the JAX modules draw from the Flax ``"dropout"`` rng when not
``deterministic``; here every ``forward`` takes ``generator``, an explicit
``torch.Generator`` on the activations' device, and ``None`` means
deterministic (no dropout).  Hidden dropout and the fused-softmax core's
attention dropout draw a Bernoulli keep mask from it; the flash core
draws one int32 seed per call for the kernels' counter hash.

``fp8=True`` runs the transformer layers' four GEMMs (QKV, the attention
output, and the MLP's two or, with SwiGLU, three) through
:func:`apex_tpu_torch.amp.fp8.fp8_matmul_t`, each linear carrying its
delayed-scaling metas as buffers; the embedding and the tied LM head stay
in the compute dtype (the TransformerEngine recipe).

``overlap_comm`` runs the sequence-parallel linears' collectives as the
rings of :mod:`~apex_tpu_torch.transformer.tensor_parallel.overlap`.

Context parallelism (``context_axis``): the activations are this rank's
``[s/cp, b, h]`` sequence shard, and the causal core runs
:func:`~apex_tpu_torch.transformer.context_parallel.ring_attention` or
:func:`~apex_tpu_torch.transformer.context_parallel.ulysses_attention`
(``context_impl``) whatever ``use_flash_attention`` says; RoPE rotates
with the shard's global positions, and grouped K/V reach the core
compact (the broadcast over their query heads happens per kernel call
there).  :mod:`~apex_tpu_torch.transformer.testing.gpt_cp_train` is the
harness.

Mixture of experts (``num_experts``): the MLP position holds a
:class:`~apex_tpu_torch.transformer.moe.SwitchMLP` (experts sharded over
``expert_axis``), whose load-balancing loss the caller adds through
:func:`~apex_tpu_torch.transformer.moe.collect_moe_aux`.

Cross attention (``AttnType.cross_attn``, the decoder layer's
``inter_attention``) takes its queries from the decoder stream and its
keys and values from ``encoder_output`` and passes no segment ids, so it
always runs the default core over ``enc_dec_mask``, as the reference's
does.  The pooler's dense layer is a Flax ``nn.Dense`` in the reference;
here it is a :class:`Dense`, an ``nn.Linear`` (``weight [out, in]``)
with Flax's dtype rule, which
:func:`apex_tpu_torch.serving.bridge.from_flax_bert` transposes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.normalization.fused_layer_norm import FusedLayerNorm
from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.ops.softmax import AttnMaskType, FusedScaleMaskSoftmax
from apex_tpu_torch.parallel.collectives import axis_index, bound_axis_size
from apex_tpu_torch.parallel.mesh import TENSOR_AXIS
from apex_tpu_torch.transformer.enums import AttnType, LayerType
from apex_tpu_torch.transformer.rope import apply_rotary, rotary_cos_sin
from apex_tpu_torch.transformer.tensor_parallel import mappings
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import divide

__all__ = ["TransformerConfig", "ParallelMLP", "CoreAttention",
           "ParallelAttention", "ParallelTransformerLayer",
           "ParallelTransformer", "Embedding", "TransformerLanguageModel",
           "parallel_lm_logits", "Pooler", "dropout"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The model shape and options (the JAX config's fields of the same
    names and defaults)."""

    hidden_size: int = 128
    num_layers: int = 2
    num_attention_heads: int = 8
    ffn_hidden_size: Optional[int] = None  # default 4*hidden
    kv_channels: Optional[int] = None      # default hidden/heads
    padded_vocab_size: int = 1024
    max_position_embeddings: int = 512
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    init_method_std: float = 0.02
    layernorm_epsilon: float = 1e-5
    # the fused-softmax core's fp16 overflow guard; the flash core
    # ignores it, as the JAX flash branch does
    apply_query_key_layer_scaling: bool = True
    attention_softmax_in_fp32: bool = False
    apply_residual_connection_post_layernorm: bool = False
    bias_gelu_fusion: bool = True          # tanh-approximate GELU
    masked_softmax_fusion: bool = True
    # the flash kernels for a causal mask or padding given as segment ids;
    # anything else takes the fused-softmax core
    use_flash_attention: bool = False
    position_embedding_type: str = "learned"   # or "rope" / "none"
    rotary_base: float = 10000.0
    rotary_percent: float = 1.0
    num_query_groups: Optional[int] = None     # None = MHA
    swiglu: bool = False
    dtype: torch.dtype = torch.float32         # compute dtype
    param_dtype: torch.dtype = torch.float32
    # the transformer layers' GEMMs in fp8 with delayed scaling; the
    # metas roll in training mode only
    fp8: bool = False
    # the tensor-parallel axis of the grid (None = no tensor parallelism),
    # and Megatron sequence parallelism over it
    tensor_axis: Optional[str] = TENSOR_AXIS
    sequence_parallel: bool = False
    # the sequence-parallel collectives as rings under partial GEMMs
    overlap_comm: bool = False
    # context parallelism: the activations hold this rank's sequence
    # shard over this axis of the grid, and the causal core runs "ring"
    # (K/V chunks rotate) or "ulysses" (all-to-all head<->sequence swap)
    context_axis: Optional[str] = None
    context_impl: str = "ring"
    # mixture of experts: a Switch MLP of this many experts in the MLP
    # position, each expert's queue cut at capacity_factor * T / E tokens,
    # the experts sharded over expert_axis (None: all local)
    num_experts: Optional[int] = None
    expert_capacity_factor: float = 1.25
    expert_axis: Optional[str] = None

    def __post_init__(self):
        if self.context_axis is not None and self.sequence_parallel:
            raise ValueError(
                "context_axis and sequence_parallel are mutually exclusive:"
                " both reinterpret the sequence dimension as sharded (over"
                " cp and tp respectively) and composing them would compute"
                " attention over a misread shard layout")
        if self.context_impl not in ("ring", "ulysses"):
            raise ValueError(
                f"context_impl must be 'ring' or 'ulysses', got "
                f"{self.context_impl!r}")
        if self.position_embedding_type not in ("learned", "rope", "none"):
            raise ValueError(
                f"position_embedding_type must be 'learned', 'rope' or "
                f"'none', got {self.position_embedding_type!r}")
        if not 0.0 < self.rotary_percent <= 1.0:
            raise ValueError(
                f"rotary_percent must be in (0, 1], got "
                f"{self.rotary_percent}")
        if (self.num_query_groups is not None
                and (self.num_query_groups <= 0
                     or self.num_attention_heads % self.num_query_groups)):
            raise ValueError(
                f"num_query_groups ({self.num_query_groups}) must be "
                f"positive and divide num_attention_heads "
                f"({self.num_attention_heads})")

    @property
    def ffn_size(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.kv_channels or divide(self.hidden_size,
                                          self.num_attention_heads)

    @property
    def query_groups(self) -> int:
        """K/V head groups (== num_attention_heads for MHA)."""
        return self.num_query_groups or self.num_attention_heads

    @property
    def rotary_dim(self) -> int:
        """Rotated leading channels of each head (even, >= 2)."""
        return max(2, int(self.head_dim * self.rotary_percent) // 2 * 2)

    @property
    def tp_world(self) -> int:
        """The tensor axis's size on the grid now (1 without one)."""
        return bound_axis_size(self.tensor_axis)

    @property
    def sp(self) -> bool:
        """Sequence parallelism in force: asked for, at tp > 1."""
        return self.sequence_parallel and self.tp_world > 1

    def parallel_kw(self) -> dict:
        """The parallel linears' tensor-parallel arguments."""
        return dict(sequence_parallel=self.sequence_parallel,
                    axis=self.tensor_axis, overlap_comm=self.overlap_comm)


def _mark_sequence_parallel(module: nn.Module) -> None:
    """Mark ``module``'s parameters as whole on every rank under sequence
    parallelism: their gradients are summed over the tensor axis."""
    for p in module.parameters():
        p.sequence_parallel = True


class Dense(nn.Linear):
    """An ``nn.Linear`` (``weight [out, in]``, held in ``param_dtype``)
    with Flax ``nn.Dense``'s dtype rule: the input and the parameters are
    cast to ``dtype``, or with ``dtype=None`` to their promoted dtype."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, *, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__(in_features, out_features, bias=bias,
                         dtype=param_dtype, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


def dropout(x, rate: float, generator: Optional[torch.Generator]):
    """Flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale
    the kept values by its inverse; ``generator=None`` is deterministic."""
    if generator is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class ParallelMLP(nn.Module):
    """h -> ffn (column; tanh-GELU, or SwiGLU with a separate gate
    linear) -> h (row).  Returns ``(out, bias)`` (skip_bias_add)."""

    def __init__(self, config: TransformerConfig, *, param_dtype=None,
                 device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        kw = dict(skip_bias_add=True, dtype=cfg.dtype,
                  param_dtype=param_dtype or cfg.param_dtype, fp8=cfg.fp8,
                  device=device, **cfg.parallel_kw())
        self.dense_h_to_4h = ColumnParallelLinear(
            cfg.hidden_size, cfg.ffn_size, **kw)
        if cfg.swiglu:
            self.dense_h_to_4h_gate = ColumnParallelLinear(
                cfg.hidden_size, cfg.ffn_size, **kw)
        self.dense_4h_to_h = RowParallelLinear(
            cfg.ffn_size, cfg.hidden_size, **kw)

    def forward(self, x):
        cfg = self.config
        h, bias = self.dense_h_to_4h(x)
        if cfg.swiglu:
            gate, gate_bias = self.dense_h_to_4h_gate(x)
            h = F.silu(gate + gate_bias) * (h + bias)
        else:
            h = F.gelu(h + bias,
                       approximate="tanh" if cfg.bias_gelu_fusion else "none")
        return self.dense_4h_to_h(h)


class CoreAttention(nn.Module):
    """Scaled-dot-product attention core over ``[s, b, n, d]`` q/k/v,
    returning the context ``[s, b, n * d]``.

    With ``use_flash_attention`` and a causal mask, or padding given as
    segment ids, the flash kernels run (scale ``1/sqrt(d)``, in-kernel
    attention dropout; query-key layer scaling does not apply).  Anything
    else takes the JAX module's default core: BMM1, then
    :class:`FusedScaleMaskSoftmax` (a causal mask, or an arbitrary bool
    ``mask`` ``[b, 1, sq, sk]``, True = masked out), attention dropout,
    and BMM2.  With ``apply_query_key_layer_scaling`` the scores are
    divided by ``sqrt(d) * coeff``, ``coeff = max(1, layer_number)``, and
    the softmax multiplies them by ``coeff`` again in fp32.

    With ``context_axis`` q/k/v are this rank's sequence shard and the
    core is :mod:`~apex_tpu_torch.transformer.context_parallel`'s
    (causal only; ring attention takes no attention dropout, Ulysses draws
    its seed from ``generator``); K/V may hold fewer (grouped) heads."""

    def __init__(self, config: TransformerConfig, layer_number: int = 1,
                 attn_mask_type: AttnMaskType = AttnMaskType.padding):
        super().__init__()
        self.config = config
        self.layer_number = layer_number
        self.attn_mask_type = attn_mask_type

    def forward(self, q, k, v, mask=None, generator=None, segment_ids=None):
        cfg = self.config
        causal = self.attn_mask_type == AttnMaskType.causal
        if cfg.context_axis is not None:
            if not causal:
                # the default core would attend within the local shard only
                raise NotImplementedError(
                    "context_axis supports causal self-attention only; "
                    "non-causal attention over a cp-sharded sequence needs "
                    "ulysses_attention (context_parallel.py) wired "
                    "explicitly")
            return self._context_parallel(q, k, v, generator)
        if cfg.use_flash_attention and (causal or segment_ids is not None):
            return self._flash(q, k, v, causal, generator, segment_ids)
        sq, b, n, d = q.shape
        sk = k.shape[0]
        norm_factor = math.sqrt(d)
        coeff = None
        if cfg.apply_query_key_layer_scaling:
            coeff = max(1, self.layer_number)
            norm_factor *= coeff
        # BMM1: the JAX module divides an fp32-accumulated product before
        # any rounding, where a bf16 bmm would round its output first; so
        # q and k are upcast and the product and the division run in fp32
        # (a product of two bf16 or fp16 values is exact in fp32)
        qt = q.permute(1, 2, 0, 3).reshape(b * n, sq, d).float()
        kt = k.permute(1, 2, 0, 3).reshape(b * n, sk, d).float()
        scores = torch.bmm(qt, kt.transpose(1, 2)) / norm_factor
        scores = scores.reshape(b, n, sq, sk).to(
            torch.float32 if cfg.attention_softmax_in_fp32 else cfg.dtype)
        softmax = FusedScaleMaskSoftmax(
            input_in_fp16=cfg.dtype == torch.float16,
            input_in_bf16=cfg.dtype == torch.bfloat16,
            attn_mask_type=self.attn_mask_type,
            scaled_masked_softmax_fusion=cfg.masked_softmax_fusion,
            mask_func=None, softmax_in_fp32=True, scale=coeff)
        probs = dropout(softmax(scores, mask), cfg.attention_dropout,
                        generator).to(cfg.dtype)
        # BMM2 in the compute dtype, as the reference's batch_matmul
        ctx = torch.bmm(probs.reshape(b * n, sq, sk),
                        v.permute(1, 2, 0, 3).reshape(b * n, sk, d))
        return ctx.reshape(b, n, sq, d).permute(2, 0, 1, 3).reshape(
            sq, b, n * d)

    def _context_parallel(self, q, k, v, generator):
        from apex_tpu_torch.transformer import context_parallel as cp_lib

        cfg = self.config
        sq, b, n, d = q.shape
        kw = {}
        if cfg.attention_dropout > 0.0 and generator is not None:
            if cfg.context_impl == "ring":
                # the kernels are re-driven per visiting chunk, and the ring
                # backward has no dropout plumbing: refuse, never skip
                raise NotImplementedError(
                    "attention_dropout under ring context parallelism is "
                    "not supported; use context_impl='ulysses' or set "
                    "attention_dropout=0.0")
            kw = dict(dropout_rate=cfg.attention_dropout,
                      dropout_seed=torch.randint(
                          0, 2 ** 31 - 1, (1,), generator=generator,
                          device=q.device, dtype=torch.int32))
        attn = (cp_lib.ring_attention if cfg.context_impl == "ring"
                else cp_lib.ulysses_attention)
        ctx = attn(q.permute(1, 2, 0, 3), k.permute(1, 2, 0, 3),
                   v.permute(1, 2, 0, 3), axis=cfg.context_axis, causal=True,
                   **kw)                                # [b, n, sq, d]
        return ctx.permute(2, 0, 1, 3).reshape(sq, b, n * d)

    def _flash(self, q, k, v, causal, generator, segment_ids):
        cfg = self.config
        sq, b, n, d = q.shape
        kw = {}
        if cfg.attention_dropout > 0.0 and generator is not None:
            kw = dict(dropout_rate=cfg.attention_dropout,
                      dropout_seed=torch.randint(
                          0, 2 ** 31 - 1, (1,), generator=generator,
                          device=q.device, dtype=torch.int32))
        if segment_ids is not None:
            kw.update(segment_ids_q=segment_ids, segment_ids_kv=segment_ids)
        ctx = flash_attention(q.permute(1, 2, 0, 3), k.permute(1, 2, 0, 3),
                              v.permute(1, 2, 0, 3), causal=causal, **kw)
        return ctx.permute(2, 0, 1, 3).reshape(sq, b, n * d)


class ParallelAttention(nn.Module):
    """Self-attention: fused QKV column linear in group-major layout (per
    K/V group its query heads, then one K and one V head), RoPE on q/k,
    grouped K/V repeated over their query heads, the core, and the
    row-linear output projection.  Returns ``(out, bias)``.

    With ``context_axis`` the RoPE positions are the shard's global ones
    (``axis_index(cp) * s_local + arange(s_local)``) and grouped K/V pass
    to the core compact: the context-parallel core sends the ``g``-head
    K/V between ranks and broadcasts it locally.

    Cross attention (``attention_type=AttnType.cross_attn``): a ``query``
    column linear on ``x`` and a ``key_value`` one (never sequence
    parallel) on ``encoder_output [sk, b, h]``, split per local head into
    K and V; no RoPE, no grouped K/V, no segment ids."""

    def __init__(self, config: TransformerConfig, layer_number: int = 1,
                 attention_type: AttnType = AttnType.self_attn,
                 attn_mask_type: AttnMaskType = AttnMaskType.padding, *,
                 device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.attention_type = attention_type
        n, g, d = cfg.num_attention_heads, cfg.query_groups, cfg.head_dim
        self.hpg = divide(n, g)
        # this rank's heads and K/V groups
        self.n_local = divide(n, cfg.tp_world)
        self.g_local = divide(g, cfg.tp_world)
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, fp8=cfg.fp8,
                  device=device, **cfg.parallel_kw())
        if attention_type == AttnType.self_attn:
            self.query_key_value = ColumnParallelLinear(
                cfg.hidden_size, (n + 2 * g) * d, **kw)
        else:
            self.query = ColumnParallelLinear(cfg.hidden_size, n * d, **kw)
            self.key_value = ColumnParallelLinear(
                cfg.hidden_size, 2 * n * d,
                **dict(kw, sequence_parallel=False))
        self.core_attention = CoreAttention(cfg, layer_number, attn_mask_type)
        self.dense = RowParallelLinear(n * d, cfg.hidden_size,
                                       skip_bias_add=True, **kw)

    def forward(self, x, mask=None, generator=None, segment_ids=None, *,
                encoder_output=None):
        if self.attention_type != AttnType.self_attn:
            return self._cross(x, mask, generator, encoder_output)
        cfg = self.config
        d, hpg = cfg.head_dim, self.hpg
        qkv = self.query_key_value(x)
        s, b = qkv.shape[0], qkv.shape[1]
        qkv = qkv.reshape(s, b, self.g_local, (hpg + 2) * d)
        q = qkv[..., :hpg * d].reshape(s, b, self.n_local, d)
        k = qkv[..., hpg * d:(hpg + 1) * d]
        v = qkv[..., (hpg + 1) * d:]
        if cfg.position_embedding_type == "rope":
            positions = torch.arange(s, device=x.device)
            if cfg.context_axis is not None \
                    and bound_axis_size(cfg.context_axis) > 1:
                positions = positions + axis_index(cfg.context_axis) * s
            cos, sin = rotary_cos_sin(positions, cfg.rotary_dim,
                                      cfg.rotary_base, q.dtype)
            q, k = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
        if hpg > 1 and cfg.context_axis is None:
            k = k.repeat_interleave(hpg, dim=2)
            v = v.repeat_interleave(hpg, dim=2)
        ctx = self.core_attention(q, k, v, mask, generator, segment_ids)
        return self.dense(ctx)

    def _cross(self, x, mask, generator, encoder_output):
        d = self.config.head_dim
        q = self.query(x)
        kv = self.key_value(encoder_output)
        s, b = q.shape[0], q.shape[1]
        q = q.reshape(s, b, self.n_local, d)
        k, v = kv.reshape(kv.shape[0], b, self.n_local, 2 * d).split(d, -1)
        return self.dense(self.core_attention(q, k, v, mask, generator))


class ParallelTransformerLayer(nn.Module):
    """Pre-LN block: LN -> attention -> bias-dropout-residual -> LN ->
    MLP -> bias-dropout-residual (optionally with the post-LN residual
    source).  A decoder layer (``LayerType.decoder``) puts LN -> cross
    attention over ``encoder_output`` and ``enc_dec_mask`` ->
    bias-dropout-residual between the two, under the same residual rule.
    With ``num_experts`` the MLP is a
    :class:`~apex_tpu_torch.transformer.moe.SwitchMLP` with a zero bias of
    shape ``(1,)``; its load-balancing loss is recorded on it
    (:func:`~apex_tpu_torch.transformer.moe.collect_moe_aux`)."""

    def __init__(self, config: TransformerConfig, layer_number: int = 1,
                 layer_type: LayerType = LayerType.encoder,
                 self_attn_mask_type: AttnMaskType = AttnMaskType.padding, *,
                 device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.layer_type = layer_type
        ln = dict(param_dtype=cfg.param_dtype, device=device)
        self.input_layernorm = FusedLayerNorm(cfg.hidden_size,
                                              cfg.layernorm_epsilon, **ln)
        self.self_attention = ParallelAttention(
            cfg, layer_number, attn_mask_type=self_attn_mask_type,
            device=device)
        if layer_type == LayerType.decoder:
            self.post_inter_attention_layernorm = FusedLayerNorm(
                cfg.hidden_size, cfg.layernorm_epsilon, **ln)
            self.inter_attention = ParallelAttention(
                cfg, layer_number, attention_type=AttnType.cross_attn,
                attn_mask_type=AttnMaskType.padding, device=device)
        self.post_attention_layernorm = FusedLayerNorm(
            cfg.hidden_size, cfg.layernorm_epsilon, **ln)
        if cfg.num_experts is not None:
            from apex_tpu_torch.transformer.moe import SwitchMLP

            self.mlp = SwitchMLP(
                cfg.hidden_size, cfg.ffn_size, cfg.num_experts,
                capacity_factor=cfg.expert_capacity_factor,
                expert_axis=cfg.expert_axis, dtype=cfg.dtype,
                param_dtype=cfg.param_dtype, seed=layer_number,
                device=device)
            if cfg.sp and cfg.expert_axis != cfg.tensor_axis:
                # whole on every tensor rank, each rank routing its own
                # sequence shard: the gradients are partial sums over tp
                _mark_sequence_parallel(self.mlp)
        else:
            self.mlp = ParallelMLP(cfg, device=device)
        if cfg.sp:
            for name in ("input_layernorm", "post_inter_attention_layernorm",
                         "post_attention_layernorm"):
                if hasattr(self, name):
                    _mark_sequence_parallel(getattr(self, name))

    def forward(self, x, mask=None, generator=None, segment_ids=None, *,
                encoder_output=None, enc_dec_mask=None):
        cfg = self.config
        post = cfg.apply_residual_connection_post_layernorm
        ln1 = self.input_layernorm(x)
        attn_out, attn_bias = self.self_attention(ln1, mask, generator,
                                                  segment_ids)
        h = (ln1 if post else x) + dropout(attn_out + attn_bias,
                                           cfg.hidden_dropout, generator)
        if self.layer_type == LayerType.decoder:
            ln_cross = self.post_inter_attention_layernorm(h)
            cross_out, cross_bias = self.inter_attention(
                ln_cross, enc_dec_mask, generator,
                encoder_output=encoder_output)
            h = (ln_cross if post else h) + dropout(
                cross_out + cross_bias, cfg.hidden_dropout, generator)
        ln2 = self.post_attention_layernorm(h)
        if cfg.num_experts is not None:
            mlp_out, _ = self.mlp(ln2)
            mlp_bias = torch.zeros((1,), dtype=cfg.dtype, device=x.device)
        else:
            mlp_out, mlp_bias = self.mlp(ln2)
        return (ln2 if post else h) + dropout(mlp_out + mlp_bias,
                                              cfg.hidden_dropout, generator)


class ParallelTransformer(nn.Module):
    """Layer stack (+ final LayerNorm when ``post_process``)."""

    def __init__(self, config: TransformerConfig,
                 self_attn_mask_type: AttnMaskType = AttnMaskType.causal,
                 post_process: bool = True, *, device=None):
        super().__init__()
        cfg = config
        self.layers = nn.ModuleList(
            ParallelTransformerLayer(cfg, i + 1,
                                     self_attn_mask_type=self_attn_mask_type,
                                     device=device)
            for i in range(cfg.num_layers))
        self.final_layernorm = (
            FusedLayerNorm(cfg.hidden_size, cfg.layernorm_epsilon,
                           param_dtype=cfg.param_dtype, device=device)
            if post_process else None)
        if cfg.sp and self.final_layernorm is not None:
            _mark_sequence_parallel(self.final_layernorm)

    def forward(self, x, mask=None, generator=None, segment_ids=None):
        for layer in self.layers:
            x = layer(x, mask, generator, segment_ids)
        if self.final_layernorm is not None:
            x = self.final_layernorm(x)
        return x


class _PositionTable(nn.Module):
    """Learned positions, under the Flax ``nn.Embed`` parameter name,
    looked up in the compute dtype."""

    def __init__(self, n: int, hidden: int, *, dtype, param_dtype, device):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(
            torch.zeros(n, hidden, dtype=param_dtype, device=device))

    def forward(self, position_ids):
        return F.embedding(position_ids, self.embedding.to(self.dtype))


class Embedding(nn.Module):
    """Word (+ learned position) embeddings + hidden dropout:
    ``token_ids [b, s]`` -> ``[s, b, h]`` (contiguous), in the compute
    dtype; under sequence parallelism this rank's ``[s/tp, b, h]``."""

    def __init__(self, config: TransformerConfig, *, param_dtype=None,
                 device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.learned_positions = cfg.position_embedding_type == "learned"
        kw = dict(dtype=cfg.dtype, param_dtype=param_dtype or cfg.param_dtype,
                  device=device)
        self.word_embeddings = VocabParallelEmbedding(
            cfg.padded_vocab_size, cfg.hidden_size, axis=cfg.tensor_axis,
            reduce_scatter_embeddings=cfg.sp, **kw)
        if self.learned_positions:
            self.position_embeddings = _PositionTable(
                cfg.max_position_embeddings, cfg.hidden_size, **kw)
            if cfg.sp:
                _mark_sequence_parallel(self.position_embeddings)

    def forward(self, token_ids, position_ids=None, generator=None):
        if position_ids is not None and not self.learned_positions:
            raise NotImplementedError(
                "custom position_ids are only honored with "
                "position_embedding_type='learned'")
        cfg = self.config
        words = self.word_embeddings(token_ids)   # [b, s, h]; SP [s/tp, b, h]
        if self.learned_positions and position_ids is None:
            position_ids = torch.arange(
                token_ids.shape[1], device=token_ids.device)[None, :]
        if cfg.sp:
            x = words
            if self.learned_positions:
                # this rank's positions only: the table's gradient is a
                # partial sum, summed over the tensor axis afterwards
                n = x.shape[0]
                start = axis_index(cfg.tensor_axis) * n
                x = x + self.position_embeddings(
                    position_ids[:, start:start + n]).transpose(0, 1)
            x = x.contiguous()
        else:
            if self.learned_positions:
                words = words + self.position_embeddings(position_ids)
            x = words.transpose(0, 1).contiguous()       # [s, b, h]
        return dropout(x, cfg.hidden_dropout, generator)


class Pooler(nn.Module):
    """Tanh pooler: ``tanh(dense(hidden[sequence_index]))``, ``hidden
    [s, b, h]`` -> ``[b, h]`` in the compute dtype."""

    def __init__(self, config: TransformerConfig, *, device=None):
        super().__init__()
        cfg = config
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size, dtype=cfg.dtype,
                           param_dtype=cfg.param_dtype, device=device)

    def forward(self, hidden, sequence_index: int = 0):
        return torch.tanh(self.dense(hidden[sequence_index]))


class TransformerLanguageModel(nn.Module):
    """Embedding + transformer stack: ``token_ids [b, s]`` -> hidden
    ``[s, b, h]``; with ``add_pooler`` ``(hidden, pooled)``, ``pooled``
    the :class:`Pooler` at ``pooling_sequence_index``."""

    def __init__(self, config: TransformerConfig,
                 self_attn_mask_type: AttnMaskType = AttnMaskType.causal,
                 add_pooler: bool = False, *, device=None):
        super().__init__()
        self.embedding = Embedding(config, device=device)
        self.encoder = ParallelTransformer(
            config, self_attn_mask_type=self_attn_mask_type, device=device)
        self.pooler = Pooler(config, device=device) if add_pooler else None

    def forward(self, token_ids, position_ids=None, attention_mask=None,
                generator=None, segment_ids=None,
                pooling_sequence_index: int = 0):
        x = self.embedding(token_ids, position_ids, generator)
        hidden = self.encoder(x, attention_mask, generator, segment_ids)
        if self.pooler is None:
            return hidden
        return hidden, self.pooler(hidden, pooling_sequence_index)


def parallel_lm_logits(hidden, word_embeddings, config: TransformerConfig,
                       bias=None):
    """Tied LM head: ``hidden [s, b, h]`` against the embedding table
    ``[vocab, h]`` -> ``[s, b, vocab]`` in ``hidden``'s dtype, plus
    ``bias`` (``[vocab]``, BERT's head) when given.  At tp > 1 the table
    is this rank's ``[vocab/tp, h]`` shard and so are the logits and the
    bias; ``hidden`` enters the tensor-parallel region first (under
    sequence parallelism all-gathered from its sequence shards)."""
    cfg = config
    if cfg.sp:
        hidden = mappings.gather_from_sequence_parallel_region(
            hidden, cfg.tensor_axis, True)
    elif cfg.tp_world > 1:
        hidden = mappings.copy_to_tensor_model_parallel_region(
            hidden, cfg.tensor_axis)
    logits = torch.matmul(hidden, word_embeddings.to(hidden.dtype).t())
    if bias is not None:
        logits = logits + bias
    return logits
