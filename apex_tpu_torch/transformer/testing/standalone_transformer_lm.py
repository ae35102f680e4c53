"""The standalone Megatron-style LM pieces the serving path uses.

Port of the parts of
:mod:`apex_tpu.transformer.testing.standalone_transformer_lm` that a
served GPT reads: the configuration, the MLP, the embedding and the tied
LM head, at tensor-parallel size 1.  Activations keep the JAX package's
``[s, b, h]`` (sequence-major) layout.  Serving runs no dropout, so the
dropout fields of the JAX config have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import divide

__all__ = ["TransformerConfig", "ParallelMLP", "Embedding",
           "parallel_lm_logits"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The model shape the serving path reads (the JAX config's fields of
    the same names and defaults)."""

    hidden_size: int = 128
    num_layers: int = 2
    num_attention_heads: int = 8
    ffn_hidden_size: Optional[int] = None  # default 4*hidden
    kv_channels: Optional[int] = None      # default hidden/heads
    padded_vocab_size: int = 1024
    max_position_embeddings: int = 512
    init_method_std: float = 0.02
    layernorm_epsilon: float = 1e-5
    apply_residual_connection_post_layernorm: bool = False
    bias_gelu_fusion: bool = True          # tanh-approximate GELU
    position_embedding_type: str = "learned"   # or "rope" / "none"
    rotary_base: float = 10000.0
    rotary_percent: float = 1.0
    num_query_groups: Optional[int] = None     # None = MHA
    swiglu: bool = False
    dtype: torch.dtype = torch.float32         # compute dtype
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
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


class ParallelMLP(nn.Module):
    """h -> ffn (column; tanh-GELU, or SwiGLU with a separate gate
    linear) -> h (row).  Returns ``(out, bias)`` (skip_bias_add)."""

    def __init__(self, config: TransformerConfig, *, device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        kw = dict(skip_bias_add=True, dtype=cfg.dtype, device=device)
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


class _PositionTable(nn.Module):
    """Learned positions, under the Flax ``nn.Embed`` parameter name."""

    def __init__(self, n: int, hidden: int, *, dtype, device):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.zeros(n, hidden, dtype=dtype, device=device),
            requires_grad=False)

    def forward(self, position_ids):
        return F.embedding(position_ids, self.embedding)


class Embedding(nn.Module):
    """Word (+ learned position) embeddings: ``token_ids [b, s]`` ->
    ``[s, b, h]`` (contiguous), in the compute dtype."""

    def __init__(self, config: TransformerConfig, *, device=None):
        super().__init__()
        cfg = config
        self.learned_positions = cfg.position_embedding_type == "learned"
        self.word_embeddings = VocabParallelEmbedding(
            cfg.padded_vocab_size, cfg.hidden_size, dtype=cfg.dtype,
            device=device)
        if self.learned_positions:
            self.position_embeddings = _PositionTable(
                cfg.max_position_embeddings, cfg.hidden_size,
                dtype=cfg.dtype, device=device)

    def forward(self, token_ids, position_ids=None):
        if position_ids is not None and not self.learned_positions:
            raise NotImplementedError(
                "custom position_ids are only honored with "
                "position_embedding_type='learned'")
        words = self.word_embeddings(token_ids)          # [b, s, h]
        if self.learned_positions:
            if position_ids is None:
                position_ids = torch.arange(
                    token_ids.shape[1], device=token_ids.device)[None, :]
            words = words + self.position_embeddings(position_ids)
        return words.transpose(0, 1).contiguous()         # [s, b, h]


def parallel_lm_logits(hidden, word_embeddings, config: TransformerConfig):
    """Tied LM head: ``hidden [s, b, h]`` against the embedding table
    ``[vocab, h]`` -> ``[s, b, vocab]`` in ``hidden``'s dtype."""
    return torch.matmul(hidden, word_embeddings.to(hidden.dtype).t())
