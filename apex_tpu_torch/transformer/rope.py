"""Rotary position embeddings (port of :mod:`apex_tpu.transformer.rope`).

Half-rotation layout: the first ``rotary_dim`` channels of each head turn
as two contiguous halves; channels past it pass through.  The tables are
computed in fp32 and cast to the activations' dtype, as in the JAX
package.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["rotary_cos_sin", "apply_rotary", "apply_rotary_decode",
           "apply_rotary_packed"]


def rotary_cos_sin(positions, rotary_dim: int, base: float = 10000.0,
                   dtype=torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``positions [s]`` -> ``(cos, sin)``, each ``[s, rotary_dim / 2]``."""
    if rotary_dim % 2:
        raise ValueError(f"rotary_dim must be even, got {rotary_dim}")
    exponent = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                            device=positions.device) / rotary_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(base, dtype=torch.float32,
                                            device=positions.device),
                               exponent)
    angles = positions.float()[:, None] * inv_freq[None, :]
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def _rotate(x, cos, sin):
    """Half-rotation with cos/sin already broadcast to x's rank."""
    half = cos.shape[-1]
    rotary_dim = 2 * half
    x1 = x[..., :half]
    x2 = x[..., half:rotary_dim]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if rotary_dim == x.shape[-1]:
        return rotated
    return torch.cat([rotated, x[..., rotary_dim:]], dim=-1)


def apply_rotary(x, cos, sin):
    """Training rotation: ``x [s, b, n, d]`` (Megatron's ``[sq, b, np,
    hn]`` layout) with tables ``[s, half]`` broadcast over batch and
    heads."""
    return _rotate(x, cos[:, None, None, :], sin[:, None, None, :])


def apply_rotary_packed(x, cos, sin):
    """Chunked-prefill rotation: ``x [s, b, n, d]`` with tables
    ``[s, b, half]`` (each slot's chunk at its own absolute positions)."""
    return _rotate(x, cos[:, :, None, :], sin[:, :, None, :])


def apply_rotary_decode(x, cos, sin):
    """Decode rotation: ``x [1, b, n, d]`` with per-slot tables ``[b, half]``."""
    return _rotate(x, cos[None, :, None, :], sin[None, :, None, :])
