"""Packed-sequence helpers (the part of :mod:`apex_tpu.data.sequence`
that the packed 3D GPT step needs)."""

from __future__ import annotations

import torch

__all__ = ["segment_loss_mask"]


def segment_loss_mask(segments: torch.Tensor) -> torch.Tensor:
    """The next-token loss mask ``[b, s - 1]`` (fp32) of packed rows:
    position ``t`` (predicting token ``t + 1``) counts iff both tokens are
    in the same document and neither is padding (segment id 0)."""
    same = segments[:, 1:] == segments[:, :-1]
    real = segments[:, 1:] > 0
    return (same & real).to(torch.float32)
