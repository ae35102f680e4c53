"""Sampling policies: temperature / top-k / top-p with per-request seeds.

Port of :mod:`apex_tpu.serving.sampling`.  Policies are ``[max_batch]``
tensors (data, not shape), one entry per slot.

- **Greedy** (``temperature == 0``, the default) is the exact fp32 argmax
  (the first index on ties), which every token-identity check rests on.
- **Seeded sampling** filters in the JAX package's order (temperature,
  then top-k at the k-th largest logit, then top-p over the sorted
  distribution, the argmax always kept) and draws each slot's token with
  a ``torch.Generator`` seeded from ``(seed, step)``, where ``step`` is
  the request's output-token counter.  A preempted request replayed
  through prefill resumes at the same counter and redraws the same
  stream.  The bits differ from JAX's threefry draws; the distribution
  is the same.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["SamplingParams", "sample_tokens", "filtered_logits"]

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """One request's sampling policy.  ``temperature == 0`` is greedy;
    ``top_k <= 0`` / ``top_p >= 1`` leave those filters off; draw ``i``
    of a request is keyed on ``(seed, step_offset + i)``.

    ``adapter_id`` names the LoRA adapter the request decodes under
    (:mod:`.lora`): ``None``, the default, gathers the permanent zero
    adapter and is bitwise the bare engine.  The engine resolves it to
    an arena slot at submit (an unknown id is ``REJECTED``)."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    step_offset: int = 0
    adapter_id: Optional[str] = None

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.step_offset < 0:
            raise ValueError(
                f"step_offset must be >= 0, got {self.step_offset}")


def filtered_logits(logits, temperature, top_k, top_p):
    """``logits [B, vocab]`` (fp32) scaled by temperature, with tokens
    outside the top-k / top-p sets set to -1e30."""
    vocab = logits.shape[-1]
    x = logits / temperature.float().clamp_min(1e-6)[:, None]
    top_k = top_k.long()
    sorted_desc = torch.sort(x, dim=-1, descending=True).values
    kth = sorted_desc.gather(1, (top_k - 1).clamp(0, vocab - 1)[:, None])
    x = torch.where((top_k[:, None] > 0) & (x < kth), _NEG, x)
    probs = torch.softmax(x, dim=-1)
    order = torch.argsort(-x, dim=-1, stable=True)
    p_sorted = probs.gather(1, order)
    keep_sorted = (torch.cumsum(p_sorted, dim=-1) - p_sorted) \
        < top_p.float()[:, None]
    keep = torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)
    return torch.where(keep, x, _NEG)


_M64 = (1 << 64) - 1


def _generator(device, seed: int, step: int) -> torch.Generator:
    """A generator keyed on ``(seed, step)`` through splitmix64, so every
    bit of its seed depends on both: the CPU generator (mt19937) keeps
    only the low 32 bits of the seed it is given."""
    z = (((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    gen = torch.Generator(device=device)
    gen.manual_seed(z ^ (z >> 31))
    return gen


def sample_tokens(logits, temperature, top_k, top_p, seeds, steps):
    """One token per slot from ``logits [B, vocab]``; the policy arguments
    are ``[B]`` tensors.  Returns int64 ``[B]``.  An all-greedy batch does
    one argmax and nothing else."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    drawn = (temperature > 0).nonzero().flatten().tolist()
    if not drawn:
        return greedy
    x = filtered_logits(logits[drawn], temperature[drawn], top_k[drawn],
                        top_p[drawn])
    probs = torch.softmax(x, dim=-1)
    out = greedy.clone()
    seeds = seeds.tolist()
    steps = steps.tolist()
    for row, slot in enumerate(drawn):
        gen = _generator(logits.device, int(seeds[slot]), int(steps[slot]))
        out[slot] = torch.multinomial(probs[row], 1, generator=gen)[0]
    return out
