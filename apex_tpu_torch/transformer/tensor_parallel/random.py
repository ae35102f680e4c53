"""The model-parallel random streams and activation checkpointing (port
of :mod:`apex_tpu.transformer.tensor_parallel.random`).

The reference folds ranks into JAX keys; here a stream is an explicit
:class:`torch.Generator`, and the key functions give the seed of one:

- :func:`model_parallel_rng_key` ``= seed + 2718 + tp_rank``, the
  stream of sharded parameters and of dropout on sharded activations:
  it differs across tensor-parallel ranks and agrees across data-parallel
  ones (NVIDIA Apex's ``model_parallel_cuda_manual_seed`` policy);
- :func:`data_parallel_rng_key`, a seed of its own per rank of ``axis``.

:func:`model_parallel_seed` registers the model-parallel stream on the
tracker and returns the default stream, ``seed`` itself, the same on
every rank.  ``tracker.fork(name)`` gives the named generator, which a
module takes as its ``generator=``.

:func:`checkpoint` recomputes its function in the backward instead of
keeping its activations, with the state of every generator it was given
(and of the tracker's) put back for the recomputation, so dropout draws
the same masks twice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.utils.checkpoint

from apex_tpu_torch.parallel import collectives as cc
from apex_tpu_torch.parallel.mesh import TENSOR_AXIS

__all__ = [
    "MODEL_PARALLEL_RNG_OFFSET",
    "model_parallel_rng_key",
    "data_parallel_rng_key",
    "RngStatesTracker",
    "get_rng_states_tracker",
    "model_parallel_seed",
    "checkpoint",
]

# the fixed offset between the model-parallel stream and the default one
MODEL_PARALLEL_RNG_OFFSET = 2718
_MIX = 0x9E3779B97F4A7C15


def _rank(axis) -> int:
    return 0 if cc.bound_axis_size(axis) == 1 else cc.axis_index(axis)


def model_parallel_rng_key(seed: int, axis: Optional[str] = TENSOR_AXIS) -> int:
    """The seed of this tensor-parallel rank's stream:
    ``seed + 2718 + tp_rank`` (``seed`` itself for ``axis=None``)."""
    if axis is None:
        return seed
    return seed + MODEL_PARALLEL_RNG_OFFSET + _rank(axis)


def data_parallel_rng_key(seed: int, axis) -> int:
    """A seed of this rank of ``axis`` (a distinct dropout stream per
    replica's batch)."""
    return (seed * _MIX + _rank(axis) + 1) % (1 << 63)


class RngStatesTracker:
    """Named random streams, each a :class:`torch.Generator`."""

    def __init__(self):
        self._gens: Dict[str, torch.Generator] = {}

    def reset(self) -> None:
        self._gens.clear()

    def get_states(self) -> Dict[str, torch.Tensor]:
        return {k: g.get_state() for k, g in self._gens.items()}

    def set_states(self, states: Dict[str, torch.Tensor]) -> None:
        """Put each named stream back to a state of :meth:`get_states`."""
        for name, state in states.items():
            if name not in self._gens:
                raise RuntimeError(f"rng state {name} is not added")
            self._gens[name].set_state(state)

    def add(self, name: str, seed: int, device=None) -> None:
        if name in self._gens:
            raise RuntimeError(f"rng state {name} already exists")
        gen = torch.Generator(device=device or "cpu")
        gen.manual_seed(seed)
        self._gens[name] = gen

    def fork(self, name: str = "model-parallel-rng") -> torch.Generator:
        """The named stream; each draw from it moves it on."""
        if name not in self._gens:
            raise RuntimeError(f"rng state {name} is not added")
        return self._gens[name]

    def generators(self):
        return list(self._gens.values())


_TRACKER = RngStatesTracker()


def get_rng_states_tracker() -> RngStatesTracker:
    return _TRACKER


def model_parallel_seed(seed: int, axis: Optional[str] = TENSOR_AXIS,
                        device=None) -> torch.Generator:
    """Reset the tracker with the ``"model-parallel-rng"`` stream
    (:func:`model_parallel_rng_key`) and return the default stream, a
    generator seeded with ``seed``, on ``device`` (default the CPU)."""
    _TRACKER.reset()
    _TRACKER.add("model-parallel-rng", model_parallel_rng_key(seed, axis),
                 device)
    gen = torch.Generator(device=device or "cpu")
    gen.manual_seed(seed)
    return gen


def checkpoint(fn, *args, use_reentrant: bool = True, policy=None,
               **kwargs):
    """``fn(*args, **kwargs)`` with its activations recomputed in the
    backward.  The generators among the arguments and the tracker's are
    put back to their states of the first call for the recomputation, and
    then to where the first call left them.  ``use_reentrant`` is
    accepted for the reference's signature; the recomputation is always
    the non-reentrant kind.  ``policy`` (what to keep) has no counterpart
    and must be ``None``."""
    del use_reentrant
    if policy is not None:
        raise ValueError("checkpoint policies are a JAX feature; pass "
                         "policy=None")
    gens = [a for a in (*args, *kwargs.values())
            if isinstance(a, torch.Generator)] + _TRACKER.generators()
    before = [g.get_state() for g in gens]
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*a, **kwargs)
        after = [g.get_state() for g in gens]
        for g, s in zip(gens, before):
            g.set_state(s)
        try:
            return fn(*a, **kwargs)
        finally:
            for g, s in zip(gens, after):
                g.set_state(s)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False,
                                             preserve_rng_state=True)
