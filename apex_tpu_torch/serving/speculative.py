"""Self-speculative drafting: n-gram / prompt-lookup proposal, host side.

Port of :mod:`apex_tpu.serving.speculative` (numpy only, copied rather
than imported so the port never loads the JAX package).

Speculative decoding splits each decode tick into *propose* and
*verify*.  This module is the propose half, with no draft model: a
request's own token stream (prompt + everything it has emitted) is the
draft source.  The suffix of the stream is matched against its earlier
occurrences and the tokens that followed last time are proposed.  The
verify half is the ``[max_batch, k + 1]`` step of
:meth:`~apex_tpu_torch.serving.model.DecodeModel.decode_step`, whose
accepted tokens are the tokens the non-speculative engine would have
produced (greedy argmax, or the ``(seed, step)``-keyed draws of
:mod:`.sampling`).  A wrong draft costs one wasted query position, never
a wrong token.

**Adaptive back-off**: a request whose proposals keep getting fully
rejected (``backoff`` consecutive zero-accept ticks) stops drafting,
re-probes with a single-token proposal every ``probe_every`` quiet
ticks, and one accepted probe re-arms it.  The counters ride the
:class:`~apex_tpu_torch.serving.scheduler.Request`, so preemption and
recompute-on-readmit keep a request's drafting posture; an
adapter-tagged request keys them per ``(slot, adapter_id)`` instead.

The engine's proposer slot is duck-typed (``propose(req, max_k)`` /
``observe(req, proposed, accepted)``), which is how tests drive the
verify step with oracle and always-wrong drafts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["SpeculativeConfig", "NGramProposer", "ngram_propose"]


@dataclasses.dataclass(frozen=True)
class SpeculativeConfig:
    """Knobs of the self-speculative decode.

    ``k`` — max drafted tokens per slot per tick; the decode step
    always runs at the fixed ``[max_batch, k + 1]`` verify shape, and
    every per-slot draft count in ``[0, k]`` is data.  ``max_ngram`` /
    ``min_ngram`` — suffix lengths tried (longest first) when matching
    the stream against its own history.  ``backoff`` — consecutive
    fully-rejected proposals before a request stops drafting (its tick
    count degrades to the plain one-tick-per-token cadence, never
    below it).
    ``probe_every`` — a backed-off request re-probes with a
    single-token proposal every this-many quiet ticks: a stream that
    turns self-predictive later (a template tail, a greedy cycle) gets
    its drafting back — one accepted probe re-arms it — while a
    hopeless stream wastes one query position per ``probe_every``
    ticks, not k per tick.
    """

    k: int = 4
    max_ngram: int = 3
    min_ngram: int = 1
    backoff: int = 4
    probe_every: int = 16

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(
                f"speculative k must be >= 1 (omit the config to disable "
                f"speculation), got {self.k}")
        if self.min_ngram < 1 or self.max_ngram < self.min_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"min {self.min_ngram} / max {self.max_ngram}")
        if self.backoff < 1:
            raise ValueError(f"backoff must be >= 1, got {self.backoff}")
        if self.probe_every < 1:
            raise ValueError(
                f"probe_every must be >= 1, got {self.probe_every}")


def ngram_propose(tokens: Sequence[int], k: int, *, max_ngram: int = 3,
                  min_ngram: int = 1) -> List[int]:
    """Prompt-lookup drafts: up to ``k`` tokens continuing ``tokens``.

    For n from ``max_ngram`` down to ``min_ngram``: take the stream's
    last n tokens and find their most recent *earlier* occurrence; on a
    hit, propose the ``k`` tokens that followed it.  The continuation
    may overlap the suffix and **self-extend** past the stream's end
    (a draft near the tail keeps reading from its own proposal), which
    is what makes a cycling stream — the tiny-model greedy attractor,
    and any periodic template — fully self-predictive at full width.
    Vectorized over a sliding window view — O(len) per n, no Python
    inner loop over the stream.  Returns ``[]`` on no match.
    """
    L = len(tokens)
    if k < 1 or L < min_ngram + 1:
        return []
    arr = np.asarray(tokens, np.int64)
    for n in range(min(max_ngram, L - 1), min_ngram - 1, -1):
        suffix = arr[L - n:]
        # windows of arr starting at 0 .. L-1-n: every occurrence
        # strictly before the suffix's own position
        windows = np.lib.stride_tricks.sliding_window_view(arr[:-1], n)
        hits = np.nonzero((windows == suffix).all(axis=1))[0]
        if hits.size:
            start = int(hits[-1]) + n         # most recent occurrence
            out: List[int] = []
            for j in range(k):
                idx = start + j
                out.append(int(arr[idx]) if idx < L else out[idx - L])
            return out
    return []


class NGramProposer:
    """Per-request adaptive wrapper over :func:`ngram_propose` — the
    engine's default proposer when ``ServingConfig.speculative`` is
    set.

    Back-off keying: an adapter-tagged request
    (``req.sampling.adapter_id`` set) keys its back-off/re-arm state
    per ``(slot, adapter_id)`` instead of per request, so one
    template-poor tenant backing off cannot silence drafting for a
    different adapter that later lands in the same slot — and a
    well-predicted adapter's re-arm survives across that tenant's
    consecutive requests.  Bare requests keep the original per-request
    counters (``req.spec_fails`` / ``req.spec_quiet``) untouched."""

    _STATE_CAP = 1024   # bounded (slot, adapter) memory

    def __init__(self, config: SpeculativeConfig):
        self.config = config
        # (slot, adapter_id) -> [fails, quiet]
        self._adapter_state: Dict[Tuple[int, str], List[int]] = {}

    def _keyed(self, req) -> Optional[List[int]]:
        """The (slot, adapter) back-off cell, or None for bare/unslotted
        requests (those keep per-request state)."""
        aid = getattr(req.sampling, "adapter_id", None) \
            if req.sampling is not None else None
        if aid is None or req.slot is None:
            return None
        key = (req.slot, aid)
        cell = self._adapter_state.get(key)
        if cell is None:
            if len(self._adapter_state) >= self._STATE_CAP:
                self._adapter_state.pop(
                    next(iter(self._adapter_state)))
            cell = self._adapter_state[key] = [0, 0]
        return cell

    def propose(self, req, max_k: int) -> List[int]:
        """Draft up to ``max_k`` tokens for ``req`` (the engine has
        already clamped ``max_k`` to the context cap, the remaining
        budget, and the configured ``k``).  A backed-off request
        proposes nothing — except one probe every ``probe_every`` quiet
        ticks, which is what makes the documented re-arm reachable (the
        engine only reports verify outcomes for ticks that drafted)."""
        cell = self._keyed(req)
        fails = cell[0] if cell is not None else req.spec_fails
        if fails >= self.config.backoff:
            if cell is not None:
                cell[1] += 1
                quiet, reset = cell[1], (lambda: cell.__setitem__(1, 0))
            else:
                req.spec_quiet += 1
                quiet = req.spec_quiet
                reset = (lambda: setattr(req, "spec_quiet", 0))
            if quiet < self.config.probe_every:
                return []
            reset()
            max_k = min(max_k, 1)   # a probe wastes ONE query position
        return ngram_propose(
            req.sequence_tokens(), max_k,
            max_ngram=self.config.max_ngram,
            min_ngram=self.config.min_ngram)

    def observe(self, req, proposed: int, accepted: int) -> None:
        """Account one verify outcome: a fully-rejected proposal counts
        toward the back-off, any acceptance re-arms the request (for an
        adapter-tagged request: re-arms the *(slot, adapter)* cell)."""
        if proposed <= 0:
            return
        cell = self._keyed(req)
        if cell is not None:
            cell[0] = 0 if accepted > 0 else cell[0] + 1
        elif accepted > 0:
            req.spec_fails = 0
        else:
            req.spec_fails += 1
