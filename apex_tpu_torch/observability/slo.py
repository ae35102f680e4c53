"""SLO policies and multi-window burn-rate alerting over the metric
history (port of :mod:`apex_tpu.observability.slo`).

The Google-SRE construction, applied to the fleet's own longitudinal
store: an :class:`SLOPolicy` names a history series (``*`` segments
expand per tenant/priority/adapter), an objective a bucket must stay
under, a compliance window with an error budget (``1 - target``), and a
fast/slow window pair of burn-rate thresholds.  The **burn rate** over
a window is the bad-bucket fraction divided by the budget: burn 1.0
consumes exactly the budget over the compliance window, burn 14 over a
short window is a page.  An alert fires only when BOTH the fast and the
slow window burn over their thresholds (the fast window gives speed,
the slow window kills one-bucket blips), and clears only after the
condition has stayed healthy for ``clear_after_s`` — hysteresis, so a
metric flapping across the objective cannot produce an alert storm.
The math is pure bucket arithmetic on the injected clock, pinned golden
by ``tests/test_slo.py``.

Every transition is a typed timeline event — ``slo_burn_alert`` /
``slo_burn_clear`` with the evidence (both burns, remaining budget)
in-record, plus a low-cadence ``slo_state`` snapshot carrying the full
budget table so ``scripts/slo_report.py`` can reconstruct the alert
timeline and budget state offline from the ordinary fleet spill.  The
kinds close through analyzer rule APX302: consumed by
``observability/trace.py`` (``collect_slo_events``), no allowlist
entries.

Evaluation is deliberately deterministic and cheap: one pass over ring
buckets per armed policy per cadence tick, no wall clock, no threads —
the router calls :meth:`SLOEvaluator.evaluate` from its pump loop and
serves :attr:`SLOEvaluator.last_rows` at ``/fleet/statusz``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from apex_tpu_torch.observability import timeline
from apex_tpu_torch.observability.timeseries import MetricHistory

__all__ = ["SLOPolicy", "SLOEvaluator"]


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """One objective over one history series (or a ``*`` family).

    A history bucket is *bad* when its ``field`` aggregate exceeds
    ``objective``; the error budget is ``1 - target`` of buckets over
    the compliance window.  ``fast_burn``/``slow_burn`` are the
    multi-window thresholds (SRE ch. 5 defaults: 14x over the fast
    window AND 6x over the slow one)."""

    name: str
    metric: str                        # e.g. "fleet/ttft_ms:p99"
    objective: float                   # bad when field value > objective
    target: float = 0.999              # good-bucket compliance target
    compliance_window_s: float = 3600.0
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    fast_burn: float = 14.0
    slow_burn: float = 6.0
    clear_after_s: float = 60.0        # sustained recovery before clear
    field: str = "mean"                # bucket aggregate judged

    def __post_init__(self):
        if not self.name or not self.metric:
            raise ValueError("SLOPolicy needs a name and a metric")
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"target must be in (0, 1): {self.target}")
        if not (0.0 < self.fast_window_s <= self.slow_window_s
                <= self.compliance_window_s):
            raise ValueError(
                "windows must satisfy 0 < fast <= slow <= compliance")
        if self.fast_burn <= 0 or self.slow_burn <= 0:
            raise ValueError("burn thresholds must be positive")
        if self.clear_after_s < 0:
            raise ValueError("clear_after_s must be >= 0")
        if self.field not in ("mean", "max", "last"):
            raise ValueError(f"unknown field {self.field!r}")

    @property
    def budget(self) -> float:
        return 1.0 - self.target


def _bad_fraction(history: MetricHistory, series: str, policy: SLOPolicy,
                  window_s: float, now: float) -> float:
    """Bad-bucket fraction over the trailing window (0.0 with no data:
    an idle fleet burns nothing)."""
    return history.bad_fraction(series, window_s, policy.objective,
                                now=now, field=policy.field)


class SLOEvaluator:
    """Burn-rate evaluation + hysteresis alert state over one history."""

    def __init__(self, history: MetricHistory,
                 policies: Sequence[SLOPolicy], *,
                 clock=None, state_every_s: float = 1.0):
        self.history = history
        self.policies: Tuple[SLOPolicy, ...] = tuple(policies)
        self._clock = clock if clock is not None else history._clock
        self.state_every_s = float(state_every_s)
        # (policy.name, series) -> {"alerting", "since", "recover_t"}
        self._state: Dict[Tuple[str, str], dict] = {}
        self._last_state_emit: Optional[float] = None
        self.alerts = 0
        self.clears = 0
        self.last_rows: List[dict] = []

    def _row(self, policy: SLOPolicy, series: str, now: float) -> dict:
        burn_fast = _bad_fraction(self.history, series, policy,
                                  policy.fast_window_s, now) / policy.budget
        burn_slow = _bad_fraction(self.history, series, policy,
                                  policy.slow_window_s, now) / policy.budget
        consumed = _bad_fraction(self.history, series, policy,
                                 policy.compliance_window_s, now) \
            / policy.budget
        remaining = 1.0 - consumed
        if burn_slow > 0 and remaining > 0:
            exhaustion_s = remaining * policy.compliance_window_s / burn_slow
        elif remaining <= 0:
            exhaustion_s = 0.0
        else:
            exhaustion_s = None
        return {"policy": policy.name, "metric": series,
                "objective": policy.objective,
                "burn_fast": round(burn_fast, 4),
                "burn_slow": round(burn_slow, 4),
                "budget_remaining": round(remaining, 6),
                "exhaustion_s": (None if exhaustion_s is None
                                 else round(exhaustion_s, 3)),
                "alerting": False}

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One cadence tick: recompute every (policy, series) row, walk
        the hysteresis state machine, emit transition events."""
        t = self._clock() if now is None else float(now)
        rows: List[dict] = []
        live_keys = set()
        for policy in self.policies:
            matched = self.history.match(policy.metric)
            if not matched and "*" not in policy.metric:
                matched = [policy.metric]   # explicit series: report idle
            for series in matched:
                key = (policy.name, series)
                live_keys.add(key)
                row = self._row(policy, series, t)
                state = self._state.get(key)
                if state is None:
                    state = self._state[key] = {
                        "alerting": False, "since": None, "recover_t": None}
                firing = (row["burn_fast"] >= policy.fast_burn
                          and row["burn_slow"] >= policy.slow_burn)
                if not state["alerting"]:
                    if firing:
                        state["alerting"] = True
                        state["since"] = t
                        state["recover_t"] = None
                        self.alerts += 1
                        timeline.emit(
                            "slo_burn_alert", policy=policy.name,
                            metric=series, burn_fast=row["burn_fast"],
                            burn_slow=row["burn_slow"],
                            budget_remaining=row["budget_remaining"],
                            objective=policy.objective)
                else:
                    if firing:
                        state["recover_t"] = None   # relapse resets
                    else:
                        if state["recover_t"] is None:
                            state["recover_t"] = t
                        if t - state["recover_t"] >= policy.clear_after_s:
                            state["alerting"] = False
                            state["since"] = None
                            state["recover_t"] = None
                            self.clears += 1
                            timeline.emit(
                                "slo_burn_clear", policy=policy.name,
                                metric=series,
                                burn_fast=row["burn_fast"],
                                burn_slow=row["burn_slow"],
                                budget_remaining=row["budget_remaining"])
                row["alerting"] = state["alerting"]
                rows.append(row)
        # a series cap-evicted upstream keeps no ghost alert state
        for key in [k for k in self._state if k not in live_keys]:
            del self._state[key]
        self.last_rows = rows
        if timeline.active() is not None and rows and (
                self._last_state_emit is None
                or t - self._last_state_emit >= self.state_every_s):
            self._last_state_emit = t
            timeline.emit("slo_state", rows=rows)
        return rows

    def worst(self) -> Optional[dict]:
        """The worst-burning row of the last evaluation (slow-window
        burn is the ranking: it is the one that exhausts budgets)."""
        if not self.last_rows:
            return None
        return max(self.last_rows, key=lambda r: r["burn_slow"])

    def introspect(self) -> dict:
        return {"policies": len(self.policies),
                "series_tracked": len(self._state),
                "alerts": self.alerts, "clears": self.clears,
                "alerting": sorted(
                    f"{p}:{m}" for (p, m), s in self._state.items()
                    if s["alerting"])}
