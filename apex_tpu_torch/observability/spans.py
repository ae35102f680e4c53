"""Span timers and profiler ranges (port of
:mod:`apex_tpu.observability.spans`).

- :func:`named_span` — a ``torch.profiler.record_function`` range
  (``apex/<name>``) around device work, so a captured trace groups the
  kernels under readable names; the reference's ``jax.named_scope``.
- :func:`span` — for host code (checkpoint save/verify/restore, data
  loading, the step loop): times the block, records ``span_ms/<name>``
  into a :class:`~apex_tpu_torch.observability.metrics.MetricRegistry`
  histogram, and opens a ``record_function`` range so a captured trace
  carries the interval (the ``nvtx.range_push`` analog).
- :func:`step_trace` — a ``record_function`` range named for one
  training step (``train_step#<n>``), the reference's
  ``StepTraceAnnotation``.
- :class:`TraceWindow` — windowed programmatic capture: every
  ``every_n`` steps a ``torch.profiler.profile`` runs for
  ``capture_steps`` steps and writes a Chrome trace under
  ``<logdir>/step_<step>``, so a long run leaves small captures.

A host span measures launch time unless its block waits for the card
itself (``torch.cuda.synchronize``, file I/O).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Optional

__all__ = ["named_span", "span", "step_trace", "TraceWindow"]

logger = logging.getLogger(__name__)

# one shared prefix so apex ranges are greppable in a trace
_PREFIX = "apex"


def named_span(name: str):
    """A profiler range ``apex/<name>`` (``with named_span("zero/rs")``);
    adds no device work."""
    import torch

    return torch.profiler.record_function(f"{_PREFIX}/{name}")


@contextlib.contextmanager
def span(name: str, *, registry=None):
    """Host wall-clock span: times the block into the registry's
    ``span_ms/<name>`` histogram (default: the rank-aware default
    registry) inside a profiler range of the same name."""
    import torch

    if registry is None:
        from apex_tpu_torch.observability.metrics import default_registry

        registry = default_registry()
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(f"{_PREFIX}/{name}"):
            yield
    finally:
        registry.histogram(f"span_ms/{name}").observe(
            (time.perf_counter() - t0) * 1e3)


def step_trace(step_num: int, name: str = "train_step"):
    """A profiler range for one training step::

        with step_trace(step):
            loss = train_step(params, tokens)
    """
    import torch

    return torch.profiler.record_function(f"{name}#{step_num}")


class _TorchProfiler:
    """``start_trace(dir)`` / ``stop_trace()`` over ``torch.profiler``
    (the CPU always, the card where there is one), the Chrome trace
    written into the window's directory."""

    def __init__(self):
        self._prof = None
        self._dir = None

    def start_trace(self, path: str) -> None:
        import torch

        if self._prof is not None:
            raise RuntimeError("a trace is already active")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        self._prof, self._dir = prof, path

    def stop_trace(self) -> None:
        prof, path = self._prof, self._dir
        if prof is None:
            raise RuntimeError("no trace is active")
        self._prof = self._dir = None
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(path, "trace.json"))


class TraceWindow:
    """Windowed programmatic profiler capture.

    ``on_step(step)`` once per training step: at every ``every_n``-th
    step a capture starts into ``<logdir>/step_<step>``, and after
    ``capture_steps`` more calls it stops.  A profiler failure (another
    capture active, no profiler) is logged and disables the window
    rather than ending the run.  ``_profiler`` (``start_trace(path)``,
    ``stop_trace()``) is injectable for tests.
    """

    def __init__(self, logdir: str, *, every_n: int = 100,
                 capture_steps: int = 3, enabled: bool = True,
                 _profiler=None):
        if every_n < 1 or capture_steps < 1:
            raise ValueError(
                f"every_n ({every_n}) and capture_steps ({capture_steps}) "
                "must be >= 1")
        self.logdir = logdir
        self.every_n = every_n
        self.capture_steps = capture_steps
        self.enabled = enabled
        self.windows_captured = 0
        self._active_until: Optional[int] = None
        self._profiler = (_profiler if _profiler is not None
                          else _TorchProfiler())

    @property
    def active(self) -> bool:
        return self._active_until is not None

    def on_step(self, step: int) -> None:
        if not self.enabled:
            return
        if self._active_until is not None:
            if step >= self._active_until:
                self._stop()
            return
        if step % self.every_n == 0:
            path = os.path.join(self.logdir, f"step_{step:08d}")
            try:
                os.makedirs(path, exist_ok=True)
                self._profiler.start_trace(path)
            except Exception as e:  # profiler unavailable / double start
                logger.warning(
                    "TraceWindow disabled: start_trace failed (%r)", e)
                self.enabled = False
                return
            self._active_until = step + self.capture_steps

    def _stop(self) -> None:
        try:
            self._profiler.stop_trace()
            self.windows_captured += 1
        except Exception as e:
            logger.warning("TraceWindow stop_trace failed (%r)", e)
            self.enabled = False
        self._active_until = None

    def close(self) -> None:
        """Stop any capture in flight (at shutdown, so the last window is
        written rather than lost)."""
        if self._active_until is not None:
            self._stop()

    def __enter__(self) -> "TraceWindow":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
