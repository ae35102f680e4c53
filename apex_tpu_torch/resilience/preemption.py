"""SIGTERM-driven clean shutdown (port of
:mod:`apex_tpu.resilience.preemption`).

A preemptible host gets a SIGTERM some time before the SIGKILL.
:class:`PreemptionGuard` catches the signal and sets a flag; the loop
reads the flag at its step boundary and winds down.  The serving engine
drains on it (:meth:`~apex_tpu_torch.serving.engine.ServingEngine.step`):
no more admissions, the running requests deliver, the queue is
cancelled.  A :class:`~apex_tpu_torch.observability.metrics.
HeartbeatMonitor` can trip the same guard when steps stop completing.

The handler only sets a flag (async-signal-safe); the real work happens
on the main thread at the step boundary, so no kernel launch,
collective or file write is interrupted by the handler itself.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Iterable

__all__ = ["PreemptionGuard"]

logger = logging.getLogger(__name__)


class PreemptionGuard:
    """Flag-setting signal handler for graceful preemption.

    ``signals`` defaults to SIGTERM (what preemption sends); add SIGINT
    to make Ctrl-C drain instead of tearing down mid-save.  CPython only
    allows handler installation from the **main thread**; constructed
    anywhere else the guard degrades gracefully to the programmatic
    :meth:`trigger` path instead of raising -
    ``signals_installed`` says which mode this instance got.  Use as a
    context manager or call :meth:`uninstall` to restore the previous
    handlers.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._event = threading.Event()
        self._previous = {}
        self._signals_installed = True
        for sig in signals:
            try:
                self._previous[sig] = signal.signal(sig, self._handle)
            except ValueError:
                # signal.signal raises ValueError BOTH off the main
                # thread and for an uncatchable/invalid signal number —
                # only the former gets the graceful fallback; a bad
                # signal on the main thread is a caller bug and must
                # keep raising, not produce a guard that silently never
                # fires.
                if threading.current_thread() is threading.main_thread():
                    raise
                self._signals_installed = False
                logger.warning(
                    "PreemptionGuard built off the main thread: signal "
                    "handlers not installed; only trigger() will trip "
                    "this guard")
                break

    @property
    def signals_installed(self) -> bool:
        """True when the OS signal handlers are live; False for a guard
        built off the main thread (programmatic :meth:`trigger` only)."""
        return self._signals_installed

    def _handle(self, signum, frame):
        self._event.set()

    @property
    def triggered(self) -> bool:
        """True once a shutdown signal has arrived (sticky)."""
        return self._event.is_set()

    def trigger(self) -> None:
        """Programmatic preemption (fault injection / tests)."""
        self._event.set()

    def uninstall(self) -> None:
        """Restore the previous signal handlers (idempotent)."""
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous = {}

    def __enter__(self) -> "PreemptionGuard":
        return self

    def __exit__(self, *exc) -> None:
        self.uninstall()
