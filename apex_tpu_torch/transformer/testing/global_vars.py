"""Global harness state: the args registry and the autoresume hook (port
of :mod:`apex_tpu.transformer.testing.global_vars`, the reference's
``apex/transformer/testing/global_vars.py``).

:class:`AutoResume` is the JAX package's generalisation of the ADLR
poller: termination is requested by a sentinel file or an environment
variable (how SLURM, GKE and other schedulers commonly surface a
preemption notice), polled at most once per ``min_poll_interval``
seconds.  :func:`check_autoresume_termination` is the reference's call
shape: call it every iteration with the save callback.  With a
``torch.distributed`` group of more than one rank the ranks agree first
(a MAX all-reduce of the flag), so a notice delivered to one host stops
every rank rather than leaving the others in their next collective.
The environment names are the JAX package's, so one notice reaches a job
of either package.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Optional

import torch

__all__ = [
    "AutoResume",
    "get_autoresume",
    "set_autoresume",
    "check_autoresume_termination",
    "get_args",
    "set_args",
]

_GLOBAL_ARGS: Optional[Any] = None
_GLOBAL_AUTORESUME: Optional["AutoResume"] = None


def set_args(args) -> None:
    """Register the harness args (``None`` clears them)."""
    global _GLOBAL_ARGS
    _GLOBAL_ARGS = args


def get_args():
    """The registered args; raise before :func:`set_args`."""
    if _GLOBAL_ARGS is None:
        raise RuntimeError("args not initialized; call set_args first")
    return _GLOBAL_ARGS


class AutoResume:
    """Preemption-notice poller: termination is requested when
    ``signal_file`` (default ``$APEX_TPU_AUTORESUME_FILE``) exists or
    ``signal_env`` holds a truthy value; a poll within
    ``min_poll_interval`` seconds of the last returns the last answer."""

    def __init__(self,
                 signal_file: Optional[str] = None,
                 signal_env: str = "APEX_TPU_AUTORESUME_TERMINATE",
                 min_poll_interval: float = 10.0):
        self.signal_file = signal_file or os.environ.get(
            "APEX_TPU_AUTORESUME_FILE")
        self.signal_env = signal_env
        self.min_poll_interval = min_poll_interval
        self._last_poll = 0.0
        self._cached = False

    def init(self) -> None:
        """Forget the last poll (the reference's ``autoresume.init()``)."""
        self._last_poll = 0.0
        self._cached = False

    def termination_requested(self) -> bool:
        now = time.monotonic()
        if now - self._last_poll < self.min_poll_interval:
            return self._cached
        self._last_poll = now
        env_val = os.environ.get(self.signal_env, "").strip().lower()
        env_requested = env_val not in ("", "0", "false", "no", "off")
        self._cached = bool(
            env_requested
            or (self.signal_file and os.path.exists(self.signal_file)))
        return self._cached

    def request_resume(self) -> None:
        """Ask to be requeued: remove the sentinel, so that the requeued
        job starts clean."""
        if self.signal_file and os.path.exists(self.signal_file):
            try:
                os.remove(self.signal_file)
            except OSError:
                pass


def set_autoresume(autoresume: Optional[AutoResume]) -> None:
    global _GLOBAL_AUTORESUME
    _GLOBAL_AUTORESUME = autoresume


def get_autoresume() -> Optional[AutoResume]:
    return _GLOBAL_AUTORESUME


def _any_rank(local: bool) -> bool:
    """``local`` OR-ed over the ranks of the default process group (on
    the CPU for gloo, on this rank's card for NCCL); ``local`` itself
    without a group of more than one rank."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return local
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    flag = torch.tensor([int(local)], dtype=torch.int32, device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def check_autoresume_termination(iteration: int,
                                 save_fn: Callable[[int], None]) -> bool:
    """When termination is requested on any rank: ``save_fn(iteration)``,
    ask to be requeued, and return True so the training loop exits;
    else False."""
    ar = get_autoresume()
    if not _any_rank(bool(ar is not None and ar.termination_requested())):
        return False
    save_fn(iteration)
    if ar is not None:
        ar.request_resume()
    return True
