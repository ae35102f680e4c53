"""Process-group bring-up and a local multi-process launcher (port of
:mod:`apex_tpu.parallel.launch`).

- :func:`initialize_distributed` joins this process to the job:
  ``torch.distributed.init_process_group`` over NCCL for the card, or
  over gloo when the caller asks for the CPU (``device="cpu"`` or
  ``backend="gloo"``).  A job that wants NCCL where NCCL is missing is an
  error, never a quiet fall back to gloo.
- :func:`run_multiprocess` starts ``world_size`` local ranks of a
  function with the ``spawn`` start method (never ``fork``: a parent
  that runs JAX or CUDA has threads), joins them to one group, and
  returns what each rank's call returned.  Every wait has a deadline;
  when it passes, the children are killed and it raises.
  :func:`start_multiprocess` starts the same ranks and returns at once,
  so the caller can work while they run; its :meth:`RankJob.join` is the
  rest of :func:`run_multiprocess`.

Arguments not given come from the environment: ``COORDINATOR_ADDRESS``
(``host:port``; else ``MASTER_ADDR``/``MASTER_PORT``), ``NUM_PROCESSES``
(else ``WORLD_SIZE``) and ``PROCESS_ID`` (else ``RANK``).  With none of
them the job is one process on ``127.0.0.1`` at a free port.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["initialize_distributed", "run_multiprocess",
           "start_multiprocess", "RankJob", "free_port"]


def free_port() -> int:
    """A TCP port on ``127.0.0.1`` that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env_int(*names) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device=None,
    timeout: float = 600.0,
) -> None:
    """Join (or, already joined, keep) the distributed job.

    ``backend`` defaults to ``"nccl"``, or to ``"gloo"`` when ``device``
    is the CPU.  With NCCL the rank takes the card ``process_id %
    torch.cuda.device_count()``.  ``timeout`` (seconds) bounds every
    collective of the default group."""
    if dist.is_initialized():
        return
    if backend is None:
        cpu = device is not None and torch.device(device).type == "cpu"
        backend = "gloo" if cpu else "nccl"
    if backend == "nccl" and not (dist.is_nccl_available()
                                  and torch.cuda.is_available()):
        raise RuntimeError(
            "NCCL and a CUDA device are needed for the card; pass "
            "device='cpu' (gloo) to run on the CPU")
    if num_processes is None:
        num_processes = _env_int("NUM_PROCESSES", "WORLD_SIZE") or 1
    if process_id is None:
        process_id = _env_int("PROCESS_ID", "RANK") or 0
    if coordinator_address is None:
        coordinator_address = os.environ.get("COORDINATOR_ADDRESS")
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        if num_processes > 1:
            raise ValueError("a job of several processes needs "
                             "coordinator_address (host:port)")
        coordinator_address = f"127.0.0.1:{free_port()}"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))


def _child(fn, rank, world_size, address, backend, num_threads, args,
           results):
    try:
        if num_threads is not None:
            torch.set_num_threads(num_threads)
        initialize_distributed(address, world_size, rank, backend=backend)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))


class RankJob:
    """Spawned ranks running (:func:`start_multiprocess`); :meth:`join`
    waits for their results, and kills them when the deadline passes."""

    def __init__(self, procs, results, world_size: int, timeout: float):
        self._procs, self._results = procs, results
        self._world_size, self._timeout = world_size, timeout
        self._deadline = time.monotonic() + timeout

    def join(self) -> List[Any]:
        """Every rank's result in rank order.  If a rank raises, or the
        deadline passes before every rank has answered, every child still
        running is killed and ``RuntimeError`` is raised with what the
        ranks reported."""
        procs, results, world_size = (self._procs, self._results,
                                      self._world_size)
        deadline = self._deadline
        outputs, failures = {}, {}
        try:
            while len(outputs) + len(failures) < world_size \
                    and not failures:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    for rank, p in enumerate(procs):
                        if (p.exitcode not in (None, 0)
                                and rank not in outputs
                                and rank not in failures):
                            failures[rank] = f"exited with code {p.exitcode}"
                    continue
                (outputs if ok else failures)[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=max(0.0, min(5.0,
                                            deadline - time.monotonic())))
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5.0)
            results.close()
        missing = [r for r in range(world_size)
                   if r not in outputs and r not in failures]
        if failures or missing:
            msgs = "\n".join(f"rank {r}: {m}"
                             for r, m in sorted(failures.items()))
            if missing:
                msgs += (f"\nranks {missing} did not answer within "
                         f"{self._timeout} s and were killed")
            raise RuntimeError(f"multiprocess run failed:\n{msgs}")
        return [outputs[r] for r in range(world_size)]


def start_multiprocess(fn: Callable, world_size: int, *,
                       args: Sequence[Any] = (), backend: str = "gloo",
                       timeout: float = 120.0,
                       num_threads: Optional[int] = None) -> RankJob:
    """Start ``fn(*args)`` on ``world_size`` spawned ranks of one process
    group and return at once (:func:`run_multiprocess`'s arguments; the
    deadline runs from now)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    address = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(fn, rank, world_size, address, backend,
                               num_threads, tuple(args), results))
             for rank in range(world_size)]
    for p in procs:
        p.start()
    return RankJob(procs, results, world_size, timeout)


def run_multiprocess(fn: Callable, world_size: int, *,
                     args: Sequence[Any] = (), backend: str = "gloo",
                     timeout: float = 120.0,
                     num_threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` spawned ranks of one process
    group and return their results in rank order.

    ``fn`` must be importable by name (a module-level function) and its
    result picklable.  Each child sets ``torch.set_num_threads
    (num_threads)`` when given, joins the group (``backend``, on
    ``127.0.0.1``), calls ``fn`` and leaves the group.  If a rank raises,
    or ``timeout`` seconds pass before every rank has answered, every
    child still running is killed and ``RuntimeError`` is raised with
    what the ranks reported."""
    return start_multiprocess(fn, world_size, args=args, backend=backend,
                              timeout=timeout,
                              num_threads=num_threads).join()
