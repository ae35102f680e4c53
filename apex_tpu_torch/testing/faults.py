"""Fault injection (port of :mod:`apex_tpu.testing.faults`): make the
failure paths testable on a laptop.

- :func:`poison_grads` — NaN/Inf injection into a gradient tree at a
  chosen step (a ``torch.where`` on the step counter, so a device counter
  needs no host sync);
- :func:`bitflip_file` / :func:`truncate_file` /
  :func:`corrupt_checkpoint` — storage damage (one flipped bit in an
  array payload, a torn tail) that the per-array checksums must catch;
- :func:`transient_os_errors` — ``os.<op>`` raising ``OSError`` for the
  first N matching calls (the NFS blip the manager's retry exists for),
  scoped by path prefix so only checkpoint traffic is hit;
- :func:`hung_writes` — park checkpoint writers on a gate before any
  byte is written, so a test holds a writer provably mid-flight;
- :func:`simulate_sigterm` — deliver a real SIGTERM to a process (the
  preemption grace signal), driving
  :class:`apex_tpu_torch.resilience.PreemptionGuard`;
- :class:`ChaosProxy` — a TCP proxy between the fleet router and a
  socket replica injecting the failures a real network throws:
  partition, half-open (accept-then-silence), slow link, torn frame,
  crc-corrupt frame, and reconnect churn — each deterministic and
  healable, so the socket transport's contracts are driven, not
  asserted;
- :class:`flapping_replica` — scripted up/down churn on a ChaosProxy
  link or a test double: deterministic edges on an injected clock, so
  the autopilot's flap-quarantine is driven by the same fake clock that
  drives its decisions.

Everything restores global state on exit; one fault at a time —
compose scenarios sequentially, as production failures arrive.
"""

from __future__ import annotations

import contextlib
import errno
import os
import signal
import socket
import threading
import time
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "poison_grads",
    "bitflip_file",
    "truncate_file",
    "corrupt_checkpoint",
    "transient_os_errors",
    "hung_writes",
    "simulate_sigterm",
    "ChaosProxy",
    "flapping_replica",
]


# ---------------------------------------------------------------------------
# Non-finite gradients
# ---------------------------------------------------------------------------


def poison_grads(grads, *, step, at_step, kind: str = "nan",
                 leaf: int = 0):
    """``grads`` with leaf ``leaf`` (in the JAX leaf order) filled with
    NaN/Inf where ``step == at_step`` — a ``torch.where``, so ``step``
    may be a device counter.  ``kind``: ``"nan"``, ``"inf"`` or
    ``"-inf"``."""
    import torch

    from apex_tpu_torch.checkpoint import _leaves_with_path, _unflatten

    bad = {"nan": float("nan"), "inf": float("inf"),
           "-inf": float("-inf")}[kind]
    leaves = [x for _, x in _leaves_with_path(grads)]
    x = leaves[leaf]
    hit = torch.as_tensor(step, device=x.device) == at_step
    leaves[leaf] = torch.where(hit, torch.full_like(x, bad), x)
    return _unflatten(grads, leaves)


# ---------------------------------------------------------------------------
# Storage corruption
# ---------------------------------------------------------------------------


def bitflip_file(path: str, *, frac: float = 0.75, bit: int = 3) -> int:
    """Flip one bit inside an array payload of an ``.npz`` checkpoint (not
    zip metadata, which nothing checksums): the data offset is read from
    the zip directory, targeting the last non-manifest entry.  A file
    that is not a zip is flipped at ``frac`` of its size.  Returns the
    byte offset flipped."""
    import zipfile

    size = os.path.getsize(path)
    off = min(size - 1, max(0, int(size * frac)))
    try:
        with zipfile.ZipFile(path) as zf:
            infos = [i for i in zf.infolist()
                     if i.filename != "__manifest__.npy"] or zf.infolist()
            info = infos[-1]
            with open(path, "rb") as f:
                # local header: bytes 26..28 hold the name and extra
                # lengths; the payload starts after the 30-byte header
                f.seek(info.header_offset + 26)
                n, m = np.frombuffer(f.read(4), dtype="<u2")
            data_start = info.header_offset + 30 + int(n) + int(m)
            # past the ~100-byte .npy header: land in raw values
            off = min(data_start + max(128, info.compress_size // 2),
                      data_start + info.compress_size - 1)
    except Exception:
        pass  # not a zip (or torn already): positional flip
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ (1 << bit)]))
    return off


def truncate_file(path: str, *, keep_frac: float = 0.5) -> None:
    """Tear the file's tail off (for ``.npz`` the zip central directory
    goes: the archive no longer opens)."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(1, int(size * keep_frac)))


def corrupt_checkpoint(path: str, *, mode: str = "bitflip",
                       shard: int = 0) -> str:
    """Damage a checkpoint: a flat ``.npz`` file, or ``shard_{shard}.npz``
    of a sharded checkpoint directory.  ``mode``: ``"bitflip"`` or
    ``"truncate"``.  Returns the file damaged."""
    target = path
    if os.path.isdir(path):
        target = os.path.join(path, f"shard_{shard}.npz")
    if mode == "bitflip":
        bitflip_file(target)
    elif mode == "truncate":
        truncate_file(target)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return target


# ---------------------------------------------------------------------------
# Flaky / hung filesystem
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def transient_os_errors(times: int, *, path_prefix: str,
                        op: str = "replace",
                        err: int = errno.EIO):
    """Make ``os.<op>`` (default the atomic-rename commit point) raise
    ``OSError(err)`` for the first ``times`` calls whose first argument
    starts with ``path_prefix``; later calls pass through.  Yields a
    counter with ``.failed`` (the failures injected)."""
    real = getattr(os, op)
    lock = threading.Lock()

    class _Counter:
        failed = 0

    counter = _Counter()

    def flaky(*args, **kwargs):
        src = os.fspath(args[0]) if args else ""
        with lock:
            inject = (counter.failed < times
                      and str(src).startswith(path_prefix))
            if inject:
                counter.failed += 1
        if inject:
            raise OSError(err, f"injected transient {op} failure "
                               f"#{counter.failed}", str(src))
        return real(*args, **kwargs)

    setattr(os, op, flaky)
    try:
        yield counter
    finally:
        setattr(os, op, real)


class _HangHandle:
    """Controls writers parked by :func:`hung_writes`."""

    def __init__(self):
        self._gate = threading.Event()
        self.entered = threading.Event()  # a writer reached the gate

    def release(self) -> None:
        """Let parked (and all future) writers proceed."""
        self._gate.set()


@contextlib.contextmanager
def hung_writes(*, path_prefix: str = ""):
    """Park every checkpoint write whose destination starts with
    ``path_prefix`` on a gate before any byte is written; the gate opens
    on exit."""
    from apex_tpu_torch import checkpoint as ckpt

    handle = _HangHandle()
    real = ckpt._write_npz

    def gated(path, manifest, arrays):
        if str(path).startswith(path_prefix):
            handle.entered.set()
            handle._gate.wait()
        return real(path, manifest, arrays)

    ckpt._write_npz = gated
    try:
        yield handle
    finally:
        handle.release()
        ckpt._write_npz = real


# ---------------------------------------------------------------------------
# Network faults
# ---------------------------------------------------------------------------


class _ProxyPair:
    """One bridged connection (client sock + upstream sock)."""

    def __init__(self, client: socket.socket, upstream: socket.socket):
        self.client = client
        self.upstream = upstream
        self._closed = threading.Event()

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        for s in (self.client, self.upstream):
            try:
                s.close()
            except OSError:
                pass

    @property
    def closed(self) -> bool:
        return self._closed.is_set()


class ChaosProxy:
    """TCP chaos between a fleet router and one socket replica.

    Listens on an ephemeral loopback port (``.address``); every
    accepted connection is bridged to ``upstream`` (a
    ``TransportServer`` / ``replica_serve`` daemon).  The
    upstream→client direction is **frame-aware** — it parses the public
    ``serving.transport`` header (version, length, crc) without ever
    deserializing a body — so faults land with byte precision:

    - :meth:`partition` — existing connections severed, new connects
      accepted-then-closed: total silence, the router's heartbeat
      ladder must produce the down verdict;
    - :meth:`half_open` — new connections accept but nothing flows
      (the classic accept-then-silence black hole): the client's hello
      deadline must churn through it;
    - :meth:`slow` — every frame/chunk delayed by ``delay_s``: RTT
      degrades, heartbeats still arrive — placement must *demote*, not
      fail;
    - :meth:`tear_next_frame` — the next replica→router frame is cut
      mid-body and the connection dropped: a torn frame the decoder
      must detect, never deserialize;
    - :meth:`corrupt_next_frame` — one bit flipped in the next frame's
      body: the crc must catch it;
    - :meth:`drop_connections` — severs at a *frame boundary*
      (reconnect churn): the session seq-replay must make it lossless;
    - :meth:`heal` — back to transparent pass-through.

    All controls are thread-safe and take effect at the next frame.
    """

    def __init__(self, upstream: Tuple[str, int], *,
                 listen_host: str = "127.0.0.1"):
        # the ONE header definition — parsing boundaries from a copy
        # would silently drift if the framing ever changed
        from apex_tpu_torch.serving.transport import FRAME_HEADER

        self._HEADER = FRAME_HEADER
        self.upstream = (upstream[0], int(upstream[1]))
        self._lock = threading.Lock()
        self._mode = "pass"              # pass | partition | half_open
        self._delay_s = 0.0
        self._tear = 0                   # one-shot counters
        self._corrupt = 0
        self._cut = False                # boundary-cut flag (churn)
        self._pairs: list = []
        self._stalled: list = []         # half-open holds
        self._closed = False
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((listen_host, 0))
        lsock.listen(8)
        lsock.settimeout(0.2)
        self._lsock = lsock
        self.address: Tuple[str, int] = lsock.getsockname()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="chaos-proxy-accept",
            daemon=True)
        self._accept_thread.start()

    # ------------------------------------------------------------- controls

    def partition(self) -> None:
        with self._lock:
            self._mode = "partition"
        self._kill_pairs()

    def half_open(self) -> None:
        with self._lock:
            self._mode = "half_open"

    def slow(self, delay_s: float) -> None:
        with self._lock:
            self._mode = "pass"
            self._delay_s = float(delay_s)

    def tear_next_frame(self) -> None:
        with self._lock:
            self._tear += 1

    def corrupt_next_frame(self) -> None:
        with self._lock:
            self._corrupt += 1

    def drop_connections(self, *, wait_s: float = 5.0) -> None:
        """Sever every live connection at the next replica→router frame
        boundary (reconnect churn: a loss the session layer must absorb
        without a failover)."""
        with self._lock:
            if not self._pairs:
                return
            self._cut = True
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            with self._lock:
                if all(p.closed for p in self._pairs):
                    break
            time.sleep(0.005)
        with self._lock:
            self._cut = False
            self._pairs = [p for p in self._pairs if not p.closed]

    def heal(self) -> None:
        with self._lock:
            self._mode = "pass"
            self._delay_s = 0.0
        # release half-open holds so the client's next attempt bridges
        for s in self._drain_stalled():
            try:
                s.close()
            except OSError:
                pass

    def close(self) -> None:
        self._closed = True
        try:
            self._lsock.close()
        except OSError:
            pass
        self._kill_pairs()
        for s in self._drain_stalled():
            try:
                s.close()
            except OSError:
                pass

    def __enter__(self) -> "ChaosProxy":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ plumbing

    def _drain_stalled(self) -> list:
        with self._lock:
            stalled, self._stalled = self._stalled, []
        return stalled

    def _kill_pairs(self) -> None:
        with self._lock:
            pairs, self._pairs = self._pairs, []
        for p in pairs:
            p.close()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                client, _ = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._lock:
                mode = self._mode
            if mode == "partition":
                try:
                    client.close()
                except OSError:
                    pass
                continue
            if mode == "half_open":
                with self._lock:
                    self._stalled.append(client)   # held, never bridged
                continue
            try:
                up = socket.create_connection(self.upstream, timeout=5.0)
            except OSError:
                try:
                    client.close()
                except OSError:
                    pass
                continue
            # both relay legs disable Nagle, same as the real transport
            # endpoints: a store-and-forward proxy that batches small
            # frames behind delayed ACKs would change the very timing
            # the fault tests are probing
            for s in (client, up):
                try:
                    s.setsockopt(socket.IPPROTO_TCP,
                                 socket.TCP_NODELAY, 1)
                except OSError:
                    pass
            pair = _ProxyPair(client, up)
            with self._lock:
                self._pairs.append(pair)
            threading.Thread(target=self._pump_raw, args=(pair,),
                             daemon=True).start()
            threading.Thread(target=self._pump_frames, args=(pair,),
                             daemon=True).start()

    def _fault_gate(self, pair: _ProxyPair) -> bool:
        """Per-frame/chunk mode check; True = stop pumping this pair."""
        while True:
            with self._lock:
                mode, delay, cut = self._mode, self._delay_s, self._cut
            if pair.closed or self._closed or mode == "partition" or cut:
                pair.close()
                return True
            if mode == "half_open":
                time.sleep(0.01)         # stall — silence, not EOF
                continue
            if delay > 0:
                time.sleep(delay)
            return False

    def _pump_raw(self, pair: _ProxyPair) -> None:
        """router → replica: raw chunk forwarding."""
        try:
            while True:
                data = pair.client.recv(65536)
                if not data:
                    break
                if self._fault_gate(pair):
                    return
                pair.upstream.sendall(data)
        except OSError:
            pass
        finally:
            pair.close()

    def _recv_exact(self, sock: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise EOFError
            buf += chunk
        return buf

    def _pump_frames(self, pair: _ProxyPair) -> None:
        """replica → router: frame-aware, so torn/corrupt/cut land at
        byte-exact positions."""
        try:
            while True:
                header = self._recv_exact(pair.upstream,
                                          self._HEADER.size)
                _, length, _ = self._HEADER.unpack(header)
                body = self._recv_exact(pair.upstream, length)
                if self._fault_gate(pair):
                    return
                frame = header + body
                with self._lock:
                    tear = self._tear > 0
                    if tear:
                        self._tear -= 1
                    corrupt = (not tear) and self._corrupt > 0
                    if corrupt:
                        self._corrupt -= 1
                if tear:
                    # half a frame then FIN: torn mid-body, the decoder
                    # must refuse to deserialize what did arrive
                    pair.client.sendall(frame[:max(
                        self._HEADER.size + 1, len(frame) // 2)])
                    pair.close()
                    return
                if corrupt:
                    flipped = bytearray(frame)
                    flipped[-1] ^= 0x10   # body byte: crc must catch it
                    frame = bytes(flipped)
                pair.client.sendall(frame)
        except (OSError, EOFError):
            pass
        finally:
            pair.close()


# ---------------------------------------------------------------------------
# Preemption
# ---------------------------------------------------------------------------


def simulate_sigterm(pid: Optional[int] = None) -> None:
    """Deliver a real SIGTERM (the preemption grace signal) to ``pid``
    (default: this process).  With a
    :class:`apex_tpu_torch.resilience.PreemptionGuard` installed this sets the
    drain flag; without one, default signal disposition applies — so
    install the guard first."""
    os.kill(os.getpid() if pid is None else pid, signal.SIGTERM)


# ---------------------------------------------------------------------------
# Flapping replica
# ---------------------------------------------------------------------------


class flapping_replica:
    """Scripted up/down churn — the fault the SLO autopilot's
    quarantine exists for.  Wraps anything with a down/up actuator
    pair and toggles it on a deterministic schedule read off an
    injected clock:

    - a :class:`ChaosProxy` link: ``down = partition``, ``up = heal``
      (auto-detected);
    - a test double (e.g. the fleet tests' ``FakeReplica``): pass
      ``down=replica.fail, up=replica.revive`` (or any callables);
      ``fail``/``revive`` attribute pairs are auto-detected too.

    The schedule is pure arithmetic on the clock — first :meth:`tick`
    pins ``t0``; edges land at ``t0 + k * period_s`` and each edge
    flips the state (even k → down, odd k → up), so the same fake
    clock replays the same churn run after run.  A test loop calls
    :meth:`tick` as often as it likes; missed edges are applied in
    order on the next call.  ``max_flaps`` bounds the churn: after
    that many down-edges the replica is brought (and stays) up, so a
    test can assert the autopilot quarantined it *during* the storm
    and releases it after back-off.

    ``flaps`` counts down-edges applied so far; :meth:`stop` ends the
    churn and restores up.
    """

    def __init__(self, target=None, *, down=None, up=None,
                 period_s: float = 1.0, max_flaps: Optional[int] = None,
                 clock=time.monotonic):
        if target is not None:
            if down is None:
                down = getattr(target, "partition", None) or \
                    getattr(target, "fail", None)
            if up is None:
                up = getattr(target, "heal", None) or \
                    getattr(target, "revive", None)
        if down is None or up is None:
            raise TypeError(
                "flapping_replica needs a down/up actuator pair "
                "(ChaosProxy, a fail/revive double, or explicit "
                "down=/up= callables)")
        if period_s <= 0:
            raise ValueError(f"period_s must be > 0, got {period_s}")
        self._down, self._up = down, up
        self.period_s = float(period_s)
        self.max_flaps = max_flaps
        self._clock = clock
        self._t0: Optional[float] = None
        self._edges = 0          # schedule edges consumed
        self.flaps = 0           # down-edges applied
        self.is_down = False
        self._stopped = False

    def tick(self) -> bool:
        """Apply every schedule edge at or before ``clock()``; returns
        the current down-ness.  Call from the same loop that pumps the
        router/autopilot."""
        if self._stopped:
            return self.is_down
        now = self._clock()
        if self._t0 is None:
            self._t0 = now
        while self._t0 + self._edges * self.period_s <= now:
            if self.max_flaps is not None and \
                    self.flaps >= self.max_flaps:
                self.stop()
                return self.is_down
            self._edges += 1
            if self.is_down:
                self._up()
                self.is_down = False
            else:
                self._down()
                self.is_down = True
                self.flaps += 1
        return self.is_down

    def stop(self) -> None:
        """End the churn and leave the replica up."""
        self._stopped = True
        if self.is_down:
            self._up()
            self.is_down = False

    def __enter__(self) -> "flapping_replica":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
