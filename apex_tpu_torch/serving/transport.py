"""Router↔replica wire — the Transport duck type and its two shapes
(port of :mod:`apex_tpu.serving.transport`; the frame format is byte for
byte the reference's).

The :class:`~apex_tpu_torch.serving.fleet.FleetRouter` is deliberately
transport-agnostic: it drives anything with the replica client surface

    ``alive() -> bool``
    ``poll() -> list[event]``              (non-blocking; may raise)
    ``submit(frid, prompt, max_new_tokens, eos_id, sampling)``
    ``submit_many(items)``                 (optional batch fast path)
    ``begin_drain()``
    ``close()``

plus the startup convenience ``wait_ready() -> meta``.  Events and
commands are exactly the :mod:`~apex_tpu_torch.serving.replica` wire protocol
(``("token", frid, tok)``, ``("state", snapshot)``, …).  Two
implementations exist:

- **in-process mp-queue** — :class:`~apex_tpu_torch.serving.replica.
  ReplicaProcess`: replica is a spawned child on THIS host,
  multiprocessing queues are the pipe.  Re-exported here as the
  reference transport.
- **framed TCP** (this module) — :class:`SocketTransport`
  talking to a :func:`replica_serve` daemon on ANY host.  The router
  does not change; every router contract (failover replay, typed shed,
  zero-downtime rollout) holds over the socket, under the network
  faults :class:`~apex_tpu_torch.testing.faults.ChaosProxy` injects.

Framing
-------
Every payload crosses as one frame::

    version(1B) | body_len(4B big-endian) | crc32(body)(4B) | body

``body`` is a pickled tuple.  A frame whose version byte is wrong,
whose length is implausible, whose crc does not match, or that ends at
EOF mid-frame is **never deserialized**: the decoder raises
:class:`FrameError`, the client counts it (``frames_corrupt``) and
classifies the replica as failed, and the router recovers through the
existing down-verdict → failover-replay path.  Torn and corrupted
frames are a *detected* failure class, not garbage handed to pickle.

Session layer
-------------
TCP delivers bytes, not guarantees, so a thin session protocol rides
the frames:

- ``("hello", last_evt_seq, cmd_seq, fresh)`` /
  ``("hello", cmd_applied, reset, resume_seq)`` — the (re)connect
  handshake.  The server keeps a bounded ring of sequence-numbered
  events; a reconnecting client names the last event seq it saw and
  the server replays the gap, so a **connection** loss at a frame
  boundary costs nothing (no failover, no token lost —
  ``fleet/reconnects`` counts it).  When the gap has fallen off the
  ring the server answers ``reset`` and the client fails the replica —
  correctness degrades to the ordinary replay path, never to a stream
  with a hole.  A ``fresh`` hello (a client that has never held a
  session — e.g. a *restarted router* attaching to a long-lived
  daemon) is different: the server resets its command-dedupe watermark
  to zero (the old session's watermark must not black-hole the new
  session's submits — a fresh client's outbox is entirely unacked and
  resends from seq 1; its ``cmd_seq`` hello field is informational),
  and when the ring cannot reach back to
  seq 0 it fast-forwards the client (``resume_seq``) and re-emits the
  sticky ``ready``/latest ``state`` events, so a fresh router always
  gets the handshake metadata and current state instead of a reset.
- ``("cmd", seq, command)`` / ``("ack", applied)`` — commands are
  sequence-numbered and buffered until acknowledged; a reconnect
  re-sends the unacked tail and the server dedupes by seq, so a torn
  connection can neither lose nor double-apply a submit.
- ``("ping", nonce)`` / ``("pong", nonce, server_mono)`` — link RTT,
  measured on the client's monotonic clock (cross-host wall clocks are
  never compared).  The router reads ``link_rtt_s`` off the client and
  *demotes* a degraded link in placement rather than hard-failing the
  replica.  ``server_mono`` is the replica host's monotonic
  clock at pong time: together with the client-side send/receive stamps
  it yields a per-link **clock offset** estimate
  (``client ≈ server + offset``, uncertainty ±RTT/2 — the NTP
  construction), refreshed per ping and drained by the router into its
  timeline spill (``link_clock`` events) so cross-host trace stitching
  maps every replica's clock onto the router's.  The hello reply
  carries the same stamp, so a link has an offset sample from its very
  first exchange.
- ``("bye",)`` — intentional server exit (drain complete / stop): the
  client stops reconnecting and reports ``alive() == False``, which is
  how a rollout's drained-and-exited check works cross-host.

The client is single-threaded and non-blocking: all I/O happens inside
``poll()`` (the router's pump), reconnects use jittered exponential
backoff, deadlines run on an injectable monotonic clock, and the
command outbox is bounded — past ``max_outbox`` pending commands,
``submit`` raises (backpressure), which the router treats as a dead
pipe.  Nothing here imports torch: payloads are numpy and plain
Python.

Security note: frames are pickled python — run this transport inside
one trust domain (the fleet's private network), exactly like the
mp-queue transport it mirrors.
"""

from __future__ import annotations

import collections
import logging
import os
import pickle
import queue as queue_mod
import random
import select
import socket
import struct
import threading
import time
import zlib
from typing import Optional, Sequence, Tuple

__all__ = [
    "FRAME_HEADER",
    "FRAME_VERSION",
    "FrameDecoder",
    "FrameError",
    "SocketTransport",
    "TransportError",
    "TransportServer",
    "encode_frame",
    "replica_serve",
    "start_replica_server",
]

logger = logging.getLogger(__name__)

FRAME_VERSION = 1
# version, body_len, crc32(body) — public so frame-aware tooling (the
# ChaosProxy fault injector) parses boundaries from the one definition
FRAME_HEADER = struct.Struct(">BII")
_HEADER = FRAME_HEADER
MAX_FRAME_BYTES = 64 << 20               # sanity bound on body_len: a
#                                          corrupted length field must
#                                          fail fast, not allocate 4 GB
#                                          or park the reader forever


class FrameError(ValueError):
    """A frame that must not be deserialized: bad version, implausible
    length, crc mismatch, or EOF mid-frame (torn)."""


class TransportError(RuntimeError):
    """Client-side transport failure — the router's dead-pipe class
    (``poll``/``submit`` raise it; ``_mark_down`` + replay recover)."""


def encode_frame(obj) -> bytes:
    body = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return _HEADER.pack(FRAME_VERSION, len(body),
                        zlib.crc32(body) & 0xFFFFFFFF) + body


class FrameDecoder:
    """Incremental frame parser over a byte stream.

    ``feed(data)`` returns the complete, crc-verified payloads and
    keeps any trailing partial frame buffered; ``partial`` says whether
    an EOF *now* would tear a frame mid-flight (the caller's
    torn-detection signal)."""

    def __init__(self, *, max_frame_bytes: int = MAX_FRAME_BYTES):
        self._buf = bytearray()
        self._max = max_frame_bytes

    @property
    def partial(self) -> bool:
        return len(self._buf) > 0

    def reset(self) -> None:
        self._buf.clear()

    def feed(self, data: bytes) -> list:
        self._buf.extend(data)
        out = []
        while len(self._buf) >= _HEADER.size:
            version, length, crc = _HEADER.unpack_from(self._buf)
            if version != FRAME_VERSION:
                raise FrameError(
                    f"frame version {version} != {FRAME_VERSION}")
            if length > self._max:
                raise FrameError(
                    f"frame length {length} exceeds bound {self._max}")
            if len(self._buf) < _HEADER.size + length:
                break
            body = bytes(self._buf[_HEADER.size:_HEADER.size + length])
            del self._buf[:_HEADER.size + length]
            if zlib.crc32(body) & 0xFFFFFFFF != crc:
                raise FrameError("frame crc32 mismatch")
            out.append(pickle.loads(body))
        return out


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


# inbound reads: the server's recv size and the bytes one connection
# may take in a loop turn before the others get theirs; the client's
# bytes a poll, so the router's pump returns to every link often
_READ_CHUNK = 1 << 20
_READ_BUDGET = 32 << 20
_POLL_READ_BUDGET = 4 << 20


class SocketTransport:
    """Framed-TCP replica client — the cross-host half of the
    :class:`~apex_tpu_torch.serving.fleet.FleetRouter` transport duck type.

    ``address``: ``(host, port)`` of a :func:`replica_serve` daemon (or
    a :class:`~apex_tpu_torch.testing.faults.ChaosProxy` in front of one).
    All I/O is non-blocking and happens inside :meth:`poll`; connect
    attempts use jittered exponential backoff (``backoff_initial_s`` →
    ``backoff_max_s``); a connection that completes TCP but never
    answers the hello within ``send_timeout_s`` (the half-open shape)
    is dropped and retried; a send buffer stuck for ``send_timeout_s``
    while connected raises.  ``max_outbox`` bounds the unacked command
    queue — past it, ``submit`` raises (backpressure), which the router
    treats as a dead pipe and replays elsewhere.

    Counters the router mirrors into the registry: ``reconnects``
    (re-established sessions that lost no events), ``frames_corrupt``
    (torn/crc-failed frames, each a replica-failure verdict);
    ``link_rtt_s`` is the latest ping round trip on THIS process's
    monotonic clock (never compared to the replica's clocks).
    """

    def __init__(self, name: str, address: Tuple[str, int], *,
                 connect_timeout_s: float = 1.0,
                 send_timeout_s: float = 5.0,
                 max_outbox: int = 1024,
                 backoff_initial_s: float = 0.05,
                 backoff_max_s: float = 2.0,
                 backoff_jitter: float = 0.5,
                 ping_every_s: float = 0.25,
                 max_frame_bytes: int = MAX_FRAME_BYTES,
                 clock=time.monotonic,
                 rng: Optional[random.Random] = None):
        self.name = name
        self.address = (address[0], int(address[1]))
        self.meta: Optional[dict] = None
        self.connect_timeout_s = connect_timeout_s
        self.send_timeout_s = send_timeout_s
        self.max_outbox = max_outbox
        self.backoff_initial_s = backoff_initial_s
        self.backoff_max_s = backoff_max_s
        self.backoff_jitter = backoff_jitter
        self.ping_every_s = ping_every_s
        self._clock = clock
        self._rng = rng if rng is not None else random.Random()
        self._max_frame = max_frame_bytes

        self.reconnects = 0
        self.frames_corrupt = 0
        # the oldest unsent bytes a poll found after its flush: what
        # ``send_timeout_s`` bounds (a KV migration's margin to it)
        self.send_backlog_max_s = 0.0
        self.link_rtt_s: Optional[float] = None
        # latest per-link clock offset (client_mono ≈ server_mono +
        # offset), ±RTT/2; None until the first stamped pong/hello
        self.clock_offset_s: Optional[float] = None
        # undrained (rtt_s, offset_s, server_mono) samples for the
        # router (take_rtt_samples) — bounded so a standalone client
        # that nobody drains cannot grow
        self._rtt_samples: collections.deque = collections.deque(
            maxlen=512)

        self._sock: Optional[socket.socket] = None
        self._pending_sock: Optional[socket.socket] = None
        self._connect_started = 0.0
        self._decoder = FrameDecoder(max_frame_bytes=max_frame_bytes)
        self._hello_done = False
        self._hello_sent_t = 0.0
        self._ever_connected = False
        self._attempts = 0
        self._next_connect_t = -float("inf")
        self._wire = bytearray()          # bytes staged for the kernel
        self._wire_since: Optional[float] = None
        self._last_evt_seq = 0
        self._cmd_seq = 0
        # unacked commands: (seq, frame_bytes); resent after reconnect,
        # dropped on ("ack", applied) — bounded by max_outbox
        self._outbox: collections.deque = collections.deque()
        self._pending: list = []          # events buffered by wait_ready
        self._pings: dict = {}            # nonce -> send time
        self._ping_nonce = 0
        self._last_ping_t = -float("inf")
        self._failed: Optional[str] = None
        self._exited = False              # server said bye (clean exit)
        self._closed = False

    # ------------------------------------------------------------ liveness

    def alive(self) -> bool:
        return self._failed is None and not self._exited

    # ------------------------------------------------------------ commands

    def _send_cmd(self, cmd: tuple) -> None:
        if self._failed is not None:
            raise TransportError(
                f"replica {self.name}: transport failed ({self._failed})")
        if self._exited:
            raise TransportError(f"replica {self.name}: exited")
        if len(self._outbox) >= self.max_outbox:
            # bounded send queue: refusing here surfaces as a dead pipe
            # at the router, which replays elsewhere — strictly better
            # than buffering without bound into a partition
            raise TransportError(
                f"replica {self.name}: send backpressure "
                f"({len(self._outbox)} commands pending ack)")
        self._cmd_seq += 1
        frame = encode_frame(("cmd", self._cmd_seq, cmd))
        self._outbox.append((self._cmd_seq, frame))
        if self._hello_done:
            self._stage(frame)

    def submit(self, frid, prompt: Sequence[int], max_new_tokens: int,
               eos_id=None, sampling=None, trace=None) -> None:
        self._send_cmd(("submit", frid, [int(t) for t in prompt],
                        int(max_new_tokens), eos_id, sampling, trace))

    def submit_many(self, items: Sequence[tuple]) -> None:
        from apex_tpu_torch.serving.replica import wire_submit_item

        self._send_cmd(("submit_many",
                        [wire_submit_item(it) for it in items]))

    def begin_drain(self, **kw) -> None:
        """Cross-host drain: the wire command (the daemon's worker runs
        the same PreemptionGuard drain a local SIGTERM would start)."""
        self._send_cmd(("drain",))

    # ------------------------------------------------- KV migration cmds
    # Each call is ONE frame on the wire — a kv_block
    # payload rides its own frame, so the outbox/ack machinery already
    # gives the migration per-block resumability: a reconnect resends
    # exactly the unacked tail, never restarts the stream.

    def export_kv(self, frid) -> None:
        self._send_cmd(("export_kv", frid))

    def kv_ack(self, frid, ok: bool) -> None:
        self._send_cmd(("kv_ack", frid, bool(ok)))

    def import_kv(self, frid, meta: dict) -> None:
        self._send_cmd(("import_kv", frid, meta))

    def kv_block(self, frid, idx: int, payload) -> None:
        self._send_cmd(("kv_block", frid, int(idx), payload))

    def import_commit(self, frid, item, n_blocks: int) -> None:
        from apex_tpu_torch.serving.replica import wire_submit_item

        self._send_cmd(("import_commit", frid, wire_submit_item(item),
                        int(n_blocks)))

    def kv_abort(self, frid) -> None:
        self._send_cmd(("kv_abort", frid))

    # ------------------------------------------------- adapter cmds
    # One frame each; the ``adapter_loaded`` /
    # ``adapter_unloaded`` ack events ride the ordinary event stream.
    # Adapter weights cross as plain pickled arrays inside the frame —
    # rank-8 pairs for the test configs are a few KB, far under
    # MAX_FRAME_BYTES.

    def load_adapter(self, adapter_id, payload: Optional[dict] = None
                     ) -> None:
        self._send_cmd(("load_adapter", adapter_id,
                        dict(payload or {})))

    def unload_adapter(self, adapter_id) -> None:
        self._send_cmd(("unload_adapter", adapter_id))

    def set_knobs(self, payload: dict) -> None:
        """ Live-retune broadcast: one frame carrying the knob
        payload (plus the router's ack token); the ``knobs_set`` verdict
        rides the ordinary event stream like the adapter acks."""
        self._send_cmd(("set_knobs", dict(payload or {})))

    # -------------------------------------------------------------- events

    def poll(self) -> list:
        """One non-blocking I/O turn: connect/backoff, flush, read,
        ping.  Returns newly surfaced replica events; raises
        :class:`TransportError` on the failure classes the router must
        treat as a dead replica (corrupt/torn frame, event-ring reset,
        send timeout, backpressure already raised at submit)."""
        if self._failed is not None:
            raise TransportError(
                f"replica {self.name}: transport failed ({self._failed})")
        out, self._pending = self._pending, []
        if self._exited:
            return out
        now = self._clock()
        if self._sock is None:
            if self._pending_sock is not None:
                self._check_connecting(now)
            elif now >= self._next_connect_t:
                self._try_connect(now)
            return out
        if not self._hello_done and \
                now - self._hello_sent_t > self.send_timeout_s:
            # accept-then-silence (half-open): TCP completed but the
            # session never did — drop and retry with backoff; the
            # router's heartbeat ladder owns the eventual down verdict
            self._disconnect(now, "hello timeout (half-open link)")
            return out
        self._flush(now)
        self._read(now, out)
        if self._sock is not None and self._hello_done:
            self._maybe_ping(now)
            if self._wire and self._wire_since is not None:
                stuck = now - self._wire_since
                self.send_backlog_max_s = max(self.send_backlog_max_s,
                                              stuck)
                if stuck > self.send_timeout_s:
                    self._fail(f"send timeout: {len(self._wire)} bytes "
                               f"stuck for {self.send_timeout_s:.1f}s")
        return out

    def wait_ready(self, timeout: float = 300.0) -> dict:
        """Block (pumping :meth:`poll`) until the replica's ready
        handshake arrives over the wire; other events are buffered for
        later ``poll`` calls in order."""
        if self.meta is not None:
            return self.meta
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            events = self.poll()
            keep = []
            for ev in events:
                if ev[0] == "ready" and self.meta is None:
                    self.meta = ev[1]
                keep.append(ev)
            # re-buffer everything (ready included) so the router's
            # view sees the same stream ReplicaProcess would deliver
            self._pending = keep + self._pending
            if self.meta is not None:
                return self.meta
            time.sleep(0.002)
        raise RuntimeError(
            f"replica {self.name}: no ready handshake over "
            f"{self.address} in {timeout:.0f}s")

    # ----------------------------------------------------------- internals

    def _try_connect(self, now: float) -> None:
        """Start a NON-blocking connect: the router's pump must never
        stall on a black-holed SYN (the real-partition shape, where no
        RST ever comes back) — progress is checked in later polls."""
        import errno

        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setblocking(False)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        err = sock.connect_ex(self.address)
        if err == 0:
            self._finish_connect(sock, now)
            return
        if err in (errno.EINPROGRESS, errno.EWOULDBLOCK, errno.EALREADY):
            self._pending_sock = sock
            self._connect_started = now
            return
        try:
            sock.close()
        except OSError:
            pass
        self._attempts += 1
        self._schedule_reconnect(now)
        logger.debug("transport %s: connect %s failed (errno %d), "
                     "retry in %.3fs", self.name, self.address, err,
                     self._next_connect_t - now)

    def _check_connecting(self, now: float) -> None:
        sock = self._pending_sock
        try:
            _, writable, errored = select.select([], [sock], [sock], 0)
        except (OSError, ValueError):
            writable, errored = [], [sock]
        if writable or errored:
            self._pending_sock = None
            err = 1
            try:
                err = sock.getsockopt(socket.SOL_SOCKET,
                                      socket.SO_ERROR)
            except OSError:
                pass
            if err == 0 and not errored:
                self._finish_connect(sock, now)
                return
            try:
                sock.close()
            except OSError:
                pass
            self._attempts += 1
            self._schedule_reconnect(now)
            return
        if now - self._connect_started > self.connect_timeout_s:
            self._pending_sock = None
            try:
                sock.close()
            except OSError:
                pass
            self._attempts += 1
            self._schedule_reconnect(now)

    def _finish_connect(self, sock: socket.socket, now: float) -> None:
        self._sock = sock
        self._decoder.reset()
        # fresh = this client has never held a session: the server
        # resets its command-dedupe watermark and fast-forwards our
        # event cursor instead of deduping/resetting us against a
        # PREVIOUS router's session (the restarted-router reattach
        # path).  The trailing 1 advertises the clock exchange: the
        # server stamps its hello reply (and pongs) with its monotonic
        # clock ONLY for clients that ask — an older router
        # strict-unpacks the 4-tuple reply, so an unconditional stamp
        # would break the replicas-first rolling-upgrade order (an
        # older server just indexes our extra element away).
        self._wire = bytearray(encode_frame(
            ("hello", self._last_evt_seq, self._cmd_seq,
             not self._ever_connected, 1)))
        self._wire_since = now
        self._hello_done = False
        self._hello_sent_t = now
        self._flush(now)

    def _schedule_reconnect(self, now: float) -> None:
        delay = min(self.backoff_max_s,
                    self.backoff_initial_s * (2 ** max(
                        0, self._attempts - 1)))
        delay *= 1.0 + self.backoff_jitter * self._rng.random()
        self._next_connect_t = now + delay

    def _close_socks(self) -> None:
        for sock in (self._sock, self._pending_sock):
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
        self._sock = None
        self._pending_sock = None

    def _disconnect(self, now: float, why: str) -> None:
        """Connection-level loss at a frame boundary: reconnect's
        business (session replay makes it lossless), not a failure."""
        self._close_socks()
        self._hello_done = False
        self._decoder.reset()
        self._wire = bytearray()
        self._wire_since = None
        self._pings.clear()
        self._attempts += 1
        self._schedule_reconnect(now)
        logger.debug("transport %s: disconnected (%s); reconnect in "
                     "%.3fs", self.name, why, self._next_connect_t - now)

    def _fail(self, reason: str) -> None:
        self._close_socks()
        self._failed = reason
        raise TransportError(f"replica {self.name}: {reason}")

    def _stage(self, frame: bytes) -> None:
        if not self._wire:
            self._wire_since = self._clock()
        self._wire.extend(frame)

    def _flush(self, now: float) -> None:
        while self._wire and self._sock is not None:
            try:
                n = self._sock.send(self._wire)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._disconnect(now, "send error")
                return
            if n <= 0:
                return
            del self._wire[:n]
        if not self._wire:
            self._wire_since = None

    def _read(self, now: float, out: list) -> None:
        """At most ``_POLL_READ_BUDGET`` bytes a poll: read to EAGAIN,
        a link takes in whole bursts of KV exports, which the router
        relays before its pump comes back to flush the other links, so
        an ``export_kv`` for a fresh first token would wait behind them
        while its stream finishes in place."""
        budget = _POLL_READ_BUDGET
        while self._sock is not None and budget > 0:
            try:
                data = self._sock.recv(65536)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                if self._decoder.partial:
                    self.frames_corrupt += 1
                    self._fail("torn frame (connection reset mid-frame)")
                self._disconnect(now, "recv error")
                return
            if data == b"":
                if self._decoder.partial:
                    # EOF mid-frame: a torn frame, never deserialized —
                    # counted and classified as replica failure
                    self.frames_corrupt += 1
                    self._fail("torn frame (EOF mid-frame)")
                self._disconnect(now, "connection closed")
                return
            budget -= len(data)
            try:
                msgs = self._decoder.feed(data)
            except FrameError as e:
                self.frames_corrupt += 1
                self._fail(f"corrupt frame: {e}")
            for msg in msgs:
                self._handle(msg, now, out)
                if self._sock is None or self._exited:
                    return

    def _handle(self, msg: tuple, now: float, out: list) -> None:
        kind = msg[0]
        if kind == "evt":
            _, seq, event = msg
            if seq <= self._last_evt_seq:
                return                      # replay overlap: dedupe
            if seq != self._last_evt_seq + 1:
                self._fail(f"event sequence gap ({self._last_evt_seq} "
                           f"-> {seq})")
            self._last_evt_seq = seq
            if event[0] == "ready" and self.meta is None:
                self.meta = event[1]
            out.append(event)
        elif kind == "ack":
            applied = msg[1]
            while self._outbox and self._outbox[0][0] <= applied:
                self._outbox.popleft()
        elif kind == "hello":
            applied, reset, resume_seq = msg[1], msg[2], msg[3]
            if len(msg) > 4 and msg[4] is not None:
                # hello-time exchange: the first offset sample of the
                # link, before any ping has flown (send stamp = when we
                # staged our hello)
                self._note_clock_sample(self._hello_sent_t, now,
                                        float(msg[4]))
            if reset:
                # the server's event ring no longer covers our gap: a
                # lossless resume is impossible, so fail the replica
                # and let the router replay (correctness over uptime)
                self._fail("server reset: event ring overran the "
                           "reconnect gap")
            # a fresh session is fast-forwarded past history it never
            # owned (the server re-emits the sticky ready/state after)
            self._last_evt_seq = max(self._last_evt_seq, int(resume_seq))
            while self._outbox and self._outbox[0][0] <= applied:
                self._outbox.popleft()
            for _, frame in self._outbox:   # resend the unacked tail
                self._stage(frame)
            self._hello_done = True
            if self._ever_connected:
                self.reconnects += 1
            self._ever_connected = True
            self._attempts = 0
        elif kind == "pong":
            sent = self._pings.pop(msg[1], None)
            if sent is not None:
                if len(msg) > 2 and msg[2] is not None:
                    self._note_clock_sample(sent, now, float(msg[2]))
                else:                   # an unstamped (older server) pong
                    self.link_rtt_s = now - sent
        elif kind == "bye":
            self._exited = True
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _note_clock_sample(self, t_send: float, t_recv: float,
                           remote_mono: float) -> None:
        """One round trip's (rtt, offset) estimate — the NTP midpoint
        construction (:func:`~apex_tpu_torch.observability.trace.
        estimate_offset`): the remote stamped its clock somewhere inside
        our [t_send, t_recv] window, so mapping it to the midpoint errs
        by at most RTT/2.  Kept as a sample queue for the router to
        drain (take_rtt_samples) into its RTT histogram + timeline."""
        from apex_tpu_torch.observability.trace import estimate_offset

        offset, _ = estimate_offset(t_send, t_recv, remote_mono)
        rtt = t_recv - t_send
        self.link_rtt_s = rtt
        self.clock_offset_s = offset
        self._rtt_samples.append((rtt, offset, remote_mono))

    def take_rtt_samples(self) -> list:
        """Drain the accumulated ``(rtt_s, offset_s, remote_mono)``
        samples (router-side: histogram + ``link_clock`` spill)."""
        out = list(self._rtt_samples)
        self._rtt_samples.clear()
        return out

    def _maybe_ping(self, now: float) -> None:
        if now - self._last_ping_t < self.ping_every_s:
            return
        self._last_ping_t = now
        self._ping_nonce += 1
        self._pings[self._ping_nonce] = now
        if len(self._pings) > 64:           # unanswered pings don't grow
            oldest = min(self._pings)
            del self._pings[oldest]
        self._stage(encode_frame(("ping", self._ping_nonce)))

    # ------------------------------------------------------------ teardown

    def close(self, timeout: float = 1.0) -> None:
        """Best-effort cooperative stop + socket close (idempotent,
        never raises — the router closes fleets in a loop)."""
        if self._closed:
            return
        self._closed = True
        try:
            if (self._sock is not None and self._hello_done
                    and self._failed is None and not self._exited):
                self._stage(encode_frame(
                    ("cmd", self._cmd_seq + 1, ("stop",))))
                deadline = time.monotonic() + timeout
                self._sock.setblocking(True)
                self._sock.settimeout(0.1)
                while self._wire and time.monotonic() < deadline:
                    try:
                        n = self._sock.send(self._wire)
                    except OSError:
                        break
                    if n <= 0:
                        break
                    del self._wire[:n]
        except Exception:
            pass
        self._close_socks()

    def __enter__(self) -> "SocketTransport":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class _ServerConn:
    __slots__ = ("decoder", "out", "hello_done", "head_rem", "stalled")

    def __init__(self, max_frame_bytes: int):
        self.decoder = FrameDecoder(max_frame_bytes=max_frame_bytes)
        self.out = bytearray()
        self.hello_done = False
        # bytes of a partially-sent head frame still un-flushed (0 =
        # ``out`` starts at a frame boundary).  A deliberate drop of a
        # stalled connection must happen at a boundary only: severing
        # mid-frame would make the client see a torn frame — a
        # corruption verdict — when the wire was never corrupted
        self.head_rem = 0
        # over the buffer cap mid-frame: stop feeding live events (the
        # ring keeps them) and drop once the head frame completes
        self.stalled = False


class TransportServer:
    """Replica-side bridge: frames on a TCP listener ↔ the worker's
    ``cmd_q``/``evt_q`` pair (the exact queues
    :func:`~apex_tpu_torch.serving.replica._replica_worker` already speaks).

    Owns a background I/O thread; the worker thread never touches a
    socket.  Events are sequence-numbered into a bounded ring
    (``event_ring``) so a reconnecting client can resume losslessly;
    commands are deduped by seq and acked.  One router connection is
    active at a time — a newer hello supersedes (and closes) the old
    connection, which is what makes reconnect churn safe.
    """

    def __init__(self, cmd_q, evt_q, *, host: str = "127.0.0.1",
                 port: int = 0, event_ring: int = 8192,
                 max_frame_bytes: int = MAX_FRAME_BYTES,
                 max_buffered_bytes: int = 16 << 20,
                 poll_s: float = 0.005):
        self._cmd_q = cmd_q
        self._evt_q = evt_q
        self._poll_s = poll_s
        self._max_frame = max_frame_bytes
        # cap on one connection's un-flushed outbound bytes: a live but
        # non-draining peer (stalled router link) must not grow replica
        # memory without bound — past the cap the connection is dropped
        # and the session seq-replay makes the loss recoverable
        self._max_buffered = max_buffered_bytes
        self._ring: collections.deque = collections.deque(
            maxlen=event_ring)
        self._evt_seq = 0
        self._cmd_applied = 0
        # sticky copies of the handshake-critical events, re-emitted to
        # a FRESH session whose gap the ring can no longer cover (the
        # restarted-router reattach path)
        self._sticky_ready: Optional[tuple] = None
        self._sticky_state: Optional[tuple] = None
        self._conns: dict = {}              # sock -> _ServerConn
        self._active: Optional[socket.socket] = None
        self._closing = False
        self._send_bye = False
        self._stopped = threading.Event()
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((host, port))
        lsock.listen(8)
        lsock.setblocking(False)
        self._lsock = lsock
        self.address: Tuple[str, int] = lsock.getsockname()
        self._thread = threading.Thread(
            target=self._serve, name="apex-transport-server", daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self.address[1]

    # --------------------------------------------------------------- loop

    def _serve(self) -> None:
        try:
            while True:
                self._pump_events()
                if self._closing and self._evt_q_drained():
                    self._goodbye()
                    return
                rlist = [self._lsock] + list(self._conns)
                wlist = [s for s, c in self._conns.items() if c.out]
                try:
                    r, w, _ = select.select(rlist, wlist, [],
                                            self._poll_s)
                except (OSError, ValueError):
                    if self._lsock.fileno() < 0:
                        return        # close() force-closed the listener
                    # a socket died between iterations; prune and retry
                    self._prune()
                    continue
                for s in w:
                    self._flush(s)
                for s in r:
                    if s is self._lsock:
                        self._accept()
                    else:
                        self._read(s)
        except Exception as e:  # noqa: BLE001 — a server thread must not
            #                     die silently; the client sees silence
            #                     and the router's ladder takes over
            logger.warning("transport server %s: loop error: %r",
                           self.address, e)
        finally:
            for s in list(self._conns):
                self._drop(s)
            try:
                self._lsock.close()
            except OSError:
                pass
            self._stopped.set()

    def _prune(self) -> None:
        for s in list(self._conns):
            if s.fileno() < 0:
                self._drop(s)

    def _accept(self) -> None:
        while True:
            try:
                conn, _ = self._lsock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            conn.setblocking(False)
            try:
                conn.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
            except OSError:
                pass
            self._conns[conn] = _ServerConn(self._max_frame)

    def _read(self, s: socket.socket) -> None:
        """Drain what the kernel holds for ``s``, up to
        ``_READ_BUDGET`` bytes a loop turn.  Every turn waits for the
        GIL behind the engine thread, so a KV migration's blocks read a
        small chunk a turn would outlast the client's send timeout."""
        budget = _READ_BUDGET
        while budget > 0:
            conn = self._conns.get(s)
            if conn is None:
                return
            try:
                data = s.recv(_READ_CHUNK)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._drop(s)
                return
            if data == b"":
                self._drop(s)
                return
            budget -= len(data)
            try:
                msgs = conn.decoder.feed(data)
            except FrameError as e:
                # garbage from the router direction: drop the
                # connection; the client reconnects and re-sends its
                # unacked commands
                logger.warning("transport server: dropping connection "
                               "on bad inbound frame: %s", e)
                self._drop(s)
                return
            for msg in msgs:
                self._handle(s, conn, msg)

    def _handle(self, s, conn: _ServerConn, msg: tuple) -> None:
        kind = msg[0]
        if kind == "hello":
            # msg[2] (the client's cmd_seq) is informational: a fresh
            # client's outbox is entirely unacked and resends from
            # seq 1, so only the reset below matters for dedupe
            last_seen, fresh = int(msg[1]), bool(msg[3])
            if fresh:
                # a brand-new session (restarted router): its command
                # numbering starts over — the OLD session's dedupe
                # watermark must not black-hole the new submits
                self._cmd_applied = 0
            oldest = self._ring[0][0] - 1 if self._ring else self._evt_seq
            covered = oldest <= last_seen <= self._evt_seq
            reset = not covered and not fresh
            resume_seq = last_seen if covered else self._evt_seq
            # the monotonic clock stamp goes only to clients
            # that ADVERTISED it (hello element 5): an older router
            # strict-unpacks a 4-tuple reply, and a mixed-version fleet
            # mid-rolling-upgrade (replicas first) must keep working
            if len(msg) > 4:
                reply = ("hello", self._cmd_applied, reset, resume_seq,
                         time.monotonic())
            else:
                reply = ("hello", self._cmd_applied, reset, resume_seq)
            conn.out.extend(encode_frame(reply))
            if covered:
                for seq, evt in self._ring:
                    if seq > last_seen:
                        conn.out.extend(encode_frame(("evt", seq, evt)))
            elif fresh:
                # fast-forwarded past history it never owned: re-emit
                # the handshake-critical sticky events as NEW events so
                # the fresh router still gets meta + current state
                for evt in (self._sticky_ready, self._sticky_state):
                    if evt is not None:
                        self._evt_seq += 1
                        self._ring.append((self._evt_seq, evt))
                        conn.out.extend(encode_frame(
                            ("evt", self._evt_seq, evt)))
            conn.hello_done = True
            if self._active is not None and self._active is not s:
                self._drop(self._active)
            self._active = s
        elif kind == "cmd":
            seq, cmd = int(msg[1]), msg[2]
            if seq > self._cmd_applied:
                self._cmd_applied = seq
                self._cmd_q.put(cmd)
            conn.out.extend(encode_frame(("ack", self._cmd_applied)))
        elif kind == "ping":
            # the pong's monotonic stamp is the clock-alignment anchor
            #: this host's clock at (approximately) the
            # client's round-trip midpoint
            conn.out.extend(encode_frame(
                ("pong", msg[1], time.monotonic())))

    def _pump_events(self) -> None:
        while True:
            try:
                raw = self._evt_q.get_nowait()
            except queue_mod.Empty:
                return
            # the worker's batched relay arrives
            # as one ("batch", [...]) payload; each sub-event gets its
            # OWN sequence number so the client's dedupe/sticky logic
            # never sees the wrapper
            subs = raw[1] if raw and raw[0] == "batch" else (raw,)
            for evt in subs:
                self._pump_one(evt)

    def _pump_one(self, evt: tuple) -> None:
        if evt[0] == "ready":
            self._sticky_ready = evt
        elif evt[0] == "state":
            self._sticky_state = evt
        self._evt_seq += 1
        self._ring.append((self._evt_seq, evt))
        active = self._active
        if active is not None and active in self._conns and \
                self._conns[active].hello_done:
            conn = self._conns[active]
            if conn.stalled:
                return      # ring keeps the event; conn is awaiting
            #                 its boundary drop in _flush
            conn.out.extend(
                encode_frame(("evt", self._evt_seq, evt)))
            if len(conn.out) > self._max_buffered:
                # live-but-stalled peer: drop rather than grow
                # without bound; seq replay recovers on reconnect.
                # Only ever sever at a frame boundary — a mid-frame
                # cut would read as a TORN frame (a corruption
                # verdict) at the client, not a connection loss
                if conn.head_rem == 0:
                    logger.warning(
                        "transport server %s: dropping stalled "
                        "connection (%d bytes un-flushed)",
                        self.address, len(conn.out))
                    self._drop(active)
                else:
                    logger.warning(
                        "transport server %s: stalling connection "
                        "(%d bytes un-flushed, mid-frame); will "
                        "drop at the frame boundary",
                        self.address, len(conn.out))
                    conn.stalled = True

    @staticmethod
    def _mark_sent(conn: _ServerConn, n: int) -> None:
        """Advance ``head_rem`` across ``n`` just-sent bytes of
        ``conn.out`` (called BEFORE they are deleted).  ``out`` holds
        whole frames except for a partially-sent head, so frame lengths
        parse directly from the buffer."""
        pos = 0
        if conn.head_rem:
            take = min(n, conn.head_rem)
            conn.head_rem -= take
            pos = take
        while pos < n:
            _, body_len, _ = _HEADER.unpack_from(conn.out, pos)
            total = _HEADER.size + body_len
            if pos + total <= n:
                pos += total
            else:
                conn.head_rem = total - (n - pos)
                pos = n

    def _flush(self, s: socket.socket) -> None:
        conn = self._conns.get(s)
        if conn is None or not conn.out:
            return
        try:
            n = s.send(conn.out)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop(s)
            return
        if n > 0:
            self._mark_sent(conn, n)
            del conn.out[:n]
        if conn.stalled and conn.head_rem == 0:
            # the deferred stall-drop: the head frame completed, so the
            # sever now lands on a boundary and the client reconnects
            # (lossless seq replay) instead of reporting a torn frame
            self._drop(s)

    def _drop(self, s: socket.socket) -> None:
        self._conns.pop(s, None)
        if self._active is s:
            self._active = None
        try:
            s.close()
        except OSError:
            pass

    def _evt_q_drained(self) -> bool:
        active = self._active
        flushed = (active is None or active not in self._conns
                   or not self._conns[active].out)
        try:
            empty = self._evt_q.empty()
        except Exception:
            empty = True
        return empty and flushed

    def _goodbye(self) -> None:
        active = self._active
        if self._send_bye and active is not None and \
                active in self._conns:
            conn = self._conns[active]
            conn.out.extend(encode_frame(("bye",)))
            deadline = time.monotonic() + 2.0
            try:
                active.setblocking(True)
                active.settimeout(0.2)
                while conn.out and time.monotonic() < deadline:
                    n = active.send(conn.out)
                    if n <= 0:
                        break
                    del conn.out[:n]
            except OSError:
                pass

    # ------------------------------------------------------------ teardown

    def close(self, *, bye: bool = True, timeout: float = 5.0) -> None:
        """Flush pending events (so a ``drained`` event beats the FIN),
        optionally send the intentional-exit ``bye``, and stop."""
        self._send_bye = bye
        self._closing = True
        self._stopped.wait(timeout)
        try:
            self._lsock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Host daemon
# ---------------------------------------------------------------------------


def replica_serve(spec, name: str, *, host: str = "127.0.0.1",
                  port: int = 0, ready_hook=None, on_ready=None) -> None:
    """Process main for one cross-host replica: the existing
    :func:`~apex_tpu_torch.serving.replica._replica_worker` lifecycle (same
    ready handshake carrying the restored ckpt step + debug port, same
    PreemptionGuard SIGTERM drain, same orphan watchdog) served over a
    :class:`TransportServer` instead of multiprocessing queues.

    Runs the worker on the *calling* thread so the PreemptionGuard owns
    the real SIGTERM handler — a preempted/rolled host drains exactly
    like the in-process transport.  ``ready_hook(address)`` fires once
    the listener is bound (how a spawner learns an ephemeral port);
    ``on_ready(engine)`` once the engine has warmed up, before the ready
    handshake (:func:`~apex_tpu_torch.serving.replica._replica_worker`).

    The server's bound on one connection's un-flushed bytes is the
    replica's whole KV arena plus 16 MiB: a KV migration puts a
    request's whole block run on the wire at once (13-35 MB for one
    GPT-124M request), and past the bound the server drops the
    connection, whose reconnect replays the run from the event ring and
    trips the bound again.
    """
    from apex_tpu_torch.serving.replica import _kv_pool_bytes, _replica_worker

    cmd_q: queue_mod.Queue = queue_mod.Queue()
    evt_q: queue_mod.Queue = queue_mod.Queue()
    server = TransportServer(
        cmd_q, evt_q, host=host, port=port,
        max_buffered_bytes=(16 << 20) + _kv_pool_bytes(spec))
    if ready_hook is not None:
        ready_hook(server.address)
    try:
        _replica_worker(spec, name, cmd_q, evt_q, os.getppid(),
                        on_ready=on_ready)
    finally:
        server.close(bye=True)


def _replica_serve_entry(spec, name, host, port, addr_q) -> None:
    replica_serve(spec, name, host=host, port=port,
                  ready_hook=addr_q.put)


def start_replica_server(spec, name: str, *, host: str = "127.0.0.1",
                         port: int = 0, start_method: str = "spawn",
                         addr_timeout_s: float = 60.0):
    """Spawn a :func:`replica_serve` daemon locally (loopback testing /
    single-host fleets); returns ``(process, (host, port))``.  A real
    cross-host deployment runs ``replica_serve`` under its own process
    supervisor on each host instead — see docs/serving.md.
    ``start_method="fork"`` raises for a replica on ``cuda``."""
    import multiprocessing as mp

    from apex_tpu_torch.serving.replica import _needs_spawn

    _needs_spawn(spec, start_method)
    ctx = mp.get_context(start_method)
    addr_q = ctx.Queue()
    proc = ctx.Process(target=_replica_serve_entry,
                       args=(spec, name, host, port, addr_q),
                       daemon=False, name=f"apex-replica-serve-{name}")
    proc.start()
    deadline = time.monotonic() + addr_timeout_s
    while True:
        try:
            addr = addr_q.get(timeout=0.2)
            break
        except queue_mod.Empty:
            if not proc.is_alive():
                raise RuntimeError(
                    f"replica server {name} died before binding "
                    f"(exitcode {proc.exitcode})") from None
            if time.monotonic() > deadline:
                proc.terminate()
                raise RuntimeError(
                    f"replica server {name} did not bind in "
                    f"{addr_timeout_s:.0f}s") from None
    return proc, (addr[0], int(addr[1]))
