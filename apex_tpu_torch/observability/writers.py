"""Crash-safe metrics storage — append-only fsync'd JSONL (port of
:mod:`apex_tpu.observability.writers`).

A
run that dies must leave behind (a) every metric record that was
acknowledged and (b) a file a reader can always parse.  The format that
satisfies both with no recovery machinery is append-only JSONL with one
``open → write → fsync → close`` cycle per record:

- each record is a single ``os.write`` of one newline-terminated line to
  an ``O_APPEND`` descriptor — concurrent writers interleave at line
  granularity, never mid-line;
- ``fsync`` before the call returns makes acknowledged records durable
  (the same contract as the checkpoint temp-fsync-rename protocol,
  without the rename: appends never replace committed bytes);
- a crash mid-write can tear at most the *final* line;
  :func:`read_jsonl` therefore treats an unparseable tail as the
  expected torn-write artifact and returns the intact prefix (a torn
  *interior* line — real corruption — is skipped with a warning, or
  fatal under ``strict=True``);
- transient ``OSError`` (an NFS/GCS-fuse blip) gets a bounded
  retry-with-backoff.

Rank-awareness lives one layer up (``MetricRegistry.flush`` writes only
on rank 0); this module is deliberately a dumb, durable pipe.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Iterator, List, Optional

__all__ = ["JsonlWriter", "read_jsonl", "iter_jsonl"]

logger = logging.getLogger(__name__)


class JsonlWriter:
    """Append-only fsync'd JSONL writer.

    ``fsync=False`` trades durability of the last few records for write
    latency (the OS still sees every byte; only a *power* loss can eat
    buffered lines) — keep the default for rank-0 training telemetry,
    where one fsync per ``log_every_n`` steps is noise.
    """

    def __init__(self, path: str, *, fsync: bool = True, retries: int = 3,
                 backoff_s: float = 0.05, keep_open: bool = False,
                 rotate_bytes: Optional[int] = None):
        self.path = path
        self.fsync = fsync
        self.retries = retries
        self.backoff_s = backoff_s
        # rotate_bytes (default off): when appending the next
        # record would push the live file past the bound, the file is
        # first renamed to a `<stem>.rot-NNNNNN.jsonl` segment and the
        # append opens a fresh file.  Rotation happens strictly BETWEEN
        # records (a frame boundary), so every segment keeps the
        # torn-tail-only durability contract: the single-write line
        # atomicity is untouched, only the file the O_APPEND descriptor
        # points at changes.  Segment names keep the `.jsonl` suffix so
        # spill readers glob them up; ``trace.read_fleet_spills`` groups
        # segments back into one logical stream in rotation order.
        if rotate_bytes is not None and rotate_bytes <= 0:
            raise ValueError("rotate_bytes must be positive (or None)")
        self.rotate_bytes = rotate_bytes
        self.rotations = 0
        self._size: Optional[int] = None   # live-file bytes, lazy stat
        # keep_open=True holds one O_APPEND descriptor across records
        # instead of an open→write→close cycle per record.  Durability
        # is IDENTICAL (each record is still a single O_APPEND
        # ``os.write`` of one full line — torn-tail-only under SIGKILL,
        # line-atomic against concurrent appenders); what changes is
        # the per-record syscall cost (~54µs → ~10µs measured), which
        # matters on event-per-token spill rates.  Keep the default for rank-0 training metrics,
        # where a descriptor held across a fork/preemption is a leak
        # hazard and one open per logged step is noise.
        self.keep_open = keep_open
        self._fd: int = -1
        self.records_written = 0
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)

    def write(self, record: dict) -> None:
        """Durably append one record.  Serialization errors propagate
        immediately (a bug, not weather); ``OSError`` is retried with
        exponential backoff and re-raised when the budget is spent.

        The retry tracks how many bytes actually landed, so a blip
        *after* the append (fsync, close) never re-appends the record as
        a duplicate, and a short/torn write is completed from where it
        stopped rather than restarted (O_APPEND continues the same
        line)."""
        data = (json.dumps(record, separators=(",", ":"),
                           default=_json_fallback) + "\n").encode()
        if self.rotate_bytes is not None:
            self._maybe_rotate(len(data))
        sent = 0
        for attempt in range(self.retries + 1):
            try:
                if self.keep_open:
                    if self._fd < 0:
                        self._fd = os.open(
                            self.path,
                            os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                            0o644)
                    while sent < len(data):
                        sent += os.write(self._fd, data[sent:])
                    if self.fsync:
                        os.fsync(self._fd)
                else:
                    # Open-per-record: no long-lived descriptor to leak
                    # across a fork/preemption, and the O_APPEND
                    # single-shot write keeps the line contiguous even
                    # with a concurrent writer.
                    fd = os.open(self.path,
                                 os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                                 0o644)
                    try:
                        while sent < len(data):
                            sent += os.write(fd, data[sent:])
                        if self.fsync:
                            os.fsync(fd)
                    finally:
                        os.close(fd)
                self.records_written += 1
                if self._size is not None:
                    self._size += len(data)
                return
            except OSError as e:
                # a kept descriptor that errored is suspect (stale NFS
                # handle, rotated file): drop it and let the retry
                # reopen — O_APPEND continues the same line from `sent`
                self.close()
                if attempt == self.retries:
                    raise
                delay = self.backoff_s * (2.0 ** attempt)
                logger.warning(
                    "metrics append to %s failed (%r), retry %d/%d in "
                    "%.2fs", self.path, e, attempt + 1, self.retries, delay)
                time.sleep(delay)

    def _rotated_name(self, seq: int) -> str:
        stem, ext = os.path.splitext(self.path)
        if ext != ".jsonl":
            stem, ext = self.path, ""
        return f"{stem}.rot-{seq:06d}{ext}"

    def _maybe_rotate(self, incoming: int) -> None:
        """Rename the live file aside when the next append would cross
        ``rotate_bytes`` — between records only, so every segment ends
        on a whole line.  Rotation is best-effort: a failed rename logs
        and keeps appending (durability beats the size bound)."""
        if self._size is None:
            try:
                self._size = os.stat(self.path).st_size
            except OSError:
                self._size = 0
        if self._size <= 0 or self._size + incoming <= self.rotate_bytes:
            return
        seq = self.rotations + 1
        while os.path.exists(self._rotated_name(seq)):
            seq += 1          # a restarted writer never clobbers history
        try:
            self.close()      # the kept descriptor must follow the file
            os.rename(self.path, self._rotated_name(seq))
        except OSError as e:
            logger.warning("JSONL rotation of %s failed (%r); appending "
                           "past rotate_bytes", self.path, e)
            return
        self.rotations = seq
        self._size = 0

    def close(self) -> None:
        """Release the kept descriptor (keep_open mode); a later write
        reopens.  No-op in open-per-record mode."""
        if self._fd >= 0:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = -1


def _json_fallback(obj):
    """Serialize the numpy/torch scalars metric records naturally carry."""
    if hasattr(obj, "item"):
        return obj.item()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    raise TypeError(f"not JSON serializable: {type(obj)!r}")


def iter_jsonl(path: str, *, strict: bool = False) -> Iterator[dict]:
    """Yield records, tolerating the crash artifacts the writer can
    leave: a torn FINAL line (writer died mid-append) is silently
    dropped — even under ``strict``, because it is the *expected* shape
    of a crash, not corruption; a torn interior line IS storage
    corruption — skipped with a warning, or raised under
    ``strict=True``."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    n = len(lines)
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            yield json.loads(line)
        except json.JSONDecodeError as e:
            # A tear happens mid-append, so the torn line is the file's
            # very last content AND unterminated (no trailing newline —
            # a terminated garbage line is interior corruption instead).
            if i == n - 1:
                logger.info("dropping torn JSONL tail in %s", path)
                return
            if strict:
                raise ValueError(
                    f"corrupt JSONL line {i} in {path}: {e}") from e
            logger.warning(
                "skipping corrupt JSONL line %d in %s (%s)", i, path, e)


def read_jsonl(path: str, *, strict: bool = False) -> List[dict]:
    """All intact records of a (possibly torn) metrics file."""
    return list(iter_jsonl(path, strict=strict))
