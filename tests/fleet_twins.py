"""Run the JAX package's fleet test scenarios through both packages.

The reference's fleet tests (``test_fleet.py``, ``test_transport.py``,
``test_autopilot.py``, ``test_slo.py``, ``test_trace.py``) drive the
router, transports, autopilot and observability through in-memory fakes
and loopback sockets, with no JAX in the path.  :func:`load` compiles a
copy of one such file bound to one side: ``"ref"`` keeps its
``apex_tpu`` imports, ``"port"`` has them rewritten to
``apex_tpu_torch``, and either side's copies import each other (its
``from test_fleet import ...`` is rewritten too).  The files themselves
are read, never edited.

:func:`run_case` runs one scenario on one side, with its own asserts,
and records what it built: every router's requests (state, tokens,
replays, reschedules, replica) and integer counters, every fake
replica's submissions in dispatch order, every autopilot's decision
log, every ``SLOEvaluator.evaluate`` verdict, and the results of the
trace stitcher, summariser and merger.  Floats and minted trace ids
are left out (wall-clock values and ``uuid4`` draws differ from run to
run on one side alone); what is left must be equal on both sides.
Over loopback sockets only the streams (each request's state, and a
finished request's tokens) are compared: which replica takes a request,
how many reconnects a fault costs, and how many tokens a request had
when a fault cut it off depend on thread timing on one side alone.

Both sides' ``ChaosProxy`` run with one change (:func:`_deferred_cut`):
``drop_connections`` cuts a link at the next frame that crosses it and
waits up to ``wait_s`` for that, but the scenario's one thread drives
the router and the replicas, so nothing crosses while it waits; when
the frames it aimed at had all crossed already (a loaded machine), the
proxy gave up after ``wait_s`` and left the link whole, and the scenario
saw no reconnect.  Here a link not cut in that time stays marked and is
cut at the next frame that does cross, after the wait returns, and the
wait is :data:`CUT_WAIT_S`: with the replicas paced (below) no frame is
left in flight for it to catch.

Both sides' socket replicas are paced (:func:`_paced_served`,
:func:`_prompt_server`).  A ``TransportServer`` takes the events a tick
queued only when its select loop next wakes (every ``poll_s``, 5 ms by
default, later when a loaded machine schedules its thread late), so the
ticks of several loop turns left in one burst: a six-token request could
reach the router whole in one pump, and a scenario that arms a fault at
the first token (``test_bad_frame_counted_and_classified_replica_
failure``) found the request finished before it could arm ("fault never
armed mid-stream").  Here the servers wake every 0.5 ms, and a
``ServedFake.tick`` returns once its live server has taken the tick's
events off the queue (within a second), so each tick's events leave
before the next tick makes more, whatever the machine's load.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import inspect
import itertools
import pathlib
import re
import sys
import time
import types
from typing import Any, Dict, List, Tuple

import numpy as np
import pytest

HERE = pathlib.Path(__file__).resolve().parent
_LOADED: Dict[Tuple[str, str], types.ModuleType] = {}
_HEX_ID = re.compile(r"^[0-9a-f]{16}$")

# names whose results are recorded when a scenario calls them
TAPPED_FUNCS = ("stitch_traces", "summarize_traces", "merge_dir",
                "collect_slo_events", "read_jsonl", "match_series")


def load(name: str, side: str) -> types.ModuleType:
    """``tests/<name>.py`` compiled for ``side`` ("ref" or "port")."""
    key = (name, side)
    if key in _LOADED:
        return _LOADED[key]
    if name != "test_fleet":
        load("test_fleet", side)
    src = (HERE / f"{name}.py").read_text()
    if side == "port":
        src = re.sub(r"\bapex_tpu\b(?!_torch)", "apex_tpu_torch", src)
    src = re.sub(r"\bfrom test_fleet import",
                 f"from _{side}_test_fleet import", src)
    mod = types.ModuleType(f"_{side}_{name}")
    mod.__file__ = str(HERE / f"{name}.py")
    sys.modules[mod.__name__] = mod
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    _LOADED[key] = mod
    return mod


def cases(name: str, skip: Dict[str, str] = None) -> List[Any]:
    """Every test of ``tests/<name>.py``, each parametrisation expanded:
    ``pytest.param((test, kwargs), id=...)``, in file order.  ``skip``
    maps test names to the reason they are left out."""
    mod = load(name, "ref")
    skip = skip or {}
    tests = sorted((fn for n, fn in vars(mod).items()
                    if n.startswith("test_") and inspect.isfunction(fn)),
                   key=lambda fn: fn.__code__.co_firstlineno)
    out = []
    for fn in tests:
        if fn.__name__ in skip:
            continue
        axes = []
        for mark in getattr(fn, "pytestmark", []):
            if mark.name != "parametrize":
                continue
            names = mark.args[0]
            names = ([n.strip() for n in names.split(",")]
                     if isinstance(names, str) else list(names))
            rows = []
            for v in mark.args[1]:
                vals = v.values if hasattr(v, "values") else v
                if len(names) == 1 and not hasattr(v, "values"):
                    vals = (v,)
                rows.append(dict(zip(names, vals)))
            axes.append(rows)
        for combo in itertools.product(*axes) if axes else [()]:
            kw = {}
            for part in combo:
                kw.update(part)
            ident = fn.__name__
            if kw:
                ident += "[" + "-".join(str(v) for v in kw.values()) + "]"
            out.append(pytest.param((fn.__name__, kw), id=ident))
    return out


# ------------------------------------------------------------- recording

_ACTIVE: List[dict] = []


def _recording_class(cls, kind: str, methods=()):
    class Recorded(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            if _ACTIVE:
                _ACTIVE[-1].setdefault(kind, []).append(self)

    for meth in methods:
        def tap(self, *a, __m=meth, **k):
            out = getattr(super(Recorded, self), __m)(*a, **k)
            if _ACTIVE:
                _ACTIVE[-1].setdefault(f"{kind}.{__m}", []).append(out)
            return out
        setattr(Recorded, meth, tap)
    Recorded.__name__ = cls.__name__
    Recorded.__qualname__ = cls.__qualname__
    Recorded.__module__ = cls.__module__
    return Recorded


def _tapped_func(fn, name):
    def tap(*a, **k):
        out = fn(*a, **k)
        if _ACTIVE:
            _ACTIVE[-1].setdefault(name, []).append(out)
        return out
    tap.__wrapped__ = fn
    return tap


CUT_WAIT_S = 0.05              # drop_connections' wait before it defers


def _deferred_cut(cls):
    """``cls`` (either side's ``ChaosProxy``) whose ``drop_connections``
    still cuts, at their next frame, the links it could not cut while it
    waited (see the module docstring)."""
    class DeferredCut(cls):
        def drop_connections(self, *, wait_s: float = 5.0) -> None:
            with self._lock:
                live = [p for p in self._pairs if not p.closed]
            super().drop_connections(wait_s=min(wait_s, CUT_WAIT_S))
            with self._lock:
                self._doomed = [p for p in getattr(self, "_doomed", [])
                                + live if not p.closed]

        def _fault_gate(self, pair) -> bool:
            with self._lock:
                doomed = any(p is pair for p in getattr(self, "_doomed", ()))
                if doomed:
                    self._doomed = [p for p in self._doomed if p is not pair]
            if doomed:
                pair.close()
                with self._lock:
                    self._pairs = [p for p in self._pairs if not p.closed]
                return True
            return super()._fault_gate(pair)

    DeferredCut.__name__ = cls.__name__
    DeferredCut.__qualname__ = cls.__qualname__
    DeferredCut.__module__ = cls.__module__
    return DeferredCut


PACE_POLL_S = 0.0005          # the paced servers' select timeout
PACE_WAIT_S = 1.0             # the longest a tick waits for its server


def _prompt_server(cls):
    """``cls`` (either side's ``TransportServer``) with ``poll_s``
    defaulting to :data:`PACE_POLL_S`."""
    class Prompt(cls):
        def __init__(self, *a, **k):
            k.setdefault("poll_s", PACE_POLL_S)
            super().__init__(*a, **k)

    Prompt.__name__ = cls.__name__
    Prompt.__qualname__ = cls.__qualname__
    Prompt.__module__ = cls.__module__
    return Prompt


def _paced_served(cls):
    """``cls`` (either side's ``ServedFake``) whose ``tick`` returns once
    its live server has taken the tick's events off the queue (see the
    module docstring)."""
    class Paced(cls):
        def tick(self):
            super().tick()
            deadline = time.monotonic() + PACE_WAIT_S
            while (not self._closed and not self.evt_q.empty()
                   and time.monotonic() < deadline):
                time.sleep(0.0002)

    Paced.__name__ = cls.__name__
    Paced.__qualname__ = cls.__qualname__
    Paced.__module__ = cls.__module__
    return Paced


_PACED = {"ChaosProxy": _deferred_cut, "TransportServer": _prompt_server,
          "ServedFake": _paced_served}

_CLASSES = {"FleetRouter": ("router", ()),
            "FakeReplica": ("replica", ()),
            "FleetAutopilot": ("autopilot", ()),
            "SLOEvaluator": ("slo", ("evaluate",))}


@contextlib.contextmanager
def _patched(side: str):
    """Swap the recorded names into every loaded module of ``side``."""
    saved = []
    made = {}
    for (_, s), mod in _LOADED.items():
        if s != side:
            continue
        for attr, wrap in _PACED.items():
            cls = mod.__dict__.get(attr)
            if isinstance(cls, type):
                if cls not in made:
                    made[cls] = wrap(cls)
                saved.append((mod, attr, cls))
                mod.__dict__[attr] = made[cls]
        for attr, (kind, methods) in _CLASSES.items():
            cls = mod.__dict__.get(attr)
            if isinstance(cls, type):
                if cls not in made:
                    made[cls] = _recording_class(cls, kind, methods)
                saved.append((mod, attr, cls))
                mod.__dict__[attr] = made[cls]
        for attr in TAPPED_FUNCS:
            fn = mod.__dict__.get(attr)
            if inspect.isfunction(fn):
                saved.append((mod, attr, fn))
                mod.__dict__[attr] = _tapped_func(fn, attr)
    try:
        yield
    finally:
        for mod, attr, obj in reversed(saved):
            mod.__dict__[attr] = obj


def norm(x: Any) -> Any:
    """A comparable, side-free form: enums by value, dataclasses and
    objects with ``__dict__`` by class name and fields, arrays as lists;
    floats and 16-hex trace ids dropped."""
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, bool) or x is None or isinstance(x, int):
        return x
    if isinstance(x, float):
        return "<float>"
    if isinstance(x, str):
        return "<id>" if _HEX_ID.match(x) else x
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, np.floating):
        return "<float>"
    if isinstance(x, np.ndarray):
        return norm(x.tolist())
    if isinstance(x, dict):
        return {norm(k): norm(v) for k, v in x.items()
                if k not in ("trace_id", "ts", "t", "mono")}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(map(repr, map(norm, x)))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [type(x).__name__,
                norm({f.name: getattr(x, f.name)
                      for f in dataclasses.fields(x)})]
    return type(x).__name__


def _outcome(rec: dict, parts) -> dict:
    out = {}
    if "streams" in parts:
        # how far an unfinished request got before its fault is timing
        out["streams"] = [
            [(rid, q.state.value, list(q.output_tokens)
              if q.state.value == "finished" else None)
             for rid, q in sorted(r.requests.items())]
            for r in rec.get("router", [])]
    if "requests" in parts:
        out["requests"] = [
            [(rid, q.state.value, list(q.output_tokens), q.replays,
              q.reschedules, q.replica)
             for rid, q in sorted(r.requests.items())]
            for r in rec.get("router", [])]
    if "counters" in parts:
        out["counters"] = [
            {n: int(v) for n, v in
             r.registry.snapshot_typed()["counters"].items()
             if float(v).is_integer()}
            for r in rec.get("router", [])]
    if "dispatch" in parts:
        out["dispatch"] = [
            (rep.name, [norm(s[1:]) for s in rep.submissions])
            for rep in rec.get("replica", [])]
    if "decisions" in parts:
        out["decisions"] = [norm(ap.decisions)
                            for ap in rec.get("autopilot", [])]
    if "results" in parts:
        for key in ("slo.evaluate",) + TAPPED_FUNCS:
            if key in rec:
                out[key] = norm(rec[key])
    return out


ALL_PARTS = ("requests", "counters", "dispatch", "decisions", "results")
# over loopback sockets, which replica takes a request and how many
# reconnects a fault costs depend on thread timing: the streams do not
SOCKET_PARTS = ("streams", "decisions", "results")


def _fixtures(fn, kw, tmp_path: pathlib.Path, stack: contextlib.ExitStack):
    args = dict(kw)
    for p in inspect.signature(fn).parameters:
        if p in args:
            continue
        if p == "tmp_path":
            d = tmp_path
            d.mkdir(parents=True, exist_ok=True)
            args[p] = d
        elif p == "monkeypatch":
            mp = pytest.MonkeyPatch()
            stack.callback(mp.undo)
            args[p] = mp
        else:
            raise LookupError(f"no fixture {p!r} for {fn.__name__}")
    return args


def run_case(name: str, case, side: str, tmp_path: pathlib.Path,
             parts=ALL_PARTS) -> dict:
    """One scenario on one side (its asserts included); its outcome."""
    test, kw = case
    mod = load(name, side)
    rec: dict = {}
    _ACTIVE.append(rec)
    try:
        with _patched(side), contextlib.ExitStack() as stack:
            fn = mod.__dict__[test]
            fn(**_fixtures(fn, kw, tmp_path / side, stack))
    finally:
        _ACTIVE.pop()
    return _outcome(rec, parts)


def assert_same(name: str, case, tmp_path: pathlib.Path,
                parts=ALL_PARTS) -> dict:
    """The scenario through both packages: equal outcomes."""
    ref = run_case(name, case, "ref", tmp_path, parts)
    port = run_case(name, case, "port", tmp_path, parts)
    assert set(port) == set(ref)
    for key in ref:
        assert port[key] == ref[key], key
    return ref
