"""Chrome trace-event (Perfetto-loadable) writer for solver timelines, the
port of ``repro.telemetry.trace``, and the program's own spans.

Emits the JSON object format of the Trace Event spec — a ``traceEvents``
list of phase-coded events — which both ``chrome://tracing`` and
https://ui.perfetto.dev load directly. The writer keeps its own
process/thread registries so callers name rows semantically ("serving" /
"lane 0") instead of juggling pid/tid integers:

- ``complete(name, ts_us, dur_us, ...)`` — a span (ph "X"): serving
  requests, lane dispatches, solve chunks.
- ``instant(name, ts_us, ...)`` — a point event (ph "i"): admissions,
  ejections, publications.
- ``counter(name, ts_us, values)`` — a counter track (ph "C"): lane fill,
  per-chunk gbest.
- ``span(name, ...)`` — context manager wrapping a host-side region with
  ``now_us`` stamps.

``now_us`` is Unix time in microseconds, the clock ``torch.profiler``
(kineto) gives its host events and, converted, the card's, so a span lies
over the device trace without a shift. Like kineto's own clock, it is a
monotonic clock (``time.perf_counter``) mapped onto Unix time
(``time.time_ns``, ``CLOCK_REALTIME``) by an offset taken at import and
again at the start of each outermost program span that records: a
duration never sees the wall clock step, and two stamps are never two
clocks apart. ``wall_us`` maps a ``time.perf_counter`` stamp that a caller
took for a duration of its own. ``to_dict()`` rebases the timestamps to
zero so the timeline starts at t=0 regardless of the clock.

**Program spans.** ``begin(name)`` and ``end(token)`` bracket a region of
the port where one solve's work happens (``api.solve``,
``pso.init_swarm``, ``ops.pack``, ``ops.launch``, ``ops.unpack``,
``api.read``). A span records only while a ``torch.profiler`` session is
active or a writer is installed (``recording(writer)``); otherwise
``begin`` tests one flag and returns None, and ``end(None)`` returns. A
recorded span is a complete event of category ``SPAN_CAT`` whose ``args``
carry its ``id``, its ``parent``'s id (the innermost span open on the same
thread when it began) and the id of the ``solve`` it belongs to (the
``api.solve`` span's own id; None outside a solve). Spans go to the
installed writer, else to a process-wide default writer, which past
twice ``SPAN_LIMIT`` spans keeps the most recent ``SPAN_LIMIT``.
``spans()`` returns them.

``profiler_session(logdir)`` optionally brackets a region with a
``torch.profiler`` trace (the card's kernels alongside the host's
operators), written to ``<logdir>/torch_trace.json`` together with the
program spans recorded during the session, in that file's time base; it
degrades to a no-op when the profiler cannot start, so callers never gate
on it.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

#: The category of the program's spans in a writer.
SPAN_CAT = "repro_torch"
#: The spans the default writer keeps, the most recent ones: about 18000
#: solves' worth (7 spans a solve).
SPAN_LIMIT = 2 ** 17


def _anchor() -> None:
    """Take ``time.time_ns`` less ``time.perf_counter``, in us, from the
    closest-spaced of three brackets of reads (to within half its
    spacing)."""
    global _offset_us
    best = None
    for _ in range(3):
        a = time.perf_counter()
        w = time.time_ns()
        b = time.perf_counter()
        if best is None or b - a < best[0]:
            best = (b - a, w / 1e3 - (a + b) * 5e5)
    _offset_us = best[1]


_offset_us = 0.0
_anchor()


def wall_us(perf_us: float) -> float:
    """A ``time.perf_counter`` stamp, in microseconds, on ``now_us``'s
    clock."""
    return perf_us + _offset_us


def now_us() -> float:
    """Unix time in microseconds: the clock of every timestamp here."""
    return time.perf_counter() * 1e6 + _offset_us


class TraceWriter:
    """Accumulates trace events; one instance per exported timeline."""

    def __init__(self) -> None:
        self._events: List[Dict[str, Any]] = []
        self._pids: Dict[str, int] = {}
        self._tids: Dict[tuple, int] = {}

    def _pid(self, process: str) -> int:
        pid = self._pids.get(process)
        if pid is None:
            pid = len(self._pids) + 1
            self._pids[process] = pid
            self._events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": process},
            })
        return pid

    def _tid(self, process: str, thread: str) -> int:
        key = (process, thread)
        tid = self._tids.get(key)
        if tid is None:
            pid = self._pid(process)
            tid = sum(1 for p, _ in self._tids if p == process) + 1
            self._tids[key] = tid
            self._events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": thread},
            })
        return tid

    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 process: str = "solver", thread: str = "main",
                 cat: str = "solve",
                 args: Optional[Dict[str, Any]] = None) -> None:
        """A finished span: ``[ts_us, ts_us + dur_us]`` on a named row."""
        self._events.append({
            "name": name, "ph": "X", "cat": cat,
            "ts": float(ts_us), "dur": max(0.0, float(dur_us)),
            "pid": self._pid(process), "tid": self._tid(process, thread),
            "args": dict(args or {}),
        })

    def instant(self, name: str, ts_us: float, *,
                process: str = "solver", thread: str = "main",
                cat: str = "solve",
                args: Optional[Dict[str, Any]] = None) -> None:
        """A point event (thread-scoped tick mark)."""
        self._events.append({
            "name": name, "ph": "i", "s": "t", "cat": cat,
            "ts": float(ts_us),
            "pid": self._pid(process), "tid": self._tid(process, thread),
            "args": dict(args or {}),
        })

    def counter(self, name: str, ts_us: float,
                values: Dict[str, float], *,
                process: str = "solver", cat: str = "solve") -> None:
        """A sample on a counter track (rendered as a stacked area)."""
        self._events.append({
            "name": name, "ph": "C", "cat": cat, "ts": float(ts_us),
            "pid": self._pid(process), "tid": 0,
            "args": {k: float(v) for k, v in values.items()},
        })

    @contextlib.contextmanager
    def span(self, name: str, *, process: str = "solver",
             thread: str = "main", cat: str = "solve",
             args: Optional[Dict[str, Any]] = None):
        """Wrap a host-side region as a complete event."""
        t0 = now_us()
        try:
            yield self
        finally:
            self.complete(name, t0, now_us() - t0, process=process,
                          thread=thread, cat=cat, args=args)

    @property
    def event_count(self) -> int:
        return len(self._events)

    def to_dict(self) -> Dict[str, Any]:
        """The trace document, timestamps rebased to start at 0."""
        stamped = [e["ts"] for e in self._events if "ts" in e]
        base = min(stamped) if stamped else 0.0
        events = []
        for e in self._events:
            e = dict(e)
            if "ts" in e:
                e["ts"] = e["ts"] - base
            events.append(e)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        """Serialize to a Perfetto-loadable ``trace.json``."""
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)


# ---------------------------------------------------------------------------
# Program spans
# ---------------------------------------------------------------------------

_default = TraceWriter()
_installed: Optional[TraceWriter] = None
_ids = itertools.count(1)
_open = threading.local()           # .stack: the thread's open spans


class _Span:
    __slots__ = ("name", "id", "parent", "solve", "args", "t0")


def begin(name: str, args: Optional[Sequence[Tuple[str, Any]]] = None,
          solve: Optional[int] = None, opens_solve: bool = False):
    """Open the span ``name``: a token for ``end``, or None where nothing
    records (no profiler session, no writer installed). ``args`` are
    (key, value) pairs added to the span's ``args``; ``solve`` names the
    solve the span belongs to where it is not its parent's (``api.read``:
    the solve that made the ``Result``); ``opens_solve`` makes the span's
    own id its solve's (``api.solve``)."""
    if _installed is None and not _autograd_profiler._is_profiler_enabled:
        return None
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    tok = _Span()
    tok.name, tok.id, tok.args = name, next(_ids), args
    parent = stack[-1] if stack else None
    tok.parent = None if parent is None else parent.id
    if opens_solve:
        tok.solve = tok.id
    elif solve is None and parent is not None:
        tok.solve = parent.solve
    else:
        tok.solve = solve
    if not stack:
        _anchor()
    stack.append(tok)
    tok.t0 = now_us()
    return tok


def end(tok) -> None:
    """Close the span ``tok`` (``begin``'s token; None does nothing) and
    record it. Spans opened inside it and left open are dropped."""
    if tok is None:
        return
    dur = now_us() - tok.t0
    stack = getattr(_open, "stack", ())
    if tok in stack:
        del stack[stack.index(tok):]
    writer = _default if _installed is None else _installed
    args = {"id": tok.id, "parent": tok.parent, "solve": tok.solve}
    args.update(tok.args or ())
    writer.complete(tok.name, tok.t0, dur, process="repro_torch",
                    thread=threading.current_thread().name, cat=SPAN_CAT,
                    args=args)
    if writer is _default and len(writer._events) > 2 * SPAN_LIMIT:
        del writer._events[:-SPAN_LIMIT]    # read through ``spans`` alone


@contextlib.contextmanager
def recording(writer: TraceWriter):
    """Record the program's spans into ``writer`` inside the block, with or
    without a profiler session."""
    global _installed
    prev, _installed = _installed, writer
    try:
        yield writer
    finally:
        _installed = prev


def spans(writer: Optional[TraceWriter] = None) -> List[Dict[str, Any]]:
    """The program spans recorded in ``writer`` (by default where spans go
    now: the installed writer, else the default one), oldest first: the
    writer's complete events of category ``SPAN_CAT``, ``ts`` and ``dur``
    in microseconds on ``now_us``'s clock."""
    if writer is None:
        writer = _default if _installed is None else _installed
    return [e for e in writer._events if e.get("cat") == SPAN_CAT]


#: The first thread id of the span rows ``profiler_session`` adds: above
#: the system's thread ids, which kineto gives the host's rows.
_SPAN_ROW = 1 << 30


def _merge_spans(path: str, t0_us: float, t1_us: float) -> None:
    """Add the spans recorded in ``[t0_us, t1_us]`` to the profiler's
    Chrome trace at ``path``, in its time base (kineto writes each
    timestamp less ``baseTimeNanoseconds``), on a row of the process."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0) / 1e3
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    rows = set()
    for e in spans():
        if e["ts"] + e["dur"] < t0_us or e["ts"] > t1_us:
            continue
        tid = _SPAN_ROW + e["tid"]
        if tid not in rows:
            rows.add(tid)
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": "repro_torch spans"}})
        events.append(dict(e, ts=e["ts"] - base, pid=pid, tid=tid))
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def profiler_session(logdir: Optional[str]):
    """Optionally bracket a region with a ``torch.profiler`` trace.

    Yields True when a profiler session actually started (logdir given and
    the profiler cooperated), else False; a started session writes its
    Chrome trace to ``<logdir>/torch_trace.json`` when the region ends,
    with the program spans recorded in the region added on a row of their
    own. Never raises: the profiler is an observer, so a failure to start,
    stop or write is reported as a warning and the region runs
    unprofiled.
    """
    if not logdir:
        yield False
        return
    try:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        t0 = now_us()
        prof.start()
    except Exception as e:      # the observer must not stop the solve
        warnings.warn(f"profiler_session: torch.profiler did not start: {e}")
        yield False
        return
    try:
        yield True
    finally:
        try:
            prof.stop()
            t1 = now_us()
            os.makedirs(logdir, exist_ok=True)
            path = os.path.join(logdir, "torch_trace.json")
            prof.export_chrome_trace(path)
            _merge_spans(path, t0, t1)
        except Exception as e:  # as above
            warnings.warn(f"profiler_session: trace not written: {e}")
