"""Chrome trace-event (Perfetto-loadable) writer for solver timelines, the
port of ``repro.telemetry.trace``.

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
  ``time.perf_counter`` stamps.

Timestamps are microseconds on any monotonic base; ``to_dict()`` rebases
them to zero so the timeline starts at t=0 regardless of the clock.

``profiler_session(logdir)`` optionally brackets a region with a
``torch.profiler`` trace (the card's kernels alongside the host's
operators), written to ``<logdir>/torch_trace.json``; it degrades to a
no-op when the profiler cannot start, so callers never gate on it.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from typing import Any, Dict, List, Optional

import torch


def _now_us() -> float:
    return time.perf_counter() * 1e6


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
        t0 = _now_us()
        try:
            yield self
        finally:
            self.complete(name, t0, _now_us() - t0, process=process,
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


@contextlib.contextmanager
def profiler_session(logdir: Optional[str]):
    """Optionally bracket a region with a ``torch.profiler`` trace.

    Yields True when a profiler session actually started (logdir given and
    the profiler cooperated), else False; a started session writes its
    Chrome trace to ``<logdir>/torch_trace.json`` when the region ends.
    Never raises: the profiler is an observer, so a failure to start, stop
    or write is reported as a warning and the region runs unprofiled.
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
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(logdir, "torch_trace.json"))
        except Exception as e:  # as above
            warnings.warn(f"profiler_session: trace not written: {e}")
