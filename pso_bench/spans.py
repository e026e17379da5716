"""The program's spans over the traced window: what the per-layer readers
``host_ms.*``, ``wait_ms.read``, ``launches_per_solve.init``,
``device_ms.init`` and ``idle_pct.*`` read beside the device's trace.

The port records a span where a solve's work happens (``api.solve``,
``pso.init_swarm``, ``ops.pack``, ``ops.launch``, ``ops.unpack``,
``api.read``) while a ``torch.profiler`` session is active, on the clock
the profiler gives its events (Unix time in us). ``program_spans`` reads
them (``repro_torch.telemetry.trace.spans``); a program that records none
gives None, and every reader then returns None. Only the spans that
overlap the traced window, from the summary's first event to its last,
count, so that spans of another profiled region in the same process are
left out. Every figure is per solve, over ``summary["solves"]``.

A device operation is issued inside the span the host was innermost in
when it made the runtime call that issued it. The calls in ``ISSUING`` are
paired with the device operations in start order (the port runs on one
stream), a copy with a copy call, a memset with a memset call, a kernel
with a launch; where the profiler lost a record (seen once in about ten
traced windows: one operation fewer than calls), the pairing skips the
call or the operation left over at the next place where the kinds
disagree, so that only the few operations between the loss and that place
are paired one call off. The operations issued inside a span are counted
by their calls, which the loss of an operation's record does not change.
Each idle gap of the device is split over the innermost span covering
each part of it; what no span covers is the caller's. The gaps are on the
device's timestamps, which kineto maps onto the host's clock, and that
mapping drifts: on an H100 some traced windows hold device timestamps that
fall behind the host's at about 2.5 ms a second, from some point in the
window on (12.7 ms by the end of a 5 s window), while others hold none.
An operation that ends a gap and starts within ``ISSUED_IDLE_US`` of its
call was issued into an idle device, so on one clock it starts a few us
after the call: how far it starts before the call instead is how far the
device's clock lags there. Each gap is moved later by the lag the last
such operation up to the one ending it shows, 0 where it shows none
(``device_lags``), so a drift is followed as it grows and an operation
with an odd timestamp moves only the gaps up to the next such operation.
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Sequence

#: An operation that ends a gap and starts at most this long after its
#: call was issued into an idle device (launch latency is 6–10 us on an
#: H100; an operation queued behind a running one starts later).
ISSUED_IDLE_US = 50.0

#: The runtime calls that issue a device operation on the stream.
ISSUING = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cudaMemcpyAsync", "cudaMemcpy", "cudaMemsetAsync", "cudaMemset"))

Span = collections.namedtuple("Span", "name start end id parent solve")


def program_spans() -> Optional[List[dict]]:
    """The spans the port has recorded in this process, or None where it
    records none."""
    try:
        from repro_torch.telemetry.trace import spans
    except ImportError:
        return None
    return spans()


def layer(name: str) -> str:
    """The layer a span's name belongs to: ``facade`` (``api.solve``),
    ``init``, ``ops``, ``read`` (``api.read``), else ``other``."""
    if name == "api.solve":
        return "facade"
    if name == "pso.init_swarm":
        return "init"
    if name.startswith("ops."):
        return "ops"
    if name == "api.read":
        return "read"
    return "other"


def window(summary: dict, events: Optional[Sequence[dict]] = None
           ) -> Optional[List[Span]]:
    """The spans (``events``, by default ``program_spans()``) that overlap
    the traced window, in start order; None where the program records none,
    the summary holds no event or no solve completed."""
    events = program_spans() if events is None else events
    stamps = summary["ops"] + summary["host"]
    if events is None or not stamps or not summary["solves"]:
        return None
    lo = min(s for _, s, _ in stamps)
    hi = max(e for _, _, e in stamps)
    out = []
    for e in events:
        start, end = e["ts"], e["ts"] + e["dur"]
        if end >= lo and start <= hi:
            a = e["args"]
            out.append(Span(e["name"], start, end, a["id"], a["parent"],
                            a["solve"]))
    out.sort(key=lambda s: (s.start, -s.end))
    return out


def per_solve_ms(summary: dict, us: float) -> float:
    return us / 1e3 / summary["solves"]


def duration_ms(summary: dict, names: Sequence[str],
                events: Optional[Sequence[dict]] = None) -> Optional[float]:
    """The spans named ``names``' durations in the window, ms a solve."""
    spans = window(summary, events)
    if not spans:
        return None
    return per_solve_ms(summary, sum(s.end - s.start for s in spans
                                     if s.name in names))


def self_ms(summary: dict, name: str,
            events: Optional[Sequence[dict]] = None) -> Optional[float]:
    """The spans named ``name``'s self time in the window (each one's
    duration less its children's), ms a solve."""
    spans = window(summary, events)
    if not spans:
        return None
    children: Dict[int, float] = collections.defaultdict(float)
    for s in spans:
        if s.parent is not None:
            children[s.parent] += s.end - s.start
    return per_solve_ms(summary, sum(s.end - s.start - children[s.id]
                                     for s in spans if s.name == name))


def innermost(spans: Sequence[Span]):
    """The timeline as (start, end, span name) pieces in time order, each
    covered by one innermost span; gaps between them are covered by
    none."""
    pieces, stack, t = [], [], None
    for s in spans:
        while stack and stack[-1].end <= s.start:
            top = stack.pop()
            if top.end > t:
                pieces.append((t, top.end, top.name))
                t = top.end
        if stack and s.start > t:
            pieces.append((t, s.start, stack[-1].name))
        stack.append(s)
        t = s.start if t is None else max(t, s.start)
    while stack:
        top = stack.pop()
        if top.end > t:
            pieces.append((t, top.end, top.name))
            t = top.end
    return pieces


def _kind(name: str) -> str:
    """A call's or a device operation's kind: ``copy``, ``set`` or
    ``kernel``."""
    if name.startswith(("cudaMemcpy", "Memcpy")):
        return "copy"
    if name.startswith(("cudaMemset", "Memset")):
        return "set"
    return "kernel"


def issue_starts(summary: dict) -> List[Optional[float]]:
    """The start of the runtime call that issued each device operation, in
    the operations' order; None for an operation left over where the
    profiler lost a record (module docstring)."""
    calls = [(_kind(n), s) for n, s, _ in summary["host"] if n in ISSUING]
    ops = summary["ops"]
    out: List[Optional[float]] = [None] * len(ops)
    i = j = 0
    while i < len(ops) and j < len(calls):
        if _kind(ops[i][0]) == calls[j][0]:
            out[i] = calls[j][1]
            i, j = i + 1, j + 1
        elif len(calls) - j > len(ops) - i:
            j += 1                      # a call whose operation was lost
        else:
            i += 1                      # an operation whose call was lost
    return out


def device_lags(summary: dict) -> List[float]:
    """For each gap of ``summary["gaps"]``, how much later the device's
    timestamps belong on the host's clock there: how far the last
    operation up to the one ending the gap that ended a gap and started
    within ``ISSUED_IDLE_US`` of its call starts before that call; 0 before
    any such operation and where it starts after its call."""
    starts = issue_starts(summary)
    ops = summary["ops"]
    lags, lag = [], 0.0
    for _, _, i in summary["gaps"]:
        t = starts[i]
        if t is not None and ops[i][1] - t <= ISSUED_IDLE_US:
            lag = max(0.0, t - ops[i][1])
        lags.append(lag)
    return lags


def _span_at(pieces, starts, t: Optional[float]) -> str:
    """The innermost span's name at host time ``t`` (``""`` where none)."""
    if t is None:
        return ""
    i = bisect.bisect_right(starts, t) - 1
    return pieces[i][2] if i >= 0 and t < pieces[i][1] else ""


def issued(summary: dict, events: Optional[Sequence[dict]] = None
           ) -> Optional[List[str]]:
    """The name of the innermost span each device operation of the window
    was issued in (``""`` where none), in the operations' order; None
    without spans or device operations."""
    spans = window(summary, events)
    if not spans or not summary["ops"]:
        return None
    pieces = innermost(spans)
    starts = [p[0] for p in pieces]
    return [_span_at(pieces, starts, t) for t in issue_starts(summary)]


def issued_in(summary: dict, name: str,
              events: Optional[Sequence[dict]] = None):
    """(the device operations issued inside the span ``name``, counted by
    their calls, and their device us), or None without spans or device
    operations."""
    spans = window(summary, events)
    if not spans or not summary["ops"]:
        return None
    pieces = innermost(spans)
    starts = [p[0] for p in pieces]
    count = sum(_span_at(pieces, starts, s) == name
                for n, s, _ in summary["host"] if n in ISSUING)
    return count, sum(e - s for (_, s, e), t in zip(summary["ops"],
                                                     issue_starts(summary))
                      if _span_at(pieces, starts, t) == name)


def idle_us(summary: dict, events: Optional[Sequence[dict]] = None
            ) -> Optional[Dict[str, float]]:
    """The device's idle gaps, moved onto the host's clock
    (``device_lags``), split by the layer (``layer``) of the innermost
    span covering each part, in us; ``caller`` where no span covers it.
    None without spans or device operations."""
    spans = window(summary, events)
    if not spans or not summary["ops"]:
        return None
    out = dict.fromkeys(("facade", "init", "ops", "read", "other",
                         "caller"), 0.0)
    pieces = innermost(spans)
    ends = [p[1] for p in pieces]
    for (a, b, _), lag in zip(summary["gaps"], device_lags(summary)):
        a, b = a + lag, b + lag
        covered = 0.0
        k = bisect.bisect_right(ends, a)
        while k < len(pieces) and pieces[k][0] < b:
            part = min(b, pieces[k][1]) - max(a, pieces[k][0])
            if part > 0:
                out[layer(pieces[k][2])] += part
                covered += part
            k += 1
        out["caller"] += (b - a) - covered
    return out


def idle_pct(summary: dict, which: str,
             events: Optional[Sequence[dict]] = None) -> Optional[float]:
    """The share of the window, in %, the device sat idle while the
    host's innermost span was of the layer ``which``."""
    parts = idle_us(summary, events)
    if parts is None or summary["window_s"] <= 0:
        return None
    return 100.0 * parts[which] / 1e6 / summary["window_s"]
