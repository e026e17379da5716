"""The traced window: ``torch.profiler`` with the device's activity alone
(kernels, copies and memsets, and the CUDA runtime calls that issued them),
with no per-operator host events and no host spans, so that the profiler
adds as little as it can to the host's share of a solve. It is reduced to
the summary that the per-layer readers (``metrics/*.py``) take and to the
result's ``breakdown``.

The summary holds the window's length on the host's clock, the device's
busy time (the union of the intervals in which a device operation ran), the
device operations in order (``ops``: name, start and end in us), the
idle gaps between them, the runtime calls in order (``host``), the solves
completed, and the call's sizes (``call``), from which a kernel's cost file
plans one solve's launches.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

from pso_bench import peaks
from pso_bench.spec import load_module


def kernel_name(name: str) -> str:
    """A device operation's short name: a kernel's identifier without its
    return type, template arguments and parameters; a copy or memset as
    the trace names it."""
    bare = name.replace("(anonymous namespace)::", "")
    m = re.match(r"(?:void\s+)?([A-Za-z_][\w:]*)\s*[<(]", bare)
    return m.group(1).split("::")[-1] if m else name


def _events(prof):
    """(device ops, host events) of a finished profile, each a list of
    (name, start us, end us) in start order, in the profiler's one
    clock."""
    import torch
    dev, host = [], []
    cpu = torch.autograd.DeviceType.CPU
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        item = (e.name(), start, start + e.duration_ns() / 1e3)
        (host if e.device_type() == cpu else dev).append(item)
    dev.sort(key=lambda x: x[1])
    host.sort(key=lambda x: x[1])
    return dev, host


def _union(ops: Sequence[Tuple[str, float, float]]):
    """(busy us, the idle gaps [(start, end, index of the op after it)])
    of ``ops`` in start order, from the first op's start to the last
    op's end."""
    busy, gaps, edge = 0.0, [], None
    for i, (_, s, e) in enumerate(ops):
        if edge is not None and s > edge:
            gaps.append((edge, s, i))
        if edge is None or e > edge:
            busy += e - (s if edge is None else max(s, edge))
            edge = e
    return busy, gaps


def summarize(prof, solves: int, window_s: float, call: dict) -> dict:
    """The traced window of ``window_s`` seconds on the host's clock, in
    which ``solves`` solves of ``call`` (``Workload.call``) completed."""
    ops, host = _events(prof)
    busy, gaps = _union(ops)
    return {"window_s": window_s, "busy_s": busy / 1e6, "solves": solves,
            "ops": ops, "gaps": gaps, "host": host, "call": call}


def roofline_pct(summary: dict, kernel: str) -> Optional[float]:
    """The counted bound of ``kernel``'s launches (``costs/<kernel>.py``,
    planned from the call's sizes) over their device time, in %: None
    where the trace holds none, or not the planned number of them."""
    times = [e - s for n, s, e in summary["ops"] if kernel_name(n) == kernel]
    if not times:
        return None
    cost = load_module("costs", kernel)
    plan = cost.launches(summary["call"])
    if len(times) != len(plan) * summary["solves"]:
        return None
    bound_ms = sum(peaks.bound_ms(cost.cost(launch)) for launch in plan)
    return 100.0 * bound_ms * summary["solves"] * 1e3 / sum(times)


def _host_at(t: float, host) -> str:
    """The runtime call the host was in at ``t``, or ``python`` where it
    was in none (the harness's or the program's own host code)."""
    inside = [(s, n) for n, s, e in host if s <= t < e]
    return max(inside)[1] if inside else "python"


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time (by short name) and the
    longest idle gaps, each named by what the host was doing in its middle
    and by the device operations on either side of it."""
    by_name: Dict[str, float] = {}
    for n, s, e in summary["ops"]:
        k = kernel_name(n)
        by_name[k] = by_name.get(k, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(summary["gaps"], key=lambda g: g[0] - g[1])[:top]
    names = [kernel_name(n) for n, _, _ in summary["ops"]]
    gaps = [[f"{_host_at((s + e) / 2, summary['host'])}: "
             f"{names[i - 1]} > {names[i]}", (e - s) / 1e6]
            for s, e, i in longest]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": gaps}
