"""One run of one cell: set-up, the measured window, the traced window's
summary, and the check of the sampled solves against the reference.

``run_cell`` does the work for ``run.py`` and for the CPU tests, which hand
it a cell at a small size and ``device="cpu"``. It returns the result's
line as a dict and the check's lines for standard error.
"""
from __future__ import annotations

import gc
import random
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from pso_bench import check, trace
from pso_bench.spec import Cell, load_reader
from pso_bench.workload import Workload

#: Top-level module names that may not be loaded when the window closes:
#: JAX, its libraries, the JAX package the port was made from, and its
#: benchmark harness.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules(modules) -> List[str]:
    """The names in ``modules`` whose top-level name (before the first
    dot) is one of ``FORBIDDEN``, compared whole."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


class Reservoir:
    """A uniform sample of ``k`` of the window's solves, drawn from the
    run's seed; it keeps each sampled solve's ``Result``."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, random.Random(seed)
        self.items: List[Tuple[int, object]] = []
        self.seen = 0

    def offer(self, seed: int, result) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((seed, result))
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = (seed, result)


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def _window(wl: Workload, seed: int, seconds: float, keep: Reservoir):
    """The closed loop: solve after solve, each from the next seed, until
    ``seconds`` have passed at the end of one. Returns (wall times of the
    solves, solves attempted, solves failed, the window's seconds)."""
    times: List[float] = []
    attempted = failed = 0
    start = end = time.perf_counter()
    while end - start < seconds:
        t0 = time.perf_counter()
        try:
            res = wl.solve(seed + attempted)
            _ = res.best_fit, res.best_pos   # read on the host, as a user does
        except RuntimeError as err:          # a solve the program refused
            failed += 1
            res = None
            print(f"solve {seed + attempted} failed: {err}",
                  file=sys.stderr)
        end = time.perf_counter()
        times.append(end - t0)
        if res is not None:
            keep.offer(seed + attempted, res)
        attempted += 1
    return times, attempted, failed, end - start


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             t0: float, device: str = "cuda", dtype: Optional[str] = None,
             marks: Optional[Dict[str, float]] = None
             ) -> Tuple[dict, List[str]]:
    """One run of ``cell``; ``t0`` is the process's start on
    ``time.perf_counter``'s clock, ``marks`` the set-up's stages the
    caller timed before (stage to its end on that clock). ``dtype`` runs
    the swarm in another precision than the configuration's (the
    control)."""
    import torch
    cuda = device.startswith("cuda")
    marks = dict(marks or {})
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=device)             # the CUDA context
        marks["context"] = time.perf_counter()
    wl = Workload(cell, device=device, dtype=dtype)
    wl.solve(seed - 1).best_fit                   # warm the cell's shape
    _sync(device)
    marks["warm_solve"] = time.perf_counter()
    keep = Reservoir(int(cell.traffic["check_solves"]), seed)
    setup_s = time.perf_counter() - t0
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
        with profile(activities=acts) as prof:
            times, attempted, failed, window = _window(wl, seed, seconds,
                                                       keep)
    else:
        times, attempted, failed, window = _window(wl, seed, seconds, keep)
    done = attempted - failed
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
           if cuda else 0}
    out = {"correct": False, "attempted": attempted, "failed": failed}
    if traced:
        summary = trace.summarize(prof, done, window, wl.call)
        del prof
        if summary["busy_s"] <= 0 and cuda:
            raise RuntimeError("the trace shows no device time")
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        metrics = {}
        for m in cell.per_layer:
            v = load_reader(m["name"])(summary)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["breakdown"] = trace.breakdown(summary)
        del summary
    else:
        metrics = {
            "solve_ms": {"value": 1e3 * window / max(done, 1), "unit": "ms"},
            "solve_ms_p95": {"value": 1e3 * float(np.percentile(times, 95)),
                             "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {m["name"]: metrics[m["name"]] for m in cell.end_to_end}
    samples = [check.sample_of(s, r) for s, r in keep.items]
    keep.items.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    values = check.run_check(wl, samples, device)
    report = check.report(values, cell.limits)
    stages, last = [], t0
    for k, t in marks.items():
        stages.append(f"{k} {t - last:.3f}")
        last = t
    lines = [f"setup_s {setup_s:.3f}: " + ", ".join(stages)] + [
        f"check {k} {v['value']!r} limit {v['limit']!r}"
        for k, v in report.items()]
    out.update(correct=bool(done and not failed
                            and check.verdict(values, cell.limits)),
               metrics=metrics, device=dev, check=report)
    return out, lines
