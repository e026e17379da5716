"""Serving observability: latency spans, percentile histograms, counters
(the port's copy of ``repro.serving.metrics``).

The serving subsystem (``repro_torch.serving.scheduler``, the flush server
in ``repro_torch.launch.serve``, and the compile cache) reports everything
it does through one ``ServingMetrics`` object:

* **Spans** — latency samples in microseconds, named by what they cover:
  ``queue_us`` (submit -> admission), ``compile_us`` (getting a lane
  program from the compile cache, a build where it had none),
  ``dispatch_us`` (one batched device step, until it finished),
  ``solve_us`` (admission -> completion) and ``e2e_us`` (submit ->
  completion). Each span keeps a bounded reservoir of samples
  and reports count/mean/p50/p99.
* **Counters** — monotonic event counts: ``submitted`` / ``admitted`` /
  ``completed`` / ``failed`` requests, ``dispatches``, ``row_swaps``
  (a freed lane slot re-admitted a fresh request without restarting the
  program — the continuous-batching event), ``tail_ejections`` (a row
  left its lane to finish a sub-chunk remainder standalone),
  ``aot_hits`` / ``aot_misses`` / ``trace_events`` from the compile
  cache, and the batch-fill pair ``lane_slots`` / ``lane_active_slots``.

``batch_fill`` is derived (active / stepped slots — 1.0 means every
dispatched row was real work), and ``snapshot()`` renders the whole
thing as a JSON-able dict so a replica can export its serving state to
disk or over the wire (``dump()``).

Everything here is host-side bookkeeping: no torch, no device.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional


class LatencyStat:
    """One named latency span: bounded sample reservoir + percentiles.

    Samples beyond ``cap`` overwrite the reservoir round-robin (cheap,
    deterministic, keeps the percentile window recent-ish without a
    wall-clock dependency); ``count``/``total_us`` stay exact.
    """

    def __init__(self, cap: int = 4096):
        self.cap = cap
        self.count = 0
        self.total_us = 0.0
        self._samples: List[float] = []

    def add(self, us: float) -> None:
        us = float(us)
        if len(self._samples) < self.cap:
            self._samples.append(us)
        else:
            self._samples[self.count % self.cap] = us
        self.count += 1
        self.total_us += us

    @property
    def mean_us(self) -> float:
        return self.total_us / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the reservoir (0 when empty)."""
        if not self._samples:
            return 0.0
        s = sorted(self._samples)
        k = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
        return s[k]

    @property
    def p50_us(self) -> float:
        return self.percentile(50.0)

    @property
    def p99_us(self) -> float:
        return self.percentile(99.0)

    def snapshot(self) -> Dict[str, float]:
        return {"count": self.count, "mean_us": self.mean_us,
                "p50_us": self.p50_us, "p99_us": self.p99_us}


class ServingMetrics:
    """The serving layer's observability sink: spans + counters.

    One instance is shared by everything serving one replica (scheduler
    lanes, the flush server's ``ServeStats``, the compile cache), so a
    single ``snapshot()`` is the replica's whole serving state.
    """

    def __init__(self, span_cap: int = 4096):
        self._span_cap = span_cap
        self.spans: Dict[str, LatencyStat] = {}
        self.counters: Dict[str, float] = {}
        self.started_at = time.time()

    # -- spans -------------------------------------------------------------
    def span(self, name: str) -> LatencyStat:
        st = self.spans.get(name)
        if st is None:
            st = self.spans[name] = LatencyStat(self._span_cap)
        return st

    def observe(self, name: str, us: float) -> None:
        self.span(name).add(us)

    # -- counters ----------------------------------------------------------
    def inc(self, name: str, k: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + k

    def get(self, name: str) -> float:
        return self.counters.get(name, 0)

    # -- derived -----------------------------------------------------------
    @property
    def batch_fill(self) -> float:
        """Real (request-occupied) rows per dispatched lane slot. 1.0 is a
        perfectly packed scheduler; the flush server reports its own fill
        via ``ServeStats.batch_fill`` (real rows per dispatch)."""
        slots = self.get("lane_slots")
        return self.get("lane_active_slots") / slots if slots else 0.0

    def snapshot(self) -> dict:
        """The whole serving state as a JSON-able dict."""
        return {
            "uptime_s": time.time() - self.started_at,
            "counters": dict(sorted(self.counters.items())),
            "batch_fill": self.batch_fill,
            "spans": {k: v.snapshot()
                      for k, v in sorted(self.spans.items())},
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)
            f.write("\n")

    def prometheus(self, *, prefix: str = "repro",
                   kernel_counters=None) -> str:
        """This sink rendered as a Prometheus text exposition (0.0.4) —
        see ``repro_torch.telemetry.prometheus_text``. ``kernel_counters``
        optionally appends the in-kernel contention counts."""
        from ..telemetry import prometheus_text
        return prometheus_text(self.snapshot(), prefix=prefix,
                               kernel_counters=kernel_counters)

    def merge_from(self, other: Optional["ServingMetrics"]) -> None:
        """Fold another sink's counts in (e.g. a drained worker's)."""
        if other is None:
            return
        for k, v in other.counters.items():
            self.inc(k, v)
        for k, st in other.spans.items():
            mine = self.span(k)
            for s in st._samples:
                mine.add(s)
            # replayed reservoir may undercount; keep exact totals
            mine.count += st.count - len(st._samples)
            mine.total_us += st.total_us - sum(st._samples)
