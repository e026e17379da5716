"""Prometheus text-exposition renderer for solver metrics, the port of
``repro.telemetry.prometheus`` (the same names and output).

Renders a ``ServingMetrics.snapshot()`` dict (and optionally kernel
counters) in the Prometheus text format (version 0.0.4): ``# HELP`` /
``# TYPE`` preambles, counters suffixed ``_total``, latency spans as
summaries with ``quantile`` labels plus ``_sum``/``_count``. Pure string
assembly over the snapshot — no client library, no registry, so a
``/metrics`` endpoint (or the CLI's ``--metrics-out``) is one call.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(name: str) -> str:
    n = _NAME_RE.sub("_", name)
    if not n or n[0].isdigit():
        n = "_" + n
    return n


def prometheus_text(snapshot: Dict[str, Any], *, prefix: str = "repro",
                    kernel_counters: Optional[Dict[str, int]] = None
                    ) -> str:
    """Render a metrics snapshot as a Prometheus exposition document.

    ``snapshot`` is ``ServingMetrics.snapshot()`` (``uptime_s`` /
    ``counters`` / ``batch_fill`` / ``spans``); extra keys (the
    scheduler's ``lanes`` list etc.) are ignored. ``kernel_counters``
    optionally adds the in-kernel contention counts
    (``repro_torch.telemetry.KernelCounters.as_dict()``) as
    ``<prefix>_kernel_<name>_total``.
    """
    out: List[str] = []

    def emit(name: str, kind: str, help_: str, samples) -> None:
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} {kind}")
        for labels, value in samples:
            lab = ("{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"
                   if labels else "")
            out.append(f"{name}{lab} {value:g}")

    if "uptime_s" in snapshot:
        emit(f"{prefix}_uptime_seconds", "gauge",
             "Seconds since the metrics sink was created.",
             [((), float(snapshot["uptime_s"]))])
    for cname in sorted(snapshot.get("counters", {})):
        emit(f"{prefix}_{_metric_name(cname)}_total", "counter",
             f"Monotonic count of {cname} events.",
             [((), float(snapshot["counters"][cname]))])
    if snapshot.get("batch_fill") is not None:
        emit(f"{prefix}_batch_fill", "gauge",
             "Mean fraction of lane slots running real rows.",
             [((), float(snapshot["batch_fill"]))])
    spans = snapshot.get("spans", {})
    if spans:
        name = f"{prefix}_span_latency_microseconds"
        samples = []
        for sname in sorted(spans):
            s = spans[sname]
            lab = ("span", _metric_name(sname))
            samples.append(((lab, ("quantile", "0.5")), float(s["p50_us"])))
            samples.append(((lab, ("quantile", "0.99")), float(s["p99_us"])))
        emit(name, "summary",
             "Host-side span latencies (reservoir-sampled).", samples)
        for sname in sorted(spans):
            s = spans[sname]
            lab = f'{{span="{_metric_name(sname)}"}}'
            out.append(f"{name}_sum{lab} "
                       f"{float(s['mean_us']) * s['count']:g}")
            out.append(f"{name}_count{lab} {s['count']:g}")
    for cname in sorted(kernel_counters or {}):
        emit(f"{prefix}_kernel_{_metric_name(cname)}_total", "counter",
             f"In-kernel {cname} events (see docs/observability.md).",
             [((), float(kernel_counters[cname]))])
    return "\n".join(out) + "\n"
