"""Render the dry run's tables from its JSON, the port of
``repro.roofline.report``:

    PYTHONPATH=src python -m repro_torch.roofline.report build/dryrun.json

The roofline table keeps the one-card cells (``|1xH100``), at H100 rates
(``analysis``).
"""
from __future__ import annotations

import json
import sys
from typing import Dict

from ..launch.dryrun import DEFAULT_OUT, MESH_NAME


def fmt_s(x):
    if x is None:
        return "—"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}µs"


def dryrun_table(results: Dict) -> str:
    rows = ["| cell | mesh | status | flops/dev | bytes/dev | "
            "coll GB/chip | mem/dev (arg+tmp) GB | fits | trace s |",
            "|---|---|---|---|---|---|---|---|---|"]
    for key in sorted(results):
        r = results[key]
        arch_shape = "|".join(key.split("|")[:2])
        mesh = key.split("|")[2]
        if r.get("status") == "skip":
            rows.append(f"| {arch_shape} | {mesh} | skip | | | | | | |")
            continue
        if r.get("status") != "ok":
            rows.append(f"| {arch_shape} | {mesh} | **FAIL** | | | | | | |")
            continue
        chips = r.get("chips", 1)
        mem = r.get("mem_argument_gb", 0) + r.get("mem_temp_gb", 0)
        fits = {True: "yes", False: "no"}.get(r.get("fits"), "—")
        rows.append(
            f"| {arch_shape} | {mesh} | ok "
            f"| {r['flops_total']/chips:.2e} "
            f"| {r['bytes_total']/chips:.2e} "
            f"| {r['coll_bytes_per_chip']/1e9:.2f} "
            f"| {mem:.1f} | {fits} "
            f"| {r.get('t_trace_s', 0):.1f} |")
    return "\n".join(rows)


def roofline_table(results: Dict) -> str:
    rows = ["| arch | shape | t_compute | t_memory | t_collective | "
            "bottleneck | MODEL_FLOPS | useful ratio | roofline frac |",
            "|---|---|---|---|---|---|---|---|---|"]
    for key in sorted(results):
        r = results[key]
        if r.get("status") != "ok" or not key.endswith("|" + MESH_NAME) \
                or "pieces" not in r:
            continue
        arch, shape, _ = key.split("|")
        rows.append(
            f"| {arch} | {shape} | {fmt_s(r['t_compute'])} "
            f"| {fmt_s(r['t_memory'])} | {fmt_s(r['t_collective'])} "
            f"| **{r['bottleneck']}** | {r['model_flops']:.2e} "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.3f} |")
    return "\n".join(rows)


def summary(results: Dict) -> str:
    ok = sum(1 for v in results.values() if v.get("status") == "ok")
    skip = sum(1 for v in results.values() if v.get("status") == "skip")
    fail = sum(1 for v in results.values() if v.get("status") == "fail")
    return f"{ok} traced ok, {skip} defined-skips, {fail} failures"


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else DEFAULT_OUT
    with open(path) as f:
        results = json.load(f)
    print("## Summary\n")
    print(summary(results) + "\n")
    print("## Dry-run table\n")
    print(dryrun_table(results) + "\n")
    print(f"## Roofline table (one card, {MESH_NAME})\n")
    print(roofline_table(results))


if __name__ == "__main__":
    main()
