"""``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each is a JSON file, ``configs/<config>.json`` and ``traffic/<traffic>.json``,
and the cell's correctness limits are ``limits/<cell>.json``, one number
(``numbers/<name>.py``) a key. The objective is ``objectives/<name>.py``
(the traffic's ``objective``, else the configuration's), the reference's
semantics of the traffic's variant ``variants/<variant>.py``. A per-layer
metric is ``metrics/<name>.py`` with ``read(summary)``; a kernel's cost is
``costs/<kernel>.py`` with ``cost(launch)`` and ``launches(call)``. Nothing
here needs editing when a cell, a metric, a number or a kernel cost is
added.
"""
from __future__ import annotations

import collections
import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Callable, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

#: A name: a letter, digit or ``_`` first, then at most 63 letters, digits,
#: ``_``, ``.`` and ``-``.
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
#: A unit: 1 to 16 letters, digits, ``_``, ``/``, ``%``, ``.`` and ``-``.
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((BENCH_DIR / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` under the benchmark, loaded by path
    once a process (a name may hold dots)."""
    key = f"pso_bench_{kind}_" + re.sub(r"\W", "_", name)
    mod = sys.modules.get(key)
    if mod is None:
        path = BENCH_DIR / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(key, path)
        if spec is None:
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


def load_cost(kernel: str) -> Callable[[dict], dict]:
    return load_module("costs", kernel).cost


def load_reader(metric: str) -> Callable[[dict], Optional[float]]:
    return load_module("metrics", metric).read


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def objective(self) -> str:
        """The objective's name: the traffic's where it names one, else the
        configuration's."""
        return self.traffic.get("objective", self.config["objective"])


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def find_cell(bench: dict, name: str) -> Cell:
    """The cell ``name`` of ``bench``: its configuration, traffic and
    limits, and the metrics it reports. ``KeyError`` for an unknown
    name."""
    return cell_of(bench, {w["name"]: w for w in bench["workloads"]}[name])


def cell_of(bench: dict, entry: dict) -> Cell:
    """The cell of a ``workloads`` entry, with the metrics of ``bench``
    that it reports."""
    name = entry["name"]
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=load_json("configs", entry["config"]),
        traffic=load_json("traffic", entry["traffic"]),
        limits=load_json("limits", name),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def problems(bench: dict) -> List[str]:
    """What in ``bench`` breaks the contract's names, units and files:
    one line each (empty when sound)."""
    out: List[str] = []
    metrics = bench["end_to_end"] + bench["per_layer"]
    for group, entries in (("configs", bench["configs"]),
                           ("workloads", bench["workloads"]),
                           ("metrics", metrics)):
        seen = collections.Counter(e["name"] for e in entries)
        out += [f"{group}: {n} named twice" for n, k in seen.items() if k > 1]
        for e in entries:
            for key in ("name", "config", "traffic"):
                if key in e and not NAME.match(str(e[key])):
                    out.append(f"{group}: bad {key} {e[key]!r}")
            out += [f"{group}: bad reduced key {k!r}"
                    for k in e.get("reduced", []) if not NAME.match(k)]
            if "unit" in e and not UNIT.match(e["unit"]):
                out.append(f"{group}: bad unit {e['unit']!r}")
    out += [f"config file {c['file']} missing" for c in bench["configs"]
            if not (ROOT / c["file"]).is_file()]
    for w in bench["workloads"]:
        for kind, name in (("configs", w["config"]), ("traffic", w["traffic"]),
                           ("limits", w["name"])):
            if not (BENCH_DIR / kind / f"{name}.json").is_file():
                out.append(f"{w['name']}: {kind}/{name}.json missing")
    out += [f"metrics/{m['name']}.py missing" for m in bench["per_layer"]
            if not (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()]
    for w in bench["workloads"]:
        if any(f.startswith(f"{w['name']}:") for f in out):
            continue
        c = cell_of(bench, w)
        for kind, name in [("objectives", c.objective),
                           ("variants", c.traffic["variant"])] + [
                ("numbers", k) for k in c.limits]:
            if not (BENCH_DIR / kind / f"{name}.py").is_file():
                out.append(f"{w['name']}: {kind}/{name}.py missing")
    return out
