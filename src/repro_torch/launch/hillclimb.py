"""Per-cell perf hillclimbing, the port of ``repro.launch.hillclimb``.

Re-runs ONE cell's piecewise roofline (one card, meta device) with
ArchConfig overrides and prints the before/after of its terms against
the baseline in the dry run's JSON (``launch.dryrun``):

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \
        --arch stablelm-3b --shape train_4k \
        --set remat=dots --set flash_custom_vjp=True \
        --tag dots_vjp --out build/hillclimb.json

``--full`` also traces the whole step on the meta device
(``piecewise.analyze_cell_whole``) for ``mem_temp_gb``: the peak of its
live bytes, op by op, where the piecewise estimate composes one layer's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional, Sequence

from ..configs import SHAPES, get_arch
from ..models import zoo
from ..roofline import analysis as ra
from ..roofline.piecewise import analyze_cell_piecewise, analyze_cell_whole
from .dryrun import CHIPS, DEFAULT_OUT, MESH_NAME


def parse_val(v: str):
    if v in ("True", "False"):
        return v == "True"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def run(arch: str, shape: str, overrides: dict, full: bool = False):
    cfg = get_arch(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = SHAPES[shape]
    mem_temp_gb = None
    if full:
        mem_temp_gb = analyze_cell_whole(cfg, shape)["peak_bytes"] / 1e9
    pw = analyze_cell_piecewise(cfg, shape)
    tokens = (cell.global_batch if cell.kind == "decode"
              else cell.seq_len * cell.global_batch)
    res = ra.analyze(arch, shape, MESH_NAME, CHIPS, pw, cfg,
                     zoo.abstract_params(cfg), cell.kind, tokens).to_dict()
    res.update(overrides=overrides, mem_temp_gb=mem_temp_gb,
               mem_temp_gb_piecewise=pw["mem_temp_dev"] / 1e9,
               pieces=pw["pieces"])
    return res


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--set", action="append", default=[],
                    metavar="FIELD=VALUE")
    ap.add_argument("--tag", default="exp")
    ap.add_argument("--out", default=os.path.join("build", "hillclimb.json"))
    ap.add_argument("--baseline", default=DEFAULT_OUT)
    ap.add_argument("--full", action="store_true",
                    help="also trace the whole step for its peak memory")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parser().parse_args(argv)
    overrides = {}
    for kv in getattr(args, "set"):
        k, v = kv.split("=", 1)
        overrides[k] = parse_val(v)

    res = run(args.arch, args.shape, overrides, full=args.full)

    # compare vs baseline
    base = {}
    if os.path.exists(args.baseline):
        with open(args.baseline) as f:
            b = json.load(f)
        base = b.get(f"{args.arch}|{args.shape}|{MESH_NAME}", {})
    print(f"\n=== {args.arch} | {args.shape} | {args.tag} ===")
    hdr = f"{'term':13s} {'baseline':>12s} {'this':>12s} {'delta':>8s}"
    print(hdr)
    for term in ("t_compute", "t_memory", "t_collective",
                 "roofline_fraction", "useful_ratio"):
        b0 = base.get(term)
        v = res[term]
        if b0:
            print(f"{term:13s} {b0:12.4f} {v:12.4f} {v/b0-1:+8.1%}")
        else:
            print(f"{term:13s} {'—':>12s} {v:12.4f}")
    print(f"bottleneck: {base.get('bottleneck', '—')} -> {res['bottleneck']}")
    if res.get("mem_temp_gb") is not None:
        print(f"mem_temp_gb: {base.get('mem_temp_gb', float('nan')):.1f}"
              f" -> {res['mem_temp_gb']:.1f} (whole step; piecewise "
              f"{res['mem_temp_gb_piecewise']:.1f})")

    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    results[f"{args.arch}|{args.shape}|{args.tag}"] = res
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
