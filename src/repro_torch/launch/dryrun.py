"""One-card dry run, the port of ``repro.launch.dryrun``: size every
(arch × shape) cell for one H100 and put its roofline terms beside it.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch all --shape all --out build/dryrun.json

The reference fakes 512 CPU devices and compiles each cell for a TPU
pod. The port's mesh is one card (key ``"{arch}|{shape}|1xH100"``,
``chips=1``): each cell is traced piece by piece on the meta device
(``roofline.piecewise``), which allocates nothing and launches nothing on
the card, so the dry run runs on the host. Each cell records the
piecewise roofline at H100 rates, the parameter counts, the argument
memory (params, optimizer state, and batch or cache: exact, from the meta
trees), the temporary memory (the pieces' live bytes, scaled as the plan
scales: ``piecewise``'s docstring) and whether the two together fit the
card's memory (``torch.cuda.get_device_properties(0).total_memory``, or
80 GiB with no card present; ``capacity_from`` says which).

Each cell is saved into ``--out`` as it finishes, so reruns resume;
``status`` is ok, skip (the reference's: long_500k for archs that are not
sub-quadratic) or fail. ``--pso`` adds the PSO rows (cubic, d=1 and
d=120 at 2^20 particles, 100 iterations of the queue kernel) from
``roofline.pso_cost.iteration_cost``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Optional, Sequence

import torch

from ..configs import SHAPES, get_arch, list_archs
from ..models import zoo
from ..optim import get_optimizer
from ..optim.optimizers import tree_leaves
from ..roofline import analysis as ra
from ..roofline.piecewise import analyze_cell_piecewise

MESH_NAME = "1xH100"
CHIPS = 1
DEFAULT_OUT = os.path.join("build", "dryrun.json")
#: The card's memory when no card is present (an H100 80GB).
ASSUMED_CAPACITY = 80 * 2 ** 30


def capacity():
    """(bytes of the card's memory, where the number comes from)."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return props.total_memory, f"cuda:0 {props.name}"
    return ASSUMED_CAPACITY, "assumed 80 GiB (no card present)"


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _spec_bytes(specs) -> int:
    return sum(math.prod(s.shape) * s.dtype.itemsize
               for s in specs.values())


def run_cell(arch_name: str, shape_name: str, verbose: bool = True) -> dict:
    """One cell's record."""
    cfg = get_arch(arch_name)
    cell = SHAPES[shape_name]
    t0 = time.time()
    params_shape = zoo.abstract_params(cfg)
    arg = _nbytes(params_shape)
    specs = zoo.input_specs(cfg, shape_name)
    if cell.kind == "train":
        arg += _nbytes(get_optimizer(cfg.optimizer)[0](params_shape))
        arg += _spec_bytes(specs)
        kind, tokens = "train", cell.seq_len * cell.global_batch
    elif cell.kind == "prefill":
        arg += _spec_bytes(specs)
        kind, tokens = "prefill", cell.seq_len * cell.global_batch
    else:
        arg += _nbytes(zoo.abstract_cache(cfg, shape_name))
        arg += _spec_bytes(specs)
        kind, tokens = "decode", cell.global_batch
    pw = analyze_cell_piecewise(cfg, shape_name)
    temp = pw["mem_temp_dev"]
    cap, cap_from = capacity()
    pw["mem_dev"] = float(arg + temp)
    roof = ra.analyze(arch_name, shape_name, MESH_NAME, CHIPS, pw, cfg,
                      params_shape, kind, tokens)
    result = roof.to_dict()
    result["pieces"] = pw["pieces"]
    result.update(
        status="ok", t_trace_s=round(time.time() - t0, 2),
        transcendentals_total=pw["transc_dev"] * CHIPS,
        mem_argument_gb=arg / 1e9, mem_temp_gb=temp / 1e9,
        fits=bool(arg + temp <= cap), capacity_gb=cap / 1e9,
        capacity_from=cap_from,
        params_total=ra.count_params(params_shape),
        params_active=ra.count_active_params(cfg, params_shape))
    if verbose:
        print(f"  memory: arg={result['mem_argument_gb']:.2f}GB "
              f"temp={result['mem_temp_gb']:.2f}GB fits={result['fits']} "
              f"({cap / 1e9:.1f} GB, {cap_from})")
        print(f"  counts: flops={roof.flops_total:.3e} "
              f"bytes={roof.bytes_total:.3e} t_compute="
              f"{roof.t_compute:.4g}s t_memory={roof.t_memory:.4g}s "
              f"({roof.bottleneck})")
    return result


def run_pso_cell(dim: int, particles: int, iters: int = 100) -> dict:
    """Bonus rows: the paper's own workload (cubic) on the card, ``iters``
    iterations of the queue kernel priced by ``pso_cost``."""
    from ..core import pso
    from ..roofline import pso_cost
    cfg = pso.PSOConfig(dim=dim, particle_cnt=particles,
                        fitness="cubic").resolved()
    c = pso_cost.iteration_cost("queue", "cubic", dim, particles,
                                backend="kernel")
    state = pso.init_swarm(cfg, 0, device="meta")
    arg = _nbytes([getattr(state, f) for f in state._fields
                   if isinstance(getattr(state, f), torch.Tensor)])
    flops, nbytes = c.flops * iters, c.bytes_hbm * iters
    cap, cap_from = capacity()
    return {
        "arch": f"pso-cubic-{dim}d", "shape": f"n{particles}",
        "mesh": MESH_NAME, "chips": CHIPS, "status": "ok",
        "flops_total": flops, "bytes_total": nbytes,
        "transcendentals_total": c.transcendentals * iters,
        "coll_bytes_per_chip": 0.0, "coll_count": 0,
        # 100 iters × N × (~10 flops/dim update + fitness ~5/dim)
        "model_flops": iters * particles * dim * 15.0,
        "mem_argument_gb": arg / 1e9, "mem_temp_gb": 0.0,
        "fits": bool(arg <= cap), "capacity_from": cap_from,
        "t_compute": flops / ra.PEAK_FLOPS,
        "t_memory": nbytes / ra.HBM_BW, "t_collective": 0.0,
    }


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--pso", action="store_true",
                    help="also run the PSO bonus rows")
    ap.add_argument("--force", action="store_true")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parser().parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            results = json.load(f)

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]

    def save():
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, sort_keys=True)

    for arch in archs:
        cfg = get_arch(arch)
        for shape in shapes:
            key = f"{arch}|{shape}|{MESH_NAME}"
            if key in results and results[key].get("status") in ("ok",
                                                                  "skip"):
                continue
            if not cfg.supports(shape):
                results[key] = {
                    "status": "skip",
                    "reason": "full-attention arch; long_500k is defined "
                              "for sub-quadratic archs only"}
                save()
                continue
            print(f"[dryrun] {key} ...", flush=True)
            try:
                results[key] = run_cell(arch, shape)
                print(f"[dryrun] {key} OK "
                      f"(trace {results[key]['t_trace_s']}s)", flush=True)
            except Exception as e:
                results[key] = {"status": "fail", "error": str(e)[:2000],
                                "traceback": traceback.format_exc()[-4000:]}
                print(f"[dryrun] {key} FAIL: {e}", flush=True)
            save()

    if args.pso:
        for dim, n in ((1, 1 << 20), (120, 1 << 20)):
            key = f"pso-cubic-{dim}d|n{n}|{MESH_NAME}"
            if key in results and not args.force:
                continue
            print(f"[dryrun] {key} ...", flush=True)
            try:
                results[key] = run_pso_cell(dim, n)
                print(f"[dryrun] {key} OK", flush=True)
            except Exception as e:
                results[key] = {"status": "fail", "error": str(e)[:2000]}
                print(f"[dryrun] {key} FAIL: {e}", flush=True)
            save()

    ok = sum(1 for v in results.values() if v.get("status") == "ok")
    skip = sum(1 for v in results.values() if v.get("status") == "skip")
    fail = sum(1 for v in results.values() if v.get("status") == "fail")
    print(f"[dryrun] done: {ok} ok, {skip} skip, {fail} fail")
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
