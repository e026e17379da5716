"""The readings that the correctness limits are set from, at a cell's own
size, each through ``check.compare`` against the float32 reference:

* ``sound``: the program's solves through the timed call, a dozen seeds or
  more;
* ``control``: the same solves with the swarm in bfloat16, the program's
  own lower-precision path;
* the faults of a wrong update, planted in the reference put in the
  program's place: ``r1_is_r2`` (the second draw used for both terms),
  ``c1_dropped`` (the cognitive term left out), ``half_iters`` (half the
  iterations run).

The benchmark's runs never run this.

    python3 pso_bench/control.py --workload d120_async --seeds 100 112 \
        --other-seeds 3

prints one JSON line a reading: the cell, the kind, the seed, the cell's
numbers and the seconds the reference took.
"""
import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seeds, dtype=None, device="cuda"):
    """One reading a seed: the solve through the timed call (in ``dtype``
    where given) and the check against the reference."""
    from pso_bench import check
    from pso_bench.workload import Workload
    wl = Workload(cell, device=device, dtype=dtype)
    wl.solve(seeds[0] - 1).best_fit                      # warm the shape
    for seed in seeds:
        sample = check.sample_of(seed, wl.solve(seed))
        t0 = time.perf_counter()
        vals = check.run_check(wl, [sample], device)
        yield seed, vals, time.perf_counter() - t0


def faulty(cell, fault: str, seeds, device="cuda"):
    """The reference's solves of ``seeds`` with ``fault`` planted, in
    ``check.sample_of``'s form."""
    from pso_bench import check
    from pso_bench.reference import Reference
    iters = int(cell.config["iters"])
    ref = Reference(cell.config, cell.objective, device)
    if fault == "r1_is_r2":
        draws = ref.draws
        ref.draws = lambda s, it: (draws(s, it)[1],) * 2
    elif fault == "c1_dropped":
        ref.c1 = 0.0
    elif fault == "half_iters":
        iters //= 2
    else:
        raise ValueError(f"unknown fault {fault!r}")
    out = ref.run(seeds, iters, cell.traffic)
    return [check.sample_of_reference(s, out, j) for j, s in enumerate(seeds)]


FAULTS = ("r1_is_r2", "c1_dropped", "half_iters")


def fault_readings(cell, seeds, device="cuda"):
    """One reading a fault and seed, against one reference run of
    ``seeds``."""
    from pso_bench import check
    out = check.reference_run(cell, [{"seed": s} for s in seeds], device)
    keys = check.STATE + ("gbest_fit", "gbest_pos")
    for fault in FAULTS:
        for j, s in enumerate(faulty(cell, fault, seeds, device)):
            one = SimpleNamespace(**{k: getattr(out, k)[j:j + 1]
                                     for k in keys})
            yield fault, s["seed"], check.compare(cell, [s], one, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs=2, required=True,
                    help="the sound seeds: [first, last)")
    ap.add_argument("--other-seeds", type=int, default=3,
                    help="the control's and each fault's seeds: that many "
                         "from the first")
    ap.add_argument("--kinds", default="sound,control,faults")
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from pso_bench import spec
    cell = spec.find_cell(spec.load_benchmark(ROOT), args.workload)
    kinds = args.kinds.split(",")
    first = args.seeds[0]
    others = list(range(first, first + args.other_seeds))

    def emit(kind, seed, vals, secs=None):
        print(json.dumps({"cell": cell.name, "kind": kind, "seed": seed,
                          **vals, "reference_s": secs}), flush=True)

    for kind, dtype, seeds in (("sound", None, range(*args.seeds)),
                               ("control", "bfloat16", others)):
        if kind in kinds and seeds:
            for seed, vals, secs in readings(cell, list(seeds), dtype):
                emit(kind, seed, vals, secs)
    if "faults" in kinds:
        for fault, seed, vals in fault_readings(cell, others):
            emit(fault, seed, vals)
    return 0


if __name__ == "__main__":
    sys.exit(main())
