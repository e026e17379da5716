"""Run one cell of the port's benchmark on the card and print its result.

    python3 pso_bench/run.py --workload d120_async --seed 7 --seconds 20 \
        --trace 0

From the root of a checkout that holds ``BENCHMARK.json``, ``pso_bench/``
and the port (``src/repro_torch``). The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics and a
``breakdown``), ``device`` and, last, ``check``: each number the
correctness check compared, beside its limit, which also end standard
error. Without a CUDA card, or with fewer cards than the cell asks for, or
with JAX or the JAX package loaded when the window closes, it prints no
result and exits 2, 2 and 3.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "pso_bench_cache"
# The bytecode of every module imported from here on, torch's too, cached
# inside the checkout at a fixed path, so that only a checkout's first run
# compiles it: where the environment says not to write bytecode and the
# installation ships none, every run would compile torch anew (most of a
# warm set-up, and most of its spread).
sys.pycache_prefix = str(CACHE / "pycache")
sys.dont_write_bytecode = False


def _paths() -> None:
    """The benchmark package and the port from this checkout, and every
    build and kernel cache inside it, at fixed paths."""
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(CACHE / "cuda"))
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    from pso_bench import harness, spec
    cell = spec.find_cell(spec.load_benchmark(ROOT), args.workload)
    import torch
    marks = {"import_torch": time.perf_counter()}
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import repro_torch.api  # noqa: F401  (fails here without the port)
    marks["import_port"] = time.perf_counter()
    out, lines = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), T0, marks=marks)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"loaded when the window closed: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print("\n".join(lines), file=sys.stderr)
    print(json.dumps(out))
    sys.stdout.flush()
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
