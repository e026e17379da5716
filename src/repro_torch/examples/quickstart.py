"""Quickstart: the unified solve facade, the port of the reference's
``examples/quickstart.py``.

One entry point — ``repro_torch.solve(problem, ...)`` — covers the eager
engine (``core.pso``), the batched engine (``solve_many``) and the CUDA
kernels (``kernels.ops``): pick a problem (a registered benchmark name or
your own ``repro_torch.Problem``), a ``Method`` (aggregation variant +
eager/kernel backend), and go.

Here: the paper's two benchmark workloads (1D and 120D cubic) through all
four aggregation variants on the eager engine, the fused and async
queue-lock CUDA kernels, and a batched multi-seed solve — verifying the
paper's §4.1 claim that queueing is an optimization, not an approximation.

    PYTHONPATH=src python -m repro_torch.examples.quickstart

on the CUDA card unless ``--device cpu`` (the kernel lines then run the
kernels' plain PyTorch versions). The eager lines pass
``backend="eager"``: on a card ``backend="auto"`` would send the
``queue_lock`` and ``async`` variants to the kernels. The kernel lines
keep the reference's ``min(iters, 100)``.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

from .. import _device
from ..api import Method, Result, best, solve, solve_many

EAGER_VARIANTS = ("reduction", "queue", "queue_lock", "async")
#: The kernel lines: (variant, Method fields beyond the backend).
KERNEL_LINES = (("queue_lock", {}), ("async", {"sync_every": 10}))


def solve_and_report(dim: int, particles: int, iters: int,
                     device=None) -> Dict[str, Result]:
    """cubic at ``dim`` through the four variants on the eager engine,
    then the fused (``queue_lock``) and async kernels at ``min(iters,
    100)`` iterations; returns the Results by printed label."""
    print(f"\n=== cubic, dim={dim}, particles={particles}, iters={iters} ===")
    print(f"{'method':32s} {'best_fit':>14s} {'wall_s':>8s}")
    out = {}
    for variant in EAGER_VARIANTS:
        t0 = time.time()
        res = solve("cubic", dim=dim, particles=particles, iters=iters,
                    seed=0, variant=variant, backend="eager", device=device)
        label = variant + " (eager)"
        print(f"{label:32s} {res.best_fit:14.4f} {time.time() - t0:8.3f}")
        out[label] = res
    # The fused and async queue-lock kernels (their plain versions on the
    # CPU). backend="kernel" exists for the queue_lock and async variants.
    k_iters = min(iters, 100)
    for variant, extra in KERNEL_LINES:
        t0 = time.time()
        res = solve("cubic", dim=dim, particles=particles, iters=k_iters,
                    seed=0, method=Method(variant=variant, backend="kernel",
                                          **extra), device=device)
        label = variant + " (cuda)"
        print(f"{label:32s} {res.best_fit:14.4f} "
              f"{time.time() - t0:8.3f}  ({k_iters} iters)")
        out[label] = res
    ideal = dim * 900000.0
    print(f"{'analytic optimum f(100)*d':32s} {ideal:14.4f}")
    return out


def batched_demo(device=None, seeds: Sequence[int] = range(8),
                 dim: int = 10, particles: int = 256,
                 iters: int = 200) -> List[Result]:
    """Many independent solves in ONE device program (the serving
    primitive): the batched eager engine, ``queue`` variant."""
    t0 = time.time()
    results = solve_many("rastrigin", seeds=seeds, dim=dim,
                         particles=particles, iters=iters, variant="queue",
                         device=device)
    top = best(results)
    print(f"\n=== batched: {len(results)} seeds of {dim}D rastrigin in one "
          f"dispatch ===")
    print(f"best seed result {top.best_fit:.4f}  "
          f"({len(results)} solves, wall={time.time() - t0:.3f}s)")
    return results


def islands_demo(device=None, islands: int = 4, dim: int = 10,
                 particles: int = 1024, iters: int = 200) -> Result:
    """One swarm split into islands with the ASYNC ring exchange.

    Islands iterate against a stale view and push their best around a
    neighbor ring every ``exchange_interval`` iterations — no global
    barrier anywhere. Staleness is bounded by ``sync_every`` iterations
    within an island plus ``islands`` exchange rounds across them; the run
    still ends fully synchronized (drain hops), so the reported best equals
    the true max over all particles.

    The reference shards its islands over as many devices as it has (one
    device degenerating, bit-identically, to the single-chip async
    variant). The port keeps ``islands`` equal row blocks of one swarm on
    the one device (ROADMAP's parity contract, "Islands"), so it runs four
    islands on one card.
    """
    t0 = time.time()
    res = solve("rastrigin", dim=dim, particles=particles, iters=iters,
                seed=0, method=Method(variant="async", islands=islands,
                                      exchange_interval=20, sync_every=5),
                device=device)
    print(f"\n=== islands: async ring over {islands} island(s) on one "
          f"device ===")
    print(f"best {res.best_fit:.4f}  (wall={time.time() - t0:.3f}s)")
    return res


def run(device=None) -> None:
    """The example at the reference's sizes on ``device``."""
    solve_and_report(dim=1, particles=1024, iters=1000, device=device)
    solve_and_report(dim=120, particles=2048, iters=500, device=device)
    batched_demo(device)
    islands_demo(device)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    try:
        _device.resolve(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    run(args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
