"""Constrained optimization, end to end: penalty vs projection. The port
of the reference's ``examples/constrained.py``.

Real PSO workloads are rarely pure boxes. ``repro_torch.ConstraintSet``
attaches feasibility constraints to any Problem and composes with every
backend (the eager engine, the CUDA kernels' split path, serving, the
tuner). Here: minimize ``||x||^2`` on the probability simplex
``{x >= 0, sum(x) = 1}`` (optimum ``x_i = 1/D``, ``f = 1/D``) with the
same landscape handled two ways:

* ``penalty`` — fitness becomes ``f(x) - weight * violation(x)``; the swarm
  roams the box and is *pushed* toward feasibility (optionally harder over
  time via the ``ramp`` schedule).
* ``projection`` — every advance is projected back onto the simplex
  (Duchi et al. sort-based projection); the swarm *never leaves* the
  feasible set.

``Method(record_history=True)`` records the gbest per sync point, from
which constrained runs report their first-feasible iteration
(``Result.first_feasible_iter``); ``repro_torch.best`` ranks results by
the Deb rule (feasible beats infeasible, then fitness, then violation).

    PYTHONPATH=src python -m repro_torch.examples.constrained

on the CUDA card unless ``--device cpu``. The ``queue_lock`` lines pass
``backend="eager"`` (the reference's jnp engine): on a card
``backend="auto"`` would send them to the kernels.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import _device
from ..api import Method, Result, best, solve, solve_many
from ..core.constraints import Constraint, ConstraintSet
from ..core.problem import Problem

DIM = 8

#: An adaptive ramp: start gentle (weight 1), quadruple every 75
#: iterations — the facade segments the run and re-weights the carried
#: bests at each boundary, so the ramp works on every backend.
RAMPED = Problem(
    name="sphere_simplex_ramp",
    fn=lambda x: torch.sum(x * x, dim=-1), lo=0.0, hi=1.0, sense="min",
    constraints=ConstraintSet(
        constraints=(
            Constraint(fn=lambda x: torch.sum(x, -1) - 1.0, kind="eq",
                       tol=1e-5, name="sum=1"),
            Constraint(fn=lambda x: torch.amax(-x, -1), name="x>=0"),
        ),
        mode="penalty", weight=1.0, ramp=4.0, ramp_every=75))


def report(label: str, res: Result) -> None:
    print(f"{label:24s} f={res.best_fit:.6f}  feasible={res.feasible}  "
          f"violation={res.violation:.3g}  "
          f"first_feasible_iter={res.first_feasible_iter}")


def solve_all(device=None, *, dim: int = DIM, particles: int = 256,
              iters: int = 300, kernel_iters: int = 60, seeds: int = 6,
              many_particles: int = 128,
              many_iters: int = 200) -> Dict[str, object]:
    """Every run of the example, printed; returns the Results by key
    (``pen``, ``proj``, ``kernel``, ``ramp``, ``many``: a list)."""
    print(f"=== sphere on the {dim}-simplex (optimum f = 1/{dim} "
          f"= {1.0 / dim:.6f}) ===")
    kw = dict(dim=dim, particles=particles, iters=iters, seed=0, w=0.7,
              variant="queue_lock", backend="eager", record_history=True,
              device=device)

    # The two built-in spellings of the same constrained landscape.
    out = {"pen": solve("sphere_simplex_pen", **kw)}
    report("penalty (w=50)", out["pen"])
    out["proj"] = solve("sphere_simplex", **kw)
    report("projection", out["proj"])

    # The async variant and the CUDA kernels take constrained problems
    # unchanged (the kernel backend's split path: the penalty rides the
    # objective's torch step between its two kernels).
    out["kernel"] = solve("sphere_simplex_pen", dim=dim, particles=particles,
                          iters=kernel_iters, seed=0, w=0.7,
                          method=Method(variant="async", backend="kernel",
                                        sync_every=10), device=device)
    report("penalty (cuda async)", out["kernel"])

    out["ramp"] = solve(RAMPED, **kw)
    report("penalty (ramp 1->4^k)", out["ramp"])

    # Deb-rule selection over a batch of seeds.
    rs = solve_many("sphere_simplex_pen", seeds=range(seeds), dim=dim,
                    particles=many_particles, iters=many_iters, w=0.7,
                    variant="queue_lock", backend="eager", device=device)
    b = best(rs)
    print(f"{'deb best of ' + str(seeds) + ' seeds':24s} f={b.best_fit:.6f}"
          f"  feasible={b.feasible}  "
          f"({sum(r.feasible for r in rs)}/{seeds} feasible)")
    out["many"] = rs
    return out


def check(proj: Result, dim: int = DIM) -> None:
    """The reference's closing asserts on the projection run."""
    assert proj.feasible and abs(proj.best_fit - 1.0 / dim) < 1e-3
    assert proj.first_feasible_iter is not None
    assert np.all(np.diff(np.asarray(proj.history.gbest_fit)) >= 0)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    try:
        _device.resolve(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    check(solve_all(args.device)["proj"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
