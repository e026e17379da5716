"""A user-defined objective, end to end. The port of the reference's
``examples/custom_objective.py``.

cuPSO hard-codes six benchmark landscapes; real workloads bring their own
(the Low-Complexity-PSO line of work exists precisely for time-critical,
application-specific objectives). ``repro_torch.Problem`` makes an
objective a first-class value:

* ``fn``: any torch function ``pos[..., D] -> value[...]`` — it runs
  unchanged in the eager engine AND on the kernel backend, whose split
  path (``kernels/pso_split.py``) runs the objective as a torch step
  between its advance and fold-and-publish kernels: no hand-written kernel
  form needed.
* per-dimension bounds: ``lo``/``hi`` scalars or length-D tuples.
* ``sense``: "min" or "max" — the engine canonicalizes internally and
  reports results back in YOUR sense.

    PYTHONPATH=src python -m repro_torch.examples.custom_objective

on the CUDA card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import _device
from ..api import Method, Result, solve
from ..core.problem import Problem, list_problems, register_problem

# Minimize a weighted, shifted quadratic bowl over a per-dimension box:
#   f(x) = sum_i w_i (x_i - c_i)^2 ,  x in [-5,5] x [-10,10] x [-2,2].
# The optimum is x = c = (1, -2, 0.5) with f = 0.
W = (1.0, 4.0, 0.25)
C = (1.0, -2.0, 0.5)
LO, HI = (-5.0, -10.0, -2.0), (5.0, 10.0, 2.0)


def weighted_bowl(x):
    w = torch.tensor(W, dtype=x.dtype, device=x.device)
    c = torch.tensor(C, dtype=x.dtype, device=x.device)
    return torch.sum(w * (x - c) ** 2, dim=-1)


problem = Problem(
    name="weighted_bowl",
    fn=weighted_bowl,
    lo=LO,                         # per-dimension boxes pin dim=3
    hi=HI,
    sense="min",                   # minimize; results come back minimized
)


def solve_all(device=None, *, particles: int = 512, iters: int = 400,
              kernel_iters: int = 100, name_particles: int = 256,
              name_iters: int = 200) -> Dict[str, Result]:
    """Every run of the example, printed; returns the Results by key
    (``eager``, ``fused``, ``async``, ``by_name``)."""
    # The eager engine, queue variant (dim defaults to the bounds' length).
    out = {"eager": solve(problem, particles=particles, iters=iters, seed=0,
                          variant="queue", device=device)}
    res = out["eager"]
    print(f"eager queue    : f={res.best_fit:.6f} at {res.best_pos}")

    # The same problem on the fused queue-lock kernel path (the split path's
    # two kernels around the objective's torch step).
    out["fused"] = solve(problem, particles=particles, iters=kernel_iters,
                         seed=0, method=Method(variant="queue_lock",
                                               backend="kernel"),
                         device=device)
    res = out["fused"]
    print(f"cuda fused     : f={res.best_fit:.6f} at {res.best_pos}")

    # And the asynchronous queue-lock (block-resident, relaxed consistency).
    out["async"] = solve(problem, particles=particles, iters=kernel_iters,
                         seed=0, method=Method(variant="async",
                                               backend="kernel",
                                               sync_every=10),
                         device=device)
    res = out["async"]
    print(f"cuda async     : f={res.best_fit:.6f} at {res.best_pos}")

    # Registering makes it addressable by name (configs, serving requests):
    register_problem(problem)
    out["by_name"] = solve("weighted_bowl", particles=name_particles,
                           iters=name_iters, device=device)
    print(f"by name        : f={out['by_name'].best_fit:.6f}")
    print(f"registered     : {', '.join(list_problems())}")
    return out


def check(res: Result) -> None:
    """The reference's asserts on the eager run."""
    assert res.best_fit < 0.1, "should sit near the optimum f=0"
    assert np.all(res.best_pos >= np.array(LO) - 1e-5)
    assert np.all(res.best_pos <= np.array(HI) + 1e-5)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    try:
        _device.resolve(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    check(solve_all(args.device)["eager"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
