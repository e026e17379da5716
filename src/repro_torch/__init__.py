"""repro_torch — the PyTorch and CUDA port of ``repro`` (cuPSO, arXiv
2205.01313) for one NVIDIA Hopper card.

Top-level surface (lazily imported so ``import repro_torch`` stays cheap and
works on CPU-only torch):

    repro_torch.solve(problem, ...) -> Result   # the unified facade
    repro_torch.solve_many(problem, seeds, ...) # one Result per seed
    repro_torch.solve_stream(requests, ...)     # continuous-batching serving
    repro_torch.ContinuousScheduler / repro_torch.CompileCache
    repro_torch.ServingMetrics
    repro_torch.SolveServer / repro_torch.SolveRequest  # flush batching
    repro_torch.best(results)                   # best of several Results
    repro_torch.Method / repro_torch.Result     # method spec / result
    repro_torch.History                         # Result.history
    repro_torch.Problem / repro_torch.register_problem
    repro_torch.get_problem / repro_torch.list_problems
    repro_torch.resolve_problem / repro_torch.PSOConfig
    repro_torch.Constraint / repro_torch.ConstraintSet   # constraints
    repro_torch.project_simplex / repro_torch.simplex_constraints
    repro_torch.constrain_problem

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise instead of falling back. The
layout mirrors ``repro`` (``core/``, ``kernels/``, ``telemetry/``,
``serving/``, ``checkpoint/``, ``runtime/``, ``launch/``, ``api.py``), but
nothing here imports JAX or ``repro``.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "solve": "repro_torch.api",
    "solve_many": "repro_torch.api",
    "solve_stream": "repro_torch.api",
    "best": "repro_torch.api",
    "Method": "repro_torch.api",
    "Result": "repro_torch.api",
    "History": "repro_torch.api",
    "ContinuousScheduler": "repro_torch.serving",
    "CompileCache": "repro_torch.serving",
    "ServingMetrics": "repro_torch.serving",
    "SolveServer": "repro_torch.launch.serve",
    "SolveRequest": "repro_torch.launch.serve",
    "Problem": "repro_torch.core.problem",
    "register_problem": "repro_torch.core.problem",
    "get_problem": "repro_torch.core.problem",
    "list_problems": "repro_torch.core.problem",
    "resolve_problem": "repro_torch.core.problem",
    "PSOConfig": "repro_torch.core.pso",
    "Constraint": "repro_torch.core.constraints",
    "ConstraintSet": "repro_torch.core.constraints",
    "project_simplex": "repro_torch.core.constraints",
    "simplex_constraints": "repro_torch.core.constraints",
    "constrain_problem": "repro_torch.core.constraints",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
