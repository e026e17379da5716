"""The six benchmark objectives, in torch, maximized (paper §6.1, Eq. 3).

Each maps ``pos[..., D] -> fit[...]`` with the same operations in the same
order as ``repro.core.fitness``; classical minimization benchmarks are
negated. The CUDA kernels carry per-thread forms of the same arithmetic
(``kernels/csrc/pso_step.cu``), selected by ``FITNESS_IDS``; ``is_builtin``
says which Problems they take.

A Python constant enters an operation as the reference's weak typing makes
it: rounded to the operand's dtype where that is narrower than float32
(``weak``), which torch does not do by itself.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict

import torch

from .problem import Problem, register_problem

#: Float dtypes narrower than float32.
LOW_PRECISION = (torch.bfloat16, torch.float16)


@functools.lru_cache(maxsize=None)
def _rounded(v: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(v, dtype=dtype))


def weak(v, dtype: torch.dtype):
    """A Python number ``v`` as it enters an operation of ``dtype`` under
    the reference's weak typing: rounded to ``dtype`` (to nearest even)
    where that is narrower than float32. Torch computes ``x * 0.8`` on a
    bfloat16 ``x`` with 0.8 at float32 precision; the reference with
    bfloat16(0.8). ``v`` itself in wider dtypes, and a tensor unchanged."""
    if dtype not in LOW_PRECISION or isinstance(v, torch.Tensor):
        return v
    return _rounded(float(v), dtype)


def sum_f32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The sum over ``dim`` as the reference's ``jnp.sum`` takes it in a
    dtype narrower than float32: from 0 in float32, one index after
    another, rounded once to ``x``'s dtype (``torch.sum`` accumulates in
    float32 too, but in another order, and disagreed on about 1 row in
    200,000 of 5 bfloat16 terms). ``torch.sum`` in wider dtypes."""
    if x.dtype not in LOW_PRECISION:
        return torch.sum(x, dim=dim)
    acc = torch.zeros_like(x.select(dim, 0), dtype=torch.float32)
    for term in x.float().unbind(dim):
        acc = acc + term
    return acc.to(x.dtype)


def cubic(pos: torch.Tensor) -> torch.Tensor:
    """Paper Eq. 3, maximized: sum_i x_i^3 - 0.8 x_i^2 - 1000 x_i + 8000."""
    x = pos
    return torch.sum(x * x * x - weak(0.8, x.dtype) * (x * x) - 1000.0 * x
                     + 8000.0, dim=-1)


def sphere(pos: torch.Tensor) -> torch.Tensor:
    """Negated sphere: max at origin, f(0) = 0."""
    return -torch.sum(pos * pos, dim=-1)


def rosenbrock(pos: torch.Tensor) -> torch.Tensor:
    """Negated Rosenbrock (D >= 2; for D == 1 degenerates to -(1-x)^2)."""
    x = pos
    if x.shape[-1] == 1:
        t = 1.0 - x
        return -(t * t).squeeze(-1)
    a, b = x[..., :-1], x[..., 1:]
    u = b - a * a
    t = 1.0 - a
    return -torch.sum(100.0 * (u * u) + t * t, dim=-1)


def griewank(pos: torch.Tensor) -> torch.Tensor:
    x = pos
    d = x.shape[-1]
    idx = torch.arange(1, d + 1, dtype=x.dtype, device=x.device)
    s = torch.sum(x * x, dim=-1) / 4000.0
    c = torch.cos(x / torch.sqrt(idx))
    if x.dtype in LOW_PRECISION:    # jnp.prod accumulates these in float32
        p = torch.prod(c, dim=-1, dtype=torch.float32).to(x.dtype)
    else:
        p = torch.prod(c, dim=-1)
    return -(s - p + 1.0)


def rastrigin(pos: torch.Tensor) -> torch.Tensor:
    x = pos
    d = x.shape[-1]
    two_pi = weak(2.0 * math.pi, x.dtype)
    return -(weak(10.0 * d, x.dtype)
             + torch.sum(x * x - 10.0 * torch.cos(two_pi * x), dim=-1))


def ackley(pos: torch.Tensor) -> torch.Tensor:
    x = pos
    d = x.shape[-1]
    dt = x.dtype
    s1 = torch.sqrt(torch.sum(x * x, dim=-1) / weak(d, dt))
    s2 = torch.sum(torch.cos(weak(2.0 * math.pi, dt) * x), dim=-1) \
        / weak(d, dt)
    return -(-20.0 * torch.exp(weak(-0.2, dt) * s1) - torch.exp(s2) + 20.0
             + weak(math.e, dt))


# Declaration order fixes FITNESS_IDS (the kernels' template index), so keep
# it the reference's.
BUILTIN_PROBLEMS = tuple(register_problem(p) for p in (
    Problem(name="cubic", fn=cubic, lo=-100.0, hi=100.0),
    Problem(name="sphere", fn=sphere, lo=-100.0, hi=100.0),
    Problem(name="rosenbrock", fn=rosenbrock, lo=-30.0, hi=30.0),
    Problem(name="griewank", fn=griewank, lo=-600.0, hi=600.0),
    Problem(name="rastrigin", fn=rastrigin, lo=-5.12, hi=5.12),
    Problem(name="ackley", fn=ackley, lo=-32.0, hi=32.0),
))

FITNESS_FNS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    p.name: p.fn for p in BUILTIN_PROBLEMS}

#: Stable integer ids for kernel-side selection.
FITNESS_IDS: Dict[str, int] = {name: i for i, name in enumerate(FITNESS_FNS)}

#: Search-domain defaults per function.
DEFAULT_BOUNDS: Dict[str, tuple] = {
    p.name: (p.lo, p.hi) for p in BUILTIN_PROBLEMS}


def is_builtin(problem: Problem) -> bool:
    """Whether ``problem`` takes the built-in kernels: one of the six
    registered objectives, unchanged (``Problem`` equality, so a lookalike
    with another ``fn`` does not). Every other Problem, constrained or
    custom, takes the kernel backend's split path
    (``repro_torch.kernels.pso_split``)."""
    i = FITNESS_IDS.get(problem.name)
    return i is not None and problem == BUILTIN_PROBLEMS[i]
