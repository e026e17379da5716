"""Constrained optimization, the port of ``repro.core.constraints``:
feasibility as ``Problem`` data, in torch.

Constraint forms
----------------
* ``Constraint(fn, kind="ineq")``: feasible where ``g(x) <= 0``.
* ``Constraint(fn, kind="eq", tol=...)``: feasible where ``|h(x)| <= tol``.

``fn`` maps a torch tensor ``pos[..., D] -> residual[...]``, the
``Problem.fn`` contract. The aggregate violation of a position is::

    viol(x) = sum_i max(0, g_i(x)) + sum_j max(0, |h_j(x)| - tol_j)

so ``viol(x) == 0`` exactly where ``x`` is feasible.

Modes (``ConstraintSet.mode``)
------------------------------
``penalty``
    Canonical fitness becomes ``max_fn(x) - weight * viol(x)``
    (``Problem.max_fn``), an objective like any other. ``ramp``/
    ``ramp_every`` multiply the weight per segment of the run; the solve
    facade applies the ramp by re-weighting the carried fitness at each
    segment boundary (``repro_torch.api``).
``projection``
    A user operator ``projection(pos[..., D]) -> pos`` maps positions onto
    the feasible set after the box clip, at init and after every advance.
    The declared constraints then only report violation.
``repair``
    Infeasible initial positions are redrawn from the box
    (``repair_init_positions``); the dynamics stay unconstrained.

The Deb rule
------------
``deb_improved`` is K. Deb's rule (2000): a feasible point beats an
infeasible one, two feasible points compare on fitness, two infeasible
points on violation (smaller wins). In ``projection`` and ``repair`` modes
it decides the pbest fold of every engine (``core.pso.deb_selection_fn``,
the split kernels of ``repro_torch.kernels.pso_split``); ``penalty`` mode
keeps the raw fitness fold, as the reference does. ``repro_torch.best``
ranks Results by it.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from . import rng
from .fitness import LOW_PRECISION, sum_f32, weak
from .problem import Problem, register_problem

Tensor = torch.Tensor

MODES = ("penalty", "projection", "repair")


def deb_improved(fit_new: Tensor, viol_new: Tensor, fit_old: Tensor,
                 viol_old: Tensor) -> Tensor:
    """Deb-rule selection mask: True where the new point displaces the old.
    Strict comparisons, so ties keep the incumbent; with both violations
    zero it is the raw ``fit_new > fit_old`` fold."""
    feas_new = viol_new <= 0.0
    feas_old = viol_old <= 0.0
    return ((feas_new & ~feas_old)
            | (feas_new & feas_old & (fit_new > fit_old))
            | (~feas_new & ~feas_old & (viol_new < viol_old)))


@dataclasses.dataclass(frozen=True)
class Constraint:
    """One scalar constraint residual: ``kind="ineq"`` is feasible where
    ``fn(x) <= 0``, ``kind="eq"`` where ``|fn(x)| <= tol``."""

    fn: Callable
    kind: str = "ineq"
    tol: float = 1e-6
    name: str = ""

    def __post_init__(self):
        if self.kind not in ("ineq", "eq"):
            raise ValueError(
                f"kind must be 'ineq' or 'eq', got {self.kind!r}")
        if not callable(self.fn):
            raise TypeError("Constraint.fn must be callable")
        if self.tol < 0:
            raise ValueError(f"tol must be >= 0, got {self.tol}")

    def violation(self, pos: Tensor) -> Tensor:
        """Per-position violation contribution (0 where satisfied)."""
        r = self.fn(pos)
        if self.kind == "eq":
            return torch.clamp(torch.abs(r) - weak(self.tol, r.dtype),
                               min=0.0)
        return torch.clamp(r, min=0.0)


@dataclasses.dataclass(frozen=True)
class ConstraintSet:
    """A frozen set of constraints plus the handling mode (module doc).

    ``weight`` is the penalty in canonical fitness units per unit of
    violation; segment ``k`` of ``ramp_every`` iterations runs at ``weight
    * ramp**k`` (no ramp when ``ramp_every == 0`` or ``ramp == 1``)."""

    constraints: Tuple[Constraint, ...] = ()
    mode: str = "penalty"
    weight: float = 1000.0
    ramp: float = 1.0
    ramp_every: int = 0
    projection: Optional[Callable] = None
    repair_tries: int = 8

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        cons = tuple(self.constraints)
        if not all(isinstance(c, Constraint) for c in cons):
            raise TypeError("constraints must be Constraint instances")
        object.__setattr__(self, "constraints", cons)
        if self.mode == "projection":
            if self.projection is None:
                raise ValueError(
                    "mode='projection' needs a projection= operator "
                    "(pos[..., D] -> pos on the feasible set)")
        elif self.projection is not None:
            raise ValueError(
                f"projection= only applies to mode='projection', "
                f"not {self.mode!r}")
        if self.mode in ("penalty", "repair") and not cons:
            raise ValueError(
                f"mode={self.mode!r} needs at least one Constraint")
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.ramp <= 0 or self.ramp_every < 0 or self.repair_tries < 1:
            raise ValueError(
                f"need ramp > 0, ramp_every >= 0, repair_tries >= 1; got "
                f"{self.ramp}/{self.ramp_every}/{self.repair_tries}")

    def violation_fn(self) -> Callable:
        """The aggregate violation ``pos[..., D] -> viol[...] >= 0``, cached
        on the instance so every caller sees one callable."""
        cached = self.__dict__.get("_violation_fn")
        if cached is None:
            cons = self.constraints

            def viol(pos):
                if not cons:
                    return pos.new_zeros(pos.shape[:-1])
                total = cons[0].violation(pos)
                for c in cons[1:]:
                    total = total + c.violation(pos)
                return total

            object.__setattr__(self, "_violation_fn", viol)
            cached = viol
        return cached

    def violation(self, pos: Tensor) -> Tensor:
        return self.violation_fn()(pos)

    def with_weight(self, weight: float) -> "ConstraintSet":
        """The same set at another (ramped) penalty weight."""
        return dataclasses.replace(self, weight=float(weight))

    def _content(self) -> Tuple:
        """Explicit fields and raw callables, hashed by
        ``Problem.cache_key`` (never the repr, which embeds function
        addresses)."""
        return ("cset", self.mode, self.weight, self.ramp, self.ramp_every,
                self.repair_tries, self.projection,
                tuple((c.kind, c.tol, c.name, c.fn)
                      for c in self.constraints))


def repair_init_positions(cset: ConstraintSet, viol_fn: Callable,
                          pos: Tensor, lo, span, seed, stream: int,
                          idx: Tensor, dtype: torch.dtype) -> Tensor:
    """Redraw infeasible initial positions (mode="repair"): up to
    ``cset.repair_tries`` fresh box draws a particle from the counter RNG
    at ``iteration = attempt`` on the init stream ``stream``; the first
    feasible draw wins, and a particle with none keeps its original draw."""
    feas = viol_fn(pos) <= 0.0
    for attempt in range(1, cset.repair_tries + 1):
        u = rng.uniform(seed, attempt, stream, idx, dtype=dtype)
        cand = lo + span * u
        take = (~feas) & (viol_fn(cand) <= 0.0)
        pos = torch.where(take[..., None], cand, pos)
        feas = feas | take
    return pos


# ---------------------------------------------------------------------------
# Ready-made operators and the sphere-on-simplex problems.
# ---------------------------------------------------------------------------

def _cumsum(u: Tensor) -> Tensor:
    """The prefix sums over the last axis as the reference's
    ``jnp.cumsum`` takes them: in a dtype narrower than float32 each prefix
    is rounded after every add (``torch.cumsum`` accumulates in float32 and
    rounds each prefix once, which disagreed on most bfloat16 rows near
    the simplex); ``torch.cumsum`` in wider dtypes."""
    if u.dtype not in LOW_PRECISION:
        return torch.cumsum(u, dim=-1)
    terms = u.unbind(-1)
    out = [terms[0]]
    for t in terms[1:]:
        out.append(out[-1] + t)
    return torch.stack(out, -1)


def project_simplex(pos: Tensor, radius: float = 1.0) -> Tensor:
    """Euclidean projection of ``pos[..., D]`` onto the simplex
    ``{x : x >= 0, sum(x) = radius}`` (Duchi et al. 2008, sort-based)."""
    d = pos.shape[-1]
    u = torch.sort(pos, dim=-1, descending=True).values
    css = _cumsum(u) - weak(radius, pos.dtype)
    k = torch.arange(1, d + 1, dtype=pos.dtype, device=pos.device)
    rho = torch.sum((u - css / k > 0).to(torch.int32), dim=-1)
    rho = torch.clamp(rho, min=1)                      # numerical guard
    theta = (torch.gather(css, -1, (rho[..., None] - 1).to(torch.int64))
             / rho[..., None].to(pos.dtype))
    return torch.clamp(pos - theta, min=0.0)


def _simplex_sum(x):
    return sum_f32(x) - weak(1.0, x.dtype)


def _simplex_nonneg(x):
    return torch.amax(-x, dim=-1)


def simplex_constraints(tol: float = 1e-5) -> Tuple[Constraint, ...]:
    """``sum(x) == 1`` (within ``tol``) and ``x >= 0``."""
    return (Constraint(fn=_simplex_sum, kind="eq", tol=tol, name="sum=1"),
            Constraint(fn=_simplex_nonneg, kind="ineq", name="x>=0"))


def _sphere_obj(x):
    """The sphere in the problem's own (minimization) sense."""
    return sum_f32(x * x)


# Minimize ||x||^2 on the probability simplex (optimum x_i = 1/D, f = 1/D),
# registered in the projection and the penalty mode.
SPHERE_SIMPLEX = register_problem(Problem(
    name="sphere_simplex", fn=_sphere_obj, lo=0.0, hi=1.0, sense="min",
    constraints=ConstraintSet(constraints=simplex_constraints(),
                              mode="projection",
                              projection=project_simplex)))

SPHERE_SIMPLEX_PENALTY = register_problem(Problem(
    name="sphere_simplex_pen", fn=_sphere_obj, lo=0.0, hi=1.0, sense="min",
    constraints=ConstraintSet(constraints=simplex_constraints(),
                              mode="penalty", weight=50.0)))


# ---------------------------------------------------------------------------
# CLI presets: "<reduce>(x) <op> <float>", plus the named preset "simplex".
# ---------------------------------------------------------------------------

_REDUCERS = {
    "sum": sum_f32,
    "norm": lambda x: torch.sqrt(sum_f32(x * x)),
    "norm2": lambda x: sum_f32(x * x),
    "min": lambda x: torch.amin(x, dim=-1),
    "max": lambda x: torch.amax(x, dim=-1),
}
_SPEC_RE = re.compile(
    r"^\s*(sum|norm2|norm|min|max)\(x\)\s*(<=|>=|==)\s*"
    r"([-+]?\d+(?:\.\d*)?(?:[eE][-+]?\d+)?)\s*$")


def constraint_from_spec(spec: str, tol: float = 1e-5) -> Constraint:
    """Parse ``"reduce(x) op value"`` (``reduce`` in
    sum|norm|norm2|min|max, ``op`` in ``<= >= ==``) into a Constraint."""
    m = _SPEC_RE.match(spec)
    if not m:
        raise ValueError(
            f"cannot parse constraint spec {spec!r}; expected e.g. "
            f"'sum(x)<=1', 'norm(x)<=2.5', 'min(x)>=0', 'sum(x)==1', "
            f"or the named preset 'simplex'")
    red, op, val = _REDUCERS[m.group(1)], m.group(2), float(m.group(3))
    if op == ">=":
        fn = lambda x, _r=red, _v=val: _v - _r(x)     # noqa: E731
    else:
        fn = lambda x, _r=red, _v=val: _r(x) - _v     # noqa: E731
    return Constraint(fn=fn, kind="eq" if op == "==" else "ineq", tol=tol,
                      name=spec.strip())


def constraint_set_from_cli(specs: Sequence[str], mode: str = "penalty",
                            weight: float = 1000.0) -> ConstraintSet:
    """A ConstraintSet from ``--constraint`` specs. ``"simplex"`` expands to
    the simplex pair and, in projection mode, supplies ``project_simplex``;
    expression specs take the penalty and repair modes only."""
    cons: list = []
    projection = None
    for s in specs:
        if s.strip() == "simplex":
            cons.extend(simplex_constraints())
            projection = project_simplex
        else:
            cons.append(constraint_from_spec(s))
    if mode == "projection" and projection is None:
        raise ValueError(
            "mode='projection' from the CLI requires the 'simplex' preset "
            "(expression constraints have no automatic projection operator);"
            " use --constraint-mode penalty or repair")
    return ConstraintSet(
        constraints=tuple(cons), mode=mode, weight=weight,
        projection=projection if mode == "projection" else None)


def constrain_problem(problem: Union[str, Problem], cset: ConstraintSet,
                      name: Optional[str] = None) -> Problem:
    """A copy of ``problem`` carrying ``cset``, without its ``kernel_fn``
    (which could not apply the penalty or the projection)."""
    from .problem import resolve_problem
    base = resolve_problem(problem)
    return dataclasses.replace(
        base, name=name or f"{base.name}_constrained", constraints=cset,
        kernel_fn=None)
