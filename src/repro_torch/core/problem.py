"""Optimization problems as data: the port of ``repro.core.problem``.

``fn`` maps a torch tensor ``pos[..., D] -> fit[...]``. The engine always
MAXIMIZES: ``sense="min"`` canonicalizes through ``max_fn`` (negation) and
results convert back with ``user_value``. ``lo``/``hi`` are a scalar or a
length-D tuple (per-dimension boxes), normalized so the Problem stays
hashable.

``constraints`` attaches a ``repro_torch.core.constraints.ConstraintSet``
(penalty, projection or repair handling; see that module for the Deb rule).
``kernel_fn`` is an optional D-major torch form of the objective,
``kernel_fn(pos [D, N]) -> fit [N]`` in the canonical (max) sense, applied
column by column: the kernel backend's split path
(``repro_torch.kernels.pso_split``) calls it on its D-major positions in
place of ``max_fn(pos.T)``, saving the transpose; the eager engine ignores
it, as the reference's jnp engine does. ``kernel_fn`` and ``constraints``
are mutually exclusive.

``Problem.cache_key()`` is the content hash the serving layer groups and
keys programs by (``repro_torch.launch.serve``, ``repro_torch.serving``).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import types
from typing import Callable, Dict, Optional, Tuple, Union

Bound = Union[float, Tuple[float, ...]]


def _norm_bound(v) -> Bound:
    """Normalize a bound to a hashable float or tuple-of-floats."""
    if isinstance(v, (int, float)):
        return float(v)
    try:
        return tuple(float(x) for x in v)
    except TypeError:
        raise TypeError(f"bound must be a scalar or a sequence, got {v!r}")


def broadcast_bounds(lo: Bound, hi: Bound) -> Tuple[Bound, Bound]:
    """Make a (lo, hi) pair rank-consistent: if exactly one side is
    per-dimension, broadcast the scalar side to match."""
    if isinstance(lo, tuple) and not isinstance(hi, tuple):
        hi = (float(hi),) * len(lo)
    elif isinstance(hi, tuple) and not isinstance(lo, tuple):
        lo = (float(lo),) * len(hi)
    return lo, hi


# --- content hashing (cache_key) --------------------------------------------
# repr() is not a faithful serialization: array and tensor reprs truncate and
# round, and a repr of a function or a built-in embeds its address, which
# changes from process to process. Hash raw bytes, and recurse into nested
# functions and code objects instead.

def _hash_value(h, v, depth: int = 0) -> None:
    import numpy as np
    import torch
    if depth > 6:
        h.update(b"<deep>")
        return
    if v is None or isinstance(v, (str, bytes, int, float, bool, complex)):
        h.update(repr(v).encode())
    elif isinstance(v, (tuple, list)):
        h.update(b"(")
        for x in v:
            _hash_value(h, x, depth + 1)
        h.update(b")")
    elif isinstance(v, types.CodeType):
        _hash_code(h, v, depth + 1)
    elif isinstance(v, torch.Tensor):
        h.update(str(v.dtype).encode())
        h.update(repr(tuple(v.shape)).encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    elif callable(v):
        _hash_fn(h, v, depth + 1)
    else:
        try:
            arr = np.asarray(v)
        except (TypeError, ValueError):
            arr = None
        if arr is not None and arr.dtype != object:
            h.update(str(arr.dtype).encode())
            h.update(repr(arr.shape).encode())
            h.update(arr.tobytes())
        else:
            h.update(repr(v).encode())


def _hash_code(h, code: types.CodeType, depth: int) -> None:
    h.update(code.co_code)
    h.update(repr(code.co_names).encode())
    _hash_value(h, code.co_consts, depth)      # may nest code objects


def _hash_fn(h, fn, depth: int = 0) -> None:
    if isinstance(fn, functools.partial):
        _hash_fn(h, fn.func, depth)
        _hash_value(h, fn.args, depth)
        _hash_value(h, tuple(sorted(fn.keywords.items())), depth)
        return
    code = getattr(fn, "__code__", None)
    if code is None:
        # a built-in (torch.sum, math.cos) or another callable: its name,
        # which, unlike its repr, is the same in every process
        name = getattr(fn, "__qualname__", None)
        h.update((f"{getattr(fn, '__module__', None)}.{name}" if name
                  else repr(fn)).encode())
        return
    _hash_code(h, code, depth)
    _hash_value(h, getattr(fn, "__defaults__", None), depth)
    try:
        cells = tuple(c.cell_contents for c in (fn.__closure__ or ()))
    except ValueError:                          # unfilled cell
        h.update(b"<cell>")
        return
    _hash_value(h, cells, depth)


@dataclasses.dataclass(frozen=True)
class Problem:
    """A named objective with bounds and sense — frozen and hashable.

    ``lo``/``hi`` may be scalars or length-D tuples; a ``bounds=(lo, hi)``
    pair may be passed instead of the two fields.
    """

    name: str
    fn: Callable
    lo: Bound = -100.0
    hi: Bound = 100.0
    sense: str = "max"
    kernel_fn: Optional[Callable] = None
    constraints: Optional[object] = None   # constraints.ConstraintSet
    bounds: dataclasses.InitVar[Optional[Tuple[Bound, Bound]]] = None

    def __post_init__(self, bounds):
        lo, hi = bounds if bounds is not None else (self.lo, self.hi)
        lo, hi = broadcast_bounds(_norm_bound(lo), _norm_bound(hi))
        if isinstance(lo, tuple):
            if len(lo) != len(hi):
                raise ValueError(
                    f"lo/hi lengths differ: {len(lo)} vs {len(hi)}")
            bad = not all(l <= h for l, h in zip(lo, hi))
        else:
            bad = not lo <= hi
        if bad:
            raise ValueError(f"need lo <= hi elementwise, got {lo} / {hi}")
        if self.sense not in ("min", "max"):
            raise ValueError(
                f"sense must be 'min' or 'max', got {self.sense!r}")
        if not (isinstance(self.name, str) and self.name):
            raise ValueError("Problem.name must be a non-empty string")
        if not callable(self.fn):
            raise TypeError("Problem.fn must be callable")
        if self.constraints is not None:
            from .constraints import ConstraintSet
            if not isinstance(self.constraints, ConstraintSet):
                raise TypeError(
                    f"constraints must be a repro_torch.core.constraints."
                    f"ConstraintSet, got {self.constraints!r}")
            if self.kernel_fn is not None:
                raise ValueError(
                    "kernel_fn and constraints are mutually exclusive: a "
                    "hand-written kernel form cannot apply the penalty/"
                    "projection (drop kernel_fn; the split path evaluates "
                    "the constrained objective itself)")
        if self.kernel_fn is not None and not callable(self.kernel_fn):
            raise TypeError("Problem.kernel_fn must be callable")
        object.__setattr__(self, "lo", lo)
        object.__setattr__(self, "hi", hi)

    @property
    def max_fn(self) -> Callable:
        """``fn`` in the engine's canonical maximization convention, with
        the penalty term of a ``mode="penalty"`` constraint set
        (``max_fn(x) = canonical fn(x) - weight * violation(x)``); cached
        on the instance so repeated accesses return the same object."""
        cset = self.constraints
        penalized = cset is not None and cset.mode == "penalty"
        if self.sense == "max" and not penalized:
            return self.fn
        cached = self.__dict__.get("_max_fn")
        if cached is None:
            fn = self.fn
            neg = self.sense == "min"
            if penalized:
                from .fitness import weak
                viol = cset.violation_fn()
                weight = cset.weight

                def cached(pos):
                    f = fn(pos)
                    if neg:
                        f = -f
                    return f - weak(weight, f.dtype) * viol(pos)

                cached.__name__ = f"penalized_{getattr(fn, '__name__', 'fn')}"
            else:
                def cached(pos):
                    return -fn(pos)

                cached.__name__ = f"neg_{getattr(fn, '__name__', 'fn')}"
            object.__setattr__(self, "_max_fn", cached)
        return cached

    def user_value(self, canonical_fit):
        """Map a canonical (maximized) fitness back to the user's sense; for
        a penalty-mode problem at a feasible point that is the objective."""
        return -canonical_fit if self.sense == "min" else canonical_fit

    @property
    def constrained(self) -> bool:
        return self.constraints is not None

    @property
    def projection_fn(self) -> Optional[Callable]:
        """The feasibility projection ``pos[..., D] -> pos`` (applied after
        the box clip), or None for every mode but "projection"."""
        cset = self.constraints
        if cset is not None and cset.mode == "projection":
            return cset.projection
        return None

    @property
    def violation_fn(self) -> Optional[Callable]:
        """Aggregate violation ``pos[..., D] -> viol[...]``, or None when
        unconstrained."""
        cset = self.constraints
        return None if cset is None else cset.violation_fn()

    @property
    def deb(self) -> bool:
        """Whether the pbest fold takes the Deb rule: the projection and
        repair modes (penalty mode keeps the raw fitness fold)."""
        return self.constrained and self.constraints.mode != "penalty"

    def violation_at(self, pos) -> float:
        """Violation of one position vector (0.0 if unconstrained)."""
        vf = self.violation_fn
        return 0.0 if vf is None else float(vf(pos))

    def with_penalty_weight(self, weight: float) -> "Problem":
        """This problem at another penalty weight (a ramp segment)."""
        if self.constraints is None or self.constraints.mode != "penalty":
            raise ValueError("with_penalty_weight needs a penalty-mode "
                             "constraint set")
        return dataclasses.replace(
            self, constraints=self.constraints.with_weight(weight))

    @property
    def ndim(self) -> Optional[int]:
        """Dimensionality pinned by per-dimension bounds (None if scalar)."""
        return len(self.lo) if isinstance(self.lo, tuple) else None

    def cache_key(self) -> str:
        """Content hash for serving batch keys and lane program keys, as in
        ``repro``: the objective's code (bytecode, constants, closure
        values, defaults, nested functions; tensors and arrays by their raw
        bytes, never their repr), ``kernel_fn``, bounds, sense and the
        constraint set's content, not the object's identity. Two problems
        under one name that compute different things never share a key;
        re-built identical ones do, in any process. The string is not the
        reference's (a torch objective is other code than a jnp one).
        Memoized on the frozen instance."""
        cached = self.__dict__.get("_cache_key")
        if cached is None:
            h = hashlib.sha1()
            _hash_value(h, (self.name, self.sense, self.lo, self.hi))
            for fn in (self.fn, self.kernel_fn):
                _hash_value(h, fn)
            if self.constraints is not None:
                _hash_value(h, self.constraints._content())
            cached = h.hexdigest()[:16]
            object.__setattr__(self, "_cache_key", cached)
        return cached


_REGISTRY: Dict[str, Problem] = {}


def register_problem(problem: Union[Problem, str], fn: Callable = None, *,
                     overwrite: bool = False, **kwargs) -> Problem:
    """Register a Problem under its name: ``register_problem(Problem(...))``
    or ``register_problem("mine", f, lo=-1.0, hi=1.0, sense="min")``.
    Re-registering an identical Problem is a no-op; different content under
    an existing name raises unless ``overwrite=True``."""
    if isinstance(problem, str):
        problem = Problem(name=problem, fn=fn, **kwargs)
    elif fn is not None or kwargs:
        raise TypeError("pass either a Problem or (name, fn, **fields)")
    old = _REGISTRY.get(problem.name)
    if old is not None and old != problem and not overwrite:
        raise ValueError(
            f"problem {problem.name!r} already registered with different "
            f"content; pass overwrite=True to replace it")
    _REGISTRY[problem.name] = problem
    return problem


def get_problem(name: str) -> Problem:
    # registers the six built-ins and the sphere-on-simplex problems
    from . import constraints, fitness  # noqa: F401
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown problem {name!r}; registered: "
            f"{', '.join(sorted(_REGISTRY)) or '<none>'}") from None


def list_problems() -> Tuple[str, ...]:
    from . import constraints, fitness  # noqa: F401
    return tuple(sorted(_REGISTRY))


def resolve_problem(obj: Union[str, Problem, Callable]) -> Problem:
    """str -> registry lookup; Problem -> itself; bare callable -> an
    anonymous max-sense Problem with the default [-100, 100] box."""
    if isinstance(obj, Problem):
        return obj
    if isinstance(obj, str):
        return get_problem(obj)
    if callable(obj):
        return Problem(name=getattr(obj, "__name__", "anonymous"), fn=obj)
    raise TypeError(f"cannot resolve {obj!r} to a Problem")
