"""The solve facade, single swarm: ``repro_torch.solve(problem, ...) ->
Result``, the port of ``repro.api``.

    import repro_torch

    res = repro_torch.solve("cubic", dim=120, particles=32768, iters=200,
                            variant="async")          # on the CUDA card
    res = repro_torch.solve("cubic", iters=10, device="cpu")

``Method`` picks the aggregation variant and the backend:

* ``variant``: ``reduction | queue | queue_lock | async`` (paper §3.2/§4).
* ``backend``: ``eager`` (the PyTorch engine, ``core/pso.py``), ``kernel``
  (the hand-written CUDA kernels; only ``queue_lock``/``async`` exist as
  kernels), or ``auto`` — the kernel for those two variants on a CUDA
  device, eager otherwise.

``device=None`` means the card; without one, ``solve`` raises instead of
falling back to the CPU. Results are reported in the problem's own sense.
Features of ``repro.api`` that are not ported yet raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from . import _device
from .core.problem import Problem, resolve_problem
from .core.pso import (ASYNC_SYNC_EVERY, VARIANTS, PSOConfig, SwarmState,
                       init_swarm, run)
from .core.update_rules import TOPOLOGIES, resolve_rule

_KERNEL_VARIANTS = ("queue_lock", "async")
_BACKENDS = ("auto", "eager", "kernel")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: ROADMAP.md, port order "
        f"item {item}")


@dataclasses.dataclass(frozen=True)
class Method:
    """How to run a solve: aggregation variant + execution backend.

    ``sync_every`` is the async variant's publication interval; ``block_n``
    the particle-block size (kernel CTAs; the eager async engine takes the
    matching block count). ``islands``, ``record_history``, ``telemetry``,
    ``schedule="auto"`` and the lbest ``topology`` values are accepted only
    at their defaults until the port carries them.
    """

    variant: str = "queue"
    backend: str = "auto"                 # auto | eager | kernel
    sync_every: int = ASYNC_SYNC_EVERY
    block_n: Optional[int] = None
    islands: int = 0
    exchange_interval: int = 1
    record_history: bool = False
    telemetry: bool = False
    schedule: str = "fixed"
    rule: str = "pso"
    topology: str = "gbest"

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(
                f"unknown variant {self.variant!r}; one of {VARIANTS}")
        if self.backend not in _BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; one of {_BACKENDS}")
        if self.backend == "kernel" and self.variant not in _KERNEL_VARIANTS:
            raise ValueError(
                f"backend='kernel' implements {_KERNEL_VARIANTS}, not "
                f"{self.variant!r}; use backend='eager'/'auto'")
        if self.schedule not in ("fixed", "auto"):
            raise ValueError(
                f"unknown schedule {self.schedule!r}; one of fixed|auto")
        resolve_rule(self.rule)
        if self.topology not in TOPOLOGIES:
            raise ValueError(
                f"unknown topology {self.topology!r}; one of {TOPOLOGIES}")
        if self.islands < 0 or self.exchange_interval < 1:
            raise ValueError(
                f"islands={self.islands} must be >= 0 and "
                f"exchange_interval={self.exchange_interval} >= 1")
        if self.sync_every < 1:
            raise ValueError(f"sync_every={self.sync_every} must be >= 1")
        if self.schedule == "auto":
            raise _not_ported("schedule='auto' (the autotuner)", "9")
        if self.topology != "gbest":
            raise _not_ported(f"topology={self.topology!r}", "4 (topologies)")
        if self.telemetry:
            raise _not_ported("telemetry=True", "5 (telemetry counters)")
        if self.record_history:
            raise _not_ported("record_history=True", "5 (telemetry counters)")
        if self.islands:
            raise _not_ported("islands", "7 (islands and the CLI)")

    def resolve_backend(self, device: torch.device) -> str:
        if self.backend != "auto":
            return self.backend
        if self.variant in _KERNEL_VARIANTS and device.type == "cuda":
            return "kernel"
        return "eager"


@dataclasses.dataclass(frozen=True, eq=False)
class Result:
    """A finished solve. ``best_fit``/``best_pos`` are in the problem's own
    sense; ``state`` is the raw (canonical-max) SwarmState for resuming."""

    problem: Problem
    config: PSOConfig
    method: Method
    iters: int
    state: SwarmState

    @property
    def best_fit(self) -> float:
        return float(self.problem.user_value(self.state.gbest_fit))

    @property
    def best_pos(self) -> np.ndarray:
        return self.state.gbest_pos.detach().cpu().numpy()

    @property
    def gbest_fit(self) -> float:
        """Canonical (maximized) fitness, as the engine tracks it."""
        return float(self.state.gbest_fit)


def _make_method(method: Optional[Method], **loose) -> Method:
    given = {k: v for k, v in loose.items() if v is not None}
    if method is not None:
        if given:
            raise ValueError(
                f"pass either method= or the loose kwargs {sorted(given)}, "
                f"not both")
        return method
    return Method(**given)


def _make_config(problem: Problem, dim, particles, w, c1, c2, dtype,
                 min_pos, max_pos, max_v, m: Method) -> PSOConfig:
    kw = dict(dim=(problem.ndim or 1) if dim is None else dim,
              particle_cnt=particles, fitness=problem, dtype=dtype,
              min_pos=min_pos, max_pos=max_pos, max_v=max_v,
              update_rule=m.rule, topology=m.topology)
    for k, v in (("w", w), ("c1", c1), ("c2", c2)):
        if v is not None:
            kw[k] = v
    return PSOConfig(**kw).resolved()


def solve(problem: Union[str, Problem], *,
          dim: Optional[int] = None, particles: int = 1024,
          iters: int = 1000, seed: int = 0,
          method: Optional[Method] = None,
          variant: Optional[str] = None, backend: Optional[str] = None,
          sync_every: Optional[int] = None, block_n: Optional[int] = None,
          w: Optional[float] = None, c1: Optional[float] = None,
          c2: Optional[float] = None, dtype: str = "float32",
          min_pos=None, max_pos=None, max_v=None,
          record_history: Optional[bool] = None,
          schedule: Optional[str] = None, rule: Optional[str] = None,
          topology: Optional[str] = None, telemetry: Optional[bool] = None,
          device=None) -> Result:
    """Solve ``problem`` with ``particles`` particles for ``iters``
    iterations on ``device`` (``None``: the CUDA card). Pass either
    ``method=Method(...)`` or the loose ``variant=``/``backend=``/...
    kwargs, not both. ``dim`` defaults to the problem's per-dimension bound
    length (else 1)."""
    dev = _device.resolve(device)
    prob = resolve_problem(problem)
    m = _make_method(method, variant=variant, backend=backend,
                     sync_every=sync_every, block_n=block_n,
                     record_history=record_history, schedule=schedule,
                     rule=rule, topology=topology, telemetry=telemetry)
    cfg = _make_config(prob, dim, particles, w, c1, c2, dtype, min_pos,
                       max_pos, max_v, m)
    state = init_swarm(cfg, seed, device=dev)
    state = _run_segmented(cfg, state, iters, m)
    return Result(problem=prob, config=cfg, method=m, iters=iters,
                  state=state)


def _run_segmented(cfg: PSOConfig, state: SwarmState, iters: int,
                   m: Method) -> SwarmState:
    """The seam where the reference's penalty ramp splits a run into
    static-weight segments; without constraints there is one segment."""
    return _run_state(cfg, state, iters, m)


def _run_state(cfg: PSOConfig, state: SwarmState, iters: int,
               m: Method) -> SwarmState:
    """One static-weight segment on the resolved backend."""
    if m.resolve_backend(state.pos.device) == "kernel":
        return _run_state_kernel(cfg, state, iters, m)
    n_blocks = (max(1, state.pos.shape[0] // m.block_n)
                if m.variant == "async" and m.block_n else None)
    return run(cfg, state, iters, m.variant, sync_every=m.sync_every,
               n_blocks=n_blocks)


def _run_state_kernel(cfg: PSOConfig, state: SwarmState, iters: int,
                      m: Method) -> SwarmState:
    """The kernel-backend segment: one fused launch, or the async
    kernel's launches (a remainder of ``iters % sync_every`` is a second
    launch)."""
    from .kernels.ops import run_queue_lock_fused, run_queue_lock_fused_async
    if m.variant == "async":
        return run_queue_lock_fused_async(cfg, state, iters,
                                          sync_every=m.sync_every,
                                          block_n=m.block_n)
    return run_queue_lock_fused(cfg, state, iters, block_n=m.block_n)


def solve_many(*args, **kwargs):
    """Batched solves: not ported yet."""
    raise _not_ported("solve_many", "2 (batched and hetero kernels)")


def solve_stream(*args, **kwargs):
    """Continuous-batching serving: not ported yet."""
    raise _not_ported("solve_stream", "6 (serving)")


def best(results: Sequence[Result]) -> Result:
    """The best Result of a batch: the highest canonical fitness (every
    ported problem is unconstrained, so the reference's Deb rule reduces to
    this)."""
    results = list(results)
    if not results:
        raise ValueError("best() of no results")
    return max(results, key=lambda r: r.gbest_fit)
