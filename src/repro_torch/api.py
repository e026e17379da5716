"""The solve facade: ``repro_torch.solve(problem, ...) -> Result`` and
``repro_torch.solve_many(problem, seeds, ...) -> [Result]``, the port of
``repro.api``.

    import repro_torch

    res = repro_torch.solve("cubic", dim=120, particles=32768, iters=200,
                            variant="async")          # on the CUDA card
    res = repro_torch.solve("cubic", iters=10, device="cpu")
    rows = repro_torch.solve_many("rastrigin", seeds=range(128), dim=10,
                                  iters=200, variant="async")

``Method`` picks the aggregation variant and the backend:

* ``variant``: ``reduction | queue | queue_lock | async`` (paper §3.2/§4).
* ``backend``: ``eager`` (the PyTorch engine, ``core/pso.py``), ``kernel``
  (the hand-written CUDA kernels; only ``queue_lock``/``async`` exist as
  kernels, and they carry the rules ``pso``, ``sso`` and ``lowcost``), or
  ``auto`` — the kernel for those two variants and rules on a CUDA
  device (on any device with ``telemetry=True``), eager otherwise. The
  kernel backend takes every Problem: the six unconstrained built-ins on
  their own kernels, any other (custom objectives, ``kernel_fn``, every
  constraint mode) on the split path (``kernels/pso_split.py``).
* ``topology`` (async only): ``gbest``, the paper's star, or the lbest
  ``ring``/``vonneumann``, where each particle block pulls the best of its
  neighbour blocks' local bests instead of gbest (``core/topology.py``).
* ``record_history``: ``Result.history``, gbest at every sync point;
  ``telemetry``: ``Result.telemetry``, the kernels' contention counters
  (``repro_torch.telemetry``; on the CPU the kernel backend's plain
  versions count).
* ``islands=k``: the swarm split into k equal islands of contiguous rows
  on the one device (``core/distributed.py``), each iterating locally and
  exchanging its best every ``exchange_interval`` iterations: the
  ``_pmax_best`` reduction for the synchronous variants (on the kernel
  backend each island's steps launch the fused kernel), the island ring
  for ``async`` (the eager engine).

Constrained problems (``core/constraints.py``): ``Result.violation``,
``feasible`` and ``first_feasible_iter`` report feasibility, ``best``
ranks by Deb's rule, and a penalty set with ``ramp``/``ramp_every`` runs
as segments of one weight each, the carried fitness re-weighted at every
boundary (``_ramp_loop``), on either backend.

``solve_stream(requests, ...)`` serves a stream of ``SolveRequest``s
through the continuous-batching scheduler (``repro_torch.serving``).

``device=None`` means the card; without one, ``solve`` raises instead of
falling back to the CPU. Results are reported in the problem's own sense.
``schedule="auto"`` (``Method``) lets the roofline autotuner
(``core.autotune``) pick the execution schedule of each solve shape.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import _device
from .core.multi_swarm import (ProblemRows, SwarmBatch, batch_rows,
                               init_batch, problem_rows, run_many,
                               run_many_with_history)
from .core.problem import Problem, resolve_problem
from .core.pso import (ASYNC_SYNC_EVERY, VARIANTS, PSOConfig, SwarmState,
                       hetero_member_config, init_swarm, run,
                       run_with_history)
from .core.update_rules import (TOPOLOGIES, kernel_carries, kernel_rule_id,
                                 resolve_rule)
from .telemetry import KernelCounters
from .telemetry.counters import _host

_KERNEL_VARIANTS = ("queue_lock", "async")
_BACKENDS = ("auto", "eager", "kernel")


@dataclasses.dataclass(frozen=True)
class Method:
    """How to run a solve: aggregation variant + execution backend.

    ``sync_every`` is the async variant's publication interval; ``block_n``
    the particle-block size (kernel CTAs; the eager async engine takes the
    matching block count). ``record_history`` fills ``Result.history`` (gbest
    per sync point, any backend); ``telemetry`` fills ``Result.telemetry``
    (the kernel backend only). ``topology`` is the async variant's pull at
    a sync point: ``gbest`` (the star), or the lbest ``ring`` and
    ``vonneumann`` (``variant="async"`` only). ``islands > 0`` splits the
    swarm into that many islands on the one device (``core.distributed``;
    the reference shards them over devices and refuses more islands than
    it has): synchronous variants exchange the best every
    ``exchange_interval`` iterations, ``async`` exchanges over the island
    ring. ``schedule="auto"`` asks the roofline autotuner
    (``core.autotune``) for the ``(variant, backend, block_n,
    sync_every)`` schedule of each solve shape: the cost model ranks the
    candidates, the top few and the fixed default run timed micro-runs, and
    the pick is cached per shape on disk. Under ``schedule="auto"`` the
    ``variant`` field only keeps an lbest ``topology`` on ``async``.
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
        if self.schedule == "auto" and self.islands:
            raise ValueError(
                "schedule='auto' tunes single-device schedules; the island "
                "runners pick their own block layout — use schedule='fixed'")
        resolve_rule(self.rule)
        if self.backend == "kernel" or self.telemetry:
            kernel_rule_id(self.rule)     # raises naming the kernel rules
        if self.telemetry and self.variant not in _KERNEL_VARIANTS:
            raise ValueError(
                f"telemetry counters are collected inside the fused CUDA "
                f"kernels, which implement {_KERNEL_VARIANTS} — "
                f"variant={self.variant!r} has no kernel to count in")
        if self.telemetry and self.backend == "eager":
            raise ValueError(
                "telemetry counters are collected inside the fused CUDA "
                "kernels; use backend='kernel' or 'auto' (auto resolves to "
                "the kernel when telemetry is on)")
        if self.telemetry and self.islands:
            raise ValueError(
                "telemetry counters are single-device only (the island "
                "runners do not thread the counter outputs)")
        if self.record_history and self.islands:
            raise ValueError(
                "record_history is single-device only (the island runners "
                "do not surface per-iteration gbest); drop islands= or "
                "record the trajectory from a single-device solve")
        if self.topology not in TOPOLOGIES:
            raise ValueError(
                f"unknown topology {self.topology!r}; one of {TOPOLOGIES}")
        if self.topology != "gbest" and self.variant != "async":
            raise ValueError(
                f"topology={self.topology!r} generalizes the async "
                f"variant's block-local pull; variant={self.variant!r} has "
                f"no block-local bests — use variant='async' (lbest "
                f"topologies: {TOPOLOGIES[1:]})")
        if self.islands < 0 or self.exchange_interval < 1:
            raise ValueError(
                f"islands={self.islands} must be >= 0 and "
                f"exchange_interval={self.exchange_interval} >= 1")
        if self.backend == "kernel" and self.islands and \
                self.variant == "async":
            raise ValueError(
                "async islands run the eager ring local loop; use "
                "backend='auto'/'eager' (the CUDA async kernel has no "
                "island ring)")
        if self.sync_every < 1:
            raise ValueError(f"sync_every={self.sync_every} must be >= 1")

    def resolve_backend(self, device: torch.device) -> str:
        if self.backend != "auto":
            return self.backend
        if self.telemetry:
            # the contention counters only exist in the kernels (and, on
            # the CPU, in their plain versions)
            return "kernel"
        # A rule the CUDA kernels lack runs on the eager engine; every
        # Problem has a kernel path (the built-ins' or the split path).
        if self.variant in _KERNEL_VARIANTS and device.type == "cuda" \
                and kernel_carries(self.rule):
            return "kernel"
        return "eager"

    def resolve_schedule(self, problem, d: int, n: int, iters: int, *,
                         device=None, dtype: str = "float32", batch: int = 1,
                         hetero_table: int = 0, measure: bool = True):
        """The grown form of ``resolve_backend``: a full execution schedule
        for one solve shape on ``device`` (None: the card).
        ``schedule="fixed"`` returns this Method's own knobs (backend by the
        fixed rule); ``schedule="auto"`` asks the roofline autotuner:
        cost-model ranking, measured micro-run fallback (``measure=False``
        stops at the model), on-disk cache per shape."""
        from .core.autotune import Schedule, resolve_schedule
        dev = _device.resolve(device)
        if self.schedule != "auto":
            return Schedule(variant=self.variant,
                            backend=self.resolve_backend(dev),
                            block_n=self.block_n,
                            sync_every=self.sync_every, source="fixed")
        kernel_ok = None
        if self.backend == "eager":
            kernel_ok = False
        elif self.backend == "kernel" or self.telemetry:
            kernel_ok = True
        return resolve_schedule(
            problem, d, n, iters, dtype=dtype, batch=batch,
            hetero_table=hetero_table, record_history=self.record_history,
            measure=measure, kernel_ok=kernel_ok, rule=self.rule,
            device=dev)


def _effective_method(m: Method, problem, cfg: PSOConfig, iters: int,
                      device: torch.device, batch: int = 1,
                      hetero_table: int = 0) -> Method:
    """Collapse ``schedule="auto"`` into a concrete fixed Method through the
    autotuner (one resolution a solve, covering every ramp segment)."""
    if m.schedule != "auto":
        return m
    s = m.resolve_schedule(problem, cfg.dim, cfg.particle_cnt, iters,
                           device=device, dtype=cfg.dtype, batch=batch,
                           hetero_table=hetero_table)
    # lbest topologies only exist on the async variant's block-local
    # machinery: the tuner may not migrate such a request off async
    variant = s.variant if m.topology == "gbest" else m.variant
    return dataclasses.replace(m, variant=variant, backend=s.backend,
                               block_n=s.block_n, sync_every=s.sync_every,
                               schedule="fixed")


@dataclasses.dataclass(frozen=True, eq=False)
class History:
    """Convergence history: the gbest trajectory sampled at sync points
    (every iteration for the synchronous variants, every publication
    boundary for ``async``). ``violation`` is the recorded gbest's
    aggregate constraint violation, None for unconstrained problems."""

    iteration: np.ndarray              # [K] absolute iteration numbers
    gbest_fit: np.ndarray              # [K] canonical (maximized) fitness
    violation: Optional[np.ndarray]    # [K] or None (unconstrained)

    def __len__(self) -> int:
        return len(self.iteration)


@dataclasses.dataclass(frozen=True, eq=False)
class Result:
    """A finished solve. ``best_fit``/``best_pos`` are in the problem's own
    sense; ``state`` is the raw (canonical-max) SwarmState for resuming.
    ``history`` holds the gbest trajectory when the solve ran with
    ``Method(record_history=True)``, ``telemetry`` the kernels' contention
    counters (``repro_torch.telemetry.KernelCounters``) with
    ``Method(telemetry=True)``."""

    problem: Problem
    config: PSOConfig
    method: Method
    iters: int
    state: SwarmState
    history: Optional[History] = None
    telemetry: Optional[KernelCounters] = None

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

    @property
    def violation(self) -> float:
        """Aggregate constraint violation at ``best_pos`` (0.0 when
        unconstrained or exactly feasible)."""
        return self.problem.violation_at(self.state.gbest_pos)

    @property
    def feasible(self) -> bool:
        """True iff ``best_pos`` satisfies every constraint (always for
        unconstrained problems)."""
        return self.violation <= 0.0

    @property
    def first_feasible_iter(self) -> Optional[int]:
        """The first recorded iteration whose gbest was feasible, or None
        (never feasible, or no history recorded); 0 for unconstrained
        problems, feasible from the start."""
        if not self.problem.constrained:
            return 0
        if self.history is None or self.history.violation is None:
            return None
        feas = np.flatnonzero(self.history.violation <= 0.0)
        return int(self.history.iteration[feas[0]]) if feas.size else None


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
    m = _effective_method(m, prob, cfg, iters, dev)
    if m.islands:
        state = _run_islands(prob, cfg, seed, iters, m, dev)
        hist = tel = None
    else:
        state = init_swarm(cfg, seed, device=dev)
        state, hist, tel = _run_segmented(prob, cfg, state, iters, m)
    return Result(problem=prob, config=cfg, method=m, iters=iters,
                  state=state, history=hist, telemetry=tel)


def _ramp_segments(iters: int, cset):
    """(iterations, penalty weight) of each segment of the penalty ramp:
    segment k of ``ramp_every`` iterations runs at ``weight * ramp**k``;
    one ``(iters, None)`` segment (the problem as it is) without a ramp."""
    if (cset is None or cset.mode != "penalty" or cset.ramp_every <= 0
            or cset.ramp == 1.0):
        return [(iters, None)]
    segs, done, k = [], 0, 0
    while done < iters:
        n = min(cset.ramp_every, iters - done)
        segs.append((n, cset.weight * (cset.ramp ** k)))
        done += n
        k += 1
    return segs


def _reweight_state(cfg: PSOConfig, state: SwarmState) -> SwarmState:
    """The carried fitness re-evaluated at a new penalty weight (a ramp
    boundary): current, pbest and block-local fitness from their
    positions, gbest re-selected from the re-weighted pbests, so gbest ==
    max(pbest) holds at every weight. A batch re-selects per row."""
    fn = cfg.fitness_fn
    fit = fn(state.pos)
    pbf = fn(state.pbest_pos)
    b = torch.argmax(pbf, -1, keepdim=True)
    gp = state.pbest_pos.gather(
        -2, b[..., None].expand(*b.shape, state.pbest_pos.shape[-1]))
    state = state._replace(fit=fit, pbest_fit=pbf,
                           gbest_pos=gp[..., 0, :],
                           gbest_fit=pbf.gather(-1, b)[..., 0])
    if state.lbest_fit is not None:
        state = state._replace(lbest_fit=fn(state.lbest_pos))
    return state


def _ramp_loop(prob: Problem, cfg: PSOConfig, state, iters: int, run_seg,
               reweight=_reweight_state):
    """The penalty-ramp scheduler: each segment a static-weight run on any
    backend, the carried fitness of ``state`` (a swarm or a batch)
    re-weighted at the boundaries (``reweight(cfg, state) -> state``).
    ``run_seg(cfg, state, k) -> (state, history or None)``. Returns
    (state, [history, ...])."""
    hists = []
    for j, (seg_iters, weight) in enumerate(
            _ramp_segments(iters, prob.constraints)):
        cfg_k = cfg
        if weight is not None:
            cfg_k = dataclasses.replace(
                cfg, fitness=prob.with_penalty_weight(weight))
            if j:
                state = reweight(cfg_k, state)
        state, h = run_seg(cfg_k, state, seg_iters)
        if h is not None:
            hists.append(h)
    return state, hists


def _run_islands(prob: Problem, cfg: PSOConfig, seed: int, iters: int,
                 m: Method, dev: torch.device) -> SwarmState:
    """The island path: ``init_sharded_swarm`` once, then one
    ``make_distributed_run`` a penalty-ramp segment (one without a ramp).
    On the kernel backend the synchronous variants' local step is the
    fused kernel (``ops.make_fused_local_step``)."""
    from .core.distributed import init_sharded_swarm, make_distributed_run
    local_step = None
    if m.variant != "async" and m.resolve_backend(dev) == "kernel":
        from .kernels.ops import make_fused_local_step
        local_step = make_fused_local_step(block_n=m.block_n)
    state = init_sharded_swarm(cfg, seed, m.islands, device=dev)

    def run_seg(cfg_k: PSOConfig, s: SwarmState, seg_iters: int):
        runner = make_distributed_run(
            cfg_k, m.islands, iters=seg_iters, variant=m.variant,
            exchange_interval=m.exchange_interval, local_step_fn=local_step,
            sync_every=m.sync_every)
        return runner(s), None

    def reweight(cfg_k: PSOConfig, s: SwarmState) -> SwarmState:
        # every ring segment seeds its islands' block locals anew
        return _reweight_state(cfg_k, s._replace(lbest_pos=None,
                                                 lbest_fit=None))

    state, _ = _ramp_loop(prob, cfg, state, iters, run_seg, reweight)
    return state


def _sum_counters(cnts):
    """Per-segment counter records folded into one (None when empty)."""
    total = None
    for c in cnts:
        total = c if total is None else total + c
    return total


def _run_segmented(prob: Problem, cfg: PSOConfig, state: SwarmState,
                   iters: int, m: Method):
    """``_run_state`` over the ramp's segments (one without a ramp).
    Returns (state, History or None, KernelCounters or None)."""
    cnts = []

    def seg(c, s, k):
        s, h, cnt = _run_state(c, s, k, m)
        if cnt is not None:
            cnts.append(cnt)
        return s, h

    state, hists = _ramp_loop(prob, cfg, state, iters, seg)
    tel = _sum_counters(cnts)
    if not hists:
        return state, None, tel
    return state, History(
        iteration=np.concatenate([np.asarray(h[0], dtype=np.int64)
                                  for h in hists]),
        gbest_fit=np.concatenate([h[1] for h in hists]),
        violation=(None if hists[0][2] is None
                   else np.concatenate([h[2] for h in hists]))), tel


def _eager_async_blocks(m: Method, n: int) -> Optional[int]:
    """The eager engine takes a block COUNT where the kernels take a block
    size: translate ``block_n`` for the async variant."""
    if m.variant != "async" or not m.block_n:
        return None
    return max(1, n // m.block_n)


def _kernel_history(cfg: PSOConfig, its, fits, gps):
    """A kernel segment's ``(iterations, gbest_fit, violations or None)``
    on the host (None without a history): the violations of the sampled
    gbest positions ``gps`` where they were sampled."""
    if its is None:
        return None
    vf = cfg.problem.violation_fn
    return its, _host(fits), None if gps is None else _host(vf(gps))


def _run_state(cfg: PSOConfig, state: SwarmState, iters: int, m: Method):
    """One static-weight segment on the resolved backend -> (state,
    (iterations, gbest_fit, violations or None) or None, KernelCounters or
    None)."""
    if m.resolve_backend(state.pos.device) == "kernel":
        return _run_state_kernel(cfg, state, iters, m)
    blocks = _eager_async_blocks(m, state.pos.shape[0])
    if m.record_history:
        state, (its, fits, viols) = run_with_history(
            cfg, state, iters, m.variant, sync_every=m.sync_every,
            n_blocks=blocks)
        return state, (its, _host(fits),
                       None if viols is None else _host(viols)), None
    return run(cfg, state, iters, m.variant, sync_every=m.sync_every,
               n_blocks=blocks), None, None


def _run_state_kernel(cfg: PSOConfig, state: SwarmState, iters: int,
                      m: Method):
    """The kernel-backend segment (``ops.run_queue_lock``): one fused
    launch, or the async kernel's launches (a remainder of ``iters %
    sync_every`` is a second launch), optionally with the contention
    counters. With a history, one launch a sync point on operands packed
    once: bit for bit the uninterrupted run for the fused kernel, whose
    launches are iteration-major, and for async with one block; with
    several async blocks the chunk seams make a more synchronous
    interleaving, as in the reference. Counters add up over the
    launches."""
    from .kernels import ops
    positions = cfg.problem.constrained
    state, hist, cnt = ops.run_queue_lock(
        cfg, state, iters, m.variant, sync_every=m.sync_every,
        block_n=m.block_n, telemetry=m.telemetry, history=m.record_history,
        positions=positions)
    hist = _kernel_history(cfg, *(hist if positions else (*hist, None)))
    return state, hist, (
        None if cnt is None else KernelCounters.from_array(cnt))


def solve_many(problem: Union[str, Problem, None] = None,
               seeds: Sequence[int] = (), *,
               problems: Optional[Sequence[Union[str, Problem]]] = None,
               dim: Optional[int] = None, particles: int = 1024,
               iters: int = 1000, method: Optional[Method] = None,
               variant: Optional[str] = None, backend: Optional[str] = None,
               sync_every: Optional[int] = None,
               block_n: Optional[int] = None, coeffs: Optional[Tuple] = None,
               w: Optional[float] = None, c1: Optional[float] = None,
               c2: Optional[float] = None, dtype: str = "float32",
               min_pos=None, max_pos=None, max_v=None,
               record_history: Optional[bool] = None,
               schedule: Optional[str] = None, rule: Optional[str] = None,
               topology: Optional[str] = None,
               telemetry: Optional[bool] = None, device=None) -> List[Result]:
    """One independent solve per entry of ``seeds``, advanced together on
    ``device`` (``None``: the CUDA card): the batched eager engine, or the
    batched CUDA kernels for ``queue_lock``/``async`` on the kernel backend.
    Row ``s`` is ``solve(problem, seed=seeds[s], ...)`` with the same
    method when ``coeffs`` is None (on the kernel backend up to the
    multi-block async race). Returns one ``Result`` per seed.

    ``coeffs=(w, c1, c2)``, each of length S, gives every swarm its own
    coefficients; only the eager engine takes them. ``problems=`` (instead
    of ``problem``) makes the batch heterogeneous: row ``s`` solves
    ``problems[s]``, a registered built-in, with its own objective and box
    bounds, so the ``min_pos``/``max_pos``/``max_v`` overrides are
    rejected. A penalty ramp applies to homogeneous batches (a
    heterogeneous batch's members keep their weights, as in the
    reference)."""
    dev = _device.resolve(device)
    m = _make_method(method, variant=variant, backend=backend,
                     sync_every=sync_every, block_n=block_n,
                     record_history=record_history, schedule=schedule,
                     rule=rule, topology=topology, telemetry=telemetry)
    if m.islands:
        raise ValueError("islands split ONE swarm; use solve() — "
                         "solve_many batches independent swarms instead")
    if (problem is None) == (problems is None):
        raise ValueError(
            "pass exactly one of problem= (homogeneous batch) or "
            "problems= (one problem per seed)")
    seeds = [int(sd) for sd in seeds]
    if problems is not None:
        return _solve_many_hetero(problems, seeds, m, dim, particles, iters,
                                  coeffs, w, c1, c2, dtype, min_pos,
                                  max_pos, max_v, dev)
    prob = resolve_problem(problem)
    cfg = _make_config(prob, dim, particles, w, c1, c2, dtype, min_pos,
                       max_pos, max_v, m)
    m = _effective_method(m, prob, cfg, iters, dev, batch=len(seeds))
    cnts = []

    def seg(c, b, k):
        b, h, cnt = _run_batch(c, b, k, m, coeffs)
        if cnt is not None:
            cnts.append(cnt)
        return b, h

    batch, hists = _ramp_loop(prob, cfg, init_batch(cfg, seeds, device=dev),
                              iters, seg)
    return [Result(problem=prob, config=cfg, method=m, iters=iters,
                   state=row, history=h, telemetry=t)
            for row, h, t in zip(batch_rows(batch),
                                 _row_histories(hists, batch.swarm_cnt),
                                 _row_counters(cnts, batch.swarm_cnt))]


def _row_histories(hists, s_cnt: int) -> List[Optional[History]]:
    """Per-row History objects from per-segment ``(iterations, [K, S]
    gbest_fit, [K, S] violations or None)`` records (all None when no
    history was recorded)."""
    if not hists:
        return [None] * s_cnt
    its = np.concatenate([np.asarray(h[0], dtype=np.int64) for h in hists])
    fits = np.concatenate([h[1] for h in hists])
    viols = (None if hists[0][2] is None
             else np.concatenate([h[2] for h in hists]))
    return [History(iteration=its, gbest_fit=fits[:, s],
                    violation=None if viols is None else viols[:, s])
            for s in range(s_cnt)]


def _row_counters(cnts, s_cnt: int) -> List[Optional[KernelCounters]]:
    """Per-row KernelCounters from per-segment ``[S, 3]`` counts."""
    total = _sum_counters([_host(c) for c in cnts])
    if total is None:
        return [None] * s_cnt
    return KernelCounters.rows(total)


def _solve_many_hetero(problems, seeds, m: Method, dim, particles, iters,
                       coeffs, w, c1, c2, dtype, min_pos, max_pos, max_v,
                       dev) -> List[Result]:
    """``solve_many(problems=[...])``: per-row problem dispatch."""
    if min_pos is not None or max_pos is not None or max_v is not None:
        raise ValueError("heterogeneous batches take bounds from each "
                         "row's problem; drop min_pos/max_pos/max_v")
    probs = [resolve_problem(p) for p in problems]
    if len(probs) != len(seeds):
        raise ValueError(f"{len(probs)} problems for {len(seeds)} seeds")
    # cfg.fitness is a placeholder: the rows carry the real objectives.
    kw = dict(dim=dim if dim is not None else 1, particle_cnt=particles,
              fitness="cubic", dtype=dtype, update_rule=m.rule,
              topology=m.topology)
    for key, v in (("w", w), ("c1", c1), ("c2", c2)):
        if v is not None:
            kw[key] = v
    cfg = PSOConfig(**kw)
    m = _effective_method(m, probs[0], cfg, iters, dev, batch=len(seeds),
                          hetero_table=len({p.cache_key() for p in probs}))
    rows, table = problem_rows(probs, cfg.dim, cfg.dtype, device=dev)
    rcfg = cfg.resolved()
    batch = init_batch(rcfg, seeds, rows=rows, table=table, device=dev)
    batch, hist, cnt = _run_batch(rcfg, batch, iters, m, coeffs, rows, table)
    configs = {p: hetero_member_config(cfg, p) for p in set(probs)}
    return [Result(problem=p, config=configs[p], method=m, iters=iters,
                   state=row, history=h, telemetry=t)
            for p, row, h, t in zip(
                probs, batch_rows(batch),
                _row_histories([] if hist is None else [hist], len(probs)),
                _row_counters([] if cnt is None else [cnt], len(probs)))]


def _run_batch(cfg: PSOConfig, batch: SwarmBatch, iters: int, m: Method,
               coeffs, rows: Optional[ProblemRows] = None, table=None):
    """A batched segment on the resolved backend -> (batch, (iterations,
    [K, S] gbest_fit, [K, S] violations or None) or None, [S, 3] counts or
    None)."""
    if m.resolve_backend(batch.pos.device) == "kernel":
        if coeffs is not None:
            raise ValueError("per-swarm coeffs are an eager-engine feature; "
                             "pass backend='eager'")
        return _run_batch_kernel(cfg, batch, iters, m, rows, table)
    blocks = _eager_async_blocks(m, batch.pos.shape[1])
    if m.record_history:
        batch, (its, fits, viols) = run_many_with_history(
            cfg, batch, iters, m.variant, coeffs, sync_every=m.sync_every,
            rows=rows, table=table, n_blocks=blocks)
        return batch, (its, _host(fits),
                       None if viols is None else _host(viols)), None
    return run_many(cfg, batch, iters, m.variant, coeffs,
                    sync_every=m.sync_every, rows=rows, table=table,
                    n_blocks=blocks), None, None


def _run_batch_kernel(cfg: PSOConfig, batch: SwarmBatch, iters: int,
                      m: Method, rows: Optional[ProblemRows] = None,
                      table=None):
    """The batched kernels through ``ops.run_queue_lock``, with the
    counters and the history of ``_run_state_kernel`` (one ``[S]`` sample
    a sync point). ``rows``/``table`` make the batch heterogeneous."""
    from .kernels import ops
    positions = rows is None and cfg.problem.constrained
    batch, hist, cnt = ops.run_queue_lock(
        cfg, batch, iters, m.variant, sync_every=m.sync_every,
        block_n=m.block_n, telemetry=m.telemetry, history=m.record_history,
        fids=None if rows is None else rows.fid, table=table,
        positions=positions)
    hist = _kernel_history(cfg, *(hist if positions else (*hist, None)))
    return batch, hist, cnt


def solve_stream(requests: Sequence, *, lane_width: int = 8,
                 coalesce_registry: bool = True, compile_cache=None,
                 autotune: bool = False, metrics=None,
                 record_history: bool = False, trace=None,
                 trace_path: Optional[str] = None, backend: str = "auto",
                 device=None) -> List:
    """Run a stream of independent solve requests through the
    continuous-batching scheduler (``repro_torch.serving.
    ContinuousScheduler``) on ``device`` (``None``: the CUDA card).

    ``requests`` are ``repro_torch.launch.serve.SolveRequest``s (or dicts
    of their fields). Async requests ride persistent batched lanes with
    chunk-boundary admission, each result its request's standalone solve;
    synchronous and sub-chunk requests run standalone. ``backend``:
    ``auto`` | ``eager`` | ``kernel``, as in ``Method``. ``compile_cache``
    (a ``CompileCache``, or a directory path for one) keeps the lane
    programs' manifest across processes; ``metrics`` (a
    ``ServingMetrics``) collects latency spans and batch fill. ``trace``
    (a ``TraceWriter``) records the serving timeline, and ``trace_path``
    writes it as a trace.json at the end (allocating a writer if ``trace``
    is None). ``record_history=True`` samples each lane request's gbest at
    its chunk boundaries onto ``SolveResult.history``. Returns one
    ``SolveResult`` per request, in request order."""
    from .launch.serve import SolveRequest
    from .serving import CompileCache, ContinuousScheduler
    if isinstance(compile_cache, str):
        compile_cache = CompileCache(path=compile_cache)
    if trace is None and trace_path is not None:
        from .telemetry import TraceWriter
        trace = TraceWriter()
    reqs = [r if isinstance(r, SolveRequest) else SolveRequest(**r)
            for r in requests]
    sched = ContinuousScheduler(
        lane_width=lane_width, coalesce_registry=coalesce_registry,
        compile_cache=compile_cache, autotune=autotune, metrics=metrics,
        trace=trace, record_history=record_history, backend=backend,
        device=device)
    out = sched.run(reqs)
    if trace is not None and trace_path is not None:
        trace.write(trace_path)
    return out


def best(results: Sequence[Result]) -> Result:
    """The best Result of a batch by Deb's rule: a feasible result beats
    any infeasible one, feasible results compare on canonical fitness,
    infeasible ones on violation (smaller wins). Unconstrained results are
    all feasible, so for them this is the highest fitness."""
    results = list(results)
    if not results:
        raise ValueError("best() of no results")
    feas = [r for r in results if r.feasible]
    if feas:
        return max(feas, key=lambda r: r.gbest_fit)
    return min(results, key=lambda r: r.violation)
