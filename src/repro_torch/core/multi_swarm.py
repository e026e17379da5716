"""Batched multi-swarm engine: many independent PSO solves advanced
together, the port of ``repro.core.multi_swarm``.

A ``SwarmBatch`` stacks S swarms on a leading axis (``pos`` ``[S, N, D]``,
``iteration``/``seed`` int64 ``[S]``). ``run_many`` hands the whole batch to
the eager engine of ``core.pso``, whose functions take a leading swarm axis:
the per-swarm seeds and iterations broadcast into the counter RNG, and every
reduction runs over one swarm's particles. RNG element indices stay local to
the swarm (particle * D + dim), so row ``s`` of a batch is the standalone
``pso.run`` on ``batch_row(batch, s)``: batching is a scheduling transform,
never a semantic one.

Per-swarm hyper-parameters: ``coeffs=(w, c1, c2)``, each ``[S]``.
Heterogeneous batches: ``rows``/``table`` from ``problem_rows`` give row
``s`` its own problem from the table (the six built-ins by default; a table
may hold custom and penalty-mode members too); each table member's
objective runs once, on the rows that select it. A homogeneous batch of a
constrained problem takes the engine's constrained init and Deb fold on
every row, as the standalone swarm does.

The reference pads batches smaller than ``MIN_VALIDATED_SWARMS`` with dead
rows to dodge an XLA:CPU per-shape FMA-contraction quirk. Eager PyTorch
compiles nothing per shape, so the port runs every batch at its own size;
it keeps the constant because the serving scheduler floors its lane width
at it, as the reference's does.

The batched CUDA kernels are ``repro_torch.kernels.ops``'s
``run_queue_lock_fused_batch`` and ``run_queue_lock_fused_async_batch``.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _device
from .problem import Problem, resolve_problem
from .pso import (ASYNC_SYNC_EVERY, VARIANTS, HeteroRow, PSOConfig,
                  SwarmState, init_swarm, run, run_with_history)

Tensor = torch.Tensor

#: The reference's smallest validated batch; the port's engine needs no
#: floor, but ``serving.ContinuousScheduler`` floors lane widths at it.
MIN_VALIDATED_SWARMS = 8

#: Dtypes without a heterogeneous batch (``problem_rows``).
NO_HETERO_DTYPES = ("bfloat16", "float16")


class ProblemRows(NamedTuple):
    """Per-row problem descriptors of a heterogeneous batch, against a
    static table of ``Problem``s: ``fid[s]`` indexes the table, and the
    bound rows repeat the arithmetic ``PSOConfig.resolved()`` gives row
    ``s``'s problem (``0.5 * (hi - lo)`` in Python floats, then one cast).
    ``sense``/``cmode``/``pweight`` are the reference's descriptor metadata:
    ``cmode`` 1 and ``pweight`` the weight for a penalty-mode member (the
    penalty rides its ``max_fn``), else 0."""

    fid: Tensor      # [S] int32
    lo: Tensor       # [S, D]
    hi: Tensor       # [S, D]
    mv: Tensor       # [S, D]
    sense: Tensor    # [S] int32: +1 max / -1 min
    cmode: Tensor    # [S] int32: 0 unconstrained / 1 penalty
    pweight: Tensor  # [S]

    @property
    def swarm_cnt(self) -> int:
        return self.fid.shape[0]


def hetero_fid(fitness) -> Optional[int]:
    """Index of ``fitness`` in the built-in table, else None: a problem that
    IS a registered built-in can share a heterogeneous batch."""
    from .fitness import BUILTIN_PROBLEMS
    try:
        prob = resolve_problem(fitness)
    except (KeyError, TypeError):
        return None
    for i, p in enumerate(BUILTIN_PROBLEMS):
        if prob == p:
            return i
    return None


def _row_bound(v, d: int, dt) -> np.ndarray:
    """Resolved Bound (scalar or per-dim tuple) -> [D] host array."""
    if isinstance(v, tuple):
        return np.asarray(v, dt)
    return np.full((d,), v, dt)


def problem_rows(problems: Sequence, dim: int, dtype: str = "float32",
                 table: Optional[Tuple[Problem, ...]] = None, device=None
                 ) -> Tuple[ProblemRows, Tuple[Problem, ...]]:
    """The per-row descriptors of a heterogeneous batch on ``device``
    (``None``: the card). ``problems`` are names or ``Problem``s, each of
    which must be in ``table`` (default: the six built-ins). Table members
    must be unconstrained or penalty-mode: projection and repair would need
    per-row init and advance hooks. Float32 and float64 only: the
    reference's heterogeneous batch fails in bfloat16 (its scan carries a
    float32 fitness beside the bfloat16 state), and the port refuses it
    there and in float16 with a ``ValueError``. Returns ``(rows, table)``."""
    from .fitness import BUILTIN_PROBLEMS
    if dtype in NO_HETERO_DTYPES:
        raise ValueError(f"heterogeneous batches take float32 (or float64) "
                         f"only, not {dtype}: the reference's fails there "
                         f"too; solve each problem in a batch of its own")
    dev = _device.resolve(device)
    table = BUILTIN_PROBLEMS if table is None else tuple(table)
    for p in table:
        if p.projection_fn is not None or (
                p.constrained and p.constraints.mode == "repair"):
            raise ValueError(
                f"problem {p.name!r}: projection/repair constraint modes "
                "cannot join a heterogeneous dispatch table (per-row "
                "init/advance hooks); solve it in its own batch")
    dt = np.dtype(dtype)
    fid, lo, hi, mv, sense, cmode, pw = [], [], [], [], [], [], []
    for f in problems:
        prob = resolve_problem(f)
        try:
            i = table.index(prob)
        except ValueError:
            raise ValueError(
                f"problem {prob.name!r} is not in the heterogeneous "
                "dispatch table; solve it in its own batch") from None
        r = PSOConfig(dim=dim, fitness=prob, dtype=dtype).resolved()
        fid.append(i)
        lo.append(_row_bound(r.min_pos, dim, dt))
        hi.append(_row_bound(r.max_pos, dim, dt))
        mv.append(_row_bound(r.max_v, dim, dt))
        sense.append(1 if prob.sense == "max" else -1)
        penalized = prob.constrained and prob.constraints.mode == "penalty"
        cmode.append(1 if penalized else 0)
        pw.append(prob.constraints.weight if penalized else 0.0)

    def put(x, dtype=None):
        return torch.as_tensor(np.asarray(x, dtype), device=dev)
    return ProblemRows(
        fid=put(fid, np.int32), lo=put(np.stack(lo)), hi=put(np.stack(hi)),
        mv=put(np.stack(mv)), sense=put(sense, np.int32),
        cmode=put(cmode, np.int32), pweight=put(pw, dt)), table


def _hetero(rows: Optional[ProblemRows], table):
    """The engine's ``hetero=(table, HeteroRow)`` operand, or None."""
    if rows is None:
        return None
    if table is None:
        raise ValueError("rows= needs the dispatch table= it indexes")
    return table, HeteroRow(fid=rows.fid, lo=rows.lo, hi=rows.hi, mv=rows.mv)


class SwarmBatch(NamedTuple):
    """S independent swarms on a leading axis. The field order is
    ``SwarmState``'s, so the engine's functions take a batch as it is."""

    pos: Tensor        # [S, N, D]
    vel: Tensor        # [S, N, D]
    fit: Tensor        # [S, N]
    pbest_pos: Tensor  # [S, N, D]
    pbest_fit: Tensor  # [S, N]
    gbest_pos: Tensor  # [S, D]
    gbest_fit: Tensor  # [S]
    iteration: Tensor  # [S] int64
    seed: Tensor       # [S] int64 holding uint32 values
    lbest_pos: Optional[Tensor] = None  # [S, nb, D] async block-local bests
    lbest_fit: Optional[Tensor] = None  # [S, nb]

    @property
    def swarm_cnt(self) -> int:
        return self.gbest_fit.shape[0]


def init_batch(cfg: PSOConfig, seeds, rows: Optional[ProblemRows] = None,
               table: Optional[Tuple[Problem, ...]] = None,
               device=None) -> SwarmBatch:
    """Initialize S swarms, one per entry of ``seeds``, on ``device``
    (``None``: the card). Row ``s`` is bit-identical to ``init_swarm(cfg,
    seeds[s])``; with ``rows``/``table`` each row initializes against its
    own problem's bounds and objective."""
    dev = _device.resolve(device)
    sd = torch.as_tensor(np.asarray(seeds, np.int64), device=dev)
    return SwarmBatch(*init_swarm(cfg, sd, device=dev,
                                  hetero=_hetero(rows, table)))


def batch_row(batch: SwarmBatch, s: int) -> SwarmState:
    """Swarm ``s`` as a standalone SwarmState (views into the batch)."""
    fields = [None if a is None else a[s] for a in batch]
    fields[7], fields[8] = int(fields[7]), int(fields[8])
    return SwarmState(*fields)


def batch_rows(batch: SwarmBatch) -> List[SwarmState]:
    """Every swarm as a standalone SwarmState, ``batch_row`` for each row
    with one read of the counters for the whole batch."""
    cols = [None if a is None else a.unbind(0) for a in batch]
    cols[7], cols[8] = batch.iteration.tolist(), batch.seed.tolist()
    return [SwarmState(*(None if c is None else c[s] for c in cols))
            for s in range(batch.swarm_cnt)]


def stack_states(states: Sequence[SwarmState]) -> SwarmBatch:
    """Stack standalone swarms into a batch (inverse of ``batch_row``)."""
    states = list(states)
    dev = states[0].pos.device
    out = []
    for i, name in enumerate(SwarmState._fields):
        vals = [st[i] for st in states]
        if name in ("iteration", "seed"):
            out.append(torch.tensor([int(v) for v in vals],
                                    dtype=torch.int64, device=dev))
        elif all(v is None for v in vals):
            out.append(None)
        elif any(v is None for v in vals):
            raise ValueError(f"{name} is set on some states and not others")
        else:
            out.append(torch.stack(vals))
    return SwarmBatch(*out)


def set_batch_row(batch: SwarmBatch, s: int, state: SwarmState
                  ) -> SwarmBatch:
    """A new batch with row ``s`` replaced by ``state`` (the scheduler's
    admission primitive). An async batch carries ``lbest_*``; the admitted
    row must too."""
    if (batch.lbest_fit is None) != (state.lbest_fit is None):
        raise ValueError(
            "row/batch lbest structure mismatch: splice rows that carry "
            "async block-local bests into async batches only")
    out = []
    for a, v in zip(batch, state):
        if a is None:
            out.append(None)
            continue
        a = a.clone()
        a[s] = v if isinstance(v, Tensor) else torch.as_tensor(v)
        out.append(a)
    return SwarmBatch(*out)


def set_problem_row(rows: ProblemRows, s: int, one: ProblemRows
                    ) -> ProblemRows:
    """A new descriptor set with row ``s`` replaced by row 0 of ``one``."""
    out = []
    for a, v in zip(rows, one):
        a = a.clone()
        a[s] = v[0]
        out.append(a)
    return ProblemRows(*out)


def _per_swarm_coeffs(coeffs, batch: SwarmBatch):
    """``(w, c1, c2)``, each of length S, as tensors of the batch's dtype
    on its device."""
    if coeffs is None:
        return None
    out = tuple(torch.as_tensor(c, dtype=batch.pos.dtype,
                                device=batch.pos.device) for c in coeffs)
    if len(out) != 3 or any(tuple(c.shape) != (batch.swarm_cnt,)
                            for c in out):
        raise ValueError(f"coeffs must be (w, c1, c2), each of length "
                         f"{batch.swarm_cnt}")
    return out


def run_many(cfg: PSOConfig, batch: SwarmBatch, iters: int,
             variant: str = "queue", coeffs=None,
             sync_every: int = ASYNC_SYNC_EVERY,
             rows: Optional[ProblemRows] = None,
             table: Optional[Tuple[Problem, ...]] = None,
             n_blocks: Optional[int] = None) -> SwarmBatch:
    """Advance every swarm of the batch ``iters`` iterations in lockstep.

    ``variant`` is one of ``reduction | queue | queue_lock | async``;
    ``coeffs`` optionally gives per-swarm ``(w, c1, c2)``; ``rows``/``table``
    make the batch heterogeneous; ``sync_every``/``n_blocks`` are the async
    variant's, and ``cfg.topology`` its pull at a sync point (each row's
    locals fold only within the row). Async rows resumed at different
    iterations keep their own publication schedules. Synchronous variants
    drop the async locals."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    return SwarmBatch(*run(cfg, batch, iters, variant, sync_every=sync_every,
                           n_blocks=n_blocks,
                           coeffs=_per_swarm_coeffs(coeffs, batch),
                           hetero=_hetero(rows, table)))


def run_many_with_history(cfg: PSOConfig, batch: SwarmBatch, iters: int,
                          variant: str = "queue", coeffs=None,
                          sync_every: int = ASYNC_SYNC_EVERY,
                          rows: Optional[ProblemRows] = None,
                          table: Optional[Tuple[Problem, ...]] = None,
                          n_blocks: Optional[int] = None):
    """``run_many`` that also records every row's gbest trajectory.

    Returns ``(batch, (iterations, gbest_fits, violations))`` with
    ``iterations`` a length-K tuple of absolute iteration numbers and
    ``gbest_fits`` ``[K, S]``, one sample per sync point per row as
    ``pso.run_with_history`` takes them (every iteration for the
    synchronous variants, every ``sync_every`` boundary for ``async``);
    ``violations`` is the recorded gbests' violation ``[K, S]`` for a
    constrained homogeneous batch, else None. Row ``s`` equals
    ``pso.run_with_history`` on ``batch_row(batch, s)``. Assumes the
    lockstep batches the facades build (all rows at one iteration count)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    out, hist = run_with_history(
        cfg, batch, iters, variant, sync_every=sync_every, n_blocks=n_blocks,
        coeffs=_per_swarm_coeffs(coeffs, batch), hetero=_hetero(rows, table))
    return SwarmBatch(*out), hist


def solve_many(cfg: PSOConfig, seeds, iters: int = 1000,
               variant: str = "queue", coeffs=None,
               sync_every: int = ASYNC_SYNC_EVERY,
               problems: Optional[Sequence] = None,
               n_blocks: Optional[int] = None, device=None) -> SwarmBatch:
    """Batched one-shot: init + run for S independent solves on
    ``device`` (``None``: the card). Row ``s`` is ``pso.solve(cfg,
    seeds[s], iters, variant)`` when ``coeffs`` is None.

    ``problems`` (length S, names or built-in ``Problem``s) makes the batch
    heterogeneous: row ``s`` solves ``problems[s]`` with its own objective
    and bounds, so ``cfg`` must not override ``min_pos``/``max_pos``/
    ``max_v``; ``cfg.fitness`` is ignored."""
    if problems is None:
        cfg = cfg.resolved()
        return run_many(cfg, init_batch(cfg, seeds, device=device), iters,
                        variant, coeffs, sync_every, n_blocks=n_blocks)
    if (cfg.min_pos is not None or cfg.max_pos is not None
            or cfg.max_v is not None):
        raise ValueError(
            "heterogeneous batches take bounds from each row's problem; "
            "pass a config without min_pos/max_pos/max_v overrides (and "
            "not already resolved())")
    seeds = np.asarray(seeds, np.int64)
    if len(problems) != seeds.shape[0]:
        raise ValueError(
            f"{len(problems)} problems for {seeds.shape[0]} seeds")
    rows, table = problem_rows(problems, cfg.dim, cfg.dtype, device=device)
    cfg = cfg.resolved()
    batch = init_batch(cfg, seeds, rows=rows, table=table, device=device)
    return run_many(cfg, batch, iters, variant, coeffs, sync_every, rows,
                    table, n_blocks)


def best_of_batch(batch: SwarmBatch) -> Tuple[Tensor, Tensor, Tensor]:
    """(best gbest_fit, its gbest_pos, winning swarm index) over the batch."""
    b = torch.argmax(batch.gbest_fit)
    return batch.gbest_fit[b], batch.gbest_pos[b], b
