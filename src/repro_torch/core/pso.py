"""Parallel PSO (PPSO) in PyTorch: config, state, and the aggregation
variants, ported from ``repro.core.pso``.

Variants (paper §3.2, §4): ``step_reduction`` (an unconditional argmax over
all pbests every iteration, the baseline), ``step_queue`` (gbest taken from
the lanes that beat the stale gbest), ``step_queue_lock`` (the predicated
pbest-argmax publication), and ``step_async``/``run_async`` (the paper's
enhanced queue-lock: blocks advance against block-local bests and publish
every ``sync_every`` iterations). All parallel variants are synchronous
PPSO: every particle sees the gbest of the previous iteration.

Constrained problems (``core.constraints``): ``init_swarm`` projects or
repairs the initial draw, ``_advance`` projects after the box clip, and in
the projection and repair modes every pbest fold takes the Deb rule
(``deb_selection_fn``). A heterogeneous batch takes none of these hooks,
as in the reference (its members are unconstrained or penalty-mode).

This eager engine is the CPU twin of the main-path kernels and the engine
of ``backend="eager"``. It keeps the reference's particle-major layout:
``pos`` is ``[N, D]``. Where the reference branches with ``lax.cond`` the
port selects with ``torch.where``, which needs no host round trip and gives
the same result.

``SwarmState.iteration`` and ``.seed`` are Python ints: they are RNG
counter components the host already knows, and kernel launches take them
as scalars.

Every function below also takes a batch of swarms (``core.multi_swarm``'s
``SwarmBatch``): the same fields with a leading swarm axis, ``pos``
``[S, N, D]``, and ``iteration``/``seed`` as int64 tensors ``[S]`` that
broadcast into the RNG counters. Reductions run over the particle axis of
each swarm, so row ``s`` of a batch takes the same operations as the
single swarm does.
"""
from __future__ import annotations

import dataclasses
from typing import (Callable, Mapping, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from .. import _device
from ..telemetry import trace as _trace
from . import rng
from .blocking import default_block_count
from .constraints import deb_improved, repair_init_positions
from .fitness import LOW_PRECISION, weak
from .problem import Bound, Problem, broadcast_bounds, resolve_problem
from .topology import block_neighbor_best
from .update_rules import TOPOLOGIES, resolve_rule

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PSOConfig:
    """Static PSO configuration (paper Table 1), as in ``repro``.

    ``fitness`` is a registered problem name or a ``Problem``;
    ``min_pos``/``max_pos``/``max_v`` override the problem's domain, each a
    scalar or a length-``dim`` tuple. ``update_rule`` names the rule
    (``pso``/``sso``/``lowcost``). ``topology`` names the async variant's
    pull at a sync point: ``gbest`` (the paper's star) or the lbest
    ``ring``/``vonneumann`` (``core.topology``).
    """

    dim: int = 1
    particle_cnt: int = 1024
    w: float = 1.0          # inertia (paper §6.1: w = 1)
    c1: float = 2.0         # cognitive coefficient
    c2: float = 2.0         # social coefficient
    fitness: Union[str, Problem] = "cubic"
    min_pos: Optional[Bound] = None   # default: fitness-specific domain
    max_pos: Optional[Bound] = None
    max_v: Optional[Bound] = None     # default: half the position range
    dtype: str = "float32"
    update_rule: str = "pso"
    topology: str = "gbest"

    def __post_init__(self):
        for f in ("min_pos", "max_pos", "max_v"):
            v = getattr(self, f)
            if v is not None and not isinstance(v, (int, float, tuple)):
                object.__setattr__(self, f, tuple(float(x) for x in v))
        resolve_rule(self.update_rule)
        if self.topology not in TOPOLOGIES:
            raise ValueError(
                f"unknown topology {self.topology!r}; one of {TOPOLOGIES}")

    @property
    def problem(self) -> Problem:
        return resolve_problem(self.fitness)

    def resolved(self) -> "PSOConfig":
        prob = self.problem
        min_pos = prob.lo if self.min_pos is None else self.min_pos
        max_pos = prob.hi if self.max_pos is None else self.max_pos
        min_pos, max_pos = broadcast_bounds(min_pos, max_pos)
        for name, v in (("min_pos", min_pos), ("max_pos", max_pos)):
            if isinstance(v, tuple) and len(v) != self.dim:
                raise ValueError(
                    f"{name} has {len(v)} entries but dim={self.dim}")
        if self.max_v is None:
            if isinstance(min_pos, tuple):
                max_v: Bound = tuple(0.5 * (h - l)
                                     for l, h in zip(min_pos, max_pos))
            else:
                max_v = 0.5 * (max_pos - min_pos)
        else:
            max_v = self.max_v
            if isinstance(max_v, tuple) and len(max_v) != self.dim:
                raise ValueError(
                    f"max_v has {len(max_v)} entries but dim={self.dim}")
        return dataclasses.replace(self, min_pos=min_pos, max_pos=max_pos,
                                   max_v=max_v)

    @property
    def fitness_fn(self) -> Callable[[Tensor], Tensor]:
        """The objective in canonical (maximization) form."""
        return self.problem.max_fn

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class SwarmState(NamedTuple):
    """Full swarm state, field for field the reference's ``SwarmState``.

    ``lbest_pos``/``lbest_fit`` are the async variant's block-local bests
    (one slot per particle block), carried so a resumed async run keeps its
    staleness window; synchronous variants leave them ``None``.
    """

    pos: Tensor        # [N, D]
    vel: Tensor        # [N, D]
    fit: Tensor        # [N]
    pbest_pos: Tensor  # [N, D]
    pbest_fit: Tensor  # [N]
    gbest_pos: Tensor  # [D]
    gbest_fit: Tensor  # []
    iteration: int     # RNG counter component
    seed: int          # uint32 RNG seed
    lbest_pos: Optional[Tensor] = None  # [nb, D]
    lbest_fit: Optional[Tensor] = None  # [nb]


# RNG stream ids (the CUDA kernels use the same numbers).
STREAM_INIT_POS = 0
STREAM_INIT_VEL = 1
STREAM_R1 = 2
STREAM_R2 = 3

_TENSOR_FIELDS = ("pos", "vel", "fit", "pbest_pos", "pbest_fit", "gbest_pos",
                  "gbest_fit", "lbest_pos", "lbest_fit")


def state_from_numpy(fields: Mapping[str, np.ndarray], device=None
                     ) -> SwarmState:
    """Build a ``SwarmState`` from numpy arrays named like the reference's
    fields (``pos``, ``vel``, ``fit``, ``pbest_*``, ``gbest_*``,
    ``iteration``, ``seed`` and optionally ``lbest_*``) — the port's way to
    carry a state over from ``repro``."""
    dev = _device.resolve(device)
    kw = {}
    for name in _TENSOR_FIELDS:
        v = fields.get(name)
        kw[name] = None if v is None else torch.as_tensor(
            np.array(v), device=dev)
    return SwarmState(iteration=int(np.asarray(fields["iteration"])),
                      seed=int(np.asarray(fields["seed"]).astype(np.uint32)),
                      **kw)


def state_to_numpy(state: SwarmState) -> dict:
    """The inverse of ``state_from_numpy``: numpy arrays under the
    reference's field names, ``iteration`` int32 and ``seed`` uint32."""
    out = {name: (None if getattr(state, name) is None
                  else getattr(state, name).detach().cpu().numpy())
           for name in _TENSOR_FIELDS}
    out["iteration"] = np.int32(state.iteration)
    out["seed"] = np.uint32(state.seed & 0xFFFFFFFF)
    return out


def _bound_operand(v: Bound, dtype: torch.dtype, device):
    """Bound -> operand: scalars stay Python floats (the reference's
    weak-typed arithmetic), per-dimension tuples become [D] tensors."""
    return v if not isinstance(v, tuple) else torch.tensor(
        v, dtype=dtype, device=device)


def _particle_index(n: int, d: int, device, index_offset: int = 0) -> Tensor:
    """RNG element index ``particle * D + dim`` for an [n, d] block."""
    return (torch.arange(n * d, dtype=torch.int64, device=device)
            .reshape(n, d) + index_offset * d)


def _per_row(x, trailing: int):
    """A per-swarm operand ``[S]`` shaped to broadcast against arrays with
    ``trailing`` more axes; scalars and 0-d tensors pass through."""
    if isinstance(x, Tensor) and x.dim() == 1:
        return x.reshape(x.shape + (1,) * trailing)
    return x


def _pick(fit: Tensor, pos: Tensor, idx: Tensor) -> Tuple[Tensor, Tensor]:
    """``(fit[..., i], pos[..., i, :])`` for the per-row indices ``idx``
    (``[..., 1]``, as ``argmax(..., keepdim=True)`` gives them)."""
    bp = pos.gather(-2, idx[..., None].expand(*idx.shape, pos.shape[-1]))
    return fit.gather(-1, idx)[..., 0], bp[..., 0, :]


class HeteroRow(NamedTuple):
    """Per-swarm dispatch operands of a heterogeneous batch row, as in
    ``repro.core.pso``: ``fid`` indexes the problem table; ``lo``/``hi``/
    ``mv`` are the row's bound columns, ``[D]`` (or ``[S, D]`` with
    ``fid`` ``[S]`` for a whole batch), precomputed by
    ``multi_swarm.problem_rows`` with ``PSOConfig.resolved()``'s
    arithmetic."""

    fid: Union[int, Tensor]
    lo: Tensor
    hi: Tensor
    mv: Tensor


def _hetero_fitness(table: Sequence[Problem], fid, pos: Tensor) -> Tensor:
    """Canonical fitness of each row's problem. Each table member runs once,
    on the rows whose ``fid`` selects it (the reference computes every
    member under ``vmap`` and selects)."""
    if not isinstance(fid, Tensor) or fid.dim() == 0:
        return table[int(fid)].max_fn(pos)
    out = pos.new_empty(pos.shape[:-1])
    for k in torch.unique(fid).tolist():
        rows = (fid == k).nonzero()[:, 0]
        out[rows] = table[k].max_fn(pos[rows])
    return out


def hetero_member_config(cfg: PSOConfig, prob: Problem) -> PSOConfig:
    """``cfg`` re-pointed at one dispatch-table member, bounds re-derived:
    the config a standalone solve of ``prob`` at this dim/particle_cnt/
    w/c1/c2/dtype resolves to."""
    return dataclasses.replace(cfg, fitness=prob, min_pos=None,
                               max_pos=None, max_v=None).resolved()


def init_swarm(cfg: PSOConfig, seed, n: Optional[int] = None,
               index_offset: int = 0, device=None,
               hetero=None) -> SwarmState:
    """Initialize a swarm (paper Alg. 1 step 1), bit-exact with the
    reference's draws. ``device=None`` means the card.

    ``seed`` may be an int64 tensor ``[S]``, which initializes S swarms at
    once (``multi_swarm.init_batch``). ``hetero=(table, row)`` draws from
    the same streams but takes the box from the row's bound columns and
    the objective from the table (``multi_swarm``'s heterogeneous
    batches)."""
    tok = _trace.begin("pso.init_swarm")
    try:
        dev = _device.resolve(device)
        cfg = cfg.resolved()
        n = cfg.particle_cnt if n is None else n
        d = cfg.dim
        dt = cfg.torch_dtype
        idx = _particle_index(n, d, dev, index_offset)
        sd = _per_row(seed, 2)
        u_pos = rng.uniform(sd, 0, STREAM_INIT_POS, idx, dtype=dt)
        u_vel = rng.uniform(sd, 0, STREAM_INIT_VEL, idx, dtype=dt)
        if hetero is None:
            lo = _bound_operand(cfg.min_pos, dt, dev)
            hi = _bound_operand(cfg.max_pos, dt, dev)
            mv = _bound_operand(cfg.max_v, dt, dev)
        else:
            lo, hi, mv = (x.unsqueeze(-2) for x in hetero[1][1:])
        # scalar bounds are weak-typed constants (fitness.weak) in the
        # reference: its span is the Python difference, rounded to the dtype
        span = weak(hi - lo, dt)
        pos = weak(lo, dt) + span * u_pos
        vel = weak(-mv, dt) + weak(2.0 * mv, dt) * u_vel
        prob = cfg.problem
        if hetero is None and prob.projection_fn is not None:
            pos = prob.projection_fn(pos)          # start feasible
        elif hetero is None and prob.constrained \
                and prob.constraints.mode == "repair":
            pos = repair_init_positions(prob.constraints, prob.violation_fn,
                                        pos, lo, span, sd, STREAM_INIT_POS,
                                        idx, dt)
        fit = (cfg.fitness_fn(pos) if hetero is None
               else _hetero_fitness(hetero[0], hetero[1].fid, pos))
        gbest_fit, gbest_pos = _pick(fit, pos, torch.argmax(fit, -1, True))
        if isinstance(seed, Tensor):
            seed = seed.to(torch.int64) & 0xFFFFFFFF
            iteration = torch.zeros_like(seed)
        else:
            seed, iteration = int(seed) & 0xFFFFFFFF, 0
        return SwarmState(
            pos=pos, vel=vel, fit=fit, pbest_pos=pos, pbest_fit=fit,
            gbest_pos=gbest_pos, gbest_fit=gbest_fit,
            iteration=iteration, seed=seed)
    finally:
        _trace.end(tok)


def _advance(cfg: PSOConfig, s: SwarmState, index_offset: int = 0,
             gbest_pos: Optional[Tensor] = None,
             coeffs: Optional[Tuple] = None, hetero=None
             ) -> Tuple[Tensor, Tensor, Tensor]:
    """Alg. 1 steps 2–3: velocity/position update + fitness, vectorized.
    ``gbest_pos`` optionally overrides the social attractor (any shape
    broadcastable to [N, D]) — ``step_async`` passes each block's local
    best. ``coeffs=(w, c1, c2)`` overrides the config's coefficients, each
    a float or a per-swarm tensor ``[S]``; ``hetero=(table, row)`` swaps
    the config's bounds and objective for the row's. Returns (pos, vel,
    fit) for iteration ``s.iteration + 1``."""
    n, d = s.pos.shape[-2:]
    dt, dev = s.pos.dtype, s.pos.device
    it = _per_row(s.iteration + 1, 2)
    sd = _per_row(s.seed, 2)
    gbp = s.gbest_pos.unsqueeze(-2) if gbest_pos is None else gbest_pos
    idx = _particle_index(n, d, dev, index_offset)
    r1 = rng.uniform(sd, it, STREAM_R1, idx, dtype=dt)
    r2 = rng.uniform(sd, it, STREAM_R2, idx, dtype=dt)
    # Python constants enter as the reference's weak typing makes them
    # (rounded in bfloat16), as in the kernels' plain versions
    w, c1, c2 = ((weak(cfg.w, dt), weak(cfg.c1, dt), weak(cfg.c2, dt))
                 if coeffs is None else (_per_row(c, 2) for c in coeffs))
    span = None
    if hetero is None:
        lo, hi, mv = (weak(_bound_operand(v, dt, dev), dt)
                      for v in (cfg.min_pos, cfg.max_pos, cfg.max_v))
        if dt in LOW_PRECISION and not isinstance(lo, Tensor):
            span = weak(cfg.max_pos - cfg.min_pos, dt)
    else:
        lo, hi, mv = (x.unsqueeze(-2) for x in hetero[1][1:])
    pos, vel = resolve_rule(cfg.update_rule).advance(
        r1, r2, s.pos, s.vel, s.pbest_pos, gbp, w=w, c1=c1, c2=c2,
        mv=mv, lo=lo, hi=hi, span=span)
    if hetero is not None:
        return pos, vel, _hetero_fitness(hetero[0], hetero[1].fid, pos)
    proj = cfg.problem.projection_fn
    if proj is not None:
        pos = proj(pos)        # the box clip first, then the feasible set
    return pos, vel, cfg.fitness_fn(pos)


def deb_selection_fn(cfg: PSOConfig, hetero=None):
    """The constrained pbest comparator ``better(fit_new, pos_new,
    fit_old, pos_old) -> bool`` (the Deb rule on the problem's violation),
    or None: unconstrained, penalty-mode and heterogeneous runs keep the
    raw ``fit > pbest_fit`` fold."""
    prob = cfg.problem
    if hetero is not None or not prob.deb:
        return None
    vf = prob.violation_fn

    def better(fit_new, pos_new, fit_old, pos_old):
        return deb_improved(fit_new, vf(pos_new), fit_old, vf(pos_old))

    return better


def _update_pbest(s: SwarmState, pos: Tensor, fit: Tensor, better=None
                  ) -> Tuple[Tensor, Tensor]:
    improved = (fit > s.pbest_fit if better is None
                else better(fit, pos, s.pbest_fit, s.pbest_pos))
    pbest_fit = torch.where(improved, fit, s.pbest_fit)
    pbest_pos = torch.where(improved[..., None], pos, s.pbest_pos)
    return pbest_pos, pbest_fit


def _take_best(fit: Tensor, pos: Tensor, s: SwarmState):
    """gbest <- (fit[b], pos[b]) for b = argmax(fit) (first on ties) if it
    beats gbest, per swarm."""
    bf, bp = _pick(fit, pos, torch.argmax(fit, -1, True))
    take = bf > s.gbest_fit
    return (torch.where(take[..., None], bp, s.gbest_pos),
            torch.where(take, bf, s.gbest_fit))


def step_reduction(cfg: PSOConfig, s: SwarmState, coeffs=None,
                   hetero=None) -> SwarmState:
    """Baseline: unconditional full argmax reduction (paper §3.2)."""
    pos, vel, fit = _advance(cfg, s, coeffs=coeffs, hetero=hetero)
    pbest_pos, pbest_fit = _update_pbest(s, pos, fit,
                                         deb_selection_fn(cfg, hetero))
    gbest_pos, gbest_fit = _take_best(pbest_fit, pbest_pos, s)
    return s._replace(pos=pos, vel=vel, fit=fit, pbest_pos=pbest_pos,
                      pbest_fit=pbest_fit, gbest_pos=gbest_pos,
                      gbest_fit=gbest_fit, iteration=s.iteration + 1)


def step_queue(cfg: PSOConfig, s: SwarmState, coeffs=None,
               hetero=None) -> SwarmState:
    """Queue algorithm (paper §4.1): the queue is the set of lanes whose
    fitness beats the stale gbest; its best member (first on ties) becomes
    gbest. With an empty queue nothing beats gbest and nothing is taken."""
    pos, vel, fit = _advance(cfg, s, coeffs=coeffs, hetero=hetero)
    pbest_pos, pbest_fit = _update_pbest(s, pos, fit,
                                         deb_selection_fn(cfg, hetero))
    q = torch.where(fit > s.gbest_fit[..., None], fit,
                    torch.full_like(fit, -torch.inf))
    gbest_pos, gbest_fit = _take_best(q, pos, s)
    return s._replace(pos=pos, vel=vel, fit=fit, pbest_pos=pbest_pos,
                      pbest_fit=pbest_fit, gbest_pos=gbest_pos,
                      gbest_fit=gbest_fit, iteration=s.iteration + 1)


def step_queue_lock(cfg: PSOConfig, s: SwarmState, coeffs=None,
                    hetero=None) -> SwarmState:
    """Queue-lock (paper §4.2), eager: gbest from the pbest argmax, taken
    only when it beats gbest (the reference predicates the argmax on any
    pbest improving; without an improvement the argmax cannot beat gbest,
    so selecting unconditionally gives the same state)."""
    pos, vel, fit = _advance(cfg, s, coeffs=coeffs, hetero=hetero)
    pbest_pos, pbest_fit = _update_pbest(s, pos, fit,
                                         deb_selection_fn(cfg, hetero))
    gbest_pos, gbest_fit = _take_best(pbest_fit, pbest_pos, s)
    return s._replace(pos=pos, vel=vel, fit=fit, pbest_pos=pbest_pos,
                      pbest_fit=pbest_fit, gbest_pos=gbest_pos,
                      gbest_fit=gbest_fit, iteration=s.iteration + 1)


STEP_FNS = {
    "reduction": step_reduction,
    "queue": step_queue,
    "queue_lock": step_queue_lock,
}

VARIANTS = ("reduction", "queue", "queue_lock", "async")

#: Default publication interval for the async variant.
ASYNC_SYNC_EVERY = 8


def init_async_locals(state: SwarmState, n_blocks: int
                      ) -> Tuple[Tensor, Tensor]:
    """Block-local bests seeded from the shared gbest: ([nb, D], [nb])."""
    gp, gf = state.gbest_pos, state.gbest_fit
    lbp = gp.unsqueeze(-2).expand(*gp.shape[:-1], n_blocks, gp.shape[-1])
    lbf = gf.unsqueeze(-1).expand(*gf.shape, n_blocks)
    return lbp.clone(), lbf.clone()


def init_swarm_async(cfg: PSOConfig, seed, n_blocks: Optional[int] = None,
                     hetero=None, device=None) -> SwarmState:
    """``init_swarm`` with the async block-local bests attached (``n_blocks``
    of them, by default ``default_block_count``): the serving scheduler's
    admission seam, as in ``repro``. Seeding the locals from gbest at
    iteration 0 is what ``run_async`` does on its first call for a bare
    ``init_swarm`` state, so an admitted row runs as the standalone solve
    of its request does."""
    cfg = cfg.resolved()
    s = init_swarm(cfg, seed, device=device, hetero=hetero)
    nb = n_blocks or default_block_count(s.pos.shape[-2])
    lbp, lbf = init_async_locals(s, nb)
    return s._replace(lbest_pos=lbp, lbest_fit=lbf)


def step_async(cfg: PSOConfig, s: SwarmState, local: Tuple[Tensor, Tensor],
               coeffs=None, hetero=None, index_offset: int = 0
               ) -> Tuple[SwarmState, Tuple[Tensor, Tensor]]:
    """One async iteration: every block of ``n // nb`` particles advances
    against its block-local best; the iteration's per-block winner (first
    on ties) is folded into the local best. The shared gbest is untouched
    until ``publish_async_locals``. ``index_offset`` shifts the particles'
    RNG indices, so an island owning particles [off, off + n) draws the
    monolithic swarm's slice (``core.distributed``)."""
    lbp, lbf = local
    n, d = s.pos.shape[-2:]
    lead = s.pos.shape[:-2]
    nb = lbf.shape[-1]
    bn = n // nb
    gb = lbp.repeat_interleave(bn, dim=-2)        # particle -> its block best
    pos, vel, fit = _advance(cfg, s, index_offset=index_offset, gbest_pos=gb,
                             coeffs=coeffs, hetero=hetero)
    pbest_pos, pbest_fit = _update_pbest(s, pos, fit,
                                         deb_selection_fn(cfg, hetero))
    fb = fit.reshape(*lead, nb, bn)
    bfit, bpos = _pick(fb, pos.reshape(*lead, nb, bn, d),
                       torch.argmax(fb, -1, True))
    take = bfit > lbf
    lbf = torch.where(take, bfit, lbf)
    lbp = torch.where(take[..., None], bpos, lbp)
    s = s._replace(pos=pos, vel=vel, fit=fit, pbest_pos=pbest_pos,
                   pbest_fit=pbest_fit, iteration=s.iteration + 1)
    return s, (lbp, lbf)


def publish_async_locals(s: SwarmState, local: Tuple[Tensor, Tensor]
                         ) -> Tuple[SwarmState, Tuple[Tensor, Tensor]]:
    """The sync point: publish the best local into gbest, then pull gbest
    back into every block's local."""
    s, (lbp, lbf) = flush_async_locals(s, local)
    return s, init_async_locals(s, lbf.shape[-1])


def flush_async_locals(s: SwarmState, local: Tuple[Tensor, Tensor]
                       ) -> Tuple[SwarmState, Tuple[Tensor, Tensor]]:
    """Publish-only half of a sync: afterwards ``gbest_fit ==
    max(pbest_fit)``, while the untouched locals let a resumed run continue
    each block where it left off."""
    lbp, lbf = local
    gp, gf = _take_best(lbf, lbp, s)
    return s._replace(gbest_pos=gp, gbest_fit=gf), (lbp, lbf)


def lbest_sync(s: SwarmState, local, topology: str
               ) -> Tuple[SwarmState, Tuple[Tensor, Tensor]]:
    """The scheduled sync of an lbest topology: flush the best local into
    gbest (for monitoring and the final answer), then give every block the
    best of its neighbourhood of locals (``block_neighbor_best``); gbest is
    never pulled back."""
    s, (lbp, lbf) = flush_async_locals(s, local)
    return s, block_neighbor_best(lbf, lbp, topology)


def _sync_point(s: SwarmState, local, sync_every: int, last: bool,
                topology: str = "gbest", shift=0):
    """After an async step: the scheduled sync where the swarm's iteration
    less ``shift`` is a multiple of ``sync_every`` (publish and pull gbest
    under the star, ``lbest_sync`` under an lbest ``topology``), else flush
    publish-only after the last step of the call. A batch decides per
    swarm, as its rows may stand at different iterations."""
    due = (s.iteration - shift) % sync_every == 0

    def scheduled(s, local):
        if topology == "gbest":
            return publish_async_locals(s, local)
        return lbest_sync(s, local, topology)
    if not isinstance(due, Tensor):
        if due:
            return scheduled(s, local)
        return flush_async_locals(s, local) if last else (s, local)
    pub_s, pub_l = scheduled(s, local)
    keep_s, keep_l = flush_async_locals(s, local) if last else (s, local)

    def pick(a, b):
        return torch.where(due.reshape(due.shape + (1,) * (a.dim() - 1)),
                           a, b)
    s = s._replace(gbest_pos=pick(pub_s.gbest_pos, keep_s.gbest_pos),
                   gbest_fit=pick(pub_s.gbest_fit, keep_s.gbest_fit))
    return s, (pick(pub_l[0], keep_l[0]), pick(pub_l[1], keep_l[1]))


def run_async(cfg: PSOConfig, state: SwarmState, iters: int,
              sync_every: int = ASYNC_SYNC_EVERY,
              n_blocks: Optional[int] = None, coeffs=None,
              hetero=None, index_offset: int = 0,
              phase: Optional[int] = None) -> SwarmState:
    """``iters`` iterations of relaxed-consistency async PSO (eager).

    Blocks run against block-local bests; the shared gbest is published
    and pulled at every iteration that is a multiple of ``sync_every``
    (aligned to absolute iteration numbers, so a resumed run keeps the
    uninterrupted schedule), and a call that ends between two such points
    flushes publish-only. Under an lbest ``cfg.topology`` the scheduled
    sync flushes gbest and pulls each block's neighbourhood best of the
    locals instead (``lbest_sync``). The result carries the block-local
    bests, and its ``gbest_fit`` equals ``max(pbest_fit)``. A state that
    carries locals of the same block count resumes them.

    ``phase`` (the reference's) places the call's start ``phase``
    iterations into a window instead: the island ring passes 0, so every
    round's schedule starts at the round. ``index_offset`` shifts the
    particles' RNG indices (``step_async``).
    """
    cfg = cfg.resolved()
    n = state.pos.shape[-2]
    nb = n_blocks or default_block_count(n)
    if n % nb:
        raise ValueError(f"n_blocks={nb} does not divide particle_cnt={n}")
    if iters <= 0:
        return state
    sync_every = max(1, sync_every)
    carried = (state.lbest_fit is not None and tuple(state.lbest_fit.shape)
               == tuple(state.gbest_fit.shape) + (nb,))
    local = ((state.lbest_pos, state.lbest_fit) if carried
             else init_async_locals(state, nb))
    shift = 0 if phase is None else state.iteration - phase
    s = state._replace(lbest_pos=None, lbest_fit=None)
    for t in range(iters):
        s, local = step_async(cfg, s, local, coeffs=coeffs, hetero=hetero,
                              index_offset=index_offset)
        s, local = _sync_point(s, local, sync_every, last=t == iters - 1,
                               topology=cfg.topology, shift=shift)
    return s._replace(lbest_pos=local[0], lbest_fit=local[1])


def run(cfg: PSOConfig, state: SwarmState, iters: int,
        variant: str = "queue", sync_every: int = ASYNC_SYNC_EVERY,
        n_blocks: Optional[int] = None, coeffs=None,
        hetero=None) -> SwarmState:
    """Run ``iters`` iterations with the chosen aggregation variant;
    ``sync_every``/``n_blocks`` only affect ``variant="async"``.
    ``coeffs``/``hetero`` are ``_advance``'s per-swarm hooks."""
    cfg = cfg.resolved()
    if variant == "async":
        return run_async(cfg, state, iters, sync_every=sync_every,
                         n_blocks=n_blocks, coeffs=coeffs, hetero=hetero)
    step = STEP_FNS[variant]
    state = state._replace(lbest_pos=None, lbest_fit=None)
    for _ in range(iters):
        state = step(cfg, state, coeffs=coeffs, hetero=hetero)
    return state


def run_with_history(cfg: PSOConfig, state: SwarmState, iters: int,
                     variant: str = "queue",
                     sync_every: int = ASYNC_SYNC_EVERY,
                     n_blocks: Optional[int] = None, coeffs=None,
                     hetero=None):
    """Like ``run`` but also records the gbest trajectory.

    Returns ``(state, (iterations, gbest_fits, violations))`` with one
    entry per sync point: every iteration for the synchronous variants,
    every ``sync_every`` boundary for ``async`` (the run is cut into
    ``run_async`` calls at the sync points, which its absolute-iteration
    schedule makes the uninterrupted run). ``iterations`` is a tuple of
    absolute iteration numbers; ``gbest_fits`` is ``[K]`` (``[K, S]`` for a
    batch), sampled into a tensor on the state's device. ``violations``
    holds the aggregate constraint violation of each recorded gbest, shaped as
    ``gbest_fits``, for a constrained problem, and is None otherwise (and
    for a heterogeneous batch, whose members report none, as in the
    reference). A batch is assumed in lockstep (its rows at one
    iteration), as the facades build it."""
    cfg = cfg.resolved()
    it0 = state.iteration
    start = int(it0 if not isinstance(it0, Tensor) else it0.reshape(-1)[0])
    async_ = variant == "async"
    stride = max(1, sync_every) if async_ else 1
    offs = range(0, max(iters, 0), stride)
    fits = torch.empty((len(offs),) + tuple(state.gbest_fit.shape),
                       dtype=state.gbest_fit.dtype,
                       device=state.gbest_fit.device)
    vf = cfg.problem.violation_fn if hetero is None else None
    viols = None if vf is None else torch.empty_like(fits)
    if not async_:
        state = state._replace(lbest_pos=None, lbest_fit=None)
    its = []
    for j, off in enumerate(offs):
        k = min(stride, iters - off)
        if async_:
            state = run_async(cfg, state, k, sync_every=sync_every,
                              n_blocks=n_blocks, coeffs=coeffs,
                              hetero=hetero)
        else:
            state = STEP_FNS[variant](cfg, state, coeffs=coeffs,
                                      hetero=hetero)
        fits[j] = state.gbest_fit
        if vf is not None:
            viols[j] = vf(state.gbest_pos)
        its.append(start + off + k)
    return state, (tuple(its), fits, viols)


def solve(cfg: PSOConfig, seed: int = 0, iters: int = 1000,
          variant: str = "queue", sync_every: int = ASYNC_SYNC_EVERY,
          device=None) -> SwarmState:
    """Convenience one-shot: init + run (eager engine)."""
    cfg = cfg.resolved()
    return run(cfg, init_swarm(cfg, seed, device=device), iters, variant,
               sync_every)
