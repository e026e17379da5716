"""Parallel PSO (PPSO) in PyTorch: config, state, and the aggregation
variants, ported from ``repro.core.pso``.

Variants (paper §3.2, §4): ``step_reduction`` (an unconditional argmax over
all pbests every iteration, the baseline), ``step_queue`` (gbest taken from
the lanes that beat the stale gbest), ``step_queue_lock`` (the predicated
pbest-argmax publication), and ``step_async``/``run_async`` (the paper's
enhanced queue-lock: blocks advance against block-local bests and publish
every ``sync_every`` iterations). All parallel variants are synchronous
PPSO: every particle sees the gbest of the previous iteration.

This eager engine is the CPU twin of the main-path kernels and the engine
of ``backend="eager"``. It keeps the reference's particle-major layout:
``pos`` is ``[N, D]``. Where the reference branches with ``lax.cond`` the
port selects with ``torch.where``, which needs no host round trip and gives
the same result.

``SwarmState.iteration`` and ``.seed`` are Python ints: they are RNG
counter components the host already knows, and kernel launches take them
as scalars.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .. import _device
from . import rng
from .blocking import default_block_count
from .problem import Bound, Problem, broadcast_bounds, resolve_problem
from .update_rules import TOPOLOGIES, resolve_rule

Tensor = torch.Tensor

#: ROADMAP item that ports the lbest topologies.
_TOPOLOGY_ITEM = "ROADMAP.md, port order item 4 (topologies)"


@dataclasses.dataclass(frozen=True)
class PSOConfig:
    """Static PSO configuration (paper Table 1), as in ``repro``.

    ``fitness`` is a registered problem name or a ``Problem``;
    ``min_pos``/``max_pos``/``max_v`` override the problem's domain, each a
    scalar or a length-``dim`` tuple. ``update_rule`` names the rule
    (``pso``/``sso``/``lowcost``). Only the ``"gbest"`` topology is ported.
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
        if self.topology != "gbest":
            raise NotImplementedError(
                f"topology={self.topology!r} is not ported yet: "
                f"{_TOPOLOGY_ITEM}")

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


def init_swarm(cfg: PSOConfig, seed: int, n: Optional[int] = None,
               index_offset: int = 0, device=None) -> SwarmState:
    """Initialize a swarm (paper Alg. 1 step 1), bit-exact with the
    reference's draws. ``device=None`` means the card."""
    dev = _device.resolve(device)
    cfg = cfg.resolved()
    n = cfg.particle_cnt if n is None else n
    d = cfg.dim
    dt = cfg.torch_dtype
    idx = _particle_index(n, d, dev, index_offset)
    u_pos = rng.uniform(seed, 0, STREAM_INIT_POS, idx, dtype=dt)
    u_vel = rng.uniform(seed, 0, STREAM_INIT_VEL, idx, dtype=dt)
    lo = _bound_operand(cfg.min_pos, dt, dev)
    hi = _bound_operand(cfg.max_pos, dt, dev)
    mv = _bound_operand(cfg.max_v, dt, dev)
    pos = lo + (hi - lo) * u_pos
    vel = -mv + 2.0 * mv * u_vel
    fit = cfg.fitness_fn(pos)
    best = torch.argmax(fit)
    return SwarmState(
        pos=pos, vel=vel, fit=fit, pbest_pos=pos, pbest_fit=fit,
        gbest_pos=pos[best], gbest_fit=fit[best],
        iteration=0, seed=int(seed) & 0xFFFFFFFF)


def _advance(cfg: PSOConfig, s: SwarmState, index_offset: int = 0,
             gbest_pos: Optional[Tensor] = None
             ) -> Tuple[Tensor, Tensor, Tensor]:
    """Alg. 1 steps 2–3: velocity/position update + fitness, vectorized.
    ``gbest_pos`` optionally overrides the social attractor (any shape
    broadcastable to [N, D]) — ``step_async`` passes each block's local
    best. Returns (pos, vel, fit) for iteration ``s.iteration + 1``."""
    n, d = s.pos.shape
    dt, dev = s.pos.dtype, s.pos.device
    it = s.iteration + 1
    gbp = s.gbest_pos[None, :] if gbest_pos is None else gbest_pos
    idx = _particle_index(n, d, dev, index_offset)
    r1 = rng.uniform(s.seed, it, STREAM_R1, idx, dtype=dt)
    r2 = rng.uniform(s.seed, it, STREAM_R2, idx, dtype=dt)
    pos, vel = resolve_rule(cfg.update_rule).advance(
        r1, r2, s.pos, s.vel, s.pbest_pos, gbp, w=cfg.w, c1=cfg.c1, c2=cfg.c2,
        mv=_bound_operand(cfg.max_v, dt, dev),
        lo=_bound_operand(cfg.min_pos, dt, dev),
        hi=_bound_operand(cfg.max_pos, dt, dev))
    return pos, vel, cfg.fitness_fn(pos)


def _update_pbest(s: SwarmState, pos: Tensor, fit: Tensor
                  ) -> Tuple[Tensor, Tensor]:
    improved = fit > s.pbest_fit
    pbest_fit = torch.where(improved, fit, s.pbest_fit)
    pbest_pos = torch.where(improved[:, None], pos, s.pbest_pos)
    return pbest_pos, pbest_fit


def _take_best(fit: Tensor, pos: Tensor, s: SwarmState):
    """gbest <- (fit[b], pos[b]) for b = argmax(fit) if it beats gbest."""
    best = torch.argmax(fit)
    take = fit[best] > s.gbest_fit
    return (torch.where(take, pos[best], s.gbest_pos),
            torch.where(take, fit[best], s.gbest_fit))


def step_reduction(cfg: PSOConfig, s: SwarmState) -> SwarmState:
    """Baseline: unconditional full argmax reduction (paper §3.2)."""
    pos, vel, fit = _advance(cfg, s)
    pbest_pos, pbest_fit = _update_pbest(s, pos, fit)
    gbest_pos, gbest_fit = _take_best(pbest_fit, pbest_pos, s)
    return s._replace(pos=pos, vel=vel, fit=fit, pbest_pos=pbest_pos,
                      pbest_fit=pbest_fit, gbest_pos=gbest_pos,
                      gbest_fit=gbest_fit, iteration=s.iteration + 1)


def step_queue(cfg: PSOConfig, s: SwarmState) -> SwarmState:
    """Queue algorithm (paper §4.1): the queue is the set of lanes whose
    fitness beats the stale gbest; its best member (first on ties) becomes
    gbest. With an empty queue nothing beats gbest and nothing is taken."""
    pos, vel, fit = _advance(cfg, s)
    pbest_pos, pbest_fit = _update_pbest(s, pos, fit)
    q = torch.where(fit > s.gbest_fit, fit, torch.full_like(fit, -torch.inf))
    gbest_pos, gbest_fit = _take_best(q, pos, s)
    return s._replace(pos=pos, vel=vel, fit=fit, pbest_pos=pbest_pos,
                      pbest_fit=pbest_fit, gbest_pos=gbest_pos,
                      gbest_fit=gbest_fit, iteration=s.iteration + 1)


def step_queue_lock(cfg: PSOConfig, s: SwarmState) -> SwarmState:
    """Queue-lock (paper §4.2), eager: gbest from the pbest argmax, taken
    only when it beats gbest (the reference predicates the argmax on any
    pbest improving; without an improvement the argmax cannot beat gbest,
    so selecting unconditionally gives the same state)."""
    pos, vel, fit = _advance(cfg, s)
    pbest_pos, pbest_fit = _update_pbest(s, pos, fit)
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
    lbp = state.gbest_pos[None, :].expand(n_blocks, -1).clone()
    lbf = state.gbest_fit.expand(n_blocks).clone()
    return lbp, lbf


def step_async(cfg: PSOConfig, s: SwarmState, local: Tuple[Tensor, Tensor]
               ) -> Tuple[SwarmState, Tuple[Tensor, Tensor]]:
    """One async iteration: every block of ``n // nb`` particles advances
    against its block-local best; the iteration's per-block winner (first
    on ties) is folded into the local best. The shared gbest is untouched
    until ``publish_async_locals``."""
    lbp, lbf = local
    n, d = s.pos.shape
    nb = lbf.shape[0]
    bn = n // nb
    gb = lbp.repeat_interleave(bn, dim=0)         # particle -> its block best
    pos, vel, fit = _advance(cfg, s, gbest_pos=gb)
    pbest_pos, pbest_fit = _update_pbest(s, pos, fit)
    fb = fit.reshape(nb, bn)
    bi = torch.argmax(fb, dim=1)
    bfit = fb.gather(1, bi[:, None])[:, 0]
    bpos = pos.reshape(nb, bn, d)[torch.arange(nb, device=pos.device), bi]
    take = bfit > lbf
    lbf = torch.where(take, bfit, lbf)
    lbp = torch.where(take[:, None], bpos, lbp)
    s = s._replace(pos=pos, vel=vel, fit=fit, pbest_pos=pbest_pos,
                   pbest_fit=pbest_fit, iteration=s.iteration + 1)
    return s, (lbp, lbf)


def publish_async_locals(s: SwarmState, local: Tuple[Tensor, Tensor]
                         ) -> Tuple[SwarmState, Tuple[Tensor, Tensor]]:
    """The sync point: publish the best local into gbest, then pull gbest
    back into every block's local."""
    s, (lbp, lbf) = flush_async_locals(s, local)
    return s, init_async_locals(s, lbf.shape[0])


def flush_async_locals(s: SwarmState, local: Tuple[Tensor, Tensor]
                       ) -> Tuple[SwarmState, Tuple[Tensor, Tensor]]:
    """Publish-only half of a sync: afterwards ``gbest_fit ==
    max(pbest_fit)``, while the untouched locals let a resumed run continue
    each block where it left off."""
    lbp, lbf = local
    b = torch.argmax(lbf)
    take = lbf[b] > s.gbest_fit
    gf = torch.where(take, lbf[b], s.gbest_fit)
    gp = torch.where(take, lbp[b], s.gbest_pos)
    return s._replace(gbest_pos=gp, gbest_fit=gf), (lbp, lbf)


def run_async(cfg: PSOConfig, state: SwarmState, iters: int,
              sync_every: int = ASYNC_SYNC_EVERY,
              n_blocks: Optional[int] = None,
              phase: Optional[int] = None) -> SwarmState:
    """``iters`` iterations of relaxed-consistency async PSO (eager).

    Blocks run against block-local bests; the shared gbest is published
    and pulled every ``sync_every`` iterations, aligned to absolute
    iteration numbers: an optional head chunk completes the window the
    resume point interrupted (``phase``, default ``iteration %
    sync_every``), full chunks follow, and a remainder flushes publish-only.
    The result carries the block-local bests, and its ``gbest_fit`` equals
    ``max(pbest_fit)``.
    """
    cfg = cfg.resolved()
    n = state.pos.shape[0]
    nb = n_blocks or default_block_count(n)
    if n % nb:
        raise ValueError(f"n_blocks={nb} does not divide particle_cnt={n}")
    if iters <= 0:
        return state
    sync_every = max(1, sync_every)
    phase = (state.iteration if phase is None else phase) % sync_every
    carried = (state.lbest_fit is not None
               and tuple(state.lbest_fit.shape) == (nb,))
    local = ((state.lbest_pos, state.lbest_fit) if carried
             else init_async_locals(state, nb))
    s = state._replace(lbest_pos=None, lbest_fit=None)

    def chunk(s, local, span, publish):
        for _ in range(span):
            s, local = step_async(cfg, s, local)
        return publish(s, local)

    if phase:
        head = min(iters, sync_every - phase)
        chunks, rem = divmod(iters - head, sync_every)
    else:
        head, (chunks, rem) = 0, divmod(iters, sync_every)
    if head:
        scheduled = head == sync_every - phase
        s, local = chunk(s, local, head, publish_async_locals if scheduled
                         else flush_async_locals)
    for _ in range(chunks):
        s, local = chunk(s, local, sync_every, publish_async_locals)
    if rem:
        s, local = chunk(s, local, rem, flush_async_locals)
    return s._replace(lbest_pos=local[0], lbest_fit=local[1])


def run(cfg: PSOConfig, state: SwarmState, iters: int,
        variant: str = "queue", sync_every: int = ASYNC_SYNC_EVERY,
        n_blocks: Optional[int] = None) -> SwarmState:
    """Run ``iters`` iterations with the chosen aggregation variant;
    ``sync_every``/``n_blocks`` only affect ``variant="async"``."""
    cfg = cfg.resolved()
    if variant == "async":
        return run_async(cfg, state, iters, sync_every=sync_every,
                         n_blocks=n_blocks)
    step = STEP_FNS[variant]
    state = state._replace(lbest_pos=None, lbest_fit=None)
    for _ in range(iters):
        state = step(cfg, state)
    return state


def solve(cfg: PSOConfig, seed: int = 0, iters: int = 1000,
          variant: str = "queue", sync_every: int = ASYNC_SYNC_EVERY,
          device=None) -> SwarmState:
    """Convenience one-shot: init + run (eager engine)."""
    cfg = cfg.resolved()
    return run(cfg, init_swarm(cfg, seed, device=device), iters, variant,
               sync_every)
