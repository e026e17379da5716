"""Island PSO, the port of ``repro.core.distributed``: one swarm split into
``n_shards`` equal islands of contiguous particles that iterate locally and
exchange their best.

The reference shards the islands over a device mesh with ``shard_map``. The
port keeps them in one process on the caller's one device: island ``s``
owns the rows ``[s * local_n, (s + 1) * local_n)`` of the global
``SwarmState``, and each collective becomes a reduction over the island
axis of the islands' stacked bests (``[k]`` fitness, ``[k, D]``
positions), as the reference's own tests run them under
``jax.vmap(axis_name=...)``. Between exchanges each island holds its own,
possibly stale, gbest. So there is no ``swarm_pspec``: the layout is the
row blocks, and a CUDA card holds every island (the port does not refuse
``n_shards`` above the device count, as the reference does).

* **Synchronous islands** (``variant`` queue, queue_lock, reduction): every
  round, each island takes ``exchange_interval`` local steps against its
  own gbest (the eager ``STEP_FNS[variant]``, or ``local_step_fn``, e.g.
  ``kernels.ops.make_fused_local_step``), then ``_pmax_best`` gives every
  island the best of all. ``exchange_interval=1`` is synchronous PPSO. As
  in the reference, the local steps draw at local particle indices, so the
  islands share one random stream. A shorter remainder round runs
  ``iters % exchange_interval`` and exchanges after it.
* **The async island ring** (``variant="async"``): each island runs the
  async engine (``pso.run_async``, its particles' global RNG indices) for a
  round, then pushes its best ``(fit, pos, owner)`` one hop around the ring
  (``ring_exchange``) and pulls a better one into its block locals. An
  island's best reaches every island within ``n_shards`` rounds, on top of
  ``sync_every`` iterations within an island; after the rounds,
  ``n_shards - 1`` drain hops leave every island's gbest equal to the max
  over all pbests. With one island the ring is ``run_async`` bit for bit.

``init_sharded_swarm`` builds each island from global particle indices
(``init_swarm(index_offset=)``), so a checkpoint of the global arrays
restores at any island count.
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Tuple

import torch

from .blocking import default_block_count
from .pso import (ASYNC_SYNC_EVERY, STEP_FNS, PSOConfig, SwarmState,
                  init_async_locals, init_swarm, run_async)

Tensor = torch.Tensor


def _pmax_best(fit: Tensor, pos: Tensor) -> Tuple[Tensor, Tensor]:
    """The islands' ``(fit [k], pos [k, D])`` reduced to the global best,
    returned to every island (``[k]``, ``[k, D]``). The reference's
    contract: the LOWEST island index achieving the max owns the
    broadcast; ``±inf`` fits take part (an all ``-inf`` swarm elects island
    0); a NaN fit counts as ``-inf`` and never owns the broadcast (an
    all-NaN swarm returns ``-inf`` and island 0's position)."""
    fit = torch.where(torch.isnan(fit), -torch.inf, fit)
    gfit = fit.max()
    winner = torch.argmax((fit >= gfit).to(torch.int32))   # first max
    k = fit.shape[0]
    return gfit.expand(k).clone(), pos[winner].expand(k, -1).clone()


def ring_exchange(gf: Tensor, gp: Tensor, owner: Tensor
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """One hop of the async island ring: island ``i`` receives island
    ``i - 1``'s known best ``(fit, pos, owner)`` and takes it under

        ``(recv_fit > fit) | (recv_fit == fit & recv_owner < owner)``

    so ties converge to the lowest originating island everywhere and NaN
    never propagates (NaN counts as ``-inf``). Islands forward the best they
    know, so a value reaches all ``k`` islands in ``k - 1`` hops."""
    gf = torch.where(torch.isnan(gf), -torch.inf, gf)
    rf, rp, ro = (torch.roll(x, 1, 0) for x in (gf, gp, owner))
    better = (rf > gf) | ((rf == gf) & (ro < owner))
    return (torch.where(better, rf, gf),
            torch.where(better[:, None], rp, gp),
            torch.where(better, ro, owner))


def init_sharded_swarm(cfg: PSOConfig, seed: int, n_shards: int,
                       device=None) -> SwarmState:
    """The global swarm built island by island on ``device`` (``None``:
    the card): island ``s`` from ``init_swarm(n=local_n,
    index_offset=s*local_n)``, gbest reconciled by ``_pmax_best``. One
    island is ``init_swarm`` exactly."""
    cfg = cfg.resolved()
    if cfg.particle_cnt % n_shards:
        raise ValueError(
            f"particle_cnt={cfg.particle_cnt} not divisible by {n_shards} "
            f"shards")
    if n_shards == 1:
        return init_swarm(cfg, seed, device=device)
    local_n = cfg.particle_cnt // n_shards
    shards = [init_swarm(cfg, seed, n=local_n, index_offset=s * local_n,
                         device=device) for s in range(n_shards)]
    gf, gp = _pmax_best(torch.stack([s.gbest_fit for s in shards]),
                        torch.stack([s.gbest_pos for s in shards]))
    return _join(shards)._replace(gbest_fit=gf[0], gbest_pos=gp[0])


_ROWS = ("pos", "vel", "fit", "pbest_pos", "pbest_fit")


def _split(state: SwarmState, n_shards: int) -> List[SwarmState]:
    """The global state as per-island states (row-block views), each with
    the global gbest and no block locals."""
    n = state.pos.shape[0]
    if n % n_shards:
        raise ValueError(f"particle_cnt={n} not divisible by {n_shards} "
                         f"shards")
    parts = {f: getattr(state, f).chunk(n_shards) for f in _ROWS}
    return [state._replace(lbest_pos=None, lbest_fit=None,
                           **{f: parts[f][s] for f in _ROWS})
            for s in range(n_shards)]


def _join(shards: List[SwarmState]) -> SwarmState:
    """Per-island states as one global state (new tensors): rows
    concatenated, gbest island 0's, block locals concatenated where the
    islands carry them."""
    s0 = shards[0]
    out = {f: torch.cat([getattr(s, f) for s in shards]) for f in _ROWS}
    if s0.lbest_fit is not None:
        out["lbest_pos"] = torch.cat([s.lbest_pos for s in shards])
        out["lbest_fit"] = torch.cat([s.lbest_fit for s in shards])
    return s0._replace(**out)


def make_distributed_run(cfg: PSOConfig, n_shards: int, iters: int,
                         variant: str = "queue",
                         exchange_interval: int = 1,
                         local_step_fn: Optional[Callable] = None,
                         sync_every: int = ASYNC_SYNC_EVERY,
                         n_blocks: Optional[int] = None
                         ) -> Callable[[SwarmState], SwarmState]:
    """``run(state) -> state`` over the global ``SwarmState`` of
    ``n_shards`` islands (module docstring).

    ``exchange_interval=1`` is synchronous PPSO; ``K`` runs K local
    iterations per exchange, and ``iters % K`` more as a remainder round.
    ``variant="async"`` runs the island ring, whose islands run
    ``run_async`` in ``n_blocks`` blocks each (by default
    ``default_block_count`` of an island); ``sync_every`` is clamped to
    ``exchange_interval`` and must divide it, so every round keeps the
    uninterrupted run's publication schedule. The ring's result carries
    the islands' block locals, ``[n_shards * nb]`` rows.
    ``local_step_fn(cfg, island_state) -> island_state`` replaces the
    synchronous variants' local step.
    """
    cfg = cfg.resolved()
    if variant == "async":
        if local_step_fn is not None:
            raise NotImplementedError(
                "variant='async' islands run the built-in eager run_async "
                "local loop; local_step_fn only overrides sync variants")
        return _make_async_ring_run(cfg, n_shards, iters, exchange_interval,
                                    sync_every, n_blocks)
    step = (local_step_fn if local_step_fn is not None
            else STEP_FNS[variant])
    rounds, rem = divmod(iters, exchange_interval)

    def one_round(shards, k: int):
        # k local iterations against each island's own (stale) gbest, then
        # the exchange
        out = []
        for s in shards:
            for _ in range(k):
                s = step(cfg, s)
            out.append(s)
        gf, gp = _pmax_best(torch.stack([s.gbest_fit for s in out]),
                            torch.stack([s.gbest_pos for s in out]))
        return [s._replace(gbest_fit=gf[i], gbest_pos=gp[i])
                for i, s in enumerate(out)]

    def run(state: SwarmState) -> SwarmState:
        shards = _split(state, n_shards)
        for _ in range(rounds):
            shards = one_round(shards, exchange_interval)
        if rem:
            shards = one_round(shards, rem)
        return _join(shards)

    return run


def _make_async_ring_run(cfg: PSOConfig, n_shards: int, iters: int,
                         exchange_interval: int, sync_every: int,
                         n_blocks: Optional[int]):
    """The async island ring's runner (``make_distributed_run``): the last
    hop of ``ring_rounds``, the islands joined."""
    # sync points must land on round boundaries, so every round keeps the
    # uninterrupted run's schedule
    sync_eff = min(sync_every, exchange_interval)
    if exchange_interval % sync_eff:
        raise ValueError(
            f"sync_every={sync_every} must divide "
            f"exchange_interval={exchange_interval} for async islands")

    def run(state: SwarmState) -> SwarmState:
        *_, (shards, _) = ring_rounds(cfg, state, n_shards, iters,
                                      exchange_interval, sync_eff, n_blocks)
        return _join(shards)

    return run


def ring_rounds(cfg: PSOConfig, state: SwarmState, n_shards: int,
                iters: int, exchange_interval: int, sync_every: int,
                n_blocks: Optional[int] = None
                ) -> Iterator[Tuple[List[SwarmState], Tensor]]:
    """The async island ring hop by hop: yields ``(islands, owner)`` as
    the islands start, then after each round's exchange and after each of
    the ``n_shards - 1`` drain hops; ``islands`` are the per-island states
    (their own gbest and block locals), ``owner`` ``[k]`` the island each
    one's gbest came from. Each round runs ``run_async`` with its schedule
    starting at the round (``phase=0``, as the reference's rounds) and the
    island's particles' global RNG indices; ``sync_every`` divides
    ``exchange_interval``."""
    cfg = cfg.resolved()
    local_n = cfg.particle_cnt // n_shards
    nb = n_blocks or default_block_count(local_n)
    rounds, rem = divmod(iters, exchange_interval)

    def exchange(shards, owner):
        gf, gp, owner = ring_exchange(
            torch.stack([s.gbest_fit for s in shards]),
            torch.stack([s.gbest_pos for s in shards]), owner)
        out = []
        for i, s in enumerate(shards):
            # pull the (possibly fresher) ring best into the block locals,
            # so the next round's blocks steer toward it at once
            take = gf[i] > s.lbest_fit
            out.append(s._replace(
                gbest_fit=gf[i], gbest_pos=gp[i],
                lbest_fit=torch.where(take, gf[i], s.lbest_fit),
                lbest_pos=torch.where(take[:, None], gp[i][None, :],
                                      s.lbest_pos)))
        return out, owner

    def one_round(shards, owner, k: int):
        out, raised = [], []
        for i, s in enumerate(shards):
            prev = s.gbest_fit
            s = run_async(cfg, s, k, sync_every=sync_every, n_blocks=nb,
                          index_offset=i * local_n, phase=0)
            raised.append(s.gbest_fit > prev)
            out.append(s)
        # a gbest raised during the local span is this island's discovery
        owner = torch.where(torch.stack(raised), torch.arange(
            n_shards, device=owner.device), owner)
        return exchange(out, owner)

    shards = []
    for s in _split(state, n_shards):
        lbp, lbf = init_async_locals(s, nb)
        shards.append(s._replace(lbest_pos=lbp, lbest_fit=lbf))
    owner = torch.arange(n_shards, device=state.pos.device)
    yield shards, owner
    for k in [exchange_interval] * rounds + ([rem] if rem else []):
        shards, owner = one_round(shards, owner, k)
        yield shards, owner
    # drain: the final bests reach every island
    for _ in range(n_shards - 1):
        shards, owner = exchange(shards, owner)
        yield shards, owner


def gather_swarm(state: SwarmState) -> SwarmState:
    """A host copy of the state (for checkpointing and inspection)."""
    return state._replace(**{
        f: getattr(state, f).detach().to("cpu", copy=True)
        for f in state._fields if isinstance(getattr(state, f), Tensor)})
