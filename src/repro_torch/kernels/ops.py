"""Swarm-level wrappers around the kernels, the port of
``repro.kernels.ops``: the queue algorithm's step, and the fused and async
functions, single swarm and batched.

They translate between the engine's particle-major ``SwarmState`` /
``SwarmBatch`` and the kernels' D-major operands, pick the block size, and
chain the async kernel's phases. Results match the eager
``repro_torch.core.pso`` variants (``step_queue`` iterated for the fused
kernel; ``run_async`` block semantics for the async kernel), and row ``s``
of a batch matches the single-swarm wrapper on ``batch_row(batch, s)``.

Every Problem that is not one of the six unconstrained built-ins (a custom
objective, a ``kernel_fn``, any constraint mode), and a heterogeneous table
with such a member, takes the split path (``kernels.pso_split``): two
kernels an iteration around the user's torch operators, with the same
results as the eager engine's ``step_queue`` iterated (fused) and
``run_async`` (async), and the Deb fold where it applies. The built-ins
keep ``pso_step``'s kernels.

The async functions follow ``cfg.topology``: the star pulls gbest at a
chunk entry, an lbest topology folds the neighbour blocks' local bests
(``pso_step``'s module docstring; ``pso_split`` in lockstep).

``telemetry=True`` makes the fused and async functions return ``(state,
counts)``: the kernels' contention counters, int32 ``[3]`` for one swarm
and ``[S, 3]`` for a batch (``repro_torch.telemetry``). ``run_queue_lock``
is the one entry point of the kernel backend: either variant, one swarm or
a batch, with or without the counters, and with ``history=True`` a gbest
sample at every sync point on operands packed once.

``AsyncLane`` is the serving scheduler's lane program: a batch held in the
kernels' layout for its whole lifetime, rows written into their columns at
admission, one chunk a dispatch, replayed from a CUDA graph on the card.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _device
from ..core.blocking import pick_block_n
from ..core.fitness import FITNESS_IDS, is_builtin
from ..core.multi_swarm import ProblemRows, SwarmBatch
from ..core.problem import Problem
from ..core.pso import (ASYNC_SYNC_EVERY, PSOConfig, SwarmState,
                        hetero_member_config)
from ..telemetry import trace as _trace
from ..telemetry import zero_counts
from . import pso_split, pso_step
from .pso_step import KernelSpec
# the phase split under the reference's name (repro.kernels.ops._async_spans)
from .pso_step import async_spans as _async_spans  # noqa: F401


def _resolve_block(n: int, block_n: Optional[int]) -> int:
    """Validate an explicit ``block_n`` or fall back to the heuristic pick."""
    bn = block_n or pick_block_n(n)
    if bn < 1 or n % bn:
        raise ValueError(
            f"block_n={bn} must be a positive divisor of particle_cnt={n}")
    return bn


def pack_dmajor(x: torch.Tensor) -> torch.Tensor:
    """[N, D] -> a new contiguous [D, N] (the kernels update it in place)."""
    return x.t().clone(memory_format=torch.contiguous_format)


def unpack_dmajor(arr: torch.Tensor) -> torch.Tensor:
    """[D, N] -> [N, D]."""
    return arr.t().contiguous()


#: ``KernelSpec.fitness`` of a Problem that takes the split path.
CONVERTED = -1


def kernel_spec(cfg: PSOConfig) -> KernelSpec:
    """Static kernel operands from a config: a built-in objective's id, or
    ``CONVERTED`` for any other Problem (the split path). The kernels, the
    built-ins' and the split path's, take float32 and bfloat16 (a
    heterogeneous table float32 only: the wrappers refuse it,
    ``pso_step.check_hetero``)."""
    cfg = cfg.resolved()
    if cfg.dtype not in ("float32", "bfloat16"):
        reason = (" (the reference's float16 draw, (h >> 8) in float16, "
                  "overflows to inf)" if cfg.dtype == "float16" else "")
        raise ValueError(f"the kernels take float32 and bfloat16, not "
                         f"{cfg.dtype}{reason}")
    prob = cfg.problem
    fid = FITNESS_IDS[prob.name] if is_builtin(prob) else CONVERTED
    return KernelSpec(fitness=fid, rule=cfg.update_rule,
                      w=cfg.w, c1=cfg.c1, c2=cfg.c2, lo=cfg.min_pos,
                      hi=cfg.max_pos, mv=cfg.max_v)


def state_to_kernel(s: SwarmState):
    """SwarmState -> new D-major operands (pos, vel, pbp, pbf, gp, gf)."""
    return (pack_dmajor(s.pos), pack_dmajor(s.vel), pack_dmajor(s.pbest_pos),
            s.pbest_fit.clone(), s.gbest_pos.clone(),
            s.gbest_fit.reshape(1).clone())


def kernel_to_state(s: SwarmState, pos, vel, pbp, pbf, gp, gf,
                    iters: int) -> SwarmState:
    return s._replace(
        pos=unpack_dmajor(pos), vel=unpack_dmajor(vel),
        fit=pbf,  # the kernels do not keep the raw fit; pbest_fit stands in
        pbest_pos=unpack_dmajor(pbp), pbest_fit=pbf,
        gbest_pos=gp, gbest_fit=gf[0], iteration=s.iteration + iters,
        lbest_pos=None, lbest_fit=None)


def queue_step(cfg: PSOConfig, s: SwarmState,
               block_n: Optional[int] = None) -> SwarmState:
    """One iteration of the paper's queue algorithm (§4.1): the queue
    kernel (on a CUDA state; its plain version on a CPU state), then
    ``queue_epilogue``, the paper's second kernel, in plain torch as the
    reference has it in jnp. Matches ``core.pso.step_queue`` (stale-gbest
    comparison); iterated, it is ``run_queue_lock_fused``'s synchronous
    PPSO."""
    cfg = cfg.resolved()
    n, _ = s.pos.shape
    bn = _resolve_block(n, block_n)
    spec = kernel_spec(cfg)
    pos, vel, pbp, pbf, gp, gf = state_to_kernel(s)
    if spec.fitness == CONVERTED:
        seeds, its = _seed_rows(s)
        pso_split.advance(pos, vel, pbp, gp[:, None], seeds, its, (spec,),
                          n=n, it_off=0, gdiv=n)
        fit, viol = pso_split.torch_step((cfg.problem,), None, n, (n,))(pos)
        nb = n // bn
        aux_fit = torch.empty(nb, dtype=pos.dtype, device=pos.device)
        aux_idx = torch.empty(nb, dtype=torch.int32, device=pos.device)
        pso_split.fold_publish(pos, pbp, pbf, fit, n=n, block_n=bn,
                               mode="queue", gf=gf,
                               pbv=_pbv(cfg, None, s.pbest_pos), viol=viol,
                               aux_fit=aux_fit, aux_idx=aux_idx)
    else:
        pos, vel, pbp, pbf, aux_fit, aux_idx = pso_step.queue_step(
            pos, vel, pbp, pbf, gp, gf, spec, seed=s.seed,
            iteration=s.iteration, block_n=bn)
    gp, gf = queue_epilogue(pos, gp, gf, aux_fit, aux_idx)
    return kernel_to_state(s, pos, vel, pbp, pbf, gp, gf, 1)


def queue_epilogue(pos, gp, gf, aux_fit, aux_idx):
    """The queue algorithm's cross-block stage on D-major operands: the
    block of the best ``aux_fit`` (the first on ties) wins, and its lane's
    column of ``pos`` replaces ``gp`` [D] if ``aux_fit`` beats ``gf`` [1].
    Returns new (gp, gf); it stays on the device (no host round trip)."""
    wb = torch.argmax(aux_fit)
    cand_fit = aux_fit[wb]
    take = cand_fit > gf
    cand_pos = pos.index_select(1, aux_idx[wb].reshape(1).long())[:, 0]
    return torch.where(take, cand_pos, gp), torch.where(take, cand_fit, gf)


def _seed_rows(s: SwarmState):
    """A swarm's (seed, iteration) as the split path's int64 ``[1]``
    operands."""
    dev = s.pos.device
    return (torch.tensor([s.seed], dtype=torch.int64, device=dev),
            torch.tensor([s.iteration], dtype=torch.int64, device=dev))


def _pbv(cfg: PSOConfig, fids, pbest_pos) -> Optional[torch.Tensor]:
    """The carried pbest violation ``[S*N]`` where the Deb fold applies
    (projection and repair modes, homogeneous), else None."""
    prob = cfg.problem
    if fids is not None or not prob.deb:
        return None
    return prob.violation_fn(pbest_pos).reshape(-1).to(
        pbest_pos.dtype).contiguous()


def _split_step(cfg, state, seeds, its, specs, table, fids, n: int,
                bn: int, lead, sync_every, cnt):
    """The ``step(off, k)`` of ``_chunked`` on the split path, for the
    D-major ``state`` (plus the async locals) of ``table``'s problems."""
    step = pso_split.torch_step(tuple(table), fids, n, lead)
    pbv = _pbv(cfg, fids, state[2].t().reshape(*lead, state[2].shape[0]))
    counters = (pso_split.uint32_rows(seeds, its, state[0].device)
                if state[0].device.type == "cuda" else None)

    def run(off, k):
        pso_split.iterate(state, seeds, its, specs, fids, step, n=n,
                          block_n=bn, off=off, iters=k,
                          sync_every=sync_every, pbv=pbv, counts=cnt,
                          counters=counters, topology=cfg.topology)
    return run


def _kernel_name(split: bool, sync_every: Optional[int]) -> str:
    """The kernel a launch runs, as its ``ops.launch`` span names it: the
    split path's kernels are ``split``."""
    if split:
        return "split"
    return "fused_kernel" if sync_every is None else "async_kernel"


def _launch(step, kernel: str, off: int, k: int,
            sync_every: Optional[int]) -> None:
    """``step(off, k)``, one call of ``kernel``'s wrapper, in an
    ``ops.launch`` span whose ``args`` give the kernel, its iterations and
    the ``sync_every`` that phases an async run's launches (a remainder is
    a second launch in the same call: ``async_spans``)."""
    tok = _trace.begin("ops.launch")
    if tok is not None:
        tok.args = (("kernel", kernel), ("iters", k),
                    ("sync_every", sync_every))
    try:
        step(off, k)
    finally:
        _trace.end(tok)


def _chunked(step, iters: int, stride: Optional[int], start: int, gf,
             gp=None, kernel: str = "fused_kernel",
             sync_every: Optional[int] = None):
    """Run ``step(offset, k)`` over ``iters`` iterations (``_launch``: a
    call of ``kernel``'s wrapper, ``sync_every`` its phases): in one call
    of all of them (``stride`` None), or in chunks of ``stride`` (the last
    shorter), copying the gbest fitness ``gf`` (and, given ``gp``, the
    gbest position) after each chunk into a tensor allocated once on its
    device, so sampling adds no host round trip. Returns (the absolute
    iteration after each chunk, from ``start``, the [K, *gf.shape]
    samples, the [K, *gp.shape] samples or None), or (None, None,
    None)."""
    if stride is None:
        _launch(step, kernel, 0, iters, sync_every)
        return None, None, None
    offs = range(0, iters, stride)
    fits = torch.empty((len(offs),) + tuple(gf.shape), dtype=gf.dtype,
                       device=gf.device)
    gps = None if gp is None else gp.new_empty((len(offs),) + tuple(gp.shape))
    its = []
    for j, off in enumerate(offs):
        k = min(stride, iters - off)
        _launch(step, kernel, off, k, sync_every)
        fits[j].copy_(gf)
        if gps is not None:
            gps[j].copy_(gp)
        its.append(start + off + k)
    return its, fits, gps


def _run_single(cfg: PSOConfig, s: SwarmState, iters: int,
                block_n: Optional[int], telemetry: bool,
                sync_every: Optional[int] = None,
                stride: Optional[int] = None, positions: bool = False):
    """One swarm through the fused kernel (``sync_every`` None) or the
    async kernel, on D-major operands packed once and unpacked once, in
    one run or in chunks of ``stride`` (``_chunked``). Returns (state,
    (iterations, [K] gbest_fit, [K, D] gbest_pos where ``positions``) or
    Nones, counts [3] or None)."""
    cfg = cfg.resolved()
    n, _ = s.pos.shape
    bn = _resolve_block(n, block_n)
    spec = kernel_spec(cfg)
    cnt = zero_counts(1, s.pos.device) if telemetry else None
    tok = _trace.begin("ops.pack")
    try:
        ops = state_to_kernel(s)
        lp = lf = None
        if sync_every is not None:
            nb = n // bn
            if s.lbest_fit is not None and tuple(s.lbest_fit.shape) == (nb,):
                lp, lf = pack_dmajor(s.lbest_pos), s.lbest_fit.clone()
            else:                       # local bests seeded from gbest
                lp, lf = ops[4][:, None].repeat(1, nb), ops[5].repeat(nb)
    finally:
        _trace.end(tok)
    split = spec.fitness == CONVERTED
    if split:
        seeds, its = _seed_rows(s)
        state = ops[:4] + (ops[4][:, None], ops[5]) + (
            () if lp is None else (lp, lf))
        step = _split_step(cfg, state, seeds, its, (spec,), (cfg.problem,),
                           None, n, bn, (n,), sync_every, cnt)
    elif sync_every is None:
        def step(off, k):
            pso_step.fused(*ops, spec, seed=s.seed,
                           iteration=s.iteration + off, iters=k, block_n=bn,
                           counts=cnt)
    else:
        def step(off, k):
            pso_step.fused_async(*ops, lp, lf, spec, seed=s.seed,
                                 iteration=s.iteration + off, iters=k,
                                 sync_every=sync_every, block_n=bn,
                                 counts=cnt, topology=cfg.topology)
    its, fits, gps = _chunked(step, iters, stride, s.iteration, ops[5],
                              ops[4] if positions else None,
                              _kernel_name(split, sync_every), sync_every)
    tok = _trace.begin("ops.unpack")
    try:
        out = kernel_to_state(s, *ops, iters)
        if sync_every is not None:
            out = out._replace(lbest_pos=unpack_dmajor(lp), lbest_fit=lf)
    finally:
        _trace.end(tok)
    return out, (its, None if fits is None else fits[:, 0], gps), cnt


def run_queue_lock_fused(cfg: PSOConfig, s: SwarmState, iters: int,
                         block_n: Optional[int] = None,
                         telemetry: bool = False):
    """``iters`` iterations of the fused queue-lock in ONE kernel launch
    (on a CUDA state; the plain version on a CPU state). ``telemetry=True``
    returns ``(state, counts)``, the [3] int32 contention counters."""
    out, _, cnt = _run_single(cfg, s, iters, block_n, telemetry)
    return (out, cnt) if telemetry else out


def run_queue_lock_fused_async(cfg: PSOConfig, s: SwarmState, iters: int,
                               sync_every: int = ASYNC_SYNC_EVERY,
                               block_n: Optional[int] = None,
                               telemetry: bool = False):
    """``iters`` iterations of the ASYNC queue-lock: each particle block
    runs ``sync_every`` iterations per chunk against its block-local best,
    touching the shared gbest only at chunk boundaries. A state that
    carries block-local bests of the same block count resumes them. With a
    single block the result equals ``run_queue_lock_fused``.
    ``telemetry=True`` returns ``(state, counts)``, the [3] int32
    contention counters summed over the launches (the remainder phase
    included)."""
    out, _, cnt = _run_single(cfg, s, iters, block_n, telemetry,
                              sync_every=sync_every)
    return (out, cnt) if telemetry else out


def make_fused_local_step(iters_per_call: int = 1,
                          block_n: Optional[int] = None):
    """The fused kernel as the ``local_step_fn`` of synchronous islands
    (``core.distributed``): ``iters_per_call`` iterations of
    ``run_queue_lock_fused`` on one island's rows (row 2 on a CUDA state;
    a custom Problem's split kernels; the plain versions on a CPU state).
    As in the reference, no index offset: every island draws at its local
    indices from the swarm's seed. The reference's ``interpret`` has no
    counterpart. Each call packs the island's rows D-major and unpacks
    them again."""
    def step(cfg: PSOConfig, s: SwarmState) -> SwarmState:
        return run_queue_lock_fused(cfg, s, iters_per_call, block_n=block_n)
    return step


def pack_dmajor_batch(x: torch.Tensor) -> torch.Tensor:
    """[S, N, D] -> a new contiguous [D, S*N] (swarm s owns columns
    [s*N, (s+1)*N))."""
    return pack_dmajor(x.reshape(-1, x.shape[-1]))


def unpack_dmajor_batch(arr: torch.Tensor, s_cnt: int) -> torch.Tensor:
    """[D, S*N] -> [S, N, D]."""
    return unpack_dmajor(arr).reshape(s_cnt, arr.shape[1] // s_cnt, -1)


def _hetero_members(cfg: PSOConfig, table: Sequence[Problem]):
    """The kernels' member table for a heterogeneous batch: member ``k`` is
    what a homogeneous kernel of ``table[k]`` at this dim/coeffs/dtype
    takes (``hetero_member_config`` re-derives its bounds). Float32 only:
    the wrappers refuse another dtype (``pso_step.check_hetero``)."""
    return tuple(kernel_spec(hetero_member_config(cfg, p)) for p in table)


def _batch_to_kernel(cfg: PSOConfig, batch: SwarmBatch, fids, table):
    """SwarmBatch -> new D-major operands (pos, vel, pbp, pbf, gp, gf) and
    the member table."""
    if fids is None:
        specs = (kernel_spec(cfg),)
    elif table is None:
        raise ValueError("fids= needs the dispatch table= it indexes")
    else:
        specs = _hetero_members(cfg, table)
    ops = (pack_dmajor_batch(batch.pos), pack_dmajor_batch(batch.vel),
           pack_dmajor_batch(batch.pbest_pos),
           batch.pbest_fit.reshape(-1).clone(), pack_dmajor(batch.gbest_pos),
           batch.gbest_fit.clone())
    return ops, specs


def _kernel_to_batch(batch: SwarmBatch, pos, vel, pbp, pbf, gp, gf,
                     iters: int) -> SwarmBatch:
    s_cnt = batch.swarm_cnt
    pbf = pbf.reshape(s_cnt, -1)
    return batch._replace(
        pos=unpack_dmajor_batch(pos, s_cnt),
        vel=unpack_dmajor_batch(vel, s_cnt),
        fit=pbf,  # the kernels do not keep the raw fit; pbest_fit stands in
        pbest_pos=unpack_dmajor_batch(pbp, s_cnt), pbest_fit=pbf,
        gbest_pos=unpack_dmajor(gp), gbest_fit=gf,
        iteration=batch.iteration + iters, lbest_pos=None, lbest_fit=None)


def _run_batch(cfg: PSOConfig, batch: SwarmBatch, iters: int,
               block_n: Optional[int], telemetry: bool, fids, table,
               sync_every: Optional[int] = None,
               stride: Optional[int] = None, positions: bool = False):
    """``_run_single`` for a batch: the batched fused or async kernel.
    Returns (batch, (iterations, [K, S] gbest_fit, [K, S, D] gbest_pos
    where ``positions``) or Nones, counts [S, 3] or None)."""
    cfg = cfg.resolved()
    s_cnt, n, _ = batch.pos.shape
    bn = _resolve_block(n, block_n)
    cnt = zero_counts(s_cnt, batch.pos.device) if telemetry else None
    tok = _trace.begin("ops.pack")
    try:
        ops, specs = _batch_to_kernel(cfg, batch, fids, table)
        lp = lf = None
        if sync_every is not None:
            nb = n // bn
            if batch.lbest_fit is not None \
                    and tuple(batch.lbest_fit.shape) == (s_cnt, nb):
                lp = pack_dmajor_batch(batch.lbest_pos)
                lf = batch.lbest_fit.reshape(-1).clone()
            else:                     # local bests seeded from each gbest
                lp = ops[4].repeat_interleave(nb, dim=1)
                lf = ops[5].repeat_interleave(nb)
    finally:
        _trace.end(tok)
    split = any(m.fitness == CONVERTED for m in specs)
    if split:
        step = _split_step(cfg, ops + (() if lp is None else (lp, lf)),
                           batch.seed, batch.iteration, specs,
                           (cfg.problem,) if fids is None else table, fids,
                           n, bn, (s_cnt, n), sync_every, cnt)
    elif sync_every is None:
        def step(off, k):
            pso_step.fused_batch(*ops, batch.seed, batch.iteration + off,
                                 specs, iters=k, block_n=bn, fids=fids,
                                 counts=cnt)
    else:
        def step(off, k):
            pso_step.fused_async_batch(*ops, lp, lf, batch.seed,
                                       batch.iteration + off, specs, iters=k,
                                       sync_every=sync_every, block_n=bn,
                                       fids=fids, counts=cnt,
                                       topology=cfg.topology)
    start = int(batch.iteration[0]) if stride is not None else 0
    its, fits, gps = _chunked(step, iters, stride, start, ops[5],
                              ops[4] if positions else None,
                              _kernel_name(split, sync_every), sync_every)
    tok = _trace.begin("ops.unpack")
    try:
        out = _kernel_to_batch(batch, *ops, iters)
        if sync_every is not None:
            out = out._replace(lbest_pos=unpack_dmajor_batch(lp, s_cnt),
                               lbest_fit=lf.reshape(s_cnt, nb))
    finally:
        _trace.end(tok)
    return out, (its, fits, None if gps is None
                 else gps.transpose(1, 2).contiguous()), (
        None if cnt is None else cnt.reshape(s_cnt, 3))


def run_queue_lock_fused_batch(cfg: PSOConfig, batch: SwarmBatch, iters: int,
                               block_n: Optional[int] = None, fids=None,
                               table: Optional[Sequence[Problem]] = None,
                               telemetry: bool = False):
    """S independent swarms x ``iters`` fused queue-lock iterations: one
    kernel launch, or one a wave of swarms where a batch of several-block
    swarms does not fit on the card at once (on a CUDA batch; the plain
    version on a CPU batch). Per-swarm seeds, iteration counters and gbest
    slots, so row ``s`` equals ``run_queue_lock_fused`` on
    ``batch_row(batch, s)`` with the same ``block_n``. ``fids``/``table``
    (``multi_swarm.problem_rows``) make the batch heterogeneous: ``cfg``
    then gives only dim, rule and coefficients. ``telemetry=True`` returns
    ``(batch, counts)`` with row ``s`` of the [S, 3] counts swarm ``s``'s
    (a heterogeneous batch counts per row too)."""
    out, _, cnt = _run_batch(cfg, batch, iters, block_n, telemetry, fids,
                             table)
    return (out, cnt) if telemetry else out


def run_queue_lock_fused_async_batch(cfg: PSOConfig, batch: SwarmBatch,
                                     iters: int,
                                     sync_every: int = ASYNC_SYNC_EVERY,
                                     block_n: Optional[int] = None,
                                     fids=None,
                                     table: Optional[Sequence[Problem]] = None,
                                     telemetry: bool = False):
    """S independent swarms through the async queue-lock: one launch of
    every swarm's blocks per ``_async_spans`` phase, with per-(swarm,
    block) local bests, so row ``s`` equals ``run_queue_lock_fused_async``
    on ``batch_row(batch, s)`` with the same ``block_n``/``sync_every``
    (up to the multi-block publication race). A batch that carries local
    bests of shape ``(S, nb)`` resumes them. ``fids``/``table`` and
    ``telemetry`` as in ``run_queue_lock_fused_batch``."""
    out, _, cnt = _run_batch(cfg, batch, iters, block_n, telemetry, fids,
                             table, sync_every=sync_every)
    return (out, cnt) if telemetry else out


def run_queue_lock(cfg: PSOConfig, state, iters: int, variant: str,
                   sync_every: int = ASYNC_SYNC_EVERY,
                   block_n: Optional[int] = None, telemetry: bool = False,
                   history: bool = False, fids=None,
                   table: Optional[Sequence[Problem]] = None,
                   positions: bool = False
                   ) -> Tuple[object, Tuple, Optional[torch.Tensor]]:
    """``state`` (a ``SwarmState``, or a ``SwarmBatch`` with
    ``fids``/``table`` as above) through the fused kernel
    (``variant="queue_lock"``) or the async kernel, as the functions above
    run it. ``history=True`` launches once a sync point instead (every
    iteration for the fused kernel, every ``sync_every`` for async) and
    samples gbest_fit after each launch; the D-major operands are packed
    once and unpacked once, the samples stay on the device until the
    caller reads them, and the result equals chunk-by-chunk calls of the
    functions above. Returns (state, (the absolute iteration of each
    sample, gbest_fit [K] or [K, S]) or (None, None), counts [3] / [S, 3]
    or None); ``positions=True`` adds the sampled gbest_pos ([K, D] or
    [K, S, D]) to the history pair."""
    async_ = variant == "async"
    kw = dict(sync_every=sync_every if async_ else None, stride=None,
              positions=positions)
    if history:
        kw["stride"] = max(1, sync_every) if async_ else 1
    if isinstance(state, SwarmBatch):
        out, hist, cnt = _run_batch(cfg, state, iters, block_n, telemetry,
                                    fids, table, **kw)
    else:
        out, hist, cnt = _run_single(cfg, state, iters, block_n, telemetry,
                                     **kw)
    return out, hist if positions else hist[:2], cnt


class AsyncLane:
    """A serving lane: ``width`` rows of one solve shape held in the
    kernels' D-major layout for the lane's whole lifetime, advanced a chunk
    of ``sync_every`` async iterations a dispatch (``cfg.topology``'s pull
    at each chunk entry).

    The layout is ``_batch_to_kernel``'s: ``pos``/``vel``/``pbp`` ``[D,
    S*n]``, ``pbf`` ``[S*n]``, ``gp`` ``[D, S]``, ``gf`` ``[S]``, the locals
    ``lp`` ``[D, S*nb]`` and ``lf`` ``[S*nb]``, all in the config's dtype
    (float32, or bfloat16 for a homogeneous lane), the ``[2, S]`` (seed,
    iteration) ``counters`` and, for a heterogeneous lane (``table``, the
    kernels' member table), ``fids`` ``[S]``. ``admit`` writes a fresh row
    (``core.pso.init_swarm_async``) into its columns in place; ``gbest``
    and ``row`` read rows back. Every row stands at an iteration that is a
    multiple of ``sync_every`` (admission only at chunk boundaries), so one
    launch of one chunk is every row's own schedule: a row equals the
    single-swarm kernel run a chunk a launch.

    ``dispatch`` is one chunk. On the card it replays a CUDA graph captured
    once, when the lane is built (``pso_step.async_lane_launch``: zero the
    lock, one launch, the iteration counters raised on the device); a
    capture that fails raises, and nothing runs the launch uncaptured. On
    the CPU it runs the wrapper's plain version (``fused_async_batch``),
    only because the caller named the CPU. Launches count under
    ``pso_step.fused_async_batch`` (rows 6 and 7; a bfloat16 lane's also in
    ``.bf16_launches``), the captures in ``AsyncLane.captures``."""

    captures = 0

    def __init__(self, cfg: PSOConfig, width: int, sync_every: int, *,
                 table: Optional[Sequence[Problem]] = None,
                 block_n: Optional[int] = None, device=None):
        self.cfg = cfg = cfg.resolved()
        d, n = cfg.dim, cfg.particle_cnt
        self.width, self.sync_every = width, sync_every
        self.block_n = _resolve_block(n, block_n)
        self.nb = n // self.block_n
        self.specs = ((kernel_spec(cfg),) if table is None
                      else _hetero_members(cfg, table))
        if any(m.fitness == CONVERTED for m in self.specs):
            raise ValueError("a lane runs the built-ins' kernels; a custom "
                             "Problem takes the split path")
        self.device = dev = torch.device(device or "cuda")
        fl = dict(dtype=cfg.torch_dtype, device=dev)     # the swarm's dtype
        sn, snb = width * n, width * self.nb
        self.state = (torch.zeros(d, sn, **fl), torch.zeros(d, sn, **fl),
                      torch.zeros(d, sn, **fl), torch.zeros(sn, **fl),
                      torch.zeros(d, width, **fl), torch.zeros(width, **fl),
                      torch.zeros(d, snb, **fl), torch.zeros(snb, **fl))
        # the kernels read the counters as uint32 from int32; the plain
        # versions take the uint32 values in int64
        self.counters = torch.zeros(2, width, device=dev, dtype=(
            torch.int32 if dev.type == "cuda" else torch.int64))
        self.fids = (None if table is None else
                     torch.zeros(width, dtype=torch.int32, device=dev))
        self.seeds = [0] * width        # host mirrors of the counters
        self.iterations = [0] * width
        self._fresh = True
        self.graph = None
        if dev.type == "cuda":
            self._capture()

    @property
    def hetero(self) -> bool:
        return self.fids is not None

    def _count(self) -> None:
        if self.hetero:
            pso_step.fused_async_batch.hetero_launches += 1
        else:
            pso_step.count(pso_step.fused_async_batch, self.state[0].dtype,
                           1, self._lanes)

    def _capture(self) -> None:
        launch = pso_step.async_lane_launch(
            self.state, self.counters, self.specs, self.fids,
            block_n=self.block_n, sync_every=self.sync_every,
            topology=self.cfg.topology)
        self._lanes = launch.lanes
        # one launch outside the capture loads the kernel (CUDA loads a
        # module at its first launch), on buffers that hold no row yet
        launch()
        self._count()
        torch.cuda.synchronize(self.device)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), torch.cuda.graph(self.graph):
            launch()
        self._launch = launch
        AsyncLane.captures += 1

    def _views(self):
        """(pos, vel, pbp) ``[D, S, n]``, pbf ``[S, n]``, gp ``[D, S, 1]``,
        gf ``[S, 1]``, lp ``[D, S, nb]``, lf ``[S, nb]``: views whose
        second-to-last axis is the row."""
        d, s = self.cfg.dim, self.width
        pos, vel, pbp, pbf, gp, gf, lp, lf = self.state
        return (pos.view(d, s, -1), vel.view(d, s, -1), pbp.view(d, s, -1),
                pbf.view(s, -1), gp.unsqueeze(-1), gf.unsqueeze(-1),
                lp.view(d, s, -1), lf.view(s, -1))

    def admit(self, slot: int, state: SwarmState,
              one: Optional[ProblemRows] = None) -> None:
        """Write ``state`` (a fresh row with its locals, at iteration 0)
        into row ``slot``; ``one`` is its one-row descriptor set in a
        heterogeneous lane. The first admission writes it into every row, so
        rows never admitted hold a well-defined swarm (never read back)."""
        if state.lbest_fit is None or tuple(state.lbest_fit.shape) != (
                self.nb,):
            raise ValueError(f"a lane row carries {self.nb} block-local "
                             "bests (init_swarm_async)")
        if self.hetero != (one is not None):
            raise ValueError("a heterogeneous lane admits rows with their "
                             "descriptors; a homogeneous lane without")
        vals = (state.pos.T, state.vel.T, state.pbest_pos.T, state.pbest_fit,
                state.gbest_pos.unsqueeze(-1), state.gbest_fit.reshape(1),
                state.lbest_pos.T, state.lbest_fit)
        seed = int(state.seed) & 0xFFFFFFFF
        word = seed - 2 ** 32 if (seed >= 2 ** 31 and
                                  self.counters.dtype == torch.int32) else seed
        if self._fresh:
            for view, v in zip(self._views(), vals):
                view.copy_(v.unsqueeze(-2).expand_as(view))
            self.counters[0].fill_(word)
            self.counters[1].zero_()
            if one is not None:
                self.fids.copy_(one.fid[:1].expand(self.width))
            self.seeds = [seed] * self.width
            self.iterations = [0] * self.width
            self._fresh = False
            return
        for view, v in zip(self._views(), vals):
            view[..., slot, :].copy_(v)
        self.counters[0, slot].fill_(word)
        self.counters[1, slot].zero_()
        if one is not None:
            self.fids[slot:slot + 1].copy_(one.fid[:1])
        self.seeds[slot], self.iterations[slot] = seed, 0

    def dispatch(self) -> None:
        """Every row one chunk of ``sync_every`` iterations further."""
        if self.graph is not None:
            self.graph.replay()
            self._count()
        else:
            pso_step.fused_async_batch(
                *self.state, self.counters[0], self.counters[1], self.specs,
                iters=self.sync_every, sync_every=self.sync_every,
                block_n=self.block_n, fids=self.fids,
                topology=self.cfg.topology)
            self.counters[1].add_(self.sync_every)
        self.iterations = [i + self.sync_every for i in self.iterations]

    def gbest(self):
        """Every row's (gbest_fit ``[S]``, gbest_pos ``[S, D]``), copied
        to the host: two copies for the whole lane, not two a row."""
        return (_device.host(self.state[5]),
                _device.host(self.state[4].t()))

    def row(self, slot: int) -> SwarmState:
        """Row ``slot`` as a standalone swarm with its locals (views into
        the lane; the kernel wrappers copy what they are given)."""
        pos, vel, pbp, pbf, gp, gf, lp, lf = self._views()
        return SwarmState(
            pos=pos[:, slot].T, vel=vel[:, slot].T, fit=pbf[slot],
            pbest_pos=pbp[:, slot].T, pbest_fit=pbf[slot],
            gbest_pos=gp[:, slot, 0], gbest_fit=gf[slot, 0],
            iteration=self.iterations[slot], seed=self.seeds[slot],
            lbest_pos=lp[:, slot].T, lbest_fit=lf[slot])
