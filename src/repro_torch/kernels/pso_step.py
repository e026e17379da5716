"""Launching wrappers for the CUDA kernels, their plain PyTorch versions,
and launch counters.

The kernels are ``csrc/pso_step.cu``'s ``queue_kernel``, ``fused_kernel``
and ``async_kernel``. ``queue_step`` replaces
``repro.kernels.pso_step.queue_step_call`` (one iteration of the paper's
queue algorithm, one swarm). The other two have a swarm axis. Single
swarm: ``fused`` replaces
``repro.kernels.pso_step.fused_call`` (the fused queue-lock) and
``fused_async`` replaces ``fused_async_call`` (the async queue-lock).
Batches of S swarms: ``fused_batch`` replaces ``fused_batch_call`` and, with
``fids``, ``hetero_fused_batch_call``; ``fused_async_batch`` replaces
``fused_async_batch_call`` and ``hetero_fused_async_batch_call``.

Arrays are D-major: ``pos``/``vel``/``pbp`` ``[D, N]``, ``pbf`` ``[N]``,
``gp`` ``[D]``, ``gf`` ``[1]``, and for the async kernel ``lp`` ``[D, nb]``,
``lf`` ``[nb]``; a batch puts swarm s in columns ``[s*N, (s+1)*N)`` of
``[D, S*N]`` arrays, with ``gp`` ``[D, S]``, ``gf`` ``[S]``, ``lp``
``[D, S*nb]``, ``lf`` ``[S*nb]`` and per-swarm ``seeds``/``its`` int64
``[S]``. All contiguous and of one float dtype, float32 or bfloat16
(``KERNEL_DTYPES``): each dtype has a library of its own, built from the
same source (``csrc/pso_step.cu``; bfloat16 with ``-DPSO_T_BF16``, at its
first launch). A heterogeneous batch takes a table of ``KernelSpec``
members (same rule and coefficients, own objective and bounds) and
``fids[S]`` into it; a homogeneous batch is a table of one. Heterogeneous
batches are float32 only.

In bfloat16 the kernels and the plain versions compute what the
reference's kernels compute in that dtype (ROADMAP, parity contract,
"bfloat16"): every operation rounds to bfloat16, each Python constant is
rounded to bfloat16 first (``fitness.weak``), the draws are ``(h >> 8)``
rounded to bfloat16 times 2**-24, and an objective's sum over D adds its
rounded terms in float32 in dimension order and is rounded once
(``_objective_bf16``).

A wrapper updates its state tensors in place and returns them. On CUDA
tensors it launches its kernel (or raises); on CPU tensors, and only there,
it runs the plain version. The plain versions return new tensors and leave
their inputs alone:

* ``queue_plain``: one iteration against the read-only gbest, and each
  block's best improving lane as ``(aux_fit, aux_idx)``; the cross-block
  argmax is the caller's (``ops.queue_step``).
* ``fused_plain``: synchronous PPSO, vectorized over blocks — each
  iteration's gbest is the best lane (first on ties) of those beating the
  previous gbest. That is ``repro``'s ``ref.queue_step_oracle`` iterated;
  with a single block it is also ``ref.run_fused_oracle``.
* ``fused_async_plain``: block-major, mirroring
  ``ref.run_fused_async_oracle`` including the ``async_spans`` remainder
  phase and its ``topology`` — one valid interleaving of the kernel's
  race.
* ``fused_batch_plain``/``fused_async_batch_plain``: the single-swarm plain
  version on each row, which is the batched kernels' contract.

Each wrapper counts every launch of its kernel in ``<wrapper>.launches``
and the bfloat16 ones also in ``.bf16_launches`` (``count``), as
``gla.gla_forward`` does; the batch wrappers count heterogeneous launches
in ``.hetero_launches``.

The async wrappers and their plain versions take ``topology``: ``gbest``
(the paper's star: a chunk entry pulls the shared gbest) or an lbest
``ring``/``vonneumann`` (a chunk entry folds the neighbour blocks' local
bests, ``core.topology.kernel_neighbor_ids``; the shared gbest is only
flushed). ``neighbor_ids`` runs the kernels' own neighbour ids.

The fused and async wrappers and their plain versions take ``counts``, an
int32 ``[3*S]`` buffer (``repro_torch.telemetry``), and add each swarm's
contention events into it: with ``counts=None`` the kernels get a null
pointer and count nothing. ``queue_step`` has no counters, as the
reference's queue kernel has none.

In bfloat16 the fused and async kernels take two paths (``kernel_lanes``
picks by shape and alignment): the pair path, two neighbouring particles
a thread on packed bfloat16 arithmetic (``fused_pair_kernel``,
``async_pair_kernel``), and the lane path, a particle a thread, where
pairs cannot be formed (an odd block or swarm, operands off 4 bytes). Both
compute the same bits; lane-path launches also count in
``.bf16_lane_launches``.

All three kernels run each particle block on a cluster of C CTAs, each
CTA owning a slice of the dimensions; ``cluster_size`` picks C from the
swarm's shape alone, the same for every kernel, so a batch row and the
single swarm, the queue and the fused kernel, and the async kernel with one
block and the fused kernel, sum each objective in the same order.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Tuple

import torch

from ..core import rng
from ..core.fitness import BUILTIN_PROBLEMS, sum_f32, weak
from ..core.problem import Bound
from ..core.pso import STREAM_R1, STREAM_R2
from ..core.topology import LBEST_IDS, grid_dims, kernel_neighbor_ids
from ..core.update_rules import kernel_rule_id, resolve_rule

Tensor = torch.Tensor

#: The storage dtypes the kernels take, one library each.
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: The build variant (``_build.VARIANTS``) of each dtype's library.
_VARIANT = {torch.float32: "", torch.bfloat16: "bf16"}


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """The static operands of a kernel call: built-in objective id
    (``core.fitness.FITNESS_IDS``), rule name, coefficients and bounds
    (scalars or per-dimension tuples)."""

    fitness: int
    rule: str
    w: float
    c1: float
    c2: float
    lo: Bound
    hi: Bound
    mv: Bound


def async_spans(iters: int, sync_every: int) -> List[Tuple[int, int, int]]:
    """Split ``iters`` into (offset, span, chunk) phases for the async
    kernel: full ``sync_every`` chunks, then one shorter remainder chunk as
    a second phase. ``iters <= 0`` is a no-op; ``sync_every`` is clamped
    into [1, iters]."""
    if iters <= 0:
        return []
    sync_every = max(1, min(sync_every, iters))
    main = (iters // sync_every) * sync_every
    phases = [(0, main, sync_every)]
    if iters - main:
        phases.append((main, iters - main, iters - main))
    return phases


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _operands(spec: KernelSpec, device, dtype=torch.float32):
    """Bounds as the reference's kernels take them in ``dtype``: scalars
    stay Python floats (``weak``: rounded to bfloat16 in bfloat16),
    per-dimension tuples become [D, 1] columns of ``dtype``. Returns (lo,
    hi, max_v)."""
    def col(v):
        return weak(v, dtype) if not isinstance(v, tuple) else torch.tensor(
            v, dtype=dtype, device=device)[:, None]
    return col(spec.lo), col(spec.hi), col(spec.mv)


def _rule_operands(spec: KernelSpec, device, dtype=torch.float32) -> dict:
    """The rule's keyword operands in ``dtype``: the coefficients
    (``weak``) and ``_operands``'s bounds; ``span`` is the SSO rule's
    resample width where the rule may not take ``hi - lo`` itself: in
    bfloat16 with scalar bounds, the Python difference rounded, as the
    reference's weak typing gives."""
    lo, hi, mv = _operands(spec, device, dtype)
    span = None
    if dtype != torch.float32 and not isinstance(spec.lo, tuple):
        span = weak(spec.hi - spec.lo, dtype)
    return dict(w=weak(spec.w, dtype), c1=weak(spec.c1, dtype),
                c2=weak(spec.c2, dtype), lo=lo, hi=hi, mv=mv, span=span)


def _rng_index(n: int, d: int, device, base: int = 0) -> Tensor:
    """RNG element index ``particle * D + dim`` laid out [D, n]."""
    part = torch.arange(base, base + n, dtype=torch.int64, device=device)
    return part[None, :] * d + torch.arange(d, dtype=torch.int64,
                                            device=device)[:, None]


def _objective_bf16(fid: int, x: Tensor) -> Tensor:
    """Built-in objective ``fid`` of a [D, n] bfloat16 tile, maximized, as
    the reference's kernel forms (``repro.kernels.pso_step.
    _fitness_dmajor``) compute it in bfloat16: each operation rounded, the
    constants rounded (``weak``), the sums over D by ``sum_f32``.
    Rosenbrock takes ``(100 u) u`` in that order. Griewank's dimension
    index is a float32 column there, so its quotients, cosines and product
    are float32 and the fitness is rounded once, at the end (the
    reference's kernel cannot store that float32 fitness into its bfloat16
    pbest and raises; the port rounds it)."""
    d = x.shape[0]
    dt = x.dtype
    name = BUILTIN_PROBLEMS[fid].name
    if name == "cubic":
        return sum_f32(x * x * x - weak(0.8, dt) * (x * x) - 1000.0 * x
                       + 8000.0, 0)
    if name == "sphere":
        return -sum_f32(x * x, 0)
    if name == "rosenbrock":
        if d == 1:
            r = 1.0 - x[0]
            return -(r * r)
        a, b = x[:-1], x[1:]
        u = b - a * a
        r = 1.0 - a
        return -sum_f32(100.0 * u * u + r * r, 0)
    if name == "griewank":
        root = torch.sqrt(torch.arange(1, d + 1, dtype=torch.float32,
                                       device=x.device))
        p = torch.ones(x.shape[1], dtype=torch.float32, device=x.device)
        for k in range(d):
            p = p * torch.cos(x[k].float() / root[k])
        s = sum_f32(x * x, 0) / 4000.0
        return (-(s.float() - p + 1.0)).to(dt)
    two_pi = weak(2.0 * math.pi, dt)
    if name == "rastrigin":
        return -(weak(10.0 * d, dt)
                 + sum_f32(x * x - 10.0 * torch.cos(two_pi * x), 0))
    s1 = torch.sqrt(sum_f32(x * x, 0) / weak(d, dt))           # ackley
    s2 = sum_f32(torch.cos(two_pi * x), 0) / weak(d, dt)
    return -(-20.0 * torch.exp(weak(-0.2, dt) * s1) - torch.exp(s2) + 20.0
             + weak(math.e, dt))


def _objective(fid: int, pos: Tensor) -> Tensor:
    """Built-in objective ``fid`` of a [D, n] tile: the engine's form in
    float32, the reference kernels' bfloat16 form in bfloat16."""
    if pos.dtype == torch.float32:
        return BUILTIN_PROBLEMS[fid].fn(pos.T)
    return _objective_bf16(fid, pos)


def _advance(spec, ops, seed, it, pos, vel, pbp, att, idx):
    """One advance of a [D, n] tile against the attractor ``att`` [D, 1]
    (``ops``: ``_rule_operands``), plus the objective: (pos, vel, fit
    [n])."""
    r1 = rng.uniform(seed, it, STREAM_R1, idx, dtype=pos.dtype)
    r2 = rng.uniform(seed, it, STREAM_R2, idx, dtype=pos.dtype)
    pos, vel = resolve_rule(spec.rule).advance(r1, r2, pos, vel, pbp, att,
                                               **ops)
    return pos, vel, _objective(spec.fitness, pos)


def _fold_pbest(fit, pos, pbp, pbf):
    """pbest fold: (pbp, pbf) where the new fitness beats pbest."""
    imp = fit > pbf
    return torch.where(imp[None, :], pos, pbp), torch.where(imp, fit, pbf)


def _queue(fit, best):
    """The queue's members: each lane's fitness where it beats ``best``,
    else -inf."""
    return torch.where(fit > best, fit, torch.full_like(fit, -math.inf))


def _fold(fit, pos, pbp, pbf, best, best_pos):
    """pbest fold, then the queue: the best lane (first on ties) among
    those beating ``best`` replaces (best, best_pos)."""
    pbp, pbf = _fold_pbest(fit, pos, pbp, pbf)
    q = _queue(fit, best)
    b = torch.argmax(q)
    take = q[b] > best
    return (pbp, pbf, torch.where(take, q[b], best),
            torch.where(take, pos[:, b], best_pos))


def queue_plain(pos, vel, pbp, pbf, gp, gf, spec: KernelSpec, *, seed: int,
                iteration: int, block_n: int):
    """One queue-algorithm iteration (kernel 1 of the paper's two), the
    port of ``_make_sync_kernel(queue=True)``: every block advances
    against the read-only gbest (``gp`` [D], ``gf`` [1]) and folds pbest;
    block b reports the best fitness among its lanes that beat ``gf``
    (-inf when none does) and that lane's swarm-local index (first lane on
    ties, the block base when the queue is empty). Returns new
    (pos, vel, pbp, pbf, aux_fit [nb], aux_idx [nb] int32)."""
    d, n = pos.shape
    nb = n // block_n
    ops = _rule_operands(spec, pos.device, pos.dtype)
    pos, vel, fit = _advance(spec, ops, seed, iteration + 1, pos, vel, pbp,
                             gp[:, None], _rng_index(n, d, pos.device))
    pbp, pbf = _fold_pbest(fit, pos, pbp, pbf)
    q = _queue(fit, gf).reshape(nb, block_n)
    # first lane of the block's maximum; lane 0 (the base) on an empty queue
    lane = torch.argmax(q, 1)
    aux_idx = torch.arange(nb, device=pos.device) * block_n + lane
    return pos, vel, pbp, pbf, q.amax(1), aux_idx.to(torch.int32)


def _any_per_block(mask, block_n: int) -> Tensor:
    """How many blocks of ``block_n`` lanes hold a True lane (a 0-d int
    tensor: counting needs no host round trip)."""
    return mask.reshape(-1, block_n).any(1).sum()


def fused_plain(pos, vel, pbp, pbf, gp, gf, spec: KernelSpec, *, seed: int,
                iteration: int, iters: int, block_n: int, counts=None):
    """``iters`` synchronous queue-lock iterations; returns new
    (pos, vel, pbp, pbf, gp, gf). The result does not depend on
    ``block_n``: every block reads the previous iteration's gbest.

    ``counts`` (int32 ``[3]``, added into in place) counts per (iteration,
    block) as the kernel does: blocks with a lane beating the previous
    gbest (``queue_updates``, and as many ``publications``) and blocks with
    a lane improving its pbest (``block_improvements``). With one block
    these are ``ref.run_fused_oracle``'s counts.

    This is ``core.pso.step_queue`` iterated, written again on the kernel's
    own operands (D-major tiles, a ``KernelSpec``) rather than routed
    through the engine: it shares ``_advance``/``_fold`` with
    ``fused_async_plain``, so with one block the two plain versions agree
    bit for bit, as the two kernels must. The engine sums each particle's
    objective over a contiguous [N, D] row, which may round differently."""
    d, n = pos.shape
    bounds = _rule_operands(spec, pos.device, pos.dtype)
    idx = _rng_index(n, d, pos.device)
    for t in range(iters):
        pos, vel, fit = _advance(spec, bounds, seed, iteration + t + 1,
                                 pos, vel, pbp, gp[:, None], idx)
        if counts is not None:
            q = _any_per_block(fit > gf, block_n)
            counts += torch.stack((q, q, _any_per_block(fit > pbf, block_n))
                                  ).to(counts.dtype)
        pbp, pbf, gf, gp = _fold(fit, pos, pbp, pbf, gf, gp)
    return pos, vel, pbp, pbf, gp, gf


def fused_async_plain(pos, vel, pbp, pbf, gp, gf, lp, lf, spec: KernelSpec,
                      *, seed: int, iteration: int, iters: int,
                      sync_every: int, block_n: int, counts=None,
                      topology: str = "gbest"):
    """``iters`` async queue-lock iterations, block-major: block b runs its
    whole span before block b+1, refreshing its local best at chunk entry
    and publishing at chunk exit; a remainder runs as a second block-major
    phase. Returns new (pos, vel, pbp, pbf, gp, gf, lp, lf).

    The chunk entry pulls gbest under ``topology="gbest"``; under an lbest
    topology it folds the neighbours' slots of ``lp``/``lf`` in
    ``kernel_neighbor_ids`` order, and the chunk exit writes the block's
    own slot before it publishes to gbest (never pulled back), so block b
    sees block b-1's slot after b-1's whole span and block b+1's as it was
    at the start of the phase, as ``ref.run_fused_async_oracle(...,
    topology=)``.

    ``counts`` (int32 ``[3]``, added into in place) counts as
    ``ref.run_fused_async_oracle``'s ``counters``: iterations of a block
    with a lane beating its local best (``queue_updates``), chunk exits
    that write the shared gbest (``publications``) and iterations of a
    block with a lane improving its pbest (``block_improvements``)."""
    d, n = pos.shape
    bn = block_n
    nb = n // bn
    bounds = _rule_operands(spec, pos.device, pos.dtype)
    pos, vel, pbp, pbf, lp, lf = (t.clone() for t in
                                  (pos, vel, pbp, pbf, lp, lf))
    lbest = topology != "gbest"
    for off, span, k in async_spans(iters, sync_every):
        for b in range(nb):
            sl = slice(b * bn, (b + 1) * bn)
            p, v, bp, bf = pos[:, sl], vel[:, sl], pbp[:, sl], pbf[sl]
            lpb, lfb = lp[:, b], lf[b:b + 1]
            idx = _rng_index(bn, d, pos.device, base=b * bn)
            for c in range(span // k):
                if lbest:                           # chunk entry: neighbours
                    for nbr in kernel_neighbor_ids(b, nb, topology):
                        take = lf[nbr:nbr + 1] > lfb
                        lfb = torch.where(take, lf[nbr:nbr + 1], lfb)
                        lpb = torch.where(take, lp[:, nbr], lpb)
                else:                               # chunk entry: gbest
                    pull = gf > lfb
                    lfb = torch.where(pull, gf, lfb)
                    lpb = torch.where(pull, gp, lpb)
                for tl in range(k):
                    it = iteration + off + c * k + tl + 1
                    p, v, fit = _advance(spec, bounds, seed, it, p, v, bp,
                                         lpb[:, None], idx)
                    if counts is not None:
                        counts[0] += (fit > lfb).any().to(counts.dtype)
                        counts[2] += (fit > bf).any().to(counts.dtype)
                    bp, bf, lfb, lpb = _fold(fit, p, bp, bf, lfb, lpb)
                if lbest:                           # chunk exit: own slot
                    lp[:, b], lf[b:b + 1] = lpb, lfb
                pub = lfb > gf                      # chunk exit
                if counts is not None:
                    counts[1] += pub[0].to(counts.dtype)
                gf = torch.where(pub, lfb, gf)
                gp = torch.where(pub, lpb, gp)
            pos[:, sl], vel[:, sl], pbp[:, sl], pbf[sl] = p, v, bp, bf
            lp[:, b], lf[b:b + 1] = lpb, lfb
    return pos, vel, pbp, pbf, gp, gf, lp, lf


def _members(specs, fids, s_cnt: int, dtype: torch.dtype):
    """Each swarm's member of the table: member 0 without ``fids``."""
    if fids is None:
        return [specs[0]] * s_cnt
    check_hetero(dtype)
    return [specs[f] for f in fids.tolist()]


def _join(rows):
    """Per-swarm plain results -> the batch's D-major operands."""
    cols = list(zip(*rows))
    out = [torch.cat(cols[0], 1), torch.cat(cols[1], 1),
           torch.cat(cols[2], 1), torch.cat(cols[3]),
           torch.stack(cols[4], 1), torch.cat(cols[5])]
    if len(cols) > 6:
        out += [torch.cat(cols[6], 1), torch.cat(cols[7])]
    return tuple(out)


def _row_counts(counts, s: int):
    """Swarm s's three slots of a ``[3*S]`` counter buffer (a view, so the
    row's plain version adds into the buffer), or None."""
    return None if counts is None else counts[3 * s:3 * s + 3]


def fused_batch_plain(pos, vel, pbp, pbf, gp, gf, seeds, its, specs, *,
                      iters: int, block_n: int, fids=None, counts=None):
    """``fused_plain`` on every swarm of a batch: swarm s owns columns
    ``[s*N, (s+1)*N)`` of ``pos``/``vel``/``pbp``/``pbf`` and column s of
    ``gp`` ``[D, S]``/``gf`` ``[S]``, starts from ``seeds[s]``/``its[s]``
    and solves ``specs[fids[s]]`` (``specs[0]`` without ``fids``), adding
    its events into slots ``3s..3s+2`` of ``counts``. This row identity is
    the batched kernels' contract. Returns new tensors."""
    s_cnt = gf.shape[0]
    n = pos.shape[1] // s_cnt
    rows = []
    for s, (spec, seed, it) in enumerate(zip(
            _members(specs, fids, s_cnt, pos.dtype), seeds.tolist(),
            its.tolist())):
        c = slice(s * n, (s + 1) * n)
        rows.append(fused_plain(pos[:, c], vel[:, c], pbp[:, c], pbf[c],
                                gp[:, s], gf[s:s + 1], spec, seed=seed,
                                iteration=it, iters=iters, block_n=block_n,
                                counts=_row_counts(counts, s)))
    return _join(rows)


def fused_async_batch_plain(pos, vel, pbp, pbf, gp, gf, lp, lf, seeds, its,
                            specs, *, iters: int, sync_every: int,
                            block_n: int, fids=None, counts=None,
                            topology: str = "gbest"):
    """``fused_async_plain`` on every swarm of a batch, laid out as in
    ``fused_batch_plain``; swarm s's block-local bests are columns
    ``[s*nb, (s+1)*nb)`` of ``lp`` ``[D, S*nb]`` and ``lf`` ``[S*nb]``
    (an lbest fold reads slot ``s*nb + nbr``, within its swarm). Returns
    new tensors."""
    s_cnt = gf.shape[0]
    n = pos.shape[1] // s_cnt
    nb = n // block_n
    rows = []
    for s, (spec, seed, it) in enumerate(zip(
            _members(specs, fids, s_cnt, pos.dtype), seeds.tolist(),
            its.tolist())):
        c, cl = slice(s * n, (s + 1) * n), slice(s * nb, (s + 1) * nb)
        rows.append(fused_async_plain(
            pos[:, c], vel[:, c], pbp[:, c], pbf[c], gp[:, s], gf[s:s + 1],
            lp[:, cl], lf[cl], spec, seed=seed, iteration=it, iters=iters,
            sync_every=sync_every, block_n=block_n,
            counts=_row_counts(counts, s), topology=topology))
    return _join(rows)


# ---------------------------------------------------------------------------
# Kernel launching
# ---------------------------------------------------------------------------

#: The kernels' objective id for a heterogeneous batch: the objective is
#: read from the member table, per swarm.
HETERO = len(BUILTIN_PROBLEMS)


@functools.lru_cache(maxsize=None)
def _lib(dtype: torch.dtype = torch.float32):
    """The library of ``dtype``'s kernels, built at its first use."""
    import ctypes as c

    from . import _build
    lib = _build.load("pso_step", _VARIANT[dtype])
    p, i, u, f = c.c_void_p, c.c_int, c.c_uint, c.c_float
    lib.pso_fused_resident.argtypes = [i] * 5 + [c.POINTER(i)]
    lib.pso_cluster_capacity.argtypes = [i] * 3 + [c.POINTER(i)]
    lib.pso_fused_launch.argtypes = ([p] * 14 + [i] * 8 + [u, u, i, i]
                                     + [f] * 6 + [i, p])
    lib.pso_async_launch.argtypes = ([p] * 16 + [i] * 10 + [u, u, u, i, i]
                                     + [f] * 6 + [i, p])
    lib.pso_neighbor_ids.argtypes = [i] * 4 + [p, p]
    lib.pso_queue_launch.argtypes = ([p] * 9 + [i] * 4 + [u, u, i, i]
                                     + [f] * 6 + [i, p])
    for fn in (lib.pso_fused_resident, lib.pso_cluster_capacity,
               lib.pso_fused_launch, lib.pso_async_launch,
               lib.pso_queue_launch, lib.pso_neighbor_ids):
        fn.restype = i
    return lib


def _check(status: int, what: str) -> None:
    if status:
        raise RuntimeError(f"{what} failed: CUDA error {status}")


def _bound_rows(spec: KernelSpec, d: int, dtype=torch.float32):
    """One member's [4, D] rows (lo, hi, max_v, span) as the kernels read
    them: values of ``dtype``, as the plain version takes them
    (``_operands``), in a float32 table."""
    def row(v):
        if isinstance(v, tuple):
            return torch.tensor(v, dtype=dtype).tolist()
        return [weak(v, dtype)] * d
    lo, hi = row(spec.lo), row(spec.hi)
    # The SSO rule's resample width: as the plain version computes it,
    # in double (rounded to the dtype) for scalar bounds and in the dtype
    # for per-dim bounds.
    span = ([weak(spec.hi - spec.lo, dtype)] * d
            if not isinstance(spec.lo, tuple)
            else (torch.tensor(hi, dtype=dtype)
                  - torch.tensor(lo, dtype=dtype)).tolist())
    return [lo, hi, row(spec.mv), span]


def _upload(rows, dtype, dev):
    """Host values -> a device tensor. From pinned memory the upload is
    asynchronous: a pageable copy would hold the host until the stream
    drains, idling the card between calls."""
    return torch.tensor(rows, dtype=dtype, pin_memory=True).to(
        dev, non_blocking=True)


@functools.lru_cache(maxsize=64)
def _tables(specs, d: int, dev, dtype=torch.float32):
    """The members' [M, 4, D] bounds (values of ``dtype``) and [M]
    objective ids on ``dev``, uploaded once per table: the kernels only
    read them."""
    return (_upload([_bound_rows(m, d, dtype) for m in specs], torch.float32,
                    dev),
            _upload([m.fitness for m in specs], torch.int32, dev))


def _counters(seeds, its, dev):
    """The uint32 counters (seeds, iterations) of a launch: for a batch
    (int64 tensors) the [2, S] int32 operand the kernels read as unsigned,
    wrapped exactly on the card, and no scalars; for one swarm (host ints)
    no operand and the two scalars, passed by value (no upload a call)."""
    if isinstance(seeds, Tensor):
        x = torch.stack((seeds.to(dev, torch.int64),
                         its.to(dev, torch.int64)))
        return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32), (0, 0)
    (seed,), (it,) = seeds, its
    return None, (int(seed) & 0xFFFFFFFF, int(it) & 0xFFFFFFFF)


#: Cluster sizes the rule picks from (8 CTAs is Hopper's portable maximum;
#: the kernels take any size up to it). Powers of two, so that a
#: power-of-two block count spreads evenly over the SMs.
CLUSTER_SIZES = (2, 4, 8)
#: The fewest dimensions a CTA of a cluster owns. A single swarm gains from
#: a split down to slices of a few dimensions, but a batch that already
#: fills the card loses by it: a cluster barrier and C remote reads of the
#: partials an iteration, and C times fewer swarms a cooperative wave
#: (chip_smoke.py phase 5b: rastrigin d=10 n=1024 S=128 is slower at C=2,
#: d=24 about even; PERF.md). C may not depend on S, so it stays 1 where a
#: batch would lose.
MIN_SLICE = 12
#: A cluster takes one particle a thread, so blocks of up to 512.
MAX_CLUSTER_BLOCK = 512


def cluster_size(n: int, d: int, block_n: int, capacity) -> int:
    """How many CTAs each particle block of a swarm of ``n`` particles in
    ``d`` dimensions runs on, for all three kernels: the largest C in
    ``CLUSTER_SIZES`` that leaves every CTA at least ``MIN_SLICE``
    dimensions and, with several blocks, still lets the card hold all
    ``n // block_n`` clusters at once (``capacity(C)``: the fewest clusters
    of C any fused or async kernel keeps resident), since the fused
    kernel's cooperative launch needs them all and an async cluster that
    does not fit waits out another's whole span; 1 (one CTA a block, no
    cluster code) otherwise, at ``d < 2 * MIN_SLICE`` and so always at
    d = 1, and for blocks over ``MAX_CLUSTER_BLOCK``.

    Why the largest: one thread walks its particle's dimensions in turn,
    so a CTA's iteration time grows with its slice (D / C steps), and at
    the main shapes a swarm's blocks alone put too few threads on the card
    (64 CTAs of 512 threads at n=32768, 12% of an H100's thread slots).
    The choice depends on the swarm's shape and the card, never on the
    number of swarms S or the kernel: a batch row then sums its objective
    in the single swarm's order, the queue kernel in the fused kernel's,
    and the async kernel with one block in the fused kernel's, which it
    must equal bit for bit."""
    if block_n > MAX_CLUSTER_BLOCK:
        return 1
    nb = n // block_n
    best = 1
    for c in CLUSTER_SIZES:
        if d < c * MIN_SLICE or (nb > 1 and capacity(c) < nb):
            break
        best = c
    return best


def launch_plan(n: int, d: int, block_n: int, s_cnt: int, capacity,
                resident, cluster=None) -> Tuple[int, int]:
    """(cluster size, swarms a launch) of a fused call on S = ``s_cnt``
    swarms: C from ``cluster_size`` (or ``cluster``, where the caller sets
    it); with several blocks a swarm, the cooperative launch needs every
    cluster resident, so a wave holds ``resident(C) // nb`` swarms
    (``resident``: CTAs at C = 1, clusters above), and a swarm whose blocks
    alone do not fit raises. With one block a swarm, one normal launch
    takes all S."""
    c = cluster_size(n, d, block_n, capacity) if cluster is None else cluster
    nb = n // block_n
    if nb == 1:
        return c, s_cnt
    held = resident(c)
    if held < nb:
        raise RuntimeError(
            f"fused kernel: {nb} blocks of {min(block_n, 512)} threads on "
            f"clusters of {c} cannot all be resident ({held} fit on this "
            f"device); the cooperative launch needs every CTA at once — use "
            f"a larger block_n")
    return c, held // nb


def async_plan(n: int, d: int, block_n: int, s_cnt: int, capacity,
               cluster=None) -> Tuple[int, int]:
    """(cluster size, CTAs) of each async launch on S = ``s_cnt`` swarms:
    the fused kernel's C for the swarm's shape (``cluster_size``, or
    ``cluster`` where the caller sets it), and one normal launch of all S
    swarms' ``n // block_n`` clusters of C CTAs. A grid of 2^31 CTAs or
    more raises."""
    c = cluster_size(n, d, block_n, capacity) if cluster is None else cluster
    ctas = s_cnt * (n // block_n) * c
    if ctas >= 2 ** 31:
        raise ValueError(f"async kernel: {ctas} CTAs in one launch; a grid "
                         f"holds fewer than 2^31 — use a larger block_n")
    return c, ctas


def launch_fits(variant: str, n: int, d: int, block_n: int, s_cnt: int,
                capacity, resident) -> bool:
    """Whether the card takes a launch of ``variant`` (``queue_lock``: the
    fused kernel, ``launch_plan``; ``async``: ``async_plan``) on S =
    ``s_cnt`` swarms of ``n`` particles in blocks of ``block_n``, without
    raising: the fused kernel with several blocks needs every cluster of a
    swarm resident at once, the async grid fewer than 2^31 CTAs.
    ``capacity`` and ``resident`` are ``launch_plan``'s."""
    c = cluster_size(n, d, block_n, capacity)
    nb = n // block_n
    if variant == "async":
        return s_cnt * nb * c < 2 ** 31
    return nb == 1 or resident(c) >= nb


def _device_index(dev) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


@functools.lru_cache(maxsize=None)
def _resident(fit_id: int, rule_id: int, block_n: int, d: int, csize: int,
              device_index: int, dtype=torch.float32) -> int:
    """How many fused-kernel CTAs (``csize`` 1) or clusters of ``csize``
    CTAs of this configuration, in ``dtype``'s library, fit on the card
    at once."""
    import ctypes
    resident = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _check(_lib(dtype).pso_fused_resident(fit_id, rule_id, block_n, d,
                                              csize, ctypes.byref(resident)),
               "occupancy query")
    return resident.value


@functools.lru_cache(maxsize=None)
def _capacity(block_n: int, d: int, device_index: int, csize: int,
              dtype=torch.float32) -> int:
    """The fewest clusters of ``csize`` CTAs that any fused or async kernel
    of ``dtype``'s library keeps resident at (block_n, d) on the card:
    ``cluster_size``'s capacity. Shared memory holds float rows in both
    libraries, so the element size moves residency only through the
    kernels' registers, which this query reads."""
    import ctypes
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _check(_lib(dtype).pso_cluster_capacity(block_n, d, csize,
                                                ctypes.byref(out)),
               "cluster occupancy query")
    return out.value


def capacity_of(block_n: int, d: int, dev, dtype=torch.float32):
    """``cluster_size``'s ``capacity`` for (block_n, d) on ``dev`` in
    ``dtype``'s library."""
    return functools.partial(_capacity, block_n, d, _device_index(dev),
                             dtype=dtype)


def resident_of(fit_id: int, rule_id: int, block_n: int, d: int, dev,
                dtype=torch.float32):
    """``launch_plan``'s ``resident`` for one configuration on ``dev`` in
    ``dtype``'s library."""
    return functools.partial(_resident, fit_id, rule_id, block_n, d,
                             device_index=_device_index(dev), dtype=dtype)


def _cluster(n: int, d: int, block_n: int, dev, cluster=None,
             dtype=torch.float32) -> int:
    """The cluster size of a launch on ``dev``: ``cluster`` if given,
    else ``cluster_size`` on the card's capacity in ``dtype``'s library."""
    if cluster is not None:
        return cluster
    return cluster_size(n, d, block_n, capacity_of(block_n, d, dev, dtype))


def _launch_operands(state, seeds, its, specs, fids, block_n: int):
    """Validate a batch's operands for a launch and build what the kernels
    read besides the state. Returns (those tensors, in the launch's order,
    None where a pointer is null; the by-value seed and iteration; objective
    id, rule id, coefficients, n, d, s_cnt). The caller holds the tensors
    until its launches are enqueued: freed earlier, their memory could go
    to another tensor before the kernel reads them."""
    pos, gf = state[0], state[5]
    dev, dtype = pos.device, pos.dtype
    for t in state:
        if t.device != dev or dev.type != "cuda" or t.dtype != dtype \
                or dtype not in KERNEL_DTYPES or not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous tensors of "
                             "one dtype, float32 or bfloat16, on one CUDA "
                             f"device; got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device} beside {dtype} on {dev}")
    s_cnt = gf.shape[0]
    d, sn = pos.shape
    n = sn // max(s_cnt, 1)
    nb = n // block_n if block_n > 0 else 0
    want = [(d, sn)] * 3 + [(sn,), (d, s_cnt), (s_cnt,)]
    if len(state) > 6:
        want += [(d, s_cnt * nb), (s_cnt * nb,)]
    shapes = [tuple(t.shape) for t in state]
    if s_cnt < 1 or sn != s_cnt * n or block_n < 1 or n % block_n \
            or shapes != want:
        raise ValueError(f"state shapes {shapes} do not match S={s_cnt}, "
                         f"D={d}, N={n}, block_n={block_n}")
    if sn >= 2 ** 31:
        raise ValueError(f"S*N = {sn} particles: the kernels index columns "
                         f"in 32 bits, so a launch takes fewer than 2^31")
    if len({(m.rule, m.w, m.c1, m.c2) for m in specs}) != 1:
        raise ValueError("the members of a table share rule and "
                         "coefficients; they differ in objective and bounds")
    bounds, member_fit = _tables(tuple(specs), d, dev, dtype)
    if fids is None:
        if len(specs) != 1:
            raise ValueError("a table of several members needs fids")
        fit_id, member_fit = specs[0].fitness, None
    else:
        check_hetero(dtype)
        fids = fids.to(dev, torch.int32).contiguous()
        if tuple(fids.shape) != (s_cnt,) or not all(
                0 <= f < len(specs)
                for f in torch.stack(torch.aminmax(fids)).tolist()):
            raise ValueError(f"fids must be {s_cnt} indices into a table "
                             f"of {len(specs)} members")
        fit_id = HETERO
    spec = specs[0]
    coef = [weak(c, dtype) for c in (spec.w, spec.c1, spec.c2,
                                     *resolve_rule(spec.rule).kernel_consts())]
    counters, scalars = _counters(seeds, its, dev)
    rows = (None, None) if counters is None else (counters[0], counters[1])
    return ([bounds, member_fit, fids, *rows], scalars, fit_id,
            kernel_rule_id(spec.rule), coef, n, d, s_cnt)


def check_hetero(dtype: torch.dtype) -> None:
    """Heterogeneous batches are float32 only: the bfloat16 library has no
    heterogeneous kernel, and the reference's heterogeneous batch fails in
    bfloat16 too (its scan carries a float32 fitness beside bfloat16
    state). The plain versions (``_members``) refuse them as the kernel
    launches (``_launch_operands``) do."""
    if dtype != torch.float32:
        raise ValueError(f"heterogeneous batches take float32 only, not "
                         f"{dtype}: the bfloat16 kernels have no "
                         f"heterogeneous form, as the reference has none "
                         f"that runs")


def _ptrs(tensors):
    """Device pointers for a launch; None is the null pointer."""
    return [None if t is None else t.data_ptr() for t in tensors]


def _check_counts(counts, s_cnt: int, dev) -> None:
    """A counter buffer the kernels add into: contiguous int32 ``[3*S]`` on
    the state's device, or None (telemetry off: the null pointer)."""
    if counts is not None and (
            counts.dtype != torch.int32 or counts.device != dev
            or tuple(counts.shape) != (3 * s_cnt,)
            or not counts.is_contiguous()):
        raise ValueError(f"counts must be a contiguous int32 [{3 * s_cnt}] "
                         f"tensor on {dev}; got {counts.dtype} "
                         f"{tuple(counts.shape)} on {counts.device}")


def count(wrapper, dtype: torch.dtype, launches: int, lanes=None) -> None:
    """Adds ``launches`` of ``dtype``'s kernel to ``wrapper.launches``, a
    bfloat16 kernel's also to ``wrapper.bf16_launches`` and, on the queue,
    fused and async kernels' lane path (``lanes`` 1, ``kernel_lanes``), to
    ``wrapper.bf16_lane_launches``."""
    wrapper.launches += launches
    if dtype == torch.bfloat16:
        wrapper.bf16_launches += launches
        if lanes == 1:
            wrapper.bf16_lane_launches += launches


#: Particles a thread of the bfloat16 queue, fused and async kernels'
#: pair path.
PAIR = 2


def kernel_lanes(pos, vel, pbp, pbf, *, n: int, block_n: int) -> int:
    """The particles a thread the queue, fused and async kernels take for
    these operands: ``PAIR`` (the bfloat16 library's pair path,
    ``queue_pair_kernel``/``fused_pair_kernel``/``async_pair_kernel``)
    where the state is bfloat16, ``block_n`` and the swarm size ``n`` are
    even (no pair straddles two blocks or two swarms, and every swarm's
    columns start even) and pos, vel, pbest_pos and pbest_fit start on 4
    bytes; else 1 (float32's kernels; in bfloat16 the lane path,
    ``queue_kernel``/``fused_kernel``/``async_kernel``)."""
    if (pos.dtype != torch.bfloat16 or block_n % PAIR or n % PAIR
            or any(t.data_ptr() % 4 for t in (pos, vel, pbp, pbf))):
        return 1
    return PAIR


def _copy_into(state, out):
    """The CPU path of a wrapper: the plain version's results, in place."""
    for dst, src in zip(state, out):
        dst.copy_(src)
    return state


def queue_step(pos, vel, pbp, pbf, gp, gf, spec: KernelSpec, *, seed: int,
               iteration: int, block_n: int):
    """One queue-algorithm iteration of one swarm: ``pos``/``vel``/
    ``pbp``/``pbf`` updated in place, ``gp``/``gf`` only read; returns
    (pos, vel, pbp, pbf, aux_fit [nb], aux_idx [nb] int32). On CUDA
    tensors ONE normal launch of ``n // block_n`` clusters of
    ``cluster_size`` CTAs (the fused kernel's, so the two agree bit for
    bit; in bfloat16 on the path ``kernel_lanes`` picks, a lane-path
    launch also counted in ``queue_step.bf16_lane_launches``), on CPU
    tensors the plain version."""
    state = (pos, vel, pbp, pbf)
    kw = dict(seed=seed, iteration=iteration, block_n=block_n)
    if pos.device.type == "cpu":
        out = queue_plain(pos, vel, pbp, pbf, gp, gf, spec, **kw)
        return _copy_into(state, out[:4]) + out[4:]
    return state + _queue_launch(state, gp, gf, spec, **kw)


def _queue_launch(state, gp, gf, spec: KernelSpec, *, seed: int,
                  iteration: int, block_n: int, cluster=None):
    """The kernel path of ``queue_step``: (aux_fit, aux_idx). ``cluster``
    sets the cluster size in place of ``cluster_size``'s (chip_smoke.py
    times each size)."""
    pos, vel, pbp, pbf = state
    extra, scalars, fit_id, rule_id, coef, n, d, _ = _launch_operands(
        (pos, vel, pbp, pbf, gp[:, None], gf), [seed], [iteration], (spec,),
        None, block_n)
    nb = n // block_n
    lanes = kernel_lanes(pos, vel, pbp, pbf, n=n, block_n=block_n)
    aux_fit = torch.empty(nb, dtype=pos.dtype, device=pos.device)
    aux_idx = torch.empty(nb, dtype=torch.int32, device=pos.device)
    with torch.cuda.device(pos.device):
        c = _cluster(n, d, block_n, pos.device, cluster, pos.dtype)
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        _check(_lib(pos.dtype).pso_queue_launch(
            *_ptrs([pos, vel, pbp, pbf, gp, gf, extra[0], aux_fit, aux_idx]),
            n, d, block_n, c, *scalars, fit_id, rule_id, *coef, lanes,
            stream), "queue kernel launch")
    count(queue_step, pos.dtype, 1, lanes)
    return aux_fit, aux_idx


queue_step.launches = queue_step.bf16_launches = 0
queue_step.bf16_lane_launches = 0


def fused(pos, vel, pbp, pbf, gp, gf, spec: KernelSpec, *, seed: int,
          iteration: int, iters: int, block_n: int, counts=None):
    """``iters`` fused queue-lock iterations of one swarm, in place: ONE
    launch of ``n // block_n`` clusters of ``cluster_size`` CTAs on CUDA
    tensors (cooperative with several blocks), the plain version on CPU
    tensors. ``counts`` (int32 ``[3]``) gets the run's contention counts
    added (``repro_torch.telemetry``)."""
    state = (pos, vel, pbp, pbf, gp, gf)
    kw = dict(seed=seed, iteration=iteration, iters=iters, block_n=block_n,
              counts=counts)
    if pos.device.type == "cpu":
        return _copy_into(state, fused_plain(*state, spec, **kw))
    _fused_launch(state, spec, **kw)
    return state


def _fused_launch(state, spec: KernelSpec, *, seed: int, iteration: int,
                  iters: int, block_n: int, cluster=None,
                  counts=None) -> None:
    """The kernel path of ``fused``: the batched launch with S = 1
    (``cluster`` as in ``_fused_batch_launch``)."""
    pos, vel, pbp, pbf, gp, gf = state
    count(fused, pos.dtype, *_fused_batch_launch(
        (pos, vel, pbp, pbf, gp[:, None], gf), [seed], [iteration], (spec,),
        iters=iters, block_n=block_n, cluster=cluster, counts=counts))


fused.launches = fused.bf16_launches = fused.bf16_lane_launches = 0


def fused_batch(pos, vel, pbp, pbf, gp, gf, seeds, its, specs, *,
                iters: int, block_n: int, fids=None, counts=None):
    """``iters`` fused queue-lock iterations of S swarms, in place (layout
    of ``fused_batch_plain``; ``seeds``/``its`` int64 ``[S]``). On CUDA
    tensors, each block on a cluster of ``cluster_size`` CTAs: with one
    block a swarm, ONE normal launch for all S; with several, cooperative
    launches in waves of as many whole swarms as the card holds at once.
    On CPU tensors the plain version. ``fids``
    (with a table ``specs`` of several members) makes the batch
    heterogeneous; its launches count in ``fused_batch.hetero_launches``.
    ``counts`` (int32 ``[3*S]``) gets swarm s's contention counts added in
    slots ``3s..3s+2``, across the waves."""
    state = (pos, vel, pbp, pbf, gp, gf)
    kw = dict(iters=iters, block_n=block_n, fids=fids, counts=counts)
    if pos.device.type == "cpu":
        return _copy_into(state, fused_batch_plain(*state, seeds, its, specs,
                                                   **kw))
    launched, lanes = _fused_batch_launch(state, seeds, its, specs, **kw)
    if fids is None:
        count(fused_batch, pos.dtype, launched, lanes)
    else:
        fused_batch.hetero_launches += launched
    return state


fused_batch.launches = fused_batch.bf16_launches = 0
fused_batch.bf16_lane_launches = 0
fused_batch.hetero_launches = 0


def _fused_batch_launch(state, seeds, its, specs, *, iters: int,
                        block_n: int, fids=None, cluster=None,
                        counts=None) -> Tuple[int, int]:
    """The kernel path of the fused wrappers (``launch_plan``); returns the
    launches made and the particles a thread they took (``kernel_lanes``).
    ``cluster`` sets the cluster size in place of ``cluster_size``'s
    (chip_smoke.py times each size)."""
    extra, scalars, fit_id, rule_id, coef, n, d, s_cnt = _launch_operands(
        state, seeds, its, specs, fids, block_n)
    _check_counts(counts, s_cnt, state[0].device)
    lanes = kernel_lanes(*state[:4], n=n, block_n=block_n)
    if iters <= 0:
        return 0, lanes
    pos = state[0]
    nb = n // block_n
    lib = _lib(pos.dtype)
    with torch.cuda.device(pos.device):
        c, wave = launch_plan(
            n, d, block_n, s_cnt,
            capacity_of(block_n, d, pos.device, pos.dtype),
            resident_of(fit_id, rule_id, block_n, d, pos.device, pos.dtype),
            cluster)
        keys = torch.zeros(2 * s_cnt, dtype=torch.int64, device=pos.device)
        cand = (torch.empty(2 * s_cnt * nb * d, dtype=pos.dtype,
                            device=pos.device) if nb > 1 else None)
        ptrs = _ptrs(list(state) + extra + [keys, cand, counts])
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        launches = 0
        for s0 in range(0, s_cnt, wave):
            _check(lib.pso_fused_launch(
                *ptrs, n, d, block_n, s_cnt, s0, min(wave, s_cnt - s0),
                iters, c, *scalars, fit_id, rule_id, *coef, lanes, stream),
                "fused kernel launch")
            launches += 1
    return launches, lanes


def fused_async(pos, vel, pbp, pbf, gp, gf, lp, lf, spec: KernelSpec, *,
                seed: int, iteration: int, iters: int, sync_every: int,
                block_n: int, cluster=None, counts=None,
                topology: str = "gbest"):
    """``iters`` async queue-lock iterations of one swarm, in place: on
    CUDA tensors one launch of ``n // block_n`` clusters of
    ``cluster_size`` CTAs (the fused kernel's C, so that with one block the
    two agree bit for bit) per ``async_spans`` phase (the remainder is a
    second launch), the plain version on CPU tensors. ``cluster`` sets the
    cluster size in place of ``cluster_size``'s (chip_smoke.py times each
    size); the plain version, the reference's math, ignores it. ``counts``
    (int32 ``[3]``) gets the run's contention counts added, over both
    phases. ``topology`` is the chunk entry's pull (module docstring)."""
    state = (pos, vel, pbp, pbf, gp, gf, lp, lf)
    kw = dict(seed=seed, iteration=iteration, iters=iters,
              sync_every=sync_every, block_n=block_n, counts=counts,
              topology=topology)
    if pos.device.type == "cpu":
        return _copy_into(state, fused_async_plain(*state, spec, **kw))
    _fused_async_launch(state, spec, cluster=cluster, **kw)
    return state


def _fused_async_launch(state, spec: KernelSpec, *, seed: int,
                        iteration: int, iters: int, sync_every: int,
                        block_n: int, cluster=None, counts=None,
                        topology: str = "gbest") -> None:
    """The kernel path of ``fused_async``: the batched launch with S = 1."""
    pos, vel, pbp, pbf, gp, gf, lp, lf = state
    count(fused_async, pos.dtype, *_fused_async_batch_launch(
        (pos, vel, pbp, pbf, gp[:, None], gf, lp, lf), [seed], [iteration],
        (spec,), iters=iters, sync_every=sync_every, block_n=block_n,
        cluster=cluster, counts=counts, topology=topology))


fused_async.launches = fused_async.bf16_launches = 0
fused_async.bf16_lane_launches = 0


def fused_async_batch(pos, vel, pbp, pbf, gp, gf, lp, lf, seeds, its, specs,
                      *, iters: int, sync_every: int, block_n: int,
                      fids=None, cluster=None, counts=None,
                      topology: str = "gbest"):
    """``iters`` async queue-lock iterations of S swarms, in place (layout
    of ``fused_async_batch_plain``): on CUDA tensors one launch of
    ``S * n // block_n`` clusters (``async_plan``) per ``async_spans``
    phase, on CPU tensors the plain version. ``fids`` makes the batch
    heterogeneous, counted in ``fused_async_batch.hetero_launches``;
    ``cluster`` and ``topology`` as in ``fused_async``; ``counts`` as in
    ``fused_batch``."""
    state = (pos, vel, pbp, pbf, gp, gf, lp, lf)
    kw = dict(iters=iters, sync_every=sync_every, block_n=block_n, fids=fids,
              counts=counts, topology=topology)
    if pos.device.type == "cpu":
        return _copy_into(state, fused_async_batch_plain(
            *state, seeds, its, specs, **kw))
    launched, lanes = _fused_async_batch_launch(state, seeds, its, specs,
                                                cluster=cluster, **kw)
    if fids is None:
        count(fused_async_batch, pos.dtype, launched, lanes)
    else:
        fused_async_batch.hetero_launches += launched
    return state


fused_async_batch.launches = fused_async_batch.bf16_launches = 0
fused_async_batch.bf16_lane_launches = 0
fused_async_batch.hetero_launches = 0


def _topology_operands(topology: str, nb: int) -> Tuple[int, int, int]:
    """(kernel topology id, von Neumann rows, cols) of the n // block_n
    blocks of a swarm; the star is id 0."""
    if topology == "gbest":
        return 0, 0, 0
    if topology not in LBEST_IDS:
        raise ValueError(f"unknown topology {topology!r}; one of "
                         f"{('gbest',) + tuple(LBEST_IDS)}")
    return (LBEST_IDS[topology],) + grid_dims(nb)


def _async_launcher(state, seeds, its, specs, fids, *, block_n: int,
                    cluster=None, counts=None, topology: str = "gbest",
                    counters=None):
    """Everything a launch of the async kernel needs but the launch, done
    once: the operands' checks and tables (``_launch_operands``; the hetero
    ``fids`` range check is a host sync), the cluster size (``async_plan``,
    an occupancy query; ``cluster`` sets it in place of ``cluster_size``'s)
    and the lock and, under an lbest ``topology``, zeroed sequence
    counters, a local-best slot each. ``counters``, a caller's own
    contiguous int32 ``[2, S]`` (seed, iteration) operand, takes the place
    of the one built from ``seeds`` and ``its``.

    Returns ``(launch, lock, seq)``: ``launch(span, chunk, off)`` makes one
    ``pso_async_launch`` of ``span`` iterations in chunks of ``chunk`` at
    iteration offset ``off`` on the current stream. It allocates nothing
    and reads nothing back, and the kernel reads every operand through its
    pointer, so a CUDA graph can capture it. ``launch.operands`` holds the
    tensors while a launch may run; ``launch.lanes`` is the particles a
    thread its launches take (``kernel_lanes``)."""
    pos = state[0]
    dev = pos.device
    extra, scalars, fit_id, rule_id, coef, n, d, s_cnt = _launch_operands(
        state, seeds, its, specs, fids, block_n)
    _check_counts(counts, s_cnt, dev)
    if counters is not None:
        if counters.dtype != torch.int32 or counters.device != dev \
                or tuple(counters.shape) != (2, s_cnt) \
                or not counters.is_contiguous():
            raise ValueError(f"counters must be a contiguous int32 "
                             f"[2, {s_cnt}] tensor on {dev}")
        extra[3:5] = [counters[0], counters[1]]
    topo = _topology_operands(topology, n // block_n)
    lanes = kernel_lanes(*state[:4], n=n, block_n=block_n)
    lib = _lib(pos.dtype)
    with torch.cuda.device(dev):
        c, _ = async_plan(n, d, block_n, s_cnt,
                          capacity_of(block_n, d, dev, pos.dtype), cluster)
    lock = torch.zeros(2 * s_cnt, dtype=torch.int32, device=dev)
    seq = (torch.zeros(s_cnt * (n // block_n), dtype=torch.int32, device=dev)
           if topo[0] else None)
    ptrs = _ptrs(list(state[:6]) + extra + list(state[6:])
                 + [lock, counts, seq])

    def launch(span: int, chunk: int, off: int) -> None:
        with torch.cuda.device(dev):
            _check(lib.pso_async_launch(
                *ptrs, n, d, block_n, s_cnt, span, chunk, c, *topo,
                off & 0xFFFFFFFF, *scalars, fit_id, rule_id, *coef, lanes,
                torch.cuda.current_stream(dev).cuda_stream),
                "async kernel launch")

    launch.operands = (extra, counts, lock, seq)
    launch.lanes = lanes
    return launch, lock, seq


def _fused_async_batch_launch(state, seeds, its, specs, *, iters: int,
                              sync_every: int, block_n: int, fids=None,
                              cluster=None, counts=None,
                              topology: str = "gbest") -> Tuple[int, int]:
    """The kernel path of the async wrappers (``async_plan``); returns the
    launches made and their particles a thread (``kernel_lanes``).
    ``cluster`` sets the cluster size in place of
    ``cluster_size``'s. An lbest ``topology`` takes the kernels' lbest
    instantiations and a zeroed sequence counter a local-best slot, shared
    by the call's launches."""
    launch, _, _ = _async_launcher(state, seeds, its, specs, fids,
                                   block_n=block_n, cluster=cluster,
                                   counts=counts, topology=topology)
    launches = 0
    for off, span, chunk in async_spans(iters, sync_every):
        launch(span, chunk, off)
        launches += 1
    return launches, launch.lanes


def async_lane_launch(state, counters, specs, fids, *, block_n: int,
                      sync_every: int, topology: str = "gbest"):
    """One chunk of a serving lane on the card (``ops.AsyncLane``), with
    everything but the launch done once, here (``_async_launcher``: the
    checks, the member table's upload, the ``fids`` range check, the
    cluster size, the lock and sequence buffers). ``state`` is the batch's
    8 D-major tensors, ``counters`` the lane's own ``[2, S]`` int32 (seed,
    iteration) operand, ``fids`` the lane's int32 ``[S]`` or None; the
    kernels read all of them through pointers, so what the lane writes into
    them between chunks is what the next chunk reads.

    Returns ``launch()``: zero the lock (and, under an lbest topology, the
    sequence counters), make one ``pso_async_launch`` of ``sync_every``
    iterations on the current stream, and add ``sync_every`` to every row's
    iteration counter, all on the device: no host sync, no allocation, no
    copy from the host, so a CUDA graph can capture it. It counts no
    launch: the caller counts what runs (a replay, not the capture), on
    the path ``launch.lanes`` names."""
    one, lock, seq = _async_launcher(
        state, counters[0].long(), counters[1].long(), specs, fids,
        block_n=block_n, topology=topology, counters=counters)

    def launch() -> None:
        lock.zero_()
        if seq is not None:
            seq.zero_()
        one(sync_every, sync_every, 0)
        counters[1].add_(sync_every)

    launch.operands = (one, lock, seq)   # held while the launch may run
    launch.lanes = one.lanes
    return launch


def neighbor_ids(nb: int, topology: str, device) -> Tensor:
    """Every block's neighbour ids ``[nb, 2 or 4]`` (int32) under an lbest
    ``topology``, in fold order: on a CUDA device from the kernels' own
    device function (one launch), on the CPU from
    ``core.topology.kernel_neighbor_ids``."""
    device = torch.device(device)
    topo, rows, cols = _topology_operands(topology, nb)
    if not topo:
        raise ValueError("the star topology folds no neighbours")
    if device.type == "cpu":
        return torch.tensor([kernel_neighbor_ids(b, nb, topology)
                             for b in range(nb)], dtype=torch.int32)
    out = torch.empty(nb, 2 if topology == "ring" else 4,
                      dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        _check(_lib().pso_neighbor_ids(
            nb, topo, rows, cols, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream),
            "neighbour ids launch")
    neighbor_ids.launches += 1
    return out


neighbor_ids.launches = 0
