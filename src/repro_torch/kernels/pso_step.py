"""Launching wrappers for the two main-path CUDA kernels, their plain
PyTorch versions, and launch counters.

``fused`` replaces ``repro.kernels.pso_step.fused_call`` (the fused
queue-lock) and ``fused_async`` replaces ``fused_async_call`` (the async
queue-lock); the kernels are ``csrc/pso_step.cu``. Arrays are D-major:
``pos``/``vel``/``pbp`` ``[D, N]``, ``pbf`` ``[N]``, ``gp`` ``[D]``, ``gf``
``[1]``, and for the async kernel ``lp`` ``[D, nb]``, ``lf`` ``[nb]``; all
float32 and contiguous.

A wrapper updates its state tensors in place and returns them. On CUDA
tensors it launches its kernel (or raises); on CPU tensors, and only there,
it runs the plain version. The plain versions return new tensors and leave
their inputs alone:

* ``fused_plain``: synchronous PPSO, vectorized over blocks — each
  iteration's gbest is the best lane (first on ties) of those beating the
  previous gbest. That is ``repro``'s ``ref.queue_step_oracle`` iterated;
  with a single block it is also ``ref.run_fused_oracle``.
* ``fused_async_plain``: block-major, mirroring
  ``ref.run_fused_async_oracle`` including the ``async_spans`` remainder
  phase — one valid interleaving of the kernel's race.

Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Tuple

import torch

from ..core import rng
from ..core.fitness import BUILTIN_PROBLEMS
from ..core.problem import Bound
from ..core.pso import STREAM_R1, STREAM_R2
from ..core.update_rules import RULE_IDS, resolve_rule

Tensor = torch.Tensor


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

def _operands(spec: KernelSpec, device):
    """Bounds as the reference's kernels take them: scalars stay Python
    floats, per-dimension tuples become [D, 1] columns."""
    def col(v):
        return v if not isinstance(v, tuple) else torch.tensor(
            v, dtype=torch.float32, device=device)[:, None]
    return col(spec.lo), col(spec.hi), col(spec.mv)


def _rng_index(n: int, d: int, device, base: int = 0) -> Tensor:
    """RNG element index ``particle * D + dim`` laid out [D, n]."""
    part = torch.arange(base, base + n, dtype=torch.int64, device=device)
    return part[None, :] * d + torch.arange(d, dtype=torch.int64,
                                            device=device)[:, None]


def _advance(spec, bounds, seed, it, pos, vel, pbp, att, idx):
    """One advance of a [D, n] tile against the attractor ``att`` [D, 1],
    plus the objective: (pos, vel, fit [n])."""
    lo, hi, mv = bounds
    r1 = rng.uniform(seed, it, STREAM_R1, idx)
    r2 = rng.uniform(seed, it, STREAM_R2, idx)
    pos, vel = resolve_rule(spec.rule).advance(
        r1, r2, pos, vel, pbp, att, w=spec.w, c1=spec.c1, c2=spec.c2,
        mv=mv, lo=lo, hi=hi)
    return pos, vel, BUILTIN_PROBLEMS[spec.fitness].fn(pos.T)


def _fold(fit, pos, pbp, pbf, best, best_pos):
    """pbest fold, then the queue: the best lane (first on ties) among
    those beating ``best`` replaces (best, best_pos)."""
    imp = fit > pbf
    pbf = torch.where(imp, fit, pbf)
    pbp = torch.where(imp[None, :], pos, pbp)
    q = torch.where(fit > best, fit, torch.full_like(fit, -math.inf))
    b = torch.argmax(q)
    take = q[b] > best
    return (pbp, pbf, torch.where(take, q[b], best),
            torch.where(take, pos[:, b], best_pos))


def fused_plain(pos, vel, pbp, pbf, gp, gf, spec: KernelSpec, *, seed: int,
                iteration: int, iters: int, block_n: int):
    """``iters`` synchronous queue-lock iterations; returns new
    (pos, vel, pbp, pbf, gp, gf). The result does not depend on
    ``block_n``: every block reads the previous iteration's gbest.

    This is ``core.pso.step_queue`` iterated, written again on the kernel's
    own operands (D-major tiles, a ``KernelSpec``) rather than routed
    through the engine: it shares ``_advance``/``_fold`` with
    ``fused_async_plain``, so with one block the two plain versions agree
    bit for bit, as the two kernels must. The engine sums each particle's
    objective over a contiguous [N, D] row, which may round differently."""
    del block_n
    d, n = pos.shape
    bounds = _operands(spec, pos.device)
    idx = _rng_index(n, d, pos.device)
    for t in range(iters):
        pos, vel, fit = _advance(spec, bounds, seed, iteration + t + 1,
                                 pos, vel, pbp, gp[:, None], idx)
        pbp, pbf, gf, gp = _fold(fit, pos, pbp, pbf, gf, gp)
    return pos, vel, pbp, pbf, gp, gf


def fused_async_plain(pos, vel, pbp, pbf, gp, gf, lp, lf, spec: KernelSpec,
                      *, seed: int, iteration: int, iters: int,
                      sync_every: int, block_n: int):
    """``iters`` async queue-lock iterations, block-major: block b runs its
    whole span before block b+1, pulling gbest at chunk entry and
    publishing at chunk exit; a remainder runs as a second block-major
    phase. Returns new (pos, vel, pbp, pbf, gp, gf, lp, lf)."""
    d, n = pos.shape
    bn = block_n
    bounds = _operands(spec, pos.device)
    pos, vel, pbp, pbf, lp, lf = (t.clone() for t in
                                  (pos, vel, pbp, pbf, lp, lf))
    for off, span, k in async_spans(iters, sync_every):
        for b in range(n // bn):
            sl = slice(b * bn, (b + 1) * bn)
            p, v, bp, bf = pos[:, sl], vel[:, sl], pbp[:, sl], pbf[sl]
            lpb, lfb = lp[:, b], lf[b:b + 1]
            idx = _rng_index(bn, d, pos.device, base=b * bn)
            for c in range(span // k):
                pull = gf > lfb                     # chunk entry
                lfb = torch.where(pull, gf, lfb)
                lpb = torch.where(pull, gp, lpb)
                for tl in range(k):
                    it = iteration + off + c * k + tl + 1
                    p, v, fit = _advance(spec, bounds, seed, it, p, v, bp,
                                         lpb[:, None], idx)
                    bp, bf, lfb, lpb = _fold(fit, p, bp, bf, lfb, lpb)
                pub = lfb > gf                      # chunk exit
                gf = torch.where(pub, lfb, gf)
                gp = torch.where(pub, lpb, gp)
            pos[:, sl], vel[:, sl], pbp[:, sl], pbf[sl] = p, v, bp, bf
            lp[:, b], lf[b:b + 1] = lpb, lfb
    return pos, vel, pbp, pbf, gp, gf, lp, lf


# ---------------------------------------------------------------------------
# Kernel launching
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    import ctypes as c

    from . import _build
    lib = _build.load("pso_step")
    p, i, u, f = c.c_void_p, c.c_int, c.c_uint, c.c_float
    lib.pso_fused_resident_ctas.argtypes = [i, i, i, i, c.POINTER(i)]
    lib.pso_fused_launch.argtypes = (
        [p] * 9 + [i] * 4 + [u, u, i, i] + [f] * 6 + [p])
    lib.pso_async_launch.argtypes = (
        [p] * 10 + [i] * 5 + [u, u, i, i] + [f] * 6 + [p])
    for fn in (lib.pso_fused_resident_ctas, lib.pso_fused_launch,
               lib.pso_async_launch):
        fn.restype = i
    return lib


def _check(status: int, what: str) -> None:
    if status:
        raise RuntimeError(f"{what} failed: CUDA error {status}")


def _kernel_inputs(spec: KernelSpec, tensors, n: int, d: int):
    """Validate the state tensors for a launch and build the [4, D] bounds
    rows (lo, hi, max_v, span) the kernels read."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda" \
                or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous float32 "
                             f"tensors on one CUDA device; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    shapes = [tuple(t.shape) for t in tensors[:6]]
    if shapes != [(d, n)] * 3 + [(n,), (d,), (1,)]:
        raise ValueError(f"state shapes {shapes} do not match D={d}, N={n}")

    def row(v):
        return [float(x) for x in v] if isinstance(v, tuple) else [v] * d
    lo, hi = row(spec.lo), row(spec.hi)
    # The SSO rule's resample width: as the plain version computes it,
    # in double for scalar bounds and in float32 for per-dim bounds.
    span = ([spec.hi - spec.lo] * d if not isinstance(spec.lo, tuple)
            else (torch.tensor(hi, dtype=torch.float32)
                  - torch.tensor(lo, dtype=torch.float32)).tolist())
    # From pinned memory the upload is asynchronous: a pageable copy would
    # hold the host until the stream drains, idling the card between calls.
    bounds = torch.tensor([lo, hi, row(spec.mv), span], dtype=torch.float32,
                          pin_memory=True).to(dev, non_blocking=True)
    k = resolve_rule(spec.rule).kernel_consts()
    scalars = ([spec.fitness, RULE_IDS[spec.rule], spec.w, spec.c1, spec.c2]
               + list(k))
    return bounds, scalars


def _ptr(t: Tensor) -> int:
    return t.data_ptr()


def _copy_into(state, out):
    """The CPU path of a wrapper: the plain version's results, in place."""
    for dst, src in zip(state, out):
        dst.copy_(src)
    return state


def fused(pos, vel, pbp, pbf, gp, gf, spec: KernelSpec, *, seed: int,
          iteration: int, iters: int, block_n: int):
    """``iters`` fused queue-lock iterations, in place: ONE cooperative
    launch of ``n // block_n`` CTAs on CUDA tensors, the plain version on
    CPU tensors."""
    state = (pos, vel, pbp, pbf, gp, gf)
    kw = dict(seed=seed, iteration=iteration, iters=iters, block_n=block_n)
    if pos.device.type == "cpu":
        return _copy_into(state, fused_plain(*state, spec, **kw))
    _fused_launch(state, spec, **kw)
    return state


def _fused_launch(state, spec: KernelSpec, *, seed: int, iteration: int,
                  iters: int, block_n: int) -> None:
    """The kernel path. Raises if the CTAs cannot all be resident at once
    (the grid-wide sync needs every CTA)."""
    pos = state[0]
    d, n = pos.shape
    bounds, (fit_id, rule_id, *coef) = _kernel_inputs(spec, state, n, d)
    if iters <= 0:
        return
    import ctypes
    lib = _lib()
    resident = ctypes.c_int(0)
    with torch.cuda.device(pos.device):
        _check(lib.pso_fused_resident_ctas(fit_id, rule_id, block_n, d,
                                           ctypes.byref(resident)),
               "occupancy query")
        nb = n // block_n
        if nb > resident.value:
            raise RuntimeError(
                f"fused kernel: {nb} CTAs of {min(block_n, 512)} threads "
                f"cannot all be resident ({resident.value} fit on this "
                f"device); the cooperative launch needs every CTA at once — "
                f"use a larger block_n")
        keys = torch.zeros(2, dtype=torch.int64, device=pos.device)
        cand = torch.empty(2 * nb * d, dtype=torch.float32, device=pos.device)
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        status = lib.pso_fused_launch(
            *map(_ptr, state + (bounds, keys, cand)),
            n, d, block_n, iters, seed & 0xFFFFFFFF,
            iteration & 0xFFFFFFFF, fit_id, rule_id, *coef, stream)
    _check(status, "fused kernel launch")
    fused.launches += 1


fused.launches = 0


def fused_async(pos, vel, pbp, pbf, gp, gf, lp, lf, spec: KernelSpec, *,
                seed: int, iteration: int, iters: int, sync_every: int,
                block_n: int):
    """``iters`` async queue-lock iterations, in place: on CUDA tensors one
    launch of ``n // block_n`` CTAs per ``async_spans`` phase (the
    remainder is a second launch), the plain version on CPU tensors."""
    state = (pos, vel, pbp, pbf, gp, gf, lp, lf)
    kw = dict(seed=seed, iteration=iteration, iters=iters,
              sync_every=sync_every, block_n=block_n)
    if pos.device.type == "cpu":
        return _copy_into(state, fused_async_plain(*state, spec, **kw))
    _fused_async_launch(state, spec, **kw)
    return state


def _fused_async_launch(state, spec: KernelSpec, *, seed: int,
                        iteration: int, iters: int, sync_every: int,
                        block_n: int) -> None:
    """The kernel path of ``fused_async``."""
    pos, lp, lf = state[0], state[6], state[7]
    d, n = pos.shape
    nb = n // block_n
    if tuple(lp.shape) != (d, nb) or tuple(lf.shape) != (nb,):
        raise ValueError(f"local bests {tuple(lp.shape)}/{tuple(lf.shape)} "
                         f"do not match D={d}, nb={nb}")
    bounds, (fit_id, rule_id, *coef) = _kernel_inputs(spec, state, n, d)
    lib = _lib()
    with torch.cuda.device(pos.device):
        lock = torch.zeros(2, dtype=torch.int32, device=pos.device)
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        for off, span, chunk in async_spans(iters, sync_every):
            status = lib.pso_async_launch(
                *map(_ptr, state[:6] + (bounds, lp, lf, lock)),
                n, d, block_n, span, chunk, seed & 0xFFFFFFFF,
                (iteration + off) & 0xFFFFFFFF, fit_id, rule_id, *coef,
                stream)
            _check(status, "async kernel launch")
            fused_async.launches += 1


fused_async.launches = 0
