"""The split path of the kernel backend: any Problem that is not one of the
six unconstrained built-ins, on two hand-written CUDA kernels around the
user's own torch operators.

The kernels are ``csrc/pso_split.cu``'s ``split_advance_kernel`` (in
bfloat16 ``split_advance_bf16_kernel``) and ``split_fold_publish_kernel``.
Together with the torch step between them they replace the converted forms
of the Pallas call functions of
``repro.kernels.pso_step`` (``queue_step_call``, ``fused_call``,
``fused_batch_call``, ``hetero_fused_batch_call``, ``fused_async_call``,
``fused_async_batch_call``, ``hetero_fused_async_batch_call``), which trace
a custom objective (``dmajor_adapter`` or ``kernel_fn``), the projection
(``kernel_projection``) and the Deb fold (``kernel_violation``) into their
bodies. One iteration is:

1. ``advance``: pos and vel against an attractor column, clipped to the box;
2. the torch step (``torch_step``): the projection, written back into pos;
   the objective (``max_fn`` on the particle-major positions, or
   ``kernel_fn`` on the D-major ones); the violation where Deb applies.
   This is the user's code, which the reference traced into its kernels;
3. ``fold_publish``: the pbest fold (raw fitness, or Deb's rule against the
   carried pbest violation ``pbv``) and the paper's intra-block queue on raw
   fitness (gbest publication is not Deb-gated, as in the reference), then,
   in the same launch, the cross-block stage, run by the particle block
   that arrives last at its swarm's counter (``arrive``).

Each particle block of the fold runs on a cluster of one or two CTAs that
share its pbest copies by rows (``fold_cluster_size``). In bfloat16 the
advance takes eight lanes a thread in 16-byte accesses where the shape and
the operands' alignment allow and the launch is large, else a lane a thread
(``advance_lanes``); both compute on lane pairs with sm_90's packed
bfloat16 instructions, whose premise ``check_bf16_ops`` runs on every
operand pair.

Semantics (held by ``tests/test_torch_constraints.py``):

* Fused mode is synchronous PPSO: every block reads iteration t-1's gbest.
  It equals ``core.pso.step_queue`` iterated (the reference's
  ``ref.queue_step_oracle`` iterated), each with the Deb fold where it
  applies, and ``pso_step.fused_plain``; with one block also
  ``ref.run_fused_oracle``.
* Async mode is the eager engine's lockstep async: it equals
  ``core.pso.run_async(n_blocks=nb)``, one valid interleaving of the async
  race, publishing and pulling at the iterations that are multiples of
  ``sync_every`` and publishing only at the end of a call. With one block
  it equals the fused mode for every ``sync_every``. Under an lbest
  ``topology`` the pull at a sync point is ``core.topology``'s
  ``block_neighbor_best`` of the locals, computed in the cross-block
  stage, so it equals ``run_async`` with that topology.
* Queue mode is one iteration of the paper's queue algorithm: each block's
  best lane beating gbest as ``(aux_fit, aux_idx)``, the cross-block
  argmax being ``ops.queue_epilogue``; ``fold_publish`` runs the fold
  alone there.
* ``pbv`` carries ``violation_fn(pbest_pos)``, which the reference
  recomputes every iteration; after any run ``pbv ==
  violation_fn(pbest_pos)`` holds exactly.

Arrays are D-major as in ``pso_step``: ``pos``/``vel``/``pbp`` ``[D, S*N]``,
``pbf``/``pbv``/``fit``/``viol`` ``[S*N]``, ``gp`` ``[D, S]``, ``gf``
``[S]``, ``lp`` ``[D, S*nb]``, ``lf`` ``[S*nb]``, ``seeds``/``its`` int64
``[S]``, ``keys`` int64 ``[S]`` (the uint64 queue keys' bits), ``act`` and
``arrive`` int32 ``[S]``. The float operands are of the state's dtype,
float32 or bfloat16, a library each (``csrc/pso_split.cu``; bfloat16 with
``-DPSO_T_BF16``, built at its first launch). A heterogeneous batch takes
a table of ``KernelSpec`` members and ``fids[S]`` into it, in float32
only.

In bfloat16 the plain versions compute what the reference's converted
kernels compute in that dtype (ROADMAP, parity contract, "bfloat16"): the
advance as ``pso_step``'s plain versions round it (the draws, bounds and
coefficients of the dtype, every operation rounded); the fold and the
publish only compare and copy, and the queue keys come from the fitness
widened to float32, which is exact. The user's functions round as their
own code does.

``split_advance_plain`` is the advance's plain version; ``split_fold_plain``
followed (outside the queue mode) by ``split_publish_plain`` is
``fold_publish``'s, with the kernel's operands and arithmetic. On CPU
tensors, and only there, the wrappers run them; on CUDA tensors they launch
the kernel or raise. Each wrapper counts its launches in
``<wrapper>.launches`` and the bfloat16 ones also in ``.bf16_launches``
(``pso_step.count``). ``fold_publish`` takes ``counts`` (int32 ``[3*S]``,
or None) with the meaning of ``repro_torch.telemetry``: the fold counts
queue updates and block improvements, and in fused mode a publication for
each block that raised its swarm's key; the async cross-block stage counts
the sync points at which a swarm's gbest rose.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..core import rng
from ..core.fitness import weak
from ..core.pso import STREAM_R1, STREAM_R2
from ..core.topology import block_neighbor_best
from ..core.update_rules import kernel_rule_id, resolve_rule
from .pso_step import (_VARIANT, KERNEL_DTYPES, KernelSpec, _check,
                       _counters, _ptrs, _rule_operands, _tables,
                       _topology_operands, check_hetero, count)

Tensor = torch.Tensor

#: Fold modes (``csrc/pso_split.cu``).
MODES = {"queue": 0, "fused": 1, "async": 2}
#: The async publish's per-swarm action: none, publish and pull (a sync
#: point), publish only (the end of a call).
ACT_NONE, ACT_SYNC, ACT_FLUSH = 0, 1, 2
#: The cluster sizes a particle block of the fold runs on: the two that
#: chip_smoke.py phase 6c measures (4 and 8 read slower there than 2).
FOLD_CLUSTERS = (1, 2)
#: The fewest rows of the pbest copies each CTA of a cluster takes.
FOLD_MIN_ROWS = 8
#: Lanes a thread of the bfloat16 advance's 16-byte path (``advance_lanes``).
ADVANCE_LANES = 8
#: The fewest elements (D * S * N) a bfloat16 advance takes the 16-byte
#: path at (``advance_lanes``): below it a lane a thread is faster, eight
#: lanes a thread leaving too few threads to hide their latency
#: (chip_smoke.py 16c's sweep of both paths by size: the lane path ahead
#: at 131072 elements, the 16-byte path at 245760).
ADVANCE_MIN_ELEMENTS = 5 << 15
#: The packed bfloat16 operations of the advance kernel that
#: ``check_bf16_ops`` holds to the float operation rounded once, in the C
#: entry's order.
BF16_OPS = ("mul", "add", "sub", "max", "min", "draw")

_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Queue keys in torch: the uint64 key of csrc/pso_split.cu's make_key, held
# as the int64 with the same bits.
# ---------------------------------------------------------------------------

def queue_keys(fit: Tensor, index: Tensor) -> Tensor:
    """``(ordered fitness bits) << 32 | (0xFFFFFFFF - index)`` as int64,
    from the fitness widened to float32 (exact from bfloat16, so the order
    and the first-lane tie-break are the same in both dtypes)."""
    # + 0.0: -0 -> +0
    u = (fit.float() + 0.0).view(torch.int32).to(torch.int64) & _U32
    u = torch.where(u >= 2 ** 31, u ^ _U32, u | 2 ** 31)
    hi = torch.where(u >= 2 ** 31, u - 2 ** 32, u)   # the int64's high word
    return hi * 2 ** 32 + (_U32 - index.to(torch.int64))


def key_index(keys: Tensor) -> Tensor:
    """The particle index of each key (meaningless where a key is 0)."""
    return _U32 - (keys & _U32)


def _umax(keys: Tensor, cand: Tensor) -> Tensor:
    """Each row's ``keys`` raised to the largest of its ``cand`` row, in
    the unsigned order of the uint64 keys (what atomicMax does)."""
    flip = torch.iinfo(torch.int64).min
    return torch.maximum(keys ^ flip, (cand ^ flip).amax(1)) ^ flip


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _member_columns(specs, fids, n: int, dev):
    """[(member spec, its columns or None for all)] of a launch."""
    if fids is None:
        return [(specs[0], None)]
    col_fid = fids.to(dev, torch.int64).repeat_interleave(n)
    return [(specs[k], (col_fid == k).nonzero()[:, 0])
            for k in torch.unique(col_fid).tolist()]


def split_advance_plain(pos, vel, pbp, attractor, seeds, its, specs,
                        fids=None, *, n: int, it_off: int, gdiv: int):
    """One advance of every element of the ``[D, S*N]`` state, iteration
    ``its[s] + it_off + 1`` of swarm s, against column ``col // gdiv`` of
    ``attractor``, each swarm with its member's rule, coefficients and bounds
    (scalars stay Python floats, as in the eager engine), in the state's
    dtype: in bfloat16 the draws, bounds, coefficients and every operation
    rounded as ``pso_step``'s plain versions round them. Returns new
    (pos, vel)."""
    d, ld = pos.shape
    dev = pos.device
    col = torch.arange(ld, device=dev)
    sw = col // n
    idx = (col - sw * n)[None, :] * d + torch.arange(d, device=dev)[:, None]
    seed = seeds.to(dev, torch.int64)[sw][None, :]
    it = (its.to(dev, torch.int64)[sw] + it_off + 1)[None, :]
    r1 = rng.uniform(seed, it, STREAM_R1, idx, dtype=pos.dtype)
    r2 = rng.uniform(seed, it, STREAM_R2, idx, dtype=pos.dtype)
    att = attractor.index_select(1, col // gdiv)
    out_pos, out_vel = torch.empty_like(pos), torch.empty_like(vel)
    for spec, cols in _member_columns(specs, fids, n, dev):
        take = ((lambda t: t) if cols is None
                else (lambda t: t.index_select(1, cols)))
        p, v = resolve_rule(spec.rule).advance(
            take(r1), take(r2), take(pos), take(vel), take(pbp), take(att),
            **_rule_operands(spec, dev, pos.dtype))
        if cols is None:
            out_pos, out_vel = p, v
        else:
            out_pos[:, cols], out_vel[:, cols] = p, v
    return out_pos, out_vel


def split_fold_plain(pos, pbp, pbf, fit, *, n: int, block_n: int, mode: str,
                     gf=None, pbv=None, viol=None, lp=None, lf=None,
                     keys=None, counts=None) -> Dict[str, Tensor]:
    """The pbest fold and each block's queue; returns the new outputs by
    name (``pbp``, ``pbf``, ``pbv`` with Deb; ``aux_fit``/``aux_idx`` in
    queue mode, ``keys`` in fused mode, ``lp``/``lf`` in async mode) and
    adds the events into ``counts``."""
    d, ld = pos.shape
    s_cnt = ld // n
    nb = n // block_n
    dev = pos.device
    if viol is None:
        imp = fit > pbf
    else:
        from ..core.constraints import deb_improved
        imp = deb_improved(fit, viol, pbf, pbv)
    out = {"pbp": torch.where(imp[None, :], pos, pbp),
           "pbf": torch.where(imp, fit, pbf)}
    if viol is not None:
        out["pbv"] = torch.where(imp, viol, pbv)
    g = (lf if mode == "async" else gf.repeat_interleave(nb))[:, None]
    fb = fit.reshape(s_cnt * nb, block_n)
    q = torch.where(fb > g, fb, torch.full_like(fb, -math.inf))
    has = (fb > g).any(1)
    lane = torch.argmax(q, 1)                 # first lane of the maximum
    local = (torch.arange(s_cnt * nb, device=dev) % nb) * block_n + lane
    win = (torch.arange(s_cnt * nb, device=dev) // nb) * n + local
    if counts is not None:
        per = torch.stack((has, has if mode == "fused" else torch.zeros_like(
            has), imp.reshape(s_cnt * nb, block_n).any(1)), 1)
        counts += per.reshape(s_cnt, nb, 3).sum(1).reshape(-1).to(
            counts.dtype)
    if mode == "queue":
        out["aux_fit"] = torch.where(has, fit[win],
                                     torch.full_like(fit[win], -math.inf))
        out["aux_idx"] = local.to(torch.int32)   # the base on an empty queue
    elif mode == "fused":
        cand = torch.where(has, queue_keys(fit[win], local),
                           torch.zeros_like(local))
        out["keys"] = _umax(keys, cand.reshape(s_cnt, nb))
    else:
        out["lf"] = torch.where(has, fit[win], lf)
        out["lp"] = torch.where(has[None, :], pos.index_select(1, win), lp)
    return out


def split_publish_plain(pos, fit, gp, gf, *, n: int, mode: str, keys=None,
                        lp=None, lf=None, act=None, counts=None,
                        topology: str = "gbest") -> Dict[str, Tensor]:
    """The cross-block stage of every swarm; returns the new outputs by
    name (``gp``, ``gf``, and ``keys`` cleared in fused mode or ``lp``/
    ``lf`` in async mode) and adds the async publications into
    ``counts``. An lbest ``topology`` pulls each local's neighbourhood
    best at a sync point instead of gbest."""
    s_cnt = gf.shape[0]
    dev = pos.device
    if mode == "fused":
        has = keys != 0
        win = torch.arange(s_cnt, device=dev) * n + key_index(keys)
        win = torch.where(has, win, torch.zeros_like(win))
        return {"gp": torch.where(has[None, :], pos.index_select(1, win), gp),
                "gf": torch.where(has, fit[win], gf),
                "keys": torch.zeros_like(keys)}
    nb = lf.shape[0] // s_cnt
    lfs = lf.reshape(s_cnt, nb)
    b = torch.argmax(lfs, 1)                  # first local of the maximum
    slot = torch.arange(s_cnt, device=dev) * nb + b
    take = (act != ACT_NONE) & (lf[slot] > gf)
    gf2 = torch.where(take, lf[slot], gf)
    gp2 = torch.where(take[None, :], lp.index_select(1, slot), gp)
    if counts is not None:
        counts.view(s_cnt, 3)[:, 1] += take.to(counts.dtype)
    pull = (act == ACT_SYNC).repeat_interleave(nb)
    if topology != "gbest":
        d = lp.shape[0]
        nbp, nbf = block_neighbor_best(
            lfs, lp.reshape(d, s_cnt, nb).permute(1, 2, 0), topology)
        return {"gp": gp2, "gf": gf2,
                "lf": torch.where(pull, nbf.reshape(-1), lf),
                "lp": torch.where(pull[None, :], nbp.permute(2, 0, 1)
                                  .reshape(d, s_cnt * nb), lp)}
    return {"gp": gp2, "gf": gf2,
            "lf": torch.where(pull, gf2.repeat_interleave(nb), lf),
            "lp": torch.where(pull[None, :], gp2.repeat_interleave(nb, 1),
                              lp)}


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib(dtype: torch.dtype = torch.float32):
    """The library of ``dtype``'s split kernels, built at its first use:
    ``csrc/pso_split.cu``, in bfloat16 with ``-DPSO_T_BF16``."""
    import ctypes as c

    from . import _build
    lib = _build.load("pso_split", _VARIANT[dtype])
    p, i, u, f = c.c_void_p, c.c_int, c.c_uint, c.c_float
    lib.pso_split_advance.argtypes = ([p] * 8 + [i] * 4 + [u, i] + [f] * 6
                                      + [i, p])
    lib.pso_split_fold_publish.argtypes = [p] * 17 + [i] * 9 + [p]
    fns = [lib.pso_split_advance, lib.pso_split_fold_publish]
    if dtype == torch.bfloat16:
        lib.pso_split_bf16_check.argtypes = [i, p, p]
        fns.append(lib.pso_split_bf16_check)
    for fn in fns:
        fn.restype = i
    return lib


def fold_cluster_size(s_cnt: int, n: int, d: int, block_n: int,
                      sm_count: int) -> int:
    """How many CTAs each particle block of the fold runs on, for ``s_cnt``
    swarms of ``n`` particles in ``d`` dimensions in blocks of ``block_n``
    on a card of ``sm_count`` SMs: 2 where the launch's clusters of two
    still hold at most one CTA an SM (``s_cnt * n // block_n * 2 <=
    sm_count``) and each CTA owns at least ``FOLD_MIN_ROWS`` rows of the
    pbest copies, else 1. A launch that already fills the card gains
    nothing from a second CTA a block, which adds its read of the block's
    fitness and a cluster barrier (chip_smoke.py phase 6c sweeps C, on one
    swarm and on a batch that fills the card). Correctness never needs the
    clusters resident at once (no CTA waits for another)."""
    ctas = s_cnt * (n // block_n)
    return 2 if d >= 2 * FOLD_MIN_ROWS and 2 * ctas <= sm_count else 1


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _validate(what: str, d: int, ld: int, n: int, nb: int,
              fl: torch.dtype, **operands):
    """Each given operand's shape and dtype as the kernels and the plain
    versions read them, for a state of ``ld // n`` swarms of ``n``
    particles in ``d`` dimensions and ``nb`` blocks a swarm, every float
    operand of the state's dtype ``fl`` (float32 or bfloat16, a library
    each; a wrong size would be read past its end on the card). None means
    absent."""
    s_cnt = ld // n
    if n < 1 or ld % n:
        raise ValueError(f"{what}: {ld} columns are not swarms of {n}")
    if fl not in KERNEL_DTYPES:
        raise ValueError(f"{what}: the split kernels take float32 or "
                         f"bfloat16, not {fl}")
    i32 = torch.int32
    want = {"pos": ((d, ld), fl), "vel": ((d, ld), fl),
            "pbp": ((d, ld), fl), "pbf": ((ld,), fl), "fit": ((ld,), fl),
            "viol": ((ld,), fl), "pbv": ((ld,), fl), "gp": ((d, s_cnt), fl),
            "gf": ((s_cnt,), fl), "lp": ((d, s_cnt * nb), fl),
            "lf": ((s_cnt * nb,), fl), "keys": ((s_cnt,), torch.int64),
            "aux_fit": ((s_cnt * nb,), fl), "aux_idx": ((s_cnt * nb,), i32),
            "act": ((s_cnt,), i32), "arrive": ((s_cnt,), i32),
            "counts": ((3 * s_cnt,), i32)}
    for name, t in operands.items():
        shape, dtype = want[name]
        if t is not None and (tuple(t.shape) != shape or t.dtype != dtype):
            raise ValueError(f"{what}: {name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def _cuda_operands(*tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError("split-kernel operands must be contiguous "
                             f"tensors on one CUDA device; got "
                             f"{tuple(t.shape)} on {t.device}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def uint32_rows(seeds: Tensor, its: Tensor, dev) -> Tensor:
    """The [2, S] int32 operand the advance kernel reads as uint32 seeds
    and iteration counters (``pso_step``'s batch counters)."""
    return _counters(seeds, its, dev)[0]


def _copy_into(dst, out):
    for name, t in out.items():
        dst[name].copy_(t)


def advance_paths(pos, vel, pbp, *, gdiv: int,
                  fids=None) -> Tuple[int, ...]:
    """The lanes a thread the advance kernel can take for these operands:
    1 (the float kernel; the bfloat16 kernel's lane path, a kernel of its
    own), and ``ADVANCE_LANES`` (the bfloat16 kernel's 16-byte path) where
    the state is bfloat16, every attractor column spans whole tiles of eight
    lanes (``gdiv % 8 == 0``, so N is a multiple of 8 and no tile straddles
    two swarms), there is no member table, and pos, vel and pbp start on 16
    bytes."""
    if (pos.dtype != torch.bfloat16 or gdiv % ADVANCE_LANES
            or fids is not None
            or any(t.data_ptr() % 16 for t in (pos, vel, pbp))):
        return (1,)
    return (1, ADVANCE_LANES)


def advance_lanes(pos, vel, pbp, *, gdiv: int, fids=None) -> int:
    """The lanes a thread the advance kernel takes: the 16-byte path where
    ``advance_paths`` allows it and the launch holds at least
    ``ADVANCE_MIN_ELEMENTS`` elements, else a lane a thread."""
    if pos.numel() < ADVANCE_MIN_ELEMENTS:
        return 1
    return advance_paths(pos, vel, pbp, gdiv=gdiv, fids=fids)[-1]


def advance(pos, vel, pbp, attractor, seeds, its,
            specs: Sequence[KernelSpec], fids=None, *, n: int, it_off: int,
            gdiv: int, counters=None):
    """``split_advance_plain`` in place: on CUDA tensors one launch of
    the advance kernel (``counters``: ``uint32_rows`` made once a call,
    else made here), on CPU tensors the plain version. In bfloat16 the
    kernel takes ``advance_lanes`` lanes a thread (the tests and
    chip_smoke.py select each path through ``ADVANCE_MIN_ELEMENTS``). A
    heterogeneous table (``fids``) takes float32 only. A launch
    of the bfloat16 lane path also counts in
    ``advance.bf16_lane_launches``."""
    d, ld = pos.shape
    _validate("split advance", d, ld, n, 1, pos.dtype, pos=pos, vel=vel,
              pbp=pbp)
    if fids is not None:
        check_hetero(pos.dtype)
    if gdiv < 1 or n % gdiv or tuple(attractor.shape) != (d, ld // gdiv) \
            or attractor.dtype != pos.dtype:
        raise ValueError(f"split advance: attractor must be {pos.dtype} "
                         f"[{d}, {ld}/gdiv] with gdiv dividing {n}; got "
                         f"{attractor.dtype} {tuple(attractor.shape)}, "
                         f"gdiv={gdiv}")
    if pos.device.type == "cpu":
        p, v = split_advance_plain(pos, vel, pbp, attractor, seeds, its,
                                   specs, fids, n=n, it_off=it_off, gdiv=gdiv)
        pos.copy_(p)
        vel.copy_(v)
        return pos, vel
    dev = pos.device
    if counters is None:
        counters = uint32_rows(seeds, its, dev)
    if fids is not None:
        fids = fids.to(dev, torch.int32).contiguous()
    dtype = pos.dtype
    bounds, _ = _tables(tuple(specs), d, dev, dtype)
    _cuda_operands(pos, vel, pbp, attractor, bounds, fids, counters)
    spec = specs[0]
    coef = [weak(c, dtype) for c in (spec.w, spec.c1, spec.c2,
                                     *resolve_rule(spec.rule)
                                     .kernel_consts())]
    lanes = advance_lanes(pos, vel, pbp, gdiv=gdiv, fids=fids)
    with torch.cuda.device(dev):
        _check(_lib(dtype).pso_split_advance(
            *_ptrs([pos, vel, pbp, attractor, bounds, fids, counters[0],
                    counters[1]]),
            n, d, ld // n, gdiv, it_off & _U32, kernel_rule_id(spec.rule),
            *coef, lanes, _stream(dev)), "split advance kernel launch")
    count(advance, dtype, 1)
    if dtype == torch.bfloat16 and lanes == 1:
        advance.bf16_lane_launches += 1
    return pos, vel


advance.launches = advance.bf16_launches = advance.bf16_lane_launches = 0


def check_bf16_ops(device=None) -> Dict[str, Tuple[int, int, int]]:
    """The premise of the bfloat16 advance, on the card: each packed
    instruction it computes with (``BF16_OPS``) run on every operand pair
    against the plain version's rounding model: mul, add and sub over all
    2^32 pairs of bfloat16 values against the float operation rounded once
    to bfloat16; max and min against fmaxf and fminf; the draws' pair
    rounding over all 2^24 values of (h >> 8) against one rounding each.
    Equal means the same 16 bits, or NaN on both sides whatever its sign
    and payload; signed zeros are compared by their bits. Returns, for each
    operation, (mismatches, lanes checked, the first mismatch's index: ``a
    << 16 | b``, the draw's value, or -1)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError("check_bf16_ops runs the packed instructions on a "
                         f"card; got {dev}")
    lib = _lib(torch.bfloat16)
    got = {}
    with torch.cuda.device(dev):
        for op, name in enumerate(BF16_OPS):
            out = torch.tensor([0, -1, 0], dtype=torch.int64, device=dev)
            _check(lib.pso_split_bf16_check(op, out.data_ptr(), _stream(dev)),
                   f"bfloat16 {name} check launch")
            bad, first, seen = out.tolist()
            got[name] = (bad, seen, first if bad else -1)
    return got


#: The operands each mode of ``fold_publish`` needs besides pos, pbp, pbf
#: and fit.
_NEEDS = {"queue": ("gf", "aux_fit", "aux_idx"),
          "fused": ("gp", "gf", "keys"),
          "async": ("gp", "gf", "lp", "lf", "act")}


def fold_publish(pos, pbp, pbf, fit, *, n: int, block_n: int, mode: str,
                 gp=None, gf=None, pbv=None, viol=None, lp=None, lf=None,
                 keys=None, act=None, aux_fit=None, aux_idx=None,
                 counts=None, arrive=None, topology: str = "gbest",
                 _cluster: Optional[int] = None):
    """``split_fold_plain``, then outside the queue mode
    ``split_publish_plain`` on its outputs, in place (``aux_fit``/
    ``aux_idx`` [S*nb] are the queue mode's outputs; ``act`` [S] the async
    mode's action a swarm; an lbest ``topology`` pulls the neighbourhood
    best at a sync point): on CUDA tensors one launch of
    ``split_fold_publish_kernel``, each particle block on a cluster of
    ``fold_cluster_size`` CTAs (``_cluster`` forces one of
    ``FOLD_CLUSTERS``, for the tests and chip_smoke.py; under an lbest
    ``topology`` with a scratch copy of the locals, ``[(D+1) * S*nb]``), on
    CPU tensors the plain versions. ``arrive`` (int32 [S], zero; zero again
    after the launch) is the swarms' arrival counters, which a caller
    launching many times owns (else they are allocated here)."""
    d, ld = pos.shape
    if block_n < 1 or n % block_n:
        raise ValueError(f"split fold: block_n={block_n} must divide {n}")
    nb = n // block_n
    _validate("split fold", d, ld, n, nb, pos.dtype, pos=pos, pbp=pbp,
              pbf=pbf, fit=fit, gp=gp, gf=gf, pbv=pbv, viol=viol, lp=lp,
              lf=lf, keys=keys, act=act, aux_fit=aux_fit, aux_idx=aux_idx,
              counts=counts, arrive=arrive)
    given = dict(gp=gp, gf=gf, lp=lp, lf=lf, keys=keys, act=act,
                 aux_fit=aux_fit, aux_idx=aux_idx)
    missing = [k for k in _NEEDS[mode] if given[k] is None]
    if (viol is None) != (pbv is None):
        missing.append("viol and pbv together")
    if missing:
        raise ValueError(f"split fold, {mode} mode: needs {missing}")
    topo = _topology_operands(topology, nb)
    if topo[0] and mode != "async":
        raise ValueError("an lbest topology pulls in the async mode only")
    if _cluster is not None and _cluster not in FOLD_CLUSTERS:
        raise ValueError(f"split fold: cluster size {_cluster} is not one "
                         f"of {FOLD_CLUSTERS}")
    if pos.device.type == "cpu":
        out = split_fold_plain(pos, pbp, pbf, fit, n=n, block_n=block_n,
                               mode=mode, gf=gf, pbv=pbv, viol=viol, lp=lp,
                               lf=lf, keys=keys, counts=counts)
        _copy_into(dict(pbp=pbp, pbf=pbf, pbv=pbv, lp=lp, lf=lf, keys=keys,
                        aux_fit=aux_fit, aux_idx=aux_idx), out)
        if mode != "queue":
            out = split_publish_plain(pos, fit, gp, gf, n=n, mode=mode,
                                      keys=keys, lp=lp, lf=lf, act=act,
                                      counts=counts, topology=topology)
            _copy_into(dict(gp=gp, gf=gf, keys=keys, lp=lp, lf=lf), out)
        return
    dev = pos.device
    s_cnt = ld // n
    if arrive is None and mode != "queue":
        arrive = torch.zeros(s_cnt, dtype=torch.int32, device=dev)
    scratch = pos.new_empty((d + 1) * s_cnt * nb) if topo[0] else None
    cluster = _cluster or fold_cluster_size(s_cnt, n, d, block_n, _sm_count(
        torch.cuda.current_device() if dev.index is None else dev.index))
    _cuda_operands(pos, pbp, pbf, fit, gp, gf, pbv, viol, lp, lf, keys, act,
                   aux_fit, aux_idx, counts, arrive)
    with torch.cuda.device(dev):
        _check(_lib(pos.dtype).pso_split_fold_publish(
            *_ptrs([pos, pbp, pbf, pbv, fit, viol, gp, gf, lp, lf, keys,
                    aux_fit, aux_idx, counts, act, arrive, scratch]),
            n, d, block_n, s_cnt, MODES[mode], *topo, cluster,
            _stream(dev)),
            "split fold-and-publish kernel launch")
    count(fold_publish, pos.dtype, 1)


fold_publish.launches = fold_publish.bf16_launches = 0


# ---------------------------------------------------------------------------
# The torch step and the iteration chain
# ---------------------------------------------------------------------------

def _flat(x: Tensor, pos: Tensor) -> Tensor:
    """A user function's per-particle output as the contiguous [S*N] the
    fold kernel reads, in the state's dtype (a wider output rounded)."""
    return x.reshape(-1).to(pos.dtype).contiguous()


def torch_step(table, fids, n: int, lead: Tuple[int, ...]
               ) -> Callable[[Tensor], Tuple[Tensor, Optional[Tensor]]]:
    """The torch step between ``advance`` and ``fold``: ``step(pos [D,
    S*N]) -> (fit [S*N], viol [S*N] or None)``. The positions are given to
    the user's functions particle-major and contiguous, ``[*lead, D]``
    (``lead`` is ``(N,)`` for one swarm, ``(S, N)`` for a batch), as the
    eager engine gives them, so a run matches it bit for bit; a
    ``kernel_fn`` takes the D-major array itself. A heterogeneous table
    evaluates each member on its own swarms' positions (projection and the
    Deb rule never apply there)."""
    if fids is None:
        prob = table[0]
        proj, kfn = prob.projection_fn, prob.kernel_fn
        vf = prob.violation_fn if prob.deb else None

        def step(pos):
            if kfn is not None:
                return _flat(kfn(pos), pos), None
            x = pos.t().contiguous().view(*lead, pos.shape[0])
            if proj is not None:
                x = proj(x)
                pos.copy_(x.reshape(-1, pos.shape[0]).t())
            return _flat(prob.max_fn(x), pos), (
                None if vf is None else _flat(vf(x), pos))
        return step
    fl = fids.tolist()
    s_cnt = len(fl)
    groups = []
    for k in sorted(set(fl)):
        rows = [s for s in range(s_cnt) if fl[s] == k]
        groups.append((table[k], torch.tensor(rows, device=fids.device)))

    def step(pos):
        d, ld = pos.shape
        fit = pos.new_empty(s_cnt, n)
        x = None
        for prob, rows in groups:
            rows = rows.to(pos.device)
            if prob.kernel_fn is not None:
                cols = (rows[:, None] * n + torch.arange(
                    n, device=pos.device)).reshape(-1)
                fit[rows] = prob.kernel_fn(pos.index_select(1, cols)
                                           ).reshape(-1, n).to(pos.dtype)
                continue
            if x is None:
                x = pos.t().contiguous().view(s_cnt, n, d)
            fit[rows] = prob.max_fn(x[rows]).to(pos.dtype)
        return fit.reshape(-1), None
    return step


def iterate(state, seeds, its, specs, fids, step, *, n: int, block_n: int,
            off: int, iters: int, sync_every: Optional[int] = None,
            pbv=None, counts=None, counters=None,
            topology: str = "gbest") -> Optional[Tensor]:
    """``iters`` iterations of the split path on ``state`` = (pos, vel,
    pbp, pbf, gp, gf), plus (lp, lf) for the async mode (``sync_every``
    given, pulling by ``topology`` at its sync points), in place, the
    first at offset ``off`` into the call's iterations: two launches an
    iteration, ``advance`` and ``fold_publish``, around ``step``
    (``torch_step``'s); ``pbv`` the carried pbest violation where Deb
    applies. Returns the last iteration's fitness."""
    pos, vel, pbp, pbf, gp, gf = state[:6]
    s_cnt = gf.shape[0]
    dev = pos.device
    cuda = dev.type == "cuda"
    if counters is None and cuda:
        counters = uint32_rows(seeds, its, dev)
    # owned by this call: zero between launches
    arrive = torch.zeros(s_cnt, dtype=torch.int32, device=dev) if cuda \
        else None
    fit = None
    if sync_every is None:
        keys = torch.zeros(s_cnt, dtype=torch.int64, device=dev)
        for t in range(iters):
            advance(pos, vel, pbp, gp, seeds, its, specs, fids, n=n,
                    it_off=off + t, gdiv=n, counters=counters)
            fit, viol = step(pos)
            fold_publish(pos, pbp, pbf, fit, n=n, block_n=block_n,
                         mode="fused", gp=gp, gf=gf, pbv=pbv, viol=viol,
                         keys=keys, counts=counts, arrive=arrive)
        return fit
    lp, lf = state[6:]
    # the action of each iteration for each swarm (core/pso.py _sync_point)
    t_ar = torch.arange(iters, device=dev)[:, None]
    due = (its.to(dev, torch.int64)[None, :] + off + t_ar + 1) \
        % max(1, sync_every) == 0
    act = torch.where(due, ACT_SYNC, torch.where(
        t_ar == iters - 1, ACT_FLUSH, ACT_NONE)).to(torch.int32)
    for t in range(iters):
        advance(pos, vel, pbp, lp, seeds, its, specs, fids, n=n,
                it_off=off + t, gdiv=block_n, counters=counters)
        fit, viol = step(pos)
        fold_publish(pos, pbp, pbf, fit, n=n, block_n=block_n, mode="async",
                     gp=gp, gf=gf, pbv=pbv, viol=viol, lp=lp, lf=lf,
                     act=act[t], counts=counts, arrive=arrive,
                     topology=topology)
    return fit
