"""Schedule autotuning, the port of ``repro.core.autotune``: pick
``(variant, backend, block_n, sync_every)`` per solve shape from the
roofline cost model, with a measured fallback.

``repro_torch.Method(schedule="auto")`` routes here instead of the fixed
``resolve_backend`` rule. Resolution is three-stage:

1. **Cache**: measured optima persist per ``(scope, shape key)`` in an
   on-disk JSON cache (``REPRO_AUTOTUNE_CACHE``, default
   ``~/.cache/repro_torch/autotune.json``) fronted by an in-process LRU,
   so the second resolve of a shape never measures again. The scope names
   the backend and the device kind (``kernel:NVIDIA H100 80GB HBM3``,
   ``eager:cpu``): an optimum measured on another device is never read
   back (the reference's scopes are ``kernel`` and ``jnp``).
2. **Model**: ``repro_torch.roofline.pso_cost`` prices every candidate
   schedule (variants x block sizes x sync intervals) with the device's
   calibration (``pso_cost.default_calibration``); candidates rank by
   predicted microseconds per iteration.
3. **Measured fallback**: the top-``K`` model picks PLUS the fixed default
   schedule run timed micro-iterations; the measured argmin wins, except
   that a challenger within ``MEASURE_NOISE_MARGIN`` of the fixed default
   loses to it. Including the fixed default makes the tuned choice never
   worse than the fixed rule by construction, model error notwithstanding.

Kernel-backend candidates enter only on a CUDA device with a rule the
kernels carry (``update_rules.kernel_carries``); on the CPU the kernel
backend runs the kernels' plain versions, which no schedule should choose
(the reference keeps interpret mode out the same way). Block sizes the
card cannot launch (the fused kernel's cooperative launch, the async
grid's size: ``pso_step.launch_fits``) are dropped before ranking. A
candidate that fails to build or to launch raises: nothing here catches
an error of a measurement.

The serving layer (``repro_torch.launch.serve``, ``repro_torch.serving``)
uses the model-only entry points: ``tuned_sync_every`` rewrites async
requests' publication interval, and ``bucket_ladder`` drops bucket sizes
whose marginal per-row gain the model prices below threshold.

    python -m repro_torch.core.autotune --seed-priors [--device cpu]
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import sys
import time
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from .. import _device

CACHE_ENV = "REPRO_AUTOTUNE_CACHE"
_LRU_SIZE = 512
#: measured micro-run length (iterations) and repeats for the fallback
MEASURE_ITERS = 24
MEASURE_REPEATS = 2
#: how many model-ranked candidates the measured fallback times
TOP_K = 3
#: hysteresis: a candidate must beat the measured fixed default by this
#: fraction to displace it; a within-noise "win" would flip sign on the
#: next independent measurement.
MEASURE_NOISE_MARGIN = 0.10
SYNC_EVERY_CHOICES = (1, 4, 8, 16, 32, 64)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A fully-resolved execution schedule for one solve shape.

    ``block_n`` is the kernel block size / eager async block size (None:
    the ``pick_block_n`` default); ``sync_every`` only matters for
    ``variant="async"``. ``backend`` is ``eager`` or ``kernel``.
    ``source`` records how the schedule was chosen: ``fixed`` (the legacy
    rule), ``model`` (analytic ranking only), ``measured`` (micro-run
    fallback) or ``cache`` (a previously measured optimum)."""

    variant: str
    backend: str
    block_n: Optional[int] = None
    sync_every: int = 8
    source: str = "fixed"
    predicted_us: Optional[float] = None
    measured_us: Optional[float] = None

    def replace(self, **kw) -> "Schedule":
        return dataclasses.replace(self, **kw)


def _kernel_ok(device: torch.device, rule: str = "pso") -> bool:
    """Whether kernel candidates exist: a CUDA device and a rule the CUDA
    kernels carry."""
    from .update_rules import kernel_carries
    return device.type == "cuda" and kernel_carries(rule)


def cache_scope(kernel_ok: bool, device: torch.device) -> str:
    """The cache scope of a resolution: the backend family it may pick and
    the device kind it measured on."""
    from ..roofline.pso_cost import device_kind
    return f"{'kernel' if kernel_ok else 'eager'}:{device_kind(device)}"


def shape_key(problem, d: int, n: int, iters: int, dtype: str,
              batch: int = 1, hetero_table: int = 0,
              rule: str = "pso") -> str:
    """Stable cache key for one solve shape, the reference's for the
    registered built-ins. ``iters`` is bucketed to its power-of-two
    ceiling; the update rule is part of the shape (its op mix moves the
    compute roofline). A custom objective keys on its content hash
    (``Problem.cache_key``, stable across processes)."""
    from .problem import resolve_problem

    it = 1
    while it < max(1, iters):
        it *= 2
    prob = resolve_problem(problem)
    pid = prob.name if not prob.constrained else f"{prob.name}+c"
    if not _fitness_named(prob):
        pid = f"custom:{prob.cache_key()[:8]}"
    return (f"{pid}|d{d}|n{n}|i{it}|{dtype}|b{batch}|h{hetero_table}"
            f"|r{rule}")


def _fitness_named(prob) -> bool:
    from .fitness import BUILTIN_PROBLEMS
    return any(prob.name == p.name for p in BUILTIN_PROBLEMS)


class AutotuneCache:
    """Measured-optima store: on-disk JSON + in-process LRU.

    The disk document maps ``{scope}::{shape_key} -> schedule dict``;
    writes are atomic (tmp + rename) and last-writer-wins: concurrent
    tuners may each measure once, which is safe, just redundant."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or os.environ.get(CACHE_ENV) or os.path.join(
            os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json")
        self._lru: "OrderedDict[str, Schedule]" = OrderedDict()
        self._disk_loaded = False

    def _load_disk(self) -> dict:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def get(self, scope: str, key: str) -> Optional[Schedule]:
        k = f"{scope}::{key}"
        if k in self._lru:
            self._lru.move_to_end(k)
            return self._lru[k]
        if not self._disk_loaded:
            for dk, v in self._load_disk().items():
                try:
                    self._lru.setdefault(dk, Schedule(**v))
                except TypeError:
                    continue    # stale schema: ignore, will re-measure
            self._disk_loaded = True
            if k in self._lru:
                return self._lru[k]
        return None

    def put(self, scope: str, key: str, sched: Schedule) -> None:
        k = f"{scope}::{key}"
        self._lru[k] = sched.replace(source="cache")
        self._lru.move_to_end(k)
        while len(self._lru) > _LRU_SIZE:
            self._lru.popitem(last=False)
        doc = self._load_disk()
        doc[k] = dataclasses.asdict(sched.replace(source="cache"))
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError:
            pass    # the cache is an optimization; never fail the solve


_CACHE: Optional[AutotuneCache] = None


def default_cache() -> AutotuneCache:
    global _CACHE
    if _CACHE is None or _CACHE.path != (
            os.environ.get(CACHE_ENV) or _CACHE.path):
        _CACHE = AutotuneCache()
    return _CACHE


def fixed_schedule(variant: str = "queue", *, record_history: bool = False,
                   sync_every: int = 8, block_n: Optional[int] = None,
                   device=None) -> Schedule:
    """The legacy ``Method.resolve_backend`` rule as a Schedule: the kernel
    on a CUDA device for the fused variants (unless history is requested),
    eager else."""
    dev = _device.resolve(device)
    backend = ("kernel" if variant in ("queue_lock", "async")
               and not record_history and dev.type == "cuda" else "eager")
    return Schedule(variant=variant, backend=backend, block_n=block_n,
                    sync_every=sync_every, source="fixed")


def _block_choices(n: int, kernel: bool) -> List[Optional[int]]:
    """Candidate block sizes: the heuristic default plus the divisors of
    ``n`` nearest the roofline-relevant range (a handful, not all)."""
    from .blocking import LANE, pick_block_n

    lane = LANE if kernel else 1
    default = pick_block_n(n, lane=lane)
    divs = [b for b in range(1, n + 1) if n % b == 0]
    good = [b for b in divs if 32 <= b <= 1024 and (b % lane == 0)]
    picks = {None, default}
    for target in (128, 256, 512):
        cands = [b for b in good if b <= target]
        if cands:
            picks.add(max(cands))
    if n <= 1024:
        picks.add(n)
    return sorted(picks, key=lambda b: (b is None, b))


def candidate_schedules(d: int, n: int, iters: int, *,
                        kernel_ok: Optional[bool] = None,
                        variants: Optional[Sequence[str]] = None,
                        max_candidates: int = 24,
                        device=None) -> List[Schedule]:
    """Enumerate the schedule search space for one shape.

    Synchronous variants contribute one candidate each (their block/sync
    knobs don't exist or don't matter); ``async`` fans out over block
    sizes x sync intervals. Kernel backends join only when ``kernel_ok``
    (default: ``device`` is a CUDA device)."""
    if kernel_ok is None:
        kernel_ok = _device.resolve(device).type == "cuda"
    variants = tuple(variants or ("reduction", "queue", "queue_lock",
                                  "async"))
    out: List[Schedule] = []
    for v in variants:
        if v != "async":
            out.append(Schedule(v, "eager"))
            if kernel_ok and v == "queue_lock":
                for bn in _block_choices(n, kernel=True):
                    out.append(Schedule(v, "kernel", block_n=bn))
            continue
        syncs = [k for k in SYNC_EVERY_CHOICES if k <= max(1, iters)] or [1]
        for bn in _block_choices(n, kernel=False):
            for k in syncs:
                out.append(Schedule("async", "eager", block_n=bn,
                                    sync_every=k))
        if kernel_ok:
            for bn in _block_choices(n, kernel=True):
                for k in syncs:
                    out.append(Schedule("async", "kernel", block_n=bn,
                                        sync_every=k))
    # Thin the async fan-out evenly if over budget (keep first/last knobs).
    if len(out) > max_candidates:
        sync_like = [s for s in out if s.variant != "async"]
        asyncs = [s for s in out if s.variant == "async"]
        keep = max(1, max_candidates - len(sync_like))
        step = max(1, len(asyncs) // keep)
        out = sync_like + asyncs[::step][:keep]
    return out


def _card_plan(problem, d: int, hetero_table: int, rule: str,
               device: torch.device) -> Tuple[Callable, Callable]:
    """``(capacity, resident)`` of ``pso_step.launch_fits`` on the card, as
    functions of ``(block_n, cluster size)``: the occupancy queries the
    kernel wrappers make before a launch."""
    from ..kernels import pso_step
    from .fitness import FITNESS_IDS
    from .problem import resolve_problem
    from .update_rules import kernel_rule_id

    idx = pso_step._device_index(device)
    fit_id = (pso_step.HETERO if hetero_table
              else FITNESS_IDS[resolve_problem(problem).name])
    rule_id = kernel_rule_id(rule)

    def capacity(bn: int, c: int) -> int:
        with torch.cuda.device(idx):
            return pso_step._capacity(bn, d, idx, c)

    def resident(bn: int, c: int) -> int:
        with torch.cuda.device(idx):
            return pso_step._resident(fit_id, rule_id, bn, d, c, idx)

    return capacity, resident


def feasible_schedules(cands: Sequence[Schedule], problem, d: int, n: int,
                       *, batch: int = 1, hetero_table: int = 0,
                       rule: str = "pso", device=None,
                       capacity: Optional[Callable] = None,
                       resident: Optional[Callable] = None
                       ) -> List[Schedule]:
    """``cands`` without the kernel schedules the card cannot launch
    (``pso_step.launch_fits``; ``capacity(block_n, c)`` and
    ``resident(block_n, c)`` default to the card's occupancy queries on a
    CUDA device). Eager schedules, the split path's (any non-built-in
    Problem: normal launches of any size) and, on the CPU without injected
    queries, every schedule (the plain versions take any block) stay."""
    from ..kernels import pso_step
    from .blocking import pick_block_n
    from .fitness import is_builtin
    from .problem import resolve_problem

    dev = _device.resolve(device)
    split = not hetero_table and not is_builtin(resolve_problem(problem))
    if split or (capacity is None and dev.type != "cuda"):
        return list(cands)
    if capacity is None:
        capacity, resident = _card_plan(problem, d, hetero_table, rule, dev)
    out = []
    for s in cands:
        if s.backend == "kernel":
            bn = s.block_n or pick_block_n(n)
            if n % bn or not pso_step.launch_fits(
                    s.variant, n, d, bn, max(1, batch),
                    functools.partial(capacity, bn),
                    functools.partial(resident, bn)):
                continue
        out.append(s)
    return out


def rank_schedules(cands: Sequence[Schedule], problem, d: int, n: int,
                   iters: int, dtype: str = "float32", batch: int = 1,
                   hetero_table: int = 0, rule: str = "pso",
                   calib=None, device=None) -> List[Schedule]:
    """Model-rank candidates (ascending predicted us/iter). Candidates the
    model cannot price (a block size that does not divide ``n``, or a
    kernel block off the 128-lane grid) are dropped. ``calib`` prices every
    candidate; by default each is priced with its backend's calibration
    on ``device`` (``pso_cost.default_calibration``)."""
    from ..roofline import pso_cost
    from .blocking import LANE

    dev = _device.resolve(device) if calib is None else None
    ranked = []
    for s in cands:
        if s.block_n is not None and (n % s.block_n
                                      or (s.backend == "kernel"
                                          and s.block_n % LANE
                                          and s.block_n != n)):
            continue
        us = pso_cost.estimate_us_per_iter(
            s.variant, problem, d, n, dtype=dtype, backend=s.backend,
            block_n=s.block_n, sync_every=s.sync_every, batch=batch,
            hetero_table=hetero_table, rule=rule,
            calib=calib or pso_cost.default_calibration(dev, s.backend))
        ranked.append(s.replace(source="model", predicted_us=us))
    ranked.sort(key=lambda s: s.predicted_us)
    return ranked


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_schedule(sched: Schedule, problem, d: int, n: int,
                     dtype: str = "float32", seed: int = 0,
                     iters: int = MEASURE_ITERS,
                     repeats: int = MEASURE_REPEATS,
                     rule: str = "pso", device=None) -> float:
    """Time a micro-run of ``sched`` on ``device`` (us per iteration, best
    of ``repeats`` after an untimed warm-up call, which also absorbs the
    kernels' first build). Goes straight at the engine entry points, never
    back through the facade, so measurement cannot recurse into
    resolution. Any error of the run propagates."""
    from .problem import resolve_problem
    from .pso import PSOConfig, init_swarm, run

    dev = _device.resolve(device)
    prob = resolve_problem(problem)
    cfg = PSOConfig(dim=d, particle_cnt=n, fitness=prob,
                    dtype=dtype, update_rule=rule).resolved()
    state = init_swarm(cfg, seed, device=dev)

    if sched.backend == "kernel":
        from ..kernels import ops
        if sched.variant == "async":
            def go():
                return ops.run_queue_lock_fused_async(
                    cfg, state, iters, sync_every=sched.sync_every,
                    block_n=sched.block_n)
        else:
            def go():
                return ops.run_queue_lock_fused(cfg, state, iters,
                                                block_n=sched.block_n)
    else:
        n_blocks = (n // sched.block_n
                    if sched.variant == "async" and sched.block_n else None)

        def go():
            return run(cfg, state, iters, sched.variant,
                       sync_every=sched.sync_every, n_blocks=n_blocks)

    go()                                  # build, load and warm caches
    _sync(dev)
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        go()
        _sync(dev)
        best = min(best, (time.perf_counter() - t0) / iters * 1e6)
    return best


def resolve_schedule(problem, d: int, n: int, iters: int, *,
                     dtype: str = "float32", batch: int = 1,
                     hetero_table: int = 0, record_history: bool = False,
                     measure: bool = True, top_k: int = TOP_K,
                     cache: Optional[AutotuneCache] = None,
                     kernel_ok: Optional[bool] = None,
                     variants: Optional[Sequence[str]] = None,
                     rule: str = "pso", device=None) -> Schedule:
    """The ``schedule="auto"`` entry point: cache -> model -> measured,
    on ``device`` (None: the card).

    ``measure=False`` (the serving layer) stops after the model ranking,
    no micro-runs, but still reads the cache, so a previously measured
    optimum wins. ``record_history`` restricts to the eager engines. The
    fixed-default schedule is ALWAYS among the measured candidates, and a
    challenger must beat it by ``MEASURE_NOISE_MARGIN`` to displace it:
    the tuned pick is never worse than the fixed rule, and within-noise
    ties keep the default."""
    dev = _device.resolve(device)
    cache = cache or default_cache()
    if kernel_ok is None:
        kernel_ok = _kernel_ok(dev, rule) and not record_history
    scope = cache_scope(kernel_ok, dev)
    key = shape_key(problem, d, n, iters, dtype, batch, hetero_table,
                    rule=rule)
    hit = cache.get(scope, key)
    if hit is not None:
        return hit
    cands = candidate_schedules(d, n, iters, kernel_ok=kernel_ok,
                                variants=variants)
    cands = feasible_schedules(cands, problem, d, n, batch=batch,
                               hetero_table=hetero_table, rule=rule,
                               device=dev)
    ranked = rank_schedules(cands, problem, d, n, iters, dtype=dtype,
                            batch=batch, hetero_table=hetero_table,
                            rule=rule, device=dev)
    if not ranked:
        return fixed_schedule(record_history=record_history, device=dev)
    if not measure:
        return ranked[0]
    fixed = fixed_schedule(record_history=record_history, device=dev)
    if not kernel_ok and fixed.backend == "kernel":
        fixed = fixed.replace(backend="eager")

    def is_fixed(s: Schedule) -> bool:
        return (s.variant == fixed.variant and s.backend == fixed.backend
                and s.block_n == fixed.block_n
                and (s.variant != "async"
                     or s.sync_every == fixed.sync_every))

    to_measure = list(ranked[:max(1, top_k)])
    if not any(is_fixed(s) for s in to_measure):
        to_measure.append(fixed.replace(source="model"))
    timed = [s.replace(source="measured", measured_us=measure_schedule(
        s, problem, d, n, dtype, rule=rule, device=dev))
        for s in to_measure]
    best = min(timed, key=lambda s: s.measured_us)
    # Hysteresis: keep the fixed default unless the winner clearly beats
    # it; a within-noise "win" would not survive re-measurement.
    anchor = next((s for s in timed if is_fixed(s)), None)
    if (anchor is not None and not is_fixed(best)
            and best.measured_us
            > (1.0 - MEASURE_NOISE_MARGIN) * anchor.measured_us):
        best = anchor
    cache.put(scope, key, best)
    return best


# --------------------------------------------------------------------------
# Serving-layer entry points (model-only: bounded latency).
# --------------------------------------------------------------------------

def tuned_sync_every(problem, d: int, n: int, iters: int,
                     dtype: str = "float32", batch: int = 1,
                     cache: Optional[AutotuneCache] = None,
                     device=None) -> int:
    """Best publication interval for an async solve at this shape (model
    ranking restricted to ``variant="async"``, cache-backed)."""
    s = resolve_schedule(problem, d, n, iters, dtype=dtype, batch=batch,
                         measure=False, cache=cache, variants=("async",),
                         device=device)
    return s.sync_every


def seed_priors(cache: Optional[AutotuneCache] = None,
                problems: Optional[Sequence] = None,
                dims: Sequence[int] = (1, 8),
                particles: Sequence[int] = (256, 1024),
                iters: int = 1024, dtype: str = "float32",
                device=None) -> int:
    """Pre-populate the cache with model-ranked schedules for the
    registry x a small shape grid on ``device`` (per-problem autotune
    priors): a fresh replica resolving ``schedule="auto"`` for a common
    shape then starts from the cost model's pick instead of timed
    micro-runs. Already-cached keys (measured optima included) are never
    overwritten. Returns the number of entries seeded."""
    from .fitness import BUILTIN_PROBLEMS

    dev = _device.resolve(device)
    cache = cache or default_cache()
    if problems is None:
        problems = [p.name for p in BUILTIN_PROBLEMS]
    kernel_ok = _kernel_ok(dev)
    scope = cache_scope(kernel_ok, dev)
    seeded = 0
    for prob in problems:
        for d in dims:
            for n in particles:
                key = shape_key(prob, d, n, iters, dtype)
                if cache.get(scope, key) is not None:
                    continue
                cands = feasible_schedules(
                    candidate_schedules(d, n, iters, kernel_ok=kernel_ok),
                    prob, d, n, device=dev)
                ranked = rank_schedules(cands, prob, d, n, iters,
                                        dtype=dtype, device=dev)
                if ranked:
                    cache.put(scope, key, ranked[0])
                    seeded += 1
    return seeded


def bucket_ladder(problem, d: int, n: int, iters: int, *,
                  max_batch: int = 128, variant: str = "queue",
                  dtype: str = "float32", min_bucket: int = 4,
                  gain_threshold: float = 0.05,
                  device=None) -> Tuple[int, ...]:
    """Batch-size buckets for the serving layer, from the cost model of
    the eager engine on ``device``, as the reference prices its jnp one.

    Doubling the bucket always doubles the work; it pays when the
    per-ROW predicted cost drops by at least ``gain_threshold`` (fixed
    overheads amortizing). Buckets past the point of diminishing returns
    are dropped, shrinking the program cache without losing fill."""
    from ..roofline import pso_cost

    calib = pso_cost.default_calibration(_device.resolve(device), "eager")
    ladder = [min_bucket]
    backend = "eager"
    prev_row = pso_cost.estimate_us_per_iter(
        variant, problem, d, n, dtype=dtype, backend=backend,
        batch=min_bucket, calib=calib) / min_bucket
    b = min_bucket * 2
    while b <= max_batch:
        row = pso_cost.estimate_us_per_iter(
            variant, problem, d, n, dtype=dtype, backend=backend,
            batch=b, calib=calib) / b
        ladder.append(b)
        if row >= prev_row * (1.0 - gain_threshold):
            break   # per-row cost flattened: larger buckets don't pay
        prev_row = row
        b *= 2
    return tuple(ladder)


def _main(argv=None) -> int:
    """CLI: ``python -m repro_torch.core.autotune --seed-priors`` (the step
    that builds a priors file for ``REPRO_AUTOTUNE_CACHE``)."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Autotune cache utilities (schedule priors)")
    ap.add_argument("--seed-priors", action="store_true",
                    help="seed model-ranked schedules for the registry "
                         "x shape grid")
    ap.add_argument("--cache", default=None,
                    help="cache file (default: REPRO_AUTOTUNE_CACHE or "
                         "~/.cache/repro_torch/autotune.json)")
    ap.add_argument("--dims", default="1,8")
    ap.add_argument("--particles", default="256,1024")
    ap.add_argument("--iters", type=int, default=1024)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if not args.seed_priors:
        ap.print_help()
        return 2
    try:
        dev = _device.resolve(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    cache = AutotuneCache(args.cache) if args.cache else default_cache()
    n = seed_priors(
        cache=cache,
        dims=tuple(int(x) for x in args.dims.split(",")),
        particles=tuple(int(x) for x in args.particles.split(",")),
        iters=args.iters, device=dev)
    print(f"seeded {n} schedule prior(s) into {cache.path} "
          f"(scope {cache_scope(_kernel_ok(dev), dev)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
