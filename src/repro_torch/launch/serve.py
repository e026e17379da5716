"""Flush-batching front end for PSO solves, the port of
``repro.launch.serve``: collect a queue generation, group by compile key,
dispatch padded batches.

``SolveServer`` collects submitted requests until ``flush()``, groups them
by their key, pads each group to a bucketed batch size, and routes every
group through one batched solve. It is the tool for OFFLINE batches: all
requests known up front, throughput over latency. For a stream (staggered
arrivals, mixed iteration budgets) use ``repro_torch.serving.
ContinuousScheduler``, which shares this module's request and result
types.

Backends are the facade's (``api.Method``): ``eager`` (the batched eager
engine, ``core.multi_swarm.solve_many``), ``kernel`` (``queue_lock``
groups through the batched fused kernels, ``async`` groups through the
batched async kernels, both by ``kernels.ops.run_queue_lock``; the other
variants have no kernel and run eager) or ``auto``, resolved per group by
``Method.resolve_backend`` on the server's device: the kernels on a card,
eager on the CPU. The reference's ``"jnp"`` is ``"eager"`` here, and its
``interpret=`` has no counterpart. ``device=None`` means the card.

Grouping is two-tier, as in the reference. Registered built-ins coalesce
into one HETEROGENEOUS batch keyed on the solve's shape, each row
dispatched to its own objective and bounds; custom ``Problem``s group by
content (``Problem.cache_key``), so distinct objectives never share a
batch and re-submitted identical ones do. ``coalesce_registry=False``
keys every request by content. A group whose solve raises resolves its
tickets to error results and leaves the other groups alone; a request
with an unknown variant, rule or topology gets its own error result.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 24 \\
        --iters 200 [--backend eager|kernel] [--autotune] \\
        [--metrics-out PATH] [--device cpu]

Padding rows reuse the group's first seed and are dropped before results
are returned. ``ServeStats`` reports the padding; an attached
``serving.ServingMetrics`` records per-request latency spans and dispatch
counters.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .. import _device
from ..api import _KERNEL_VARIANTS, Method
from ..core.multi_swarm import (hetero_fid, init_batch, problem_rows,
                                solve_many)
from ..core.problem import Problem, resolve_problem
from ..core.pso import ASYNC_SYNC_EVERY, PSOConfig

_MIN_BUCKET = 4
BUCKETS = (_MIN_BUCKET, 8, 16, 32, 64, 128)

# Hetero batch keys carry this marker in the content slot: every registry
# built-in at the same solve shape lands in ONE group, on a config pinned to
# a canonical fitness (the rows carry the real objectives).
_HETERO = "__hetero__"
_HETERO_CANONICAL_FITNESS = "cubic"

BACKENDS = ("auto", "eager", "kernel")


def resolve_backend(backend: str, variant: str, rule: str, device) -> str:
    """``eager`` or ``kernel`` for a group of ``variant``/``rule`` requests
    on ``device``: variants without a kernel run eager; otherwise the
    facade's ``Method.resolve_backend`` (``auto``: the kernels on a card)."""
    if variant not in _KERNEL_VARIANTS:
        return "eager"
    return Method(variant=variant, backend=backend,
                  rule=rule).resolve_backend(device)


@dataclasses.dataclass(frozen=True)
class SolveRequest:
    """One independent PSO solve.

    ``sync_every`` is the ``variant="async"`` publication interval. It only
    enters the compile key for async requests; the synchronous variants
    ignore it.
    """

    dim: int = 1
    particle_cnt: int = 1024
    fitness: Union[str, Problem] = "cubic"
    seed: int = 0
    iters: int = 1000
    variant: str = "queue"
    dtype: str = "float32"
    sync_every: int = ASYNC_SYNC_EVERY
    rule: str = "pso"          # update rule (core.update_rules)
    topology: str = "gbest"    # async lbest topology (core.topology)

    def _topology_key(self) -> str:
        """The topology only exists on the async variant's block-local
        machinery; sync requests key on the star."""
        return self.topology if self.variant == "async" else "gbest"

    @property
    def batch_key(self) -> Tuple:
        """Everything that forces a distinct program; the problem enters by
        content hash, a registered name resolved through the registry."""
        return (self.dim, self.particle_cnt,
                resolve_problem(self.fitness).cache_key(), self.iters,
                self.variant, self.dtype,
                self.sync_every if self.variant == "async" else 0,
                self.rule, self._topology_key())

    @property
    def hetero_eligible(self) -> bool:
        """True when the problem is a registered built-in: the request can
        ride a shared heterogeneous batch with other built-ins."""
        return hetero_fid(self.fitness) is not None

    def group_key(self, coalesce_registry: bool = True) -> Tuple:
        """The server's grouping key: the hetero marker for built-ins, the
        content hash otherwise."""
        if coalesce_registry and self.hetero_eligible:
            return (self.dim, self.particle_cnt, _HETERO, self.iters,
                    self.variant, self.dtype,
                    self.sync_every if self.variant == "async" else 0,
                    self.rule, self._topology_key())
        return self.batch_key

    def config(self) -> PSOConfig:
        return PSOConfig(dim=self.dim, particle_cnt=self.particle_cnt,
                         fitness=self.fitness, dtype=self.dtype,
                         update_rule=self.rule,
                         topology=self._topology_key())


@dataclasses.dataclass
class SolveResult:
    request: SolveRequest
    gbest_fit: float         # canonical (maximized) fitness
    gbest_pos: np.ndarray
    batch_size: int          # padded batch the request rode in
    error: Optional[BaseException] = None  # set when the solve raised
    history: Optional[object] = None  # repro_torch.History sampled at the
    # lane's chunk boundaries (continuous scheduler, record_history=True)

    @property
    def ok(self) -> bool:
        """False when this request's group failed: ``error`` holds the
        exception and the ``gbest_*`` fields are meaningless."""
        return self.error is None

    @property
    def objective(self) -> float:
        """The objective value in the problem's own sense."""
        if not self.ok:
            raise RuntimeError(
                f"request failed: {self.error!r}") from self.error
        return float(resolve_problem(self.request.fitness)
                     .user_value(self.gbest_fit))

    @property
    def violation(self) -> float:
        """Aggregate constraint violation at ``gbest_pos`` (0.0 for
        unconstrained problems), as ``repro_torch.Result.violation``."""
        import torch
        return resolve_problem(self.request.fitness).violation_at(
            torch.as_tensor(self.gbest_pos))

    @property
    def feasible(self) -> bool:
        return self.violation <= 0.0


def request_error(r: SolveRequest) -> Optional[Exception]:
    """Per-request admission validation: the rejection (or None). Returned,
    not raised, so a bad variant, rule, topology or problem resolves to its
    own error result instead of failing the group it would join."""
    from ..core.pso import VARIANTS
    from ..core.update_rules import TOPOLOGIES, resolve_rule
    if r.variant not in VARIANTS:
        return ValueError(
            f"unknown variant {r.variant!r}; one of {VARIANTS}")
    try:
        resolve_rule(r.rule)
    except ValueError as e:
        return e
    if r.topology not in TOPOLOGIES:
        return ValueError(
            f"unknown topology {r.topology!r}; one of {TOPOLOGIES}")
    try:
        resolve_problem(r.fitness)
    except (KeyError, ValueError, TypeError) as e:
        return e
    return None


@dataclasses.dataclass
class ServeStats:
    requests: int = 0
    dispatches: int = 0      # batched device programs launched
    padded_rows: int = 0     # wasted swarm slots from bucket padding
    hetero_dispatches: int = 0  # of which: heterogeneous (mixed-problem)
    failed: int = 0          # requests whose group's solve raised

    @property
    def batch_fill(self) -> float:
        """Mean real (non-padding) rows per dispatch."""
        return self.requests / self.dispatches if self.dispatches else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["batch_fill"] = self.batch_fill
        return d


def bucket_size(k: int, max_batch: int = BUCKETS[-1],
                buckets: Tuple[int, ...] = BUCKETS) -> int:
    """Smallest bucket >= k (capped at ``max_batch``)."""
    for b in buckets:
        if b >= min(k, max_batch):
            return min(b, max_batch)
    return max_batch


class SolveServer:
    """Collects solve requests and dispatches them as padded batches.

    ``backend``: ``auto`` | ``eager`` | ``kernel`` (module docstring),
    resolved per group; ``device=None`` means the card. ``block_n`` is the
    kernels' particle-block size (``None``: their pick).
    ``coalesce_registry`` (default on) merges every registered built-in at
    one solve shape into one heterogeneous batch.

    ``autotune=True`` consults the roofline autotuner (``core.autotune``,
    model-only: no timed micro-runs on the serving path, but previously
    measured cache entries win): async requests' ``sync_every`` is
    rewritten to the tuned value for their shape BEFORE grouping (the tuned
    interval is part of the group key, so every request at one shape
    shares one tuned dispatch), and the bucket ladder is derived per
    grouping shape from the cost model (buckets past the point of
    diminishing per-row returns are dropped).
    """

    def __init__(self, max_batch: int = 64, backend: str = "auto",
                 block_n: Optional[int] = None,
                 coalesce_registry: bool = True, autotune: bool = False,
                 metrics=None, device=None):
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r}; one of {BACKENDS}")
        if max_batch < BUCKETS[0]:
            raise ValueError(
                f"max_batch={max_batch} < minimum bucket {BUCKETS[0]}")
        self.device = _device.resolve(device)
        self.max_batch = max_batch
        self.backend = backend
        self.block_n = block_n
        self.coalesce_registry = coalesce_registry
        self.autotune = autotune
        self.stats = ServeStats()
        self.metrics = metrics   # optional serving.ServingMetrics
        self._pending: List[Tuple[int, SolveRequest, float]] = []
        self._ticket = 0
        self._ladders: Dict[Tuple, Tuple[int, ...]] = {}

    def _tuned_request(self, r: SolveRequest) -> SolveRequest:
        """An async request with its publication interval rewritten to the
        tuned value for its shape (sync variants and autotune off: as it
        is)."""
        if not self.autotune or r.variant != "async":
            return r
        from ..core.autotune import tuned_sync_every
        k = tuned_sync_every(r.fitness, r.dim, r.particle_cnt, r.iters,
                             r.dtype, device=self.device)
        return dataclasses.replace(r, sync_every=k)

    def _buckets_for(self, r0: SolveRequest) -> Tuple[int, ...]:
        """The bucket ladder of one grouping shape: static by default,
        model-tuned (memoized per shape) when autotuning."""
        if not self.autotune:
            return BUCKETS
        key = (r0.dim, r0.particle_cnt, r0.iters, r0.variant, r0.dtype)
        if key not in self._ladders:
            from ..core.autotune import bucket_ladder
            self._ladders[key] = bucket_ladder(
                r0.fitness, r0.dim, r0.particle_cnt, r0.iters,
                max_batch=self.max_batch, variant=r0.variant,
                dtype=r0.dtype, min_bucket=_MIN_BUCKET, device=self.device)
        return self._ladders[key]

    def submit(self, req: SolveRequest) -> int:
        """Enqueue a request; returns a ticket resolved by ``flush()``."""
        t = self._ticket
        self._ticket += 1
        self._pending.append((t, req, time.perf_counter()))
        if self.metrics is not None:
            self.metrics.inc("submitted")
        return t

    def _solve_group(self, reqs: List[SolveRequest]) -> List[SolveResult]:
        """One group -> one dispatch (or a few, past ``max_batch``)."""
        out: List[SolveResult] = []
        hetero = (self.coalesce_registry
                  and all(r.hetero_eligible for r in reqs))
        for lo in range(0, len(reqs), self.max_batch):
            chunk = reqs[lo:lo + self.max_batch]
            k = len(chunk)
            padded = bucket_size(k, self.max_batch,
                                 self._buckets_for(chunk[0]))
            seeds = np.array([r.seed for r in chunk]
                             + [chunk[0].seed] * (padded - k), dtype=np.int64)
            r0 = chunk[0]
            if hetero:
                # padding rows replicate the first request's problem too
                probs = ([r.fitness for r in chunk]
                         + [r0.fitness] * (padded - k))
                cfg = PSOConfig(dim=r0.dim, particle_cnt=r0.particle_cnt,
                                fitness=_HETERO_CANONICAL_FITNESS,
                                dtype=r0.dtype, update_rule=r0.rule,
                                topology=r0._topology_key())
                batch = self._dispatch_hetero(cfg, seeds, probs, r0)
            else:
                batch = self._dispatch_uniform(r0.config(), seeds, r0)
            gf = _device.host(batch.gbest_fit)
            gp = _device.host(batch.gbest_pos)
            self.stats.dispatches += 1
            self.stats.hetero_dispatches += int(hetero)
            self.stats.padded_rows += padded - k
            if self.metrics is not None:
                self.metrics.inc("dispatches")
                self.metrics.inc("lane_slots", padded)
                self.metrics.inc("lane_active_slots", k)
            out.extend(SolveResult(request=r, gbest_fit=float(gf[i]),
                                   gbest_pos=gp[i], batch_size=padded)
                       for i, r in enumerate(chunk))
        return out

    def _kernel(self, r0: SolveRequest) -> bool:
        return resolve_backend(self.backend, r0.variant, r0.rule,
                               self.device) == "kernel"

    def _dispatch_uniform(self, cfg: PSOConfig, seeds: np.ndarray,
                          r0: SolveRequest):
        """One problem for the whole batch (content-keyed groups)."""
        if self._kernel(r0):
            from ..kernels.ops import run_queue_lock
            cfg = cfg.resolved()
            return run_queue_lock(
                cfg, init_batch(cfg, seeds, device=self.device), r0.iters,
                r0.variant, sync_every=r0.sync_every,
                block_n=self.block_n)[0]
        return solve_many(cfg, seeds, iters=r0.iters, variant=r0.variant,
                          sync_every=r0.sync_every, device=self.device)

    def _dispatch_hetero(self, cfg: PSOConfig, seeds: np.ndarray,
                         probs: List[Union[str, Problem]], r0: SolveRequest):
        """Mixed-problem dispatch: per-row objective and bound
        descriptors, one batch for the whole mix."""
        if self._kernel(r0):
            from ..kernels.ops import run_queue_lock
            rows, table = problem_rows(probs, cfg.dim, cfg.dtype,
                                       device=self.device)
            rcfg = cfg.resolved()
            batch = init_batch(rcfg, seeds, rows=rows, table=table,
                               device=self.device)
            return run_queue_lock(
                rcfg, batch, r0.iters, r0.variant, sync_every=r0.sync_every,
                block_n=self.block_n, fids=rows.fid, table=table)[0]
        return solve_many(cfg, seeds, iters=r0.iters, variant=r0.variant,
                          sync_every=r0.sync_every, problems=probs,
                          device=self.device)

    def flush(self) -> Dict[int, SolveResult]:
        """Dispatch all pending requests; returns {ticket: result}.
        Failures are isolated per group (the dispatch unit)."""
        groups: Dict[Tuple, List[Tuple[int, SolveRequest, float]]] = \
            defaultdict(list)
        results: Dict[int, SolveResult] = {}
        for t, r, ts in self._pending:
            err = request_error(r)
            if err is not None:
                self.stats.failed += 1
                if self.metrics is not None:
                    self.metrics.inc("failed")
                results[t] = SolveResult(
                    request=r, gbest_fit=float("nan"),
                    gbest_pos=np.full((r.dim,), np.nan),
                    batch_size=0, error=err)
                continue
            r = self._tuned_request(r)   # the tuned sync_every keys the group
            groups[r.group_key(self.coalesce_registry)].append((t, r, ts))
        self._pending.clear()
        for _, members in sorted(groups.items(), key=lambda kv: repr(kv[0])):
            tickets = [t for t, _, _ in members]
            t0 = time.perf_counter()
            try:
                solved = self._solve_group([r for _, r, _ in members])
            except Exception as e:
                self.stats.failed += len(members)
                if self.metrics is not None:
                    self.metrics.inc("failed", len(members))
                results.update(
                    (t, SolveResult(request=r, gbest_fit=float("nan"),
                                    gbest_pos=np.full((r.dim,), np.nan),
                                    batch_size=0, error=e))
                    for t, r, _ in members)
                continue
            results.update(zip(tickets, solved))
            self.stats.requests += len(members)
            if self.metrics is not None:
                now = time.perf_counter()
                self.metrics.inc("completed", len(members))
                self.metrics.observe("dispatch_us", (now - t0) * 1e6)
                for _, _, ts in members:
                    self.metrics.observe("e2e_us", (now - ts) * 1e6)
        return results

    def solve_all(self, requests: Sequence[SolveRequest]) -> List[SolveResult]:
        """Convenience: submit + flush, results in request order."""
        tickets = [self.submit(r) for r in requests]
        resolved = self.flush()
        return [resolved[t] for t in tickets]

    def snapshot(self) -> dict:
        """ServeStats (and the attached metrics sink, if any) as a
        JSON-able dict."""
        doc = {"stats": self.stats.as_dict()}
        if self.metrics is not None:
            doc["metrics"] = self.metrics.snapshot()
        return doc

    def prometheus(self, *, prefix: str = "repro") -> str:
        """This server's state as a Prometheus text exposition: the metrics
        sink's spans and counters, else the ServeStats counters."""
        if self.metrics is not None:
            return self.metrics.prometheus(prefix=prefix)
        from ..telemetry import prometheus_text
        counters = {k: v for k, v in self.stats.as_dict().items()
                    if k != "batch_fill"}
        return prometheus_text(
            {"counters": counters, "batch_fill": self.stats.batch_fill,
             "spans": {}}, prefix=prefix)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--backend", default="auto", choices=list(BACKENDS))
    ap.add_argument("--variant", default="auto",
                    choices=["auto", "reduction", "queue", "queue_lock",
                             "async"])
    ap.add_argument("--sync-every", type=int, default=ASYNC_SYNC_EVERY,
                    help="async variant publication interval")
    ap.add_argument("--no-coalesce", action="store_true",
                    help="per-problem content-hash grouping")
    ap.add_argument("--autotune", action="store_true",
                    help="roofline-tuned sync_every and bucket ladder")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a Prometheus text exposition of the "
                         "serving metrics here after the flush")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    # four built-ins over two solve shapes: with registry coalescing each
    # shape is ONE heterogeneous dispatch
    if args.variant == "auto":
        variant = "queue" if args.backend == "eager" else "queue_lock"
    else:
        variant = args.variant
    mix = [("cubic", 1, 256), ("sphere", 1, 256),
           ("rastrigin", 10, 128), ("ackley", 10, 128)]
    reqs = [SolveRequest(dim=d, particle_cnt=n, fitness=f, seed=i,
                         iters=args.iters, variant=variant,
                         sync_every=args.sync_every)
            for i, (f, d, n) in ((i, mix[i % len(mix)])
                                 for i in range(args.requests))]
    metrics = None
    if args.metrics_out:
        from ..serving import ServingMetrics
        metrics = ServingMetrics()
    srv = SolveServer(max_batch=args.max_batch, backend=args.backend,
                      coalesce_registry=not args.no_coalesce,
                      autotune=args.autotune, metrics=metrics,
                      device=args.device)
    t0 = time.time()
    results = srv.solve_all(reqs)
    dt = time.time() - t0
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(srv.prometheus())
        print(f"metrics -> {args.metrics_out}")
    for r in results[:4]:
        print(f"req({r.request.fitness}, dim={r.request.dim}, "
              f"seed={r.request.seed}) gbest_fit={r.gbest_fit:.6g} "
              f"(batch={r.batch_size})")
    s = srv.stats
    print(f"{s.requests} requests in {s.dispatches} dispatches "
          f"({s.hetero_dispatches} heterogeneous, {s.padded_rows} padded "
          f"rows, fill={s.batch_fill:.1f}) on {srv.device}, "
          f"wall={dt:.3f}s ({s.requests / dt:.1f} solves/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
