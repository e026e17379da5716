"""Continuous-batching scheduler, the port of
``repro.serving.scheduler``: admit requests into in-flight batched async
solves at chunk boundaries.

The flush server (``repro_torch.launch.serve``) batches one queue
generation at a time, keyed on the full shape including ``iters``. A
serving tier sees a stream instead: staggered arrivals, mixed budgets. This
scheduler keeps a few persistent **lanes**. A lane holds ``width``
independent rows and advances ``sync_every`` iterations a dispatch (one
chunk) through ONE program, built once per lane key and reused for the
lane's lifetime (``lane_program``):

* kernel backend, registry built-ins: ``kernels.ops.AsyncLane``. The rows
  live in the kernels' D-major layout for the lane's lifetime, a fresh row
  is written into its columns at admission, gbest is read from them at
  harvest, and a chunk is one launch of the batched async kernel (the
  heterogeneous one for a coalesced lane), replayed on the card from a
  CUDA graph captured when the program was built;
* eager backend: the eager engine's ``run_many(..., "async")`` a chunk at a
  time, on a ``SwarmBatch`` (``BatchLane``);
* a custom Problem on the kernel backend: the split path
  (``kernels.pso_split``, around the user's torch step) through
  ``ops.run_queue_lock`` on a ``SwarmBatch``, a chunk at a time.

Admission invariants (the correctness argument, the reference's):

1. Rows are admitted and removed only between dispatches, at chunk
   boundaries. A fresh row is ``core.pso.init_swarm_async`` (init plus
   locals seeded from gbest, what ``run_async`` does on its first call);
   the program never restarts.
2. Every row of a lane stands at phase 0: rows start at iteration 0 and
   advance in whole chunks, so one chunk is every row's own schedule.
3. Budgets are per row. A request for ``T`` iterations rides
   ``T // sync_every`` chunks; a remainder ejects the row at the last
   boundary and finishes standalone from its state and its locals (the
   single-swarm kernel on the kernel backend, ``run_async`` on the eager
   one). Requests shorter than a chunk, and the synchronous variants,
   never enter a lane: they run standalone through ``repro_torch.solve``.

So every result equals its request's standalone solve: on the eager
backend ``core.pso.solve(cfg, seed, T, "async", sync_every)`` bit for bit;
on the kernel backend ``repro_torch.solve(..., backend="kernel",
record_history=True)``, which launches a chunk at a time, bit for bit for
the CPU's plain versions and for one-block lanes on the card (several
blocks race on the card by design and are held to the async invariants).
Lane keys drop ``iters``, so mixed budgets share a lane.

A ``CompileCache`` makes lane programs outlive the process: its manifest
rebuilds them at ``prewarm()``, so a restarted replica's first request
makes no build on the request path.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import _device, api
from ..core.blocking import default_block_count, pick_block_n
from ..core.fitness import BUILTIN_PROBLEMS
from ..core.multi_swarm import (MIN_VALIDATED_SWARMS, NO_HETERO_DTYPES,
                                ProblemRows, batch_row, hetero_fid,
                                problem_rows, run_many, stack_states)
from ..core.problem import resolve_problem
from ..core.pso import (HeteroRow, PSOConfig, hetero_member_config,
                        init_swarm_async, run_async)
from ..api import History
from ..launch.serve import (_HETERO, _HETERO_CANONICAL_FITNESS, BACKENDS,
                            SolveRequest, SolveResult, request_error,
                            resolve_backend)
from ..telemetry.trace import now_us, wall_us
from .compile_cache import CompileCache
from .metrics import ServingMetrics

def _now_us() -> float:
    """The monotonic clock the metrics' durations are taken on; a trace
    event's stamp is placed on the trace's clock (``wall_us``)."""
    return time.perf_counter() * 1e6


def _lane_config(dim: int, particle_cnt: int, fitness, dtype: str,
                 rule: str, topology: str) -> PSOConfig:
    return PSOConfig(dim=dim, particle_cnt=particle_cnt, fitness=fitness,
                     dtype=dtype, update_rule=rule,
                     topology=topology).resolved()


def lane_blocks(backend: str, n: int) -> int:
    """A lane's block count: the kernels' (``pick_block_n``) on the kernel
    backend, the eager engine's (``default_block_count``) on the other."""
    return n // pick_block_n(n) if backend == "kernel" \
        else default_block_count(n)


class BatchLane:
    """A lane program on a ``SwarmBatch``: the eager engine's
    ``run_many`` a chunk at a time, or (``split=True``) the kernel
    backend's split path through ``ops.run_queue_lock``. Built once a lane
    key and memoized like any program; nothing is captured. Same interface
    as ``kernels.ops.AsyncLane``."""

    def __init__(self, cfg: PSOConfig, width: int, sync_every: int,
                 n_blocks: int, *, table=None, split: bool = False):
        self.cfg, self.width, self.sync_every = cfg, width, sync_every
        self.nb, self.table, self.split = n_blocks, table, split
        self.batch = None
        self.rows: Optional[ProblemRows] = None

    def admit(self, slot: int, state, one: Optional[ProblemRows] = None
              ) -> None:
        if self.batch is None:
            # the first row fills every slot: rows never admitted hold a
            # well-defined swarm (never read back)
            self.batch = stack_states([state] * self.width)
            if one is not None:
                self.rows = ProblemRows(*(
                    a[:1].expand(self.width, *a.shape[1:]).clone()
                    for a in one))
            return
        for a, v in zip(self.batch, state):
            if a is not None:
                a[slot] = v
        if one is not None:
            for a, v in zip(self.rows, one):
                a[slot] = v[0]

    def dispatch(self) -> None:
        se = self.sync_every
        if self.split:
            from ..kernels import ops
            self.batch = ops.run_queue_lock(self.cfg, self.batch, se,
                                            "async", sync_every=se)[0]
        else:
            self.batch = run_many(self.cfg, self.batch, se, "async",
                                  sync_every=se, rows=self.rows,
                                  table=self.table, n_blocks=self.nb)

    def gbest(self):
        # copies: admissions write the batch in place
        return (_device.host(self.batch.gbest_fit),
                _device.host(self.batch.gbest_pos))

    def row(self, slot: int):
        return batch_row(self.batch, slot)


def lane_program(spec: dict):
    """Build the program a JSON lane spec describes (``_Lane.spec``; the
    compile cache's manifest keeps these): an ``ops.AsyncLane`` on the
    kernel backend, a ``BatchLane`` on the eager one. ``fitness`` None
    means the heterogeneous lane over the six built-ins."""
    hetero = spec["fitness"] is None
    cfg = _lane_config(spec["dim"], spec["particle_cnt"],
                       _HETERO_CANONICAL_FITNESS if hetero
                       else spec["fitness"], spec["dtype"], spec["rule"],
                       spec["topology"])
    table = BUILTIN_PROBLEMS if hetero else None
    if spec["backend"] == "kernel":
        from ..kernels.ops import AsyncLane
        return AsyncLane(cfg, spec["width"], spec["sync_every"], table=table,
                         device=_device.resolve(spec["device"]))
    return BatchLane(cfg, spec["width"], spec["sync_every"],
                     lane_blocks("eager", spec["particle_cnt"]), table=table)


@dataclasses.dataclass
class _Active:
    """One admitted request occupying a lane slot."""
    ticket: int
    request: SolveRequest
    done: int = 0            # iterations applied so far
    submitted_us: float = 0.0
    admitted_us: float = 0.0
    history: Optional[list] = None   # [(iteration, gbest_fit), ...] samples


class _Lane:
    """One persistent lane: ``width`` slots over one program."""

    def __init__(self, key: Tuple, cfg: PSOConfig, width: int,
                 sync_every: int, hetero: bool, backend: str, device):
        self.key = key
        self.uid = 0                           # display id (trace rows)
        self.cfg = cfg
        self.width = width
        self.sync_every = sync_every
        self.hetero = hetero
        self.backend = backend
        self.device = device
        self.nb = lane_blocks(backend, cfg.particle_cnt)
        self.slots: List[Optional[_Active]] = [None] * width
        self.chunks_dispatched = 0
        self.program = None

    @property
    def active_count(self) -> int:
        return sum(1 for a in self.slots if a is not None)

    def free_slot(self) -> Optional[int]:
        for i, a in enumerate(self.slots):
            if a is None:
                return i
        return None

    def program_key(self) -> str:
        c = self.cfg
        # stable across processes: content lanes key on a digest of the
        # problem's content hash
        content = (_HETERO if self.hetero
                   else "content:" + hashlib.sha1(
                       repr(self.key).encode()).hexdigest()[:16])
        return (f"lane|{self.backend}|{self.device}|d{c.dim}"
                f"|n{c.particle_cnt}|{c.dtype}|se{self.sync_every}"
                f"|nb{self.nb}|w{self.width}|r{c.update_rule}"
                f"|t{c.topology}|{content}")

    def spec(self) -> Optional[dict]:
        """What rebuilds this lane's program in another process
        (``lane_program``), or None: a custom Problem's lane has no spec."""
        prob = None if self.hetero else self.cfg.problem
        if prob is not None and hetero_fid(prob) is None:
            return None
        c = self.cfg
        return {"backend": self.backend, "device": str(self.device),
                "dim": c.dim, "particle_cnt": c.particle_cnt,
                "dtype": c.dtype, "sync_every": self.sync_every,
                "width": self.width, "rule": c.update_rule,
                "topology": c.topology,
                "fitness": None if prob is None else prob.name}

    def build_content(self):
        """The program of a custom Problem's lane (no spec)."""
        return BatchLane(self.cfg, self.width, self.sync_every, self.nb,
                         split=self.backend == "kernel")


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class ContinuousScheduler:
    """Streaming solve front end over persistent batched async lanes.

    ``lane_width`` rows a lane (floored at ``MIN_VALIDATED_SWARMS``, as in
    the reference); ``coalesce_registry`` merges registry built-ins at one
    solve shape into heterogeneous lanes; ``compile_cache`` (a
    ``CompileCache``) makes lane programs restart-persistent. ``backend``
    (``auto`` | ``eager`` | ``kernel``) and ``device`` (None: the card)
    resolve as in ``SolveServer``. ``autotune=True`` rewrites async
    requests' ``sync_every`` to the model-tuned value (a lane key of its
    own, so its own program) and caps lane width at the autotuner's bucket
    ladder's last rung, the point where the cost model prices per-row gains
    as flattened.

    Telemetry (``repro_torch.telemetry``): ``trace`` (a ``TraceWriter``)
    records the timeline, one row per lane with a span per chunk,
    admit/eject instants, a span per request and a lane-fill counter.
    ``record_history=True`` samples every lane row's gbest at its chunk
    boundaries onto ``SolveResult.history`` (standalone solves report
    None).

    Single-threaded and synchronous: ``submit`` + ``step``/``drain`` (or
    one-shot ``run``).
    """

    def __init__(self, lane_width: int = 8,
                 coalesce_registry: bool = True,
                 compile_cache: Optional[CompileCache] = None,
                 autotune: bool = False,
                 metrics: Optional[ServingMetrics] = None,
                 trace=None, record_history: bool = False,
                 backend: str = "auto", device=None):
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r}; one of {BACKENDS}")
        self.device = _device.resolve(device)
        self.backend = backend
        self.lane_width = max(MIN_VALIDATED_SWARMS, lane_width)
        self.coalesce_registry = coalesce_registry
        self.autotune = autotune
        self.metrics = metrics or ServingMetrics()
        self.trace = trace
        self.record_history = record_history
        self.compile_cache = compile_cache
        if compile_cache is not None and compile_cache.metrics is None:
            compile_cache.metrics = self.metrics
        self._lanes: "OrderedDict[Tuple, _Lane]" = OrderedDict()
        self._pending: List[_Active] = []
        self._results: Dict[int, SolveResult] = {}
        self._ticket = 0
        self._ladder_width: Dict[Tuple, int] = {}

    # -- submission --------------------------------------------------------
    def submit(self, req: SolveRequest) -> int:
        t = self._ticket
        self._ticket += 1
        self.metrics.inc("submitted")
        self._pending.append(_Active(ticket=t, request=req,
                                     submitted_us=_now_us()))
        return t

    def _tuned(self, r: SolveRequest) -> SolveRequest:
        if not self.autotune or r.variant != "async":
            return r
        from ..core.autotune import tuned_sync_every
        k = tuned_sync_every(r.fitness, r.dim, r.particle_cnt, r.iters,
                             r.dtype, device=self.device)
        return dataclasses.replace(r, sync_every=k)

    def _backend(self, r: SolveRequest) -> str:
        return resolve_backend(self.backend, r.variant, r.rule, self.device)

    # -- lane keying -------------------------------------------------------
    def _lane_key(self, r: SolveRequest) -> Tuple:
        """Like ``SolveRequest.group_key`` but WITHOUT ``iters``: per-row
        accounting lets mixed budgets share a lane. Registered built-ins
        coalesce into a heterogeneous lane in float32 and float64 only (a
        heterogeneous batch has no bfloat16 form, ``problem_rows``); a
        bfloat16 request takes a lane of its own problem."""
        hetero = (self.coalesce_registry and r.dtype not in NO_HETERO_DTYPES
                  and hetero_fid(r.fitness) is not None)
        content = _HETERO if hetero else resolve_problem(
            r.fitness).cache_key()
        return (r.dim, r.particle_cnt, r.dtype, r.sync_every,
                r.rule, r._topology_key(), content)

    def _lane_for(self, r: SolveRequest) -> _Lane:
        key = self._lane_key(r)
        lane = self._lanes.get(key)
        if lane is not None:
            return lane
        hetero = key[-1] == _HETERO
        cfg = _lane_config(r.dim, r.particle_cnt,
                           _HETERO_CANONICAL_FITNESS if hetero
                           else r.fitness, r.dtype, r.rule,
                           r._topology_key())
        lane = _Lane(key, cfg, self._width_for(r), r.sync_every, hetero,
                     self._backend(r), self.device)
        lane.uid = len(self._lanes)
        self._lanes[key] = lane
        return lane

    def _width_for(self, r: SolveRequest) -> int:
        if not self.autotune:
            return self.lane_width
        key = (r.dim, r.particle_cnt, r.variant, r.dtype)
        if key not in self._ladder_width:
            from ..core.autotune import bucket_ladder
            ladder = bucket_ladder(
                r.fitness, r.dim, r.particle_cnt, r.iters,
                max_batch=self.lane_width, variant=r.variant,
                dtype=r.dtype, min_bucket=MIN_VALIDATED_SWARMS,
                device=self.device)
            self._ladder_width[key] = max(MIN_VALIDATED_SWARMS, ladder[-1])
        return self._ladder_width[key]

    # -- admission ---------------------------------------------------------
    def _admit(self) -> None:
        still: List[_Active] = []
        for a in self._pending:
            err = request_error(a.request)
            if err is not None:
                # the flush server's rejection: the bad request gets its own
                # error result and never reaches a lane or a solve
                self.metrics.inc("failed")
                self._results[a.ticket] = SolveResult(
                    request=a.request, gbest_fit=float("nan"),
                    gbest_pos=np.full((a.request.dim,), np.nan),
                    batch_size=0, error=err)
                continue
            r = self._tuned(a.request)
            if r.variant != "async" or r.iters < max(1, r.sync_every):
                self._solve_standalone(a, r)
                continue
            lane = self._lane_for(r)
            slot = lane.free_slot()
            if slot is None:
                still.append(a)     # lane full: wait for a chunk boundary
                continue
            self._splice(lane, slot, a, r)
        self._pending = still

    def _one_row(self, lane: _Lane, r: SolveRequest):
        """A heterogeneous row's descriptors: (ProblemRows of one row, the
        engine's ``hetero=(table, HeteroRow)``)."""
        one, table = problem_rows([r.fitness], lane.cfg.dim, lane.cfg.dtype,
                                  device=self.device)
        return one, (table, HeteroRow(fid=one.fid[0], lo=one.lo[0],
                                      hi=one.hi[0], mv=one.mv[0]))

    def _splice(self, lane: _Lane, slot: int, a: _Active,
                r: SolveRequest) -> None:
        program = self._lane_program(lane)
        one, hetero = (None, None) if not lane.hetero \
            else self._one_row(lane, r)
        program.admit(slot, init_swarm_async(
            lane.cfg, r.seed, n_blocks=lane.nb, hetero=hetero,
            device=self.device), one)
        a.admitted_us = _now_us()
        self.metrics.observe("queue_us", a.admitted_us - a.submitted_us)
        self.metrics.inc("admitted")
        if lane.chunks_dispatched:
            self.metrics.inc("row_swaps")
        if self.record_history:
            a.history = []
        if self.trace is not None:
            self.trace.instant(
                f"admit t{a.ticket}", wall_us(a.admitted_us),
                process="serving", thread=f"lane {lane.uid}",
                cat="admission",
                args={"slot": slot, "fitness": str(r.fitness),
                      "iters": r.iters})
        lane.slots[slot] = a

    # -- standalone solves -------------------------------------------------
    def _solve_standalone(self, a: _Active, r: SolveRequest) -> None:
        a.admitted_us = _now_us()
        self.metrics.observe("queue_us", a.admitted_us - a.submitted_us)
        t0 = _now_us()
        res = api.solve(r.fitness, dim=r.dim, particles=r.particle_cnt,
                    iters=r.iters, seed=r.seed, variant=r.variant,
                    backend=self._backend(r), sync_every=r.sync_every,
                    dtype=r.dtype, rule=r.rule, topology=r._topology_key(),
                    device=self.device)
        if self.trace is not None:
            self.trace.complete(
                f"standalone t{a.ticket}", wall_us(t0), _now_us() - t0,
                process="serving", thread="standalone", cat="solve",
                args={"fitness": str(r.fitness), "variant": r.variant,
                      "iters": r.iters})
        self.metrics.inc("standalone_solves")
        self._finish(a, res.gbest_fit, _device.host(res.state.gbest_pos),
                     batch_size=1)

    def _eject(self, lane: _Lane, slot: int, rem: int) -> None:
        """Finish a row's sub-chunk remainder standalone at a boundary,
        from its state and its locals."""
        a = lane.slots[slot]
        r = a.request
        state = lane.program.row(slot)
        if lane.backend == "kernel":
            from ..kernels import ops
            cfg = (hetero_member_config(lane.cfg, resolve_problem(r.fitness))
                   if lane.hetero else lane.cfg)
            st = ops.run_queue_lock(cfg, state, rem, "async",
                                    sync_every=lane.sync_every)[0]
        else:
            hetero = self._one_row(lane, r)[1] if lane.hetero else None
            st = run_async(lane.cfg, state, rem, sync_every=lane.sync_every,
                           n_blocks=lane.nb, hetero=hetero)
        lane.slots[slot] = None
        self.metrics.inc("tail_ejections")
        gf = float(st.gbest_fit)
        if a.history is not None:
            a.history.append((r.iters, gf))
        if self.trace is not None:
            self.trace.instant(
                f"eject t{a.ticket}", now_us(), process="serving",
                thread=f"lane {lane.uid}", cat="admission",
                args={"slot": slot, "remainder": rem})
        self._finish(a, gf, _device.host(st.gbest_pos),
                     batch_size=lane.width)

    def _finish(self, a: _Active, gf: float, gp: np.ndarray,
                batch_size: int) -> None:
        now = _now_us()
        self.metrics.observe("solve_us", now - a.admitted_us)
        self.metrics.observe("e2e_us", now - a.submitted_us)
        self.metrics.inc("completed")
        hist = None
        if a.history:
            its, fits = zip(*a.history)
            hist = History(iteration=np.asarray(its, dtype=np.int64),
                           gbest_fit=np.asarray(fits), violation=None)
        if self.trace is not None:
            self.trace.complete(
                f"request t{a.ticket}", wall_us(a.submitted_us),
                now - a.submitted_us, process="requests",
                thread=f"ticket {a.ticket}", cat="request",
                args={"fitness": str(a.request.fitness),
                      "iters": a.request.iters,
                      "batch_size": batch_size, "gbest_fit": gf})
        self._results[a.ticket] = SolveResult(
            request=a.request, gbest_fit=gf, gbest_pos=gp,
            batch_size=batch_size, history=hist)

    # -- dispatch ----------------------------------------------------------
    def _lane_program(self, lane: _Lane):
        """The lane's program, built (or taken from the compile cache) at
        its first admission; with a cache, claimed for the lane while it
        holds rows (``CompileCache.claim``: another scheduler's lane on the
        same cache and key raises instead of writing into its rows)."""
        cache = self.compile_cache
        if lane.program is None:
            spec = lane.spec()
            if spec is None:
                build = lane.build_content
            else:
                def build():
                    return lane_program(spec)
            if cache is None:
                lane.program = build()
            else:
                t0 = _now_us()
                lane.program = cache.get(lane.program_key(), build, spec)
                self.metrics.observe("compile_us", _now_us() - t0)
        if cache is not None:
            cache.claim(lane.program_key(), lane)
        return lane.program

    def _release(self, lane: _Lane) -> None:
        """An emptied lane gives its cached program back."""
        if self.compile_cache is not None and lane.program is not None:
            self.compile_cache.release(lane.program_key(), lane)

    def _dispatch(self, lane: _Lane) -> None:
        t0 = _now_us()
        lane.program.dispatch()
        _wait(self.device)
        dur = _now_us() - t0
        self.metrics.observe("dispatch_us", dur)
        lane.chunks_dispatched += 1
        self.metrics.inc("dispatches")
        self.metrics.inc("lane_slots", lane.width)
        self.metrics.inc("lane_active_slots", lane.active_count)
        if self.trace is not None:
            ts = wall_us(t0)
            self.trace.complete(
                f"chunk {lane.chunks_dispatched}", ts, dur,
                process="serving", thread=f"lane {lane.uid}",
                cat="dispatch",
                args={"active": lane.active_count, "width": lane.width,
                      "sync_every": lane.sync_every})
            self.trace.counter(f"lane {lane.uid} fill", ts,
                               {"active": lane.active_count,
                                "idle": lane.width - lane.active_count})
        fits = lane.program.gbest()[0] if self.record_history else None
        for i, a in enumerate(lane.slots):
            if a is not None:
                a.done += lane.sync_every
                if a.history is not None:
                    a.history.append((a.done, float(fits[i])))

    # -- the loop ----------------------------------------------------------
    def step(self) -> Dict[int, SolveResult]:
        """One scheduling round: admit at the boundary, advance every
        active lane one chunk, harvest completions. Returns the results
        that completed this round (also kept for ``drain``/``run``)."""
        before = set(self._results)
        self._admit()
        for lane in list(self._lanes.values()):
            # boundary bookkeeping first: rows whose remainder is shorter
            # than a chunk leave now
            for i, a in enumerate(lane.slots):
                if a is None:
                    continue
                rem = a.request.iters - a.done
                if 0 < rem < lane.sync_every:
                    self._eject(lane, i, rem)
            if lane.active_count:
                self._dispatch(lane)
                done = [i for i, a in enumerate(lane.slots)
                        if a is not None and a.done >= a.request.iters]
                if done:
                    gf, gp = lane.program.gbest()   # one read for the lane
                    for i in done:
                        a = lane.slots[i]
                        lane.slots[i] = None
                        self._finish(a, float(gf[i]), gp[i],
                                     batch_size=lane.width)
            if lane.active_count == 0:
                self._release(lane)
        return {t: r for t, r in self._results.items() if t not in before}

    @property
    def busy(self) -> bool:
        return bool(self._pending) or any(
            lane.active_count for lane in self._lanes.values())

    def drain(self) -> Dict[int, SolveResult]:
        """Step until every submitted request has a result."""
        while self.busy:
            self.step()
        return dict(self._results)

    def run(self, requests) -> List[SolveResult]:
        """One-shot: submit all + drain, results in order."""
        tickets = [self.submit(r) for r in requests]
        resolved = self.drain()
        return [resolved[t] for t in tickets]

    def snapshot(self) -> dict:
        """Serving state: metrics, lane occupancy, compile-cache stats."""
        doc = self.metrics.snapshot()
        doc["lanes"] = [
            {"key": repr(lane.key), "width": lane.width,
             "active": lane.active_count,
             "chunks": lane.chunks_dispatched}
            for lane in self._lanes.values()]
        if self.compile_cache is not None:
            doc["compile_cache"] = self.compile_cache.snapshot()
        return doc
