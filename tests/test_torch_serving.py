"""repro_torch's serving (``launch.serve``, ``serving.scheduler``,
``serving.compile_cache``, ``serving.metrics``, ``api.solve_stream``) on the
CPU, case for case after the reference's serving tests
(tests/test_serving.py, the serve tests of tests/test_hetero.py,
tests/test_async.py and tests/test_multi_swarm.py, and two of
tests/test_telemetry.py), each on the eager backend and on the kernel
backend's plain versions, plus the lane graph on a card (``gpu``-marked).

The contract:

* eager backend: every scheduler result is bit for bit the port's
  standalone eager ``core.pso.solve(cfg, seed, T, variant, sync_every)``
  (the reference's own contract);
* kernel backend (the CPU runs the kernels' plain versions): every result
  is bit for bit ``repro_torch.solve(..., backend="kernel",
  record_history=True)``, which launches a chunk at a time, as a lane does
  (queue and other synchronous variants run standalone on the eager
  engine, and are held to ``core.pso.solve``);
* against JAX, on the reference's 11-request trace: the scheduler's and the
  flush server's bookkeeping exactly, and the numbers within the
  tolerances tests/test_torch_multi_swarm.py holds ``run_many`` to
  (fitness rtol = atol = 1e-5; positions rtol=2e-6, atol=max(1e-5, 1e-6 x
  the box width): XLA and PyTorch round the velocity chain and cos/exp
  differently).

Sizes are small: d <= 10, n <= 256, budgets <= 24.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.api import solve as facade_solve
from repro_torch.core import multi_swarm as ms
from repro_torch.core import pso
from repro_torch.core.fitness import BUILTIN_PROBLEMS
from repro_torch.core.problem import Problem
from repro_torch.kernels import ops, pso_step
from repro_torch.launch import serve
from repro_torch.launch.serve import SolveRequest, SolveServer
from repro_torch.serving import (CompileCache, ContinuousScheduler,
                                 LatencyStat, ServingMetrics)
from repro_torch.telemetry import prometheus_text

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = ("cubic", "sphere", "rastrigin", "ackley", "griewank", "rosenbrock")
DIM, N, SE = 10, 128, 8
CPU = "cpu"
BACKENDS = ("eager", "kernel")
FIT_TOL = dict(rtol=1e-5, atol=1e-5)


def _req(k, iters, fitness=None, variant="async", **kw):
    return SolveRequest(dim=DIM, particle_cnt=N,
                        fitness=fitness or NAMES[k % len(NAMES)],
                        seed=k, iters=iters, variant=variant, sync_every=SE,
                        **kw)


def _trace():
    """The reference's 11-request trace (tests/test_serving.py): budgets of
    whole chunks, one with a remainder (a tail ejection), one under a chunk
    (a standalone solve), more requests than slots (row swaps)."""
    reqs = [_req(k, iters) for k, iters in
            enumerate((16, 8, 24, 16, 8, 16, 24, 8, 16))]
    return reqs + [_req(9, 20), _req(10, 4)]


def _standalone(r, backend):
    """(gbest_fit, gbest_pos) of the request's standalone solve under the
    contract of the module docstring."""
    if backend == "kernel" and r.variant in ("queue_lock", "async"):
        res = facade_solve(r.fitness, dim=r.dim, particles=r.particle_cnt,
                           iters=r.iters, seed=r.seed, variant=r.variant,
                           sync_every=r.sync_every, backend="kernel",
                           record_history=True, rule=r.rule,
                           topology=r._topology_key(), device=CPU)
        return res.gbest_fit, res.best_pos
    st = pso.solve(r.config(), r.seed, r.iters, r.variant, r.sync_every,
                   device=CPU)
    return float(st.gbest_fit), st.gbest_pos.numpy()


def _assert_bit_exact(results, reqs, backend):
    for res, r in zip(results, reqs):
        gf, gp = _standalone(r, backend)
        assert res.ok, res.error
        assert res.gbest_fit == gf, (r.fitness, r.iters)
        np.testing.assert_array_equal(res.gbest_pos, gp)


def _sched(backend, **kw):
    return ContinuousScheduler(backend=backend, device=CPU, **kw)


def _server(backend, **kw):
    return SolveServer(backend=backend, device=CPU, **kw)


# -- the scheduler: chunk-boundary admission, bit for bit ---------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_scheduler_bit_exact_vs_standalone_mixed_trace(backend):
    reqs = _trace()
    sched = _sched(backend, lane_width=8)
    results = sched.run(reqs)
    _assert_bit_exact(results, reqs, backend)
    m = sched.metrics
    assert m.get("completed") == len(reqs)
    assert m.get("row_swaps") >= 1
    assert m.get("tail_ejections") == 1
    assert m.get("standalone_solves") == 1
    assert 0.0 < m.batch_fill <= 1.0
    snap = sched.snapshot()
    assert snap["lanes"] and snap["lanes"][0]["active"] == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_scheduler_sync_variant_runs_standalone(backend):
    reqs = [_req(0, 12, variant="queue"), _req(1, 16)]
    sched = _sched(backend)
    _assert_bit_exact(sched.run(reqs), reqs, backend)
    assert sched.metrics.get("standalone_solves") == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_scheduler_homogeneous_lane_for_custom_problem(backend):
    """A custom Problem gets its own content-keyed lane (the split path on
    the kernel backend), same contract."""
    prob = Problem(name="serving_quad",
                   fn=lambda x: -((x - 1.0) ** 2).sum(-1), lo=-5.0, hi=5.0)
    reqs = [_req(k, 16, fitness=prob) for k in range(3)] + [
        _req(3, 20, fitness=prob)]
    sched = _sched(backend, lane_width=8)
    _assert_bit_exact(sched.run(reqs), reqs, backend)
    assert len(sched.snapshot()["lanes"]) == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_scheduler_lanes_keyed_by_rule_and_topology(backend):
    """Lanes keyed by rule and topology (an lbest topology pulls the
    neighbours' locals at each chunk entry): every row still its
    standalone solve."""
    reqs = [SolveRequest(dim=4, particle_cnt=256, fitness=NAMES[k], seed=k,
                         iters=t, variant="async", sync_every=4, rule=rule,
                         topology=topo)
            for k, (t, rule, topo) in enumerate(
                ((8, "pso", "ring"), (12, "pso", "ring"),
                 (8, "sso", "gbest"), (10, "lowcost", "vonneumann")))]
    sched = _sched(backend)
    _assert_bit_exact(sched.run(reqs), reqs, backend)
    assert len(sched.snapshot()["lanes"]) == 3


def test_scheduler_lane_program_is_the_kernel_layout():
    """The kernel backend's lane is an ``ops.AsyncLane`` in the kernels'
    D-major layout: admission writes the row's columns, the counters carry
    each row's seed and iteration, gbest is read from ``gp``/``gf``."""
    sched = _sched("kernel", lane_width=8)
    sched.submit(_req(3, 16))
    sched.step()
    lane = next(iter(sched._lanes.values()))
    prog = lane.program
    assert isinstance(prog, ops.AsyncLane) and prog.hetero
    assert prog.state[0].shape == (DIM, 8 * N)
    assert prog.state[6].shape == (DIM, 8 * prog.nb)
    assert prog.counters[:, 0].tolist() == [3, SE]
    assert prog.fids.tolist() == [ms.hetero_fid("ackley")] * 8
    gf, gp = prog.gbest()
    row = prog.row(0)
    assert row.iteration == SE and row.seed == 3
    assert gf[0] == float(row.gbest_fit)
    np.testing.assert_array_equal(gp[0], row.gbest_pos.numpy())


@pytest.mark.parametrize("topology", ["gbest", "ring"])
@pytest.mark.parametrize("hetero", [False, True])
def test_async_lane_rows_are_single_swarm_chunks(topology, hetero):
    """The lane program at any block count (n=256 in 4 blocks here): each
    row, admitted at a chunk boundary while others run, equals the
    single-swarm async kernel's plain version run a chunk a call from its
    own fresh state, bit for bit."""
    cfg = pso.PSOConfig(dim=3, particle_cnt=256, topology=topology,
                        fitness="cubic" if hetero else "ackley").resolved()
    table = BUILTIN_PROBLEMS if hetero else None
    lane = ops.AsyncLane(cfg, 4, 4, table=table, block_n=64, device=CPU)
    assert lane.nb == 4 and lane.graph is None
    rows = {}

    def admit(slot, seed):
        name = NAMES[seed % 6] if hetero else "ackley"
        one = hr = None
        if hetero:
            one, tb = ms.problem_rows([name], 3, device=CPU)
            hr = (tb, pso.HeteroRow(one.fid[0], one.lo[0], one.hi[0],
                                    one.mv[0]))
        lane.admit(slot, pso.init_swarm_async(cfg, seed, n_blocks=4,
                                              hetero=hr, device=CPU), one)
        mcfg = pso.hetero_member_config(cfg, repro_torch.get_problem(name))
        rows[slot] = (mcfg, pso.init_swarm(mcfg, seed, device=CPU))

    for slot, seed in enumerate((0, 1, 2, 3)):
        admit(slot, seed)
    for k in range(3):
        lane.dispatch()
        if k == 0:
            admit(2, 7)                       # a row swap after a chunk
        else:
            mcfg, st = rows[2]
            rows[2] = (mcfg, ops.run_queue_lock_fused_async(
                mcfg, st, 4, sync_every=4, block_n=64))
        for slot in (0, 1, 3):
            mcfg, st = rows[slot]
            rows[slot] = (mcfg, ops.run_queue_lock_fused_async(
                mcfg, st, 4, sync_every=4, block_n=64))
    gf, gp = lane.gbest()
    for slot, (_, st) in rows.items():
        got = lane.row(slot)
        assert got.iteration == st.iteration
        for f in ("pos", "vel", "pbest_pos", "pbest_fit", "gbest_pos",
                  "lbest_pos", "lbest_fit"):
            assert torch.equal(getattr(got, f), getattr(st, f)), (slot, f)
        assert gf[slot] == float(st.gbest_fit)
        np.testing.assert_array_equal(gp[slot], st.gbest_pos.numpy())


def test_init_swarm_async_is_init_plus_seeded_locals():
    cfg = pso.PSOConfig(dim=3, particle_cnt=256, fitness="sphere")
    s = pso.init_swarm_async(cfg, 5, n_blocks=2, device=CPU)
    base = pso.init_swarm(cfg, 5, device=CPU)
    assert torch.equal(s.pos, base.pos) and s.iteration == 0
    assert s.lbest_pos.shape == (2, 3) and s.lbest_fit.shape == (2,)
    assert torch.equal(s.lbest_fit, base.gbest_fit.expand(2))
    assert torch.equal(s.lbest_pos, base.gbest_pos.expand(2, 3))
    dflt = pso.init_swarm_async(cfg, 5, device=CPU)
    assert dflt.lbest_fit.shape == (1,)      # default_block_count(256)
    assert ms.MIN_VALIDATED_SWARMS == 8


def test_init_swarm_async_matches_reference():
    from repro.core import pso as jpso
    jcfg = jpso.PSOConfig(dim=3, particle_cnt=256, fitness="rastrigin")
    tcfg = pso.PSOConfig(dim=3, particle_cnt=256, fitness="rastrigin")
    j = jpso.init_swarm_async(jcfg, 9, n_blocks=2)
    t = pso.init_swarm_async(tcfg, 9, n_blocks=2, device=CPU)
    np.testing.assert_array_equal(t.pos.numpy(), np.asarray(j.pos))
    np.testing.assert_allclose(t.lbest_fit.numpy(), np.asarray(j.lbest_fit),
                               **FIT_TOL)
    np.testing.assert_array_equal(t.lbest_pos.numpy(),
                                  np.asarray(j.lbest_pos))


# -- against the reference's scheduler and server ------------------------------

COUNTS = ("submitted", "admitted", "completed", "row_swaps", "tail_ejections",
          "standalone_solves", "dispatches", "lane_slots",
          "lane_active_slots")


def _pos_tol(r):
    cfg = r.config().resolved()
    return dict(rtol=2e-6, atol=max(1e-5, 1e-6 * (cfg.max_pos - cfg.min_pos)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_scheduler_bookkeeping_matches_reference(backend):
    from repro.launch.serve import SolveRequest as JRequest
    from repro.serving import ContinuousScheduler as JScheduler
    reqs = _trace()
    js = JScheduler(lane_width=8)
    want = js.run([JRequest(**{f: getattr(r, f) for f in (
        "dim", "particle_cnt", "fitness", "seed", "iters", "variant",
        "sync_every")}) for r in reqs])
    ts = _sched(backend, lane_width=8)
    got = ts.run(reqs)
    assert {k: ts.metrics.get(k) for k in COUNTS} == {
        k: js.metrics.get(k) for k in COUNTS}
    tl, jl = ts.snapshot()["lanes"], js.snapshot()["lanes"]
    assert [(x["width"], x["active"], x["chunks"]) for x in tl] == [
        (x["width"], x["active"], x["chunks"]) for x in jl]
    for r, a, b in zip(reqs, got, want):
        assert a.batch_size == b.batch_size
        np.testing.assert_allclose(a.gbest_fit, b.gbest_fit, **FIT_TOL)
        np.testing.assert_allclose(a.gbest_pos, np.asarray(b.gbest_pos),
                                   **_pos_tol(r))


@pytest.mark.parametrize("backend", BACKENDS)
def test_server_bookkeeping_matches_reference(backend):
    from repro.launch.serve import SolveRequest as JRequest
    from repro.launch.serve import SolveServer as JServer
    reqs = _trace() + [_req(11, 16, variant="queue"),
                       _req(12, 12, variant="queue_lock")]
    jsrv = JServer(max_batch=8)   # its grouping is the backend's too
    jreqs = [JRequest(**{f: getattr(r, f) for f in (
        "dim", "particle_cnt", "fitness", "seed", "iters", "variant",
        "sync_every")}) for r in reqs]
    assert [r.group_key() for r in reqs] == [r.group_key() for r in jreqs]
    jsrv.solve_all(jreqs)
    srv = _server(backend, max_batch=8)
    got = srv.solve_all(reqs)
    assert srv.stats.as_dict() == jsrv.stats.as_dict()
    _assert_bit_exact(got, reqs, backend)


# -- the restart story: the program manifest -----------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_compile_cache_restart_zero_retrace_bit_exact(backend, tmp_path):
    """A cold cache builds the lane program once and records its spec; a
    fresh cache over the same directory prewarms it and serves the same
    trace with no build on the request path and equal results."""
    reqs = [_req(k, 16) for k in range(4)]
    cold = CompileCache(str(tmp_path))
    a = _sched(backend, lane_width=8, compile_cache=cold).run(reqs)
    assert cold.aot_misses == 1 and cold.trace_events == 1
    warm = CompileCache(str(tmp_path))
    assert warm.prewarm() == 1
    sched = _sched(backend, lane_width=8, compile_cache=warm)
    b = sched.run(reqs)
    assert warm.aot_hits == 1 and warm.aot_misses == 0
    assert warm.trace_events == 0
    for ra, rb in zip(a, b):
        assert ra.gbest_fit == rb.gbest_fit
        np.testing.assert_array_equal(ra.gbest_pos, rb.gbest_pos)
    _assert_bit_exact(b, reqs, backend)
    snap = sched.snapshot()["compile_cache"]
    assert snap["trace_events"] == 0 and snap["programs"] == 1
    # a manifest entry without prewarm: a hit, built on the request path
    late = CompileCache(str(tmp_path))
    _sched(backend, lane_width=8, compile_cache=late).run(reqs[:1])
    assert (late.aot_hits, late.aot_misses, late.trace_events) == (1, 0, 1)


def test_compile_cache_memory_only_dedup():
    cc = CompileCache(path="")
    calls = []

    def build():
        calls.append(1)
        return object()
    f1 = cc.get("k", build, {"x": 1})
    f2 = cc.get("k", build, {"x": 1})
    assert f1 is f2
    assert cc.aot_misses == 1 and cc.aot_hits == 1
    assert cc.trace_events == 1 and len(calls) == 1
    assert cc.prewarm() == 0


def test_compile_cache_manifest_fingerprint_mismatch(tmp_path):
    with open(tmp_path / "manifest.json", "w") as f:
        json.dump({"fingerprint": {"torch": "0.0.0", "device": "vaporware"},
                   "entries": {"deadbeef": {"key": "k", "spec": {
                       "backend": "eager"}}}}, f)
    assert CompileCache(str(tmp_path)).prewarm() == 0


def test_compile_cache_content_lane_is_memoized_not_recorded(tmp_path):
    """A custom Problem's program has no spec another process could rebuild
    from: memoized, counted as a build, kept out of the manifest."""
    prob = Problem(name="serving_lin", fn=lambda x: x.sum(-1), lo=-1.0,
                   hi=1.0)
    cc = CompileCache(str(tmp_path))
    _sched("kernel", compile_cache=cc).run([_req(0, 8, fitness=prob)])
    assert cc.aot_misses == 1 and cc.trace_events == 1
    assert CompileCache(str(tmp_path)).prewarm() == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_compile_cache_shared_by_two_schedulers(backend):
    """A lane program holds its lane's rows: two schedulers on one cache
    take turns on a lane key, each result its standalone solve's, and the
    second raises while the first has rows in flight at that key."""
    reqs = [_req(k, 16) for k in range(4)]
    cc = CompileCache(path="")
    a = _sched(backend, lane_width=8, compile_cache=cc)
    b = _sched(backend, lane_width=8, compile_cache=cc)
    _assert_bit_exact(a.run(reqs), reqs, backend)
    _assert_bit_exact(b.run(reqs[::-1]), reqs[::-1], backend)
    assert cc.trace_events == 1 and cc.aot_hits == 1
    a.submit(reqs[0])
    a.step()                            # a row of a's mid-solve
    t = b.submit(reqs[1])
    with pytest.raises(RuntimeError, match="another scheduler"):
        b.step()
    _assert_bit_exact([a.drain()[4]], reqs[:1], backend)
    _assert_bit_exact([b.drain()[t]], reqs[1:2], backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_solve_stream_facade(backend, tmp_path):
    reqs = [dict(dim=DIM, particle_cnt=N, fitness=NAMES[k], seed=k,
                 iters=16, variant="async", sync_every=SE)
            for k in range(3)]
    results = repro_torch.solve_stream(reqs, compile_cache=str(tmp_path),
                                       backend=backend, device=CPU)
    _assert_bit_exact(results, [SolveRequest(**r) for r in reqs], backend)
    assert repro_torch.solve_stream([], device=CPU) == []


# -- metrics ---------------------------------------------------------------------

def test_latency_stat_percentiles_and_reservoir():
    st = LatencyStat(cap=8)
    for v in (10.0, 20.0, 30.0, 40.0):
        st.add(v)
    assert st.mean_us == 25.0
    assert st.p50_us == 30.0
    assert st.p99_us == 40.0
    for v in range(100):
        st.add(float(v))
    assert st.count == 104
    assert len(st._samples) == 8
    snap = st.snapshot()
    assert snap["count"] == 104 and snap["p99_us"] <= 99.0


def test_serving_metrics_snapshot_and_fill():
    m = ServingMetrics()
    assert m.batch_fill == 0.0
    m.inc("lane_slots", 16)
    m.inc("lane_active_slots", 12)
    m.observe("e2e_us", 100.0)
    snap = m.snapshot()
    assert snap["batch_fill"] == 0.75
    assert snap["spans"]["e2e_us"]["count"] == 1
    m2 = ServingMetrics()
    m2.merge_from(m)
    assert m2.batch_fill == 0.75


def test_metrics_match_reference_copy():
    """The port keeps a copy of the reference's host-only bookkeeping: the
    same samples give the same snapshot and percentiles."""
    from repro.serving import LatencyStat as JStat
    a, b = LatencyStat(cap=16), JStat(cap=16)
    for v in np.random.default_rng(0).uniform(0, 1000, 40):
        a.add(v)
        b.add(v)
    assert a.snapshot() == b.snapshot()
    for q in (0, 10, 50, 90, 99, 100):
        assert a.percentile(q) == b.percentile(q)


def test_prometheus_exposition():
    pinned = {"queue_updates": 1, "publications": 1, "block_improvements": 11}
    m = ServingMetrics()
    m.inc("completed", 3)
    m.observe("e2e_us", 100.0)
    m.observe("e2e_us", 300.0)
    lines = m.prometheus(kernel_counters=pinned).splitlines()
    assert any(line.startswith("repro_completed_total 3") for line in lines)
    assert "# TYPE repro_completed_total counter" in lines
    assert "# TYPE repro_uptime_seconds gauge" in lines
    assert any('repro_span_latency_microseconds{span="e2e_us",quantile='
               in line for line in lines)
    assert 'repro_span_latency_microseconds_count{span="e2e_us"} 2' in lines
    assert "repro_kernel_publications_total 1" in lines
    assert "repro_kernel_block_improvements_total 11" in lines
    t2 = prometheus_text(m.snapshot(), prefix="pso")
    assert any(line.startswith("pso_completed_total")
               for line in t2.splitlines())


@pytest.mark.parametrize("backend", BACKENDS)
def test_solve_stream_trace_and_history(backend, tmp_path):
    reqs = [SolveRequest(fitness="cubic", dim=DIM, particle_cnt=N,
                         iters=12, seed=5, variant="async", sync_every=4),
            SolveRequest(fitness="sphere", dim=3, particle_cnt=N,
                         iters=16, seed=6, variant="async", sync_every=4),
            SolveRequest(fitness="cubic", dim=DIM, particle_cnt=N,
                         iters=12, seed=9, variant="queue")]
    p = tmp_path / "trace.json"
    res = repro_torch.solve_stream(reqs, lane_width=4, record_history=True,
                                   trace_path=str(p), backend=backend,
                                   device=CPU)
    for r in res[:2]:
        h = r.history
        assert h is not None and h.iteration[-1] == r.request.iters
        assert float(h.gbest_fit[-1]) == r.gbest_fit
        assert list(h.iteration) == list(range(4, r.request.iters + 1, 4))
        assert bool(np.all(np.diff(h.gbest_fit) >= 0))
    assert res[2].history is None
    evs = json.load(open(p))["traceEvents"]
    names = {e["name"] for e in evs}
    for prefix in ("admit t", "chunk ", "request t", "standalone t"):
        assert any(n.startswith(prefix) for n in names), prefix
    assert any(n.endswith(" fill") for n in names)
    for e in evs:
        assert {"name", "ph", "pid"} <= set(e)


def test_solve_stream_histories_match_the_kernel_backend_solve():
    """A lane row's history is the standalone kernel solve's history, the
    eject's sample included."""
    reqs = [_req(2, 20), _req(3, 16)]
    res = repro_torch.solve_stream(reqs, record_history=True,
                                   backend="kernel", device=CPU)
    for x, r in zip(res, reqs):
        want = facade_solve(r.fitness, dim=DIM, particles=N, iters=r.iters,
                            seed=r.seed, variant="async", sync_every=SE,
                            backend="kernel", record_history=True,
                            device=CPU).history
        np.testing.assert_array_equal(x.history.iteration, want.iteration)
        np.testing.assert_array_equal(x.history.gbest_fit, want.gbest_fit)


# -- the flush server ------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_flush_partial_failure_isolated(backend):
    def poison(x):
        raise RuntimeError("poisoned objective")

    bad = Problem(name="serving_poison", fn=poison, lo=-1.0, hi=1.0)
    good = [_req(k, 16, variant="queue") for k in range(2)]
    reqs = [good[0], _req(2, 16, fitness=bad, variant="queue"), good[1]]
    srv = _server(backend)
    results = srv.solve_all(reqs)
    assert not results[1].ok
    assert isinstance(results[1].error, RuntimeError)
    with pytest.raises(RuntimeError, match="request failed"):
        results[1].objective
    _assert_bit_exact([results[0], results[2]], good, backend)
    assert srv.stats.failed == 1
    assert srv.stats.requests == 2


def test_serve_stats_batch_fill_zero_flushes():
    s = serve.ServeStats()
    assert s.batch_fill == 0.0
    d = s.as_dict()
    assert d["batch_fill"] == 0.0 and d["failed"] == 0


def test_bucket_size_edges():
    from repro_torch.launch.serve import _MIN_BUCKET, BUCKETS, bucket_size
    assert bucket_size(1) == _MIN_BUCKET
    assert bucket_size(_MIN_BUCKET) == _MIN_BUCKET
    assert bucket_size(5) == 8
    assert bucket_size(BUCKETS[-1]) == BUCKETS[-1]
    assert bucket_size(10 ** 6) == BUCKETS[-1]
    assert bucket_size(100, max_batch=16) == 16
    assert bucket_size(3, max_batch=4) == 4
    assert bucket_size(5, max_batch=64, buckets=(4, 32)) == 32
    assert bucket_size(40, max_batch=64, buckets=(4, 32)) == 64


@pytest.mark.parametrize("backend", BACKENDS)
def test_serve_rejects_invalid_requests_per_request(backend):
    good = [_req(0, 16, variant="queue"), _req(1, 16)]
    bad = [
        SolveRequest(dim=DIM, particle_cnt=N, fitness=NAMES[0], seed=7,
                     iters=16, variant="warp"),
        SolveRequest(dim=DIM, particle_cnt=N, fitness=NAMES[1], seed=8,
                     iters=16, variant="queue", rule="warp_speed"),
        SolveRequest(dim=DIM, particle_cnt=N, fitness=NAMES[2], seed=9,
                     iters=16, variant="async", sync_every=SE,
                     topology="hypercube"),
    ]
    reqs = [good[0]] + bad + [good[1]]
    for front_end in (_server(backend).solve_all,
                      _sched(backend, lane_width=8).run):
        results = front_end(list(reqs))
        for res, want in zip(results[1:4], ("variant", "rule", "topology")):
            assert not res.ok
            assert want in str(res.error)
            assert np.isnan(res.gbest_fit)
        _assert_bit_exact([results[0], results[4]], good, backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_serve_rule_topology_thread_to_engine(backend):
    combos = [("sso", "gbest"), ("lowcost", "ring"), ("pso", "vonneumann")]
    reqs = [SolveRequest(dim=DIM, particle_cnt=N, fitness=NAMES[k], seed=k,
                         iters=16, variant="async", sync_every=SE,
                         rule=rule, topology=topo)
            for k, (rule, topo) in enumerate(combos)]
    srv = _server(backend)
    results = srv.solve_all(list(reqs))
    _assert_bit_exact(results, reqs, backend)
    assert srv.stats.dispatches == len(combos)


@pytest.mark.parametrize("backend", BACKENDS)
def test_serve_mixed_builtin_trace_coalesces_to_one_dispatch(backend):
    reqs = [SolveRequest(dim=10, particle_cnt=128, fitness=nm, seed=i,
                         iters=20, variant="queue")
            for i, nm in enumerate(NAMES)]
    srv = _server(backend)
    res = srv.solve_all(reqs)
    assert srv.stats.dispatches == 1
    assert srv.stats.hetero_dispatches == 1
    assert srv.stats.batch_fill == len(reqs)
    _assert_bit_exact(res, reqs, backend)


def test_serve_coalesce_off_restores_content_hash_grouping():
    reqs = [SolveRequest(dim=3, particle_cnt=64, fitness=nm, seed=i,
                         iters=10, variant="queue")
            for i, nm in enumerate(["sphere", "cubic", "rastrigin"])]
    srv = _server("eager", coalesce_registry=False)
    srv.solve_all(reqs)
    assert srv.stats.dispatches == 3
    assert srv.stats.hetero_dispatches == 0
    srv2 = _server("eager")
    srv2.solve_all(reqs)
    assert srv2.stats.dispatches == 1
    assert srv2.stats.batch_fill >= 2 * srv.stats.batch_fill


@pytest.mark.parametrize("backend", BACKENDS)
def test_serve_custom_problem_keeps_content_hash_isolation(backend):
    custom = Problem(name="mine", fn=lambda x: -(x * x).sum(-1),
                     lo=-1.0, hi=1.0)
    reqs = [SolveRequest(dim=3, particle_cnt=64, fitness="sphere", seed=0,
                         iters=10, variant="queue_lock"),
            SolveRequest(dim=3, particle_cnt=64, fitness=custom, seed=1,
                         iters=10, variant="queue_lock")]
    assert reqs[0].hetero_eligible and not reqs[1].hetero_eligible
    srv = _server(backend)
    res = srv.solve_all(reqs)
    assert srv.stats.dispatches == 2
    assert srv.stats.hetero_dispatches == 1
    if backend == "eager":
        _assert_bit_exact(res, reqs, backend)
    else:
        # a queue_lock batch row is the single-swarm fused kernel (no
        # history: every fused launch is a whole run)
        for x, r in zip(res, reqs):
            want = facade_solve(r.fitness, dim=3, particles=64, iters=10,
                                seed=r.seed, variant="queue_lock",
                                backend="kernel", device=CPU)
            assert x.gbest_fit == want.gbest_fit


@pytest.mark.parametrize("variant", ["queue_lock", "async"])
def test_serve_kernel_backend_hetero_dispatch(variant):
    """Built-in queue_lock/async groups on the kernel backend are one
    heterogeneous batched kernel call; each row equals its problem's
    single-swarm kernel."""
    names = ["sphere", "rastrigin", "ackley"]
    reqs = [SolveRequest(dim=2, particle_cnt=128, fitness=nm, seed=i,
                         iters=6, variant=variant)
            for i, nm in enumerate(names)]
    srv = _server("kernel")
    res = srv.solve_all(reqs)
    assert srv.stats.dispatches == 1 and srv.stats.hetero_dispatches == 1
    for r in res:
        ck = r.request.config().resolved()
        st = pso.init_swarm(ck, r.request.seed, device=CPU)
        if variant == "queue_lock":
            ref = ops.run_queue_lock_fused(ck, st, iters=6)
        else:
            ref = ops.run_queue_lock_fused_async(ck, st, iters=6)
        np.testing.assert_array_equal(r.gbest_pos, ref.gbest_pos.numpy())


def test_solve_server_async_variant_both_backends():
    reqs = [SolveRequest(dim=2, particle_cnt=128, fitness="cubic", seed=i,
                         iters=8, variant="async", sync_every=4)
            for i in range(3)]
    for r in _server("eager", max_batch=8).solve_all(reqs):
        cfg = r.request.config().resolved()
        direct = pso.run_async(cfg, pso.init_swarm(cfg, r.request.seed,
                                                   device=CPU), 8,
                               sync_every=4)
        assert r.gbest_fit == float(direct.gbest_fit)
    for r in _server("kernel", max_batch=8, block_n=64).solve_all(reqs):
        cfg = r.request.config().resolved()
        direct = ops.run_queue_lock_fused_async(
            cfg, pso.init_swarm(cfg, r.request.seed, device=CPU), iters=8,
            sync_every=4, block_n=64)
        assert r.gbest_fit == float(direct.gbest_fit)


def test_sync_every_is_part_of_compile_key_for_async_only():
    a = SolveRequest(variant="async", sync_every=4)
    b = SolveRequest(variant="async", sync_every=16)
    assert a.batch_key != b.batch_key
    c = SolveRequest(variant="queue_lock", sync_every=4)
    d = SolveRequest(variant="queue_lock", sync_every=16)
    assert c.batch_key == d.batch_key


@pytest.mark.parametrize("backend", BACKENDS)
def test_solve_server_batches_and_matches_direct_solve(backend):
    reqs = [SolveRequest(dim=1, particle_cnt=64, fitness="cubic",
                         seed=i, iters=30) for i in range(5)]
    reqs += [SolveRequest(dim=3, particle_cnt=64, fitness="rastrigin",
                          seed=i, iters=30) for i in range(3)]
    srv = _server(backend, max_batch=16)
    results = srv.solve_all(reqs)
    assert len(results) == 8
    assert srv.stats.dispatches == 2
    assert srv.stats.padded_rows == (8 - 5) + (4 - 3)
    _assert_bit_exact(results, reqs, backend)


def test_solve_server_rejects_sub_bucket_max_batch():
    _server("eager", max_batch=4)
    with pytest.raises(ValueError):
        _server("eager", max_batch=2)
    with pytest.raises(ValueError):
        _server("bogus")


def test_serve_backend_resolution():
    """``auto`` is the facade's rule: the kernels on a card, eager on the
    CPU; variants without a kernel run eager on every backend."""
    cpu = torch.device(CPU)
    assert serve.resolve_backend("auto", "async", "pso", cpu) == "eager"
    assert serve.resolve_backend("kernel", "async", "pso", cpu) == "kernel"
    assert serve.resolve_backend("kernel", "queue", "pso", cpu) == "eager"
    assert serve.resolve_backend("auto", "async", "pso",
                                 torch.device("cuda")) == "kernel"


def test_serve_cli_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "metrics.prom"
    assert serve.main(["--requests", "6", "--iters", "8", "--device", CPU,
                       "--backend", "kernel", "--metrics-out",
                       str(out)]) == 0
    text = capsys.readouterr().out
    assert "6 requests in 2 dispatches (2 heterogeneous" in text
    assert "repro_completed_total 6" in out.read_text()


# -- Problem.cache_key ---------------------------------------------------------

def test_cache_key_content_identity():
    from repro_torch.core.problem import get_problem
    assert get_problem("cubic").cache_key() == repro_torch.resolve_problem(
        "cubic").cache_key()
    assert SolveRequest(fitness="sphere").batch_key == SolveRequest(
        fitness=get_problem("sphere")).batch_key

    def make(scale, lo=-1.0, name="q"):
        w = torch.full((3,), scale)
        return Problem(name=name, fn=lambda x: -(w * x * x).sum(-1), lo=lo,
                       hi=1.0)
    assert make(1.0).cache_key() == make(1.0).cache_key()
    assert make(1.0).cache_key() != make(2.0).cache_key()      # closure
    assert make(1.0).cache_key() != make(1.0, lo=-2.0).cache_key()
    other = Problem(name="q", fn=lambda x: (x * x).sum(-1), lo=-1.0, hi=1.0)
    assert other.cache_key() != make(1.0).cache_key()           # body
    big = np.arange(5000, dtype=np.float32)
    tweak = big.copy()
    tweak[2500] += 1.0       # beyond any repr's truncation
    assert Problem(name="b", fn=lambda x, a=big: x.sum(-1)).cache_key() != \
        Problem(name="b", fn=lambda x, a=tweak: x.sum(-1)).cache_key()
    assert repro_torch.get_problem("sphere_simplex").cache_key() != \
        repro_torch.get_problem("sphere_simplex_pen").cache_key()
    p = make(3.0)
    assert p.cache_key() is p.cache_key()                       # memoized


_KEY_CODE = """
import sys, numpy as np, torch
sys.path.insert(0, {src!r})
from repro_torch.core.problem import Problem, get_problem
w = torch.linspace(0.5, 1.5, 7)
a = np.arange(3000, dtype=np.float32)
p = Problem(name="k", fn=lambda x, a=a: -(w * x * x).sum(-1) + float(a[7]),
            lo=(-1.0,) * 7, hi=2.0, sense="min", kernel_fn=torch.sum)
print(p.cache_key(), get_problem("rastrigin").cache_key(),
      get_problem("sphere_simplex").cache_key())
"""


def test_cache_key_is_the_same_in_two_processes():
    code = _KEY_CODE.format(src=str(ROOT / "src"))
    outs = [subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=120, env=dict(
                               os.environ, PYTHONHASHSEED=str(seed)))
            for seed in (1, 2)]
    for o in outs:
        assert o.returncode == 0, o.stderr
    assert outs[0].stdout == outs[1].stdout
    assert outs[0].stdout.split()[1] == repro_torch.get_problem(
        "rastrigin").cache_key()


# -- the lane graph on the card ------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("hetero", [False, True])
def test_lane_graph_replay_equals_the_uncaptured_launch(hetero):
    """A lane captures its chunk once; each replay equals the uncaptured
    batched launch (``pso_step.fused_async_batch``) on copies of the same
    operands, bit for bit (one block a row: no race)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = pso.PSOConfig(dim=DIM, particle_cnt=N,
                        fitness="cubic" if hetero else "rastrigin")
    caps = ops.AsyncLane.captures
    lane = ops.AsyncLane(cfg, 8, SE, table=BUILTIN_PROBLEMS if hetero
                         else None, device=dev)
    assert ops.AsyncLane.captures == caps + 1
    for s in range(8):
        one = None
        hr = None
        if hetero:
            one, table = ms.problem_rows([NAMES[s % 6]], DIM, device=dev)
            hr = (table, pso.HeteroRow(one.fid[0], one.lo[0], one.hi[0],
                                       one.mv[0]))
        lane.admit(s, pso.init_swarm_async(cfg, 40 + s, n_blocks=lane.nb,
                                           hetero=hr, device=dev), one)
    ref = [t.clone() for t in lane.state]
    seeds = lane.counters[0].long() & 0xFFFFFFFF
    its = lane.counters[1].long()
    key = "hetero_launches" if hetero else "launches"
    before = getattr(pso_step.fused_async_batch, key)
    for k in range(3):
        lane.dispatch()
        pso_step.fused_async_batch(*ref, seeds, its + k * SE, lane.specs,
                                   iters=SE, sync_every=SE,
                                   block_n=lane.block_n, fids=lane.fids)
        torch.cuda.synchronize()
        for a, b in zip(lane.state, ref):
            assert torch.equal(a, b), k
    assert lane.counters[1].tolist() == [3 * SE] * 8
    assert getattr(pso_step.fused_async_batch, key) == before + 6
    assert ops.AsyncLane.captures == caps + 1
