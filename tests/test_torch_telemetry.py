"""repro_torch.telemetry and the convergence histories on the CPU, against
repro.telemetry and the JAX oracles, plus the counter kernels against their
plain versions on a card (``gpu``-marked; they skip inside the test when
there is none).

Counter pins are exact event counts, not tolerances: the plain versions
count at the oracles' program points (``ref.run_fused_oracle``,
``ref.run_fused_async_oracle``). With several blocks the port's fused
kernel is synchronous PPSO (every block reads the previous iteration's
gbest) where the TPU kernel's grid runs blocks in order, so its counts are
held to ``ref.queue_step_oracle`` iterated, and to the invariants
``queue_updates == publications <= block_improvements <= iters * nb``.

Histories: iteration numbers equal ``repro.solve``'s exactly; gbest samples
within the parity tolerance of tests/test_torch_api.py's solve_many rows
over at most 10 iterations (fitness rtol=1e-5, atol=1e-5: near rastrigin's
optimum the fitness, about -1, cancels terms of order 10 whose cos rounds
differently in XLA and PyTorch), and over longer runs monotone with the
last sample equal to ``Result.gbest_fit``.
"""
import json

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import api
from repro_torch.core import multi_swarm as ms
from repro_torch.core import pso
from repro_torch.kernels import ops, pso_step
from repro_torch.telemetry import (COUNTER_NAMES, SLOTS_PER_SWARM,
                                   KernelCounters, TraceWriter,
                                   profiler_session, prometheus_text,
                                   zero_counts)

try:
    import repro
    from repro import telemetry as jtel
    from repro.core import pso as jpso
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ModuleNotFoundError:     # a CUDA host may have no JAX installed
    repro = jtel = jpso = jops = jref = None

torch.set_num_threads(1)

# the reference's pinned validation shape (tests/test_telemetry.py): dim=2
# cubic, 128 particles, two blocks of 64, 12 iterations, seed 5
DIM, N, BN, ITERS, SEED = 2, 128, 64, 12, 5


@pytest.fixture
def reference():
    """The JAX reference, for the parity tests on the CPU."""
    if jpso is None:
        pytest.skip("needs the JAX reference package `repro`, and JAX is "
                    "not installed")


@pytest.fixture
def cuda():
    """The card, decided inside the test so every worker collects alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100 with "
                    "`python -m pytest -m gpu tests/test_torch_telemetry.py`")
    return torch.device("cuda")


def _cfg(fit="cubic", d=DIM, n=N, rule="pso"):
    return pso.PSOConfig(dim=d, particle_cnt=n, fitness=fit,
                         update_rule=rule).resolved()


def _state(cfg, seed=SEED, device="cpu"):
    return pso.init_swarm(cfg, seed, device=device)


def _counts(cnt) -> dict:
    return KernelCounters.from_array(cnt).as_dict()


def _oracle(fit, d, n, bn, iters, seed, sync_every=None, rule="pso"):
    """The JAX oracle's counts for the run, from the port's initial state
    (bit-equal to the reference's)."""
    jc = jpso.PSOConfig(dim=d, particle_cnt=n, fitness=fit,
                        update_rule=rule).resolved()
    state = ops.state_to_kernel(_state(_cfg(fit, d, n, rule), seed))
    pos, vel, pbp, pbf, gp, gf = (x.numpy() for x in state)
    kw = jops._cfg_kwargs(jc)
    kw["d_real"] = d
    fitness = kw.pop("fitness")
    cnt = {}
    if sync_every is None:
        jref.run_fused_oracle(seed, 0, pos, vel, pbp, pbf[None, :],
                              gp[:, None], gf, iters, bn, fitness=fitness,
                              counters=cnt, **kw)
    else:
        jref.run_fused_async_oracle(seed, 0, pos, vel, pbp, pbf[None, :],
                                    gp[:, None], float(gf[0]), iters, bn,
                                    sync_every, fitness=fitness, counters=cnt,
                                    **kw)
    return {k: cnt.get(k, 0) for k in COUNTER_NAMES}


def _invariants(c: dict, iters: int, nb: int, sync=True, chunks=None):
    """The counter invariants: a lane that beats the working best (gbest,
    or an async block's local best, which is at least its pbests) also
    beats its own pbest."""
    assert c["queue_updates"] <= c["block_improvements"] <= iters * nb
    if sync:
        assert c["queue_updates"] == c["publications"]
    else:
        assert c["publications"] <= chunks * nb


# ---------------------------------------------------------------- exporters

def test_kernel_counters_match_reference(reference):
    arr = np.array([3, 1, 7, 0, 0, 2], np.int32)
    got = KernelCounters.rows(torch.from_numpy(arr))
    want = jtel.KernelCounters.rows(arr)
    assert [g.as_dict() for g in got] == [w.as_dict() for w in want]
    one = KernelCounters.from_array(torch.tensor([1, 2, 3], dtype=torch.int32))
    jone = jtel.KernelCounters.from_array(np.array([1, 2, 3], np.int32))
    assert (one + one).as_dict() == (jone + jone).as_dict()
    assert COUNTER_NAMES == jtel.COUNTER_NAMES
    assert SLOTS_PER_SWARM == jtel.SLOTS_PER_SWARM
    with pytest.raises(ValueError):
        KernelCounters.from_array(np.zeros(4, np.int32))
    z = zero_counts(2, device="cpu")
    assert z.dtype == torch.int32 and tuple(z.shape) == (6,)
    assert int(z.abs().sum()) == 0


@pytest.mark.parametrize("prefix", ["repro", "pso"])
def test_prometheus_text_matches_reference(prefix, reference):
    snap = {"uptime_s": 12.5, "counters": {"completed": 3, "lane.admit": 7},
            "batch_fill": 0.75, "lanes": [1, 2],
            "spans": {"e2e_us": {"p50_us": 100.0, "p99_us": 300.0,
                                 "mean_us": 200.0, "count": 2},
                      "9dispatch": {"p50_us": 5.0, "p99_us": 9.5,
                                    "mean_us": 6.25, "count": 4}}}
    kc = {"queue_updates": 1, "publications": 1, "block_improvements": 11}
    for k in (None, kc):
        got = prometheus_text(snap, prefix=prefix, kernel_counters=k)
        want = jtel.prometheus_text(snap, prefix=prefix, kernel_counters=k)
        assert got == want
    assert prometheus_text({}) == jtel.prometheus_text({})


def test_trace_writer_matches_reference(tmp_path, reference):
    writers = TraceWriter(), jtel.TraceWriter()
    for tw in writers:
        tw.complete("chunk", 100.0, 50.0, process="solver", thread="chunks",
                    cat="solve", args={"iters": 4})
        tw.instant("admit t0", 120.0, process="serving", thread="lane 0")
        tw.counter("lane 0 fill", 130.0, {"active": 3, "idle": 1})
        tw.complete("neg", 90.0, -1.0, process="serving", thread="lane 1")
    got, want = (tw.to_dict() for tw in writers)
    assert got == want and writers[0].event_count == writers[1].event_count
    p = tmp_path / "trace.json"
    writers[0].write(str(p))
    assert json.loads(p.read_text()) == want
    with writers[0].span("host", args={"k": 1}):
        pass
    assert writers[0].to_dict()["traceEvents"][-1]["name"] == "host"


def test_profiler_session(tmp_path):
    with profiler_session(None) as on:
        assert on is False
    with profiler_session(str(tmp_path / "prof")) as on:
        torch.ones(4).sum()
    assert on is True
    doc = json.loads((tmp_path / "prof" / "torch_trace.json").read_text())
    assert "traceEvents" in doc


# ----------------------------------------------- plain versions vs oracles

@pytest.mark.parametrize("fit,rule", [("cubic", "pso"), ("rastrigin", "sso"),
                                      ("sphere", "lowcost")])
def test_fused_plain_one_block_counts_match_oracle(fit, rule, reference):
    cfg = _cfg(fit, rule=rule)
    s = _state(cfg)
    cnt = zero_counts(device="cpu")
    pso_step.fused_plain(*ops.state_to_kernel(s), ops.kernel_spec(cfg),
                         seed=SEED, iteration=0, iters=6, block_n=N,
                         counts=cnt)
    got = _counts(cnt)
    assert got == _oracle(fit, DIM, N, N, 6, SEED, rule=rule)
    _invariants(got, 6, 1)


@pytest.mark.parametrize("fit,sync_every", [("cubic", 4), ("griewank", 3)])
def test_fused_async_plain_one_block_counts_match_oracle(fit, sync_every,
                                                         reference):
    cfg = _cfg(fit)
    state = ops.state_to_kernel(_state(cfg))
    cnt = zero_counts(device="cpu")
    pso_step.fused_async_plain(*state, state[4][:, None].clone(),
                               state[5].clone(), ops.kernel_spec(cfg),
                               seed=SEED, iteration=0, iters=7,
                               sync_every=sync_every, block_n=N, counts=cnt)
    assert _counts(cnt) == _oracle(fit, DIM, N, N, 7, SEED, sync_every)


def test_fused_async_plain_two_blocks_pinned_shape(reference):
    """The reference's pinned shape, through ``ops`` (seeded locals, the
    counter buffer) and the oracle: equal counts."""
    cfg = _cfg()
    _, cnt = ops.run_queue_lock_fused_async(cfg, _state(cfg), ITERS,
                                            sync_every=4, block_n=BN,
                                            telemetry=True)
    got = _counts(cnt)
    assert got == _oracle("cubic", DIM, N, BN, ITERS, SEED, 4)
    _invariants(got, ITERS, N // BN, sync=False, chunks=ITERS // 4)


def test_fused_plain_multi_block_counts_are_queue_step_oracle(reference):
    """Synchronous PPSO over four blocks: per iteration, a block counts a
    queue update (and a publication) where the oracle's ``aux_fit`` beats
    the previous gbest, and an improvement where a pbest of its rose."""
    fit, d, n, bn, iters = "rastrigin", 3, 256, 64, 5
    cfg = _cfg(fit, d, n)
    jc = jpso.PSOConfig(dim=d, particle_cnt=n, fitness=fit).resolved()
    state = ops.state_to_kernel(_state(cfg, seed=2))
    cnt = zero_counts(device="cpu")
    pso_step.fused_plain(*state, ops.kernel_spec(cfg), seed=2, iteration=0,
                         iters=iters, block_n=bn, counts=cnt)
    kw = jops._cfg_kwargs(jc)
    kw["d_real"] = d
    fitness = kw.pop("fitness")
    pos, vel, pbp, pbf, gp, gf = (x.numpy() for x in state)
    pbf, gp = pbf[None, :], gp[:, None]
    want = dict.fromkeys(COUNTER_NAMES, 0)
    for t in range(iters):
        old_pbf = np.asarray(pbf).reshape(-1)
        old_gf = float(np.asarray(gf).reshape(-1)[0])
        pos, vel, pbp, pbf, gp, gf, aux_fit, _ = jref.queue_step_oracle(
            2, t, pos, vel, pbp, pbf, gp, old_gf, bn, fitness=fitness, **kw)
        q = int((np.asarray(aux_fit) > old_gf).sum())
        imp = (np.asarray(pbf).reshape(-1) > old_pbf).reshape(-1, bn)
        want["queue_updates"] += q
        want["publications"] += q
        want["block_improvements"] += int(imp.any(1).sum())
    got = _counts(cnt)
    assert got == want
    _invariants(got, iters, n // bn)


@pytest.mark.parametrize("variant", ["queue_lock", "async"])
def test_counts_add_up_across_chunked_calls(variant):
    cfg = _cfg()
    kw = dict(block_n=BN, telemetry=True)
    if variant == "async":
        run, kw["sync_every"] = ops.run_queue_lock_fused_async, 4
    else:
        run = ops.run_queue_lock_fused
    whole, cnt = run(cfg, _state(cfg), ITERS, **kw)
    s, tot = _state(cfg), None
    for k in (4, 4, 4) if variant == "async" else (5, 4, 3):
        s, c = run(cfg, s, k, **kw)
        tot = KernelCounters.from_array(c) + (tot or KernelCounters(0, 0, 0))
    assert tot == KernelCounters.from_array(cnt)
    assert torch.equal(s.pos, whole.pos) and torch.equal(s.gbest_pos,
                                                         whole.gbest_pos)


def test_counts_disabled_by_default():
    cfg = _cfg()
    out = ops.run_queue_lock_fused(cfg, _state(cfg), 2, block_n=BN)
    assert isinstance(out, pso.SwarmState)
    assert api.Method(variant="async").telemetry is False


def _batch(fit, seeds, problems=None, d=DIM, n=N):
    cfg = pso.PSOConfig(dim=d, particle_cnt=n,
                        **({} if problems else dict(fitness=fit)))
    if problems is None:
        cfg = cfg.resolved()
        return cfg, ms.init_batch(cfg, seeds, device="cpu"), None, None
    rows, table = ms.problem_rows(problems, d, device="cpu")
    rcfg = cfg.resolved()
    return (rcfg, ms.init_batch(rcfg, seeds, rows=rows, table=table,
                                device="cpu"), rows, table)


@pytest.mark.parametrize("variant", ["queue_lock", "async"])
@pytest.mark.parametrize("hetero", [False, True])
def test_batch_counts_rows_equal_single_swarm(variant, hetero):
    """Row s of a batch's [S, 3] counts equals the single-swarm run of its
    swarm: the batch row for a homogeneous batch, its problem with the
    member's bounds (``hetero_member_config``) for a heterogeneous one."""
    seeds = (5, 6, 7)
    problems = ["cubic", "sphere", "rastrigin"] if hetero else None
    cfg, b, rows, table = _batch("cubic", seeds, problems)
    kw = dict(block_n=BN, telemetry=True)
    fids = None if rows is None else rows.fid
    if variant == "async":
        _, cnt = ops.run_queue_lock_fused_async_batch(
            cfg, b, ITERS, sync_every=4, fids=fids, table=table, **kw)
        single = ops.run_queue_lock_fused_async
        kw["sync_every"] = 4
    else:
        _, cnt = ops.run_queue_lock_fused_batch(cfg, b, ITERS, fids=fids,
                                                table=table, **kw)
        single = ops.run_queue_lock_fused
    assert tuple(cnt.shape) == (3, SLOTS_PER_SWARM)
    for s in range(3):
        c = cfg if not hetero else pso.hetero_member_config(
            pso.PSOConfig(dim=DIM, particle_cnt=N), table[int(fids[s])])
        _, one = single(c, ms.batch_row(b, s), ITERS, **kw)
        assert KernelCounters.rows(cnt)[s] == KernelCounters.from_array(one)
        _invariants(_counts(one), ITERS, N // BN, sync=variant != "async",
                    chunks=ITERS // 4)


# ------------------------------------------------------------- api surface

def test_telemetry_method_validation():
    """Mirrors tests/test_telemetry.py::test_telemetry_method_validation,
    plus a rule the kernels do not carry."""
    from repro_torch.core import update_rules as ur
    ur.UPDATE_RULES["pso_twin"] = ur.PSORule("pso_twin")
    try:
        with pytest.raises(ValueError, match="lowcost"):
            api.Method(variant="async", rule="pso_twin", telemetry=True)
    finally:
        del ur.UPDATE_RULES["pso_twin"]
    with pytest.raises(ValueError, match="telemetry"):
        api.Method(variant="queue_lock", backend="eager", telemetry=True)
    with pytest.raises(ValueError, match="telemetry"):
        api.Method(variant="queue", telemetry=True)   # no queue kernel
    with pytest.raises(ValueError, match="telemetry"):
        api.Method(variant="queue_lock", islands=2, telemetry=True)
    with pytest.raises(ValueError, match="single-device"):
        api.Method(variant="queue", islands=2, record_history=True)
    # telemetry alone resolves to the kernel backend, on any device
    m = api.Method(variant="queue_lock", telemetry=True)
    assert m.resolve_backend(torch.device("cpu")) == "kernel"
    assert api.Method(variant="queue_lock").resolve_backend(
        torch.device("cpu")) == "eager"


def test_result_telemetry_and_history_on_kernel_backend():
    kw = dict(dim=DIM, particles=N, iters=ITERS, seed=SEED, block_n=BN,
              device="cpu")
    r = repro_torch.solve("cubic", variant="queue_lock", backend="kernel",
                          record_history=True, telemetry=True, **kw)
    r0 = repro_torch.solve("cubic", variant="queue_lock", backend="kernel",
                           **kw)
    assert isinstance(r.telemetry, KernelCounters) and r0.telemetry is None
    assert r0.history is None and r.first_feasible_iter == 0
    h = r.history
    assert isinstance(h, api.History) and len(h) == ITERS
    assert list(h.iteration) == list(range(1, ITERS + 1))
    assert h.violation is None
    assert float(h.gbest_fit[-1]) == r.gbest_fit
    assert np.all(np.diff(h.gbest_fit) >= 0)
    for a, b in zip(r.state, r0.state):      # history on == history off
        assert a == b if not isinstance(a, torch.Tensor) else torch.equal(a, b)
    _invariants(r.telemetry.as_dict(), ITERS, N // BN)
    ra = repro_torch.solve("cubic", variant="async", sync_every=5,
                           telemetry=True, record_history=True, **kw)
    assert list(ra.history.iteration) == [5, 10, 12]
    assert float(ra.history.gbest_fit[-1]) == ra.gbest_fit
    assert ra.method.resolve_backend(torch.device("cpu")) == "kernel"
    _invariants(ra.telemetry.as_dict(), ITERS, N // BN, sync=False, chunks=3)


@pytest.mark.parametrize("variant,backend", [
    ("reduction", "eager"), ("queue", "eager"), ("queue_lock", "eager"),
    ("async", "eager"), ("queue_lock", "kernel"), ("async", "kernel")])
def test_solve_history_matches_reference(variant, backend, reference):
    kw = dict(dim=3, particles=128, iters=8, seed=7, variant=variant,
              sync_every=3, record_history=True)
    want = repro.solve("rastrigin", backend="jnp", **kw)
    got = repro_torch.solve("rastrigin", backend=backend, device="cpu", **kw)
    np.testing.assert_array_equal(got.history.iteration,
                                  np.asarray(want.history.iteration))
    np.testing.assert_allclose(got.history.gbest_fit,
                               np.asarray(want.history.gbest_fit),
                               rtol=1e-5, atol=1e-5)
    assert got.history.violation is None and want.history.violation is None
    assert float(got.history.gbest_fit[-1]) == got.gbest_fit


@pytest.mark.parametrize("variant", ["queue", "async"])
def test_long_history_invariants(variant):
    r = repro_torch.solve("griewank", dim=4, particles=256, iters=60, seed=3,
                          variant=variant, sync_every=7, record_history=True,
                          device="cpu")
    h = r.history
    want = list(range(1, 61)) if variant == "queue" else \
        list(range(7, 60, 7)) + [60]
    assert list(h.iteration) == want
    assert np.all(np.diff(h.gbest_fit) >= 0)
    assert float(h.gbest_fit[-1]) == r.gbest_fit
    off = repro_torch.solve("griewank", dim=4, particles=256, iters=60,
                            seed=3, variant=variant, sync_every=7,
                            device="cpu")
    assert torch.equal(off.state.pos, r.state.pos)


@pytest.mark.parametrize("variant,hetero", [
    ("queue", False), ("reduction", True), ("async", False), ("async", True)])
def test_run_many_with_history_rows_are_run_with_history(variant, hetero):
    problems = ["cubic", "sphere", "rastrigin", "ackley"] if hetero else None
    cfg, b, rows, table = _batch("rastrigin", (1, 2, 3, 4), problems, d=3,
                                 n=64)
    out, (its, fits, viols) = ms.run_many_with_history(
        cfg, b, 7, variant, sync_every=3, rows=rows, table=table, n_blocks=2)
    assert viols is None and tuple(fits.shape) == (len(its), 4)
    for s in range(4):
        c = cfg if not hetero else pso.hetero_member_config(
            pso.PSOConfig(dim=3, particle_cnt=64), table[int(rows.fid[s])])
        one, (its1, fits1, _) = pso.run_with_history(
            c, ms.batch_row(b, s), 7, variant, sync_every=3, n_blocks=2)
        assert its1 == its
        assert torch.equal(fits1, fits[:, s])
        assert torch.equal(one.pos, out.pos[s])


@pytest.mark.parametrize("variant,backend", [("queue_lock", "kernel"),
                                             ("async", "kernel"),
                                             ("queue_lock", "eager")])
def test_solve_many_row_histories(variant, backend):
    seeds = (5, 6, 7)
    kw = dict(dim=DIM, particles=N, iters=ITERS, variant=variant,
              backend=backend, block_n=BN, sync_every=4, record_history=True,
              telemetry=backend == "kernel" or None, device="cpu")
    res = repro_torch.solve_many("cubic", seeds, **kw)
    for sd, r in zip(seeds, res):
        one = repro_torch.solve("cubic", seed=sd, **kw)
        np.testing.assert_array_equal(r.history.iteration,
                                      one.history.iteration)
        np.testing.assert_array_equal(r.history.gbest_fit,
                                      one.history.gbest_fit)
        assert float(r.history.gbest_fit[-1]) == r.gbest_fit
        assert r.telemetry == one.telemetry


@pytest.mark.parametrize("backend", ["kernel", "eager"])
def test_solve_many_hetero_histories(backend):
    problems = ["cubic", "sphere", "rastrigin"]
    res = repro_torch.solve_many(
        problems=problems, seeds=(5, 6, 7), dim=DIM, particles=N,
        iters=ITERS, variant="queue_lock", backend=backend, block_n=BN,
        record_history=True, telemetry=backend == "kernel" or None,
        device="cpu")
    for p, r in zip(problems, res):
        assert r.problem.name == p and len(r.history) == ITERS
        assert float(r.history.gbest_fit[-1]) == r.gbest_fit
        assert np.all(np.diff(r.history.gbest_fit) >= 0)
        if backend == "kernel":
            _invariants(r.telemetry.as_dict(), ITERS, N // BN)
        else:
            assert r.telemetry is None


def test_kernel_history_equals_chunked_ops_calls():
    """The history runner packs once and launches a sync point at a time;
    its final state and samples equal ``ops`` called chunk by chunk."""
    cfg = _cfg("rastrigin", 3, 256)
    s0 = _state(cfg, 4)
    out, (its, fits), cnt = ops.run_queue_lock(cfg, s0, 10, "async",
                                               sync_every=4, block_n=64,
                                               telemetry=True, history=True)
    s, tot, want = s0, KernelCounters(0, 0, 0), []
    for k in (4, 4, 2):
        s, c = ops.run_queue_lock_fused_async(cfg, s, k, sync_every=4,
                                              block_n=64, telemetry=True)
        tot = tot + KernelCounters.from_array(c)
        want.append(float(s.gbest_fit))
    assert its == [4, 8, 10] and fits.tolist() == want
    assert KernelCounters.from_array(cnt) == tot
    for a, b in zip(out, s):
        assert a == b if not isinstance(a, torch.Tensor) else torch.equal(a, b)


# ------------------------------------------------------- on the card (gpu)

def _card_counts(state, spec, kernel, **kw):
    cnt = zero_counts(device="cuda")
    out = kernel(*[x.clone() for x in state], spec, counts=cnt, **kw)
    torch.cuda.synchronize()
    return out, _counts(cnt)


@pytest.mark.gpu
@pytest.mark.parametrize("d,n", [(1, 4096), (8, 512), (120, 1024)])
def test_fused_counter_kernel_on_card(cuda, d, n):
    """Counters on and off give bit-equal states; the counts equal the
    counting plain version's wherever the trajectories agree (exactly at
    d=1 and one block), else the invariants hold."""
    cfg = _cfg("rastrigin" if d > 1 else "cubic", d, n)
    spec = ops.kernel_spec(cfg)
    state = ops.state_to_kernel(_state(cfg, 1, device="cuda"))
    bn = ops._resolve_block(n, None)
    kw = dict(seed=1, iteration=3, iters=4, block_n=bn)
    off = pso_step.fused(*[x.clone() for x in state], spec, **kw)
    on, got = _card_counts(state, spec, pso_step.fused, **kw)
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    want = zero_counts(device="cuda")
    plain = pso_step.fused_plain(*state, spec, counts=want, **kw)
    _invariants(got, 4, n // bn)
    if d == 1 or all(torch.equal(a, b) for a, b in zip(on, plain)):
        assert got == _counts(want)


@pytest.mark.gpu
def test_async_counter_kernel_on_card(cuda):
    """One block: counters on equal off bit for bit, counts equal the plain
    version's; several blocks: the async invariants."""
    cfg = _cfg("cubic", 8, 512)
    spec = ops.kernel_spec(cfg)
    state = ops.state_to_kernel(_state(cfg, 1, device="cuda"))
    state = state + (state[4][:, None].clone(), state[5].clone())
    kw = dict(seed=1, iteration=0, iters=21, sync_every=8, block_n=512)
    off = pso_step.fused_async(*[x.clone() for x in state], spec, **kw)
    on, got = _card_counts(state, spec, pso_step.fused_async, **kw)
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    want = zero_counts(device="cuda")
    pso_step.fused_async_plain(*state, spec, counts=want, **kw)
    assert got == _counts(want)
    cfg = _cfg("rastrigin", 120, 4096)
    state = ops.state_to_kernel(_state(cfg, 2, device="cuda"))
    state = state + (state[4][:, None].repeat(1, 8), state[5].repeat(8))
    _, got = _card_counts(state, ops.kernel_spec(cfg), pso_step.fused_async,
                          **dict(kw, iters=24))
    _invariants(got, 24, 8, sync=False, chunks=3)


@pytest.mark.gpu
def test_kernel_history_on_card(cuda):
    """Fused: history on equals history off bit for bit, one sample an
    iteration; async: ceil(iters / sync_every) samples, the last one the
    result's gbest."""
    kw = dict(dim=10, particles=2048, iters=30, seed=2, block_n=512)
    on = repro_torch.solve("rastrigin", variant="queue_lock",
                           record_history=True, telemetry=True, **kw)
    off = repro_torch.solve("rastrigin", variant="queue_lock", **kw)
    assert torch.equal(on.state.pos, off.state.pos)
    assert torch.equal(on.state.pbest_fit, off.state.pbest_fit)
    assert len(on.history) == 30 and on.history.gbest_fit[-1] == on.gbest_fit
    ra = repro_torch.solve("rastrigin", variant="async", sync_every=8,
                           record_history=True, telemetry=True, **kw)
    assert list(ra.history.iteration) == [8, 16, 24, 30]
    assert ra.history.gbest_fit[-1] == ra.gbest_fit
