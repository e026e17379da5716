"""bfloat16 swarms on the kernel backend: the plain versions of rows 1, 2,
3, 5 and 6 (the queue kernel, the fused queue-lock, the batched fused, the
async queue-lock and the batched async) against the reference's Pallas
kernels in interpret mode at ``dtype=bfloat16``, step by step from a
shared state; ``solve``/``solve_many``, serving and the autotuner in
bfloat16; and what the kernels refuse.

The tolerance is ROADMAP's bfloat16 parity contract. The reference's
kernels compute in bfloat16 by rounding every operation's result to
bfloat16, each weak-typed Python constant rounded first, the draws as
``(h >> 8)`` rounded to bfloat16 times 2**-24, and an objective's sum over
D accumulated in float32 in dimension order and rounded once. The plain
versions compute the same roundings in the same order, so on the CPU they
agree with the interpret-mode kernels bit for bit, and this file holds
them to that (``torch.equal`` on the bfloat16 tensors). Griewank is the
exception the contract names: the reference's kernel cannot run it in
bfloat16 (its float32 dimension column promotes the fitness, which the
bfloat16 pbest cannot store), so the port's form is held to the
reference's expression evaluated outside the kernel and rounded once.

The fused queue-lock with several blocks is synchronous PPSO in the port
and a sequential grid in the reference, as in float32, so rows 2 and 3
compare one block a swarm; the async rows compare two blocks (the plain
versions run the reference's block-major order). Sizes are small: n 128 or
256, d 1, 3 or 8, batches of 8."""
import math

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import multi_swarm as ms
from repro_torch.core import pso
from repro_torch.core.topology import block_neighbor_best
from repro_torch.kernels import ops, pso_step
from repro_torch.launch.serve import SolveRequest, SolveServer
from repro_torch.serving import ContinuousScheduler

try:
    import jax.numpy as jnp

    import repro
    from repro.core import multi_swarm as jms
    from repro.core import pso as jpso
    from repro.core.update_rules import resolve_rule as jrule
    from repro.kernels import ops as jops
    from repro.kernels import pso_step as jstep
    from repro.launch.serve import SolveRequest as JRequest
    from repro.launch.serve import SolveServer as JServer
    from repro.serving import ContinuousScheduler as JScheduler
except ModuleNotFoundError:     # a CUDA host may have no JAX installed
    jnp = repro = None

torch.set_num_threads(1)

BF = torch.bfloat16
CPU = "cpu"
#: The objectives the reference's kernels run in bfloat16 (griewank: see
#: the module docstring).
FITS = ("cubic", "sphere", "rosenbrock", "rastrigin", "ackley")
RULES = ("pso", "sso", "lowcost")
ROWS = ("queue", "fused", "fused_batch", "async", "async_batch")
#: Coefficients that bfloat16 does not hold exactly, so that a constant
#: left unrounded shows.
COEF = dict(w=0.7, c1=1.4, c2=1.6)


@pytest.fixture
def reference():
    if repro is None:
        pytest.skip("needs the JAX reference package `repro`, and JAX is "
                    "not installed")


def _t(x) -> torch.Tensor:
    """A reference array as a torch tensor of its dtype (bfloat16 through
    float32, which holds it exactly)."""
    a = jnp.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(BF)
    return torch.from_numpy(np.array(a))


def _port(js) -> pso.SwarmState:
    """A reference state as the port's, on the CPU, in bfloat16."""
    kw = {k: (None if getattr(js, k) is None else _t(getattr(js, k)))
          for k in ("pos", "vel", "fit", "pbest_pos", "pbest_fit",
                    "gbest_pos", "gbest_fit", "lbest_pos", "lbest_fit")}
    return pso.SwarmState(iteration=int(js.iteration), seed=int(js.seed),
                          **kw)


def _same(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        b = b.reshape(a.shape)
        assert a.dtype == b.dtype == BF, (what, i, a.dtype, b.dtype)
        assert torch.equal(a, b), (what, i, int((a != b).sum()))


def _cfgs(fit, rule, d, n, **kw):
    kw = dict(dim=d, particle_cnt=n, fitness=fit, update_rule=rule,
              dtype="bfloat16", **COEF, **kw)
    return jpso.PSOConfig(**kw).resolved(), pso.PSOConfig(**kw).resolved()


def _dmajor(s):
    """A port state's D-major operands (pos, vel, pbp, pbf, gp, gf)."""
    return ops.state_to_kernel(s)


_CASES = [(row, fit, rule, (1, 3, 8)[i % 3])
          for i, (row, fit, rule) in enumerate(
              (r, f, u) for r in ROWS for f in FITS for u in RULES)]


@pytest.mark.parametrize("row,fit,rule,d", _CASES)
def test_plain_rows_match_reference_kernels_bf16(row, fit, rule, d,
                                                 reference):
    """Each row's plain version against the reference's kernel in
    interpret mode, from a shared bfloat16 state, bit for bit."""
    n = 128
    jc, tc = _cfgs(fit, rule, d, n)
    spec = ops.kernel_spec(tc)
    if row in ("queue", "fused"):
        js = jpso.init_swarm(jc, 3)
        for _ in range(2):                  # two steps, each from the last
            s = _port(js)
            if row == "queue":
                want = jops.queue_step(jc, js, block_n=64, interpret=True)
                got = _dmajor(ops.queue_step(tc, s, block_n=64))
            else:
                want = jops.run_queue_lock_fused(jc, js, 1, block_n=n,
                                                 interpret=True)
                got = pso_step.fused_plain(*_dmajor(s), spec, seed=s.seed,
                                           iteration=s.iteration, iters=1,
                                           block_n=n)
            _same(got, _dmajor(_port(want)), f"{row} {fit}/{rule} d={d}")
            js = want
    elif row == "async":
        js = jpso.init_swarm(jc, 4)
        want = jops.run_queue_lock_fused_async(jc, js, 5, sync_every=2,
                                               block_n=64, interpret=True)
        s = _port(js)
        st = _dmajor(s)
        got = pso_step.fused_async_plain(
            *st, st[4][:, None].repeat(1, 2), st[5].repeat(2), spec,
            seed=s.seed, iteration=0, iters=5, sync_every=2, block_n=64)
        w = _port(want)
        _same(got, _dmajor(w) + (ops.pack_dmajor(w.lbest_pos), w.lbest_fit),
              f"async {fit}/{rule} d={d}")
    else:
        seeds = [0, 1, 7, 42, 99, 123, 100000, 2 ** 31 - 5]
        jb = jms.init_batch(jc, seeds)
        jb = jb._replace(iteration=jnp.arange(8, dtype=jnp.int32) * 3)
        b = ms.stack_states([_port(jms.batch_row(jb, k)) for k in range(8)])
        st = [ops.pack_dmajor_batch(b.pos), ops.pack_dmajor_batch(b.vel),
              ops.pack_dmajor_batch(b.pbest_pos), b.pbest_fit.reshape(-1),
              ops.pack_dmajor(b.gbest_pos), b.gbest_fit]
        if row == "fused_batch":
            want = jops.run_queue_lock_fused_batch(jc, jb, 3, block_n=n,
                                                   interpret=True)
            got = pso_step.fused_batch_plain(*st, b.seed, b.iteration,
                                             (spec,), iters=3, block_n=n)
        else:
            want = jops.run_queue_lock_fused_async_batch(
                jc, jb, 5, sync_every=2, block_n=64, interpret=True)
            got = pso_step.fused_async_batch_plain(
                *st, st[4].repeat_interleave(2, 1),
                st[5].repeat_interleave(2), b.seed, b.iteration, (spec,),
                iters=5, sync_every=2, block_n=64)
        wb = ms.stack_states([_port(jms.batch_row(want, k))
                              for k in range(8)])
        wst = [ops.pack_dmajor_batch(wb.pos), ops.pack_dmajor_batch(wb.vel),
               ops.pack_dmajor_batch(wb.pbest_pos), wb.pbest_fit.reshape(-1),
               ops.pack_dmajor(wb.gbest_pos), wb.gbest_fit]
        if row == "async_batch":
            wst += [ops.pack_dmajor_batch(wb.lbest_pos),
                    wb.lbest_fit.reshape(-1)]
        _same(got, wst, f"{row} {fit}/{rule} d={d}")


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("d", [1, 3, 8])
def test_griewank_bf16_is_the_reference_expression(rule, d, reference):
    """The reference's kernel refuses griewank in bfloat16; the port's
    advance and objective equal the reference kernel's own advance
    (``_advance_block``, eager) and its ``_fitness_dmajor`` form rounded
    once to bfloat16, bit for bit."""
    n = 128
    jc, tc = _cfgs("griewank", rule, d, n)
    js = jpso.init_swarm(jc, 3)
    with pytest.raises(Exception):
        jops.run_queue_lock_fused(jc, js, 1, block_n=n, interpret=True)
    spec = ops.kernel_spec(tc)
    s = _port(js)
    pos, vel, pbp, _, gp, _ = _dmajor(s)
    dpad = jstep.pad_dim(d)

    def padded(x):
        a = np.zeros((dpad, x.shape[1]), np.float32)
        a[:d] = x.float().numpy()
        return jnp.asarray(a, jnp.bfloat16)

    jpos, jvel, dmask, _ = jstep._advance_block(
        s.seed, 1, padded(pos), padded(vel), padded(pbp), padded(gp[:, None]),
        0, w=jc.w, c1=jc.c1, c2=jc.c2, min_pos=jc.min_pos, max_pos=jc.max_pos,
        max_v=jc.max_v, d_real=d, rule=jrule(rule))
    jfit = jstep._fitness_dmajor("griewank", jpos, dmask, d)
    got = pso_step._advance(spec, pso_step._rule_operands(spec, CPU, BF),
                            s.seed, 1, pos, vel, pbp, gp[:, None],
                            pso_step._rng_index(n, d, CPU))
    _same(got, (_t(jpos)[:d], _t(jvel)[:d],
                _t(jnp.asarray(jfit).astype(jnp.bfloat16))[0]),
          f"griewank {rule} d={d}")


@pytest.mark.parametrize("row", ["fused", "async_one_block", "async"])
def test_counters_match_reference_bf16(row, reference):
    """The plain versions' contention counts in bfloat16 equal the
    reference kernels' telemetry twins'."""
    n = 128
    jc, tc = _cfgs("rastrigin", "pso", 3, n)
    spec = ops.kernel_spec(tc)
    js = jpso.init_swarm(jc, 6)
    s = _port(js)
    st = _dmajor(s)
    cnt = torch.zeros(3, dtype=torch.int32)
    if row == "fused":
        _, want = jops.run_queue_lock_fused(jc, js, 6, block_n=n,
                                            interpret=True, telemetry=True)
        pso_step.fused_plain(*st, spec, seed=s.seed, iteration=0, iters=6,
                             block_n=n, counts=cnt)
    else:
        bn = n if row == "async_one_block" else 64
        nb = n // bn
        _, want = jops.run_queue_lock_fused_async(
            jc, js, 7, sync_every=3, block_n=bn, interpret=True,
            telemetry=True)
        pso_step.fused_async_plain(
            *st, st[4][:, None].repeat(1, nb), st[5].repeat(nb), spec,
            seed=s.seed, iteration=0, iters=7, sync_every=3, block_n=bn,
            counts=cnt)
    assert cnt.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("topology", ["ring", "vonneumann"])
def test_lbest_matches_reference_bf16(topology, reference):
    """The async plain version under an lbest topology, four blocks,
    against the reference's kernel (block-major) bit for bit."""
    n, bn = 256, 64
    jc, tc = _cfgs("sphere", "pso", 3, n, topology=topology)
    spec = ops.kernel_spec(tc)
    js = jpso.init_swarm(jc, 9)
    want = _port(jops.run_queue_lock_fused_async(jc, js, 6, sync_every=2,
                                                 block_n=bn, interpret=True))
    s = _port(js)
    st = _dmajor(s)
    got = pso_step.fused_async_plain(
        *st, st[4][:, None].repeat(1, 4), st[5].repeat(4), spec,
        seed=s.seed, iteration=0, iters=6, sync_every=2, block_n=bn,
        topology=topology)
    _same(got, _dmajor(want) + (ops.pack_dmajor(want.lbest_pos),
                              want.lbest_fit), f"lbest {topology}")


# --- the facade --------------------------------------------------------------

def _solves(fit, variant, iters, topology="gbest", **kw):
    """The reference's and the port's kernel-backend solve, bfloat16."""
    n = 128 if variant == "queue_lock" else 256
    args = dict(dim=3, particles=n, iters=iters, seed=2, dtype="bfloat16",
                **kw)
    m = dict(variant=variant, backend="kernel", topology=topology,
             sync_every=2, block_n=128)
    jr = repro.solve(fit, method=repro.Method(**m), **args)
    tr = repro_torch.solve(fit, method=repro_torch.Method(**m), device=CPU,
                           **args)
    return jr, tr


@pytest.mark.parametrize("fit", FITS)
@pytest.mark.parametrize("variant,topology", [("queue_lock", "gbest"),
                                              ("async", "gbest"),
                                              ("async", "ring")])
def test_solve_bf16_kernel_backend_matches_reference(fit, variant, topology,
                                                     reference):
    """``solve(..., dtype="bfloat16", backend="kernel")`` over 6
    iterations (queue_lock one block, async two): the reference's state
    bit for bit, a bfloat16 state."""
    jr, tr = _solves(fit, variant, 6, topology)
    assert tr.state.pos.dtype == BF and tr.state.gbest_fit.dtype == BF
    assert tr.best_fit == jr.best_fit
    assert torch.equal(tr.state.pos, _t(jr.state.pos))
    assert torch.equal(tr.state.pbest_fit, _t(jr.state.pbest_fit))
    np.testing.assert_array_equal(
        tr.best_pos, np.asarray(jnp.asarray(jr.best_pos, jnp.float32)))


@pytest.mark.parametrize("variant", ["queue_lock", "async"])
@pytest.mark.parametrize("fit", ["cubic", "griewank", "ackley"])
def test_solve_bf16_invariants_over_40(fit, variant):
    """40 iterations on the kernel backend in bfloat16: a bfloat16 state
    in the box, gbest monotone over its history, == max(pbest), and the
    objective of gbest_pos equal to gbest_fit in the kernels' arithmetic
    (``pso_step._objective_bf16``)."""
    r = repro_torch.solve(fit, dim=3, particles=256, iters=40, seed=1,
                          variant=variant, backend="kernel", sync_every=4,
                          block_n=128, dtype="bfloat16", record_history=True,
                          device=CPU)
    s, cfg = r.state, r.config
    assert s.pos.dtype == BF
    assert bool(((s.pos >= cfg.min_pos) & (s.pos <= cfg.max_pos)).all())
    hist = r.history.gbest_fit
    assert np.all(np.diff(hist) >= 0) and len(hist) > 1
    assert float(s.gbest_fit) == float(s.pbest_fit.max()) == hist[-1]
    fid = ops.kernel_spec(cfg).fitness
    assert torch.equal(pso_step._objective_bf16(fid, s.gbest_pos[:, None]),
                       s.gbest_fit.reshape(1))


@pytest.mark.parametrize("variant", ["queue_lock", "async"])
def test_solve_many_bf16_matches_reference(variant, reference):
    """A homogeneous ``solve_many`` of 8 seeds in bfloat16 on the kernel
    backend: every row the reference's bit for bit."""
    kw = dict(dim=3, particles=128, iters=6, variant=variant,
              backend="kernel", sync_every=2, block_n=128 if variant ==
              "queue_lock" else 64, dtype="bfloat16")
    seeds = [0, 1, 7, 42, 99, 123, 100000, 5]
    jrs = repro.solve_many("rastrigin", seeds, **kw)
    trs = repro_torch.solve_many("rastrigin", seeds, device=CPU, **kw)
    for jr, tr in zip(jrs, trs):
        assert tr.state.pos.dtype == BF
        assert tr.best_fit == jr.best_fit
        assert torch.equal(tr.state.pos, _t(jr.state.pos))


# --- refusals ----------------------------------------------------------------

def test_hetero_bf16_raises_in_both(reference):
    """A heterogeneous bfloat16 batch: the reference fails, the port
    raises ValueError with the reason (on the kernel backend and eager)."""
    kw = dict(problems=["cubic", "sphere"], seeds=range(2), dim=3,
              particles=128, iters=2, variant="async", dtype="bfloat16")
    with pytest.raises(Exception):
        repro.solve_many(backend="kernel", **kw)
    for backend in ("kernel", "eager"):
        with pytest.raises(ValueError, match="float32"):
            repro_torch.solve_many(backend=backend, device=CPU, **kw)


@pytest.mark.parametrize("variant", ["queue_lock", "async"])
def test_float16_and_float64_raise_on_kernel_backend(variant):
    kw = dict(dim=3, particles=128, iters=2, variant=variant,
              backend="kernel", device=CPU)
    with pytest.raises(ValueError, match="overflows"):
        repro_torch.solve("cubic", dtype="float16", **kw)
    with pytest.raises(ValueError, match="float32"):
        repro_torch.solve("cubic", dtype="float64", **kw)


def test_custom_problem_bf16_runs_on_kernel_backend():
    """The split kernels take bfloat16: a custom Problem in bfloat16 runs
    on the kernel backend, with a bfloat16 state, and one block a swarm
    equals the eager engine bit for bit, as in float32."""
    mine = pso.Problem(name="mine_bf16", fn=lambda x: -(x * x).sum(-1),
                       lo=-5.0, hi=5.0)
    kw = dict(dim=3, particles=128, iters=4, variant="queue_lock",
              dtype="bfloat16", device=CPU)
    got = repro_torch.solve(mine, backend="kernel", block_n=128, **kw)
    want = repro_torch.solve(mine, backend="eager", **kw)
    assert got.state.pos.dtype == want.state.pos.dtype == BF
    assert torch.equal(got.state.pos, want.state.pos)
    assert got.best_fit == want.best_fit


def test_hetero_wrappers_refuse_bf16():
    """The batch wrappers' plain versions refuse a heterogeneous bfloat16
    batch as their kernels do."""
    cfg = pso.PSOConfig(dim=2, particle_cnt=64, dtype="bfloat16").resolved()
    b = ms.init_batch(cfg, range(2), device=CPU)
    st = [ops.pack_dmajor_batch(b.pos), ops.pack_dmajor_batch(b.vel),
          ops.pack_dmajor_batch(b.pbest_pos), b.pbest_fit.reshape(-1),
          ops.pack_dmajor(b.gbest_pos), b.gbest_fit]
    specs = (ops.kernel_spec(cfg),) * 2
    fids = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        pso_step.fused_batch(*st, b.seed, b.iteration, specs, iters=1,
                             block_n=64, fids=fids)
    with pytest.raises(ValueError, match="float32"):
        pso_step.fused_async_batch(*st, st[4], st[5], b.seed, b.iteration,
                                   specs, iters=1, sync_every=1, block_n=64,
                                   fids=fids)


# --- serving -----------------------------------------------------------------

def _requests(R, fits, variant="async"):
    return [R(dim=3, particle_cnt=128, fitness=f, seed=k, iters=16,
              variant=variant, sync_every=8, dtype="bfloat16")
            for k, f in enumerate(fits)]


@pytest.mark.parametrize("backend", ["eager", "kernel"])
def test_scheduler_runs_bf16_requests_as_reference(backend, reference):
    """``ContinuousScheduler`` with registry coalescing on: the reference
    runs bfloat16 requests, so the port does, each in a lane of its own
    problem (a heterogeneous lane has no bfloat16 form) keyed by the dtype,
    with bfloat16 lane buffers; the results are the reference
    scheduler's."""
    fits = ["cubic", "sphere", "cubic"]
    want = JScheduler().run(_requests(JRequest, fits))
    sched = ContinuousScheduler(backend=backend, device=CPU)
    got = sched.run(_requests(SolveRequest, fits))
    assert [r.ok for r in got] == [True] * 3
    assert [r.gbest_fit for r in got] == [r.gbest_fit for r in want]
    keys = list(sched._lanes)
    assert len(keys) == 2 and all("bfloat16" in k for k in keys)
    for lane in sched._lanes.values():
        assert "|bfloat16|" in lane.program_key()
        if backend == "kernel":
            assert isinstance(lane.program, ops.AsyncLane)
            assert all(t.dtype == BF for t in lane.program.state)


@pytest.mark.parametrize("coalesce", [False, True])
def test_server_runs_bf16_requests_where_reference_does(coalesce, reference):
    """``SolveServer`` on the kernel backend: without coalescing, bfloat16
    groups run and equal the reference server's results; with it, the
    reference's heterogeneous group fails, and the port's fails alike, a
    ValueError's reason in each result."""
    fits = ["cubic", "sphere", "rastrigin"]
    for variant in ("queue_lock", "async"):
        js = JServer(backend="kernel", coalesce_registry=coalesce)
        ts = SolveServer(backend="kernel", coalesce_registry=coalesce,
                         device=CPU)
        jt = [js.submit(r) for r in _requests(JRequest, fits, variant)]
        tt = [ts.submit(r) for r in _requests(SolveRequest, fits, variant)]
        jd, td = js.flush(), ts.flush()
        want, got = [jd[t] for t in jt], [td[t] for t in tt]
        assert [r.ok for r in got] == [r.ok for r in want] == \
            [not coalesce] * 3
        if coalesce:
            assert all("float32" in str(r.error) for r in got)
        else:
            assert [r.gbest_fit for r in got] == [r.gbest_fit for r in want]


# --- the autotuner -----------------------------------------------------------

def test_resolve_schedule_bf16_prices_and_measures_bf16(tmp_path,
                                                        monkeypatch):
    """``resolve_schedule(dtype="bfloat16")`` prices every candidate at
    ``DTYPE_BYTES["bfloat16"]`` and measures the kernel candidates on
    bfloat16 operands (their plain versions here), where a float32-only
    kernel path would raise."""
    from repro_torch.core import autotune as at
    from repro_torch.roofline import pso_cost
    seen = []
    orig = (ops.run_queue_lock_fused, ops.run_queue_lock_fused_async)

    def spy(fn):
        def run(cfg, state, *a, **kw):
            seen.append((cfg.dtype, state.pos.dtype))
            return fn(cfg, state, *a, **kw)
        return run

    monkeypatch.setattr(ops, "run_queue_lock_fused", spy(orig[0]))
    monkeypatch.setattr(ops, "run_queue_lock_fused_async", spy(orig[1]))
    cache = at.AutotuneCache(str(tmp_path / "tune.json"))
    got = at.resolve_schedule("cubic", 4, 128, 16, dtype="bfloat16",
                              kernel_ok=True, cache=cache, top_k=64,
                              device=CPU)
    assert got.source == "measured" and seen
    assert set(seen) == {("bfloat16", BF)}
    # the model's ranking (no run) at a solve cell: its bytes at 2 an
    # element
    d, n = 120, 32768
    cands = at.candidate_schedules(d, n, 200, kernel_ok=True)
    ranked = at.rank_schedules(cands, "cubic", d, n, 200, dtype="bfloat16",
                               device=CPU)
    kern = [s for s in ranked if s.backend == "kernel"]
    assert kern
    for s in kern:
        calib = pso_cost.default_calibration(torch.device(CPU), s.backend)
        kw = dict(backend=s.backend, block_n=s.block_n,
                  sync_every=s.sync_every, calib=calib)
        assert s.predicted_us == pso_cost.estimate_us_per_iter(
            s.variant, "cubic", d, n, dtype="bfloat16", **kw)
        cost = {dt: pso_cost.iteration_cost(
            s.variant, "cubic", d, n, dtype=dt, backend=s.backend,
            block_n=s.block_n, sync_every=s.sync_every)
            for dt in ("bfloat16", "float32")}
        assert 2 * cost["bfloat16"].bytes_hbm == cost["float32"].bytes_hbm
    assert pso_cost.DTYPE_BYTES["bfloat16"] == 2


def test_kernel_candidates_follow_the_dtype_on_a_card():
    """Kernel candidates exist where the kernels take the dtype: float32
    and bfloat16, for every homogeneous Problem (a custom one takes the
    split path)."""
    from repro_torch.core import autotune as at
    card = torch.device("cuda")
    assert at._kernel_ok(card, "pso", "float32")
    assert at._kernel_ok(card, "pso", "bfloat16")
    assert not at._kernel_ok(card, "pso", "float16")
    assert not at._kernel_ok(torch.device(CPU), "pso", "bfloat16")


# --- the weak-typed constants and the draws ----------------------------------

def test_bf16_draw_rounds_to_nearest_even_and_may_be_one():
    """``(h >> 8)`` rounded to bfloat16 (to nearest, ties to even) times
    2**-24: a 24-bit value at the top rounds up to 2**24, so a draw is
    1.0; 2**23 + 2**15 and 2**23 + 3 * 2**15 are ties (spacing 2**16)."""
    from repro_torch.core import rng
    h = torch.tensor([(1 << 24) - 1, (1 << 23) + (1 << 15),
                      (1 << 23) + 3 * (1 << 15)], dtype=torch.int64)
    got = (h.to(BF) * (1.0 / (1 << 24))).tolist()
    assert got == [1.0, 0.5, 0.5078125]
    idx = torch.arange(1 << 16, dtype=torch.int64)
    u = rng.uniform(1, 2, 3, idx, dtype=BF)
    ref = (rng.hash_u32(1, 2, 3, idx) >> 8).to(torch.float32)
    assert torch.equal(u, (ref.to(BF) * (1.0 / (1 << 24))))
    assert float(u.max()) <= 1.0


def test_weak_constants_round_in_bf16_only():
    from repro_torch.core.fitness import weak
    assert weak(0.8, torch.float32) == 0.8
    assert weak(0.8, BF) == 0.80078125
    assert weak(2.0 * math.pi, BF) == 6.28125
    assert weak(3, torch.float32) == 3
    t = torch.ones(2)
    assert weak(t, BF) is t


# --- the fused and async kernels' two bfloat16 paths -------------------------
# ``pso_step.kernel_lanes`` picks, by shape and alignment alone, the pair
# path (two particles a thread on packed bfloat16 arithmetic) or the lane
# path (a particle a thread); both compute the plain versions' bits.

def _operands(n, s_cnt=1, d=3, dtype=BF, shift=()):
    """pos, vel, pbp [D, S*N] and pbf [S*N] of ``dtype``; the tensors
    named in ``shift`` start one element (2 bytes in bfloat16) past a
    4-byte boundary."""
    out = []
    for name, shape in (("pos", (d, s_cnt * n)), ("vel", (d, s_cnt * n)),
                        ("pbp", (d, s_cnt * n)), ("pbf", (s_cnt * n,))):
        size = math.prod(shape)
        buf = torch.zeros(size + 2, dtype=dtype)
        k = 1 if name in shift else 0
        out.append(buf[k:k + size].view(shape))
    return out


@pytest.mark.parametrize("n,block_n,s_cnt,want", [
    (1024, 512, 1, 2),          # even blocks: pairs
    (1024, 1024, 1, 2),         # one block of more than 512
    (1024, 512, 4, 2),          # a batch of even swarms
    (128, 8, 1, 2),             # even blocks below four pairs: pairs,
    (128, 2, 1, 2),             # which an lbest fold takes too (it reads
    (128, 4, 1, 2),             # its neighbours strided over the CTA's
    (128, 6, 1, 2),             # threads)
    (1023, 341, 1, 1),          # odd block_n (and n)
    (1023, 1023, 1, 1),         # one odd block
    (341, 341, 4, 1),           # S > 1 with an odd n: odd columns
    (6, 3, 2, 1),               # odd block_n in an even swarm
])
def test_kernel_lanes_by_shape(n, block_n, s_cnt, want):
    ops_ = _operands(n, s_cnt)
    assert pso_step.kernel_lanes(*ops_, n=n, block_n=block_n) == want


@pytest.mark.parametrize("shifted", ["pos", "vel", "pbp", "pbf"])
def test_kernel_lanes_by_alignment(shifted):
    """An operand that starts 2 bytes past a 4-byte boundary takes the lane
    path; the same shape aligned takes pairs."""
    ops_ = _operands(1024, shift=(shifted,))
    assert ops_[["pos", "vel", "pbp", "pbf"].index(shifted)].data_ptr() % 4
    assert pso_step.kernel_lanes(*ops_, n=1024, block_n=512) == 1
    assert pso_step.kernel_lanes(*_operands(1024), n=1024, block_n=512) == 2


def test_kernel_lanes_float32_is_one_lane():
    assert pso_step.kernel_lanes(*_operands(1024, dtype=torch.float32),
                                 n=1024, block_n=512) == 1


def test_lane_launches_count_bf16_lane_path_only():
    """``count``: bfloat16 launches on the lane path also count in
    ``bf16_lane_launches``; pair-path and float32 launches do not."""
    w = pso_step.fused_async_batch
    before = (w.launches, w.bf16_launches, w.bf16_lane_launches)
    pso_step.count(w, BF, 2, 1)
    pso_step.count(w, BF, 3, 2)
    pso_step.count(w, torch.float32, 4, 1)
    after = (w.launches, w.bf16_launches, w.bf16_lane_launches)
    assert [a - b for a, b in zip(after, before)] == [9, 5, 2]


@pytest.mark.parametrize("shift", [(), ("pos", "pbf")])
def test_plain_versions_ignore_the_path(shift):
    """On the CPU the wrappers run the plain version whatever the path:
    operands off 4 bytes give the aligned ones' bits."""
    cfg = pso.PSOConfig(dim=3, particle_cnt=256, fitness="rastrigin",
                        dtype="bfloat16").resolved()
    s = pso.init_swarm(cfg, 4, device=CPU)
    spec, state = ops.kernel_spec(cfg), ops.state_to_kernel(s)
    moved = [x.clone() for x in state]
    odd = _operands(256, shift=shift)
    for dst, src in zip(odd, moved[:4]):
        dst.copy_(src)
    moved[:4] = odd
    kw = dict(seed=s.seed, iteration=2, iters=3, block_n=128)
    want = pso_step.fused(*[x.clone() for x in state], spec, **kw)
    got = pso_step.fused(*moved, spec, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shift", [(), ("vel",), ("pbf",)])
def test_queue_step_plain_ignores_the_path(shift):
    """The queue step routes by ``kernel_lanes`` on the card only: on the
    CPU it runs the plain version whatever the path, counts no launch,
    and operands off 4 bytes give the aligned ones' bits."""
    cfg = pso.PSOConfig(dim=3, particle_cnt=256, fitness="ackley",
                        dtype="bfloat16").resolved()
    s = pso.init_swarm(cfg, 6, device=CPU)
    spec, state = ops.kernel_spec(cfg), ops.state_to_kernel(s)
    odd = _operands(256, shift=shift)
    for dst, src in zip(odd, state[:4]):
        dst.copy_(src)
    want_lanes = 1 if shift else pso_step.PAIR
    assert pso_step.kernel_lanes(*odd, n=256, block_n=64) == want_lanes
    kw = dict(seed=s.seed, iteration=5, block_n=64)
    before = (pso_step.queue_step.launches,
              pso_step.queue_step.bf16_lane_launches)
    got = pso_step.queue_step(*odd, state[4], state[5], spec, **kw)
    want = pso_step.queue_plain(*state, spec, **kw)
    assert (pso_step.queue_step.launches,
            pso_step.queue_step.bf16_lane_launches) == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.fixture
def cuda():
    """The card, decided inside the test so every worker collects alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100 with "
                    "`python -m pytest -m gpu tests/test_torch_bf16.py`")
    return torch.device("cuda")


def _card_state(cuda, fit, rule, d, n, seed=3):
    cfg = pso.PSOConfig(dim=d, particle_cnt=n, fitness=fit,
                        update_rule=rule, dtype="bfloat16").resolved()
    s = pso.init_swarm(cfg, seed, device=cuda)
    return ops.kernel_spec(cfg), list(ops.state_to_kernel(s)), s.seed


def _lane_copy(state):
    """A copy of a kernel state whose pos, vel, pbp and pbf start 2 bytes
    past a 4-byte boundary: the lane path at any shape."""
    out = []
    for k, t in enumerate(state):
        if k < 4:
            buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
            t = buf[1:].view(t.shape).copy_(t)
        else:
            t = t.clone()
        out.append(t)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("fit", FITS + ("griewank",))
@pytest.mark.parametrize("d,n,bn", [(8, 1024, 512), (37, 1024, 512),
                                    (120, 128, 128)])
def test_bf16_pair_and_lane_paths_agree_on_card(cuda, fit, rule, d, n, bn):
    """One CTA a block (d=8), clusters of 2 (d=37) and of 8 (d=120, one
    block): a fused launch of three iterations, counters on, on the pair
    path and on the lane path bit for bit, counts too; at one CTA both are
    the plain version's bits; with one block the async kernel on each path
    equals the fused kernel."""
    spec, state, seed = _card_state(cuda, fit, rule, d, n)
    kw = dict(seed=seed, iteration=4, iters=3, block_n=bn)
    assert pso_step.kernel_lanes(*state[:4], n=n, block_n=bn) == 2
    c1, c2 = (torch.zeros(3, dtype=torch.int32, device=cuda)
              for _ in range(2))
    lanes = pso_step.fused.bf16_lane_launches
    pair = pso_step.fused(*[x.clone() for x in state], spec, counts=c1, **kw)
    lane = pso_step.fused(*_lane_copy(state), spec, counts=c2, **kw)
    torch.cuda.synchronize()
    assert pso_step.fused.bf16_lane_launches == lanes + 1
    for a, b in zip(pair, lane):
        assert torch.equal(a, b)
    assert torch.equal(c1, c2)
    if pso_step._cluster(n, d, bn, cuda, dtype=BF) == 1:
        want = pso_step.fused_plain(*state, spec, **kw)
        for a, b in zip(pair, want):
            assert torch.equal(a, b)
    if n == bn:
        loc = [state[4][:, None].clone(), state[5].clone()]
        for st in ([x.clone() for x in state] + loc,
                   _lane_copy(state) + [x.clone() for x in loc]):
            got = pso_step.fused_async(*st, spec, sync_every=1, **kw)
            torch.cuda.synchronize()
            for a, b in zip(got[:6], pair):
                assert torch.equal(a, b)


def _queue_on(state, spec, kw):
    """One queue step of ``state`` (its pos/vel/pbp/pbf updated in place)
    against its gbest: the step's six outputs."""
    return pso_step.queue_step(*state[:4], state[4], state[5], spec, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("fit", FITS + ("griewank",))
@pytest.mark.parametrize("d,n,bn", [(8, 1024, 512), (37, 1024, 512)])
def test_bf16_queue_pair_and_lane_paths_agree_on_card(cuda, fit, rule, d, n,
                                                      bn):
    """The queue kernel's pair path (``queue_pair_kernel``) against its
    lane path (``lane_copy``) bit for bit, aux_fit and aux_idx (first lane
    on ties) too: one CTA a block (d=8, also the plain version's bits) and
    clusters of 2 (d=37)."""
    spec, state, seed = _card_state(cuda, fit, rule, d, n)
    kw = dict(seed=seed, iteration=4, block_n=bn)
    assert pso_step.kernel_lanes(*state[:4], n=n, block_n=bn) == 2
    lanes = pso_step.queue_step.bf16_lane_launches
    bf16 = pso_step.queue_step.bf16_launches
    pair = _queue_on([x.clone() for x in state], spec, kw)
    torch.cuda.synchronize()
    assert pso_step.queue_step.bf16_lane_launches == lanes
    lane = _queue_on(_lane_copy(state), spec, kw)
    torch.cuda.synchronize()
    assert pso_step.queue_step.bf16_lane_launches == lanes + 1
    assert pso_step.queue_step.bf16_launches == bf16 + 2
    for a, b in zip(pair, lane):
        assert torch.equal(a, b)
    if pso_step._cluster(n, d, bn, cuda, dtype=BF) == 1:
        want = pso_step.queue_plain(*state, spec, **kw)
        for a, b in zip(pair, want):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("rule", RULES)
def test_bf16_queue_lane_path_by_shape_on_card(cuda, rule):
    """Odd blocks (n=1023 in blocks of 341) and misaligned operands take
    the queue kernel's lane path, bit for bit the plain version."""
    spec, state, seed = _card_state(cuda, "rastrigin", rule, 8, 1023)
    kw = dict(seed=seed, iteration=2, block_n=341)
    assert pso_step.kernel_lanes(*state[:4], n=1023, block_n=341) == 1
    lanes = pso_step.queue_step.bf16_lane_launches
    got = _queue_on([x.clone() for x in state], spec, kw)
    want = pso_step.queue_plain(*state, spec, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    spec, state, seed = _card_state(cuda, "sphere", rule, 8, 1024)
    kw = dict(seed=seed, iteration=2, block_n=512)
    got = _queue_on(_lane_copy(state), spec, kw)
    want = pso_step.queue_plain(*state, spec, **kw)
    torch.cuda.synchronize()
    assert pso_step.queue_step.bf16_lane_launches == lanes + 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("rule", RULES)
def test_bf16_lane_path_by_shape_on_card(cuda, rule):
    """Shapes that force the lane path, bit for bit the plain versions:
    odd blocks (n=1023 in blocks of 341 on one CTA each, fused and, with
    one block of 341 at d=37 on a cluster of 2, async against fused) and a
    batch of S=4 swarms of an odd n=341."""
    spec, state, seed = _card_state(cuda, "rastrigin", rule, 8, 1023)
    kw = dict(seed=seed, iteration=1, iters=3, block_n=341)
    assert pso_step.kernel_lanes(*state[:4], n=1023, block_n=341) == 1
    lanes = pso_step.fused.bf16_lane_launches
    got = pso_step.fused(*[x.clone() for x in state], spec, **kw)
    want = pso_step.fused_plain(*state, spec, **kw)
    torch.cuda.synchronize()
    assert pso_step.fused.bf16_lane_launches == lanes + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    spec, state, seed = _card_state(cuda, "cubic", rule, 37, 341)
    assert pso_step._cluster(341, 37, 341, cuda, dtype=BF) == 2
    kw = dict(seed=seed, iteration=0, iters=5, block_n=341)
    fused = pso_step.fused(*[x.clone() for x in state], spec, **kw)
    loc = (state[4][:, None].clone(), state[5].clone())
    got = pso_step.fused_async(*[x.clone() for x in state], *loc, spec,
                               sync_every=2, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got[:6], fused):
        assert torch.equal(a, b)
    cfg = pso.PSOConfig(dim=10, particle_cnt=341, fitness="ackley",
                        update_rule=rule, dtype="bfloat16").resolved()
    b = ms.init_batch(cfg, range(4), device=cuda)
    specs = (ops.kernel_spec(cfg),)
    st = [ops.pack_dmajor_batch(b.pos), ops.pack_dmajor_batch(b.vel),
          ops.pack_dmajor_batch(b.pbest_pos), b.pbest_fit.reshape(-1).clone(),
          ops.pack_dmajor(b.gbest_pos), b.gbest_fit.clone()]
    assert pso_step.kernel_lanes(*st[:4], n=341, block_n=341) == 1
    kw = dict(iters=4, block_n=341)
    lanes = pso_step.fused_batch.bf16_lane_launches
    got = pso_step.fused_batch(*[x.clone() for x in st], b.seed, b.iteration,
                               specs, **kw)
    want = pso_step.fused_batch_plain(*st, b.seed, b.iteration, specs, **kw)
    torch.cuda.synchronize()
    assert pso_step.fused_batch.bf16_lane_launches == lanes + 1
    for a, w in zip(got, want):
        assert torch.equal(a, w)


#: Blocks below and just above a thread a neighbour (ring 2, von Neumann
#: 4): on the lane path (the first) they are 1-6 threads, on the pair path
#: (the second, even blocks) 1-3.
SMALL_BLOCKS = [("ring", 1), ("ring", 2), ("vonneumann", 1),
                ("vonneumann", 2), ("vonneumann", 3), ("vonneumann", 4),
                ("vonneumann", 6)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("topology,bn", SMALL_BLOCKS)
def test_bf16_lbest_small_blocks_on_card(cuda, dtype, topology, bn):
    """The async kernel's lbest fold reads the neighbours strided over the
    CTA's threads, so blocks of fewer threads than neighbours run: n/bn
    blocks (rastrigin d=3 n=48, 8 iterations at sync_every=2) end, every
    local-best slot is non-decreasing and at least its neighbourhood's best
    at launch, and gbest is max(pbest), on the lane path and (bfloat16,
    even blocks) the pair path. One block of bn: the star's kernel bit for
    bit on each path, and the plain version bit for bit in bfloat16 (in
    float32 within the topology tests' 1e-5: the plain version sums the
    objective in torch's order)."""
    cfg = pso.PSOConfig(dim=3, particle_cnt=48, fitness="rastrigin",
                        dtype=dtype).resolved()
    s = pso.init_swarm(cfg, 3, device=cuda)
    spec, state = ops.kernel_spec(cfg), list(ops.state_to_kernel(s))
    paths = [lambda st: [x.clone() for x in st]]
    if dtype == "bfloat16":
        paths.append(_lane_copy)
        assert pso_step.kernel_lanes(*state[:4], n=48, block_n=bn) == (
            2 if bn % 2 == 0 else 1)
    nb = 48 // bn
    lp = state[4][:, None].repeat(1, nb).contiguous()
    lf = state[5].repeat(nb)
    lf[torch.arange(nb, device=cuda) % 3 == 1] -= 1.0   # distinct slots
    kw = dict(seed=s.seed, iteration=0, iters=8, sync_every=2, block_n=bn,
              topology=topology)
    _, hood = block_neighbor_best(lf.clone(), lp.clone().T, topology)
    for copy in paths:
        st = copy(state) + [lp.clone(), lf.clone()]
        pso_step.fused_async(*st, spec, **kw)
        torch.cuda.synchronize()
        pbf, gf, got_lf = st[3], st[5], st[7]
        assert bool((got_lf >= lf).all())
        assert bool((got_lf >= hood).all())
        assert float(gf[0]) >= float(state[5][0])
        assert float(gf[0]) == float(pbf.max())
        one = [x[:, :bn].contiguous() if x.dim() == 2 and k < 3
               else x[:bn].clone() if k == 3 else x.clone()
               for k, x in enumerate(state)]
        loc = [one[4][:, None].clone(), one[5].clone()]
        one_kw = dict(kw, iters=6)
        got = pso_step.fused_async(*copy(one), *[x.clone() for x in loc],
                                   spec, **one_kw)
        star = pso_step.fused_async(*copy(one), *[x.clone() for x in loc],
                                    spec, **dict(one_kw, topology="gbest"))
        want = pso_step.fused_async_plain(*one, *[x.clone() for x in loc],
                                          spec, **one_kw)
        torch.cuda.synchronize()
        for a, b, c in zip(got, want, star):
            assert torch.equal(a, c)
            if dtype == "bfloat16":
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
