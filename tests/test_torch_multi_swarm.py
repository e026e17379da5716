"""repro_torch.core.multi_swarm against repro.core.multi_swarm on the CPU,
and the port's batch rows against its own single-swarm engine.

Inputs are shared as numpy arrays: S=8 swarms (the reference pads smaller
batches), n <= 128, d = 3. Tolerances: ``problem_rows`` is exact;
``init_batch`` draws (pos, vel), its gbest position and the seed and
iteration counters are exact, and fitness values agree to rtol=1e-5,
atol=1e-5 (XLA and PyTorch implement cos and exp differently). Steps are
compared one at a time from a shared batch, as in tests/test_torch_core.py
and tests/test_torch_kernels.py: positions and velocities within rtol=2e-6,
atol=max(1e-5, 1e-6 x the row's box width) (XLA:CPU contracts the velocity
chain into FMAs whose terms are of the order of the box: 200 for cubic,
1200 for griewank), fitness within rtol=1e-5, atol=1e-5; pbest
improvement masks are equal. A batch row of the port equals the
port's single-swarm ``run`` on ``batch_row`` bit for bit."""
import numpy as np
import pytest
import torch

from repro.core import multi_swarm as jms
from repro.core import pso as jpso
from repro_torch.core import multi_swarm as ms
from repro_torch.core import pso

torch.set_num_threads(1)

SEEDS = [0, 1, 7, 42, 99, 123, 100000, 2 ** 31 - 5]
MIXED = ["cubic", "sphere", "rosenbrock", "griewank", "rastrigin", "ackley",
         "cubic", "ackley"]
POS_TOL = dict(rtol=2e-6, atol=1e-5)
FIT_TOL = dict(rtol=1e-5, atol=1e-5)
COEFFS = ([0.7, 0.9, 1.0, 0.5, 0.72, 0.6, 0.8, 1.0],
          [1.5, 2.0, 1.2, 1.49, 1.0, 0.5, 2.0, 1.7],
          [1.5, 1.0, 2.0, 1.49, 0.5, 1.0, 2.0, 1.3])


def _cfgs(fit="rastrigin", d=3, n=128):
    kw = dict(dim=d, particle_cnt=n)
    if fit is not None:
        kw["fitness"] = fit
    return jpso.PSOConfig(**kw).resolved(), pso.PSOConfig(**kw).resolved()


def _rows(problems, d=3):
    jr, jt = jms.problem_rows(problems, d)
    tr, tt = ms.problem_rows(problems, d, device="cpu")
    return (jr, jt), (tr, tt)


def _to_port(jb):
    """A JAX batch as the port's, through numpy."""
    f = {k: (None if getattr(jb, k) is None else np.asarray(getattr(jb, k)))
         for k in jb._fields}
    out = {k: None if v is None else torch.as_tensor(np.array(v))
           for k, v in f.items()}
    out["iteration"] = out["iteration"].to(torch.int64)
    out["seed"] = torch.as_tensor(f["seed"].astype(np.int64))
    return ms.SwarmBatch(**out)


def _assert_batch_close(jb, tb, widths):
    """``widths``: each row's box width."""
    for f in ("pos", "vel", "pbest_pos", "gbest_pos", "lbest_pos"):
        a, b = getattr(tb, f), getattr(jb, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        for s, wd in enumerate(widths):
            np.testing.assert_allclose(
                a[s].numpy(), np.asarray(b[s]), rtol=POS_TOL["rtol"],
                atol=max(POS_TOL["atol"], 1e-6 * wd), err_msg=f"{f}[{s}]")
    for f in ("fit", "pbest_fit", "gbest_fit", "lbest_fit"):
        a, b = getattr(tb, f), getattr(jb, f)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **FIT_TOL,
                                       err_msg=f)
    assert tb.iteration.tolist() == np.asarray(jb.iteration).tolist()


def test_problem_rows_match_reference_exactly():
    (jr, jt), (tr, tt) = _rows(MIXED)
    assert [p.name for p in tt] == [p.name for p in jt]
    for f in jr._fields:
        want, got = np.asarray(getattr(jr, f)), getattr(tr, f).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert tr.swarm_cnt == 8
    assert [ms.hetero_fid(p) for p in MIXED] == [jms.hetero_fid(p)
                                                 for p in MIXED]
    assert ms.hetero_fid(lambda x: x.sum(-1)) is None
    with pytest.raises(ValueError, match="dispatch table"):
        ms.problem_rows([pso.Problem(name="mine", fn=lambda x: x.sum(-1))],
                        2, device="cpu")


@pytest.mark.parametrize("hetero", [False, True])
def test_init_batch_matches_reference(hetero):
    jc, tc = _cfgs(None if hetero else "ackley")
    if hetero:
        (jr, jt), (tr, tt) = _rows(MIXED)
        jb = jms.init_batch(jc, SEEDS, rows=jr, table=jt)
        tb = ms.init_batch(tc, SEEDS, rows=tr, table=tt, device="cpu")
    else:
        jb = jms.init_batch(jc, SEEDS)
        tb = ms.init_batch(tc, SEEDS, device="cpu")
    for f in ("pos", "vel", "pbest_pos", "gbest_pos"):
        assert np.array_equal(getattr(tb, f).numpy(),
                              np.asarray(getattr(jb, f))), f
    for f in ("fit", "pbest_fit", "gbest_fit"):
        np.testing.assert_allclose(getattr(tb, f).numpy(),
                                   np.asarray(getattr(jb, f)), **FIT_TOL)
    assert tb.seed.tolist() == np.asarray(jb.seed).astype(np.int64).tolist()
    assert tb.iteration.tolist() == [0] * 8


_RUNS = [(v, c, h) for v in ("reduction", "queue", "queue_lock", "async")
         for c, h in ((False, False), (True, False), (False, True))]
_RUNS.append(("queue_lock", True, True))


@pytest.mark.parametrize("variant,coeffs,hetero", _RUNS)
def test_run_many_matches_reference(variant, coeffs, hetero):
    """Three steps, each from the shared batch; async with sync_every=2
    and two blocks walks a publish, a remainder flush and a resume."""
    jc, tc = _cfgs(None if hetero else "rastrigin")
    kw = dict(sync_every=2, n_blocks=2)
    if coeffs:
        kw["coeffs"] = tuple(np.asarray(c, np.float32) for c in COEFFS)
    if hetero:
        (jr, jt), (tr, tt) = _rows(MIXED)
        jkw, tkw = dict(kw, rows=jr, table=jt), dict(kw, rows=tr, table=tt)
        jb = jms.init_batch(jc, SEEDS, rows=jr, table=jt)
        widths = (tr.hi - tr.lo).amax(1).tolist()
    else:
        jkw = tkw = kw
        jb = jms.init_batch(jc, SEEDS)
        widths = [tc.max_pos - tc.min_pos] * 8
    for _ in range(3):
        tb = _to_port(jb)
        jo = jms.run_many(jc, jb, 1, variant, **jkw)
        to = ms.run_many(tc, tb, 1, variant, **tkw)
        _assert_batch_close(jo, to, widths)
        assert np.array_equal(to.pbest_fit.numpy() > tb.pbest_fit.numpy(),
                              np.asarray(jo.pbest_fit)
                              > np.asarray(jb.pbest_fit))
        jb = jo


@pytest.mark.parametrize("variant", ["reduction", "queue", "queue_lock",
                                     "async"])
def test_run_many_rows_are_single_swarm_runs(variant):
    """Row s of the batch is ``pso.run`` on ``batch_row(batch, s)``, bit for
    bit, including async rows resumed at different iterations (each keeps
    its own publication schedule)."""
    _, tc = _cfgs("griewank", n=96)
    b = ms.init_batch(tc, SEEDS, device="cpu")
    b = b._replace(iteration=torch.tensor([0, 1, 2, 3, 5, 8, 13, 21]))
    kw = dict(sync_every=3, n_blocks=3)
    out = ms.run_many(tc, b, 5, variant, **kw)
    for s in range(8):
        want = pso.run(tc, ms.batch_row(b, s), 5, variant, **kw)
        row = ms.batch_row(out, s)
        for f in pso.SwarmState._fields:
            a, w = getattr(row, f), getattr(want, f)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, w), (s, f)
            else:
                assert a == w, (s, f)


def test_hetero_rows_are_member_runs():
    """A heterogeneous row is the single-swarm run of its problem with the
    bounds of ``hetero_member_config``, up to the float32 span of the
    bounds (here exact: every built-in box is symmetric)."""
    _, tc = _cfgs(None, n=64)
    rows, table = ms.problem_rows(MIXED, 3, device="cpu")
    out = ms.solve_many(pso.PSOConfig(dim=3, particle_cnt=64), SEEDS, 4,
                        "queue", problems=MIXED, device="cpu")
    for s, name in enumerate(MIXED):
        mc = pso.hetero_member_config(tc, table[int(rows.fid[s])])
        assert mc.problem.name == name
        want = pso.solve(mc, SEEDS[s], 4, "queue", device="cpu")
        row = ms.batch_row(out, s)
        for f in ("pos", "vel", "pbest_pos", "gbest_pos", "pbest_fit",
                  "gbest_fit"):
            assert torch.equal(getattr(row, f), getattr(want, f)), (name, f)


def test_solve_many_core_matches_reference_and_validates():
    jc, tc = _cfgs("sphere", n=64)
    jb = jms.solve_many(jpso.PSOConfig(dim=3, particle_cnt=64,
                                       fitness="sphere"), SEEDS, iters=2)
    tb = ms.solve_many(pso.PSOConfig(dim=3, particle_cnt=64,
                                     fitness="sphere"), SEEDS, iters=2,
                       device="cpu")
    np.testing.assert_allclose(tb.gbest_fit.numpy(), np.asarray(jb.gbest_fit),
                               rtol=1e-4, atol=1e-4)
    bf, bp, bs = ms.best_of_batch(tb)
    jf, _, js = jms.best_of_batch(jb)
    assert int(bs) == int(js) and torch.equal(bp, tb.gbest_pos[bs])
    with pytest.raises(ValueError, match="bounds"):
        ms.solve_many(pso.PSOConfig(dim=2, min_pos=-1.0, max_pos=1.0),
                      [0, 1], problems=["sphere", "cubic"], device="cpu")
    with pytest.raises(ValueError, match="problems for"):
        ms.solve_many(pso.PSOConfig(dim=2), [0, 1, 2],
                      problems=["sphere", "cubic"], device="cpu")
    with pytest.raises(ValueError, match="coeffs"):
        ms.run_many(tc, tb, 1, "queue", coeffs=([1.0], [2.0], [2.0]))


def test_stack_states_batch_row_round_trip():
    _, tc = _cfgs("cubic", n=64)
    b = ms.run_many(tc, ms.init_batch(tc, SEEDS, device="cpu"), 3, "async",
                    sync_every=2, n_blocks=2)
    rows = [ms.batch_row(b, s) for s in range(8)]
    assert rows[3].seed == 42 and rows[0].iteration == 3
    for r, o in zip(rows, ms.batch_rows(b)):
        assert (r.iteration, r.seed) == (o.iteration, o.seed)
        assert all(torch.equal(getattr(r, f), getattr(o, f))
                   for f in ("pos", "pbest_fit", "gbest_pos", "lbest_fit"))
    back = ms.stack_states(rows)
    for f, a, w in zip(ms.SwarmBatch._fields, back, b):
        assert torch.equal(a, w), f
    swapped = ms.set_batch_row(b, 2, rows[5])
    assert torch.equal(swapped.pos[2], b.pos[5])
    assert swapped.seed[2] == b.seed[5] and torch.equal(b.pos[2],
                                                        rows[2].pos)
    with pytest.raises(ValueError, match="lbest"):
        ms.set_batch_row(b, 0, rows[0]._replace(lbest_pos=None,
                                                lbest_fit=None))
    pr, _ = ms.problem_rows(MIXED, 3, device="cpu")
    one, _ = ms.problem_rows(["sphere"], 3, device="cpu")
    moved = ms.set_problem_row(pr, 0, one)
    assert int(moved.fid[0]) == 1 and int(pr.fid[0]) == 0
