"""The lbest topologies of repro_torch against repro's, on the CPU, plus the
async kernel's lbest instantiations on a card (``gpu``-marked; they skip
inside the test when there is none).

What is held, and how tightly:

* ``core.topology`` (``grid_dims``, ``kernel_neighbor_ids``,
  ``block_neighbor_best``): exactly, ties included (they only compare and
  copy);
* the eager ``run_async`` under ``ring``/``vonneumann`` against
  ``repro.core.pso.run_async``, one call a step from the reference's state:
  positions rtol 2e-6 / atol 1e-5, fitness rtol 1e-5 / atol 1e-5 (as
  ``tests/test_torch_core.py``: XLA:CPU contracts the velocity chain into
  FMAs and sums in another order);
* the plain versions of the async kernels (single swarm, batch,
  heterogeneous batch) against ``ref.run_fused_async_oracle`` and the
  Pallas kernels in interpret mode at the tolerances of
  ``tests/test_torch_kernels.py`` (positions rtol 2e-6 / atol max(1e-5,
  1e-6 * box width), fitness rtol 1e-5 / atol 1e-5 * max|fit|), their
  counters exactly;
* batch rows against single runs, and the split path against the eager
  engine: bit for bit.

Run them alone: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_topology.py``; on the card ``-m gpu``."""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import api
from repro_torch.core import multi_swarm as ms
from repro_torch.core import pso, topology
from repro_torch.kernels import ops, pso_split, pso_step

try:
    import jax.numpy as jnp
    from repro.core import multi_swarm as jms
    from repro.core import pso as jpso
    from repro.core import topology as jtop
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    import repro as jpso_api
except ModuleNotFoundError:     # a CUDA host may have no JAX installed
    jnp = jms = jpso = jtop = jops = jref = jpso_api = None

torch.set_num_threads(1)

LBEST = ("ring", "vonneumann")
POS_TOL = dict(rtol=2e-6, atol=1e-5)
FIT_TOL = dict(rtol=1e-5, atol=1e-5)


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
                    "`python -m pytest -m gpu tests/test_torch_topology.py`")
    return torch.device("cuda")


def _np(s):
    return {k: (None if getattr(s, k) is None else np.asarray(getattr(s, k)))
            for k in s._fields}


def _cfgs(topo, fit="rastrigin", d=3, n=128, rule="pso"):
    return (jpso.PSOConfig(dim=d, particle_cnt=n, fitness=fit,
                           update_rule=rule, topology=topo).resolved(),
            pso.PSOConfig(dim=d, particle_cnt=n, fitness=fit,
                          update_rule=rule, topology=topo).resolved())


def _pos_tol(spec):
    width = max(np.max(np.subtract(spec.hi, spec.lo)), 1.0)
    return dict(rtol=2e-6, atol=max(1e-5, 1e-6 * width))


def _fit_tol(ref):
    return dict(rtol=1e-5,
                atol=1e-5 * max(1.0, float(np.max(np.abs(np.asarray(ref))))))


# --- core.topology -----------------------------------------------------------

@pytest.mark.parametrize("nb", [1, 2, 3, 4, 6, 7, 12, 16])
def test_topology_functions_match_reference(nb, reference):
    """grid_dims, kernel_neighbor_ids (also the CPU path of the kernels'
    ``neighbor_ids``) and block_neighbor_best, on local bests drawn from
    three values so that ties are common: equal to the reference's, bit
    for bit, for one swarm and for a batch of swarms."""
    rng = np.random.default_rng(nb)
    assert topology.grid_dims(nb) == jtop.grid_dims(nb)
    for topo in LBEST:
        want = [tuple(int(x) for x in jtop.kernel_neighbor_ids(b, nb, topo))
                for b in range(nb)]
        assert [topology.kernel_neighbor_ids(b, nb, topo)
                for b in range(nb)] == want
        assert pso_step.neighbor_ids(nb, topo, "cpu").tolist() == \
            [list(w) for w in want]
        lbf = rng.integers(0, 3, size=(5, nb)).astype(np.float32)
        lbp = rng.normal(size=(5, nb, 4)).astype(np.float32)
        got_p, got_f = topology.block_neighbor_best(
            torch.tensor(lbf), torch.tensor(lbp), topo)
        for s in range(5):
            jp, jf = jtop.block_neighbor_best(jnp.asarray(lbf[s]),
                                              jnp.asarray(lbp[s]), topo)
            assert np.array_equal(got_f[s].numpy(), np.asarray(jf))
            assert np.array_equal(got_p[s].numpy(), np.asarray(jp))


def test_unknown_lbest_topology_raises():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="lbest topology"):
        topology.block_neighbor_best(x, torch.zeros(4, 2), "star")
    with pytest.raises(ValueError, match="lbest topology"):
        topology.kernel_neighbor_ids(0, 4, "gbest")
    with pytest.raises(ValueError, match="unknown topology"):
        pso_step.neighbor_ids(4, "torus", "cpu")
    with pytest.raises(ValueError, match="unknown topology"):
        pso.PSOConfig(topology="torus")


# --- the eager engine --------------------------------------------------------

@pytest.mark.parametrize("topo", LBEST)
@pytest.mark.parametrize("start", [0, 3])
def test_run_async_lbest_matches_reference(topo, start, reference):
    """run_async under an lbest topology, one call a step from the
    reference's state for 12 iterations (sync_every=4, n_blocks=4): the
    scheduled syncs (every 4th iteration) pull the neighbourhood best, the
    other steps end in a publish-only flush; from iteration 3 the steps
    walk a head chunk first."""
    jc, tc = _cfgs(topo)
    js = jpso.init_swarm(jc, 1)
    if start:
        js = jpso.run_async(jc, js, start, sync_every=4, n_blocks=4)
    for _ in range(12):
        ts = pso.state_from_numpy(_np(js), device="cpu")
        js = jpso.run_async(jc, js, 1, sync_every=4, n_blocks=4)
        ts = pso.run_async(tc, ts, 1, sync_every=4, n_blocks=4)
        for f in ("pos", "vel", "pbest_pos", "gbest_pos", "lbest_pos"):
            np.testing.assert_allclose(getattr(ts, f).numpy(),
                                       np.asarray(getattr(js, f)),
                                       **POS_TOL, err_msg=f)
        for f in ("fit", "pbest_fit", "gbest_fit", "lbest_fit"):
            np.testing.assert_allclose(getattr(ts, f).numpy(),
                                       np.asarray(getattr(js, f)),
                                       **FIT_TOL, err_msg=f)
        assert float(ts.gbest_fit) == float(ts.pbest_fit.max())


@pytest.mark.parametrize("topo", LBEST)
def test_lbest_sync_differs_from_the_star(topo):
    """At a scheduled sync the star gives every block gbest; an lbest
    topology gives each block only its neighbourhood's best, and flushes
    the best local into gbest all the same."""
    cfg = pso.PSOConfig(dim=2, particle_cnt=64, fitness="sphere").resolved()
    s = pso.init_swarm(cfg, 0, device="cpu")
    lbf = torch.tensor([-9.0, -1.0, -7.0, -8.0, -6.0, -5.0, -4.0, -3.0])
    lbp = torch.arange(16.0).reshape(8, 2)
    s = s._replace(gbest_fit=torch.tensor(-10.0))
    out, (p, f) = pso.lbest_sync(s, (lbp, lbf), topo)
    assert float(out.gbest_fit) == -1.0
    assert torch.equal(out.gbest_pos, lbp[1])
    want_p, want_f = topology.block_neighbor_best(lbf, lbp, topo)
    assert torch.equal(f, want_f) and torch.equal(p, want_p)
    assert float(f.min()) < -1.0          # not every block sees gbest


# --- the plain versions of the async kernels ---------------------------------

def _oracle(jc, js, state, iters, bn, sync_every, topo):
    """ref.run_fused_async_oracle on the port's D-major operands, with its
    counters."""
    pos, vel, pbp, pbf, gp, gf = (x.numpy() for x in state)
    kw = jops._cfg_kwargs(jc)
    kw["d_real"] = jc.dim
    fitness = kw.pop("fitness")
    counters = {}
    out = jref.run_fused_async_oracle(
        int(js.seed), 0, pos, vel, pbp, pbf[None, :], gp[:, None],
        float(gf[0]), iters, bn, sync_every, fitness=fitness,
        topology=topo, counters=counters, **kw)
    return out, counters


@pytest.mark.parametrize("topo", LBEST)
def test_fused_async_plain_lbest_matches_oracle_and_pallas(topo, reference):
    """Row 5: the plain single-swarm version under an lbest topology, 128
    particles in 4 blocks at d=3, 8 iterations at sync_every=3 (two chunks,
    then a remainder phase), against ``ref.run_fused_async_oracle`` and the
    Pallas kernel in interpret mode; its counters equal the oracle's."""
    jc, tc = _cfgs(topo)
    js = jpso.init_swarm(jc, 6)
    state = ops.state_to_kernel(pso.state_from_numpy(_np(js), device="cpu"))
    spec = ops.kernel_spec(tc)
    bn, iters, se = 32, 8, 3
    want, counters = _oracle(jc, js, state, iters, bn, se, topo)
    cnt = torch.zeros(3, dtype=torch.int32)
    got = pso_step.fused_async_plain(
        *state, state[4][:, None].repeat(1, 4), state[5].repeat(4), spec,
        seed=int(js.seed), iteration=0, iters=iters, sync_every=se,
        block_n=bn, counts=cnt, topology=topo)
    for a, b in ((got[0], want[0]), (got[1], want[1]), (got[2], want[2]),
                 (got[4], want[4]), (got[6], want[6])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape),
                                   **_pos_tol(spec))
    for a, b in ((got[3], want[3]), (got[5], want[5]), (got[7], want[7])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape),
                                   **_fit_tol(want[3]))
    assert cnt.tolist() == [counters.get(k, 0) for k in (
        "queue_updates", "publications", "block_improvements")]
    pallas = jops.run_queue_lock_fused_async(jc, js, iters, sync_every=se,
                                             block_n=bn, interpret=True)
    port = ops.run_queue_lock_fused_async(
        tc, pso.state_from_numpy(_np(js), device="cpu"), iters,
        sync_every=se, block_n=bn)
    for f in ("pos", "vel", "pbest_pos", "gbest_pos", "lbest_pos"):
        np.testing.assert_allclose(getattr(port, f).numpy(),
                                   np.asarray(getattr(pallas, f)),
                                   **_pos_tol(spec), err_msg=f)
    for f in ("pbest_fit", "gbest_fit", "lbest_fit"):
        np.testing.assert_allclose(getattr(port, f).numpy(),
                                   np.asarray(getattr(pallas, f)),
                                   **_fit_tol(pallas.pbest_fit), err_msg=f)


@pytest.mark.parametrize("topo", LBEST)
def test_lbest_one_block_is_the_star(topo):
    """With one block a neighbour fold reads only the block itself, so an
    lbest run equals the star's, the local best equal to gbest."""
    cfg = pso.PSOConfig(dim=3, particle_cnt=64, fitness="ackley").resolved()
    state = ops.state_to_kernel(pso.init_swarm(cfg, 2, device="cpu"))
    spec = ops.kernel_spec(cfg)
    kw = dict(seed=2, iteration=0, iters=7, sync_every=3, block_n=64)
    loc = (state[4][:, None].clone(), state[5].clone())
    star = pso_step.fused_async_plain(*state, *loc, spec, **kw)
    lb = pso_step.fused_async_plain(*state, *loc, spec, topology=topo, **kw)
    for a, b in zip(star, lb):
        assert torch.equal(a, b)
    assert torch.equal(lb[6][:, 0], lb[4]) and torch.equal(lb[7], lb[5])


BATCH_SEEDS = [0, 1, 7, 42, 99, 123, 100000, 2 ** 31 - 5]
MIXED = ["cubic", "sphere", "rosenbrock", "griewank", "rastrigin", "ackley",
         "cubic", "ackley"]


def _batches(topo, hetero, d=3, n=128):
    """The same 8-swarm batch for the reference and the port, at per-row
    iterations 0, 3, 6, ..., with the port's kernel table and fids."""
    fit = {} if hetero else dict(fitness="rastrigin")
    jc, tc = (m.PSOConfig(dim=d, particle_cnt=n, topology=topo, **fit)
              .resolved() for m in (jpso, pso))
    if hetero:
        jr, jt = jms.problem_rows(MIXED, d)
        tr, tt = ms.problem_rows(MIXED, d, device="cpu")
        jb = jms.init_batch(jc, BATCH_SEEDS, rows=jr, table=jt)
        jkw, tkw = dict(fids=jr.fid, table=jt), dict(fids=tr.fid, table=tt)
        widths = (tr.hi - tr.lo).amax(1).tolist()
    else:
        jb = jms.init_batch(jc, BATCH_SEEDS)
        jkw, tkw = {}, {}
        widths = [tc.max_pos - tc.min_pos] * 8
    jb = jb._replace(iteration=jb.iteration + 3 * np.arange(8, dtype=np.int32))
    return jc, tc, jb, _port_batch(jb), jkw, tkw, widths


def _port_batch(jb):
    out = {k: None if getattr(jb, k) is None
           else torch.as_tensor(np.array(getattr(jb, k))) for k in jb._fields}
    out["iteration"] = out["iteration"].to(torch.int64)
    out["seed"] = torch.as_tensor(np.asarray(jb.seed).astype(np.int64))
    return ms.SwarmBatch(**out)


@pytest.mark.parametrize("topo", LBEST)
@pytest.mark.parametrize("hetero", [False, True])
def test_fused_async_batch_plain_lbest_matches_pallas(topo, hetero,
                                                      reference):
    """Rows 6 and 7: the plain batch (and heterogeneous batch) under an
    lbest topology against the batched Pallas kernels in interpret mode, 8
    swarms of 128 particles in 4 blocks at d=3, rows at different
    iterations: 8 iterations as calls of 3, 3 and 2 (a chunk of 3, each
    call from the reference's state and its carried local bests, as the
    parity contract compares trajectories; over 8 iterations in one call
    the velocities' rounding drifts past the tolerance)."""
    jc, tc, jb, tb, jkw, tkw, widths = _batches(topo, hetero)
    for k in (3, 3, 2):
        want = jops.run_queue_lock_fused_async_batch(
            jc, jb, k, sync_every=3, block_n=32, interpret=True, **jkw)
        got = ops.run_queue_lock_fused_async_batch(tc, tb, k, sync_every=3,
                                                   block_n=32, **tkw)
        for f in ("pos", "vel", "pbest_pos", "gbest_pos", "lbest_pos"):
            for s, wd in enumerate(widths):
                np.testing.assert_allclose(
                    getattr(got, f)[s].numpy(),
                    np.asarray(getattr(want, f)[s]), rtol=2e-6,
                    atol=max(1e-5, 1e-6 * wd), err_msg=f"{f}[{s}]")
        for f in ("pbest_fit", "gbest_fit", "lbest_fit"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)),
                                       **_fit_tol(want.pbest_fit), err_msg=f)
        assert got.lbest_fit.shape == (8, 4)
        jb, tb = want, _port_batch(want)


@pytest.mark.parametrize("topo", LBEST)
def test_lbest_batch_rows_equal_single_runs(topo):
    """Row s of an lbest batch equals the single swarm, bit for bit: the
    eager ``run_many`` row against ``pso.run_async`` on ``batch_row``, and
    the kernels' plain batch row against the single-swarm plain version,
    the counters included."""
    cfg = pso.PSOConfig(dim=2, particle_cnt=96, fitness="griewank",
                        topology=topo).resolved()
    b = ms.init_batch(cfg, [3, 4, 5], device="cpu")
    b = b._replace(iteration=b.iteration + torch.tensor([0, 2, 5]))
    eager = ms.run_many(cfg, b, 9, "async", sync_every=4, n_blocks=6)
    kern, cnt = ops.run_queue_lock_fused_async_batch(
        cfg, b, 9, sync_every=4, block_n=16, telemetry=True)
    for s in range(3):
        row = ms.batch_row(b, s)
        want = pso.run_async(cfg, row, 9, sync_every=4, n_blocks=6)
        wk, wc = ops.run_queue_lock_fused_async(cfg, row, 9, sync_every=4,
                                                block_n=16, telemetry=True)
        for f in ("pos", "vel", "pbest_pos", "pbest_fit", "gbest_pos",
                  "gbest_fit", "lbest_pos", "lbest_fit"):
            assert torch.equal(getattr(ms.batch_row(eager, s), f),
                               getattr(want, f)), (s, f)
            assert torch.equal(getattr(ms.batch_row(kern, s), f),
                               getattr(wk, f)), (s, f)
        assert torch.equal(cnt[s], wc)


# --- the split path ----------------------------------------------------------

def _my_sphere():
    return repro_torch.Problem(name="my_sphere",
                               fn=lambda x: -torch.sum(x * x, -1),
                               lo=-5.0, hi=5.0)


@pytest.mark.parametrize("topo", LBEST)
@pytest.mark.parametrize("name", ["sphere_simplex", "my_sphere"])
def test_split_lbest_equals_eager_bitwise(topo, name):
    """The split path's async mode under an lbest topology (the pull is
    ``block_neighbor_best`` inside ``split_publish_plain``)
    equals the eager ``run_async`` bit for bit, also resumed from its
    carried locals, and a batch's rows equal it too."""
    prob = _my_sphere() if name == "my_sphere" else name
    cfg = pso.PSOConfig(dim=5, particle_cnt=64, w=0.7, fitness=prob,
                        topology=topo).resolved()
    s0 = pso.init_swarm(cfg, 3, device="cpu")
    want = pso.run_async(cfg, s0, 9, sync_every=3, n_blocks=8)
    got = ops.run_queue_lock_fused_async(cfg, s0, 9, sync_every=3, block_n=8)
    for f in ("pos", "vel", "pbest_pos", "pbest_fit", "gbest_pos",
              "gbest_fit", "lbest_pos", "lbest_fit"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    more = ops.run_queue_lock_fused_async(cfg, got, 5, sync_every=3,
                                          block_n=8)
    again = pso.run_async(cfg, want, 5, sync_every=3, n_blocks=8)
    assert torch.equal(more.pbest_pos, again.pbest_pos)
    assert torch.equal(more.lbest_fit, again.lbest_fit)
    b = ms.init_batch(cfg, [3, 8], device="cpu")
    kb = ops.run_queue_lock_fused_async_batch(cfg, b, 9, sync_every=3,
                                              block_n=8)
    assert torch.equal(ms.batch_row(kb, 0).lbest_pos, want.lbest_pos)
    assert torch.equal(ms.batch_row(kb, 0).pbest_pos, want.pbest_pos)


def test_split_publish_lbest_plain_is_block_neighbor_best():
    """The split publish's lbest pull, swarm by swarm: a sync point flushes
    gbest and gives each local its neighbourhood best; a flush or no
    action leaves the locals alone."""
    rng = np.random.default_rng(5)
    s_cnt, nb, d, n = 3, 6, 2, 12
    lf = torch.tensor(rng.integers(0, 4, size=s_cnt * nb).astype(np.float32))
    lp = torch.tensor(rng.normal(size=(d, s_cnt * nb)).astype(np.float32))
    gp, gf = torch.zeros(d, s_cnt), torch.full((s_cnt,), -1.0)
    pos, fit = torch.zeros(d, s_cnt * n), torch.zeros(s_cnt * n)
    act = torch.tensor([1, 2, 0], dtype=torch.int32)
    out = pso_split.split_publish_plain(pos, fit, gp, gf, n=n, mode="async",
                                        lp=lp, lf=lf, act=act,
                                        topology="vonneumann")
    want_p, want_f = topology.block_neighbor_best(
        lf[:nb], lp[:, :nb].T, "vonneumann")
    assert torch.equal(out["lf"][:nb], want_f)
    assert torch.equal(out["lp"][:, :nb], want_p.T)
    assert torch.equal(out["lf"][nb:], lf[nb:])
    assert torch.equal(out["lp"][:, nb:], lp[:, nb:])
    assert out["gf"].tolist() == [float(lf[:nb].max()),
                                  float(lf[nb:2 * nb].max()), -1.0]


# --- the facade ----------------------------------------------------------------

@pytest.mark.parametrize("backend", ["eager", "kernel"])
@pytest.mark.parametrize("topo", LBEST)
def test_lbest_end_to_end_facade(backend, topo):
    """``solve`` and ``solve_many`` (homogeneous, heterogeneous and on a
    constrained Problem) with ``Method(variant="async", topology=...)`` on
    the CPU, both backends: the config reports the topology, the history
    has a monotone sample a sync point, gbest never falls below the
    initial one, positions stay in the box, and the kernel backend's
    counters hold the async invariants."""
    m = api.Method(variant="async", backend=backend, topology=topo,
                   sync_every=4, block_n=32, record_history=True,
                   telemetry=backend == "kernel")
    res = repro_torch.solve("cubic", dim=2, particles=128, iters=40, seed=0,
                            method=m, device="cpu")
    assert res.config.topology == topo
    assert len(res.history) == 10 and res.history.iteration[-1] == 40
    assert bool(np.all(np.diff(res.history.gbest_fit) >= 0))
    assert res.history.gbest_fit[-1] == res.gbest_fit
    s0 = pso.init_swarm(res.config, 0, device="cpu")
    assert res.gbest_fit >= float(s0.gbest_fit)
    assert res.gbest_fit == float(res.state.pbest_fit.max())
    assert bool((res.state.pos >= res.config.min_pos - 1e-5).all())
    assert bool((res.state.pos <= res.config.max_pos + 1e-5).all())
    if backend == "kernel":
        t = res.telemetry
        assert t.queue_updates <= t.block_improvements <= 40 * 4
        assert t.publications <= 10 * 4
    rows = repro_torch.solve_many("rastrigin", [1, 2], dim=3, particles=64,
                                  iters=9, method=m, device="cpu")
    hetero = repro_torch.solve_many(problems=["sphere", "ackley"],
                                    seeds=[1, 2], dim=3, particles=64,
                                    iters=9, method=m, device="cpu")
    for r in rows + hetero:
        assert r.config.topology == topo
        assert r.gbest_fit == float(r.state.pbest_fit.max())
    con = repro_torch.solve("sphere_simplex", dim=4, particles=64, iters=9,
                            w=0.7, method=m, device="cpu")
    assert con.config.topology == topo
    assert float((con.state.pos.sum(-1) - 1).abs().max()) < 1e-5


@pytest.mark.parametrize("topo,bn", [
    ("gbest", 1), ("ring", 1), ("ring", 2), ("vonneumann", 3),
    ("vonneumann", 4), ("vonneumann", 6), ("vonneumann", 8)])
def test_lbest_small_blocks_kernel_backend(topo, bn, reference):
    """Blocks with fewer particles than neighbours (ring in blocks of 1,
    von Neumann in blocks of 1-3) and just above: ``solve`` on the kernel
    backend (the async kernels' plain versions here) against the
    reference's kernel backend (Pallas, interpret mode), rastrigin d=3,
    one block and four, 8 iterations at sync_every=2, at the plain
    versions' tolerances. On the card the same blocks run on the kernels
    (``test_bf16_lbest_small_blocks_on_card`` in tests/test_torch_bf16.py)."""
    for n in (bn, 4 * bn):
        kw = dict(dim=3, particles=n, iters=8, seed=3)
        want = jpso_api.solve("rastrigin", method=jpso_api.Method(
            variant="async", backend="kernel", topology=topo, block_n=bn,
            sync_every=2), **kw)
        got = repro_torch.solve("rastrigin", method=api.Method(
            variant="async", backend="kernel", topology=topo, block_n=bn,
            sync_every=2), device="cpu", **kw)
        assert got.config.topology == topo
        st, ref = got.state, _np(want.state)
        tol = _pos_tol(ops.kernel_spec(got.config))
        np.testing.assert_allclose(st.pos.numpy(), ref["pos"], **tol)
        np.testing.assert_allclose(st.pbest_pos.numpy(), ref["pbest_pos"],
                                   **tol)
        np.testing.assert_allclose(st.pbest_fit.numpy(), ref["pbest_fit"],
                                   **_fit_tol(ref["pbest_fit"]))
        np.testing.assert_allclose(got.gbest_fit, float(want.gbest_fit),
                                   **_fit_tol(ref["gbest_fit"]))


# --- on the card -------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("topo", LBEST)
def test_neighbor_ids_exact_on_card(cuda, topo):
    for nb in (1, 2, 3, 7, 12, 64, 256):
        got = pso_step.neighbor_ids(nb, topo, cuda).cpu()
        assert torch.equal(got, pso_step.neighbor_ids(nb, topo, "cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("topo", LBEST)
@pytest.mark.parametrize("d,n", [(8, 512), (120, 128)])
def test_lbest_one_block_matches_plain_on_card(cuda, topo, d, n):
    """One block (at d=120 on a cluster of CTAs): the lbest kernel bit for
    bit the star's kernel over 21 iterations at sync_every=8 (two chunks,
    then a remainder launch), and at d=8 against its plain version (at
    d=120 the two sum the objective in other orders, and over 21
    iterations a comparison may flip)."""
    cfg = pso.PSOConfig(dim=d, particle_cnt=n, fitness="ackley").resolved()
    state = ops.state_to_kernel(pso.init_swarm(cfg, 1, device=cuda))
    spec = ops.kernel_spec(cfg)
    loc = (state[4][:, None].clone(), state[5].clone())
    kw = dict(seed=1, iteration=0, iters=21, sync_every=8, block_n=n)
    want = pso_step.fused_async_plain(*state, *loc, spec, topology=topo,
                                      **kw)
    got = pso_step.fused_async(*[x.clone() for x in state + loc], spec,
                               topology=topo, **kw)
    star = pso_step.fused_async(*[x.clone() for x in state + loc], spec,
                                **kw)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, star):
        if d == 8:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        assert torch.equal(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("topo", LBEST)
@pytest.mark.parametrize("fit,d,n", [("cubic", 1, 65536),
                                     ("rastrigin", 24, 16384),
                                     ("rastrigin", 120, 1024)])
def test_lbest_multi_block_invariants_on_card(cuda, topo, fit, d, n):
    """Several blocks (a race by design), three launches of 16 iterations at
    sync_every=4: gbest monotone and equal to max(pbest) and to a pbest
    column, every slot's fitness non-decreasing and at least its
    neighbourhood's best at launch, the fitness at every slot's position
    its stored fitness (exactly at d=1, where torch and the kernel round
    alike; a torn slot would not be), positions in the box, publications
    at most chunks x blocks."""
    cfg = pso.PSOConfig(dim=d, particle_cnt=n, fitness=fit).resolved()
    state = ops.state_to_kernel(pso.init_swarm(cfg, 3, device=cuda))
    spec = ops.kernel_spec(cfg)
    nb = n // 512
    state = state + (state[4][:, None].repeat(1, nb).contiguous(),
                     state[5].repeat(nb))
    cnt = torch.zeros(3, dtype=torch.int32, device=cuda)
    prev = float(state[5][0])
    for launch in range(3):
        lf0 = state[7].clone()
        _, hood = topology.block_neighbor_best(lf0, state[6].T, topo)
        pso_step.fused_async(*state, spec, seed=3, iteration=16 * launch,
                             iters=16, sync_every=4, block_n=512,
                             counts=cnt, topology=topo)
        torch.cuda.synchronize()
        pos, _, pbp, pbf, gp, gf, lp, lf = state
        assert float(gf[0]) >= prev
        prev = float(gf[0])
        assert float(gf[0]) == float(pbf.max())
        assert bool((pbp[:, pbf == gf] == gp[:, None]).all(0).any())
        assert bool((lf >= lf0).all()) and bool((lf >= hood).all())
        refit = cfg.fitness_fn(lp.T.contiguous())
        if d == 1:
            assert torch.equal(refit, lf)
        else:
            torch.testing.assert_close(refit, lf, rtol=1e-5, atol=1e-5 * max(
                1.0, float(lf.abs().max())))
        lo, hi, _ = pso_step._operands(spec, pos.device)
        assert bool(((pos >= lo) & (pos <= hi)).all())
    assert int(cnt[1]) <= 3 * 4 * nb
