"""repro_torch.core against repro.core on the CPU: the counter RNG, block
sizing, the six objectives, the update rules, init_swarm, the eager step
variants and the async engine, from inputs shared as numpy arrays.

Tolerances: the RNG is bit-exact. One step from a shared state agrees to
rtol=2e-6, atol=1e-5 on positions and velocities and rtol=1e-5 on fitness:
XLA:CPU contracts the velocity chain into FMAs and sums in another order,
PyTorch does neither the same way. Improvement masks and chosen winners
must be equal. Longer runs are compared one step at a time from the shared
state (PSO diverges once a comparison flips)."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocking as jblocking
from repro.core import fitness as jfitness
from repro.core import pso as jpso
from repro.core import rng as jrng
from repro.core import update_rules as jrules
from repro_torch.core import blocking, fitness, pso, rng, update_rules

torch.set_num_threads(1)

POS_TOL = dict(rtol=2e-6, atol=1e-5)
FIT_TOL = dict(rtol=1e-5, atol=1e-5)
FITNESS = ("cubic", "sphere", "rosenbrock", "griewank", "rastrigin", "ackley")


def _np_state(s):
    return {k: (None if getattr(s, k) is None else np.asarray(getattr(s, k)))
            for k in s._fields}


def _assert_state_close(js, ts, pos_tol=POS_TOL, fit_tol=FIT_TOL):
    for f in ("pos", "vel", "pbest_pos", "gbest_pos"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), **pos_tol,
                                   err_msg=f)
    for f in ("fit", "pbest_fit", "gbest_fit"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), **fit_tol,
                                   err_msg=f)
    assert ts.iteration == int(js.iteration)


def _configs(fit, rule="pso", d=3, n=64, **kw):
    return (jpso.PSOConfig(dim=d, particle_cnt=n, fitness=fit,
                           update_rule=rule, **kw).resolved(),
            pso.PSOConfig(dim=d, particle_cnt=n, fitness=fit,
                          update_rule=rule, **kw).resolved())


# --- RNG ---------------------------------------------------------------------

_IDX = np.concatenate([
    np.arange(0, 4096), np.arange(2**31 - 2048, 2**31 + 2048),
    np.arange(2**32 - 2048, 2**32)]).astype(np.uint64)


@pytest.mark.parametrize("seed,it,stream", [
    (0, 0, 0), (12345, 7, 2), (2**32 - 1, 2**31 + 5, 3), (2**31, 1, 1)])
def test_rng_bit_exact(seed, it, stream):
    idx_j = jnp.asarray(_IDX, jnp.uint32)
    want_bits = np.asarray(jrng.hash_u32(np.uint32(seed), np.uint32(it),
                                         stream, idx_j))
    idx = torch.as_tensor(_IDX.astype(np.int64))
    got_bits = rng.hash_u32(seed, it, stream, idx).numpy()
    assert np.array_equal(got_bits.astype(np.uint32), want_bits)
    want = np.asarray(jrng.uniform(np.uint32(seed), np.uint32(it), stream,
                                   jnp.asarray(_IDX, jnp.uint32)))
    got = rng.uniform(seed, it, stream, idx).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_rng_tensor_counters_match_int_counters():
    idx = torch.arange(100, dtype=torch.int64)
    a = rng.uniform(torch.tensor(99), torch.tensor(3), 2, idx)
    assert torch.equal(a, rng.uniform(99, 3, 2, idx))


# --- block sizing ------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 33, 96, 100, 128, 384, 640, 1024,
                               131072, 1009, 1042, 1563])
def test_pick_block_n_matches_reference(n):
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jblocking.pick_block_n(n)
        want_count = jblocking.default_block_count(n)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = blocking.pick_block_n(n)
        got_count = blocking.default_block_count(n)
    assert (got, got_count) == (want, want_count)
    assert len(tw) == len(jw)          # the degenerate-grid warning too
    if n in (1009, 1042):
        assert got == {1009: 1009, 1042: 521}[n] and tw


# --- objectives and rules ----------------------------------------------------

@pytest.mark.parametrize("d", [1, 2, 7, 120])
@pytest.mark.parametrize("name", FITNESS)
def test_fitness_matches_reference(name, d):
    lo, hi = jfitness.DEFAULT_BOUNDS[name]
    x = np.random.default_rng(d).uniform(lo, hi, (33, d)).astype(np.float32)
    want = np.asarray(jfitness.FITNESS_FNS[name](jnp.asarray(x)))
    got = fitness.FITNESS_FNS[name](torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert fitness.FITNESS_IDS[name] == jfitness.FITNESS_IDS[name]


@pytest.mark.parametrize("rule", ["pso", "sso", "lowcost"])
def test_update_rules_match_reference(rule):
    g = np.random.default_rng(7)
    shp = (40, 5)
    r1, r2 = (g.random(shp, dtype=np.float32) for _ in range(2))
    pos, vel, pbp = (g.uniform(-5, 5, shp).astype(np.float32)
                     for _ in range(3))
    gp = g.uniform(-5, 5, (1, 5)).astype(np.float32)
    kw = dict(w=0.7, c1=1.5, c2=1.5, mv=2.5, lo=-5.0, hi=5.0)
    jp, jv = jrules.resolve_rule(rule).advance(
        *map(jnp.asarray, (r1, r2, pos, vel, pbp, gp)), **kw)
    tp, tv = update_rules.resolve_rule(rule).advance(
        *map(torch.as_tensor, (r1, r2, pos, vel, pbp, gp)), **kw)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **POS_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **POS_TOL)


# --- init and the eager step variants ----------------------------------------

@pytest.mark.parametrize("fit,kw", [
    ("cubic", {}), ("rastrigin", {}),
    ("sphere", dict(min_pos=(-1.0, -2.0, -3.0), max_pos=(1.0, 2.0, 4.0)))])
def test_init_swarm_matches_reference(fit, kw):
    jc, tc = _configs(fit, **kw)
    js = jpso.init_swarm(jc, 11)
    ts = pso.init_swarm(tc, 11, device="cpu")
    _assert_state_close(js, ts)
    assert int(np.asarray(jnp.argmax(js.fit))) == int(torch.argmax(ts.fit))
    assert ts.seed == int(js.seed)


@pytest.mark.parametrize("variant", ["step_reduction", "step_queue",
                                     "step_queue_lock"])
@pytest.mark.parametrize("fit,rule", [("cubic", "pso"), ("rastrigin", "sso"),
                                      ("griewank", "lowcost"),
                                      ("rosenbrock", "pso")])
def test_step_variants_match_reference(variant, fit, rule):
    jc, tc = _configs(fit, rule, d=4, n=96)
    js = jpso.init_swarm(jc, 5)
    for _ in range(4):                      # step by step from shared state
        ts = pso.state_from_numpy(_np_state(js), device="cpu")
        jo = getattr(jpso, variant)(jc, js)
        to = getattr(pso, variant)(tc, ts)
        _assert_state_close(jo, to)
        assert np.array_equal(
            to.pbest_fit.numpy() > ts.pbest_fit.numpy(),
            np.asarray(jo.pbest_fit) > np.asarray(js.pbest_fit))
        js = jo


def test_step_async_and_sync_points_match_reference():
    jc, tc = _configs("rastrigin", d=3, n=96)
    js = jpso.init_swarm(jc, 9)
    jl = jpso.init_async_locals(js, 4)
    for _ in range(3):
        ts = pso.state_from_numpy(_np_state(js), device="cpu")
        tl = tuple(torch.as_tensor(np.asarray(x)) for x in jl)
        js, jl = jpso.step_async(jc, js, jl)
        ts, tl = pso.step_async(tc, ts, tl)
        _assert_state_close(js, ts)
        np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl[0]), **POS_TOL)
        np.testing.assert_allclose(tl[1].numpy(), np.asarray(jl[1]), **FIT_TOL)
    ts = pso.state_from_numpy(_np_state(js), device="cpu")
    tl = tuple(torch.as_tensor(np.asarray(x)) for x in jl)
    for fn in ("flush_async_locals", "publish_async_locals"):
        jo, jol = getattr(jpso, fn)(js, jl)
        to, tol = getattr(pso, fn)(ts, tl)
        _assert_state_close(jo, to)
        np.testing.assert_allclose(tol[0].numpy(), np.asarray(jol[0]))
        np.testing.assert_allclose(tol[1].numpy(), np.asarray(jol[1]))


@pytest.mark.parametrize("start,iters", [(0, 7), (3, 6)])
def test_run_async_phase_head_remainder_match_reference(start, iters):
    """run_async one call per step from the shared state: the phase is
    derived from the iteration, so the steps walk a head chunk (start=3),
    full chunks, and a trailing remainder flush (sync_every=4)."""
    jc, tc = _configs("cubic", d=2, n=96)
    js = jpso.run_async(jc, jpso.init_swarm(jc, 1), start, sync_every=4,
                        n_blocks=3) if start else jpso.init_swarm(jc, 1)
    for _ in range(iters):
        ts = pso.state_from_numpy(_np_state(js), device="cpu")
        js = jpso.run_async(jc, js, 1, sync_every=4, n_blocks=3)
        ts = pso.run_async(tc, ts, 1, sync_every=4, n_blocks=3)
        _assert_state_close(js, ts)
        np.testing.assert_allclose(ts.lbest_fit.numpy(),
                                   np.asarray(js.lbest_fit), **FIT_TOL)
        np.testing.assert_allclose(ts.lbest_pos.numpy(),
                                   np.asarray(js.lbest_pos), **POS_TOL)
        assert float(ts.gbest_fit) == float(ts.pbest_fit.max())


def test_run_async_segments_in_one_call():
    """A 7-iteration call from iteration 3 (head 1, one chunk, remainder 2)
    against the reference's, compared at the end with a looser bound."""
    jc, tc = _configs("sphere", d=2, n=64)
    js = jpso.run_async(jc, jpso.init_swarm(jc, 2), 3, sync_every=4)
    ts = pso.state_from_numpy(_np_state(js), device="cpu")
    jo = jpso.run_async(jc, js, 7, sync_every=4)
    to = pso.run_async(tc, ts, 7, sync_every=4)
    _assert_state_close(jo, to, pos_tol=dict(rtol=1e-4, atol=1e-4),
                        fit_tol=dict(rtol=1e-4, atol=1e-4))


def test_state_numpy_round_trip():
    jc, tc = _configs("ackley", d=3, n=64)
    js = jpso.run_async(jc, jpso.init_swarm(jc, 4), 5, sync_every=2,
                        n_blocks=2)
    fields = _np_state(js)
    ts = pso.state_from_numpy(fields, device="cpu")
    back = pso.state_to_numpy(ts)
    for k, v in fields.items():
        assert np.array_equal(back[k], v), k
        assert back[k].dtype == v.dtype, k
    assert ts.lbest_pos.shape == (2, 3)
