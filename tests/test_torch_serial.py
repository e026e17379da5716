"""repro_torch.core.serial (numpy, the paper's Alg. 1 CPU baseline)
against repro.core.serial. Both are numpy with the same operations in the
same order, so the six built-ins agree bit for bit; a custom objective goes
through the port's torch ``max_fn`` and is held within rtol=1e-6."""
import numpy as np
import pytest
import torch

from repro_torch.core import SerialSwarm, run_serial_fast
from repro_torch.core import pso, serial

try:
    from repro.core import pso as jpso
    from repro.core import serial as jserial
except ModuleNotFoundError:     # a CUDA host may have no JAX installed
    jpso = jserial = None

FITNESS = ("cubic", "sphere", "rosenbrock", "griewank", "rastrigin", "ackley")
STATE = ("pos", "vel", "fit", "pbest_pos", "pbest_fit", "gbest_pos")


@pytest.fixture
def reference():
    """The JAX reference, for the parity tests."""
    if jpso is None:
        pytest.skip("needs the JAX reference package `repro`, and JAX is "
                    "not installed")


def _cfgs(fit, d=3, n=64, **kw):
    return (jpso.PSOConfig(dim=d, particle_cnt=n, fitness=fit, **kw),
            pso.PSOConfig(dim=d, particle_cnt=n, fitness=fit, **kw))


@pytest.mark.parametrize("fit", FITNESS)
def test_serial_swarm_bit_exact(fit, reference):
    jc, tc = _cfgs(fit)
    want, got = jserial.SerialSwarm(jc, seed=4), SerialSwarm(tc, seed=4)
    for f in STATE:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    wf, wp = want.run(20)
    gf, gp = got.run(20)
    assert gf == wf and np.array_equal(gp, wp)
    for f in STATE:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.gbest_fit == want.gbest_fit and got.iteration == 20


@pytest.mark.parametrize("fit", FITNESS)
def test_run_serial_fast_bit_exact(fit, reference):
    jc, tc = _cfgs(fit)
    wf, wp = jserial.run_serial_fast(jc, 7, 20)
    gf, gp = run_serial_fast(tc, 7, 20)
    assert gf == wf and np.array_equal(gp, wp)
    assert gp.dtype == np.float32


def test_serial_per_dimension_bounds_bit_exact(reference):
    kw = dict(min_pos=(-5.0, -1.0, 0.0), max_pos=(5.0, 2.0, 30.0))
    jc, tc = _cfgs("rosenbrock", **kw)
    assert run_serial_fast(tc, 3, 20)[0] == \
        jserial.run_serial_fast(jc, 3, 20)[0]
    want, got = jserial.SerialSwarm(jc, 3), SerialSwarm(tc, 3)
    want.run(10)
    got.run(10)
    for f in STATE:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


def test_serial_uniform_matches_torch_rng():
    """The numpy RNG mirror draws what ``core.rng`` draws."""
    from repro_torch.core import rng
    idx = np.arange(4096, dtype=np.uint32)
    want = rng.uniform(123, 7, 2, torch.arange(4096)).numpy()
    assert np.array_equal(serial._uniform(123, 7, 2, idx), want)


def test_serial_custom_objective_through_torch():
    """A Problem outside the six built-ins is evaluated by its torch
    ``max_fn`` on a CPU tensor: the sphere written as a custom objective
    runs as the numpy sphere does, within rounding."""
    mine = pso.Problem(name="neg_square", fn=lambda x: -torch.sum(x * x, -1),
                       lo=-100.0, hi=100.0)
    tc = pso.PSOConfig(dim=3, particle_cnt=64, fitness=mine)
    ref = pso.PSOConfig(dim=3, particle_cnt=64, fitness="sphere")
    got, want = SerialSwarm(tc, 1), SerialSwarm(ref, 1)
    got.run(5)
    want.run(5)
    np.testing.assert_allclose(got.pbest_fit, want.pbest_fit, rtol=1e-6)
    np.testing.assert_allclose(run_serial_fast(tc, 1, 5)[1],
                               run_serial_fast(ref, 1, 5)[1], rtol=1e-6)
