"""repro_torch.core.tuner on the CPU against repro.core.tuner: the tuner's
populations bit for bit for the same seed (both run numpy), and
``make_solve_many_fitness`` scores within FIT_TOL (tests/test_torch_core.py's
fitness tolerance; 8 iterations, within the parity contract's 10), then the
reference's tuner tests (tests/test_multi_swarm.py,
tests/test_constraints.py) on the port."""
import numpy as np
import pytest
import torch

from repro.core import PSOConfig as JConfig
from repro.core import tuner as jtuner
from repro_torch.core import PSOConfig, get_problem
from repro_torch.core.tuner import (PSO_COEFF_DIMS, PSOTuner, SearchDim,
                                    make_solve_many_fitness)

torch.set_num_threads(1)

FIT_TOL = dict(rtol=1e-5, atol=1e-5)
DIMS = PSO_COEFF_DIMS + (SearchDim("lr", 1e-4, 1e-1, log=True),)


@pytest.mark.parametrize("seed", [0, 7])
def test_ask_equals_the_reference_population(seed):
    jdims = [jtuner.SearchDim(d.name, d.low, d.high, d.log) for d in DIMS]
    mine, ref = PSOTuner(DIMS, particles=6, seed=seed), jtuner.PSOTuner(
        jdims, particles=6, seed=seed)
    rng = np.random.default_rng(seed)
    for _ in range(3):
        assert mine.ask() == ref.ask()
        fits = rng.normal(size=6)
        mine.tell(fits)
        ref.tell(fits)
    assert mine.gbest_fit == ref.gbest_fit
    np.testing.assert_array_equal(mine.gbest_pos, ref.gbest_pos)


@pytest.mark.parametrize("variant", ["queue", "async"])
def test_solve_many_fitness_scores_match_the_reference(variant):
    pop = PSOTuner(PSO_COEFF_DIMS, particles=5, seed=3).ask()
    kw = dict(seeds=[0, 1], iters=8, variant=variant, sync_every=4)
    mine = make_solve_many_fitness(
        PSOConfig(dim=5, particle_cnt=64, fitness="rastrigin"), device="cpu",
        **kw)(pop)
    ref = jtuner.make_solve_many_fitness(
        JConfig(dim=5, particle_cnt=64, fitness="rastrigin"), **kw)(pop)
    np.testing.assert_allclose(mine, np.asarray(ref), **FIT_TOL)


def test_tuner_batched_evaluation_on_solve_many():
    """The whole population x probe grid runs as one batched solve per
    tuner iteration; a batched score equals the candidate scored alone."""
    cfg = PSOConfig(dim=5, particle_cnt=64, fitness="rastrigin")
    bf = make_solve_many_fitness(cfg, seeds=[0, 1], iters=25, device="cpu")
    tuner = PSOTuner(PSO_COEFF_DIMS, particles=6, seed=0)
    res = tuner.run(batch_fitness=bf, iters=2)
    assert res.evaluations == 6 * 2
    assert np.isfinite(res.best_fitness)
    assert set(res.best_params) == {"w", "c1", "c2"}
    one = bf([res.best_params])
    np.testing.assert_allclose(one[0], res.best_fitness, rtol=1e-6)


def test_tuner_rejects_ambiguous_fitness_args():
    tuner = PSOTuner(PSO_COEFF_DIMS, particles=4)
    with pytest.raises(ValueError):
        tuner.run()
    with pytest.raises(ValueError):
        tuner.run(lambda p: 0.0, batch_fitness=lambda pop: [0.0] * len(pop))


def test_tuner_with_constrained_problem():
    cfg = PSOConfig(dim=4, particle_cnt=32,
                    fitness=get_problem("sphere_simplex"))
    bf = make_solve_many_fitness(cfg, seeds=[0, 1], iters=10, device="cpu")
    res = PSOTuner(PSO_COEFF_DIMS, particles=3, seed=0).run(
        batch_fitness=bf, iters=2)
    assert np.isfinite(res.best_fitness)
    assert res.best_fitness <= 0.0               # canonical max of -||x||^2


def test_solve_many_fitness_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card error cannot occur")
    bf = make_solve_many_fitness(PSOConfig(dim=2, particle_cnt=32), [0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bf([{"w": 0.7}])
