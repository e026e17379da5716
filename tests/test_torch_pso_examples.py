"""The port's PSO examples (``repro_torch.examples.quickstart``,
``constrained``, ``custom_objective``) on the CPU against the reference's
``repro.solve`` / ``repro.solve_many`` with the same arguments on its jnp
engine, and their command line.

Each example's functions run at a small size on ``device="cpu"`` (the
kernel lines in their plain versions, the custom and constrained Problems
on the split path's plain versions). Tolerances, from the parity contract
(ROADMAP): trajectories of 5 iterations or fewer from the same seed are
compared step for step, positions within rtol = atol = 1e-4 and fitness
within rtol = 1e-5 (tests/test_torch_api.py's); a penalised fitness, whose
violation cancels to a few ulps of 1 times its weight, and solve_many's
rows also within atol 1e-5 (as there). Longer runs are held to invariants
and solution quality: gbest monotone, gbest equal to the best pbest,
positions in the box or on the simplex, and the reference's own asserts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro_torch import solve
from repro_torch.examples import constrained, custom_objective, quickstart

torch.set_num_threads(1)

POS_TOL = dict(rtol=1e-4, atol=1e-4)
FIT_RTOL = 1e-5
PEN_ATOL = 1e-5


def _close(got, want, fit_atol=0.0):
    np.testing.assert_allclose(got.state.pos.numpy(),
                               np.asarray(want.state.pos), **POS_TOL)
    np.testing.assert_allclose(got.best_pos, want.best_pos, **POS_TOL)
    np.testing.assert_allclose(got.best_fit, want.best_fit, rtol=FIT_RTOL,
                               atol=fit_atol)
    assert got.state.iteration == int(want.state.iteration)


# --- quickstart ----------------------------------------------------------------

@pytest.mark.parametrize("dim", [1, 12])
def test_quickstart_lines_match_reference(dim):
    """Every line of ``solve_and_report``: the four eager variants against
    the reference's jnp engine, the fused and async kernel lines (their
    plain versions here) against the same variants there."""
    n, iters = 128, 5
    got = quickstart.solve_and_report(dim, n, iters, device="cpu")
    assert list(got) == [v + " (eager)" for v in quickstart.EAGER_VARIANTS] \
        + [v + " (cuda)" for v, _ in quickstart.KERNEL_LINES]
    kw = dict(dim=dim, particles=n, iters=iters, seed=0, backend="jnp")
    for v in quickstart.EAGER_VARIANTS:
        _close(got[v + " (eager)"], repro.solve("cubic", variant=v, **kw))
    for v, extra in quickstart.KERNEL_LINES:
        res = got[v + " (cuda)"]
        assert res.method.backend == "kernel"
        _close(res, repro.solve("cubic", variant=v, **extra, **kw))


def test_quickstart_kernel_lines_cap_iterations(capsys):
    got = quickstart.solve_and_report(1, 64, 120, device="cpu")
    assert got["queue_lock (cuda)"].iters == 100
    assert got["reduction (eager)"].iters == 120
    out = capsys.readouterr().out
    assert "analytic optimum f(100)*d" in out and "(100 iters)" in out


def test_quickstart_batched_demo_matches_reference():
    kw = dict(seeds=range(8), dim=10, particles=64, iters=5)
    got = quickstart.batched_demo("cpu", **kw)
    want = repro.solve_many("rastrigin", variant="queue", backend="jnp", **kw)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        _close(g, w, fit_atol=PEN_ATOL)
    assert repro.best(want).best_fit == pytest.approx(
        max(g.best_fit for g in got), rel=FIT_RTOL)


def test_quickstart_one_island_matches_reference():
    """One island: the reference's one-device ring, the single-swarm async
    run."""
    got = quickstart.islands_demo("cpu", islands=1, dim=10, particles=256,
                                  iters=5)
    want = repro.solve("rastrigin", dim=10, particles=256, iters=5, seed=0,
                       method=repro.Method(variant="async", islands=1,
                                           exchange_interval=20,
                                           sync_every=5))
    _close(got, want)


def test_quickstart_four_islands_hold_the_invariants():
    """Four islands on one device (the reference needs four devices):
    after the drain the gbest is the best pbest, evaluated at its own
    position, and positions stay in the box."""
    got = quickstart.islands_demo("cpu", dim=10, particles=1024, iters=40)
    s = got.state
    assert got.method.islands == 4
    assert float(s.gbest_fit) == float(s.pbest_fit.max())
    cfg = got.config
    assert float(s.pos.min()) >= cfg.min_pos
    assert float(s.pos.max()) <= cfg.max_pos
    at = got.problem.fn(s.gbest_pos[None])
    assert got.best_fit == pytest.approx(float(at[0]), rel=FIT_RTOL)


# --- constrained ---------------------------------------------------------------

def _ramped_reference():
    p = constrained.RAMPED
    cs = p.constraints
    return repro.Problem(
        name=p.name, fn=lambda x: jnp.sum(x * x, axis=-1), lo=p.lo, hi=p.hi,
        sense=p.sense,
        constraints=repro.ConstraintSet(
            constraints=(
                repro.Constraint(fn=lambda x: jnp.sum(x, -1) - 1.0,
                                 kind="eq", tol=1e-5, name="sum=1"),
                repro.Constraint(fn=lambda x: jnp.max(-x, -1), name="x>=0")),
            mode=cs.mode, weight=cs.weight, ramp=cs.ramp,
            ramp_every=cs.ramp_every))


def test_constrained_runs_match_reference():
    """Every run of the example at 5 iterations: penalty, projection, the
    async kernel line (the split path), the ramp and the batch of seeds."""
    n, iters = 64, 5
    got = constrained.solve_all("cpu", particles=n, iters=iters,
                                kernel_iters=iters, seeds=3,
                                many_particles=n, many_iters=iters)
    kw = dict(dim=constrained.DIM, particles=n, iters=iters, seed=0, w=0.7,
              variant="queue_lock", backend="jnp", record_history=True)
    for key, prob in (("pen", "sphere_simplex_pen"),
                      ("proj", "sphere_simplex"),
                      ("ramp", _ramped_reference())):
        want = repro.solve(prob, **kw)
        _close(got[key], want, fit_atol=PEN_ATOL)
        assert got[key].feasible == want.feasible
        assert got[key].first_feasible_iter == want.first_feasible_iter
        np.testing.assert_allclose(got[key].history.violation,
                                   want.history.violation, rtol=1e-4,
                                   atol=1e-6)
    assert got["kernel"].method.backend == "kernel"
    _close(got["kernel"], repro.solve(
        "sphere_simplex_pen", dim=constrained.DIM, particles=n, iters=iters,
        seed=0, w=0.7, variant="async", backend="jnp", sync_every=10),
        fit_atol=PEN_ATOL)
    want = repro.solve_many("sphere_simplex_pen", seeds=range(3),
                            dim=constrained.DIM, particles=n, iters=iters,
                            w=0.7, variant="queue_lock", backend="jnp")
    for g, w in zip(got["many"], want):
        _close(g, w, fit_atol=PEN_ATOL)


def test_constrained_projection_is_feasible_and_monotone():
    """The example's projection run at its own size (d=8, 256 particles,
    300 iterations): every position on the simplex, gbest monotone over the
    history, and the reference's asserts (the optimum 1/8 within 1e-3)."""
    res = solve("sphere_simplex", dim=constrained.DIM, particles=256,
                iters=300, seed=0, w=0.7, variant="queue_lock",
                backend="eager", record_history=True, device="cpu")
    pos = res.state.pos
    assert float(pos.min()) >= 0.0
    np.testing.assert_allclose(pos.sum(-1).numpy(), 1.0, atol=1e-5)
    hist = np.asarray(res.history.gbest_fit)
    assert len(hist) == 300 and np.all(np.diff(hist) >= 0)
    assert float(res.state.gbest_fit) == float(res.state.pbest_fit.max())
    constrained.check(res)


# --- custom_objective ----------------------------------------------------------

def _bowl_reference():
    w, c = jnp.asarray(custom_objective.W), jnp.asarray(custom_objective.C)
    return repro.Problem(name="weighted_bowl",
                         fn=lambda x: jnp.sum(w * (x - c) ** 2, axis=-1),
                         lo=custom_objective.LO, hi=custom_objective.HI,
                         sense="min")


def test_custom_objective_runs_match_reference():
    """The eager queue run, the fused and async kernel lines (the split
    path) and the run by name, at 5 iterations."""
    n, iters = 64, 5
    got = custom_objective.solve_all("cpu", particles=n, iters=iters,
                                     kernel_iters=iters, name_particles=n,
                                     name_iters=iters)
    prob = _bowl_reference()
    kw = dict(particles=n, iters=iters, seed=0, backend="jnp")
    _close(got["eager"], repro.solve(prob, variant="queue", **kw))
    _close(got["fused"], repro.solve(prob, variant="queue_lock", **kw))
    _close(got["async"], repro.solve(prob, variant="async", sync_every=10,
                                     **kw))
    assert got["fused"].method.backend == got["async"].method.backend \
        == "kernel"
    _close(got["by_name"], repro.solve(prob, **kw))
    assert got["by_name"].config.dim == 3


def test_custom_objective_eager_run_passes_its_asserts():
    """The example's eager run at its own size (512 particles, 400
    iterations): the reference's asserts, near the optimum and in the
    per-dimension box."""
    res = custom_objective.solve_all("cpu", kernel_iters=1,
                                     name_particles=8, name_iters=1)["eager"]
    custom_objective.check(res)
    assert res.problem.sense == "min"
    np.testing.assert_allclose(res.best_pos, custom_objective.C, atol=0.2)


# --- the command line ----------------------------------------------------------

MODULES = [quickstart, constrained, custom_objective]


@pytest.mark.parametrize("mod", MODULES, ids=lambda m: m.__name__)
def test_examples_need_the_card_unless_told(mod, capsys):
    """Without a card and without ``--device cpu`` an example exits 2 with
    the device rule's message; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        mod.main([])
    assert e.value.code == 2
    assert "device='cpu'" in capsys.readouterr().err


@pytest.mark.parametrize("mod", [constrained, custom_objective],
                         ids=lambda m: m.__name__)
def test_examples_run_on_the_cpu_when_told(mod, capsys):
    assert mod.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "cuda" in out and "pallas" not in out


def test_problems_have_the_reference_fields():
    ref = _bowl_reference()
    got = custom_objective.problem
    assert (got.name, got.lo, got.hi, got.sense) == (ref.name, ref.lo,
                                                     ref.hi, ref.sense)
    ramp = _ramped_reference().constraints
    mine = constrained.RAMPED.constraints
    fields = ("mode", "weight", "ramp", "ramp_every")
    assert [getattr(mine, f) for f in fields] == \
        [getattr(ramp, f) for f in fields]
    assert [(c.kind, c.tol, c.name) for c in mine.constraints] == \
        [(c.kind, c.tol, c.name) for c in ramp.constraints]
