"""repro_torch.api on the CPU: solve and solve_many against
repro.solve/repro.solve_many(backend="jnp") for every variant at a few
iterations (solve_many homogeneous and with problems=), Method validation,
islands through the facade, the export surface against the reference's,
the features that are not ported yet, the no-card error, and the port's
independence of JAX and of the reference package.

Tolerance: three iterations from the same seed, positions within rtol=1e-4,
atol=1e-4 and fitness within rtol=1e-5 (the per-step differences of
tests/test_torch_core.py, compounded over three steps); solve_many's rows
also allow atol=1e-5 on fitness, as tests/test_torch_core.py does, because
a griewank row's fitness (about -0.7) cancels terms of order 1 whose cos
rounds differently in XLA and PyTorch."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro_torch import api
from repro_torch.core.problem import Problem

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)


def _close(got, want):
    np.testing.assert_allclose(got.state.pos.numpy(),
                               np.asarray(want.state.pos), **TRAJ_TOL)
    np.testing.assert_allclose(got.best_pos, want.best_pos, **TRAJ_TOL)
    np.testing.assert_allclose(got.best_fit, want.best_fit, rtol=1e-5)
    assert got.state.iteration == int(want.state.iteration)


@pytest.mark.parametrize("variant,backend", [
    ("reduction", "eager"), ("queue", "eager"), ("queue_lock", "eager"),
    ("async", "eager"), ("queue_lock", "kernel"), ("async", "kernel"),
    ("queue_lock", "auto"), ("async", "auto")])
def test_solve_cpu_matches_reference(variant, backend):
    kw = dict(dim=3, particles=128, iters=3, seed=7, variant=variant,
              sync_every=2)
    want = repro.solve("rastrigin", backend="jnp", **kw)
    got = repro_torch.solve("rastrigin", backend=backend, device="cpu", **kw)
    _close(got, want)
    assert float(got.state.gbest_fit) == float(got.state.pbest_fit.max())


SEEDS = [0, 1, 7, 42, 99, 123, 100000, 2 ** 31 - 5]
MIXED = ["cubic", "sphere", "rosenbrock", "griewank", "rastrigin", "ackley",
         "cubic", "ackley"]


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("variant,backend", [
    ("reduction", "eager"), ("queue", "eager"), ("queue_lock", "eager"),
    ("async", "eager"), ("queue_lock", "kernel"), ("async", "kernel")])
def test_solve_many_cpu_matches_reference(variant, backend, hetero):
    kw = dict(dim=3, particles=128, iters=3, variant=variant, sync_every=2)
    where = dict(problems=MIXED) if hetero else dict(problem="rastrigin")
    want = repro.solve_many(seeds=SEEDS, backend="jnp", **where, **kw)
    got = repro_torch.solve_many(seeds=SEEDS, backend=backend, device="cpu",
                                 **where, **kw)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.state.pos.numpy(),
                                   np.asarray(w.state.pos), **TRAJ_TOL)
        np.testing.assert_allclose(g.best_pos, w.best_pos, **TRAJ_TOL)
        np.testing.assert_allclose(g.best_fit, w.best_fit, rtol=1e-5,
                                   atol=1e-5)
        assert g.state.iteration == int(w.state.iteration)
        assert g.problem.name == w.problem.name
        assert (g.config.min_pos, g.config.max_v) == (w.config.min_pos,
                                                      w.config.max_v)
        assert float(g.state.gbest_fit) == float(g.state.pbest_fit.max())


def test_solve_many_rows_equal_solve_and_validate():
    kw = dict(dim=2, particles=64, iters=4, variant="async", sync_every=3,
              block_n=32, device="cpu")
    rows = repro_torch.solve_many("griewank", SEEDS[:3], **kw)
    for sd, r in zip(SEEDS[:3], rows):
        one = repro_torch.solve("griewank", seed=sd, **kw)
        assert torch.equal(r.state.pos, one.state.pos)
        assert r.best_fit == one.best_fit and r.iters == 4
    coeffs = ([0.7] * 3, [1.5] * 3, [1.5] * 3)
    tuned = repro_torch.solve_many("sphere", SEEDS[:3], coeffs=coeffs,
                                   **dict(kw, variant="queue"))
    assert len(tuned) == 3
    with pytest.raises(ValueError, match="coeffs"):
        repro_torch.solve_many("sphere", SEEDS[:3], coeffs=coeffs,
                               backend="kernel", **kw)
    with pytest.raises(ValueError, match="exactly one"):
        repro_torch.solve_many("sphere", SEEDS[:2], problems=MIXED[:2],
                               device="cpu")
    with pytest.raises(ValueError, match="bounds"):
        repro_torch.solve_many(problems=MIXED[:2], seeds=SEEDS[:2],
                               max_pos=1.0, device="cpu")
    with pytest.raises(ValueError, match="problems for"):
        repro_torch.solve_many(problems=MIXED[:2], seeds=SEEDS[:3],
                               device="cpu")


def test_solve_min_sense_and_per_dim_bounds():
    def shifted(x):
        return ((x - 1.0) ** 2).sum(-1)

    prob = Problem(name="shifted", fn=shifted, lo=(-2.0, -3.0),
                   hi=(2.0, 3.0), sense="min")
    got = repro_torch.solve(prob, particles=64, iters=40, variant="queue",
                            backend="eager", device="cpu")
    assert got.config.dim == 2
    assert 0.0 <= got.best_fit < 1e-2
    assert got.best_fit == -got.gbest_fit
    assert np.all(got.best_pos >= [-2.0, -3.0])


def test_best_picks_highest_fitness():
    rs = [repro_torch.solve("sphere", dim=2, particles=64, iters=i,
                            device="cpu") for i in (0, 5)]
    assert api.best(rs) is max(rs, key=lambda r: r.gbest_fit)
    with pytest.raises(ValueError):
        api.best([])


@pytest.mark.parametrize("kw,match", [
    (dict(variant="nope"), "unknown variant"),
    (dict(backend="jnp"), "unknown backend"),
    (dict(variant="queue", backend="kernel"), "backend='kernel'"),
    (dict(schedule="sometimes"), "unknown schedule"),
    (dict(rule="nope"), "unknown update rule"),
    (dict(topology="star"), "unknown topology"),
    (dict(islands=-1), "islands"),
    (dict(sync_every=0), "sync_every"),
    (dict(islands=2, schedule="auto"), "single-device schedules"),
])
def test_method_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        api.Method(**kw)


def test_method_auto_backend_follows_device():
    m = api.Method(variant="async")
    assert m.resolve_backend(torch.device("cuda")) == "kernel"
    assert m.resolve_backend(torch.device("cpu")) == "eager"
    assert api.Method(variant="queue").resolve_backend(
        torch.device("cuda")) == "eager"


@pytest.fixture
def custom_rules():
    """Two rules the CUDA kernels do not carry, registered for one test: a
    host-only rule and an elementwise, kernel-eligible one outside
    ``RULE_IDS``. Both advance like pso."""
    from repro_torch.core import update_rules as ur

    class HostRule(ur.PSORule):
        pass

    added = {"hostonly": HostRule("hostonly", kernel_eligible=False),
             "pso_twin": ur.PSORule("pso_twin")}
    ur.UPDATE_RULES.update(added)
    try:
        yield added
    finally:
        for name in added:
            del ur.UPDATE_RULES[name]


@pytest.mark.parametrize("rule", ["hostonly", "pso_twin"])
def test_method_refuses_kernel_backend_for_rules_without_kernel(
        custom_rules, rule):
    """Mirrors tests/test_update_rules.py::
    test_method_validates_rule_and_topology: a rule the CUDA kernels lack
    constructs, runs eager, is refused on backend='kernel' naming the
    kernel rules, and backend='auto' resolves to eager even on a card."""
    from repro_torch.core import update_rules as ur
    assert custom_rules["hostonly"].kernel_eligible is False
    assert custom_rules["hostonly"].rng_draws == 2
    for variant in ("queue_lock", "async"):
        api.Method(variant=variant, backend="eager", rule=rule)
        with pytest.raises(ValueError, match="kernel") as ei:
            api.Method(variant=variant, backend="kernel", rule=rule)
        assert all(n in str(ei.value) for n in ("pso", "sso", "lowcost"))
        m = api.Method(variant=variant, rule=rule)
        assert m.resolve_backend(torch.device("cuda")) == "eager"
        assert m.resolve_backend(torch.device("cpu")) == "eager"
    with pytest.raises(ValueError, match="lowcost"):
        ur.kernel_rule_id(rule)
    with pytest.raises(ValueError, match="kernel"):
        repro_torch.solve("sphere", dim=2, particles=64, iters=1,
                          variant="async", backend="kernel", rule=rule,
                          device="cpu")


def test_kernel_rule_ids_and_auto_backend(custom_rules):
    """The kernel rules keep their ids and the kernel under 'auto'; a
    custom rule runs through 'auto' on the eager engine, as the
    reference's eager engine runs it."""
    from repro_torch.core import update_rules as ur
    assert {n: ur.kernel_rule_id(n) for n in ur.RULE_IDS} == ur.RULE_IDS
    assert ur.kernel_rule_id(ur.UPDATE_RULES["sso"]) == 1
    for rule in ur.RULE_IDS:
        assert api.Method(variant="async", rule=rule).resolve_backend(
            torch.device("cuda")) == "kernel"
    got = repro_torch.solve("sphere", dim=3, particles=64, iters=5, seed=0,
                            variant="queue_lock", rule="pso_twin",
                            device="cpu")
    want = repro_torch.solve("sphere", dim=3, particles=64, iters=5, seed=0,
                             variant="queue_lock", rule="pso",
                             device="cpu")
    assert got.method.resolve_backend(torch.device("cpu")) == "eager"
    assert got.best_fit == want.best_fit


def test_method_and_loose_kwargs_are_exclusive():
    with pytest.raises(ValueError, match="either method="):
        repro_torch.solve("cubic", method=api.Method(), variant="queue",
                          device="cpu")


def test_method_facade_islands():
    """Method(islands=...) routes solve() through the island runner, as in
    the reference (tests/test_islands_ring.py): one async island is the
    single-swarm async solve, the facade's checks raise the reference's
    errors, and sync islands run (on the kernel backend through the fused
    kernel's plain version here)."""
    res = repro_torch.solve("rastrigin", dim=3, particles=128, iters=16,
                            seed=0, device="cpu", method=api.Method(
                                variant="async", islands=1,
                                exchange_interval=8, sync_every=4))
    ref = repro_torch.solve("rastrigin", dim=3, particles=128, iters=16,
                            seed=0, device="cpu", method=api.Method(
                                variant="async", sync_every=4))
    assert res.gbest_fit == ref.gbest_fit       # 1-island ring == one swarm
    assert res.method.islands == 1
    with pytest.raises(ValueError, match="solve_many"):
        repro_torch.solve_many("cubic", seeds=[0, 1], device="cpu",
                               method=api.Method(islands=2))
    with pytest.raises(ValueError, match="ring local loop"):
        api.Method(variant="async", backend="kernel", islands=2)
    for variant, backend in (("queue", "auto"), ("queue_lock", "kernel")):
        res_q = repro_torch.solve("rastrigin", dim=3, particles=128,
                                  iters=16, seed=0, device="cpu",
                                  method=api.Method(
                                      variant=variant, backend=backend,
                                      islands=4, exchange_interval=4))
        assert np.isfinite(res_q.gbest_fit)
        assert res_q.gbest_fit == float(res_q.state.pbest_fit.max())


def test_export_surface_matches_the_reference():
    """Every top-level name of repro exists in repro_torch, and repro.core
    and repro_torch.core export the same names, each importable."""
    import repro.core
    import repro_torch.core
    assert set(repro.__all__) <= set(repro_torch.__all__)
    assert set(repro.core.__all__) == set(repro_torch.core.__all__)
    for name in repro_torch.__all__:
        assert getattr(repro_torch, name) is not None, name
    for name in repro_torch.core.__all__:
        assert getattr(repro_torch.core, name) is not None, name
    from repro_torch.launch.serve import SolveServer
    from repro_torch.serving import ContinuousScheduler
    assert repro_torch.SolveServer is SolveServer
    assert repro_torch.ContinuousScheduler is ContinuousScheduler


@pytest.mark.parametrize("topology", ["ring", "vonneumann"])
def test_lbest_topology_runs_on_the_async_variant(topology):
    """The lbest topologies are ported: an async Method takes them on
    either backend, and ``solve`` carries them into the config."""
    for backend in ("auto", "eager", "kernel"):
        m = api.Method(variant="async", backend=backend, topology=topology)
        assert m.topology == topology
    res = repro_torch.solve("cubic", dim=2, particles=64, iters=6,
                            variant="async", topology=topology,
                            sync_every=2, device="cpu")
    assert res.config.topology == topology


@pytest.mark.parametrize("variant", ["reduction", "queue", "queue_lock"])
def test_lbest_topology_needs_the_async_variant(variant):
    """As in the reference: only the async variant has block-local bests
    for a neighbourhood pull."""
    with pytest.raises(ValueError, match="variant='async'"):
        api.Method(variant=variant, topology="ring")


def test_unported_entry_points_and_problem_fields_raise():
    # solve_stream is ported (item 6): an empty stream serves nothing
    assert api.solve_stream([], device="cpu") == []
    # constraints and kernel_fn are ported: what raises now is the
    # reference's validation of them
    with pytest.raises(TypeError, match="ConstraintSet"):
        Problem(name="c", fn=lambda x: x.sum(-1), constraints=object())
    with pytest.raises(ValueError, match="mutually exclusive"):
        Problem(name="k", fn=lambda x: x.sum(-1), kernel_fn=lambda p: p[0],
                constraints=repro_torch.ConstraintSet(
                    mode="projection",
                    projection=repro_torch.project_simplex))


def test_solve_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card error cannot occur")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.solve("cubic", iters=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.solve("cubic", iters=1, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.solve_many("cubic", [0, 1], iters=1)
    from repro_torch.core import multi_swarm
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multi_swarm.init_batch(repro_torch.PSOConfig(), [0, 1])


def test_registry_exports():
    assert repro_torch.list_problems()[:6] == tuple(sorted(
        ["ackley", "cubic", "griewank", "rastrigin", "rosenbrock", "sphere"]))
    assert repro_torch.get_problem("cubic") is repro_torch.resolve_problem(
        "cubic")
    assert callable(repro_torch.solve_many)
    from repro_torch import core
    assert core.solve_many is core.multi_swarm.solve_many
    assert {"SwarmBatch", "init_batch", "batch_row", "run_many",
            "best_of_batch"} <= set(dir(core))
    cfg = repro_torch.PSOConfig(dim=2, fitness="griewank").resolved()
    assert (cfg.min_pos, cfg.max_pos, cfg.max_v) == (-600.0, 600.0, 600.0)
    assert repro_torch.solve_stream is repro_torch.api.solve_stream


def test_importing_the_port_loads_no_jax_or_reference():
    code = ("import sys, repro_torch, repro_torch.api, "
            "repro_torch.core.multi_swarm, repro_torch.core.serial, "
            "repro_torch.kernels.ops, repro_torch.kernels.pso_step, "
            "repro_torch.kernels.gla, repro_torch.serving, "
            "repro_torch.launch.serve, repro_torch.launch.pso_run, "
            "repro_torch.checkpoint, repro_torch.runtime, "
            "repro_torch.core.distributed, repro_torch.core.tuner, "
            "repro_torch.core.autotune, repro_torch.roofline, "
            "repro_torch.roofline.pso_cost, repro_torch.configs, "
            "repro_torch.models, repro_torch.launch.steps, "
            "repro_torch.launch.train, repro_torch.optim, "
            "repro_torch.data, repro_torch.launch.dryrun, "
            "repro_torch.launch.hillclimb, repro_torch.launch.sharding, "
            "repro_torch.roofline.piecewise, repro_torch.roofline.report, "
            "repro_torch.examples.train_lm, "
            "repro_torch.examples.tune_lm_hparams, "
            "repro_torch.examples.quickstart, "
            "repro_torch.examples.constrained, "
            "repro_torch.examples.custom_objective\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(bad)\nassert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stdout + out.stderr


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax_or_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


# --- a history on the eager async engine with an explicit block_n -----------
# The port's history run passes the block count on (as its run without a
# history does), so a history never changes the trajectory; the reference's
# single-swarm history run drops it and takes the default block count
# (ROADMAP, parity contract: "History runs and block_n").

HISTORY_KW = dict(dim=4, particles=128, iters=8, seed=5)


def _async_run(mod, block_n: int, dtype: str, history: bool, backend: str):
    m = mod.Method(variant="async", sync_every=2, block_n=block_n,
                   record_history=history, backend=backend)
    extra = dict(device="cpu") if mod is repro_torch else {}
    return mod.solve("rastrigin", method=m, dtype=dtype, **HISTORY_KW,
                     **extra)


def _f32(pos) -> np.ndarray:
    if isinstance(pos, torch.Tensor):
        return pos.float().numpy()
    return np.asarray(pos).astype(np.float32)


@pytest.mark.parametrize("block_n", [64, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_history_run_keeps_the_block_count(dtype, block_n):
    """Several blocks: the port's history run equals its run without a
    history bit for bit, and the reference's run without a history (bit
    for bit in bfloat16, within TRAJ_TOL in float32), not the reference's
    history run, which runs one block."""
    hist = _async_run(repro_torch, block_n, dtype, True, "eager")
    plain = _async_run(repro_torch, block_n, dtype, False, "eager")
    assert torch.equal(hist.state.pos, plain.state.pos)
    assert torch.equal(hist.state.vel, plain.state.vel)
    assert hist.best_fit == plain.best_fit
    assert hist.history.gbest_fit[-1] == plain.best_fit
    want = _async_run(repro, block_n, dtype, False, "jnp")
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_f32(hist.state.pos),
                                      _f32(want.state.pos))
        assert hist.best_fit == want.best_fit
    else:
        np.testing.assert_allclose(_f32(hist.state.pos),
                                   _f32(want.state.pos), **TRAJ_TOL)
        np.testing.assert_allclose(hist.best_fit, want.best_fit, rtol=1e-5)
    theirs = _async_run(repro, block_n, dtype, True, "jnp")
    assert np.abs(_f32(hist.state.pos) - _f32(theirs.state.pos)).max() > 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_history_run_one_block_equals_the_reference_history(dtype):
    """One block (block_n = particles): the two packages' history runs
    agree, bit for bit in bfloat16 and within TRAJ_TOL in float32, their
    histories included."""
    got = _async_run(repro_torch, 128, dtype, True, "eager")
    want = _async_run(repro, 128, dtype, True, "jnp")
    np.testing.assert_array_equal(got.history.iteration,
                                  np.asarray(want.history.iteration))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_f32(got.state.pos),
                                      _f32(want.state.pos))
        np.testing.assert_array_equal(_f32(got.history.gbest_fit),
                                      _f32(want.history.gbest_fit))
    else:
        np.testing.assert_allclose(_f32(got.state.pos),
                                   _f32(want.state.pos), **TRAJ_TOL)
        np.testing.assert_allclose(got.history.gbest_fit,
                                   want.history.gbest_fit, rtol=1e-5)


# --- constrained problems and custom objectives through the facade ----------

@pytest.mark.parametrize("name", ["sphere_simplex", "sphere_simplex_pen"])
@pytest.mark.parametrize("variant,backend", [
    ("queue_lock", "eager"), ("async", "eager"), ("queue_lock", "kernel"),
    ("async", "kernel")])
def test_solve_constrained_cpu_matches_reference(name, variant, backend):
    """The registered constrained problems through ``solve`` on both
    backends (the kernel backend's split path in its plain versions)
    against ``repro.solve``; a penalised fitness also within atol 1e-5 (its
    violation cancels to a few ulps of 1, times the weight 50)."""
    kw = dict(dim=4, particles=128, iters=3, seed=7, variant=variant,
              sync_every=2, w=0.7, record_history=True)
    want = repro.solve(name, backend="jnp", **kw)
    got = repro_torch.solve(name, backend=backend, device="cpu", **kw)
    np.testing.assert_allclose(got.state.pos.numpy(),
                               np.asarray(want.state.pos), **TRAJ_TOL)
    np.testing.assert_allclose(got.best_pos, want.best_pos, **TRAJ_TOL)
    np.testing.assert_allclose(got.best_fit, want.best_fit, rtol=1e-5,
                               atol=1e-5)
    assert got.feasible == want.feasible
    assert got.first_feasible_iter == want.first_feasible_iter
    np.testing.assert_allclose(got.history.violation,
                               want.history.violation, rtol=1e-4, atol=1e-6)
    if name == "sphere_simplex":
        pos = got.state.pos
        assert float(pos.min()) >= 0.0
        np.testing.assert_allclose(pos.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("variant", ["queue_lock", "async"])
def test_solve_many_constrained_rows_equal_solve(variant):
    kw = dict(dim=4, particles=64, iters=4, variant=variant, sync_every=2,
              w=0.7, backend="kernel", record_history=True, device="cpu")
    rows = repro_torch.solve_many("sphere_simplex", [3, 4, 5], **kw)
    for sd, r in zip([3, 4, 5], rows):
        one = repro_torch.solve("sphere_simplex", seed=sd, **kw)
        assert torch.equal(r.state.pos, one.state.pos)
        assert r.best_fit == one.best_fit
        np.testing.assert_array_equal(r.history.violation,
                                      one.history.violation)
    assert repro_torch.best(rows).best_fit == min(r.best_fit for r in rows)


def test_custom_objective_on_the_kernel_backend_matches_eager():
    """A custom objective runs on the kernel backend (the split path) and
    equals the eager engine's queue variant bit for bit."""
    fn = lambda x: -(x * x).sum(-1)          # noqa: E731
    kw = dict(dim=3, particles=128, iters=5, seed=2, device="cpu")
    got = repro_torch.solve(fn, variant="queue_lock", backend="kernel",
                            telemetry=True, **kw)
    want = repro_torch.solve(fn, variant="queue", backend="eager", **kw)
    assert torch.equal(got.state.pos, want.state.pos)
    assert got.best_fit == want.best_fit
    assert got.telemetry.queue_updates == got.telemetry.publications > 0
