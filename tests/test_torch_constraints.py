"""repro_torch's constraints and custom objectives against repro's, on the
CPU (the split kernels on a card: tests/test_torch_split.py).

Every constraint function is written twice, in jnp for the reference and in
torch for the port, and both sides start from the same numpy state. What is
held, and how tightly:

* violations, the Deb rule, the penalised ``max_fn``, the repair init and
  ``Problem`` validation: exactly (the counter RNG is bit-exact);
* ``project_simplex``: atol 1e-6 (XLA's cumsum may sum in another order);
* the eager engine against ``repro.core.pso``, one step at a time from the
  reference's state (the parity contract): positions rtol 1e-6, atol 1e-6,
  fitness rtol 1e-5 (a penalised fitness sums its violation in another
  order, a few ulps apart, as the reference's own constrained kernel tests
  allow);
* the split path's plain versions against the port's eager engine: bit for
  bit (fused against ``run(..., "queue")``, async against
  ``run_async(n_blocks=nb)``);
* one-block split runs against the Pallas kernels in interpret mode:
  positions rtol 1e-5 / atol 1e-6, gbest rel 1e-6, the reference's own
  tolerances for its converted kernels (tests/test_constraints.py). A
  penalised gbest (and a ramped solve's) is held to ``PEN_ULPS`` ulps of 1
  times the penalty weight instead: its violation ``|sum(x) - 1|`` cancels
  to a few ulps of 1, which the weight scales, so across frameworks it
  cannot meet a relative 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.api
import repro_torch
from repro.core import constraints as jcons
from repro.core import pso as jpso
from repro.core import serial as jserial
from repro.kernels import ops as jops
from repro_torch import api
from repro_torch.core import constraints as cons
from repro_torch.core import multi_swarm as ms
from repro_torch.core import pso, serial
from repro_torch.kernels import ops, pso_split

torch.set_num_threads(1)

STEP_TOL = dict(rtol=1e-6, atol=1e-6)
FIT_TOL = dict(rtol=1e-5, atol=1e-6)
KERNEL_POS_TOL = dict(rtol=1e-5, atol=1e-6)
PEN_ULPS = 4


def _pen_atol(weight: float) -> float:
    return PEN_ULPS * weight * 2.0 ** -23


# --- problems, written in both frameworks -----------------------------------

def _plane_ball(lib, tries=64):
    """Repair mode: maximize sum(x) in [-2, 2]^D subject to ||x||^2 <= 2.25.
    The box corner beats every feasible point, so only the Deb fold keeps
    the pbests feasible (the reference test's ``_plane_ball``)."""
    t = lib is torch
    sm = (lambda x: torch.sum(x, -1)) if t else (lambda x: jnp.sum(x, -1))
    sq = ((lambda x: torch.sum(x * x, -1)) if t
          else (lambda x: jnp.sum(x * x, -1)))
    m = cons if t else jcons
    P = repro_torch.Problem if t else repro.Problem
    return P(name="plane_ball", fn=sm, lo=-2.0, hi=2.0,
             constraints=m.ConstraintSet(
                 constraints=(m.Constraint(fn=lambda x: sq(x) - 2.25,
                                           name="ball"),),
                 mode="repair", repair_tries=tries))


def _problem(lib, name):
    if name == "plane_ball":
        return _plane_ball(lib)
    get = (repro_torch.get_problem if lib is torch
           else repro.core.problem.get_problem)
    return get(name)


def _custom(lib):
    """An unconstrained custom objective: the sphere, maximized."""
    if lib is torch:
        return repro_torch.Problem(name="my_sphere",
                                   fn=lambda x: -torch.sum(x * x, -1),
                                   lo=-5.0, hi=5.0)
    return repro.Problem(name="my_sphere", fn=lambda x: -jnp.sum(x * x, -1),
                         lo=-5.0, hi=5.0)


PROBLEMS = ("sphere_simplex", "sphere_simplex_pen", "plane_ball")


def _dim(name: str) -> int:
    """d=3 for plane_ball, whose ball holds a fifth of the box there, so
    every repaired particle starts feasible; d=5 otherwise."""
    return 3 if name == "plane_ball" else 5


def _cfgs(name, d=None, n=64, w=0.7):
    d = _dim(name) if d is None else d
    return (jpso.PSOConfig(dim=d, particle_cnt=n, w=w,
                           fitness=_problem(jnp, name)).resolved(),
            pso.PSOConfig(dim=d, particle_cnt=n, w=w,
                          fitness=_problem(torch, name)).resolved())


def _np(s):
    return {k: (None if getattr(s, k) is None else np.asarray(getattr(s, k)))
            for k in s._fields}


def _torch_state(js):
    return pso.state_from_numpy(_np(js), device="cpu")


def _equal_states(a, b, fields=("pos", "vel", "pbest_pos", "pbest_fit",
                                "gbest_pos", "gbest_fit")):
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# --- Constraint / ConstraintSet / Problem ----------------------------------

def test_constraint_violation_forms():
    x = np.array([[0.3, 0.3], [0.9, 0.9], [-0.2, 0.5]], np.float32)
    for kind, tol in (("ineq", 1e-6), ("eq", 0.1)):
        want = jcons.Constraint(fn=lambda p: jnp.sum(p, -1) - 1.0, kind=kind,
                                tol=tol).violation(jnp.asarray(x))
        got = cons.Constraint(fn=lambda p: torch.sum(p, -1) - 1.0, kind=kind,
                              tol=tol).violation(torch.from_numpy(x))
        assert np.array_equal(got.numpy(), np.asarray(want))
    pairs = [(jcons, jnp, jnp.asarray), (cons, torch, torch.from_numpy)]
    aggs = []
    for m, lib, put in pairs:
        cs = m.ConstraintSet(constraints=(
            m.Constraint(fn=lambda p, lib=lib: lib.sum(p, -1) - 1.0),
            m.Constraint(fn=lambda p, lib=lib: lib.sum(p, -1) - 1.0,
                         kind="eq", tol=0.1)), mode="penalty")
        aggs.append(np.asarray(cs.violation(put(x))))
    assert np.array_equal(aggs[0], aggs[1])
    empty = cons.ConstraintSet(mode="projection",
                               projection=cons.project_simplex)
    assert float(empty.violation(torch.tensor([5.0, 5.0]))) == 0.0


@pytest.mark.parametrize("make,exc,match", [
    (lambda m, f: m.Constraint(fn=f, kind="leq"), ValueError, "kind"),
    (lambda m, f: m.Constraint(fn=1.0), TypeError, "callable"),
    (lambda m, f: m.Constraint(fn=f, tol=-1.0), ValueError, "tol"),
    (lambda m, f: m.ConstraintSet(constraints=(m.Constraint(fn=f),),
                                  mode="clip"), ValueError, "mode"),
    (lambda m, f: m.ConstraintSet(constraints=(m.Constraint(fn=f),),
                                  mode="projection"), ValueError,
     "projection"),
    (lambda m, f: m.ConstraintSet(constraints=(m.Constraint(fn=f),),
                                  mode="penalty", projection=lambda x: x),
     ValueError, "projection"),
    (lambda m, f: m.ConstraintSet(constraints=(), mode="penalty"),
     ValueError, "at least one"),
    (lambda m, f: m.ConstraintSet(constraints=(f,)), TypeError,
     "Constraint instances"),
    (lambda m, f: m.ConstraintSet(constraints=(m.Constraint(fn=f),),
                                  weight=0.0), ValueError, "weight"),
    (lambda m, f: m.ConstraintSet(constraints=(m.Constraint(fn=f),),
                                  ramp_every=-1), ValueError, "ramp"),
    (lambda m, f: m.constraint_from_spec("sum(x) < 1"), ValueError,
     "cannot parse"),
    (lambda m, f: m.constraint_set_from_cli(["sum(x)<=1"], "projection"),
     ValueError, "simplex"),
])
def test_validation_errors_match_reference(make, exc, match):
    msgs = []
    for m in (jcons, cons):
        with pytest.raises(exc, match=match) as err:
            make(m, lambda x: x.sum(-1))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_problem_constraint_validation():
    fn = lambda x: -(x * x).sum(-1)        # noqa: E731
    with pytest.raises(TypeError, match="ConstraintSet"):
        repro_torch.Problem(name="x", fn=fn, constraints="simplex")
    with pytest.raises(ValueError, match="mutually exclusive"):
        repro_torch.Problem(name="x", fn=fn, kernel_fn=lambda p: p.sum(0),
                            constraints=cons.ConstraintSet(
                                constraints=(cons.Constraint(fn=fn),)))
    p = repro_torch.get_problem("sphere_simplex")
    assert p.constrained and p.projection_fn is cons.project_simplex
    assert p.deb and not repro_torch.get_problem("sphere_simplex_pen").deb
    assert "sphere_simplex" in repro_torch.list_problems()
    hash(p)
    with pytest.raises(ValueError, match="penalty-mode"):
        p.with_penalty_weight(2.0)


def test_deb_improved_matches_reference_on_a_grid():
    fits = np.array([-1.0, 0.0, 0.5, 1.0], np.float32)
    viols = np.array([0.0, -0.0, 1e-7, 0.5, 2.0], np.float32)
    g = np.array(np.meshgrid(fits, viols, fits, viols, indexing="ij"))
    g = g.reshape(4, -1)
    want = np.asarray(jcons.deb_improved(*map(jnp.asarray, g)))
    got = cons.deb_improved(*map(torch.from_numpy, g)).numpy()
    assert got.dtype == np.bool_ and np.array_equal(got, want)
    assert want.any() and not want.all()


def test_project_simplex_matches_reference():
    rng = np.random.default_rng(0)
    for shape in ((7, 5), (3, 4, 8), (16, 1)):
        x = (rng.normal(size=shape) * 2).astype(np.float32)
        want = np.asarray(jcons.project_simplex(jnp.asarray(x)))
        got = cons.project_simplex(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert got.min() >= 0.0
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    known = {(5.0, 5.0): (0.5, 0.5), (2.0, 0.0, 0.0): (1.0, 0.0, 0.0),
             (0.25, 0.75): (0.25, 0.75), (-1.0, -1.0, -1.0): (1 / 3,) * 3}
    for x, want in known.items():
        got = cons.project_simplex(torch.tensor(x))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    r2 = cons.project_simplex(torch.tensor([3.0, 1.0]), radius=2.0)
    np.testing.assert_allclose(r2.numpy(), [2.0, 0.0])


def test_penalised_max_fn_matches_reference():
    x = np.random.default_rng(1).uniform(0, 1, (9, 6)).astype(np.float32)
    want = repro.core.problem.get_problem("sphere_simplex_pen").max_fn(
        jnp.asarray(x))
    p = repro_torch.get_problem("sphere_simplex_pen")
    got = p.max_fn(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    v = p.violation_fn(torch.from_numpy(x))
    np.testing.assert_allclose(
        got.numpy(), -(torch.from_numpy(x) ** 2).sum(-1) - 50.0 * v,
        rtol=1e-6)
    assert p.max_fn is p.max_fn
    heavier = p.with_penalty_weight(100.0)
    assert heavier.constraints.weight == 100.0 and heavier.max_fn is not \
        p.max_fn


@pytest.mark.parametrize("name,d,n", [("plane_ball", 3, 64),
                                      ("plane_ball", 8, 128)])
def test_repair_init_matches_reference_bitwise(name, d, n):
    jcfg, cfg = _cfgs(name, d=d, n=n)
    for seed in (0, 3):
        want = jpso.init_swarm(jcfg, seed)
        got = pso.init_swarm(cfg, seed, device="cpu")
        assert np.array_equal(got.pos.numpy(), np.asarray(want.pos))
        # A draw whose residual lies within an ulp of 0 could decide its
        # repair differently in another summation order; none does here.
        resid = (got.pos * got.pos).sum(-1) - 2.25
        near = int((resid.abs() < 1e-6).sum())
        assert near == 0, f"{near} draws within an ulp of the constraint"
    # batched init: each row is the standalone init
    b = ms.init_batch(cfg, [0, 3, 5], device="cpu")
    lone = pso.init_swarm(cfg, 5, device="cpu")
    assert torch.equal(b.pos[2], lone.pos)


def test_projection_init_and_serial_baseline():
    jcfg, cfg = _cfgs("sphere_simplex", d=6, n=32)
    got = pso.init_swarm(cfg, 2, device="cpu").pos.numpy()
    np.testing.assert_allclose(got, np.asarray(jpso.init_swarm(jcfg, 2).pos),
                               **STEP_TOL)
    assert got.min() >= 0.0
    # the serial baseline's constrained init and its projection hook (the
    # reference's SerialSwarm cannot step a constrained init: its projected
    # or repaired positions are a read-only array, so only its init is
    # compared, and the port's steps are held to feasibility)
    for name in ("sphere_simplex", "plane_ball"):
        jcfg, cfg = _cfgs(name, d=4, n=32)
        a, b = jserial.SerialSwarm(jcfg, 1), serial.SerialSwarm(cfg, 1)
        np.testing.assert_allclose(b.pos, a.pos, **STEP_TOL)
        b.run(3)
        if name == "sphere_simplex":
            assert b.pos.min() >= 0.0
            np.testing.assert_allclose(b.pos.sum(-1), 1.0, atol=1e-5)
        fa, pa = jserial.run_serial_fast(jcfg, 1, 4)
        fb, pb = serial.run_serial_fast(cfg, 1, 4)
        np.testing.assert_allclose(fb, fa, rtol=1e-5)
        np.testing.assert_allclose(pb, pa, rtol=1e-5, atol=1e-5)


# --- the eager engine against repro.core.pso --------------------------------

@pytest.mark.parametrize("name", PROBLEMS)
@pytest.mark.parametrize("variant", ["queue", "queue_lock", "reduction"])
def test_eager_steps_match_reference(name, variant):
    """One step at a time from the reference's state, 8 steps."""
    jcfg, cfg = _cfgs(name)
    js = jpso.init_swarm(jcfg, 4)
    for _ in range(8):
        want = jpso.STEP_FNS[variant](jcfg, js)
        got = pso.STEP_FNS[variant](cfg, _torch_state(js))
        for f in ("pos", "vel", "pbest_pos", "pbest_fit", "gbest_fit"):
            np.testing.assert_allclose(
                getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                **(FIT_TOL if f.endswith("fit") else STEP_TOL), err_msg=f)
        js = want
    if name == "plane_ball":            # the Deb fold keeps pbests feasible
        v = cfg.problem.violation_fn(_torch_state(js).pbest_pos)
        assert float(v.max()) <= 0.0


@pytest.mark.parametrize("name", PROBLEMS)
def test_eager_async_matches_reference(name):
    jcfg, cfg = _cfgs(name)
    js = jpso.init_swarm(jcfg, 6)
    want = jpso.run_async(jcfg, js, 6, sync_every=3, n_blocks=2)
    got = pso.run_async(cfg, _torch_state(js), 6, sync_every=3, n_blocks=2)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got.gbest_fit), float(want.gbest_fit),
                               rtol=1e-5)


def test_run_with_history_reports_violations():
    jcfg, cfg = _cfgs("sphere_simplex_pen")
    js = jpso.init_swarm(jcfg, 0)
    _, (jits, jf, jv) = jpso.run_with_history(jcfg, js, 5, "queue")
    _, (its, f, v) = pso.run_with_history(cfg, _torch_state(js), 5, "queue")
    assert its == jits
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-7)
    _, (_, _, none) = pso.run_with_history(
        pso.PSOConfig(dim=2, particle_cnt=32).resolved(),
        pso.init_swarm(pso.PSOConfig(dim=2, particle_cnt=32), 0,
                       device="cpu"), 2)
    assert none is None


# --- the split path ---------------------------------------------------------

SPLIT_PROBLEMS = PROBLEMS + ("custom",)


def _port_problem(name):
    if name == "custom":
        return _custom(torch)
    return _problem(torch, name)


def test_kernel_fn_takes_the_split_path_only():
    """A D-major ``kernel_fn`` replaces ``max_fn`` on the split path (it
    sums over D in its own order, so fitness agrees to rounding) and the
    eager engine ignores it."""
    calls = []

    def kfn(p):
        calls.append(tuple(p.shape))
        return -torch.sum(p * p, 0)
    prob = repro_torch.Problem(name="my_sphere_k",
                               fn=lambda x: -torch.sum(x * x, -1),
                               kernel_fn=kfn, lo=-5.0, hi=5.0)
    cfg = pso.PSOConfig(dim=5, particle_cnt=64, w=0.7,
                        fitness=prob).resolved()
    s0 = pso.init_swarm(cfg, 2, device="cpu")
    want = pso.run(cfg, s0, 5, "queue")
    assert not calls
    got = ops.run_queue_lock_fused(cfg, s0, 5, block_n=16)
    assert calls == [(5, 64)] * 5
    np.testing.assert_allclose(got.pos.numpy(), want.pos.numpy(),
                               **STEP_TOL)
    np.testing.assert_allclose(got.pbest_fit.numpy(),
                               want.pbest_fit.numpy(), **FIT_TOL)


@pytest.mark.parametrize("name", SPLIT_PROBLEMS)
@pytest.mark.parametrize("block_n", [64, 16])
def test_split_fused_equals_eager_queue_bitwise(name, block_n):
    cfg = pso.PSOConfig(dim=_dim(name), particle_cnt=64, w=0.7,
                        fitness=_port_problem(name)).resolved()
    s0 = pso.init_swarm(cfg, 2, device="cpu")
    want = pso.run(cfg, s0, 7, "queue")
    got = ops.run_queue_lock_fused(cfg, s0, 7, block_n=block_n)
    _equal_states(got, want)
    one = ops.queue_step(cfg, s0, block_n=block_n)
    _equal_states(one, pso.step_queue(cfg, s0))


@pytest.mark.parametrize("name", SPLIT_PROBLEMS)
@pytest.mark.parametrize("sync_every", [1, 3])
def test_split_async_equals_eager_bitwise(name, sync_every):
    cfg = pso.PSOConfig(dim=_dim(name), particle_cnt=64, w=0.7,
                        fitness=_port_problem(name)).resolved()
    s0 = pso.init_swarm(cfg, 3, device="cpu")
    want = pso.run_async(cfg, s0, 7, sync_every=sync_every, n_blocks=4)
    got = ops.run_queue_lock_fused_async(cfg, s0, 7, sync_every=sync_every,
                                         block_n=16)
    _equal_states(got, want)
    assert torch.equal(got.lbest_pos, want.lbest_pos)
    assert torch.equal(got.lbest_fit, want.lbest_fit)
    # resumed from the carried locals, it stays the uninterrupted run
    more = ops.run_queue_lock_fused_async(cfg, got, 5, sync_every=sync_every,
                                          block_n=16)
    _equal_states(more, pso.run_async(cfg, want, 5, sync_every=sync_every,
                                      n_blocks=4))


@pytest.mark.parametrize("name", PROBLEMS)
def test_split_async_one_block_equals_fused(name):
    cfg = pso.PSOConfig(dim=_dim(name), particle_cnt=64, w=0.7,
                        fitness=_port_problem(name)).resolved()
    s0 = pso.init_swarm(cfg, 1, device="cpu")
    f = ops.run_queue_lock_fused(cfg, s0, 8, block_n=64)
    for se in (1, 2, 4, 8):
        a = ops.run_queue_lock_fused_async(cfg, s0, 8, sync_every=se,
                                           block_n=64)
        _equal_states(a, f)


@pytest.mark.parametrize("name", ["sphere_simplex", "sphere_simplex_pen",
                                  "plane_ball"])
def test_split_one_block_matches_pallas_interpret(name):
    jcfg, cfg = _cfgs(name, n=64)
    js = jpso.init_swarm(jcfg, 1)
    s0 = _torch_state(js)
    want = jops.run_queue_lock_fused(jcfg, js, iters=8, block_n=64)
    got = ops.run_queue_lock_fused(cfg, s0, 8, block_n=64)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               **KERNEL_POS_TOL)
    cs = cfg.problem.constraints
    assert float(got.gbest_fit) == pytest.approx(
        float(want.gbest_fit), rel=1e-6,
        abs=_pen_atol(cs.weight) if cs.mode == "penalty" else None)
    if name == "sphere_simplex":
        want = jops.run_queue_lock_fused_async(jcfg, js, iters=8,
                                               sync_every=4, block_n=64)
        got = ops.run_queue_lock_fused_async(cfg, s0, 8, sync_every=4,
                                             block_n=64)
        np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                                   **KERNEL_POS_TOL)
        assert float(got.gbest_fit) == pytest.approx(
            float(want.gbest_fit), rel=1e-6)


@pytest.mark.parametrize("name", ["sphere_simplex", "plane_ball"])
@pytest.mark.parametrize("async_", [False, True])
def test_split_carried_pbest_violation_is_exact(name, async_):
    """pbv carries violation_fn(pbest_pos) where the reference recomputes
    it: after a run the two are equal exactly."""
    cfg = pso.PSOConfig(dim=_dim(name), particle_cnt=64, w=0.7,
                        fitness=_port_problem(name)).resolved()
    s0 = pso.init_swarm(cfg, 5, device="cpu")
    state = list(ops.state_to_kernel(s0))
    state[4] = state[4][:, None]
    prob = cfg.problem
    pbv = prob.violation_fn(s0.pbest_pos).contiguous()
    seeds, its = ops._seed_rows(s0)
    kw = {}
    if async_:
        state += [state[4].repeat(1, 4), state[5].repeat(4)]
        kw["sync_every"] = 3
    step = pso_split.torch_step((prob,), None, 64, (64,))
    pso_split.iterate(tuple(state), seeds, its, (ops.kernel_spec(cfg),), None,
                      step, n=64, block_n=16, off=0, iters=9, pbv=pbv, **kw)
    pbest = ops.unpack_dmajor(state[2])
    assert torch.equal(pbv, prob.violation_fn(pbest))
    if name == "plane_ball":
        assert float(pbv.max()) <= 0.0


def test_split_batch_rows_and_hetero_custom_member():
    """A homogeneous batch's rows, and a heterogeneous table holding a
    custom and a penalty member beside a built-in, each equal their
    standalone split runs."""
    cfg = pso.PSOConfig(dim=4, particle_cnt=64, w=0.7,
                        fitness="sphere_simplex").resolved()
    b = ms.init_batch(cfg, [0, 1, 2], device="cpu")
    out = ops.run_queue_lock_fused_async_batch(cfg, b, 6, sync_every=2,
                                               block_n=32)
    lone = ops.run_queue_lock_fused_async(
        cfg, pso.init_swarm(cfg, 1, device="cpu"), 6, sync_every=2,
        block_n=32)
    _equal_states(ms.batch_row(out, 1), lone)
    table = (repro_torch.get_problem("cubic"), _custom(torch),
             repro_torch.get_problem("sphere_simplex_pen"))
    probs = [table[1], table[0], table[2], table[1]]
    rows, table = ms.problem_rows(probs, 4, table=table, device="cpu")
    assert rows.cmode.tolist() == [0, 0, 1, 0]
    assert rows.pweight.tolist() == [0.0, 0.0, 50.0, 0.0]
    base = pso.PSOConfig(dim=4, particle_cnt=64, w=0.7)
    rcfg = base.resolved()
    seeds = [4, 5, 6, 7]
    hb = ms.init_batch(rcfg, seeds, rows=rows, table=table, device="cpu")
    for variant in ("queue_lock", "async"):
        got, _, _ = ops.run_queue_lock(rcfg, hb, 6, variant, sync_every=2,
                                       block_n=32, fids=rows.fid,
                                       table=table)
        eager = ms.run_many(rcfg, hb, 6, "queue" if variant == "queue_lock"
                            else variant, sync_every=2, rows=rows,
                            table=table, n_blocks=2)
        _equal_states(got, eager)
        for s, (p, sd) in enumerate(zip(probs, seeds)):
            mcfg = pso.hetero_member_config(base, p)
            want, _, _ = ops.run_queue_lock(
                mcfg, pso.init_swarm(mcfg, sd, device="cpu"), 6, variant,
                sync_every=2, block_n=32)
            for f in ("pos", "gbest_pos", "gbest_fit"):
                assert torch.equal(getattr(ms.batch_row(got, s), f),
                                   getattr(want, f)), (variant, s, f)


def test_hetero_table_rejects_projection_and_repair():
    for p in (repro_torch.get_problem("sphere_simplex"),
              _plane_ball(torch)):
        for mod, prob in ((ms, p),):
            with pytest.raises(ValueError, match="projection/repair"):
                mod.problem_rows([prob], 3, table=(prob,), device="cpu")
    with pytest.raises(ValueError, match="projection/repair"):
        repro.core.multi_swarm.problem_rows(
            [_plane_ball(jnp)], 3, table=(_plane_ball(jnp),))


def test_split_counters_meet_the_invariants():
    cfg = pso.PSOConfig(dim=5, particle_cnt=64, w=0.7,
                        fitness="sphere_simplex").resolved()
    s0 = pso.init_swarm(cfg, 0, device="cpu")
    f, cf = ops.run_queue_lock_fused(cfg, s0, 10, block_n=16,
                                     telemetry=True)
    q, p, b = cf.tolist()
    assert q == p and 0 < p <= b <= 10 * 4
    a, ca = ops.run_queue_lock_fused_async(cfg, s0, 10, sync_every=4,
                                           block_n=16, telemetry=True)
    q, p, b = ca.tolist()
    assert p <= 3 and q <= b <= 10 * 4
    _equal_states(ops.run_queue_lock_fused(cfg, s0, 10, block_n=16), f)


# --- the facade: ramp, feasibility, best ------------------------------------

def test_ramp_segments_and_reweight_match_reference():
    jp = repro.core.problem.get_problem("sphere_simplex_pen")
    p = repro_torch.get_problem("sphere_simplex_pen")
    jc = jcons.ConstraintSet(constraints=jp.constraints.constraints,
                             mode="penalty", weight=50.0, ramp=2.0,
                             ramp_every=4)
    c = cons.ConstraintSet(constraints=p.constraints.constraints,
                           mode="penalty", weight=50.0, ramp=2.0,
                           ramp_every=4)
    for iters in (1, 4, 10, 16):
        assert api._ramp_segments(iters, c) == \
            repro.api._ramp_segments(iters, jc)
    assert api._ramp_segments(7, None) == [(7, None)]
    jcfg = jpso.PSOConfig(dim=4, particle_cnt=32,
                          fitness=jp.with_penalty_weight(200.0)).resolved()
    cfg = pso.PSOConfig(dim=4, particle_cnt=32,
                        fitness=p.with_penalty_weight(200.0)).resolved()
    js = jpso.run(jcfg, jpso.init_swarm(jcfg, 0), 3, "queue")
    want = repro.api._reweight_state(jcfg, js)
    got = api._reweight_state(cfg, _torch_state(js))
    for f in ("fit", "pbest_fit", "gbest_pos", "gbest_fit"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6)
    jb = repro.core.multi_swarm.init_batch(jcfg, np.arange(8))
    wb = repro.api._reweight_batch(jcfg, jb)
    gb = api._reweight_state(cfg, ms.init_batch(cfg, np.arange(8),
                                                device="cpu"))
    for f in ("pbest_fit", "gbest_pos", "gbest_fit"):
        np.testing.assert_allclose(getattr(gb, f).numpy(),
                                   np.asarray(getattr(wb, f)), rtol=1e-6)


@pytest.mark.parametrize("backend", ["eager", "kernel"])
@pytest.mark.parametrize("variant", ["queue_lock", "async"])
def test_ramped_solve_matches_reference(backend, variant):
    cs = dict(mode="penalty", weight=50.0, ramp=2.0, ramp_every=3)
    jp = repro.core.problem.get_problem("sphere_simplex_pen")
    jprob = jcons.constrain_problem(jp, jcons.ConstraintSet(
        constraints=jp.constraints.constraints, **cs), name="ramped")
    p = repro_torch.get_problem("sphere_simplex_pen")
    prob = cons.constrain_problem(p, cons.ConstraintSet(
        constraints=p.constraints.constraints, **cs), name="ramped")
    kw = dict(dim=4, particles=64, iters=8, seed=3, variant=variant,
              sync_every=2, w=0.7, record_history=True)
    want = repro.solve(jprob, backend="jnp", **kw)
    got = repro_torch.solve(prob, backend=backend, device="cpu", **kw)
    np.testing.assert_allclose(got.best_pos, want.best_pos, rtol=1e-4,
                               atol=1e-5)
    last_weight = 50.0 * 2.0 ** 2          # the third segment's
    assert got.best_fit == pytest.approx(want.best_fit, rel=1e-5,
                                         abs=_pen_atol(last_weight))
    assert np.array_equal(got.history.iteration, want.history.iteration)
    np.testing.assert_allclose(got.history.violation, want.history.violation,
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", PROBLEMS)
def test_result_feasibility_and_best_match_reference(name):
    """The eager engines on both sides (the same queue_lock semantics:
    gbest from the Deb-folded pbests), then the kernel backend's results
    against its own batched rows."""
    kw = dict(dim=_dim(name), particles=64, iters=6, variant="queue_lock",
              w=0.7, record_history=True)
    seeds = [0, 1, 2, 3]
    want = [repro.solve(_problem(jnp, name), seed=sd, backend="jnp", **kw)
            for sd in seeds]
    got = [repro_torch.solve(_problem(torch, name), seed=sd,
                             backend="eager", device="cpu", **kw)
           for sd in seeds]
    for g, w in zip(got, want):
        assert g.feasible == w.feasible
        assert g.violation == pytest.approx(w.violation, rel=1e-4, abs=1e-6)
        assert g.first_feasible_iter == w.first_feasible_iter
    assert seeds[got.index(repro_torch.best(got))] == \
        seeds[want.index(repro.best(want))]
    got = [repro_torch.solve(_problem(torch, name), seed=sd,
                             backend="kernel", device="cpu", **kw)
           for sd in seeds]
    many = repro_torch.solve_many(_problem(torch, name), seeds, device="cpu",
                                  backend="kernel", **kw)
    for g, r in zip(got, many):
        _equal_states(g.state, r.state)
        np.testing.assert_array_equal(g.history.violation,
                                      r.history.violation)


def test_best_prefers_feasible_then_least_violation():
    def fake(fit, viol):
        prob = repro_torch.Problem(
            name="f", fn=lambda x: x.sum(-1), constraints=cons.ConstraintSet(
                constraints=(cons.Constraint(fn=lambda x: x[..., 0]),)))
        st = pso.SwarmState(*(torch.zeros(1),) * 5,
                            gbest_pos=torch.tensor([viol]),
                            gbest_fit=torch.tensor(fit), iteration=0, seed=0)
        return api.Result(problem=prob, config=None, method=api.Method(),
                          iters=0, state=st)
    a, b, c = fake(5.0, 0.5), fake(1.0, 0.0), fake(9.0, 0.1)
    assert repro_torch.best([a, b, c]) is b
    assert repro_torch.best([a, c]) is c
    assert repro_torch.best([fake(1.0, -1.0), fake(2.0, 0.0)]).gbest_fit == 2


def test_auto_backend_takes_custom_objectives_to_the_kernel():
    m = api.Method(variant="queue_lock")
    assert m.resolve_backend(torch.device("cuda")) == "kernel"
    assert api.Method(variant="async").resolve_backend(
        torch.device("cuda")) == "kernel"
    got = repro_torch.solve(lambda x: -(x * x).sum(-1), dim=2, particles=64,
                            iters=4, variant="queue_lock", backend="kernel",
                            device="cpu")
    want = repro_torch.solve(lambda x: -(x * x).sum(-1), dim=2, particles=64,
                             iters=4, variant="queue", backend="eager",
                             device="cpu")
    _equal_states(got.state, want.state)
