"""bfloat16 on the split path: custom and constrained Problems on the
kernel backend (the converted forms 1c, 2c, 3c, 5c, 6c), against the
reference at ``dtype="bfloat16"`` on the CPU.

First the constraint library's bfloat16 repairs, each against the
reference's own functions bit for bit: ``project_simplex`` (its prefix sums
rounded after every add, as ``jnp.cumsum`` does), the registered problems'
sums over D (float32 from 0 in dimension order, rounded once, as
``jnp.sum``), the weak-typed constants (a violation's ``tol``, the penalty
weight, the projection's radius), ``init_swarm``, and one step of the eager
engine (whose coefficients and scalar bounds are weak-typed too).

Then the split path's plain versions against the reference's converted
kernels in Pallas interpret mode, step by step from a shared state, bit for
bit: the queue step (two blocks), the fused mode and the async mode on one
block (with counters, and an lbest topology), the batched forms, for the
registered constrained problems and the tests' custom objectives, every
rule. The reference traces the user's functions into its kernel bodies,
and XLA:CPU compiles those with excess precision by default
(``xla_allow_excess_precision``): a bfloat16 product that feeds a sum is
then not rounded, so the kernel's objective differs from the same jnp
function run op by op, and from the port, by up to one bfloat16 rounding.
``strict`` compiles the reference's call with that option off, which
keeps every rounding its code writes; the port computes those. With the
default option a custom objective with no product feeding a sum (the L1
objective below) agrees all the same, and the facade tests use it; a plain
``torch.sum`` sphere is held to one rounding of its fitness
(``BF16_ULP``).

Several blocks: the fused mode is synchronous PPSO and the async mode the
eager engine's lockstep, so they equal the port's own bfloat16 eager
engine bit for bit (``step_queue`` iterated, ``run_async``). Card tests of
the bfloat16 split kernels are in ``tests/test_torch_split.py`` (no JAX
there)."""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import constraints as cons
from repro_torch.core import multi_swarm as ms
from repro_torch.core import pso
from repro_torch.core.fitness import sum_f32
from repro_torch.kernels import ops, pso_split
from repro_torch.launch.serve import SolveRequest
from repro_torch.serving import ContinuousScheduler

try:
    import jax
    import jax.numpy as jnp

    import repro
    from repro.core import constraints as jcons
    from repro.core import multi_swarm as jms
    from repro.core import pso as jpso
    from repro.kernels import ops as jops
    from repro.kernels import pso_step as jstep
    from repro.launch.serve import SolveRequest as JRequest
    from repro.serving import ContinuousScheduler as JScheduler
except ModuleNotFoundError:     # a CUDA host may have no JAX installed
    jax = jnp = repro = None

torch.set_num_threads(1)

BF = torch.bfloat16
CPU = "cpu"
RULES = ("pso", "sso", "lowcost")
#: One bfloat16 rounding of a fitness: 8 significant bits.
BF16_ULP = 2.0 ** -7
#: Coefficients that bfloat16 does not hold exactly.
COEF = dict(w=0.7, c1=1.4, c2=1.6)
#: XLA's option that keeps every bfloat16 rounding a traced function
#: writes (the module docstring).
STRICT = {"xla_allow_excess_precision": False}


@pytest.fixture
def reference():
    if repro is None:
        pytest.skip("needs the JAX reference package `repro`, and JAX is "
                    "not installed")


def strict(fn, *args):
    """``fn(*args)``, the reference's call, compiled with every bfloat16
    rounding kept."""
    return jax.jit(fn, compiler_options=STRICT)(*args)


def _t(x) -> torch.Tensor:
    a = jnp.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(BF)
    return torch.from_numpy(np.array(a))


def _j(x: torch.Tensor):
    return jnp.asarray(x.float().numpy(), jnp.bfloat16)


def _port(js) -> pso.SwarmState:
    """A reference state as the port's, on the CPU, in bfloat16."""
    kw = {k: (None if getattr(js, k) is None else _t(getattr(js, k)))
          for k in ("pos", "vel", "fit", "pbest_pos", "pbest_fit",
                    "gbest_pos", "gbest_fit", "lbest_pos", "lbest_fit")}
    return pso.SwarmState(iteration=int(js.iteration), seed=int(js.seed),
                          **kw)


FIELDS = ("pos", "vel", "pbest_pos", "pbest_fit", "gbest_pos", "gbest_fit",
          "lbest_pos", "lbest_fit")


def _same(got, want, what, fields=FIELDS):
    """Every field of two states (or batches) equal, bfloat16, bit for
    bit."""
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        if a is None or b is None:
            continue
        b = b.reshape(a.shape)
        assert a.dtype == b.dtype == BF, (what, f, a.dtype, b.dtype)
        assert torch.equal(a, b), (what, f, int((a != b).sum()))


# --- the problems, written in both frameworks --------------------------------

def _plane_ball(torch_side: bool):
    """Repair mode (the reference tests' ``_plane_ball``): maximize sum(x)
    in [-2, 2]^D subject to ||x||^2 <= 2.25; the sums in dimension order
    on the torch side (``sum_f32``), as ``jnp.sum`` takes them."""
    if torch_side:
        return repro_torch.Problem(
            name="plane_ball", fn=sum_f32, lo=-2.0, hi=2.0,
            constraints=cons.ConstraintSet(
                constraints=(cons.Constraint(
                    fn=lambda x: sum_f32(x * x) - 2.25, name="ball"),),
                mode="repair", repair_tries=64))
    return repro.Problem(
        name="plane_ball", fn=lambda x: jnp.sum(x, -1), lo=-2.0, hi=2.0,
        constraints=jcons.ConstraintSet(
            constraints=(jcons.Constraint(
                fn=lambda x: jnp.sum(x * x, -1) - 2.25, name="ball"),),
            mode="repair", repair_tries=64))


def _sphere(torch_side: bool):
    """A custom sphere, maximized, its sum in dimension order."""
    if torch_side:
        return repro_torch.Problem(name="my_sphere",
                                   fn=lambda x: -sum_f32(x * x),
                                   lo=-5.0, hi=5.0)
    return repro.Problem(name="my_sphere", fn=lambda x: -jnp.sum(x * x, -1),
                         lo=-5.0, hi=5.0)


def _l1(torch_side: bool, lo=-5.0, hi=5.0):
    """A custom objective with no product feeding its sum (-sum |x|), which
    XLA compiles to the same bits with or without excess precision."""
    if torch_side:
        return repro_torch.Problem(name="my_l1",
                                   fn=lambda x: -sum_f32(torch.abs(x)),
                                   lo=lo, hi=hi)
    return repro.Problem(name="my_l1", fn=lambda x: -jnp.sum(jnp.abs(x), -1),
                         lo=lo, hi=hi)


def _problem(name: str, torch_side: bool):
    if name == "plane_ball":
        return _plane_ball(torch_side)
    if name == "custom":
        return _sphere(torch_side)
    return (repro_torch.get_problem(name) if torch_side
            else repro.core.problem.get_problem(name))


PROBLEMS = ("sphere_simplex", "sphere_simplex_pen", "plane_ball", "custom")


def _dim(name: str) -> int:
    """d=3 for plane_ball (its ball holds a fifth of the box there, so every
    repaired particle starts feasible), d=5 otherwise."""
    return 3 if name == "plane_ball" else 5


def _cfgs(name, rule="pso", n=64, d=None, **kw):
    d = _dim(name) if d is None else d
    kw = dict(dim=d, particle_cnt=n, update_rule=rule, dtype="bfloat16",
              **COEF, **kw)
    return (jpso.PSOConfig(fitness=_problem(name, False), **kw).resolved(),
            pso.PSOConfig(fitness=_problem(name, True), **kw).resolved())


def _rows(seed: int, n: int, d: int) -> torch.Tensor:
    """bfloat16 rows near the simplex, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, d)).astype(np.float32)
    x = x / x.sum(1, keepdims=True) + rng.normal(0, 0.01, (n, d)).astype(
        np.float32)
    return torch.from_numpy(x).to(BF)


# --- the constraint library's repairs ----------------------------------------

@pytest.mark.parametrize("d", [5, 8])
def test_project_simplex_bf16_is_the_reference(d, reference):
    """``project_simplex`` in bfloat16 equals the reference's eagerly and in
    its kernels' form (``kernel_projection``, the D-major tile, compiled
    with XLA's default options), bit for bit; torch.cumsum's one rounding a
    prefix disagreed on most rows near the simplex."""
    x = _rows(d, 4000, d)
    got = cons.project_simplex(x)
    assert got.dtype == BF
    assert torch.equal(got, _t(jcons.project_simplex(_j(x))))
    lifted = jstep.kernel_projection(repro.core.problem.get_problem(
        "sphere_simplex"))
    tile = jnp.zeros((jstep.pad_dim(d), x.shape[0]), jnp.bfloat16)
    tile = tile.at[:d].set(_j(x).T)
    assert torch.equal(got, _t(jax.jit(lambda p: lifted(p, d))(tile)[:d].T))
    # float32 keeps torch.cumsum
    x32 = x.float()
    u = torch.sort(x32, -1, descending=True).values
    assert torch.equal(cons._cumsum(u), torch.cumsum(u, -1))


def test_registered_sums_bf16_are_jnp_sum(reference):
    """The registered problems' sums over D in bfloat16 (the sphere
    objective, the simplex sum, the penalised max_fn, the CLI reducers)
    equal ``jnp.sum``'s on 200,000 rows of 5; torch.sum's order disagreed
    on about one row in that many."""
    x = torch.from_numpy(np.random.default_rng(11).uniform(
        -1, 1, (200_000, 5)).astype(np.float32)).to(BF)
    xj = _j(x)
    assert torch.equal(cons._sphere_obj(x), _t(jcons._sphere_obj(xj)))
    assert torch.equal(cons._simplex_sum(x), _t(jcons._simplex_sum(xj)))
    pen = repro_torch.get_problem("sphere_simplex_pen")
    jpen = repro.core.problem.get_problem("sphere_simplex_pen")
    assert torch.equal(pen.max_fn(x), _t(jpen.max_fn(xj)))
    for spec in ("sum(x) <= 1", "norm2(x) <= 1", "norm(x) <= 1"):
        got = cons.constraint_from_spec(spec).violation(x)
        assert torch.equal(got, _t(jcons.constraint_from_spec(
            spec).violation(xj))), spec


def test_weak_constants_bf16_are_the_reference(reference):
    """The Python constants of the constraint library enter a bfloat16
    operation rounded to bfloat16 first, as the reference's weak typing
    makes them: an equality's ``tol``, the penalty weight (and a ramped
    one), the projection's radius."""
    rng = np.random.default_rng(5)
    small = torch.from_numpy(rng.uniform(-3e-5, 3e-5, (4096, 2)).astype(
        np.float32)).to(BF)
    eq = cons.Constraint(fn=lambda x: x[..., 0], kind="eq", tol=1e-5)
    jeq = jcons.Constraint(fn=lambda x: x[..., 0], kind="eq", tol=1e-5)
    assert torch.equal(eq.violation(small), _t(jeq.violation(_j(small))))
    x = _rows(3, 4096, 5)
    for weight in (0.7, 50.0 * 1.3 ** 3):
        p = repro_torch.get_problem("sphere_simplex_pen").with_penalty_weight(
            weight)
        jp = repro.core.problem.get_problem(
            "sphere_simplex_pen").with_penalty_weight(weight)
        assert torch.equal(p.max_fn(x), _t(jp.max_fn(_j(x)))), weight
    assert torch.equal(cons.project_simplex(x, radius=0.7),
                       _t(jcons.project_simplex(_j(x), radius=0.7)))


@pytest.mark.parametrize("name", ["sphere_simplex", "sphere_simplex_pen",
                                  "plane_ball"])
def test_init_swarm_bf16_is_the_reference(name, reference):
    """``init_swarm`` of the constrained problems in bfloat16 at d=8
    n=1024 (plane_ball at d=3): every field the reference's bit for
    bit."""
    jc, tc = _cfgs(name, n=1024, d=3 if name == "plane_ball" else 8)
    _same(pso.init_swarm(tc, 7, device=CPU), _port(jpso.init_swarm(jc, 7)),
          f"init {name}")


@pytest.mark.parametrize("name", PROBLEMS)
@pytest.mark.parametrize("rule", RULES)
def test_eager_step_bf16_is_the_reference(name, rule, reference):
    """One eager ``step_queue`` and one ``run_async`` iteration (two
    blocks) from a shared bfloat16 state equal the reference engine's bit
    for bit: its coefficients and scalar bounds enter as bfloat16 values
    (weak typing), as in the kernels' plain versions. The reference's
    ``run_async`` is one compiled loop, so it is compiled ``strict``."""
    jc, tc = _cfgs(name, rule, n=128)
    js = jpso.run(jc, jpso.init_swarm(jc, 2), 2, "queue")
    s = _port(js)
    _same(pso.step_queue(tc, s), _port(jpso.step_queue(jc, js)),
          f"step_queue {name}/{rule}")
    _same(pso.run_async(tc, s, 1, sync_every=1, n_blocks=2),
          _port(strict(lambda st: jpso.run_async(jc, st, 1, sync_every=1,
                                                 n_blocks=2), js)),
          f"run_async {name}/{rule}")


# --- the split path's plain versions against the converted kernels -----------

def _user_functions_agree(tc, jc, pos: torch.Tensor) -> None:
    """The two frameworks' user functions (objective, violation,
    projection) on the positions a test feeds, bit for bit, the
    reference's as its kernels compile them (``strict``)."""
    tp, jp = tc.problem, jc.problem
    xj = _j(pos)
    assert torch.equal(tp.max_fn(pos), _t(strict(jp.max_fn, xj)))
    if tp.violation_fn is not None:
        assert torch.equal(tp.violation_fn(pos),
                           _t(strict(jp.violation_fn, xj)))
    if tp.projection_fn is not None:
        assert torch.equal(tp.projection_fn(pos),
                           _t(strict(jp.projection_fn, xj)))


_SPLIT = [(mode, name, rule) for mode in ("queue", "fused", "async")
          for name in PROBLEMS for rule in RULES]


@pytest.mark.parametrize("mode,name,rule", _SPLIT)
def test_split_plain_bf16_matches_converted_kernels(mode, name, rule,
                                                    reference):
    """The split path's plain versions (advance, the user's torch step,
    fold and publish) in bfloat16 against the reference's converted
    kernel in interpret mode (``strict``), from a shared state two eager
    iterations in, bit for bit: ``ops.queue_step`` on two blocks, then
    again from its result; the fused mode, 3 iterations, and the async
    mode, 5 iterations at sync_every 2, on one block."""
    n = 64
    jc, tc = _cfgs(name, rule, n=n)
    js = jpso.run(jc, jpso.init_swarm(jc, 4), 2, "queue")
    _user_functions_agree(tc, jc, _t(js.pos))
    if mode == "queue":
        for _ in range(2):
            want = strict(lambda st: jops.queue_step(
                jc, st, block_n=32, interpret=True), js)
            _same(ops.queue_step(tc, _port(js), block_n=32), _port(want),
                  f"queue {name}/{rule}")
            js = want
        return
    if mode == "fused":
        want = strict(lambda st: jops.run_queue_lock_fused(
            jc, st, 3, block_n=n, interpret=True), js)
        got = ops.run_queue_lock_fused(tc, _port(js), 3, block_n=n)
    else:
        want = strict(lambda st: jops.run_queue_lock_fused_async(
            jc, st, 5, sync_every=2, block_n=n, interpret=True), js)
        got = ops.run_queue_lock_fused_async(tc, _port(js), 5, sync_every=2,
                                             block_n=n)
    _same(got, _port(want), f"{mode} {name}/{rule}")
    _user_functions_agree(tc, jc, got.pos)


@pytest.mark.parametrize("mode", ["fused", "async"])
@pytest.mark.parametrize("name", ["sphere_simplex", "custom"])
def test_split_counters_bf16_match_reference(mode, name, reference):
    """The fold-and-publish plain version's contention counts in bfloat16,
    one block, equal the reference's converted kernel's telemetry."""
    n = 64
    jc, tc = _cfgs(name, n=n)
    js = jpso.init_swarm(jc, 6)
    if mode == "fused":
        (jw, want) = strict(lambda st: jops.run_queue_lock_fused(
            jc, st, 6, block_n=n, interpret=True, telemetry=True), js)
        got, cnt = ops.run_queue_lock_fused(tc, _port(js), 6, block_n=n,
                                            telemetry=True)
    else:
        (jw, want) = strict(lambda st: jops.run_queue_lock_fused_async(
            jc, st, 7, sync_every=3, block_n=n, interpret=True,
            telemetry=True), js)
        got, cnt = ops.run_queue_lock_fused_async(
            tc, _port(js), 7, sync_every=3, block_n=n, telemetry=True)
    _same(got, _port(jw), f"{mode} {name} with counters")
    assert cnt.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("mode", ["fused", "async"])
@pytest.mark.parametrize("name", ["sphere_simplex", "custom"])
def test_split_batch_bf16_matches_converted_kernels(mode, name, reference):
    """The batched forms (3c, 6c) in bfloat16: 8 swarms at their own
    seeds and iteration counters, one block each, every row the reference's
    batched converted kernel's bit for bit."""
    n, s_cnt = 64, 8
    jc, tc = _cfgs(name, n=n)
    seeds = [0, 1, 7, 42, 99, 123, 100000, 2 ** 31 - 5]
    jb = jms.init_batch(jc, seeds)
    jb = jb._replace(iteration=jnp.arange(s_cnt, dtype=jnp.int32) * 3)
    b = ms.stack_states([_port(jms.batch_row(jb, k)) for k in range(s_cnt)])
    if mode == "fused":
        want = strict(lambda bt: jops.run_queue_lock_fused_batch(
            jc, bt, 3, block_n=n, interpret=True), jb)
        got = ops.run_queue_lock_fused_batch(tc, b, 3, block_n=n)
    else:
        want = strict(lambda bt: jops.run_queue_lock_fused_async_batch(
            jc, bt, 5, sync_every=2, block_n=n, interpret=True), jb)
        got = ops.run_queue_lock_fused_async_batch(tc, b, 5, sync_every=2,
                                                   block_n=n)
    for k in range(s_cnt):
        _same(ms.batch_row(got, k), _port(jms.batch_row(want, k)),
              f"{mode} batch {name} row {k}")


_MULTI = [("fused", "gbest", 2), ("async", "gbest", 2), ("async", "ring", 4),
          ("async", "vonneumann", 4)]


@pytest.mark.parametrize("mode,topology,nb", _MULTI)
@pytest.mark.parametrize("name", ["sphere_simplex", "plane_ball"])
def test_split_multi_block_bf16_is_the_eager_engine(mode, topology, nb,
                                                    name):
    """Several blocks: the split path in bfloat16 equals the port's own
    bfloat16 eager engine bit for bit, fused as ``step_queue`` iterated,
    async as ``run_async(n_blocks=nb)`` under the topology."""
    n, iters = 256, 6
    _, tc = _cfgs(name, n=n, topology=topology)
    s = pso.run(tc, pso.init_swarm(tc, 8, device=CPU), 2, "queue")
    if mode == "fused":
        got = ops.run_queue_lock_fused(tc, s, iters, block_n=n // nb)
        want = pso.run(tc, s, iters, "queue")
        fields = FIELDS[:6]
    else:
        got = ops.run_queue_lock_fused_async(tc, s, iters, sync_every=2,
                                             block_n=n // nb)
        want = pso.run_async(tc, s, iters, sync_every=2, n_blocks=nb)
        fields = FIELDS
    _same(got, want, f"{mode} {topology} nb={nb} {name}", fields)


def test_torch_sum_objective_within_one_rounding(reference):
    """A custom sphere summed by plain ``torch.sum`` against the
    reference's converted kernel as it compiles by default (excess
    precision: the products not rounded before the sum): one queue step
    from a shared state keeps positions and velocities bit for bit; each
    pbest fitness lies within one bfloat16 rounding of the reference's,
    and a pbest decision differs only where the two fitnesses tie within
    that."""
    n, d = 256, 8
    kw = dict(dim=d, particle_cnt=n, dtype="bfloat16", **COEF)
    jc = jpso.PSOConfig(fitness=repro.Problem(
        name="sphere_sum", fn=lambda x: -jnp.sum(x * x, -1), lo=-5.0,
        hi=5.0), **kw).resolved()
    tc = pso.PSOConfig(fitness=repro_torch.Problem(
        name="sphere_sum", fn=lambda x: -torch.sum(x * x, -1), lo=-5.0,
        hi=5.0), **kw).resolved()
    js = jpso.run(jc, jpso.init_swarm(jc, 9), 2, "queue")
    prev = _port(js)
    want = _port(jops.queue_step(jc, js, block_n=128, interpret=True))
    got = ops.queue_step(tc, prev, block_n=128)
    assert torch.equal(got.pos, want.pos) and torch.equal(got.vel, want.vel)
    fit = tc.problem.max_fn(got.pos).float()
    tol = BF16_ULP * fit.abs()
    assert bool(((got.pbest_fit.float() - want.pbest_fit.float()).abs()
                 <= tol + BF16_ULP * want.pbest_fit.float().abs()).all())
    flip = (got.pbest_fit > prev.pbest_fit) != (want.pbest_fit >
                                                prev.pbest_fit)
    near = (fit - prev.pbest_fit.float()).abs() <= tol
    assert bool((~flip | near).all())
    same = ~flip
    assert torch.equal(got.pbest_pos[same], want.pbest_pos[same])


# --- the facade --------------------------------------------------------------

_SOLVES = [("queue_lock", "gbest", False), ("async", "gbest", False),
           ("async", "ring", False), ("queue_lock", "gbest", True),
           ("async", "gbest", True)]


@pytest.mark.parametrize("variant,topology,per_dim", _SOLVES)
def test_solve_custom_bf16_kernel_backend_matches_reference(
        variant, topology, per_dim, reference):
    """``solve(custom, dtype="bfloat16", backend="kernel")`` over 6
    iterations, one block (the split path's async mode is the eager
    engine's lockstep, the reference's several blocks its block-major
    order): the reference's state bit for bit, a bfloat16 state; also with
    per-dimension bounds."""
    bounds = ((-5.0, -2.0, -1.0), (5.0, 2.0, 3.0)) if per_dim else (-5.0,
                                                                     5.0)
    tp, jp = _l1(True, *bounds), _l1(False, *bounds)
    args = dict(dim=3, particles=128, iters=6, seed=2, dtype="bfloat16")
    m = dict(variant=variant, backend="kernel", topology=topology,
             sync_every=2, block_n=128)
    jr = repro.solve(jp, method=repro.Method(**m), **args)
    tr = repro_torch.solve(tp, method=repro_torch.Method(**m), device=CPU,
                           **args)
    pos = tr.state.pos
    assert pos.dtype == BF and tr.state.gbest_fit.dtype == BF
    assert torch.equal(tp.max_fn(pos), _t(jax.jit(jp.max_fn)(_j(pos))))
    assert tr.best_fit == jr.best_fit
    assert torch.equal(pos, _t(jr.state.pos))
    assert torch.equal(tr.state.pbest_fit, _t(jr.state.pbest_fit))


@pytest.mark.parametrize("variant", ["queue_lock", "async"])
def test_solve_many_custom_bf16_matches_reference(variant, reference):
    """``solve_many`` of a custom Problem in bfloat16 on the kernel
    backend, 8 seeds, one block a swarm: every row the reference's bit for
    bit."""
    kw = dict(dim=3, particles=128, iters=6, variant=variant,
              backend="kernel", sync_every=2, block_n=128, dtype="bfloat16")
    seeds = [0, 1, 7, 42, 99, 123, 100000, 5]
    jrs = repro.solve_many(_l1(False), seeds, **kw)
    trs = repro_torch.solve_many(_l1(True), seeds, device=CPU, **kw)
    for jr, tr in zip(jrs, trs):
        assert tr.state.pos.dtype == BF
        assert tr.best_fit == jr.best_fit
        assert torch.equal(tr.state.pos, _t(jr.state.pos))


@pytest.mark.parametrize("name", ["sphere_simplex", "custom"])
def test_islands_local_step_bf16_matches_reference(name, reference):
    """Islands' local step (``ops.make_fused_local_step``) on a bfloat16
    island of a custom or constrained Problem, one block: the reference's
    ``make_fused_local_step`` bit for bit; and ``solve`` with two islands
    keeps a bfloat16 state."""
    jc, tc = _cfgs(name, n=64)
    js = jpso.init_swarm(jc, 3)
    want = strict(lambda st: jops.make_fused_local_step(2, block_n=64)(
        jc, st), js)
    _same(ops.make_fused_local_step(2, block_n=64)(tc, _port(js)),
          _port(want), f"local step {name}")
    r = repro_torch.solve(tc.problem, dim=tc.dim, particles=128, iters=8,
                          dtype="bfloat16", device=CPU,
                          method=repro_torch.Method(
                              variant="queue_lock", backend="kernel",
                              islands=2, exchange_interval=4))
    assert r.state.pos.dtype == BF


def test_scheduler_custom_bf16_request(reference):
    """One ``ContinuousScheduler`` request of a custom Problem in
    bfloat16 on the kernel backend: a lane of its own problem on the split
    path with bfloat16 rows, the result the standalone ``solve(...,
    backend="kernel", record_history=True)``'s bit for bit and the
    reference scheduler's."""
    kw = dict(dim=3, particle_cnt=128, seed=4, iters=16, variant="async",
              sync_every=8, dtype="bfloat16")
    sched = ContinuousScheduler(backend="kernel", device=CPU)
    (got,) = sched.run([SolveRequest(fitness=_l1(True), **kw)])
    (want,) = JScheduler().run(
        [JRequest(fitness=_l1(False), **kw)])
    alone = repro_torch.solve(_l1(True), dim=3, particles=128, iters=16,
                              seed=4, variant="async", sync_every=8,
                              dtype="bfloat16", backend="kernel",
                              record_history=True, device=CPU)
    assert got.ok and got.gbest_fit == alone.best_fit == want.gbest_fit
    (lane,) = sched._lanes.values()
    assert "|bfloat16|" in lane.program_key()
    assert lane.program.split and lane.program.batch.pos.dtype == BF


# --- the autotuner -----------------------------------------------------------

def test_resolve_schedule_prices_the_split_path_bf16(tmp_path, monkeypatch):
    """A custom Problem in bfloat16: kernel candidates exist on a card,
    the split path's bytes are priced at 2 an element (half float32's),
    and a measured resolve runs its kernel candidates on bfloat16
    operands."""
    from repro_torch.core import autotune as at
    from repro_torch.roofline import pso_cost
    mine = _l1(True)
    assert at._kernel_ok(torch.device("cuda"), "pso", "bfloat16")
    for variant in ("queue_lock", "async"):
        cost = {dt: pso_cost.iteration_cost(
            variant, mine, 8, 1024, dtype=dt, backend="kernel",
            block_n=512) for dt in ("bfloat16", "float32")}
        assert 2 * cost["bfloat16"].bytes_hbm == cost["float32"].bytes_hbm
        assert cost["bfloat16"].dispatches >= pso_cost.SPLIT_LAUNCHES
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
    got = at.resolve_schedule(mine, 4, 128, 16, dtype="bfloat16",
                              kernel_ok=True, cache=cache, top_k=64,
                              device=CPU)
    assert got.source == "measured" and seen
    assert set(seen) == {("bfloat16", BF)}


# --- refusals ----------------------------------------------------------------

def test_split_refuses_heterogeneous_bf16_and_other_dtypes():
    """A heterogeneous bfloat16 table with a custom member raises
    ValueError (the reference's heterogeneous bfloat16 batches fail too),
    in the facade and in the split advance itself; float16 and float64
    custom Problems raise on the kernel backend, each with its reason."""
    kw = dict(dim=3, particles=128, iters=2, variant="async", device=CPU)
    for backend in ("kernel", "eager"):
        with pytest.raises(ValueError, match="float32"):
            repro_torch.solve_many(problems=[_l1(True), "cubic"],
                                   seeds=range(2), dtype="bfloat16",
                                   backend=backend, **kw)
    cfg = pso.PSOConfig(dim=3, particle_cnt=64, fitness=_l1(True),
                        dtype="bfloat16").resolved()
    st = ops.state_to_kernel(pso.init_swarm(cfg, 0, device=CPU))
    spec = ops.kernel_spec(cfg)
    with pytest.raises(ValueError, match="float32"):
        pso_split.advance(st[0], st[1], st[2], st[4][:, None],
                          torch.zeros(1, dtype=torch.int64),
                          torch.zeros(1, dtype=torch.int64), (spec, spec),
                          torch.zeros(1, dtype=torch.int32), n=64, it_off=0,
                          gdiv=64)
    with pytest.raises(ValueError, match="overflows"):
        repro_torch.solve(_l1(True), dtype="float16", backend="kernel", **kw)
    with pytest.raises(ValueError, match="float32 and bfloat16"):
        repro_torch.solve(_l1(True), dtype="float64", backend="kernel", **kw)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pso_split.advance(*(t.double() for t in st[:3]),
                          st[4][:, None].double(),
                          torch.zeros(1, dtype=torch.int64),
                          torch.zeros(1, dtype=torch.int64), (spec,), n=64,
                          it_off=0, gdiv=64)
