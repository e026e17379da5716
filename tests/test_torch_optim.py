"""repro_torch.optim against the JAX reference (repro.optim) on the CPU: the
schedules, sgd/adam/adafactor over one tree with bfloat16, 1-D, factored
and unfactored leaves, and PSOOptimizer's trajectory; then the reference's
own optim tests (tests/test_optim.py) case for case on the port.

Inputs are made from numpy seeds, the same grads fed to both packages.
Tolerances:
- schedules: float32, rtol = 1e-6 (one ulp of cos taken by another libm);
- optimizers, float32 leaves and states: rtol = atol = 1e-6 (the same
  float32 ops; reductions (adafactor's means) in other orders);
- bfloat16 parameters and adafactor's bfloat16 momentum: within one
  bfloat16 unit, |d| <= 2^-8 |want| + 1e-6 (a float32 value a few ulps
  apart may round to the neighbouring bfloat16);
- PSOOptimizer, five steps: positions and velocities atol = 1e-6 (the
  advance is the same float32 chain, which XLA:CPU may contract into
  FMAs: ROADMAP's parity contract), fitness rtol = 1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch import optim as t_optim

try:
    import jax
    import jax.numpy as jnp

    from repro import optim as j_optim
except ModuleNotFoundError:     # a CUDA host may have no JAX installed
    jax = None

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-6, atol=1e-6)
NAMES = ["sgd", "adam", "adafactor"]


@pytest.fixture(scope="module", autouse=True)
def reference():
    if jax is None:
        pytest.skip("needs the JAX reference package `repro`, and JAX is "
                    "not installed")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, bf16=False):
    got, want = _np(got), _np(want)
    if bf16:
        assert np.all(np.abs(got - want) <= 2.0 ** -8 * np.abs(want) + 1e-6)
    else:
        np.testing.assert_allclose(got, want, **F32_TOL)


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(
        a, np.float32)).to(torch.bfloat16 if a.dtype == jnp.bfloat16
                           else torch.float32), tree)


def _params(r):
    """bfloat16 factored, 1-D, float32 factored, unfactored (a dim < 2)
    and 3-D factored leaves."""
    return {"a": jnp.asarray(r.standard_normal((8, 16)), jnp.bfloat16),
            "v": jnp.asarray(r.standard_normal(5), jnp.float32),
            "nested": {"f": jnp.asarray(r.standard_normal((6, 4)),
                                        jnp.float32),
                       "row": jnp.asarray(r.standard_normal((1, 7)),
                                          jnp.float32),
                       "cube": jnp.asarray(r.standard_normal((2, 3, 4)),
                                           jnp.float32)}}


def _grads(r, params):
    return jax.tree.map(lambda p: jnp.asarray(
        r.standard_normal(p.shape) * 0.1, p.dtype), params)


def _compare_trees(got, want):
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            t_optim.optimizers.tree_leaves(got)):
        assert tuple(g.shape) == w.shape, path
        _close(g, w, bf16=w.dtype == jnp.bfloat16)


# --- schedules -----------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 7), (0, 30)])
def test_schedules_equal_reference(warmup, total):
    steps = np.arange(0, total + 5, dtype=np.int32)
    want_c = [float(j_optim.cosine_schedule(jnp.asarray(s), 3e-4, warmup,
                                            total)) for s in steps]
    want_w = [float(j_optim.linear_warmup(jnp.asarray(s), 3e-4, warmup))
              for s in steps]
    for s, wc, ww in zip(steps, want_c, want_w):
        step = torch.tensor(int(s), dtype=torch.int32)
        got_c = t_optim.cosine_schedule(step, 3e-4, warmup, total)
        assert got_c.dtype == torch.float32
        np.testing.assert_allclose(float(got_c), wc, rtol=1e-6)
        np.testing.assert_allclose(
            float(t_optim.linear_warmup(step, 3e-4, warmup)), ww, rtol=1e-6)


# --- optimizers against the reference ----------------------------------------

@pytest.mark.parametrize("updates", [1, 3])
@pytest.mark.parametrize("name", NAMES)
def test_optimizer_matches_reference(name, updates):
    """Parameters and state after ``updates`` updates of the same grads,
    at a schedule's lr (a 0-d float32 tensor, as in the train step)."""
    r = np.random.default_rng(7)
    jp = _params(r)
    tp = _torch_tree(jp)
    j_init, j_upd = j_optim.get_optimizer(name)
    t_init, t_upd = t_optim.get_optimizer(name)
    js, ts = j_init(jp), t_init(tp)
    for _ in range(updates):
        g = _grads(r, jp)
        lr = j_optim.cosine_schedule(js.step + 2, 1e-2, 2, 10)
        jp, js = j_upd(jp, g, js, lr)
        tp, ts = t_upd(tp, _torch_tree(g), ts,
                       t_optim.cosine_schedule(ts.step + 2, 1e-2, 2, 10))
    assert int(ts.step) == int(js.step) == updates
    assert ts.step.dtype == torch.int32
    _compare_trees(tp, jp)
    _compare_trees(ts.inner, js.inner)


def test_optimizer_all_equals_reference():
    assert t_optim.__all__ == j_optim.__all__
    assert t_optim.OptState._fields == j_optim.OptState._fields


# --- PSOOptimizer ------------------------------------------------------------------

def _regression(n=128):
    X = np.asarray(jax.random.normal(jax.random.key(0), (n, 4)))
    w_true = np.asarray([0.4, -0.2, 0.1, 0.3], np.float32)
    return X, X @ w_true, w_true


def test_pso_optimizer_trajectory_matches_reference():
    """Five steps of a two-leaf tree (dict keys out of sorted order, so the
    flattening order matters): positions, velocities, pbests and the best
    loss each step."""
    X, y, _ = _regression()
    Xt, yt = torch.from_numpy(X.copy()), torch.from_numpy(y.copy())
    jopt = j_optim.PSOOptimizer({"w": jnp.zeros((4,)),
                                 "b": {"c": jnp.zeros((2,))}},
                                particles=64, seed=3)
    topt = t_optim.PSOOptimizer({"w": torch.zeros(4),
                                 "b": {"c": torch.zeros(2)}},
                                particles=64, seed=3)

    def jloss(p):
        return jnp.mean((X @ p["w"] + p["b"]["c"].sum() - y) ** 2)

    def tloss(p):
        return torch.mean((Xt @ p["w"] + p["b"]["c"].sum() - yt) ** 2)

    for _ in range(5):
        want, got = jopt.step(jloss), topt.step(tloss)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        for f in ("pos", "vel", "pbest_pos", "gbest_pos"):
            np.testing.assert_allclose(
                getattr(topt.state, f).numpy(),
                np.asarray(getattr(jopt.state, f)), atol=1e-6, err_msg=f)
        np.testing.assert_allclose(topt.state.pbest_fit.numpy(),
                                   np.asarray(jopt.state.pbest_fit),
                                   rtol=1e-5)
    assert topt.state.iteration == int(jopt.state.iteration)
    best = topt.best_params
    assert list(best) == ["w", "b"] and tuple(best["b"]["c"].shape) == (2,)


def test_pso_optimizer_gradient_free_regression():
    """The reference's regression test on the port."""
    X, y, w_true = _regression()
    Xt, yt = torch.from_numpy(X.copy()), torch.from_numpy(y.copy())
    opt = t_optim.PSOOptimizer({"w": torch.zeros(4)}, particles=128,
                               span=1.0, seed=0)
    best = None
    for _ in range(150):
        best = opt.step(lambda p: torch.mean((Xt @ p["w"] - yt) ** 2))
    assert best < 1e-2
    np.testing.assert_allclose(opt.best_params["w"].numpy(), w_true,
                               atol=0.1)


def test_pso_optimizer_refuses_a_host_call():
    """``torch.func.vmap`` rejects ``.item()`` as ``jax.vmap`` rejects a
    host call; nothing falls back to a per-particle loop."""
    opt = t_optim.PSOOptimizer({"w": torch.zeros(3)}, particles=8)
    with pytest.raises(RuntimeError, match="item"):
        opt.step(lambda p: torch.ones(()) * float(p["w"].sum().item()))


# --- the reference's optim tests, on the port -----------------------------------

def _quadratic_params():
    return {"w": torch.tensor([3.0, -2.0, 1.0]),
            "b": {"c": torch.tensor([[0.5, -0.5], [1.0, -1.0]])}}


@pytest.mark.parametrize("name", NAMES)
def test_optimizers_minimize_quadratic(name):
    init, update = t_optim.get_optimizer(name)
    params = _quadratic_params()
    state = init(params)

    def loss(p):
        return sum(torch.sum(torch.square(l))
                   for l in t_optim.optimizers.tree_leaves(p))

    l0 = float(loss(params))
    for _ in range(120):
        grads = t_optim.optimizers.tree_map(lambda p: 2 * p, params)
        params, state = update(params, grads, state, 0.05)
    assert float(loss(params)) < 0.05 * l0, name
    assert int(state.step) == 120


@pytest.mark.parametrize("name", NAMES)
def test_dtype_and_shape_preserved(name):
    init, update = t_optim.get_optimizer(name)
    params = {"a": torch.ones((8, 16), dtype=torch.bfloat16),
              "v": torch.ones(5)}
    grads = t_optim.optimizers.tree_map(
        lambda p: torch.full_like(p, 0.01), params)
    shapes = {k: (v.shape, v.dtype) for k, v in params.items()}
    new_p, _ = update(params, grads, init(params), 1e-3)
    assert {k: (v.shape, v.dtype) for k, v in new_p.items()} == shapes


def test_adafactor_memory_factored():
    """The factored second moment is O(rows + cols), not O(rows * cols)."""
    st = t_optim.adafactor_init({"big": torch.zeros((1024, 512),
                                                    dtype=torch.bfloat16)})
    inner = st.inner["big"]
    assert tuple(inner["vr"].shape) == (1024,)
    assert tuple(inner["vc"].shape) == (512,)
    assert inner["m"].dtype == torch.bfloat16


def test_cosine_schedule_shape():
    assert float(t_optim.cosine_schedule(torch.tensor(0), 1e-3, 10,
                                         100)) == 0.0
    assert float(t_optim.cosine_schedule(torch.tensor(10), 1e-3, 10, 100)) \
        == pytest.approx(1e-3, rel=1e-5)
    assert float(t_optim.cosine_schedule(torch.tensor(100), 1e-3, 10, 100)) \
        == pytest.approx(1e-4, rel=1e-3)


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_sliced_updates_equal_whole(name, monkeypatch):
    """SGD and Adam update a large stacked leaf a slice at a time: the
    same bits as the whole leaf at once."""
    init, update = t_optim.get_optimizer(name)
    r = np.random.default_rng(3)
    trees = []
    for piece in (10, 1 << 26):
        monkeypatch.setattr(t_optim.optimizers, "_PIECE", piece)
        p = {"a": torch.from_numpy(r.standard_normal((3, 4, 5)).astype(
            np.float32)).to(torch.bfloat16), "b": torch.ones(7)}
        state = init(p)
        for k in range(3):
            g = t_optim.optimizers.tree_map(
                lambda t: torch.full_like(t, 0.01 * (k + 1)), p)
            p, state = update(p, g, state, 0.1)
        trees.append((p, state.inner))
        r = np.random.default_rng(3)
    for a, b in zip(t_optim.optimizers.tree_leaves(trees[0]),
                    t_optim.optimizers.tree_leaves(trees[1])):
        assert torch.equal(a, b)
