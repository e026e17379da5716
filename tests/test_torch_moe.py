"""repro_torch.models.moe against the JAX reference (repro.models.moe) on
the CPU, float32, the reference's weights carried across: the capacity,
the output, the auxiliary loss and the dropped (token, choice) pairs with
ample and with tight capacity (where a dropped choice's write lands on the
next expert's slot 0, the last write winning as in XLA's scatter), tied
router probabilities (ties by the lower expert index, as
``jax.lax.top_k``), and the gradients of router and experts; then the
reference's own MoE tests (tests/test_moe.py) on the port.

Inputs are made from numpy seeds. Tolerance: rtol = atol = 1e-5 on
outputs, the auxiliary loss and gradients (float32 sums over d and ff
taken in other orders); routing (experts, slots, drops) equal exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.models import convert
from repro_torch.models import moe as t_moe

try:
    import jax
    import jax.numpy as jnp

    from repro.models import moe as j_moe
except ModuleNotFoundError:     # a CUDA host may have no JAX installed
    jax = None

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def reference():
    if jax is None:
        pytest.skip("needs the JAX reference package `repro`, and JAX is "
                    "not installed")


def _layer(d, ff, e, act="silu", seed=0):
    jp = j_moe.init_moe(jax.random.key(seed), d, ff, e, act, jnp.float32)
    return jp, convert.tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ref_keep(jp, x, e, k, cf, group):
    """The reference's (token, choice) pairs that got a slot."""
    xg = x.reshape(-1, group, x.shape[-1])
    cap = j_moe._capacity(group, e, k, cf)
    probs = jax.nn.softmax((jnp.asarray(xg) @ jp["router"]).astype(
        jnp.float32), axis=-1)
    _, experts = jax.lax.top_k(probs, k)
    one_hot = jax.nn.one_hot(experts.reshape(xg.shape[0], -1), e,
                             dtype=jnp.int32)
    slot = (jnp.cumsum(one_hot, axis=1) * one_hot - 1).max(-1)
    return np.asarray(slot < cap), np.asarray(experts)


@pytest.mark.parametrize("cf,act", [(8.0, "silu"), (1.25, "silu"),
                                    (0.5, "silu"), (0.5, "gelu")])
def test_moe_apply_matches_reference(cf, act):
    """Out, aux and drops at ample (8), the configs' (1.25) and tight
    (0.5) capacity, gated and plain experts, two groups."""
    d, ff, e, k = 16, 32, 4, 2
    jp, tp = _layer(d, ff, e, act)
    x = _x(1, 2, 32, d)
    kw = dict(n_experts=e, top_k=k, capacity_factor=cf, act=act,
              group_tokens=32)
    want, want_aux = jax.jit(lambda p, x: j_moe.moe_apply(p, x, **kw))(
        jp, jnp.asarray(x))
    got, aux = t_moe.moe_apply(tp, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    r = t_moe.dispatch(tp, torch.from_numpy(x).reshape(2, 32, d),
                       n_experts=e, top_k=k, capacity_factor=cf)
    keep, _ = _ref_keep(jp, x, e, k, cf, 32)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert r.cap == j_moe._capacity(32, e, k, cf)
    if cf < 1:
        assert not keep.all()              # the tight case drops tokens
    else:
        assert keep.all()


def test_moe_ties_break_by_lower_expert():
    """A zero router ties every expert: both packages take experts 0 and 1
    for every token and drop the same tokens beyond capacity."""
    d, ff, e, k = 8, 16, 4, 2
    jp, tp = _layer(d, ff, e)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _x(2, 1, 64, d)
    kw = dict(n_experts=e, top_k=k, capacity_factor=1.25, act="silu",
              group_tokens=64)
    want, want_aux = jax.jit(lambda p, x: j_moe.moe_apply(p, x, **kw))(
        jp, jnp.asarray(x))
    got, aux = t_moe.moe_apply(tp, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    keep, experts = _ref_keep(jp, x, e, k, 1.25, 64)
    assert (experts[..., 0] == 0).all() and (experts[..., 1] == 1).all()
    r = t_moe.dispatch(tp, torch.from_numpy(x), n_experts=e, top_k=k,
                       capacity_factor=1.25)
    np.testing.assert_array_equal(r.keep.numpy(), keep)


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_moe_grads_match_reference(cf):
    """Gradients of a loss over the output and the auxiliary loss reach
    router and experts, equal to ``jax.grad``'s."""
    d, ff, e, k = 8, 16, 4, 2
    jp, tp = _layer(d, ff, e)
    x = _x(3, 1, 16, d)
    kw = dict(n_experts=e, top_k=k, capacity_factor=cf, act="silu",
              group_tokens=16)

    def jloss(p):
        y, aux = j_moe.moe_apply(p, jnp.asarray(x), **kw)
        return jnp.sum(y * y) + 0.01 * aux

    want = jax.jit(jax.grad(jloss))(jp)
    tp = {n: t.requires_grad_() for n, t in tp.items()}
    y, aux = t_moe.moe_apply(tp, torch.from_numpy(x), **kw)
    got = torch.autograd.grad(torch.sum(y * y) + 0.01 * aux,
                              list(tp.values()))
    for name, g in zip(tp, got):
        assert float(g.abs().sum()) > 0.0, name
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), **TOL,
                                   err_msg=name)


def test_slot_gate_last_write_wins():
    dest = torch.tensor([[8, 0, 8, 1, 9]])
    w = torch.tensor([[0.1, 0.2, 0.3, 0.4, 0.5]])
    got = t_moe._slot_gate(w, dest, 16)
    want = j_moe._slot_gate(jnp.asarray(w.numpy()[0]),
                            jnp.asarray(dest.numpy()[0]), 16)
    np.testing.assert_array_equal(got.numpy()[0], np.asarray(want))


# --- the reference's MoE tests, on the port -------------------------------------

def _dense_reference(p, x, n_experts, top_k, act):
    """No-drop reference: every token runs through its top-k experts."""
    from repro_torch.models.layers import act_fn
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    probs = torch.softmax((xt @ p["router"]).float(), -1)
    gates, experts = torch.topk(probs, top_k)
    gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(xt)
    for e in range(n_experts):
        h = act_fn(act)(xt @ p["w_gate"][e]) * (xt @ p["w_in"][e])
        y = h @ p["w_out"][e]
        for j in range(top_k):
            out += y * torch.where(experts[:, j] == e, gates[:, j],
                                   0.0)[:, None]
    return out.reshape(b, s, d)


def test_moe_matches_dense_reference_when_capacity_ample():
    d, ff, e, k = 16, 32, 4, 2
    p = t_moe.init_moe(torch.Generator().manual_seed(0), d, ff, e, "silu",
                       torch.float32, device="cpu")
    x = torch.from_numpy(_x(4, 2, 8, d))
    got, aux = t_moe.moe_apply(p, x, n_experts=e, top_k=k,
                               capacity_factor=8.0, act="silu",
                               group_tokens=16)
    np.testing.assert_allclose(got.numpy(),
                               _dense_reference(p, x, e, k, "silu").numpy(),
                               rtol=2e-4, atol=2e-4)
    assert float(aux) > 0.0


def test_moe_drops_only_over_capacity():
    d, ff, e, k = 8, 16, 4, 2
    p = t_moe.init_moe(torch.Generator().manual_seed(0), d, ff, e, "silu",
                       torch.float32, device="cpu")
    x = torch.from_numpy(_x(5, 1, 64, d))
    kw = dict(n_experts=e, top_k=k, act="silu", group_tokens=64)
    ample, _ = t_moe.moe_apply(p, x, capacity_factor=8.0, **kw)
    tight, _ = t_moe.moe_apply(p, x, capacity_factor=0.5, **kw)
    assert bool(torch.isfinite(tight).all())
    assert float(tight.norm()) <= float(ample.norm()) + 1e-3


def test_capacity_rounding():
    for args in ((4096, 16, 2, 1.25), (64, 4, 2, 1.25), (8, 128, 2, 1.25),
                 (1, 16, 2, 1.25), (8192, 128, 2, 1.25)):
        assert t_moe._capacity(*args) == j_moe._capacity(*args)
    assert t_moe._capacity(4096, 16, 2, 1.25) == 640
    assert t_moe._capacity(8, 128, 2, 1.25) == 8      # floor
