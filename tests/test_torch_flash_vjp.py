"""repro_torch.models.flash_vjp against the JAX reference
(repro.models.flash_vjp, a ``jax.custom_vjp``) on the CPU, float32: the
forward and dq/dk/dv on the reference tests' ``CASES`` (causal, GQA,
sliding window, hd_qk != hd_v, non-causal) and on a padded length with
always-visible prefix keys; the same gradients against autograd through
the port's plain ``attention.flash_attention``; and ``flash_custom_vjp``
wired through ``gqa_forward``.

Inputs are made from numpy seeds; the cotangent is that of sum(sin(o)).
Tolerances, float32: forward rtol = atol = 2e-5 and gradients rtol = atol
= 5e-4, the reference test's own (sums over a few hundred terms in other
orders, and the backward's recomputed exp(s - lse) against the forward's
rescaled one).
"""
import numpy as np
import pytest
import torch

from repro_torch.models import attention as t_attn
from repro_torch.models import flash_vjp as t_flash

try:
    import jax
    import jax.numpy as jnp

    from repro.models import attention as j_attn
    from repro.models import flash_vjp as j_flash
except ModuleNotFoundError:     # a CUDA host may have no JAX installed
    jax = None

torch.set_num_threads(1)

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
# (B, Sq, Sk, H, KH, hd, hdv, causal, window, qb, kb, prefix_len): the
# reference's CASES, then a padded length (80 over blocks of 32) with a
# window and always-visible prefix keys.
CASES = [
    (2, 64, 64, 4, 4, 16, 16, True, 0, 32, 32, 0),
    (1, 128, 128, 8, 2, 16, 16, True, 0, 64, 32, 0),      # GQA
    (2, 96, 96, 4, 4, 16, 16, True, 32, 32, 32, 0),       # sliding window
    (1, 64, 64, 4, 2, 16, 8, True, 0, 32, 32, 0),         # hd_qk != hd_v
    (2, 64, 64, 4, 4, 16, 16, False, 0, 32, 32, 0),       # non-causal
    (1, 80, 80, 4, 2, 16, 16, True, 24, 32, 32, 8),       # padding, prefix
]


@pytest.fixture(scope="module", autouse=True)
def reference():
    if jax is None:
        pytest.skip("needs the JAX reference package `repro`, and JAX is "
                    "not installed")


def _mk(case, seed=0):
    b, sq, sk, h, kh, hd, hdv = case[:7]
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, sk, kh, hd), (b, sk, kh, hdv))]


def _ref_grads(case, qkv):
    *_, causal, window, qb, kb, prefix = case

    def loss(q, k, v):
        o = j_flash.flash_attention_vjp(q, k, v, causal, window, 0, qb, kb,
                                        None, prefix)
        return jnp.sum(jnp.sin(o))

    fwd = jax.jit(lambda q, k, v: j_flash.flash_attention_vjp(
        q, k, v, causal, window, 0, qb, kb, None, prefix))
    return fwd(*qkv), jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*qkv)


def _grads(fn, qkv):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in qkv)
    o = fn(q, k, v)
    return o.detach(), torch.autograd.grad(torch.sum(torch.sin(o)),
                                           (q, k, v))


@pytest.mark.parametrize("case", CASES)
def test_flash_vjp_matches_reference(case):
    *_, causal, window, qb, kb, prefix = case
    qkv = _mk(case)
    want_o, want_g = _ref_grads(case, qkv)
    got_o, got_g = _grads(lambda q, k, v: t_flash.flash_attention_vjp(
        q, k, v, causal, window, 0, qb, kb, None, prefix), qkv)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **FWD_TOL)
    for name, g, w in zip("qkv", got_g, want_g):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", CASES)
def test_flash_vjp_matches_autograd_of_plain(case):
    """The hand-written backward against autograd through the port's
    blockwise ``flash_attention`` (forward and all three gradients)."""
    *_, causal, window, qb, kb, prefix = case
    qkv = _mk(case, seed=1)
    want_o, want_g = _grads(lambda q, k, v: t_attn.flash_attention(
        q, k, v, causal=causal, window=window, q_block=qb, kv_block=kb,
        prefix_len=prefix), qkv)
    got_o, got_g = _grads(lambda q, k, v: t_flash.flash_attention_vjp(
        q, k, v, causal, window, 0, qb, kb, None, prefix), qkv)
    np.testing.assert_allclose(got_o.numpy(), want_o.numpy(), **FWD_TOL)
    for name, g, w in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL,
                                   err_msg=f"d{name}")


def test_gqa_forward_custom_vjp_matches_reference():
    """``gqa_forward(use_custom_vjp=True)`` against the reference's, output
    and weight gradients, with a window and prefix keys."""
    r = np.random.default_rng(2)
    d, h, kh, hd = 32, 4, 2, 8
    jp = j_attn.init_gqa(jax.random.key(0), d, h, kh, hd, True, jnp.float32)
    x = r.standard_normal((2, 40, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40)[None], (2, 40)).astype(np.int32)
    kw = dict(h=h, kh=kh, hd=hd, theta=10000.0, window=16, prefix_len=4,
              q_block=16, kv_block=16, use_custom_vjp=True)

    def jloss(p):
        return jnp.sum(jnp.sin(j_attn.gqa_forward(p, jnp.asarray(x),
                                                  jnp.asarray(pos), **kw)))

    want = jax.jit(jax.grad(jloss))(jp)
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in jp.items()}
    out = t_attn.gqa_forward(tp, torch.from_numpy(x),
                             torch.from_numpy(pos.astype(np.int64)), **kw)
    got = torch.autograd.grad(torch.sum(torch.sin(out)), list(tp.values()))
    for name, g in zip(tp, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]),
                                   **GRAD_TOL, err_msg=name)
