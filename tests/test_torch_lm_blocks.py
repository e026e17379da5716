"""The LM substrate's building blocks (``repro_torch.models.layers``,
``attention``, ``ssm``) against the JAX reference's (``repro.models``) on
the CPU, in float32 at small shapes, the reference's weights carried across
(``models.convert``); the whole models: ``tests/test_torch_lm.py``.

Inputs are made from numpy seeds. Tolerance, float32: rtol = atol = 1e-5,
sums over at most a few hundred terms taken in other orders.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import gla as t_gla
from repro_torch.models import attention as t_attn
from repro_torch.models import convert
from repro_torch.models import layers as t_layers
from repro_torch.models import ssm as t_ssm

try:
    import jax
    import jax.numpy as jnp

    from repro.models import attention as j_attn
    from repro.models import layers as j_layers
    from repro.models import ssm as j_ssm
except ModuleNotFoundError:     # a CUDA host may have no JAX installed
    jax = None

torch.set_num_threads(1)

BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def reference():
    if jax is None:
        pytest.skip("needs the JAX reference package `repro`, and JAX is "
                    "not installed")


def _ref(fn, *args, **static):
    """The reference's ``fn`` on ``args``, jitted with ``static`` bound (one
    compiled call runs here several times faster than op by op)."""
    return jax.jit(functools.partial(fn, **static))(*args)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(r, *shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i"
                            else np.array(a))


def _close(got, want, tol=BLOCK_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def _carry(tree):
    """The reference's jnp tree as the port's tensors."""
    return convert.tree_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


# --- building blocks ---------------------------------------------------------

def test_rmsnorm_rope_mlp_match_reference():
    r = _rng(0)
    x, w = _normal(r, 2, 12, 4, 16), _normal(r, 16)
    _close(t_layers.rmsnorm(_t(w), _t(x), 1e-5),
           _ref(j_layers.rmsnorm, w, x, eps=1e-5))
    pos = r.integers(0, 500, (2, 12)).astype(np.int32)
    _close(t_layers.apply_rope(_t(x), _t(pos), 1e4),
           _ref(j_layers.apply_rope, x, pos, theta=1e4))
    h = _normal(r, 2, 12, 32)
    for act in ("silu", "gelu", "relu"):
        jp = j_layers.init_mlp(jax.random.key(1), 32, 48, act, jnp.float32)
        _close(t_layers.mlp(_carry(jp), _t(h), act),
               _ref(j_layers.mlp, jp, h, act=act))


@pytest.mark.parametrize("pad_vocab", [False, True])
def test_chunked_xent_matches_reference(pad_vocab):
    """Chunks of 16 over S=40 (a remainder), masked labels, V=200."""
    r = _rng(1)
    h, w = _normal(r, 2, 40, 24), _normal(r, 24, 200, scale=0.3)
    labels = r.integers(0, 200, (2, 40)).astype(np.int32)
    labels[0, :5] = -1
    _close(t_layers.chunked_xent(_t(h), _t(w), _t(labels), 16, pad_vocab),
           _ref(j_layers.chunked_xent, h, w, labels, chunk=16,
                pad_vocab=pad_vocab))


@pytest.mark.parametrize("kw", [
    dict(causal=True), dict(causal=False),
    dict(causal=True, window=20),
    dict(causal=True, window=20, prefix_len=6),
    dict(causal=True, q_offset=24)])
def test_flash_attention_matches_reference(kw):
    """Blocks of 16 over 56 queries and keys (padding), GQA 4 over 2."""
    r = _rng(2)
    sq = 32 if kw.get("q_offset") else 56
    q = _normal(r, 2, sq, 4, 16)
    k, v = _normal(r, 2, 56, 2, 16), _normal(r, 2, 56, 2, 8)
    blocks = dict(q_block=16, kv_block=16)
    _close(t_attn.flash_attention(_t(q), _t(k), _t(v), **kw, **blocks),
           _ref(j_attn.flash_attention, q, k, v, **kw, **blocks))


@pytest.mark.parametrize("window,prefix_len", [(0, 0), (8, 0), (8, 4)])
def test_decode_attention_matches_reference(window, prefix_len):
    r = _rng(3)
    q = _normal(r, 2, 1, 4, 16)
    kc, vc = _normal(r, 2, 40, 2, 16), _normal(r, 2, 40, 2, 16)
    _close(t_attn.decode_attention(_t(q), _t(kc), _t(vc), 30, window=window,
                                   prefix_len=prefix_len),
           _ref(j_attn.decode_attention, q, kc, vc, 30, window=window,
                prefix_len=prefix_len))


@pytest.mark.parametrize("window_only_reads", [False, True])
def test_gqa_decode_matches_reference(window_only_reads):
    """GQA decode with bias at cache position 27 of 40, a window of 8 and 4
    always-visible rows; the port writes the cache in place."""
    r = _rng(4)
    jp = j_attn.init_gqa(jax.random.key(2), 32, 4, 2, 8, True, jnp.float32)
    jp = {k: v + 0.1 * jnp.asarray(_normal(r, *v.shape)) for k, v in
          jp.items()}
    x = _normal(r, 2, 1, 32)
    cache = {"k": _normal(r, 2, 40, 2, 8), "v": _normal(r, 2, 40, 2, 8)}
    kw = dict(h=4, kh=2, hd=8, theta=1e4, window=8, prefix_len=4,
              window_only_reads=window_only_reads)
    want, want_c = _ref(j_attn.gqa_decode, jp, x, cache, 27, **kw)
    mine = {k: _t(v) for k, v in cache.items()}
    got, got_c = t_attn.gqa_decode(_carry(jp), _t(x), mine, 27, **kw)
    assert got_c is mine
    _close(got, want)
    for name in ("k", "v"):
        _close(got_c[name], want_c[name])


def test_gqa_and_mla_forward_match_reference():
    r = _rng(5)
    x = _normal(r, 2, 24, 32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    jp = j_attn.init_gqa(jax.random.key(3), 32, 4, 2, 8, False, jnp.float32)
    kw = dict(h=4, kh=2, hd=8, theta=1e4, window=8, prefix_len=3,
              q_block=16, kv_block=16)
    _close(t_attn.gqa_forward(_carry(jp), _t(x), _t(pos), **kw),
           _ref(j_attn.gqa_forward, jp, x, pos, **kw))
    mla = dict(h=4, q_rank=16, kv_rank=12, rope_hd=4, nope_hd=8, v_hd=8)
    jm = j_attn.init_mla(jax.random.key(4), 32, dtype=jnp.float32, **mla)
    kw = dict(mla, theta=1e4, eps=1e-5)
    _close(t_attn.mla_forward(_carry(jm), _t(x), _t(pos), q_block=16,
                              kv_block=16, **kw),
           _ref(j_attn.mla_forward, jm, x, pos, q_block=16, kv_block=16,
                **kw))
    cache = {"c_kv": _normal(r, 2, 20, 12), "k_rope": _normal(r, 2, 20, 4)}
    want, want_c = _ref(j_attn.mla_decode, jm, x[:, :1], cache, 9, **kw)
    got, got_c = t_attn.mla_decode(_carry(jm), _t(x[:, :1]),
                                   {k: _t(v) for k, v in cache.items()}, 9,
                                   **kw)
    _close(got, want)
    for name in cache:
        _close(got_c[name], want_c[name])


# --- the GLA engine and the recurrent blocks ---------------------------------

def _gla_operands(r, b, s, h, n, p):
    q, k = _normal(r, b, s, h, n, scale=0.3), _normal(r, b, s, h, n,
                                                        scale=0.3)
    v = _normal(r, b, s, h, p)
    ld = (-np.logaddexp(0.0, _normal(r, b, s, h)) * 0.1).astype(np.float32)
    li = np.clip(_normal(r, b, s, h, scale=0.3), -2, 2)
    return q, k, v, ld, li


def test_gla_chunked_with_state_matches_reference():
    """An initial state in, the final state out, S=40 padded to chunks of
    16; then a decode step from that state."""
    r = _rng(6)
    x = _gla_operands(r, 2, 40, 3, 8, 6)
    h0 = _normal(r, 2, 3, 8, 6)
    want_y, want_h = _ref(lambda *a: j_ssm.gla_chunked(*a[:5], chunk=16,
                                                        h0=a[5]), *x, h0)
    got_y, got_h = t_ssm.gla_chunked(*map(_t, x), chunk=16, h0=_t(h0))
    _close(got_y, want_y)
    _close(got_h, want_h)
    step = [a[:, 0] for a in _gla_operands(r, 2, 1, 3, 8, 6)]
    want = _ref(j_ssm.gla_step, want_h, *step)
    got = t_ssm.gla_step(got_h, *map(_t, step))
    for g, w in zip(got, want):
        _close(g, w)


def test_gla_chunked_bf16_rounds_as_the_reference():
    """bfloat16 operands: the engine rounds the weights, q k^T and their
    product to bfloat16 and the carried state where it meets q, as the
    reference's jnp engine does; the same inputs agree within one
    bfloat16 unit of y (2^-7 relative) plus 2^-8 of max |y| (a tie flipped
    by a float32 sum in another order; see tests/test_torch_gla.py)."""
    r = _rng(7)
    q, k, v, ld, li = _gla_operands(r, 1, 48, 2, 16, 16)
    tq, tk, tv = (_t(a).bfloat16() for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
                  for a in (tq, tk, tv))
    want_y, want_h = _ref(j_ssm.gla_chunked, jq, jk, jv, ld, li, chunk=16)
    got_y, got_h = t_ssm.gla_chunked(tq, tk, tv, _t(ld), _t(li), chunk=16)
    assert got_y.dtype == torch.bfloat16 and got_h.dtype == torch.float32
    want = np.asarray(want_y.astype(jnp.float32))
    err = np.abs(got_y.float().numpy() - want)
    assert (err <= 2.0 ** -7 * np.abs(want)
            + 2.0 ** -8 * np.abs(want).max()).all(), float(err.max())
    _close(got_h, want_h, dict(rtol=1e-2, atol=1e-2))


def test_ssd_forward_and_decode_match_reference():
    """hymba's SSD branch (4 heads, state 8, expand 2) forward with and
    without its final state, then a decode step from it; the CPU never
    takes the kernel path."""
    r = _rng(8)
    jp = j_ssm.init_ssd(jax.random.key(5), 32, 4, 8, 2, jnp.float32)
    x = _normal(r, 2, 40, 32)
    kw = dict(heads=4, state=8, expand=2)
    want, want_h = _ref(j_ssm.ssd_forward, jp, x, chunk=16,
                        return_state=True, **kw)
    before = t_gla.gla_forward.launches
    got = t_ssm.ssd_forward(_carry(jp), _t(x), chunk=16, **kw)
    got2, got_h = t_ssm.ssd_forward(_carry(jp), _t(x), chunk=16,
                                    return_state=True, **kw)
    assert t_gla.gla_forward.launches == before
    _close(got, want)
    _close(got2, want)
    _close(got_h, want_h)
    x1 = _normal(r, 2, 1, 32)
    want = _ref(j_ssm.ssd_decode, jp, x1, want_h, **kw)
    got = t_ssm.ssd_decode(_carry(jp), _t(x1), got_h, **kw)
    for g, w in zip(got, want):
        _close(g, w)


def test_mlstm_forward_and_decode_match_reference():
    r = _rng(9)
    jp = j_ssm.init_mlstm(jax.random.key(6), 32, 4, jnp.float32)
    x = _normal(r, 2, 40, 32)
    want, want_h = _ref(j_ssm.mlstm_forward, jp, x, heads=4, chunk=16,
                        return_state=True)
    got, got_h = t_ssm.mlstm_forward(_carry(jp), _t(x), heads=4, chunk=16,
                                     return_state=True)
    _close(got, want)
    _close(got_h, want_h)
    assert tuple(got_h.shape) == t_ssm.mlstm_state_shape(2, 32, 4)
    x1 = _normal(r, 2, 1, 32)
    want = _ref(j_ssm.mlstm_decode, jp, x1, want_h, heads=4)
    got = t_ssm.mlstm_decode(_carry(jp), _t(x1), got_h, heads=4)
    for g, w in zip(got, want):
        _close(g, w)


def test_slstm_forward_and_decode_match_reference():
    r = _rng(10)
    jp = j_ssm.init_slstm(jax.random.key(7), 32, jnp.float32)
    x = _normal(r, 2, 24, 32)
    want, want_c = _ref(j_ssm.slstm_forward, jp, x, return_state=True)
    got, got_c = t_ssm.slstm_forward(_carry(jp), _t(x), return_state=True)
    _close(got, want)
    for g, w in zip(got_c, want_c):
        _close(g, w)
    x1 = _normal(r, 2, 1, 32)
    want = _ref(j_ssm.slstm_decode, jp, x1, want_c)
    got = t_ssm.slstm_decode(_carry(jp), _t(x1), got_c)
    _close(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        _close(g, w)
