"""repro_torch.kernels.gla against repro.kernels.gla (Pallas interpret
mode) and repro.models.ssm.gla_chunked on the CPU, plus the CUDA GLA kernel
against its plain version on a card (``gpu``-marked; it skips inside the
test when there is none).

Inputs are made from a numpy seed the way ``tests/test_gla_kernel.py``
makes its own (q, k ~ 0.3 N(0,1), v ~ N(0,1), log_decay = -0.1
softplus(N(0,1)), log_inc = clip(0.3 N(0,1), -2, 2)). Tolerance: the
reference test's own, rtol = atol = 2e-4: the chunk's cumulative sums and
the products are summed in other orders."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gla

try:
    import jax.numpy as jnp

    from repro.kernels.gla import gla_forward as j_gla_forward
    from repro.models.ssm import gla_chunked as j_gla_chunked
except ModuleNotFoundError:     # a CUDA host may have no JAX installed
    jnp = j_gla_forward = j_gla_chunked = None

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def cuda():
    """The card, decided inside the test so every worker collects alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100 with "
                    "`python -m pytest -m gpu tests/test_torch_gla.py`")
    return torch.device("cuda")


@pytest.fixture
def reference():
    if jnp is None:
        pytest.skip("needs the JAX reference package `repro`, and JAX is "
                    "not installed")


def _inputs(case, seed=0, decay_scale=0.1):
    """numpy float32 (q, k, v, log_decay, log_inc) for (B, S, H, N, P)."""
    b, s, h, n, p = case
    r = np.random.default_rng(seed)
    q = (r.standard_normal((b, s, h, n)) * 0.3).astype(np.float32)
    k = (r.standard_normal((b, s, h, n)) * 0.3).astype(np.float32)
    v = r.standard_normal((b, s, h, p)).astype(np.float32)
    ld = (-np.logaddexp(0.0, r.standard_normal((b, s, h))) * decay_scale
          ).astype(np.float32)
    li = np.clip(r.standard_normal((b, s, h)) * 0.3, -2, 2).astype(np.float32)
    return q, k, v, ld, li


def _check_all(x, chunk):
    """The port's plain version and the CPU path of ``gla_forward``
    against the reference's Pallas kernel and its jnp engine."""
    want_kernel = np.asarray(j_gla_forward(*map(jnp.asarray, x),
                                           chunk=chunk))
    want_engine = np.asarray(j_gla_chunked(*map(jnp.asarray, x),
                                           chunk=chunk)[0])
    t = [torch.from_numpy(a) for a in x]
    plain = gla.gla_forward_plain(*t, chunk=chunk).numpy()
    before = gla.gla_forward.launches
    got = gla.gla_forward(*t, chunk=chunk, device="cpu")
    assert gla.gla_forward.launches == before      # no kernel on the CPU
    assert got.dtype == torch.float32 and got.shape == x[2].shape
    for mine in (plain, got.numpy()):
        np.testing.assert_allclose(mine, want_kernel, **TOL)
        np.testing.assert_allclose(mine, want_engine, **TOL)


@pytest.mark.parametrize("case,chunk", [
    ((2, 64, 2, 16, 32), 16),        # the reference test's tier-1 shape
    ((2, 96, 1, 8, 24), 32),         # S not a multiple of the chunk
    ((1, 40, 2, 8, 8), 64),          # S shorter than the chunk
    ((1, 128, 4, 16, 16), 128),      # one chunk of the default length
])
def test_gla_matches_reference(case, chunk, reference):
    _check_all(_inputs(case, seed=sum(case)), chunk)


def test_gla_mlstm_v_augmented(reference):
    """mLSTM's ones column: P = N + 1, the normalizer in the last column."""
    q, k, v, ld, li = _inputs((1, 64, 2, 16, 16), seed=7)
    v = np.concatenate([v, np.ones(v.shape[:3] + (1,), np.float32)], -1)
    _check_all((q, k, v, ld, li), 16)


@pytest.mark.parametrize("decay", [0.0, -50.0])
def test_gla_zero_and_total_decay(decay, reference):
    """log_decay = 0 keeps all history across chunks; -50 forgets it at
    every step (the clamps act: exp(-80) at the chunk's far end)."""
    q, k, v, ld, li = _inputs((1, 64, 1, 8, 8), seed=5)
    _check_all((q, k, v, np.full_like(ld, decay), li), 16)


def test_gla_state_carries_across_chunks():
    """Keeping and forgetting differ in later chunks: the state is carried."""
    q, k, v, ld, li = (torch.from_numpy(a)
                       for a in _inputs((1, 64, 1, 8, 8), seed=5))
    keep = gla.gla_forward(q, k, v, torch.zeros_like(ld), li, chunk=16,
                           device="cpu")
    forget = gla.gla_forward(q, k, v, torch.full_like(ld, -50.0), li,
                             chunk=16, device="cpu")
    assert not torch.allclose(keep[:, -16:], forget[:, -16:], atol=1e-3)


def test_gla_folded_plain_is_the_model_math():
    """The kernel's plain version on folded operands equals the model-level
    plain version per (batch, head)."""
    q, k, v, ld, li = (torch.from_numpy(a)
                       for a in _inputs((2, 32, 3, 8, 5), seed=1))
    want = gla.gla_forward_plain(q, k, v, ld, li, chunk=16)

    def fold(a):
        return a.transpose(1, 2).reshape(6, 32, *a.shape[3:])

    got = gla.gla_folded_plain(*map(fold, (q, k, v, ld, li)), 16)
    assert torch.equal(got.reshape(2, 3, 32, 5).transpose(1, 2), want)


def test_gla_rejects_bf16_and_bad_shapes():
    q, k, v, ld, li = (torch.from_numpy(a)
                       for a in _inputs((1, 16, 1, 4, 4), seed=2))
    with pytest.raises(NotImplementedError, match="bf16"):
        gla.gla_forward(q.bfloat16(), k, v, ld, li, device="cpu")
    with pytest.raises(ValueError, match="shapes"):
        gla.gla_forward(q, k[:, :8], v, ld, li, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        gla.gla_forward(q.double(), k, v, ld, li, device="cpu")


# --- on the card -------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("case,chunk", [
    ((2, 64, 2, 16, 32), 16), ((2, 96, 1, 8, 24), 32),
    ((1, 256, 4, 16, 128), 128), ((1, 200, 2, 256, 257), 128),
    ((1, 64, 3, 40, 70), 64)])
def test_gla_kernel_matches_plain_on_card(cuda, case, chunk):
    x = [torch.from_numpy(a).to(cuda) for a in _inputs(case, seed=3)]
    want = gla.gla_forward_plain(*x, chunk=chunk)
    before = gla.gla_forward.launches
    got = gla.gla_forward(*x, chunk=chunk)
    torch.cuda.synchronize()
    assert gla.gla_forward.launches == before + 1
    torch.testing.assert_close(got, want, **TOL)
