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


def _regime(case, regime, chunk, seed=0):
    """Inputs whose gates stress the weights' clips. ``model``: hymba's SSD
    gates at initialisation (``repro.models.ssm._ssd_gates``: dt =
    softplus(x w_dt) with x w_dt ~ N(0, 0.8^2), a_log = 0), whose running
    sum falls by about 100 over a chunk of 128, so the clips bite inside
    every chunk. ``spike``: log_decay -70 at each chunk's first step and 0
    after it, log_inc 10, q, k, v ~ 3 |N(0,1)| (no cancellation, so that
    the sums are as large as they can be and float32 holds them to the
    tolerance): every weight is exp(10), but exp(log_inc - cum) alone would
    be exp(80)."""
    q, k, v, ld, li = _inputs(case, seed=seed)
    r = np.random.default_rng(seed + 1)
    if regime == "model":
        dt = np.logaddexp(0.0, r.standard_normal(ld.shape) * 0.8)
        return q, k, v, (-dt).astype(np.float32), \
            np.log(dt + 1e-9).astype(np.float32)
    ld = np.zeros_like(ld)
    ld[:, ::chunk] = -70.0
    return np.abs(q) * 10, np.abs(k) * 10, np.abs(v) * 3, ld, \
        np.full_like(li, 10.0)


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


@pytest.mark.parametrize("regime", ["model", "spike"])
def test_gla_gate_regimes_match_reference(regime, reference):
    """Gates that drive the weights into the clips (see ``_regime``)."""
    _check_all(_regime((1, 96, 2, 16, 24), regime, 32, seed=9), 32)


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


def _fold(x):
    b, s, h = x[3].shape
    return [torch.from_numpy(a).transpose(1, 2).reshape(b * h, s,
                                                        *a.shape[3:])
            .contiguous() for a in x]


def _stages(folded, chunk):
    """The kernel path's decomposition, stage by stage, on folded operands
    (the stage wrappers: plain versions on CPU tensors, kernels on CUDA)."""
    q, k, v, ld, li = folded
    states, tot = gla.chunk_states(k, v, ld, li, chunk)
    h_in = gla.state_pass(states.clone(), tot)
    return states, tot, h_in, gla.chunk_output(q, k, v, ld, li, h_in, chunk)


@pytest.mark.parametrize("case,chunk,ones", [
    ((2, 64, 2, 16, 32), 16, False),   # the reference test's tier-1 shape
    ((2, 96, 1, 8, 24), 32, False),    # S not a multiple of the chunk
    ((1, 40, 2, 8, 8), 64, False),     # S shorter than the chunk
    ((1, 128, 4, 16, 16), 128, False),  # one chunk of the default length
    ((1, 64, 2, 16, 16), 16, True),    # mLSTM's ones column, P = N + 1
])
def test_gla_stages_compose_to_the_reference(case, chunk, ones, reference):
    """Chunk states, state pass and chunk output composed equal
    ``gla_folded_plain`` and the reference's Pallas kernel (interpret mode)
    and jnp engine, on the padded, folded operands."""
    x = list(_inputs(case, seed=sum(case)))
    if ones:
        x[2] = np.concatenate([x[2], np.ones(x[2].shape[:3] + (1,),
                                             np.float32)], -1)
    b, s, h, _ = x[0].shape
    p = x[2].shape[-1]
    length = min(chunk, s)
    padded = gla._pad(*(torch.from_numpy(a) for a in x), length)
    folded = _fold([a.numpy() for a in padded])
    states, tot, h_in, y = _stages(folded, length)
    sp = folded[0].shape[1]
    assert states.shape == (b * h, sp // length, case[3], p)
    assert tot.shape == (b * h, sp // length)
    assert torch.equal(h_in[:, 0], torch.zeros_like(h_in[:, 0]))
    torch.testing.assert_close(y, gla.gla_folded_plain(*folded, length),
                               **TOL)
    got = y.reshape(b, h, sp, p).transpose(1, 2)[:, :s].numpy()
    want_kernel = np.asarray(j_gla_forward(*map(jnp.asarray, x),
                                           chunk=chunk))
    want_engine = np.asarray(j_gla_chunked(*map(jnp.asarray, x),
                                           chunk=chunk)[0])
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_engine, **TOL)


def test_gla_state_pass_is_the_reference_recurrence():
    """H_in(c+1) = H_in(c) * exp(clip(tot_c)) + S_c, from H_in(0) = 0, and
    the last chunk's state is never read."""
    folded = _fold(_inputs((1, 64, 2, 8, 6), seed=4))
    states, tot = gla.gla_chunk_states_plain(*folded[1:], 16)
    h_in = gla.gla_state_pass_plain(states, tot)
    h = torch.zeros_like(states[:, 0])
    for c in range(4):
        torch.testing.assert_close(h_in[:, c], h, rtol=0, atol=0)
        h = h * torch.exp(torch.clamp(tot[:, c], -80, 20))[:, None, None] \
            + states[:, c]
    states[:, -1] = 1e9
    assert torch.equal(gla.gla_state_pass_plain(states, tot), h_in)


def test_gla_rejects_bf16_and_bad_shapes():
    """bfloat16 q, k and v are taken together (see the bf16 tests below);
    bfloat16 mixed with float32 operands, other dtypes and bad shapes are
    refused."""
    q, k, v, ld, li = (torch.from_numpy(a)
                       for a in _inputs((1, 16, 1, 4, 4), seed=2))
    with pytest.raises(ValueError, match="one dtype"):
        gla.gla_forward(q.bfloat16(), k, v, ld, li, device="cpu")
    with pytest.raises(ValueError, match="shapes"):
        gla.gla_forward(q, k[:, :8], v, ld, li, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        gla.gla_forward(q.double(), k, v, ld, li, device="cpu")
    with pytest.raises(ValueError, match="bfloat16"):
        gla.gla_forward(q.half(), k.half(), v.half(), ld, li, device="cpu")
    with pytest.raises(ValueError, match="gates"):
        gla.gla_forward(q, k, v, ld.half(), li, device="cpu")


# --- bfloat16 ----------------------------------------------------------------
#
# The bf16 bound, elementwise: |got - want| <= 2^-7 |want| + 2^-8 max|want|.
# Both sides round where the reference's kernel rounds (q k^T o W to
# bfloat16 before it meets v, y to bfloat16) from float32 sums taken in
# other orders, so a value within float32 rounding of a bfloat16 tie may
# round either way: at y one bfloat16 unit of the entry (2^-7 relative at
# most), at a q k^T o W term one unit of that term, which the second part
# bounds. The float32 tolerance above does not hold: one bfloat16 unit is
# 2^-8 to 2^-7 of a value. (The reference's jnp engine rounds elsewhere, q
# k^T and the carried state too; against the kernel it differs by ~0.5% of
# max|y|, so it is not held to this bound.)

def _bf16_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = 2.0 ** -7 * np.abs(want) + 2.0 ** -8 * np.abs(want).max()
    err = np.abs(got - want)
    assert (err <= tol).all(), (float(err.max()), float(np.abs(want).max()))


def _bf16_inputs(case, seed, ones=False):
    """bfloat16 q, k, v (rounded from ``_inputs``) and float32 gates, as
    torch tensors and as the reference's jnp arrays."""
    x = list(_inputs(case, seed=seed))
    if ones:
        x[2] = np.concatenate([x[2], np.ones(x[2].shape[:3] + (1,),
                                             np.float32)], -1)
    t = [torch.from_numpy(a).bfloat16() for a in x[:3]] + \
        [torch.from_numpy(a) for a in x[3:]]
    j = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
         for a in t[:3]] + [jnp.asarray(a) for a in x[3:]]
    return t, j


@pytest.mark.parametrize("case,chunk,ones", [
    ((2, 64, 2, 16, 32), 16, False),   # N <= 16 (hymba's SSD heads)
    ((1, 64, 2, 40, 33), 32, False),   # N > 16 and an odd P
    ((1, 50, 2, 24, 24), 32, True),    # mLSTM's ones column, S padded
])
def test_gla_bf16_matches_reference(case, chunk, ones, reference):
    """bfloat16 q, k, v: the plain version, the CPU path of gla_forward and
    the three stages composed against the reference's Pallas kernel at
    bfloat16 (interpret mode), within the bf16 bound; y in v's dtype."""
    t, j = _bf16_inputs(case, sum(case), ones)
    want = np.asarray(j_gla_forward(*j, chunk=chunk).astype(jnp.float32))
    plain = gla.gla_forward_plain(*t, chunk=chunk)
    got = gla.gla_forward(*t, chunk=chunk, device="cpu")
    assert plain.dtype == got.dtype == torch.bfloat16
    assert got.shape == t[2].shape
    _bf16_close(plain.float().numpy(), want)
    _bf16_close(got.float().numpy(), want)
    b, s, h, _ = t[0].shape
    length = min(chunk, s)
    folded = [a.transpose(1, 2).reshape(b * h, a.shape[1], *a.shape[3:])
              .contiguous() for a in gla._pad(*t, length)]
    *_, y = _stages(folded, length)
    assert y.dtype == torch.bfloat16
    sp = folded[0].shape[1]
    y = y.reshape(b, h, sp, -1).transpose(1, 2)[:, :s]
    _bf16_close(y.float().numpy(), want)


def test_gla_bf16_rounds_where_the_reference_kernel_rounds():
    """The plain version at bfloat16 is its float32 math on the widened
    inputs with q k^T o W rounded to bfloat16 before it meets v: not the
    float32 result rounded once."""
    t = [torch.from_numpy(a) for a in _inputs((1, 32, 1, 16, 8), seed=11)]
    t = [a.bfloat16() for a in t[:3]] + t[3:]
    y = gla.gla_forward_plain(*t, chunk=16)
    wide = gla.gla_forward_plain(*[a.float() for a in t], chunk=16)
    assert y.dtype == torch.bfloat16 and wide.dtype == torch.float32
    assert not torch.equal(y, wide.bfloat16())
    _bf16_close(y.float().numpy(), wide.numpy())


# --- on the card -------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("case,chunk", [
    ((2, 64, 2, 16, 32), 16), ((2, 96, 1, 8, 24), 32),
    ((1, 256, 4, 16, 128), 128), ((1, 200, 2, 256, 257), 128),
    ((1, 64, 3, 40, 70), 64),
    ((2, 2048, 4, 16, 64), 16)])   # enough chunks that a CTA walks P-tiles
def test_gla_kernel_matches_plain_on_card(cuda, case, chunk):
    x = [torch.from_numpy(a).to(cuda) for a in _inputs(case, seed=3)]
    want = gla.gla_forward_plain(*x, chunk=chunk)
    before = gla.gla_forward.launches
    got = gla.gla_forward(*x, chunk=chunk)
    torch.cuda.synchronize()
    assert gla.gla_forward.launches == before + 1
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("decay", [0.0, -50.0])
@pytest.mark.parametrize("case", [(1, 256, 2, 16, 64), (1, 256, 2, 40, 70)])
def test_gla_kernel_clipped_weights_on_card(cuda, case, decay):
    """log_decay = 0 keeps every weight inside the clips; -50 drives them
    into the clips at every step, and its running sum spans 6,400 within a
    chunk: the N <= 16 kernel then takes each entry's own clipped exp, as
    the N > 16 kernel always does."""
    q, k, v, ld, li = (torch.from_numpy(a).to(cuda)
                       for a in _inputs(case, seed=6))
    ld = torch.full_like(ld, decay)
    want = gla.gla_forward_plain(q, k, v, ld, li, chunk=128)
    got = gla.gla_forward(q, k, v, ld, li, chunk=128)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("regime", ["model", "spike"])
@pytest.mark.parametrize("case", [(1, 256, 2, 16, 64), (1, 256, 2, 40, 70)])
def test_gla_kernel_gate_regimes_on_card(cuda, case, regime):
    """Gates whose weights reach the clips inside a chunk (``_regime``):
    the N <= 16 kernel makes them from an exp a row and an exp a column,
    clipping the product; the result is finite where the reference's is."""
    q, k, v, ld, li = (torch.from_numpy(a).to(cuda)
                       for a in _regime(case, regime, 128, seed=8))
    want = gla.gla_forward_plain(q, k, v, ld, li, chunk=128)
    got = gla.gla_forward(q, k, v, ld, li, chunk=128)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(want).all())
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("case,chunk", [
    ((2, 64, 2, 16, 32), 16), ((2, 96, 1, 8, 24), 32),
    ((1, 256, 4, 16, 128), 128), ((1, 200, 2, 256, 257), 128),
    ((1, 64, 3, 40, 70), 64),
    ((2, 2048, 4, 16, 64), 16)])   # enough chunks that a CTA walks P-tiles
def test_gla_stage_kernels_match_plain_on_card(cuda, case, chunk):
    """Each of the three kernels against its plain stage on the same
    inputs: every chunk's own state and total decay (the last chunk's are
    never read, so the kernel does not write them), H_in at every chunk,
    and y from the plain H_in."""
    x = [torch.from_numpy(a) for a in _inputs(case, seed=3)]
    length = min(chunk, case[1])
    folded = [a.to(cuda) for a in _fold([t.numpy() for t in gla._pad(
        *x, length)])]
    q, k, v, ld, li = folded
    want_states, want_tot = gla.gla_chunk_states_plain(k, v, ld, li, length)
    want_h = gla.gla_state_pass_plain(want_states, want_tot)
    states, tot = gla.chunk_states(k, v, ld, li, length)
    torch.cuda.synchronize()
    torch.testing.assert_close(states[:, :-1], want_states[:, :-1], **TOL)
    torch.testing.assert_close(tot[:, :-1], want_tot[:, :-1], **TOL)
    h_in = gla.state_pass(want_states.clone(), want_tot)
    torch.cuda.synchronize()
    for c in range(h_in.shape[1]):
        torch.testing.assert_close(h_in[:, c], want_h[:, c], **TOL)
    y = gla.chunk_output(q, k, v, ld, li, want_h, length)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        y, gla.gla_chunk_output_plain(q, k, v, ld, li, want_h, length), **TOL)


def _bf16_card_check(t, chunk):
    """The bfloat16 kernel path on ``t`` (bfloat16 q, k, v and float32
    gates on the card) and its stages against their plain versions: y
    within the bf16 bound, the chunk states within ``TOL`` of the plain
    stage, y from the plain H_in within the bf16 bound."""
    want = gla.gla_forward_plain(*t, chunk=chunk)
    before = (gla.gla_forward.launches, gla.gla_forward.bf16_launches)
    got = gla.gla_forward(*t, chunk=chunk)
    torch.cuda.synchronize()
    assert (gla.gla_forward.launches, gla.gla_forward.bf16_launches) == (
        before[0] + 1, before[1] + 1)
    assert got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    _bf16_close(got.float().cpu().numpy(), want.float().cpu().numpy())
    length = min(chunk, t[0].shape[1])
    folded = [a.transpose(1, 2).reshape(-1, a.shape[1], *a.shape[3:])
              .contiguous() for a in gla._pad(*t, length)]
    q, k, v, ld, li = folded
    want_states, want_tot = gla.gla_chunk_states_plain(k, v, ld, li, length)
    want_h = gla.gla_state_pass_plain(want_states, want_tot)
    states, tot = gla.chunk_states(k, v, ld, li, length)
    y = gla.chunk_output(q, k, v, ld, li, want_h, length)
    torch.cuda.synchronize()
    torch.testing.assert_close(states[:, :-1], want_states[:, :-1], **TOL)
    torch.testing.assert_close(tot[:, :-1], want_tot[:, :-1], **TOL)
    _bf16_close(y.float().cpu().numpy(), gla.gla_chunk_output_plain(
        q, k, v, ld, li, want_h, length).float().cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("case,chunk,ones", [
    ((1, 256, 4, 16, 128), 128, False), ((2, 96, 1, 8, 24), 32, False),
    ((1, 200, 2, 256, 256), 128, True), ((1, 64, 3, 40, 70), 64, False),
    ((2, 2048, 4, 16, 64), 16, False),
    ((2, 512, 2, 16, 128), 128, False),     # hymba's head, narrow
    ((2, 512, 2, 16, 128), 64, False),      # chunks of 64
    ((1, 1000, 2, 16, 128), 128, False),    # S padded to 1024
    ((1, 256, 2, 256, 256), 64, True),      # N=256, P=257, chunks of 64
    ((1, 100, 2, 12, 10), 32, False)])      # rows of 4-byte copies
def test_gla_bf16_kernel_matches_plain_on_card(cuda, case, chunk, ones):
    """The bfloat16 kernel path and its stages against their plain versions
    within the bf16 bound (P = 257 with the ones column: rows of bfloat16
    that are 2-byte aligned only, plain loads; N = 12: 4-byte copies)."""
    x = list(_inputs(case, seed=4))
    if ones:
        x[2] = np.concatenate([x[2], np.ones(x[2].shape[:3] + (1,),
                                             np.float32)], -1)
    t = [torch.from_numpy(a).to(cuda) for a in x]
    _bf16_card_check([a.bfloat16() for a in t[:3]] + t[3:], chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("regime", ["model", "spike", 0.0, -50.0])
@pytest.mark.parametrize("case", [(1, 256, 2, 16, 64), (1, 256, 2, 40, 70)])
def test_gla_bf16_gate_regimes_on_card(cuda, case, regime):
    """The float32 card tests' clipped-gate regimes in bfloat16: hymba's
    model gates and the spike (``_regime``), log_decay 0 (no clip) and -50
    (every weight in the clips; the narrow kernel then takes each entry's
    own clipped exp), the whole path and its stages within the bounds."""
    if isinstance(regime, str):
        x = _regime(case, regime, 128, seed=8)
    else:
        x = list(_inputs(case, seed=6))
        x[3] = np.full_like(x[3], regime)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in x]
    _bf16_card_check([a.bfloat16() for a in t[:3]] + t[3:], 128)
