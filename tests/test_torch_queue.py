"""The queue algorithm (paper §4.1): repro_torch's ``ops.queue_step`` and
``pso_step.queue_plain`` against ``repro.kernels.ops.queue_step`` (Pallas
interpret mode) and ``ref.queue_step_oracle`` on the CPU, plus the CUDA
queue kernel against its plain version and the fused kernel on a card
(``gpu``-marked; they skip inside the test when there is none).

Tolerances are those of ``test_torch_kernels.py``: after each step from a
shared state, positions, velocities and pbest positions within rtol=2e-6
and atol=max(1e-5, 1e-6 * box width) (XLA:CPU contracts the velocity chain
into FMAs, whose rounding is an ulp of the box), fitness within rtol=1e-5
and atol=1e-5 * max|fit| (the objective is summed in another order).
Improvement masks, the winning block and the winner's index must be
equal. The queue kernel has no deliberate difference from the reference:
the TPU queue kernel is synchronous too."""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import pso
from repro_torch.kernels import ops, pso_step

try:
    from repro.core import pso as jpso
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ModuleNotFoundError:     # a CUDA host may have no JAX installed
    jpso = jops = jref = None

torch.set_num_threads(1)

FITNESS = ("cubic", "sphere", "rosenbrock", "griewank", "rastrigin", "ackley")
RULES = ("pso", "sso", "lowcost")
FIELDS = ("pos", "vel", "pbest_pos", "pbest_fit", "gbest_pos", "gbest_fit")


@pytest.fixture
def cuda():
    """The card, decided inside the test so every worker collects alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100 with "
                    "`python -m pytest -m gpu tests/test_torch_queue.py`")
    return torch.device("cuda")


@pytest.fixture
def reference():
    """The JAX reference, for the parity tests on the CPU."""
    if jpso is None:
        pytest.skip("needs the JAX reference package `repro`, and JAX is "
                    "not installed")


def _cfgs(fit, rule="pso", d=3, n=128):
    return (jpso.PSOConfig(dim=d, particle_cnt=n, fitness=fit,
                           update_rule=rule).resolved(),
            pso.PSOConfig(dim=d, particle_cnt=n, fitness=fit,
                          update_rule=rule).resolved())


def _np(s):
    return {k: (None if getattr(s, k) is None else np.asarray(getattr(s, k)))
            for k in s._fields}


def _port(js):
    return pso.state_from_numpy(_np(js), device="cpu")


def _pos_tol(cfg):
    width = max(float(np.max(np.subtract(cfg.max_pos, cfg.min_pos))), 1.0)
    return dict(rtol=2e-6, atol=max(1e-5, 1e-6 * width))


def _fit_tol(ref):
    return dict(rtol=1e-5,
                atol=1e-5 * max(1.0, float(np.max(np.abs(np.asarray(ref))))))


def _assert_close(got, want, cfg):
    for f in ("pos", "vel", "pbest_pos", "gbest_pos"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   **_pos_tol(cfg), err_msg=f)
    for f in ("fit", "pbest_fit", "gbest_fit"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   **_fit_tol(want.pbest_fit), err_msg=f)
    assert got.iteration == int(want.iteration)


def _assert_same_improvements(got_pbf, want_pbf, old_pbf):
    """The pbest improvement masks agree wherever the new fitness is not
    tied with the old pbest at the fitness tolerance (SSO may copy a
    particle back onto its pbest, and an ulp decides that tie)."""
    got, want = got_pbf > old_pbf, want_pbf > old_pbf
    scale = 1e-5 * max(1.0, float(np.max(np.abs(old_pbf))))
    clear = np.abs(np.maximum(got_pbf, want_pbf) - old_pbf) > scale
    assert np.array_equal(got[clear], want[clear])


# Pairwise coverage of objective x rule x blocks: every objective with
# every rule, and each of them with one block and with four.
_CASES = [(f, r, (1, 4)[i % 2])
          for i, (f, r) in enumerate(itertools.product(FITNESS, RULES))]


@pytest.mark.parametrize("fit,rule,nb", _CASES)
def test_queue_step_matches_pallas_queue_step(fit, rule, nb, reference):
    """Five steps, each from the reference's state: the port's whole
    ``ops.queue_step`` (kernel plain version, then the cross-block
    epilogue) against ``repro.kernels.ops.queue_step`` in interpret mode.
    The first is the one-step case; the others start from a state whose
    gbest the reference's queue has already moved."""
    n = 128
    jc, tc = _cfgs(fit, rule, n=n)
    js = jpso.init_swarm(jc, 11)
    for _ in range(5):
        want = jops.queue_step(jc, js, block_n=n // nb, interpret=True)
        got = ops.queue_step(tc, _port(js), block_n=n // nb)
        _assert_close(got, want, tc)
        _assert_same_improvements(got.pbest_fit.numpy(),
                                  np.asarray(want.pbest_fit),
                                  np.asarray(js.pbest_fit))
        js = want


def _oracle(jc, tc, js, bn, gf=None):
    """The port's plain kernel and the reference's oracle on the same
    D-major operands; ``gf`` overrides the input gbest."""
    state = list(ops.state_to_kernel(_port(js)))
    if gf is not None:
        state[5] = torch.tensor([gf], dtype=torch.float32)
    pos, vel, pbp, pbf, gp, gf_ = (x.numpy() for x in state)
    kw = jops._cfg_kwargs(jc)
    want = jref.queue_step_oracle(
        int(js.seed), int(js.iteration), pos, vel, pbp, pbf[None, :],
        gp[:, None], float(gf_[0]), bn, d_real=tc.dim, **kw)
    got = pso_step.queue_plain(*state, ops.kernel_spec(tc), seed=int(js.seed),
                               iteration=int(js.iteration), block_n=bn)
    return state, got, want


@pytest.mark.parametrize("fit,rule", [("cubic", "pso"), ("rastrigin", "sso"),
                                      ("ackley", "lowcost"),
                                      ("rosenbrock", "pso")])
def test_queue_plain_matches_queue_step_oracle(fit, rule, reference):
    """Four blocks: each block's (aux_fit, aux_idx) and the state against
    ``ref.queue_step_oracle``; the winner's index exactly, and the port's
    epilogue (``ops.queue_step``) takes the oracle's gbest."""
    n, bn = 128, 32
    jc, tc = _cfgs(fit, rule, n=n)
    js = jpso.init_swarm(jc, 5)
    for _ in range(3):
        state, got, want = _oracle(jc, tc, js, bn)
        for a, b in zip(got[:4], want[:4]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(
                a.shape), **(_fit_tol(want[3]) if a.dim() == 1
                             else _pos_tol(tc)))
        aux_fit, aux_idx = np.asarray(want[6]), np.asarray(want[7])
        np.testing.assert_allclose(got[4].numpy(), aux_fit,
                                   **_fit_tol(want[3]))
        assert np.array_equal(got[5].numpy(), aux_idx)
        assert got[5].dtype == torch.int32
        out = ops.queue_step(tc, _port(js), block_n=bn)
        np.testing.assert_allclose(out.gbest_pos.numpy(),
                                   np.asarray(want[4]).reshape(-1),
                                   **_pos_tol(tc))
        np.testing.assert_allclose(float(out.gbest_fit), float(want[5]),
                                   **_fit_tol(want[3]))
        js = jops.queue_step(jc, js, block_n=bn, interpret=True)


def test_queue_plain_empty_queue_reports_block_bases(reference):
    """No lane beats the input gbest: every block reports -inf at its base
    index, as the reference's ``_queue_best`` does, and gbest stays."""
    n, bn = 128, 32
    jc, tc = _cfgs("sphere", n=n)
    js = jpso.init_swarm(jc, 2)
    _, got, want = _oracle(jc, tc, js, bn, gf=1e30)
    assert np.all(np.isneginf(got[4].numpy()))
    assert np.array_equal(got[5].numpy(), np.asarray(want[7]))
    assert got[5].tolist() == [0, 32, 64, 96]
    s = _port(js)._replace(gbest_fit=torch.tensor(1e30))
    out = ops.queue_step(tc, s, block_n=bn)
    assert torch.equal(out.gbest_pos, s.gbest_pos)
    assert float(out.gbest_fit) == float(torch.tensor(1e30))


@pytest.mark.parametrize("fit,rule,bn", [("cubic", "pso", 32),
                                         ("griewank", "sso", 16),
                                         ("rastrigin", "lowcost", 128)])
def test_queue_step_iterated_is_fused_plain(fit, rule, bn):
    """Five ``ops.queue_step`` calls equal ``run_queue_lock_fused``'s five
    synchronous iterations on the CPU bit for bit: the same advance, the
    same fold, the same winner (first block on ties, then first lane)."""
    tc = pso.PSOConfig(dim=3, particle_cnt=128, fitness=fit,
                       update_rule=rule).resolved()
    s0 = pso.init_swarm(tc, 9, device="cpu")
    s = s0
    for _ in range(5):
        s = ops.queue_step(tc, s, block_n=bn)
    fused = ops.run_queue_lock_fused(tc, s0, 5, block_n=bn)
    for f in FIELDS + ("fit",):
        assert torch.equal(getattr(s, f), getattr(fused, f)), f
    assert s.iteration == fused.iteration == 5


def test_queue_kernel_path_on_cpu_tensors_raises_and_counts_nothing():
    tc = pso.PSOConfig(dim=2, particle_cnt=128).resolved()
    s = pso.init_swarm(tc, 0, device="cpu")
    before = pso_step.queue_step.launches
    ops.queue_step(tc, s, block_n=64)
    assert pso_step.queue_step.launches == before
    with pytest.raises(ValueError, match="divisor"):
        ops.queue_step(tc, s, block_n=100)


# --- on the card -------------------------------------------------------------

def _card_state(cuda, fit, rule, d, n, seed=1):
    cfg = pso.PSOConfig(dim=d, particle_cnt=n, fitness=fit,
                        update_rule=rule).resolved()
    s = pso.init_swarm(cfg, seed, device=cuda)
    return cfg, ops.kernel_spec(cfg), ops.state_to_kernel(s), s


@pytest.mark.gpu
@pytest.mark.parametrize("fit,rule,d,n,bn", [
    ("cubic", "pso", 1, 131072, 512), ("rastrigin", "sso", 5, 2048, 256),
    ("griewank", "lowcost", 3, 1024, 1024), ("ackley", "pso", 24, 4096,
                                              512)])
def test_queue_kernel_matches_plain_on_card(cuda, fit, rule, d, n, bn):
    _, spec, state, s = _card_state(cuda, fit, rule, d, n)
    kw = dict(seed=s.seed, iteration=37, block_n=bn)
    want = pso_step.queue_plain(*state, spec, **kw)
    before = pso_step.queue_step.launches
    got = pso_step.queue_step(*[x.clone() for x in state], spec, **kw)
    torch.cuda.synchronize()
    assert pso_step.queue_step.launches == before + 1
    for a, w in zip(got[:4], want[:4]):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[4], want[4], rtol=1e-5, atol=1e-5)
    assert torch.equal(got[5], want[5])


@pytest.mark.gpu
@pytest.mark.parametrize("fit,d,n", [("cubic", 1, 131072),
                                     ("rastrigin", 120, 32768)])
def test_queue_step_iterated_equals_fused_kernel_on_card(cuda, fit, d, n):
    """Both are synchronous PPSO with the same rounding and tie-break, so
    k queue steps and one fused launch of k iterations agree bit for bit."""
    cfg, _, _, s0 = _card_state(cuda, fit, "pso", d, n)
    s = s0
    for _ in range(4):
        s = ops.queue_step(cfg, s, block_n=512)
    fused = ops.run_queue_lock_fused(cfg, s0, 4, block_n=512)
    torch.cuda.synchronize()
    for f in FIELDS:
        assert torch.equal(getattr(s, f), getattr(fused, f)), f


# Every objective with every rule on clusters: d=120 (C=8 on an H100) and
# d=37 (C=2, uneven slices), one block (n=128) and two (n=1024).
_CLUSTER_SHAPES = ((120, 1024, 512), (37, 128, 128), (120, 128, 128),
                   (37, 1024, 512))
_CLUSTER_CASES = [(f, r) + _CLUSTER_SHAPES[i % 4]
                  for i, (f, r) in enumerate(itertools.product(FITNESS,
                                                               RULES))]


@pytest.mark.gpu
@pytest.mark.parametrize("fit,rule,d,n,bn", _CLUSTER_CASES)
def test_cluster_queue_kernel_matches_plain_on_card(cuda, fit, rule, d, n,
                                                    bn):
    """The queue kernel with each particle block split over a cluster
    against its plain version: positions to rounding, fitness to the
    objective's ulps, the blocks' winners exactly."""
    _, spec, state, s = _card_state(cuda, fit, rule, d, n)
    assert pso_step._cluster(n, d, bn, cuda) > 1
    kw = dict(seed=s.seed, iteration=37, block_n=bn)
    want = pso_step.queue_plain(*state, spec, **kw)
    got = pso_step.queue_step(*[x.clone() for x in state], spec, **kw)
    torch.cuda.synchronize()
    for a, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, w, rtol=2e-6, atol=1e-5)
    scale = max(1.0, float(want[3].abs().max()))   # aux_fit may be -inf
    for a, w in (got[3], want[3]), (got[4], want[4]):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5 * scale)
    assert torch.equal(got[5], want[5])


@pytest.mark.gpu
@pytest.mark.parametrize("fit,d,n", [("rastrigin", 120, 1024),
                                     ("rosenbrock", 37, 128),
                                     ("cubic", 120, 32768)])
def test_cluster_queue_step_iterated_equals_fused_kernel_on_card(cuda, fit,
                                                                 d, n):
    """On clusters too, k queue steps and one fused launch of k iterations
    agree bit for bit: the same cluster size, so the same sum order."""
    cfg, _, _, s0 = _card_state(cuda, fit, "pso", d, n)
    bn = ops._resolve_block(n, None)
    assert pso_step._cluster(n, d, bn, cuda) > 1
    s = s0
    for _ in range(4):
        s = ops.queue_step(cfg, s)
    fused = ops.run_queue_lock_fused(cfg, s0, 4)
    torch.cuda.synchronize()
    for f in FIELDS:
        assert torch.equal(getattr(s, f), getattr(fused, f)), f


@pytest.mark.gpu
def test_queue_kernel_d1_exact_on_card(cuda):
    """At d = 1 (no cluster) the queue kernel rounds as its plain version:
    every output equal."""
    _, spec, state, s = _card_state(cuda, "cubic", "pso", 1, 131072)
    kw = dict(seed=s.seed, iteration=37, block_n=512)
    want = pso_step.queue_plain(*state, spec, **kw)
    got = pso_step.queue_step(*[x.clone() for x in state], spec, **kw)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert torch.equal(a, w)
