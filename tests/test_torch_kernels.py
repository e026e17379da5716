"""repro_torch.kernels against repro.kernels on the CPU, plus the CUDA
kernels against their plain versions on a card (``gpu``-marked; they skip
inside the test when there is none).

On the CPU the port's wrappers run the kernels' plain versions; the JAX
kernels run in Pallas interpret mode or through the ``ref.py`` oracles.
Tolerances, after each step from a shared state: positions, velocities
and pbest positions within rtol=2e-6 and atol=max(1e-5, 1e-6 * box width),
fitness within rtol=1e-5 and atol=1e-5 * max|fit|. XLA:CPU contracts the
velocity chain (and the SSO rule's ``lo + (hi - lo) * r2``) into FMAs whose
terms are of the order of the box, so a result near zero may differ by an
ulp of the box width (1.2e-4 at griewank's 1200); an objective sums terms
up to the swarm's largest fitness in another order, and where they cancel
the difference is an ulp of those terms. Improvement masks and winners must
be equal. The fused kernel's multi-block semantics are synchronous PPSO,
so with several blocks it is held against ``ref.queue_step_oracle``
iterated; with one block against ``ops.run_queue_lock_fused`` itself."""
import numpy as np
import pytest
import torch

from repro_torch.core import multi_swarm as ms
from repro_torch.core import pso
from repro_torch.kernels import ops, pso_step

try:
    from repro.core import multi_swarm as jms
    from repro.core import pso as jpso
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ModuleNotFoundError:     # a CUDA host may have no JAX installed
    jms = jpso = jops = jref = None

torch.set_num_threads(1)

FIT_TOL = dict(rtol=1e-5, atol=1e-5)
FITNESS = ("cubic", "sphere", "rosenbrock", "griewank", "rastrigin", "ackley")


@pytest.fixture
def cuda():
    """The card, decided inside the test so every worker collects alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100 with "
                    "`python -m pytest -m gpu tests/test_torch_kernels.py`")
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


def _dmajor(js):
    """A JAX state's fields as the port's D-major kernel operands."""
    return ops.state_to_kernel(pso.state_from_numpy(_np(js), device="cpu"))


def _pos_tol(spec):
    width = max(np.max(np.subtract(spec.hi, spec.lo)), 1.0)
    return dict(rtol=2e-6, atol=max(1e-5, 1e-6 * width))


def _assert_dmajor_close(got, pos, vel, pbp, pbf, gp, gf, spec):
    for a, b in ((got[0], pos), (got[1], vel), (got[2], pbp), (got[4], gp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape),
                                   **_pos_tol(spec))
    scale = max(1.0, float(np.max(np.abs(np.asarray(pbf)))))
    for a, b in ((got[3], pbf), (got[5], gf)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape),
                                   rtol=1e-5, atol=1e-5 * scale)


def _assert_same_improvements(got_pbf, want_pbf, old_pbf):
    """The pbest improvement masks agree wherever the new fitness is not
    tied with the old pbest at the fitness tolerance: a particle that lands
    on its pbest again (SSO copies it) re-evaluates the same point, and an
    ulp of the objective's rounding decides that tie."""
    got, want = got_pbf > old_pbf, want_pbf > old_pbf
    scale = 1e-5 * max(1.0, float(np.max(np.abs(old_pbf))))
    clear = np.abs(np.maximum(got_pbf, want_pbf) - old_pbf) > scale
    assert np.array_equal(got[clear], want[clear])


def _oracle_kw(cfg, d):
    kw = jops._cfg_kwargs(cfg)
    kw["d_real"] = d
    return kw


_SINGLE = [(f, r, *((128, 1), (256, 3), (128, 8))[i % 3])
           for i, (f, r) in enumerate(
               (f, r) for f in FITNESS for r in ("pso", "sso", "lowcost"))]


@pytest.mark.parametrize("fit,rule,n,d", _SINGLE)
def test_fused_plain_single_block_matches_pallas_kernel(fit, rule, n, d,
                                                        reference):
    jc, tc = _cfgs(fit, rule, d, n)
    spec = ops.kernel_spec(tc)
    js = jpso.init_swarm(jc, 3)
    for _ in range(3):                        # step by step from shared state
        want = jops.run_queue_lock_fused(jc, js, 1, block_n=n, interpret=True)
        s = pso.state_from_numpy(_np(js), device="cpu")
        got = pso_step.fused_plain(*ops.state_to_kernel(s), spec,
                                   seed=s.seed, iteration=s.iteration,
                                   iters=1, block_n=n)
        _assert_dmajor_close(got, want.pos.T, want.vel.T, want.pbest_pos.T,
                             want.pbest_fit, want.gbest_pos, want.gbest_fit,
                             spec)
        _assert_same_improvements(got[3].numpy(), np.asarray(want.pbest_fit),
                                  np.asarray(js.pbest_fit))
        js = want


@pytest.mark.parametrize("fit,rule", [("cubic", "pso"), ("rastrigin", "sso"),
                                      ("ackley", "lowcost")])
def test_fused_plain_multi_block_is_queue_step_iterated(fit, rule, reference):
    d, n, bn = 3, 256, 128
    jc, tc = _cfgs(fit, rule, d, n)
    spec = ops.kernel_spec(tc)
    js = jpso.init_swarm(jc, 8)
    s = pso.state_from_numpy(_np(js), device="cpu")
    state = ops.state_to_kernel(s)
    kw = _oracle_kw(jc, d)
    fitness = kw.pop("fitness")
    for t in range(3):
        pos, vel, pbp, pbf, gp, gf = (x.numpy() for x in state)
        want = jref.queue_step_oracle(
            s.seed, t, pos, vel, pbp, pbf[None, :], gp[:, None], float(gf[0]),
            bn, fitness=fitness, **kw)
        state = pso_step.fused_plain(*state, spec, seed=s.seed, iteration=t,
                                     iters=1, block_n=bn)
        _assert_dmajor_close(state, *want[:6], spec)
        # the published winner: the oracle's cross-block argmax
        aux_fit, aux_idx = np.asarray(want[6]), np.asarray(want[7])
        wb = int(np.argmax(aux_fit))
        if aux_fit[wb] > gf[0]:
            assert np.array_equal(state[4].numpy(),
                                  state[0].numpy()[:, aux_idx[wb]])


@pytest.mark.parametrize("fit,rule,sync_every,iters",
                         [("cubic", "pso", 4, 6), ("griewank", "sso", 3, 7),
                          ("sphere", "lowcost", 1, 5)])
def test_fused_async_plain_single_block_matches_pallas_kernel(
        fit, rule, sync_every, iters, reference):
    d, n = 3, 128
    jc, tc = _cfgs(fit, rule, d, n)
    js = jpso.init_swarm(jc, 6)
    want = jops.run_queue_lock_fused_async(jc, js, iters,
                                           sync_every=sync_every, block_n=n,
                                           interpret=True)
    state = _dmajor(js)
    lp, lf = state[4][:, None].clone(), state[5].clone()
    got = pso_step.fused_async_plain(
        *state, lp, lf, ops.kernel_spec(tc), seed=int(js.seed), iteration=0,
        iters=iters, sync_every=sync_every, block_n=n)
    spec = ops.kernel_spec(tc)
    _assert_dmajor_close(got, want.pos.T, want.vel.T, want.pbest_pos.T,
                         want.pbest_fit, want.gbest_pos, want.gbest_fit, spec)
    np.testing.assert_allclose(got[6].numpy(), np.asarray(want.lbest_pos).T,
                               **_pos_tol(spec))
    # one block: the async kernel equals the fused one for any sync_every
    fused = pso_step.fused_plain(*state, ops.kernel_spec(tc),
                                 seed=int(js.seed), iteration=0, iters=iters,
                                 block_n=n)
    for a, b in zip(got[:6], fused):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fit,sync_every,iters", [("cubic", 4, 10),
                                                  ("rastrigin", 3, 8)])
def test_fused_async_plain_two_blocks_matches_oracle(fit, sync_every, iters,
                                                   reference):
    d, n, bn = 2, 256, 128
    jc, tc = _cfgs(fit, "pso", d, n)
    js = jpso.init_swarm(jc, 12)
    state = _dmajor(js)
    pos, vel, pbp, pbf, gp, gf = (x.numpy() for x in state)
    kw = _oracle_kw(jc, d)
    fitness = kw.pop("fitness")
    want = jref.run_fused_async_oracle(
        int(js.seed), 0, pos, vel, pbp, pbf[None, :], gp[:, None],
        float(gf[0]), iters, bn, sync_every, fitness=fitness, **kw)
    lp, lf = state[4][:, None].repeat(1, 2), state[5].repeat(2)
    got = pso_step.fused_async_plain(
        *state, lp, lf, ops.kernel_spec(tc), seed=int(js.seed), iteration=0,
        iters=iters, sync_every=sync_every, block_n=bn)
    spec = ops.kernel_spec(tc)
    _assert_dmajor_close(got, *want[:6], spec)
    np.testing.assert_allclose(got[6].numpy(), np.asarray(want[6]),
                               **_pos_tol(spec))
    np.testing.assert_allclose(got[7].numpy(), np.asarray(want[7]), **FIT_TOL)


def test_ops_async_resumes_carried_locals():
    """Two calls that carry the block-local bests equal one call when the
    split lands on a sync point (the reference's checkpoint contract)."""
    tc = pso.PSOConfig(dim=2, particle_cnt=256).resolved()
    s = pso.init_swarm(tc, 4, device="cpu")
    one = ops.run_queue_lock_fused_async(tc, s, 8, sync_every=4, block_n=64)
    two = ops.run_queue_lock_fused_async(tc, s, 4, sync_every=4, block_n=64)
    two = ops.run_queue_lock_fused_async(tc, two, 4, sync_every=4,
                                         block_n=64)
    for f in ("pos", "vel", "pbest_pos", "pbest_fit", "gbest_pos",
              "gbest_fit", "lbest_pos", "lbest_fit"):
        assert torch.equal(getattr(one, f), getattr(two, f)), f
    assert two.iteration == 8


def test_async_spans_match_reference(reference):
    for iters, se in [(0, 8), (53, 8), (8, 8), (5, 8), (7, 0), (16, 3)]:
        assert ops._async_spans(iters, se) == jops._async_spans(iters, se)


def test_pack_unpack_round_trip():
    x = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    p = ops.pack_dmajor(x)
    assert p.shape == (4, 6) and p.is_contiguous()
    assert torch.equal(ops.unpack_dmajor(p), x)
    p[0, 0] = -1.0                         # a new tensor, never a view
    assert x[0, 0] == 0.0
    one = torch.arange(5, dtype=torch.float32)[:, None]     # D == 1
    q = ops.pack_dmajor(one)
    q[0, 0] = 9.0
    assert one[0, 0] == 0.0


def test_resolve_block_errors():
    assert ops._resolve_block(1024, None) == 512
    assert ops._resolve_block(96, 32) == 32
    for bad in (100, -4):
        with pytest.raises(ValueError, match="divisor"):
            ops._resolve_block(1024, bad)


# A card's capacity for clusters of C CTAs of 512 threads, two CTAs an SM
# on 132 SMs (the fixture of the cluster-size tests; the wrappers query
# the card's own), and its capacity for single CTAs.
_CAPACITY = {2: 132, 4: 66, 8: 33}.get


def _resident(c):
    return 264 if c == 1 else _CAPACITY(c)


_CLUSTER_RULE_CASES = [
    (32768, 120, 512, 4),     # 64 blocks: 64 clusters of 8 do not fit
    (8192, 120, 512, 8), (1024, 120, 512, 8), (128, 120, 128, 8),
    (1024, 37, 512, 2),       # slices of 18 and 19 dimensions
    (1024, 48, 512, 4), (1024, 24, 512, 2), (1024, 23, 512, 1),
    (1024, 10, 512, 1), (131072, 120, 512, 1),   # 256 blocks: no cluster
    (1024, 120, 1024, 1),     # a cluster takes one particle a thread
]


@pytest.mark.parametrize("n,d,bn,want", _CLUSTER_RULE_CASES)
def test_cluster_size_follows_the_shape(n, d, bn, want):
    """The rule: the largest C of 2, 4, 8 that leaves each CTA at least
    MIN_SLICE dimensions and lets all of a swarm's clusters be resident;
    the same answer every time it is asked."""
    got = [pso_step.cluster_size(n, d, bn, _CAPACITY) for _ in range(3)]
    assert got == [want] * 3


@pytest.mark.parametrize("n,bn", [(32, 32), (131072, 512), (1024, 1024),
                                  (128, 128), (1009, 1009)])
def test_cluster_size_is_one_at_d1(n, bn):
    """At d = 1 the kernels run without a cluster, so the d = 1 cells run
    the arithmetic of one CTA a block."""
    assert pso_step.cluster_size(n, 1, bn, _CAPACITY) == 1
    assert pso_step.launch_plan(n, 1, bn, 7, _CAPACITY, _resident)[0] == 1


@pytest.mark.parametrize("n,d,bn", [(1024, 120, 512), (32768, 120, 512),
                                    (128, 120, 128), (1024, 10, 512)])
def test_launch_plan_cluster_independent_of_swarm_count(n, d, bn):
    """A batch of S swarms takes the single swarm's cluster size for every
    S (its rows then sum their objectives in the single swarm's order);
    only the swarms a cooperative wave holds depend on the card."""
    plans = {s: pso_step.launch_plan(n, d, bn, s, _CAPACITY, _resident)
             for s in (1, 4, 128, 300, 1024)}
    assert {c for c, _ in plans.values()} == {
        pso_step.cluster_size(n, d, bn, _CAPACITY)}
    c = plans[1][0]
    nb = n // bn
    for s, (_, wave) in plans.items():
        assert wave == (s if nb == 1 else _resident(c) // nb)


def test_launch_plan_raises_when_a_swarm_cannot_be_resident():
    with pytest.raises(RuntimeError, match="resident"):
        pso_step.launch_plan(131072, 1, 256, 1, _CAPACITY, _resident)


@pytest.mark.parametrize("n,d,bn,want", _CLUSTER_RULE_CASES)
def test_async_cluster_is_the_fused_kernels(n, d, bn, want):
    """The async kernel runs each block on the fused kernel's cluster size
    at every shape: with one block the two must agree bit for bit, which
    only the same order of the partial sums gives."""
    c, ctas = pso_step.async_plan(n, d, bn, 1, _CAPACITY)
    assert c == want == pso_step.launch_plan(n, d, bn, 1, _CAPACITY,
                                             _resident)[0]
    assert ctas == (n // bn) * c
    assert pso_step.async_plan(n, d, bn, 1, _CAPACITY, cluster=2)[0] == 2


@pytest.mark.parametrize("n,d,bn", [(1024, 120, 512), (32768, 120, 512),
                                    (128, 120, 128), (1024, 24, 512),
                                    (1024, 10, 512)])
def test_async_plan_cluster_independent_of_swarm_count(n, d, bn):
    """A batch's rows take the single swarm's cluster size for every S, so
    a row sums its objective in the single swarm's order; the one normal
    launch grows with S."""
    c = pso_step.cluster_size(n, d, bn, _CAPACITY)
    for s in (1, 4, 6, 128, 300, 1024):
        assert pso_step.async_plan(n, d, bn, s, _CAPACITY) == (
            c, s * (n // bn) * c)


def test_async_plan_raises_beyond_the_grid():
    with pytest.raises(ValueError, match="2\\^31"):
        pso_step.async_plan(2 ** 20, 1, 1, 2 ** 11, _CAPACITY)


def test_kernel_path_on_cpu_tensors_raises():
    tc = pso.PSOConfig(dim=2, particle_cnt=128).resolved()
    s = pso.init_swarm(tc, 0, device="cpu")
    state = ops.state_to_kernel(s)
    spec = ops.kernel_spec(tc)
    with pytest.raises(ValueError, match="CUDA"):
        pso_step._fused_launch(state, spec, seed=0, iteration=0, iters=1,
                               block_n=128)
    lp, lf = state[4][:, None].clone(), state[5].clone()
    for cluster in (None, 2):
        with pytest.raises(ValueError, match="CUDA"):
            pso_step._fused_async_launch(state + (lp, lf), spec, seed=0,
                                         iteration=0, iters=1, sync_every=1,
                                         block_n=128, cluster=cluster)
    # the CPU wrappers ran no kernel
    before = (pso_step.fused.launches, pso_step.fused_async.launches)
    ops.run_queue_lock_fused(tc, s, 2)
    ops.run_queue_lock_fused_async(tc, s, 2)
    assert (pso_step.fused.launches, pso_step.fused_async.launches) == before


@pytest.mark.parametrize("cluster", [None, 2, 8])
def test_async_wrappers_on_cpu_tensors_run_the_plain_version(cluster):
    """``cluster=`` chooses the kernel's cluster size; on CPU tensors the
    wrappers run the plain versions, which know nothing of clusters, and
    launch nothing."""
    tc = pso.PSOConfig(dim=24, particle_cnt=256, fitness="rastrigin")
    tc = tc.resolved()
    state = _with_locals(ops.state_to_kernel(pso.init_swarm(tc, 3,
                                                            device="cpu")), 2)
    spec = ops.kernel_spec(tc)
    kw = dict(seed=3, iteration=4, iters=5, sync_every=2, block_n=128)
    want = pso_step.fused_async_plain(*state, spec, **kw)
    before = pso_step.fused_async.launches
    got = pso_step.fused_async(*[x.clone() for x in state], spec,
                               cluster=cluster, **kw)
    assert pso_step.fused_async.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    b = ms.init_batch(tc, BATCH_SEEDS[:3], device="cpu")
    bstate = [ops.pack_dmajor_batch(b.pos), ops.pack_dmajor_batch(b.vel),
              ops.pack_dmajor_batch(b.pbest_pos), b.pbest_fit.reshape(-1),
              ops.pack_dmajor(b.gbest_pos), b.gbest_fit.clone()]
    bstate += [bstate[4].repeat_interleave(2, 1),
               bstate[5].repeat_interleave(2)]
    bkw = dict(iters=5, sync_every=2, block_n=128)
    want = pso_step.fused_async_batch_plain(*bstate, b.seed, b.iteration,
                                            (spec,), **bkw)
    got = pso_step.fused_async_batch(*[x.clone() for x in bstate], b.seed,
                                     b.iteration, (spec,), cluster=cluster,
                                     **bkw)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_kernel_spec_rejects_custom_objective_and_dtype():
    # a custom objective is no built-in kernel's: its spec routes it to the
    # split path (kernels/pso_split.py) instead of raising
    mine = pso.Problem(name="mine", fn=lambda x: -x.sum(-1))
    cfg = pso.PSOConfig(dim=2, particle_cnt=64, fitness=mine)
    assert ops.kernel_spec(cfg).fitness == ops.CONVERTED
    assert ops.kernel_spec(pso.PSOConfig(dim=2, particle_cnt=64,
                                         fitness="sphere")).fitness == 1
    with pytest.raises(ValueError, match="float32"):
        ops.kernel_spec(pso.PSOConfig(dim=2, particle_cnt=64,
                                      dtype="float64"))


# --- batched plain versions against the batched Pallas kernels --------------

BATCH_SEEDS = [0, 1, 7, 42, 99, 123, 100000, 2 ** 31 - 5]
MIXED = ["cubic", "sphere", "rosenbrock", "griewank", "rastrigin", "ackley",
         "cubic", "ackley"]


def _batches(hetero, d, n, rule="pso"):
    """The same 8-swarm batch for the reference and the port, at per-row
    iterations 0, 3, 6, ..., with the port's kernel table and fids."""
    fit = None if hetero else "rastrigin"
    jc, tc = (m.PSOConfig(dim=d, particle_cnt=n, update_rule=rule,
                          **({} if fit is None else dict(fitness=fit)))
              .resolved() for m in (jpso, pso))
    if hetero:
        jr, jt = jms.problem_rows(MIXED, d)
        tr, tt = ms.problem_rows(MIXED, d, device="cpu")
        jb = jms.init_batch(jc, BATCH_SEEDS, rows=jr, table=jt)
        jkw = dict(fids=jr.fid, table=jt)
        tkw = dict(fids=tr.fid, table=tt)
        widths = (tr.hi - tr.lo).amax(1).tolist()
    else:
        jb = jms.init_batch(jc, BATCH_SEEDS)
        jkw, tkw = {}, {}
        widths = [tc.max_pos - tc.min_pos] * 8
    jb = jb._replace(iteration=jb.iteration + 3 * np.arange(8, dtype=np.int32))
    return jc, tc, jb, jkw, tkw, widths


def _port_batch(jb):
    out = {k: None if getattr(jb, k) is None
           else torch.as_tensor(np.array(getattr(jb, k))) for k in jb._fields}
    out["iteration"] = out["iteration"].to(torch.int64)
    out["seed"] = torch.as_tensor(np.asarray(jb.seed).astype(np.int64))
    return ms.SwarmBatch(**out)


def _assert_rows_close(got, want, widths):
    for f in ("pos", "vel", "pbest_pos", "gbest_pos", "lbest_pos"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        for s, wd in enumerate(widths if a is not None else ()):
            np.testing.assert_allclose(a[s].numpy(), np.asarray(b[s]),
                                       rtol=2e-6, atol=max(1e-5, 1e-6 * wd),
                                       err_msg=f"{f}[{s}]")
    scale = max(1.0, float(np.max(np.abs(np.asarray(want.pbest_fit)))))
    for f in ("pbest_fit", "gbest_fit", "lbest_fit"):
        a, b = getattr(got, f), getattr(want, f)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=f)
    assert got.iteration.tolist() == np.asarray(want.iteration).tolist()


@pytest.mark.parametrize("hetero,rule", [(False, "pso"), (True, "sso")])
def test_fused_batch_plain_single_block_matches_pallas_kernel(hetero, rule,
                                                              reference):
    """One block a swarm: the plain batch against the batched (and
    hetero) Pallas kernel, step by step from the shared batch."""
    jc, tc, jb, jkw, tkw, widths = _batches(hetero, 3, 128, rule)
    for _ in range(2):
        tb = _port_batch(jb)
        want = jops.run_queue_lock_fused_batch(jc, jb, 1, block_n=128,
                                               interpret=True, **jkw)
        got = ops.run_queue_lock_fused_batch(tc, tb, 1, block_n=128, **tkw)
        _assert_rows_close(got, want, widths)
        _assert_same_improvements(got.pbest_fit.numpy(),
                                  np.asarray(want.pbest_fit),
                                  np.asarray(jb.pbest_fit))
        jb = want


@pytest.mark.parametrize("hetero", [False, True])
def test_fused_batch_plain_multi_block_rows_are_fused_plain(hetero,
                                                           reference):
    """Several blocks a swarm: row s of the plain batch is the port's
    single-swarm ``fused_plain`` (synchronous PPSO) on that swarm, from its
    own iteration, bit for bit."""
    _, tc, jb, _, tkw, _ = _batches(hetero, 3, 256)
    tb = _port_batch(jb)
    out = ops.run_queue_lock_fused_batch(tc, tb, 3, block_n=64, **tkw)
    table = tkw.get("table")
    for s in range(8):
        cfg = (tc if table is None else
               pso.hetero_member_config(tc, table[int(tkw["fids"][s])]))
        want = ops.run_queue_lock_fused(cfg, ms.batch_row(tb, s), 3,
                                        block_n=64)
        row = ms.batch_row(out, s)
        for f in ("pos", "vel", "pbest_pos", "pbest_fit", "gbest_pos",
                  "gbest_fit"):
            assert torch.equal(getattr(row, f), getattr(want, f)), (s, f)
        assert row.iteration == want.iteration


@pytest.mark.parametrize("hetero,nb", [(False, 1), (False, 2), (True, 1),
                                       (True, 2)])
def test_fused_async_batch_plain_matches_pallas_kernel(hetero, nb,
                                                       reference):
    """The plain async batch against the batched (and hetero) Pallas async
    kernel, block-major like ``ref.run_fused_async_oracle``: 5 iterations
    at sync_every=2 (two chunks and a remainder launch), rows resuming at
    different iterations, from locals seeded by each gbest."""
    jc, tc, jb, jkw, tkw, widths = _batches(hetero, 2, 256)
    tb = _port_batch(jb)
    want = jops.run_queue_lock_fused_async_batch(
        jc, jb, 5, sync_every=2, block_n=256 // nb, interpret=True, **jkw)
    got = ops.run_queue_lock_fused_async_batch(tc, tb, 5, sync_every=2,
                                               block_n=256 // nb, **tkw)
    _assert_rows_close(got, want, widths)
    assert got.lbest_fit.shape == (8, nb)


def test_batch_kernel_path_on_cpu_tensors_raises():
    tc = pso.PSOConfig(dim=2, particle_cnt=128).resolved()
    b = ms.init_batch(tc, BATCH_SEEDS, device="cpu")
    state = [ops.pack_dmajor_batch(b.pos), ops.pack_dmajor_batch(b.vel),
             ops.pack_dmajor_batch(b.pbest_pos), b.pbest_fit.reshape(-1),
             ops.pack_dmajor(b.gbest_pos), b.gbest_fit.clone()]
    specs = (ops.kernel_spec(tc),)
    with pytest.raises(ValueError, match="CUDA"):
        pso_step._fused_batch_launch(state, b.seed, b.iteration, specs,
                                     iters=1, block_n=128)
    lp, lf = state[4].clone(), state[5].clone()
    with pytest.raises(ValueError, match="CUDA"):
        pso_step._fused_async_batch_launch(state + [lp, lf], b.seed,
                                           b.iteration, specs, iters=1,
                                           sync_every=1, block_n=128)
    before = (pso_step.fused_batch.launches,
              pso_step.fused_async_batch.launches)
    ops.run_queue_lock_fused_batch(tc, b, 2)
    ops.run_queue_lock_fused_async_batch(tc, b, 2)
    assert (pso_step.fused_batch.launches,
            pso_step.fused_async_batch.launches) == before
    with pytest.raises(ValueError, match="table"):
        ops.run_queue_lock_fused_batch(tc, b, 1, fids=torch.zeros(8))


def test_pack_unpack_batch_round_trip():
    x = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    p = ops.pack_dmajor_batch(x)
    assert p.shape == (4, 6) and p.is_contiguous()
    assert torch.equal(p[:, 3:6], x[1].t())         # swarm 1's columns
    assert torch.equal(ops.unpack_dmajor_batch(p, 2), x)


# --- on the card -------------------------------------------------------------

def _card_state(cuda, fit, rule, d, n, seed=1):
    cfg = pso.PSOConfig(dim=d, particle_cnt=n, fitness=fit,
                        update_rule=rule).resolved()
    s = pso.init_swarm(cfg, seed, device=cuda)
    return cfg, ops.kernel_spec(cfg), ops.state_to_kernel(s), s.seed


@pytest.mark.gpu
@pytest.mark.parametrize("fit,rule,d,n,bn", [
    ("cubic", "pso", 1, 8192, 512), ("rastrigin", "sso", 5, 2048, 256),
    ("griewank", "lowcost", 3, 1024, 1024), ("rosenbrock", "pso", 4, 1009,
                                              1009)])
def test_fused_kernel_matches_plain_on_card(cuda, fit, rule, d, n, bn):
    _, spec, state, seed = _card_state(cuda, fit, rule, d, n)
    want = pso_step.fused_plain(*state, spec, seed=seed, iteration=0,
                                iters=1, block_n=bn)
    got = pso_step.fused(*[x.clone() for x in state], spec, seed=seed,
                         iteration=0, iters=1, block_n=bn)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["pso", "sso", "lowcost"])
def test_fused_kernel_multi_iteration_matches_plain_on_card(cuda, rule):
    """One launch of six iterations over 256 CTAs from a nonzero iteration:
    both key and candidate slots, and each slot's reuse two iterations on,
    held against the plain version. At D = 1 the two round alike, so no
    comparison can flip and the trajectories must agree throughout."""
    _, spec, state, seed = _card_state(cuda, "cubic", rule, 1, 131072)
    kw = dict(seed=seed, iteration=37, iters=6, block_n=512)
    want = pso_step.fused_plain(*state, spec, **kw)
    got = pso_step.fused(*[x.clone() for x in state], spec, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_async_kernel_single_block_matches_plain_on_card(cuda):
    _, spec, state, seed = _card_state(cuda, "ackley", "pso", 8, 512)
    lp, lf = state[4][:, None].clone(), state[5].clone()
    args = (spec,)
    kw = dict(seed=seed, iteration=0, iters=21, sync_every=8, block_n=512)
    want = pso_step.fused_async_plain(*state, lp, lf, *args, **kw)
    got = pso_step.fused_async(*[x.clone() for x in state + (lp, lf)],
                               *args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _assert_async_invariants(cfg, spec, state, seed, iters, sync_every):
    """Three launches of the multi-block async kernel, whose publication
    order is a race: gbest monotone, gbest == max(pbest), gbest_pos bit for
    bit the pbest position of a particle of fitness gbest (a torn copy of
    two winners matches none), the fitness at gbest_pos equal to gbest
    (exactly at D = 1; at D > 1 torch sums in another order, so at the
    fitness tolerance), positions inside the bounds."""
    d = state[0].shape[0]
    prev = float(state[5][0])
    for launch in range(3):
        pso_step.fused_async(*state, spec, seed=seed,
                             iteration=iters * launch, iters=iters,
                             sync_every=sync_every, block_n=512)
        torch.cuda.synchronize()
        pos, _, pbp, pbf, gp, gf = state[:6]
        assert float(gf[0]) >= prev
        prev = float(gf[0])
        assert float(gf[0]) == float(pbf.max())
        cols = pbp[:, pbf == gf]
        assert bool((cols == gp[:, None]).all(0).any())
        refit = cfg.fitness_fn(gp[None, :])
        if d == 1:
            assert float(refit[0]) == float(gf[0])
        else:
            torch.testing.assert_close(refit, gf, rtol=1e-5,
                                       atol=1e-5 * max(1.0, abs(prev)))
        lo, hi, _ = pso_step._operands(spec, pos.device)
        assert bool(((pos >= lo) & (pos <= hi)).all())


def _with_locals(state, nb):
    return state + (state[4][:, None].repeat(1, nb).contiguous(),
                    state[5].repeat(nb))


@pytest.mark.gpu
def test_async_kernel_multi_block_invariants_on_card(cuda):
    cfg, spec, state, seed = _card_state(cuda, "cubic", "pso", 1, 65536)
    _assert_async_invariants(cfg, spec, _with_locals(state, 128), seed,
                             iters=8, sync_every=1)


@pytest.mark.gpu
@pytest.mark.parametrize("sync_every", [1, 8])
def test_async_kernel_multi_block_invariants_wide_on_card(cuda, sync_every):
    """At D > 1 the shared gbest is many floats under the lock; rastrigin
    does not run to the bounds, so a torn gbest_pos is no corner of the
    box and shows."""
    cfg, spec, state, seed = _card_state(cuda, "rastrigin", "pso", 24,
                                         16384)
    _assert_async_invariants(cfg, spec, _with_locals(state, 32), seed,
                             iters=8, sync_every=sync_every)


# --- batched kernels on the card ---------------------------------------------


def _card_batch(cuda, fit, rule, d, n, s_cnt, problems=None):
    """A batch on the card at per-row iterations 0, 3, 6, ... (serving
    lanes admit rows at different iterations), with its kernel table."""
    seeds = [BATCH_SEEDS[s % 8] + s for s in range(s_cnt)]
    if problems is None:
        cfg = pso.PSOConfig(dim=d, particle_cnt=n, fitness=fit,
                            update_rule=rule).resolved()
        b = ms.init_batch(cfg, seeds, device=cuda)
        fids, specs = None, (ops.kernel_spec(cfg),)
    else:
        cfg = pso.PSOConfig(dim=d, particle_cnt=n,
                            update_rule=rule).resolved()
        rows, table = ms.problem_rows(problems, d, device=cuda)
        b = ms.init_batch(cfg, seeds, rows=rows, table=table, device=cuda)
        fids, specs = rows.fid, ops._hetero_members(cfg, table)
    b = b._replace(iteration=3 * torch.arange(s_cnt, device=cuda))
    return cfg, b, fids, specs


def _batch_ops(b, nb=None):
    out = [ops.pack_dmajor_batch(b.pos), ops.pack_dmajor_batch(b.vel),
           ops.pack_dmajor_batch(b.pbest_pos), b.pbest_fit.reshape(-1).clone(),
           ops.pack_dmajor(b.gbest_pos), b.gbest_fit.clone()]
    if nb:
        out += [out[4].repeat_interleave(nb, 1), out[5].repeat_interleave(nb)]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("fit,rule,d,n,bn,s_cnt,hetero", [
    ("cubic", "pso", 1, 1024, 512, 8, False),
    ("rastrigin", "sso", 3, 1024, 512, 5, False),
    ("griewank", "lowcost", 10, 256, 256, 64, False),
    (None, "pso", 10, 1024, 512, 12, True),
    (None, "lowcost", 3, 256, 256, 12, True)])
def test_fused_batch_kernel_matches_plain_on_card(cuda, fit, rule, d, n, bn,
                                                  s_cnt, hetero):
    problems = [FITNESS[s % 6] for s in range(s_cnt)] if hetero else None
    _, b, fids, specs = _card_batch(cuda, fit, rule, d, n, s_cnt, problems)
    state = _batch_ops(b)
    kw = dict(iters=2, block_n=bn, fids=fids)
    want = pso_step.fused_batch_plain(*state, b.seed, b.iteration, specs,
                                      **kw)
    got = pso_step.fused_batch(*[x.clone() for x in state], b.seed,
                               b.iteration, specs, **kw)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("s_cnt", [5, 300])
def test_fused_batch_rows_equal_single_swarm_kernel_on_card(cuda, s_cnt):
    """Row s of a batched launch is the single-swarm kernel on swarm s, bit
    for bit. At S=300 with two blocks a swarm the batch runs in waves (600
    CTAs where about 264 fit at once), the last one partial."""
    _, b, _, specs = _card_batch(cuda, "rastrigin", "pso", 10, 1024, s_cnt)
    orig = _batch_ops(b)
    state = [x.clone() for x in orig]
    before = pso_step.fused_batch.launches
    pso_step.fused_batch(*state, b.seed, b.iteration, specs, iters=5,
                         block_n=512)
    waves = pso_step.fused_batch.launches - before
    assert waves == 1 if s_cnt == 5 else waves >= 2
    seeds, its = b.seed.tolist(), b.iteration.tolist()
    for s in range(s_cnt):
        c = slice(s * 1024, (s + 1) * 1024)
        one = [x[:, c].contiguous() for x in orig[:3]] + [
            orig[3][c].clone(), orig[4][:, s].contiguous(),
            orig[5][s:s + 1].clone()]
        pso_step.fused(*one, specs[0], seed=seeds[s], iteration=its[s],
                       iters=5, block_n=512)
        for a, w in zip(one, (state[0][:, c], state[1][:, c],
                              state[2][:, c], state[3][c], state[4][:, s],
                              state[5][s:s + 1])):
            assert torch.equal(a, w), s


@pytest.mark.gpu
@pytest.mark.parametrize("hetero", [False, True])
def test_async_batch_kernel_single_block_matches_plain_on_card(cuda, hetero):
    problems = [FITNESS[s % 6] for s in range(12)] if hetero else None
    _, b, fids, specs = _card_batch(cuda, "ackley", "pso", 8, 512, 12,
                                    problems)
    state = _batch_ops(b, nb=1)
    kw = dict(iters=11, sync_every=4, block_n=512, fids=fids)
    want = pso_step.fused_async_batch_plain(*state, b.seed, b.iteration,
                                            specs, **kw)
    got = pso_step.fused_async_batch(*[x.clone() for x in state], b.seed,
                                     b.iteration, specs, **kw)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("hetero", [False, True])
def test_async_batch_kernel_multi_block_invariants_on_card(cuda, hetero):
    """Each swarm of a multi-block async batch holds the single-swarm
    invariants: gbest == max(pbest), gbest_pos bit for bit a pbest column,
    positions in its bounds."""
    problems = [FITNESS[s % 6] for s in range(12)] if hetero else None
    cfg, b, fids, specs = _card_batch(cuda, "rastrigin", "pso", 10, 2048, 12,
                                      problems)
    state = _batch_ops(b, nb=4)
    pso_step.fused_async_batch(*state, b.seed, b.iteration, specs, iters=16,
                               sync_every=4, block_n=512, fids=fids)
    torch.cuda.synchronize()
    for s in range(12):
        c = slice(s * 2048, (s + 1) * 2048)
        pos, pbp, pbf = state[0][:, c], state[2][:, c], state[3][c]
        gp, gf = state[4][:, s], state[5][s]
        assert float(gf) == float(pbf.max())
        assert bool((pbp[:, pbf == gf] == gp[:, None]).all(0).any())
        spec = specs[0 if fids is None else int(fids[s])]
        lo, hi, _ = pso_step._operands(spec, pos.device)
        assert bool(((pos >= lo) & (pos <= hi)).all())


# --- the queue and fused kernels on clusters, on the card -------------------

def _fit_close(a, b):
    torch.testing.assert_close(a, b, rtol=1e-5,
                               atol=1e-5 * max(1.0, float(b.abs().max())))


# Every objective with every rule, each at one of the four cluster shapes:
# d=120 (C=8 on an H100) and d=37 (C=2, slices of 18 and 19), one block
# (n=128) and two (n=1024).
_CLUSTER_SHAPES = ((120, 128, 128), (37, 1024, 512), (37, 128, 128),
                   (120, 1024, 512))
_CLUSTER_CASES = [(f, r) + _CLUSTER_SHAPES[i % 4] for i, (f, r) in enumerate(
    (f, r) for f in FITNESS for r in ("pso", "sso", "lowcost"))]


@pytest.mark.gpu
@pytest.mark.parametrize("fit,rule,d,n,bn", _CLUSTER_CASES)
def test_cluster_fused_kernel_matches_plain_on_card(cuda, fit, rule, d, n,
                                                    bn):
    """The fused kernel with a particle block split over a cluster, two
    iterations in one launch, against its plain version: positions to
    rounding, fitness to the objective's ulps (its sum runs in rank order);
    rosenbrock's pairs across slice boundaries included."""
    _, spec, state, seed = _card_state(cuda, fit, rule, d, n)
    assert pso_step._cluster(n, d, bn, cuda) > 1
    kw = dict(seed=seed, iteration=11, iters=2, block_n=bn)
    want = pso_step.fused_plain(*state, spec, **kw)
    got = pso_step.fused(*[x.clone() for x in state], spec, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("pos", "vel", "pbp", "pbf", "gp", "gf"), got,
                          want):
        if name in ("pbf", "gf"):
            _fit_close(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=2e-6, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("s_cnt,hetero", [(4, False), (6, True)])
def test_cluster_batch_rows_equal_single_swarm_kernel_on_card(cuda, s_cnt,
                                                              hetero):
    """At d=120 n=1024 (clusters of 8) every row of a batched launch is the
    single-swarm kernel on that swarm, bit for bit: the cluster size
    depends on the swarm's shape, not on S."""
    problems = [FITNESS[s % 6] for s in range(s_cnt)] if hetero else None
    _, b, fids, specs = _card_batch(cuda, "rastrigin", "pso", 120, 1024,
                                    s_cnt, problems)
    assert pso_step._cluster(1024, 120, 512, cuda) > 1
    orig = _batch_ops(b)
    state = [x.clone() for x in orig]
    pso_step.fused_batch(*state, b.seed, b.iteration, specs, iters=4,
                         block_n=512, fids=fids)
    members = [0] * s_cnt if fids is None else fids.tolist()
    seeds, its = b.seed.tolist(), b.iteration.tolist()
    for s in range(s_cnt):
        c = slice(s * 1024, (s + 1) * 1024)
        one = [x[:, c].contiguous() for x in orig[:3]] + [
            orig[3][c].clone(), orig[4][:, s].contiguous(),
            orig[5][s:s + 1].clone()]
        pso_step.fused(*one, specs[members[s]], seed=seeds[s],
                       iteration=its[s], iters=4, block_n=512)
        for a, w in zip(one, (state[0][:, c], state[1][:, c],
                              state[2][:, c], state[3][c], state[4][:, s],
                              state[5][s:s + 1])):
            assert torch.equal(a, w), s


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["pso", "sso", "lowcost"])
def test_fused_kernel_d1_exact_on_card(cuda, rule):
    """At d = 1 there is no cluster and kernel and plain round alike: six
    iterations over 256 CTAs agree with the plain version exactly."""
    _, spec, state, seed = _card_state(cuda, "cubic", rule, 1, 131072)
    assert pso_step._cluster(131072, 1, 512, cuda) == 1
    kw = dict(seed=seed, iteration=37, iters=6, block_n=512)
    want = pso_step.fused_plain(*state, spec, **kw)
    got = pso_step.fused(*[x.clone() for x in state], spec, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# --- the async kernel on clusters, on the card -------------------------------

_ONE_BLOCK_CASES = [(f, r) for f in FITNESS for r in ("pso", "sso", "lowcost")]


@pytest.mark.gpu
@pytest.mark.parametrize("fit,rule", _ONE_BLOCK_CASES)
def test_cluster_async_kernel_one_block_equals_fused_on_card(cuda, fit, rule):
    """One block of 128 particles at d=120 on clusters of 8: the async
    kernel equals the fused kernel bit for bit for any chunk length, here
    every iteration a boundary (sync_every=1) and two chunks plus an
    ``async_spans`` remainder (sync_every=2, two launches); its local best
    is gbest."""
    _, spec, state, seed = _card_state(cuda, fit, rule, 120, 128)
    assert pso_step._cluster(128, 120, 128, cuda) == 8
    kw = dict(seed=seed, iteration=5, iters=5, block_n=128)
    want = pso_step.fused(*[x.clone() for x in state], spec, **kw)
    for sync_every in (1, 2):
        got = pso_step.fused_async(*[x.clone() for x in
                                     _with_locals(state, 1)], spec,
                                   sync_every=sync_every, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), sync_every
        assert torch.equal(got[6][:, 0], got[4])
        assert torch.equal(got[7], got[5])


@pytest.mark.gpu
@pytest.mark.parametrize("n,c", [(32768, 2), (1024, 8)])
@pytest.mark.parametrize("fit", ["rastrigin", "cubic"])
def test_cluster_async_kernel_multi_block_invariants_on_card(cuda, n, c, fit):
    """Several blocks on clusters, a boundary every iteration: the
    cluster-wide seqlock holds every invariant (a torn or lost publish
    shows as a gbest_pos that is no pbest column)."""
    cfg, spec, state, seed = _card_state(cuda, fit, "pso", 120, n)
    assert pso_step._cluster(n, 120, 512, cuda) == c
    _assert_async_invariants(cfg, spec, _with_locals(state, n // 512), seed,
                             iters=8, sync_every=1)


@pytest.mark.gpu
@pytest.mark.parametrize("s_cnt,hetero", [(4, False), (6, True)])
def test_cluster_async_batch_rows_equal_single_swarm_kernel_on_card(
        cuda, s_cnt, hetero):
    """At d=120 n=512 (one block on a cluster of 8) every row of a batched
    async launch is the single-swarm async kernel on that swarm, bit for
    bit, across a remainder launch."""
    problems = [FITNESS[s % 6] for s in range(s_cnt)] if hetero else None
    _, b, fids, specs = _card_batch(cuda, "rastrigin", "pso", 120, 512,
                                    s_cnt, problems)
    assert pso_step._cluster(512, 120, 512, cuda) == 8
    orig = _batch_ops(b, nb=1)
    state = [x.clone() for x in orig]
    kw = dict(iters=11, sync_every=4, block_n=512)
    pso_step.fused_async_batch(*state, b.seed, b.iteration, specs,
                               fids=fids, **kw)
    members = [0] * s_cnt if fids is None else fids.tolist()
    seeds, its = b.seed.tolist(), b.iteration.tolist()
    for s in range(s_cnt):
        c = slice(s * 512, (s + 1) * 512)
        one = [x[:, c].contiguous() for x in orig[:3]] + [
            orig[3][c].clone(), orig[4][:, s].contiguous(),
            orig[5][s:s + 1].clone(), orig[6][:, s:s + 1].contiguous(),
            orig[7][s:s + 1].clone()]
        pso_step.fused_async(*one, specs[members[s]], seed=seeds[s],
                             iteration=its[s], **kw)
        for a, w in zip(one, (state[0][:, c], state[1][:, c],
                              state[2][:, c], state[3][c], state[4][:, s],
                              state[5][s:s + 1], state[6][:, s:s + 1],
                              state[7][s:s + 1])):
            assert torch.equal(a, w), s


# --- bfloat16 kernels against their plain versions on the card --------------
# ROADMAP's bfloat16 parity contract: on one CTA a block a bfloat16 kernel
# computes the plain version's float32 operations, roundings and cosf/expf
# in the same order, so the two agree bit for bit; on clusters only the
# order of the objective's float32 partial sums differs, and the async
# kernel with one block equals the fused kernel at the same cluster size.

def _bf16_card_state(cuda, fit, rule, d, n, seed=1):
    cfg = pso.PSOConfig(dim=d, particle_cnt=n, fitness=fit,
                        update_rule=rule, dtype="bfloat16").resolved()
    s = pso.init_swarm(cfg, seed, device=cuda)
    return cfg, ops.kernel_spec(cfg), ops.state_to_kernel(s), s.seed


@pytest.mark.gpu
@pytest.mark.parametrize("fit", FITNESS)
@pytest.mark.parametrize("rule", ["pso", "sso", "lowcost"])
def test_bf16_fused_and_queue_kernels_match_plain_on_card(cuda, fit, rule):
    """d=8, two blocks of 512 on one CTA each: a fused launch of three
    iterations and a queue step, bfloat16 throughout, bit for bit their
    plain versions; the queue step bit for bit a fused launch of one."""
    _, spec, state, seed = _bf16_card_state(cuda, fit, rule, 8, 1024)
    kw = dict(seed=seed, iteration=5, block_n=512)
    want = pso_step.fused_plain(*state, spec, iters=3, **kw)
    got = pso_step.fused(*[x.clone() for x in state], spec, iters=3, **kw)
    q = pso_step.queue_step(*[x.clone() for x in state], spec, **kw)
    qp = pso_step.queue_plain(*state, spec, **kw)
    one = pso_step.fused(*[x.clone() for x in state], spec, iters=1, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got + q, want + qp):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(q[:4], one[:4]):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("topology", ["gbest", "ring", "vonneumann"])
@pytest.mark.parametrize("d,n", [(8, 512), (37, 128)])
def test_bf16_async_one_block_equals_fused_on_card(cuda, topology, d, n):
    """One block (one CTA at d=8, a cluster of 2 at d=37), bfloat16: the
    async kernel under every topology equals the fused kernel bit for bit
    across a remainder launch, and the plain version at one CTA."""
    _, spec, state, seed = _bf16_card_state(cuda, "rastrigin", "pso", d, n)
    kw = dict(seed=seed, iteration=0, iters=11, block_n=n)
    fused = pso_step.fused(*[x.clone() for x in state], spec, **kw)
    locals_ = (state[4][:, None].clone(), state[5].clone())
    got = pso_step.fused_async(*[x.clone() for x in state + locals_], spec,
                               sync_every=4, topology=topology, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got[:6], fused):
        assert torch.equal(a, b)
    if pso_step._cluster(n, d, n, cuda, dtype=torch.bfloat16) == 1:
        want = pso_step.fused_async_plain(*state, *locals_, spec,
                                          sync_every=4, topology=topology,
                                          **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_bf16_batches_match_plain_on_card(cuda):
    """rastrigin d=10 n=1024 S=16, bfloat16: the batched fused kernel (two
    blocks a swarm) and the batched async kernel (one block a swarm) bit
    for bit their plain versions."""
    cfg = pso.PSOConfig(dim=10, particle_cnt=1024, fitness="rastrigin",
                        dtype="bfloat16").resolved()
    b = ms.init_batch(cfg, range(16), device=cuda)
    b = b._replace(iteration=3 * torch.arange(16, device=cuda))
    specs = (ops.kernel_spec(cfg),)
    st = _batch_ops(b)
    kw = dict(iters=8, block_n=512)
    got = pso_step.fused_batch(*[x.clone() for x in st], b.seed,
                               b.iteration, specs, **kw)
    want = pso_step.fused_batch_plain(*st, b.seed, b.iteration, specs, **kw)
    st = _batch_ops(b, nb=1)
    kw = dict(iters=8, sync_every=4, block_n=1024)
    got += pso_step.fused_async_batch(*[x.clone() for x in st], b.seed,
                                      b.iteration, specs, **kw)
    want += pso_step.fused_async_batch_plain(*st, b.seed, b.iteration,
                                             specs, **kw)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, w)


@pytest.mark.gpu
def test_bf16_async_kernel_multi_block_invariants_on_card(cuda):
    """cubic d=120 n=32768 in bfloat16, 64 blocks on clusters of 2: gbest
    monotone over launches, == max(pbest), a pbest column of its fitness,
    every position in the box."""
    _, spec, state, seed = _bf16_card_state(cuda, "cubic", "pso", 120,
                                            32768)
    assert pso_step._cluster(32768, 120, 512, cuda, dtype=torch.bfloat16) \
        == 2
    state = state + (state[4][:, None].repeat(1, 64).contiguous(),
                     state[5].repeat(64))
    prev = float(state[5][0])
    for launch in range(3):
        pso_step.fused_async(*state, spec, seed=seed, iteration=8 * launch,
                             iters=8, sync_every=4, block_n=512)
        torch.cuda.synchronize()
        pos, _, pbp, pbf, gp, gf = state[:6]
        g = float(gf[0])
        assert g >= prev and g == float(pbf.max())
        cols = pbp[:, pbf == gf]
        assert bool((cols == gp[:, None]).all(0).any())
        assert bool(((pos >= -100) & (pos <= 100)).all())
        prev = g
