"""The split path's kernels (``repro_torch.kernels.pso_split``) against their
plain versions on a card (``gpu``-marked; they skip inside the test when
there is none), and the plain versions' own contracts on the CPU: the queue
keys' order, the fold's and the publish's modes. Imports no JAX, so it runs
on a card host as it is.

On the card each kernel is held to its plain version on the same card
tensors, exactly: advance positions and velocities bit for bit, fold and
publish outputs given the same fit/viol tensors."""
import math

import pytest
import torch

import repro_torch
from repro_torch.core import constraints as cons
from repro_torch.core import pso
from repro_torch.kernels import ops, pso_split

torch.set_num_threads(1)


def _plane_ball():
    return repro_torch.Problem(
        name="plane_ball", fn=lambda x: torch.sum(x, -1), lo=-2.0, hi=2.0,
        constraints=cons.ConstraintSet(
            constraints=(cons.Constraint(
                fn=lambda x: torch.sum(x * x, -1) - 2.25),),
            mode="repair", repair_tries=64))


def _problem(name):
    if name == "plane_ball":
        return _plane_ball()
    if name == "custom":
        return repro_torch.Problem(name="my_sphere",
                                   fn=lambda x: -torch.sum(x * x, -1),
                                   lo=-5.0, hi=5.0)
    return repro_torch.get_problem(name)


def _ukey(fit: float, index: int) -> int:
    """csrc/pso_split.cu's make_key in Python ints."""
    import struct
    u = struct.unpack("<I", struct.pack("<f", fit + 0.0))[0]
    u = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return (u << 32) | (0xFFFFFFFF - index)


def test_queue_keys_are_the_kernel_keys_and_order_like_them():
    fits = [-math.inf, -3.5, -0.0, 0.0, 1e-30, 2.0, 2.0, 7.25]
    idx = [5, 1, 9, 2, 0, 4, 3, 8]
    got = pso_split.queue_keys(torch.tensor(fits), torch.tensor(idx))
    want = [_ukey(f, i) for f, i in zip(fits, idx)]
    assert [k & 0xFFFFFFFFFFFFFFFF for k in got.tolist()] == want
    assert pso_split.key_index(got).tolist() == idx
    # unsigned order: the larger fitness, then the lower index (first lane)
    best = pso_split._umax(torch.zeros(1, dtype=torch.int64), got[None, :])
    assert int(best) & 0xFFFFFFFFFFFFFFFF == max(want)
    assert int(pso_split.key_index(best)) == 8
    tie = pso_split._umax(torch.zeros(1, dtype=torch.int64),
                          got[None, 5:7])
    assert int(pso_split.key_index(tie)) == 3


def test_fold_and_publish_plain_modes():
    """Two swarms of two blocks of four: the fused fold raises each swarm's
    key to its best lane beating gf, the publish takes it and clears the
    key; the async fold moves each block's winner into its local best."""
    d, n, bn = 2, 8, 4
    pos = torch.arange(d * 2 * n, dtype=torch.float32).reshape(d, 2 * n)
    fit = torch.tensor([0., 5., 1., 5., 2., 3., 4., 0.,
                        -1., -2., -3., -4., 9., 8., 9., 1.])
    pbf = torch.full((2 * n,), 1.5)
    pbp = torch.zeros(d, 2 * n)
    gf = torch.tensor([4.0, 0.0])
    keys = torch.zeros(2, dtype=torch.int64)
    counts = torch.zeros(6, dtype=torch.int32)
    out = pso_split.split_fold_plain(pos, pbp, pbf, fit, n=n, block_n=bn,
                                     mode="fused", gf=gf, keys=keys,
                                     counts=counts)
    assert pso_split.key_index(out["keys"]).tolist() == [1, 4]
    assert torch.equal(out["pbf"], torch.where(fit > 1.5, fit, pbf))
    # swarm 0: block 0 beats gf (5 > 4); block 1 does not (4 is not > 4)
    assert counts.tolist() == [1, 1, 2, 1, 1, 1]
    gp = torch.zeros(d, 2)
    pub = pso_split.split_publish_plain(pos, fit, gp, gf, n=n, mode="fused",
                                        keys=out["keys"])
    assert pub["gf"].tolist() == [5.0, 9.0]
    assert torch.equal(pub["gp"], pos[:, [1, 12]])
    assert pub["keys"].tolist() == [0, 0]
    lf = torch.tensor([5.0, 3.5, 0.0, 8.5])
    lp = torch.zeros(d, 4)
    out = pso_split.split_fold_plain(pos, pbp, pbf, fit, n=n, block_n=bn,
                                     mode="async", lp=lp, lf=lf)
    assert out["lf"].tolist() == [5.0, 4.0, 0.0, 9.0]
    assert torch.equal(out["lp"][:, 1], pos[:, 6])
    act = torch.tensor([pso_split.ACT_SYNC, pso_split.ACT_FLUSH],
                       dtype=torch.int32)
    pub = pso_split.split_publish_plain(pos, fit, gp, gf, n=n, mode="async",
                                        lp=out["lp"], lf=out["lf"], act=act)
    assert pub["gf"].tolist() == [5.0, 9.0]
    assert pub["lf"].tolist() == [5.0, 5.0, 0.0, 9.0]   # swarm 1 not pulled
    queue = pso_split.split_fold_plain(
        pos[:, :n], pbp[:, :n], pbf[:n], fit[:n], n=n, block_n=bn,
        mode="queue", gf=gf[:1])
    assert queue["aux_fit"].tolist() == [5.0, -math.inf]
    assert queue["aux_idx"].tolist() == [1, 4]


def test_wrappers_refuse_operands_of_the_wrong_shape():
    """A user's objective of the wrong length, or a attractor of the wrong
    width, is refused before any kernel would read past its end."""
    d, n = 3, 64
    pos, vel, pbp = (torch.zeros(d, n) for _ in range(3))
    pbf, gf = torch.zeros(n), torch.zeros(1)
    with pytest.raises(ValueError, match="fit must be"):
        pso_split.fold(pos, pbp, pbf, torch.zeros(n - 1), n=n, block_n=16,
                       mode="fused", gf=gf,
                       keys=torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="attractor must be"):
        pso_split.advance(pos, vel, pbp, torch.zeros(d, 2),
                          torch.zeros(1, dtype=torch.int64),
                          torch.zeros(1, dtype=torch.int64), (), n=n,
                          it_off=0, gdiv=n)
    with pytest.raises(ValueError, match="act must be"):
        pso_split.publish(pos, torch.zeros(n), torch.zeros(d, 1), gf, n=n,
                          mode="async", lp=torch.zeros(d, 4),
                          lf=torch.zeros(4), act=torch.zeros(1))


def _card_round(name, variant, d, n, bn, dev):
    """One split iteration on the card from a state two iterations in:
    each kernel against its plain version on the same card tensors."""
    cfg = pso.PSOConfig(dim=d, particle_cnt=n, w=0.7,
                        fitness=_problem(name)).resolved()
    s = pso.run(cfg, pso.init_swarm(cfg, 0, device=dev), 2, "queue")
    pos, vel, pbp, pbf, gp, gf = ops.state_to_kernel(s)
    gp = gp[:, None].contiguous()
    spec = ops.kernel_spec(cfg)
    seeds, its = ops._seed_rows(s)
    nb = n // bn
    attractor, gdiv = (gp, n) if variant == "fused" else (
        gp.repeat(1, nb).contiguous(), bn)
    p0, v0 = pso_split.split_advance_plain(pos, vel, pbp, attractor, seeds,
                                           its, (spec,), n=n, it_off=0,
                                           gdiv=gdiv)
    pso_split.advance(pos, vel, pbp, attractor, seeds, its, (spec,), n=n,
                      it_off=0, gdiv=gdiv)
    assert torch.equal(pos, p0) and torch.equal(vel, v0)
    fit, viol = pso_split.torch_step((cfg.problem,), None, n, (n,))(pos)
    pbv = ops._pbv(cfg, None, s.pbest_pos)
    bufs = dict(pbp=pbp, pbf=pbf, pbv=pbv)
    kw = dict(n=n, block_n=bn, mode=variant, pbv=pbv, viol=viol,
              counts=torch.zeros(3, dtype=torch.int32, device=dev))
    if variant == "fused":
        kw.update(gf=gf, keys=torch.zeros(1, dtype=torch.int64, device=dev))
    else:
        kw.update(lp=attractor.clone(), lf=gf.repeat(nb))
    plain_counts = kw["counts"].clone()
    want = pso_split.split_fold_plain(pos, pbp, pbf, fit,
                                      **dict(kw, counts=plain_counts))
    pso_split.fold(pos, pbp, pbf, fit, **kw)
    for k, w in want.items():
        assert torch.equal(bufs.get(k, kw.get(k)), w), k
    assert torch.equal(kw["counts"], plain_counts)
    pkw = dict(n=n, mode=variant)
    if variant == "fused":
        pkw["keys"] = kw["keys"]
    else:
        pkw.update(lp=kw["lp"], lf=kw["lf"], act=torch.full(
            (1,), pso_split.ACT_SYNC, dtype=torch.int32, device=dev))
    want = pso_split.split_publish_plain(pos, fit, gp, gf, **pkw)
    pso_split.publish(pos, fit, gp, gf, **pkw)
    got = dict(gp=gp, gf=gf, **pkw)
    for k, w in want.items():
        assert torch.equal(got[k], w), k


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100 with "
                    "`python -m pytest -m gpu tests/test_torch_split.py`")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sphere_simplex", "sphere_simplex_pen",
                                  "plane_ball", "custom"])
@pytest.mark.parametrize("variant", ["fused", "async"])
def test_split_kernels_match_plain_on_card(cuda, name, variant):
    _card_round(name, variant, 3 if name == "plane_ball" else 8, 1024, 256,
                cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["queue_lock", "async"])
def test_split_solve_on_card_is_feasible(cuda, variant):
    r = repro_torch.solve("sphere_simplex", dim=8, particles=1024, iters=50,
                          variant=variant, w=0.7)
    assert r.feasible and r.best_fit == pytest.approx(1 / 8, rel=1e-3)
    pos = r.state.pos
    assert float(pos.min()) >= 0.0
    assert float((pos.sum(-1) - 1).abs().max()) <= 1e-5
