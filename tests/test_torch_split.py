"""The split path's kernels (``repro_torch.kernels.pso_split``) against their
plain versions on a card (``gpu``-marked; they skip inside the test when
there is none), and the plain versions' own contracts on the CPU: the queue
keys' order, the fold's and the publish's modes, the fold's cluster
planner, and ``fold_publish`` on CPU tensors. Imports no JAX, so it runs on
a card host as it is.

On the card each kernel is held to its plain version on the same card
tensors, exactly: advance positions and velocities bit for bit, the
fold-and-publish kernel's outputs (given the same fit/viol tensors) equal
to ``split_fold_plain`` followed by ``split_publish_plain``, at every
cluster size, with its arrival counters back at zero; in float32 and in
bfloat16 (the library built with ``-DPSO_T_BF16``, whose launches also
count in ``.bf16_launches``)."""
import math

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import constraints as cons
from repro_torch.core import pso
from repro_torch.kernels import ops, pso_split

torch.set_num_threads(1)

BF = torch.bfloat16


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
        pso_split.fold_publish(pos, pbp, pbf, torch.zeros(n - 1), n=n,
                               block_n=16, mode="fused", gp=torch.zeros(d, 1),
                               gf=gf, keys=torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="attractor must be"):
        pso_split.advance(pos, vel, pbp, torch.zeros(d, 2),
                          torch.zeros(1, dtype=torch.int64),
                          torch.zeros(1, dtype=torch.int64), (), n=n,
                          it_off=0, gdiv=n)
    with pytest.raises(ValueError, match="act must be"):
        pso_split.fold_publish(pos, pbp, pbf, torch.zeros(n), n=n,
                               block_n=16, mode="async", gp=torch.zeros(d, 1),
                               gf=gf, lp=torch.zeros(d, 4), lf=torch.zeros(4),
                               act=torch.zeros(1))


def _operands(gp, gf, pbp, pbf, pbv, *, n, bn, variant, act=None):
    """Fresh copies of one fold_publish call's in-place operands, counts
    zero; async locals seeded from gbest, ``act`` a sync point for every
    swarm unless given."""
    dev, s_cnt, nb = gf.device, gf.shape[0], n // bn
    op = dict(pbp=pbp.clone(), pbf=pbf.clone(), gp=gp.clone(),
              gf=gf.clone(), pbv=None if pbv is None else pbv.clone(),
              counts=torch.zeros(3 * s_cnt, dtype=torch.int32, device=dev))
    if variant == "fused":
        op["keys"] = torch.zeros(s_cnt, dtype=torch.int64, device=dev)
    elif variant == "async":
        op.update(lp=gp.repeat_interleave(nb, 1).contiguous(),
                  lf=gf.repeat_interleave(nb).contiguous(),
                  act=torch.full((s_cnt,), pso_split.ACT_SYNC,
                                 dtype=torch.int32, device=dev)
                  if act is None else act)
    else:
        op.update(aux_fit=gf.new_empty(s_cnt * nb),
                  aux_idx=torch.empty(s_cnt * nb, dtype=torch.int32,
                                      device=dev))
        del op["gp"]
    return op


def _plain_chain(pos, fit, viol, op, *, n, bn, variant, topology="gbest"):
    """``split_fold_plain`` then (outside the queue mode)
    ``split_publish_plain`` on copies of ``op``: the outputs by name."""
    w = {k: (None if v is None else v.clone()) for k, v in op.items()}
    w.update(pso_split.split_fold_plain(
        pos, w["pbp"], w["pbf"], fit, n=n, block_n=bn, mode=variant,
        gf=w["gf"], pbv=w["pbv"], viol=viol, lp=w.get("lp"),
        lf=w.get("lf"), keys=w.get("keys"), counts=w["counts"]))
    if variant != "queue":
        w.update(pso_split.split_publish_plain(
            pos, fit, w["gp"], w["gf"], n=n, mode=variant,
            keys=w.get("keys"), lp=w.get("lp"), lf=w.get("lf"),
            act=w.get("act"), counts=w["counts"], topology=topology))
    return w


def _held_to_plain(pos, fit, viol, op, *, n, bn, variant, cluster=None,
                   topology="gbest"):
    """One ``fold_publish`` on ``op`` in place against the plain chain on
    copies: every output and the counts equal, exactly; one launch counted
    on the card and none on the CPU; on the card every arrival counter back
    at 0."""
    want = _plain_chain(pos, fit, viol, op, n=n, bn=bn, variant=variant,
                        topology=topology)
    dev = pos.device
    arrive = (torch.zeros(fit.shape[0] // n, dtype=torch.int32, device=dev)
              if dev.type == "cuda" and variant != "queue" else None)
    before = (pso_split.fold_publish.launches,
              pso_split.fold_publish.bf16_launches)
    pso_split.fold_publish(pos, op["pbp"], op["pbf"], fit, n=n, block_n=bn,
                           mode=variant, viol=viol, arrive=arrive,
                           _cluster=cluster, topology=topology,
                           **{k: v for k, v in op.items()
                              if k not in ("pbp", "pbf")})
    card = dev.type == "cuda"
    assert (pso_split.fold_publish.launches,
            pso_split.fold_publish.bf16_launches) == (
        before[0] + card, before[1] + (card and pos.dtype == BF))
    for k, w in want.items():
        if w is not None:
            assert torch.equal(op[k], w), k
    assert arrive is None or not arrive.any()


def _card_round(name, variant, d, n, bn, dev, cluster=None, rule="pso",
                dtype="float32"):
    """One split iteration on the card from a state two iterations in:
    each kernel against its plain version on the same card tensors."""
    cfg = pso.PSOConfig(dim=d, particle_cnt=n, w=0.7, update_rule=rule,
                        fitness=_problem(name), dtype=dtype).resolved()
    s = pso.run(cfg, pso.init_swarm(cfg, 0, device=dev), 2, "queue")
    pos, vel, pbp, pbf, gp, gf = ops.state_to_kernel(s)
    gp = gp[:, None].contiguous()
    spec = ops.kernel_spec(cfg)
    seeds, its = ops._seed_rows(s)
    nb = n // bn
    attractor, gdiv = (gp, n) if variant != "async" else (
        gp.repeat(1, nb).contiguous(), bn)
    p0, v0 = pso_split.split_advance_plain(pos, vel, pbp, attractor, seeds,
                                           its, (spec,), n=n, it_off=0,
                                           gdiv=gdiv)
    pso_split.advance(pos, vel, pbp, attractor, seeds, its, (spec,), n=n,
                      it_off=0, gdiv=gdiv)
    assert torch.equal(pos, p0) and torch.equal(vel, v0)
    fit, viol = pso_split.torch_step((cfg.problem,), None, n, (n,))(pos)
    pbv = ops._pbv(cfg, None, s.pbest_pos)
    op = _operands(gp, gf, pbp, pbf, pbv, n=n, bn=bn, variant=variant)
    _held_to_plain(pos, fit, viol, op, n=n, bn=bn, variant=variant,
                   cluster=cluster)


def _random_state(seed, s_cnt, n, d, deb, dev="cpu", dtype=torch.float32):
    """A random D-major state of ``s_cnt`` swarms whose fitness, pbest
    fitness and violations tie and cross one another, from numpy (small
    integers, which bfloat16 holds exactly)."""
    rng = np.random.default_rng(seed)

    def f32(*shape, k=5):
        return torch.tensor(rng.integers(-k, k, size=shape).astype(
            np.float32), device=dev).to(dtype)
    pos, pbp = f32(d, s_cnt * n, k=100), f32(d, s_cnt * n, k=100)
    fit, pbf = f32(s_cnt * n), f32(s_cnt * n)
    gp, gf = f32(d, s_cnt, k=100), f32(s_cnt, k=3)
    viol = torch.clamp(f32(s_cnt * n, k=2), min=0) if deb else None
    pbv = torch.clamp(f32(s_cnt * n, k=2), min=0) if deb else None
    return pos, pbp, pbf, gp, gf, fit, viol, pbv


#: fold_publish's modes on the CPU: (variant, topology, actions a swarm).
FOLD_CASES = [("queue", "gbest", None), ("fused", "gbest", None),
              ("async", "gbest", (0, 0, 0, 0)), ("async", "gbest", (1,) * 4),
              ("async", "gbest", (2,) * 4), ("async", "gbest", (1, 2, 0, 1)),
              ("async", "ring", (1, 2, 0, 1)),
              ("async", "vonneumann", (1, 1, 2, 0))]


@pytest.mark.parametrize("deb", [False, True])
@pytest.mark.parametrize("variant,topology,act", FOLD_CASES)
def test_fold_publish_on_cpu_is_the_plain_chain(variant, topology, act,
                                                deb):
    """The wrapper on CPU tensors, in place, equals split_fold_plain then
    split_publish_plain on copies, counts included, in every mode, action
    and topology, with and without Deb's rule; it launches nothing."""
    s_cnt, n, bn, d = 4, 48, 8, 3
    pos, pbp, pbf, gp, gf, fit, viol, pbv = _random_state(
        7, s_cnt, n, d, deb)
    op = _operands(gp, gf, pbp, pbf, pbv, n=n, bn=bn, variant=variant,
                   act=None if act is None else torch.tensor(
                       act, dtype=torch.int32))
    _held_to_plain(pos, fit, viol, op, n=n, bn=bn, variant=variant,
                   topology=topology)
    assert int(op["counts"].sum()) > 0


@pytest.mark.parametrize("variant,topology,act", FOLD_CASES)
def test_fold_publish_bf16_on_cpu_is_the_plain_chain(variant, topology, act):
    """The same in bfloat16 (Deb's rule on): the wrapper takes bfloat16
    operands, every float output bfloat16, and launches nothing."""
    s_cnt, n, bn, d = 4, 48, 8, 3
    pos, pbp, pbf, gp, gf, fit, viol, pbv = _random_state(
        7, s_cnt, n, d, True, dtype=BF)
    op = _operands(gp, gf, pbp, pbf, pbv, n=n, bn=bn, variant=variant,
                   act=None if act is None else torch.tensor(
                       act, dtype=torch.int32))
    _held_to_plain(pos, fit, viol, op, n=n, bn=bn, variant=variant,
                   topology=topology)
    assert all(t.dtype == BF for t in op.values()
               if t is not None and t.is_floating_point())


#: fold_cluster_size on a 132-SM H100: (S, n, d, block_n, C), at phase
#: 6b's and 6c's solve cells, solve_many's batch (chip_smoke.py SPLIT_MANY),
#: 6c's batch sweep and the thresholds of the row cap and the SM fill.
PLANS = [(1, 32768, 120, 512, 2),    # 6b/6c sphere_simplex, custom d=120
         (1, 1024, 8, 512, 1),       # 6b d=8 cells
         (64, 1024, 8, 512, 1),      # solve_many's rows
         (1, 1024, 3, 512, 1),       # 6b plane_ball
         (1, 1024, 8, 128, 1),       # phase 7's split lbest
         (1, 1024, 15, 512, 1), (1, 1024, 16, 512, 2), (1, 1024, 37, 512, 2),
         (1, 16384, 120, 512, 2), (1, 8192, 120, 512, 2),
         (1, 131072, 120, 512, 1),   # 256 blocks: more than one an SM
         (1, 132 * 512, 120, 512, 1), (1, 66 * 512, 120, 512, 2),
         (1, 67 * 512, 120, 512, 1),
         (128, 256, 120, 256, 1),    # 6c's batch: 128 CTAs at C=1
         (64, 1024, 120, 512, 1),    # a batch that fills the card at C=1
         (33, 1024, 120, 512, 2), (34, 1024, 120, 512, 1)]


@pytest.mark.parametrize("s_cnt,n,d,bn,want", PLANS)
def test_fold_cluster_size_plans(s_cnt, n, d, bn, want):
    c = pso_split.fold_cluster_size(s_cnt, n, d, bn, 132)
    assert c == want and c in pso_split.FOLD_CLUSTERS
    # never more CTAs a block than rows of FOLD_MIN_ROWS, and 1 at d <= 8;
    # never more than one CTA an SM, batch included, where C > 1
    assert c == 1 or (d >= c * pso_split.FOLD_MIN_ROWS
                      and s_cnt * (n // bn) * c <= 132)


def test_fold_publish_refuses_a_mode_without_its_operands():
    d, n = 3, 64
    pos, pbp = torch.zeros(d, n), torch.zeros(d, n)
    pbf, fit, gf = torch.zeros(n), torch.zeros(n), torch.zeros(1)
    with pytest.raises(ValueError, match="needs"):
        pso_split.fold_publish(pos, pbp, pbf, fit, n=n, block_n=16,
                               mode="fused", gf=gf)
    with pytest.raises(ValueError, match="cluster"):
        pso_split.fold_publish(pos, pbp, pbf, fit, n=n, block_n=16,
                               mode="queue", gf=gf,
                               aux_fit=torch.zeros(4),
                               aux_idx=torch.zeros(4, dtype=torch.int32),
                               _cluster=4)


def _advance_operands(d, n, s_cnt, gdiv, rule="pso", dev="cpu",
                      misaligned=False, dtype=BF, seed=0):
    """One advance's operands: a custom Problem's kernel spec (box [-5, 5])
    under ``rule``, and ``s_cnt`` swarms of random positions, velocities,
    pbest and attractor columns (numpy, seeded; values of ``dtype``), seeds
    and iteration counters. ``misaligned`` puts pos, vel and pbp 2 bytes
    past a 16-byte boundary, contiguous all the same."""
    cfg = pso.PSOConfig(dim=d, particle_cnt=n, w=0.7, update_rule=rule,
                        fitness=_problem("custom"),
                        dtype=str(dtype).split(".")[-1]).resolved()
    rng = np.random.default_rng(seed)
    ld = s_cnt * n

    def arr(shape, bound, off=False):
        t = torch.tensor(rng.uniform(-bound, bound, size=shape).astype(
            np.float32)).to(dtype).to(dev)
        if not off:
            return t
        out = torch.empty(t.numel() + 1, dtype=dtype, device=dev)[1:]
        return out.view(shape).copy_(t)
    pos, vel, pbp = (arr((d, ld), b, misaligned) for b in (5.0, 12.0, 5.0))
    att = arr((d, ld // gdiv), 5.0)
    seeds = torch.tensor(rng.integers(0, 2 ** 31, size=s_cnt))
    its = torch.tensor(rng.integers(0, 5000, size=s_cnt))
    return pos, vel, pbp, att, seeds, its, (ops.kernel_spec(cfg),)


#: advance_paths' cases: (dtype, n, S, gdiv, misaligned, a member table,
#: the paths the operands allow).
PATH_CASES = [(BF, 1024, 1, 1024, False, False, (1, 8)),   # gbest
              (BF, 1024, 4, 256, False, False, (1, 8)),    # locals, S = 4
              (BF, 1002, 1, 1002, False, False, (1,)),     # N % 8: a tail
              (BF, 1000, 1, 500, False, False, (1,)),      # gdiv % 8
              (BF, 1024, 1, 1024, True, False, (1,)),      # 2 bytes off 16
              (BF, 1024, 2, 1024, False, True, (1,)),      # a member table
              (torch.float32, 1024, 1, 1024, False, False, (1,))]


@pytest.mark.parametrize("dtype,n,s_cnt,gdiv,off,table,want", PATH_CASES)
def test_advance_paths_by_shape_and_alignment(dtype, n, s_cnt, gdiv, off,
                                              table, want):
    pos, vel, pbp, *_ = _advance_operands(3, n, s_cnt, gdiv, dtype=dtype,
                                          misaligned=off)
    assert pos.is_contiguous() and (pos.data_ptr() % 16 != 0) == off
    fids = torch.zeros(s_cnt, dtype=torch.int32) if table else None
    assert pso_split.advance_paths(pos, vel, pbp, gdiv=gdiv,
                                   fids=fids) == want


@pytest.mark.parametrize("d,n,off,want", [
    (3, 1024, False, 1),                       # a small launch
    (8, 20480, False, 8),                      # ADVANCE_MIN_ELEMENTS
    (8, 20472, False, 1),                      # just under it
    (120, 32768, False, 8),                    # 16c's swarm
    (8, 20480, True, 1)])                      # large, but 2 bytes off 16
def test_advance_lanes_takes_the_16_byte_path_on_large_launches(d, n, off,
                                                                want):
    pos, vel, pbp, *_ = _advance_operands(d, n, 1, n, misaligned=off)
    big = d * n >= pso_split.ADVANCE_MIN_ELEMENTS
    assert want == (8 if big and not off else 1)
    assert pso_split.advance_lanes(pos, vel, pbp, gdiv=n) == want


#: A threshold past every launch: the planner's lane path at any size.
NEVER = 1 << 62


@pytest.mark.parametrize("n,gdiv,least,want", [
    (1024, 1024, 0, 8),        # the threshold at 0: the 16-byte path
    (1024, 256, 0, 8),         # the async locals, likewise
    (1024, 1024, NEVER, 1),    # past every launch: the lane path
    (1002, 1002, 0, 1),        # a row tail takes the lanes at any size
    (1000, 500, 0, 1)])        # and so does gdiv % 8
def test_advance_lanes_follows_the_size_threshold(monkeypatch, n, gdiv,
                                                  least, want):
    """The card tests and chip_smoke.py select each path through the
    planner's threshold (``ADVANCE_MIN_ELEMENTS``): at 0 the 16-byte path
    wherever ``advance_paths`` allows it, past every launch the lane path.
    On the CPU the advance is the plain version's whichever it picks."""
    pos, vel, pbp, att, seeds, its, specs = _advance_operands(
        5, n, 2, gdiv, rule="lowcost")
    monkeypatch.setattr(pso_split, "ADVANCE_MIN_ELEMENTS", least)
    assert pso_split.advance_lanes(pos, vel, pbp, gdiv=gdiv) == want
    kw = dict(n=n, it_off=3, gdiv=gdiv)
    ref = pso_split.split_advance_plain(pos, vel, pbp, att, seeds, its,
                                        specs, **kw)
    pso_split.advance(pos, vel, pbp, att, seeds, its, specs, **kw)
    assert torch.equal(pos, ref[0]) and torch.equal(vel, ref[1])


def _bf16_bits_rne(v: np.ndarray) -> np.ndarray:
    """float64 values rounded once to bfloat16, to nearest even, written on
    the bits: the 53-bit significand cut to 8 bits (fewer below bfloat16's
    least normal, 2^-126, down to its subnormals' 2^-133), a carry into the
    exponent, overflow to inf at (2 - 2^-8) * 2^127; NaN to 0x7FC0.
    Returns the uint16 bits."""
    b = v.view(np.uint64)
    sign = ((b >> np.uint64(63)) << np.uint64(15)).astype(np.int64)
    biased = ((b >> np.uint64(52)) & np.uint64(0x7FF)).astype(np.int64)
    frac = (b & np.uint64((1 << 52) - 1)).astype(np.int64)
    e = biased - 1023
    m = frac | (1 << 52)
    shift = np.minimum(45 + np.maximum(-126 - e, 0), 60)
    kept = m >> shift
    rem = m & ((np.int64(1) << shift) - 1)
    half = np.int64(1) << (shift - 1)
    kept += (rem > half) | ((rem == half) & (kept & 1 == 1))
    bits = (np.maximum(e + 126, 0) << 7) + kept     # the carry included
    bits = np.where(bits >= 0x7F80, 0x7F80, bits)
    bits = np.where(v == 0, 0, bits)
    bits = np.where(np.isnan(v), 0x7FC0, bits | sign)
    return bits.astype(np.uint16)


def _bf16_of_bits(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits.astype(np.uint16).view(np.int16)).view(BF)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _same_bf16(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    nan = lambda x: (x & 0x7FFF) > 0x7F80
    return (a == b) | (nan(a) & nan(b))


#: The other operand of every bfloat16 value in the rounding test: +-0,
#: subnormals, the least normals, the extremes, +-inf, NaNs, values near 1,
#: the draws' scale 2^-24, powers whose products overflow or underflow, and
#: a seeded sample.
EDGE_BITS = np.array(
    [0x0000, 0x8000, 0x0001, 0x8001, 0x0002, 0x0003, 0x003F, 0x0040, 0x0041,
     0x807F, 0x007F, 0x0080, 0x8080, 0x0081, 0x00FF, 0x7F7F, 0xFF7F, 0x7F7E,
     0x7F00, 0x7F80, 0xFF80, 0x7FC0, 0xFFC0, 0x7F81, 0x3F80, 0xBF80, 0x3F81,
     0x3F7F, 0x4000, 0x3F00, 0x3380, 0x5F80, 0x1F80, 0x0C00, 0x7300, 0xC2C8]
    + np.random.default_rng(0).integers(0, 1 << 16, size=64).tolist(),
    dtype=np.uint16)


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_bf16_rounding_model_is_the_once_rounded_result(op):
    """The plain version's bfloat16 arithmetic (a float32 result rounded
    once to bfloat16: torch's bfloat16 operators on the CPU, and numpy's
    float32 operation then torch's rounding) against the exact result
    rounded once (float64, exact for mul and to 53 bits for add and sub,
    then ``_bf16_bits_rne``), for every bfloat16 value against
    ``EDGE_BITS``: the premise on which the kernel's packed instructions
    (one rounding each) compute the plain version's values."""
    a_bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    a, b = _bf16_of_bits(a_bits)[:, None], _bf16_of_bits(EDGE_BITS)[None, :]
    fn = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y,
          "sub": lambda x, y: x - y}[op]
    model = _bits(fn(a, b))
    with np.errstate(all="ignore"):
        f32 = fn(a.float().numpy(), b.float().numpy())
        exact = _bf16_bits_rne(fn(a.double().numpy(), b.double().numpy()))
    from_f32 = _bits(torch.from_numpy(f32).to(BF))
    assert _same_bf16(model, from_f32).all()
    bad = ~_same_bf16(model, exact)
    assert not bad.any(), (
        f"{int(bad.sum())} {op} results differ, first "
        f"{[hex(int(x)) for x in np.argwhere(bad)[0]]}")


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
@pytest.mark.parametrize("cluster", pso_split.FOLD_CLUSTERS)
@pytest.mark.parametrize("variant", ["fused", "async"])
@pytest.mark.parametrize("n,bn", [(4096, 512), (1002, 501)])
def test_fold_publish_matches_plain_on_card_at_each_cluster(cuda, variant,
                                                            cluster, n, bn):
    """At blocks of 512 the copies run in float4, at 501 a lane at a time
    (n and the block not multiples of four)."""
    _card_round("sphere_simplex", variant, 40, n, bn, cuda, cluster=cluster)


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", pso_split.FOLD_CLUSTERS)
@pytest.mark.parametrize("variant,topology,act", FOLD_CASES)
def test_fold_publish_modes_on_card_at_each_cluster(cuda, variant, topology,
                                                    act, cluster):
    s_cnt, n, bn, d = 4, 1024, 128, 20
    pos, pbp, pbf, gp, gf, fit, viol, pbv = _random_state(
        3, s_cnt, n, d, True, dev=cuda)
    op = _operands(gp, gf, pbp, pbf, pbv, n=n, bn=bn, variant=variant,
                   act=None if act is None else torch.tensor(
                       act, dtype=torch.int32, device=cuda))
    _held_to_plain(pos, fit, viol, op, n=n, bn=bn, variant=variant,
                   cluster=cluster, topology=topology)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["queue_lock", "async"])
def test_split_solve_on_card_is_feasible(cuda, variant):
    r = repro_torch.solve("sphere_simplex", dim=8, particles=1024, iters=50,
                          variant=variant, w=0.7)
    assert r.feasible and r.best_fit == pytest.approx(1 / 8, rel=1e-3)
    pos = r.state.pos
    assert float(pos.min()) >= 0.0
    assert float((pos.sum(-1) - 1).abs().max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sphere_simplex", "sphere_simplex_pen",
                                  "plane_ball", "custom"])
@pytest.mark.parametrize("rule", ["pso", "sso", "lowcost"])
@pytest.mark.parametrize("variant", ["queue", "fused", "async"])
def test_split_kernels_match_plain_on_card_bf16(cuda, name, rule, variant):
    """The bfloat16 split kernels against their plain versions, every
    rule and mode."""
    before = pso_split.advance.bf16_launches
    _card_round(name, variant, 3 if name == "plane_ball" else 8, 1024, 256,
                cuda, rule=rule, dtype="bfloat16")
    assert pso_split.advance.bf16_launches == before + 1


#: The bfloat16 advance's cells on the card: (d, n, S, gdiv, misaligned).
ADVANCE_BF16_CELLS = [(1, 1024, 1, 1024, False), (3, 1024, 1, 1024, False),
                      (120, 32768, 1, 32768, False),   # 16c's swarm
                      (24, 1002, 1, 1002, False),      # a row tail
                      (8, 1024, 1, 1024, True),        # 2 bytes off 16
                      (8, 1024, 4, 256, False),        # async locals, S = 4
                      (10, 1000, 3, 500, False),       # gdiv % 8
                      # solve_many's batch: gbest, and the async locals
                      (10, 1024, 128, 1024, False),
                      (10, 1024, 128, 512, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["pso", "sso", "lowcost"])
@pytest.mark.parametrize("d,n,s_cnt,gdiv,off", ADVANCE_BF16_CELLS)
def test_advance_bf16_each_path_bit_for_bit_on_card(cuda, monkeypatch, d, n,
                                                    s_cnt, gdiv, off, rule):
    """The bfloat16 advance's 16-byte path and its lane path, each selected
    on purpose where the operands allow it (``ADVANCE_MIN_ELEMENTS`` at 0 or
    past every launch), bit for bit ``split_advance_plain``; a lane-path
    launch also counts in ``bf16_lane_launches``."""
    pos, vel, pbp, att, seeds, its, specs = _advance_operands(
        d, n, s_cnt, gdiv, rule=rule, dev=cuda, misaligned=off)
    kw = dict(n=n, it_off=7, gdiv=gdiv)
    want = pso_split.split_advance_plain(pos, vel, pbp, att, seeds, its,
                                         specs, **kw)
    paths = pso_split.advance_paths(pos, vel, pbp, gdiv=gdiv)
    assert paths == ((1,) if off or gdiv % 8 else (1, 8))
    for lanes in paths:
        p, v = pos.clone(), vel.clone()
        if off:
            p = torch.empty(p.numel() + 1, dtype=BF, device=cuda)[1:].view(
                p.shape).copy_(pos)
            v = torch.empty(v.numel() + 1, dtype=BF, device=cuda)[1:].view(
                v.shape).copy_(vel)
        monkeypatch.setattr(pso_split, "ADVANCE_MIN_ELEMENTS",
                            0 if lanes > 1 else NEVER)
        assert pso_split.advance_lanes(p, v, pbp, gdiv=gdiv) == lanes
        before = (pso_split.advance.bf16_launches,
                  pso_split.advance.bf16_lane_launches)
        pso_split.advance(p, v, pbp, att, seeds, its, specs, **kw)
        torch.cuda.synchronize()
        assert (pso_split.advance.bf16_launches,
                pso_split.advance.bf16_lane_launches) == (
            before[0] + 1, before[1] + (lanes == 1))
        for got, w in ((p, want[0]), (v, want[1])):
            assert torch.equal(got.view(torch.int16), w.view(torch.int16))


@pytest.mark.gpu
def test_bf16_packed_instructions_exhaustive_on_card(cuda):
    """Every packed instruction of the bfloat16 advance equals the float
    operation rounded once on every operand pair (``check_bf16_ops``)."""
    got = pso_split.check_bf16_ops(cuda)
    assert list(got) == list(pso_split.BF16_OPS)
    for name, (bad, seen, first) in got.items():
        assert seen == (1 << 24 if name == "draw" else 1 << 32), name
        assert bad == 0 and first == -1, (name, bad, hex(first))


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", pso_split.FOLD_CLUSTERS)
@pytest.mark.parametrize("variant", ["fused", "async"])
@pytest.mark.parametrize("n,bn", [(4096, 512), (1002, 501)])
def test_fold_publish_bf16_matches_plain_on_card_at_each_cluster(
        cuda, variant, cluster, n, bn):
    """In bfloat16 the copies take four lanes in 8 bytes at blocks of 512,
    a lane at a time at 501."""
    _card_round("sphere_simplex", variant, 40, n, bn, cuda, cluster=cluster,
                dtype="bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", pso_split.FOLD_CLUSTERS)
@pytest.mark.parametrize("variant,topology,act", FOLD_CASES)
def test_fold_publish_bf16_modes_on_card_at_each_cluster(
        cuda, variant, topology, act, cluster):
    s_cnt, n, bn, d = 4, 1024, 128, 20
    pos, pbp, pbf, gp, gf, fit, viol, pbv = _random_state(
        3, s_cnt, n, d, True, dev=cuda, dtype=BF)
    op = _operands(gp, gf, pbp, pbf, pbv, n=n, bn=bn, variant=variant,
                   act=None if act is None else torch.tensor(
                       act, dtype=torch.int32, device=cuda))
    _held_to_plain(pos, fit, viol, op, n=n, bn=bn, variant=variant,
                   cluster=cluster, topology=topology)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["queue_lock", "async"])
def test_split_solve_on_card_bf16(cuda, variant):
    """A custom Problem in bfloat16 through ``solve`` on the card: the
    bfloat16 split kernels only, a bfloat16 state in the box."""
    before = pso_split.fold_publish.bf16_launches
    r = repro_torch.solve(_problem("custom"), dim=8, particles=1024,
                          iters=50, variant=variant, w=0.7,
                          dtype="bfloat16")
    assert pso_split.fold_publish.bf16_launches == before + 50
    pos = r.state.pos
    assert pos.dtype == BF and float(pos.abs().max()) <= 5.0
    assert r.state.gbest_fit == r.state.pbest_fit.max()
