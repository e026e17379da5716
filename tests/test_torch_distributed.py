"""repro_torch.core.distributed on the CPU: islands as row blocks of one
swarm, against repro.core.distributed.

* The collectives ``_pmax_best`` and ``ring_exchange`` equal the
  reference's, run under ``jax.vmap(axis_name="s")`` on the same inputs,
  exactly (tests/test_islands_ring.py's cases: dense argmax, ties, ±inf,
  NaN, one hop a round, the tie-break converging, NaN never propagating).
* ``init_sharded_swarm`` at k = 1, 2, 4 against the reference's
  ``init_swarm(n, index_offset)`` islands, and bit for bit across k.
* Four islands against the reference on a 4-device mesh (a subprocess with
  ``--xla_force_host_platform_device_count=4``, which writes the
  reference's states to an npz): sync ``queue`` 8 iterations with
  exchange 3 (a remainder round), the async ring 8 iterations with
  exchange 4 and sync_every 2, from the start and from a round that starts
  mid-window. The port runs from the same states, within POS_TOL /
  FIT_TOL (tests/test_torch_core.py's; at most 8 iterations).
* The port's own invariants: one island equals the single-swarm engine
  bit for bit, the ring hop by hop against
  ``repro.kernels.ref.run_islands_ring_oracle`` (each island's gbest and
  owner, the staleness bound, the final flush), a
  remainder tail, the bad sync/exchange combination, elastic checkpoints,
  the fused local step (its plain version here), and ``run_async``'s
  ``index_offset``."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core import pso as jpso
from repro.kernels.ref import run_islands_ring_oracle
from repro_torch import checkpoint as ckpt
from repro_torch.core import distributed as dist
from repro_torch.core import pso
from repro_torch.kernels import ops

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POS_TOL = dict(rtol=2e-6, atol=1e-5)
FIT_TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(d=3, n=256, fit="rastrigin"):
    return (jpso.PSOConfig(dim=d, particle_cnt=n, fitness=fit).resolved(),
            pso.PSOConfig(dim=d, particle_cnt=n, fitness=fit).resolved())


def _assert_close(ts, want: dict, what: str):
    """A port state against the reference's fields (numpy arrays)."""
    for f in ts._fields:
        x = getattr(ts, f)
        if f not in want:
            assert x is None, (what, f)
            continue
        if isinstance(x, int):
            assert x == int(want[f]), (what, f)
            continue
        tol = FIT_TOL if "fit" in f else POS_TOL
        np.testing.assert_allclose(x.numpy(), want[f], **tol,
                                   err_msg=f"{what}: {f}")


def _equal(a, b) -> bool:
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                return False
        elif x != y:
            return False
    return True


# --- the collectives against the reference's under vmap ----------------------

def _jpm(fit, pos):
    return jax.vmap(lambda f, p: jdist._pmax_best(f, p, ("s",)),
                    axis_name="s")(jnp.asarray(fit, jnp.float32),
                                   jnp.asarray(pos, jnp.float32))


def _pm_both(fit, pos):
    want = _jpm(fit, pos)
    got = dist._pmax_best(torch.tensor(np.asarray(fit, np.float32)),
                          torch.tensor(np.asarray(pos, np.float32)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got


def test_pmax_best_matches_dense_argmax_oracle():
    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(2, 9))
        fit = rng.normal(size=n).astype(np.float32)
        pos = rng.normal(size=(n, 3)).astype(np.float32)
        gf, gp = _pm_both(fit, pos)
        w = int(np.argmax(fit))
        np.testing.assert_array_equal(gf.numpy(), np.full(n, fit[w]))
        np.testing.assert_array_equal(gp.numpy(), np.tile(pos[w], (n, 1)))


def test_pmax_best_tie_lowest_index_owns_broadcast():
    gf, gp = _pm_both([2.0, 5.0, 5.0, 5.0], [[0.0], [10.0], [20.0], [30.0]])
    np.testing.assert_array_equal(gf.numpy(), np.full(4, 5.0))
    np.testing.assert_array_equal(gp.numpy(), np.full((4, 1), 10.0))


def test_pmax_best_inf_fits():
    gf, gp = _pm_both([-np.inf, 1.0, np.inf, np.inf],
                      [[0.], [1.], [2.], [3.]])
    np.testing.assert_array_equal(gf.numpy(), np.full(4, np.inf))
    np.testing.assert_array_equal(gp.numpy(), np.full((4, 1), 2.0))
    gf, gp = _pm_both([-np.inf] * 4, [[0.], [1.], [2.], [3.]])
    np.testing.assert_array_equal(gf.numpy(), np.full(4, -np.inf))
    np.testing.assert_array_equal(gp.numpy(), np.zeros((4, 1)))


def test_pmax_best_nan_guard():
    gf, gp = _pm_both([np.nan, 3.0, np.nan, 1.0], [[9.], [1.], [9.], [3.]])
    np.testing.assert_array_equal(gf.numpy(), np.full(4, 3.0))
    np.testing.assert_array_equal(gp.numpy(), np.full((4, 1), 1.0))
    gf, gp = _pm_both([np.nan] * 4, [[7.], [1.], [2.], [3.]])
    np.testing.assert_array_equal(gf.numpy(), np.full(4, -np.inf))
    np.testing.assert_array_equal(gp.numpy(), np.full((4, 1), 7.0))


def _hop_both(f, p, o):
    """One hop on both sides from the same (numpy) inputs; returns the
    port's, after checking it equals the reference's exactly."""
    n = len(f)
    want = jax.vmap(lambda a, b, c: jdist.ring_exchange(a, b, c, "s", n),
                    axis_name="s")(jnp.asarray(f, jnp.float32),
                                   jnp.asarray(p, jnp.float32),
                                   jnp.asarray(o, jnp.int32))
    got = dist.ring_exchange(torch.tensor(np.asarray(f, np.float32)),
                             torch.tensor(np.asarray(p, np.float32)),
                             torch.tensor(np.asarray(o, np.int32)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return tuple(g.numpy() for g in got)


def test_ring_propagates_one_hop_per_round():
    n = 5
    f, p, o = ([9.0, 1.0, 2.0, 3.0, 4.0],
               np.arange(n, dtype=np.float32)[:, None],
               np.arange(n, dtype=np.int32))
    for hop in range(1, n):
        f, p, o = _hop_both(f, p, o)
        np.testing.assert_array_equal(f == 9.0, np.arange(n) <= hop)
    np.testing.assert_array_equal(p, np.zeros((n, 1)))
    np.testing.assert_array_equal(o, np.zeros(n, np.int32))


def test_ring_tie_break_converges_to_lowest_owner():
    n = 4
    f, p, o = (np.full(n, 5.0), np.arange(n, dtype=np.float32)[:, None],
               np.asarray([2, 1, 3, 0], np.int32))
    for _ in range(n - 1):
        f, p, o = _hop_both(f, p, o)
    np.testing.assert_array_equal(o, np.zeros(n, np.int32))
    np.testing.assert_array_equal(p, np.full((n, 1), 3.0))


def test_ring_nan_never_propagates():
    n = 4
    f, p, o = ([np.nan, 1.0, np.nan, 2.0],
               np.arange(n, dtype=np.float32)[:, None],
               np.arange(n, dtype=np.int32))
    for _ in range(n - 1):
        f, p, o = _hop_both(f, p, o)
    np.testing.assert_array_equal(f, np.full(n, 2.0))
    np.testing.assert_array_equal(p, np.full((n, 1), 3.0))


# --- sharded init ---------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 4])
def test_sharded_init_matches_reference_islands(k):
    jcfg, cfg = _cfgs(d=7, n=128, fit="ackley")
    local_n = 128 // k
    isl = [jpso.init_swarm(jcfg, 11, n=local_n, index_offset=s * local_n)
           for s in range(k)]
    got = dist.init_sharded_swarm(cfg, 11, k, device="cpu")
    for f in ("pos", "vel", "pbest_pos"):
        np.testing.assert_allclose(
            getattr(got, f).numpy(),
            np.concatenate([np.asarray(getattr(s, f)) for s in isl]),
            **POS_TOL, err_msg=f)
    np.testing.assert_allclose(
        got.fit.numpy(), np.concatenate([np.asarray(s.fit) for s in isl]),
        **FIT_TOL)
    best = max(isl, key=lambda s: float(s.gbest_fit))
    np.testing.assert_allclose(float(got.gbest_fit), float(best.gbest_fit),
                               **FIT_TOL)
    np.testing.assert_allclose(got.gbest_pos.numpy(),
                               np.asarray(best.gbest_pos), **POS_TOL)


def test_sharded_init_bit_for_bit_across_island_counts():
    _, cfg = _cfgs(d=7, n=128, fit="ackley")
    mono = pso.init_swarm(cfg, 11, device="cpu")
    one = dist.init_sharded_swarm(cfg, 11, 1, device="cpu")
    assert _equal(one, mono)
    four = dist.init_sharded_swarm(cfg, 11, 4, device="cpu")
    for f in ("pos", "vel", "fit", "pbest_pos", "pbest_fit", "gbest_pos",
              "gbest_fit"):
        assert torch.equal(getattr(four, f), getattr(one, f)), f
    with pytest.raises(ValueError, match="divisible"):
        dist.init_sharded_swarm(cfg, 11, 3, device="cpu")


# --- four islands against the reference's 4-device mesh ------------------------

_MESH_SCRIPT = r"""
import sys
import jax, numpy as np
from repro.core import PSOConfig
from repro.core.distributed import init_sharded_swarm, make_distributed_run

cfg = PSOConfig(dim=3, particle_cnt=256, fitness="rastrigin").resolved()
mesh = jax.make_mesh((4,), ("data",))
st = init_sharded_swarm(cfg, 0, mesh)
out = {}

def put(prefix, s):
    for f in s._fields:
        v = getattr(s, f)
        if v is not None:
            out[prefix + f] = np.asarray(v)

ring = make_distributed_run(cfg, mesh, iters=8, variant="async",
                            exchange_interval=4, sync_every=2)
put("init.", st)
put("sync.", make_distributed_run(cfg, mesh, iters=8, variant="queue",
                                  exchange_interval=3)(st))
put("ring.", ring(st))
mid = make_distributed_run(cfg, mesh, iters=3, variant="queue",
                           exchange_interval=3)(st)
put("mid_in.", mid)
put("mid.", ring(mid))
out["devices"] = np.asarray(len(jax.devices()))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh") / "runs.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _MESH_SCRIPT, path], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(path) as z:
        runs = {k: z[k] for k in z.files}
    assert int(runs["devices"]) == 4
    return runs


def _fields(runs, prefix):
    return {k[len(prefix):]: v for k, v in runs.items()
            if k.startswith(prefix)}


def test_four_island_init_matches_the_mesh(mesh_runs):
    _, cfg = _cfgs()
    got = dist.init_sharded_swarm(cfg, 0, 4, device="cpu")
    _assert_close(got, _fields(mesh_runs, "init."), "init")


@pytest.mark.parametrize("case,start,variant,iters,exchange,sync_every", [
    ("sync", "init", "queue", 8, 3, 8),
    ("ring", "init", "async", 8, 4, 2),
    ("mid", "mid_in", "async", 8, 4, 2),
])
def test_four_islands_match_the_mesh(mesh_runs, case, start, variant, iters,
                                     exchange, sync_every):
    """From the reference's own starting state; "mid" starts the ring at
    iteration 3, mid-window, where the reference's rounds run their
    schedule from the round's start (``phase=0``)."""
    _, cfg = _cfgs()
    s0 = pso.state_from_numpy(_fields(mesh_runs, start + "."), device="cpu")
    runner = dist.make_distributed_run(cfg, 4, iters, variant, exchange,
                                       sync_every=sync_every)
    _assert_close(runner(s0), _fields(mesh_runs, case + "."), case)


def test_single_global_gbest_would_not_match_the_mesh(mesh_runs):
    """The islands' stale gbests matter: one swarm of 256 run the same 8
    iterations (one gbest for all) leaves the reference's sync islands."""
    _, cfg = _cfgs()
    s0 = pso.state_from_numpy(_fields(mesh_runs, "init."), device="cpu")
    one = pso.run(cfg, s0, 8, "queue")
    want = _fields(mesh_runs, "sync.")
    assert not np.allclose(one.pos.numpy(), want["pos"], **POS_TOL)


# --- the port's invariants ---------------------------------------------------------

def test_one_island_sync_equals_single_swarm():
    _, cfg = _cfgs(d=4, n=64, fit="sphere")
    st = dist.init_sharded_swarm(cfg, 0, 1, device="cpu")
    for exchange in (1, 4):
        out = dist.make_distributed_run(cfg, 1, 25, "queue", exchange)(st)
        assert _equal(out, pso.run(cfg, pso.init_swarm(cfg, 0, device="cpu"),
                                   25, "queue"))


@pytest.mark.parametrize("iters,exchange,sync", [(24, 8, 4), (20, 5, 5),
                                                 (23, 8, 4)])
def test_one_island_ring_equals_run_async(iters, exchange, sync):
    """The reference's acceptance identity: one island's ring is run_async
    bit for bit, but for the locals after a non-scheduled tail flush (the
    ring pulls the published best into the blocks)."""
    _, cfg = _cfgs(d=4, n=128)
    st = dist.init_sharded_swarm(cfg, 7, 1, device="cpu")
    out = dist.make_distributed_run(cfg, 1, iters, "async", exchange,
                                    sync_every=sync)(st)
    ref = pso.run_async(cfg, pso.init_swarm(cfg, 7, device="cpu"), iters,
                        sync_every=sync, n_blocks=out.lbest_fit.shape[0])
    skip = ("lbest_pos", "lbest_fit") if iters % exchange else ()
    for f in out._fields:
        if f in skip:
            continue
        x, y = getattr(out, f), getattr(ref, f)
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y), f
    assert float(out.gbest_fit) == float(out.pbest_fit.max())


def _reference_islands_state(jcfg, seed: int, k: int):
    """The oracle's starting state as one global port state: the
    reference's ``init_swarm(n, index_offset)`` islands concatenated, gbest
    the first island's of the max (``_pmax_best``'s rule)."""
    local_n = jcfg.particle_cnt // k
    isl = [jpso.init_swarm(jcfg, seed, n=local_n, index_offset=s * local_n)
           for s in range(k)]
    win = int(np.argmax([float(s.gbest_fit) for s in isl]))
    fields = {f: np.concatenate([np.asarray(getattr(s, f)) for s in isl])
              for f in ("pos", "vel", "fit", "pbest_pos", "pbest_fit")}
    fields.update(gbest_pos=np.asarray(isl[win].gbest_pos),
                  gbest_fit=np.asarray(isl[win].gbest_fit), iteration=0,
                  seed=seed)
    return pso.state_from_numpy(fields, device="cpu")


def test_ring_matches_the_oracle_island_by_island():
    """Four islands, 8 iterations from the oracle's own starting state,
    hop by hop (``ring_rounds``): after every round and drain hop each
    island's gbest agrees with the eager oracle's within FIT_TOL and its
    owner exactly; a round-r best reaches the island d hops downstream by
    round r + d (every island within n_shards rounds); after the drain
    every island's gbest is the max over all pbests."""
    k = 4
    jcfg, cfg = _cfgs()
    _, want = run_islands_ring_oracle(jcfg, 0, k, 8, 4, sync_every=2)
    hops = list(dist.ring_rounds(cfg, _reference_islands_state(jcfg, 0, k),
                                 k, 8, 4, 2))[1:]
    hist = [[(float(s.gbest_fit), int(o)) for s, o in zip(isl, owner)]
            for isl, owner in hops]
    assert len(hist) == len(want) == 2 + k - 1
    for r, (got_r, want_r) in enumerate(zip(hist, want)):
        for (gf, go), (wf, wo) in zip(got_r, want_r):
            np.testing.assert_allclose(gf, wf, **FIT_TOL, err_msg=str(r))
            assert go == wo, (r, got_r, want_r)
    for r in range(len(hist)):
        for i in range(k):
            for d in range(1, k):
                if r + d < len(hist):
                    assert hist[r + d][(i + d) % k][0] >= hist[r][i][0]
    islands = hops[-1][0]
    top = max(float(s.pbest_fit.max()) for s in islands)
    assert all(float(s.gbest_fit) == top for s in islands)


def test_sync_remainder_tail_vs_divisible():
    """On one island the exchange is a no-op: a schedule with a remainder
    round equals the divisible one and the plain run, bit for bit."""
    _, cfg = _cfgs(d=3, n=64, fit="sphere")
    st = dist.init_sharded_swarm(cfg, 1, 1, device="cpu")
    div = dist.make_distributed_run(cfg, 1, 24, "queue", 8)(st)
    ndiv = dist.make_distributed_run(cfg, 1, 24, "queue", 7)(st)
    assert div.iteration == ndiv.iteration == 24
    assert _equal(div, ndiv)
    assert _equal(div, pso.run(cfg, st, 24, "queue"))


def test_async_ring_rejects_bad_sync_exchange_combo():
    _, cfg = _cfgs(d=2, n=64, fit="cubic")
    with pytest.raises(ValueError, match="divide"):
        dist.make_distributed_run(cfg, 1, 12, "async", 6, sync_every=4)
    with pytest.raises(NotImplementedError, match="local_step_fn"):
        dist.make_distributed_run(cfg, 1, 12, "async", 4, sync_every=4,
                                  local_step_fn=ops.make_fused_local_step())


@pytest.mark.parametrize("k_after", [1, 2])
def test_elastic_checkpoint_resumes_at_another_island_count(tmp_path,
                                                            k_after):
    """Four islands' global arrays checkpointed, restored and continued
    on 1 or 2 islands: the restored state is the saved one bit for bit, a
    one-island continuation is the plain run's, and the search goes on."""
    _, cfg = _cfgs(d=3, n=64, fit="cubic")
    st = dist.make_distributed_run(cfg, 4, 10, "queue", 5)(
        dist.init_sharded_swarm(cfg, 4, 4, device="cpu"))
    ckpt.save(str(tmp_path), 10, dist.gather_swarm(st))
    step, restored = ckpt.restore_latest(str(tmp_path), ckpt.stand_ins(st),
                                         device="cpu")
    assert step == 10 and _equal(restored, st)
    cont = dist.make_distributed_run(cfg, k_after, 10, "queue", 5)(restored)
    assert cont.iteration == 20
    assert float(cont.gbest_fit) >= float(st.gbest_fit)
    assert float(cont.gbest_fit) == float(cont.pbest_fit.max())
    if k_after == 1:
        assert _equal(cont, pso.run(cfg, restored, 10, "queue"))


def test_fused_local_step_under_islands():
    """The fused kernel as every island's local step (its plain version on
    the CPU) is synchronous PPSO, i.e. the eager queue step: four islands
    of it agree with the eager islands within the step tolerance, and the
    fused islands keep their gbest at the max pbest."""
    _, cfg = _cfgs(d=2, n=512, fit="sphere")
    st = dist.init_sharded_swarm(cfg, 6, 4, device="cpu")
    fused = dist.make_distributed_run(
        cfg, 4, 8, "queue_lock", 2,
        local_step_fn=ops.make_fused_local_step(iters_per_call=1))(st)
    eager = dist.make_distributed_run(cfg, 4, 8, "queue", 2)(st)
    np.testing.assert_allclose(fused.pos.numpy(), eager.pos.numpy(),
                               **POS_TOL)
    np.testing.assert_allclose(fused.pbest_fit.numpy(),
                               eager.pbest_fit.numpy(), **FIT_TOL)
    assert float(fused.gbest_fit) == float(fused.pbest_fit.max())
    assert float(fused.gbest_fit) >= float(st.gbest_fit)
    two = dist.make_distributed_run(
        cfg, 4, 4, "queue_lock", 2,
        local_step_fn=ops.make_fused_local_step(iters_per_call=2))(st)
    assert two.iteration == 8                 # 2 calls x 2 iterations a round


def test_gather_swarm_is_a_host_copy():
    _, cfg = _cfgs(d=2, n=64)
    st = dist.init_sharded_swarm(cfg, 0, 2, device="cpu")
    g = dist.gather_swarm(st)
    assert _equal(g, st)
    assert g.pos.data_ptr() != st.pos.data_ptr()


# --- run_async's index_offset and phase ------------------------------------------

def test_run_async_index_offset_zero_is_the_default_run():
    _, cfg = _cfgs(d=3, n=1024)
    s0 = pso.init_swarm(cfg, 2, device="cpu")
    base = pso.run_async(cfg, s0, 12, sync_every=4)
    assert _equal(pso.run_async(cfg, s0, 12, sync_every=4, index_offset=0),
                  base)
    # phase=None reads the window from the iteration: at iteration 0 that
    # is phase 0
    assert _equal(pso.run_async(cfg, s0, 12, sync_every=4, phase=0), base)
    part = pso.run_async(cfg, s0, 3, sync_every=4)
    assert _equal(pso.run_async(cfg, part, 9, sync_every=4, phase=3),
                  pso.run_async(cfg, part, 9, sync_every=4))


@pytest.mark.parametrize("offset,phase", [(0, None), (512, None), (768, 0)])
def test_run_async_index_offset_matches_reference(offset, phase):
    """8 iterations of one island of 256 particles at ``offset``, from a
    state 3 iterations in (so ``phase=0`` moves the schedule), against the
    reference's ``run_async(index_offset=, phase=)`` from the same state."""
    jcfg, cfg = _cfgs(d=3, n=256)
    js = jpso.run(jcfg, jpso.init_swarm(jcfg, 5, n=256, index_offset=offset),
                  3, "queue")
    want = jpso.run_async(jcfg, js, 8, sync_every=2, index_offset=offset,
                          phase=phase)
    s0 = pso.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in js._fields
         if getattr(js, f) is not None}, device="cpu")
    got = pso.run_async(cfg, s0, 8, sync_every=2, index_offset=offset,
                        phase=phase)
    _assert_close(got, {f: np.asarray(getattr(want, f)) for f in want._fields
                        if getattr(want, f) is not None}, "run_async")
