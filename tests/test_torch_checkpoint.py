"""repro_torch.checkpoint and repro_torch.runtime on the CPU: the reference's
checkpoint tests (tests/test_checkpoint.py) case for case on the port, and
checkpoint files interchanged with repro.checkpoint in both directions.

Resumes are held bit for bit against the uninterrupted run (the counter
RNG makes a run a function of its state), as in the reference. A file
written by either package restores in the other bit for bit, counters
included (the port keeps iteration and seed as ints, the reference as
int32 and uint32), and both write the same manifest keys."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.core import pso as jpso
from repro_torch import checkpoint as ckpt
from repro_torch.core import (PSOConfig, batch_row, init_batch, init_swarm,
                              run, run_async, run_many, stack_states)
from repro_torch.core.pso import SwarmState

torch.set_num_threads(1)


def _tree():
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.ones(5, dtype=torch.bfloat16)},
            "step_count": torch.tensor(7, dtype=torch.int32)}


def _leaves(tree):
    return [x for _, x in ckpt.checkpointer._leaves(tree)]


def _assert_states_equal(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f
        else:
            assert x == y, f


def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path)
    tree = _tree()
    ckpt.save(d, 3, tree)
    assert ckpt.latest_step(d) == 3
    out = ckpt.restore(d, 3, tree)
    for a, b in zip(_leaves(out), _leaves(tree)):
        assert torch.equal(a.float(), b.float())
        assert a.dtype == b.dtype


def test_latest_and_prune(tmp_path):
    d = str(tmp_path)
    tree = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, tree)
    assert ckpt.latest_step(d) == 5
    ckpt.prune(d, keep=2)
    assert ckpt.latest_step(d) == 5
    assert ckpt.restore_latest(d, tree)[0] == 5
    with pytest.raises(FileNotFoundError):
        ckpt.restore(d, 1, tree)


def test_incomplete_checkpoint_ignored(tmp_path):
    """A dir without manifest (simulated crash mid-write) is not 'latest'."""
    d = str(tmp_path)
    ckpt.save(d, 1, _tree())
    os.makedirs(os.path.join(d, "step_00000009"))  # torn write, no manifest
    assert ckpt.latest_step(d) == 1


def test_shape_mismatch_rejected(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree())
    bad = dict(_tree(), w=torch.zeros((2, 2)))
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.restore(d, 1, bad)


def test_pso_crash_restart_bit_exact(tmp_path):
    """Run 30 iters; 'crash'; resume from the step-10 checkpoint: the
    trajectory is the uninterrupted one bit for bit."""
    d = str(tmp_path)
    cfg = PSOConfig(dim=5, particle_cnt=64, fitness="rastrigin").resolved()
    s = init_swarm(cfg, 3, device="cpu")
    s10 = run(cfg, s, 10, "queue")
    ckpt.save(d, 10, s10)
    full = run(cfg, s10, 20, "queue")          # uninterrupted continuation
    # --- crash happens here; a new process restores from stand-ins:
    step, restored = ckpt.restore_latest(d, ckpt.stand_ins(s10),
                                         device="cpu")
    assert step == 10 and isinstance(restored, SwarmState)
    resumed = run(cfg, restored, 20, "queue")
    assert torch.equal(full.pos, resumed.pos)
    assert float(full.gbest_fit) == float(resumed.gbest_fit)


def test_async_checkpoint_resume_bit_exact_at_chunk_boundary(tmp_path):
    """The checkpoint carries the block-local bests, so resuming at a chunk
    boundary is the uninterrupted run bit for bit."""
    d = str(tmp_path)
    cfg = PSOConfig(dim=3, particle_cnt=128, fitness="rastrigin").resolved()
    s0 = init_swarm(cfg, 9, device="cpu")
    full = run_async(cfg, s0, 32, sync_every=4, n_blocks=4)
    s16 = run_async(cfg, s0, 16, sync_every=4, n_blocks=4)
    assert s16.lbest_fit is not None and tuple(s16.lbest_fit.shape) == (4,)
    ckpt.save(d, 16, s16)
    step, restored = ckpt.restore_latest(d, ckpt.stand_ins(s16),
                                         device="cpu")
    assert step == 16
    assert restored.lbest_fit is not None         # locals survived the disk
    resumed = run_async(cfg, restored, 16, sync_every=4, n_blocks=4)
    _assert_states_equal(full, resumed)


def test_async_resume_mid_window_keeps_publication_schedule():
    """Resuming off the sync grid keeps publish points on absolute
    iteration numbers, and the tail flush publishes without resetting the
    blocks: bit for bit the uninterrupted run."""
    # 1024 particles: two blocks, so the locals are real
    cfg = PSOConfig(dim=2, particle_cnt=1024, fitness="cubic").resolved()
    s0 = init_swarm(cfg, 4, device="cpu")
    full = run_async(cfg, s0, 20, sync_every=8)
    part = run_async(cfg, s0, 6, sync_every=8)   # 20 = 6 + 14, off the grid
    assert float(part.gbest_fit) == float(part.pbest_fit.max())
    resumed = run_async(cfg, part, 14, sync_every=8)
    _assert_states_equal(full, resumed)
    resumed2 = run(cfg, part, 14, "async", sync_every=8)
    assert torch.equal(full.pos, resumed2.pos)


def test_batched_async_resume_bit_exact_any_boundary():
    """A batched async solve split at a chunk boundary or mid-window is the
    uninterrupted batched run bit for bit, and each row the single-swarm
    resume."""
    cfg = PSOConfig(dim=2, particle_cnt=1024, fitness="cubic").resolved()
    b0 = init_batch(cfg, list(range(8)), device="cpu")
    for split in (8, 6):
        full = run_many(cfg, b0, 20, "async", sync_every=8)
        part = run_many(cfg, b0, split, "async", sync_every=8)
        assert tuple(part.lbest_fit.shape) == (8, 2)
        resumed = run_many(cfg, part, 20 - split, "async", sync_every=8)
        for f in full._fields:
            assert torch.equal(getattr(full, f), getattr(resumed, f)), (
                f, split)
        single = run_async(cfg, batch_row(part, 3), 20 - split, sync_every=8)
        assert torch.equal(resumed.pos[3], single.pos)


def test_batched_async_resume_mixed_phases():
    """Rows checkpointed at different iterations resume each on its own
    schedule: every row equals its standalone continuation."""
    cfg = PSOConfig(dim=2, particle_cnt=1024, fitness="cubic").resolved()
    states = [run_async(cfg, init_swarm(cfg, sd, device="cpu"), pre,
                        sync_every=8)
              for sd, pre in zip(range(6), (3, 6, 11, 3, 6, 11))]
    batch = stack_states(states)
    out = run_many(cfg, batch, 9, "async", sync_every=8)
    for i in range(6):
        single = run_async(cfg, batch_row(batch, i), 9, sync_every=8)
        for f in ("pos", "pbest_fit", "gbest_fit", "lbest_fit"):
            assert torch.equal(getattr(out, f)[i], getattr(single, f)), (
                i, f)


def test_step_runner_retry_and_resume(tmp_path):
    """StepRunner recovers from a transient failure via its checkpoint."""
    from repro_torch.runtime import RunnerConfig, StepRunner
    calls = {"n": 0}

    def flaky_step(state, step):
        calls["n"] += 1
        if calls["n"] == 7:                       # one transient device loss
            raise RuntimeError("simulated device failure")
        return {k: v + 1 for k, v in state.items()}

    runner = StepRunner(RunnerConfig(str(tmp_path), ckpt_interval=2,
                                     backoff_s=0.0), flaky_step)
    out = runner.run({"x": torch.zeros(())}, 0, 10)
    assert float(out["x"]) == 10.0                # all 10 steps applied
    assert ckpt.latest_step(str(tmp_path)) == 10


def test_suggest_checkpoint_interval_matches_reference():
    from repro.runtime import suggest_checkpoint_interval as jsuggest
    from repro_torch.runtime import suggest_checkpoint_interval
    for args in ((0.01, 24.0, 2.0), (1.5, 0.5, 30.0), (1e-12, 1.0, 1.0)):
        assert suggest_checkpoint_interval(*args) == jsuggest(*args)


# --- interchange with repro.checkpoint ---------------------------------------

SEED = 3_000_000_000          # above 2**31: must survive the uint32/int64 trip


def _ref_async_state():
    cfg = jpso.PSOConfig(dim=3, particle_cnt=256, fitness="rastrigin")
    return jpso.run_async(cfg, jpso.init_swarm(cfg, np.uint32(SEED)), 6,
                          sync_every=4)


def _port_async_state():
    cfg = PSOConfig(dim=3, particle_cnt=256, fitness="rastrigin")
    return run_async(cfg, init_swarm(cfg, SEED, device="cpu"), 6,
                     sync_every=4)


def test_reference_file_restores_in_the_port(tmp_path):
    d = str(tmp_path)
    ref = _ref_async_state()
    jckpt.save(d, 6, ref)
    jckpt.save(d, 7, {"w": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
                      "nested": {"b": jnp.full((5,), 1.5, jnp.bfloat16)},
                      "step_count": jnp.asarray(7, jnp.int32)})
    got = ckpt.restore(d, 6, ckpt.stand_ins(_port_async_state()),
                       device="cpu")
    for f in ref._fields:
        want = np.asarray(getattr(ref, f))
        x = getattr(got, f)
        if isinstance(x, int):
            assert x == int(want), f
        else:
            np.testing.assert_array_equal(x.numpy(), want, err_msg=f)
            assert x.dtype == torch.float32, f
    assert got.seed == SEED and got.iteration == 6
    tree = ckpt.restore(d, 7, _tree())
    assert tree["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(tree["nested"]["b"].float(), torch.full((5,), 1.5))
    assert torch.equal(tree["w"], _tree()["w"])
    assert tree["step_count"].dtype == torch.int32
    assert int(tree["step_count"]) == 7


def test_port_file_restores_in_the_reference(tmp_path):
    d = str(tmp_path)
    mine = _port_async_state()
    ckpt.save(d, 6, mine)
    ckpt.save(d, 7, _tree())
    got = jckpt.restore(d, 6, jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), _ref_async_state()))
    for f in mine._fields:
        x = getattr(mine, f)
        want = np.asarray(x) if isinstance(x, int) else x.numpy()
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), want,
                                      err_msg=f)
    assert got.seed.dtype == jnp.uint32 and int(got.seed) == SEED
    assert got.iteration.dtype == jnp.int32 and int(got.iteration) == 6
    tmpl = {"w": jnp.zeros((3, 4), jnp.float32),
            "nested": {"b": jnp.zeros((5,), jnp.bfloat16)},
            "step_count": jnp.asarray(0, jnp.int32)}
    tree = jckpt.restore(d, 7, tmpl)
    assert tree["nested"]["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(tree["nested"]["b"], np.float32),
                                  np.ones(5, np.float32))
    np.testing.assert_array_equal(np.asarray(tree["w"]),
                                  np.arange(12, dtype=np.float32).reshape(3, 4))


def test_manifests_have_the_reference_keys_and_paths(tmp_path):
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    os.makedirs(a)                 # the reference writes into an existing dir
    jckpt.save(a, 6, _ref_async_state())
    ckpt.save(b, 6, _port_async_state())
    ma, mb = (json.load(open(os.path.join(x, "step_00000006",
                                          "manifest.json"))) for x in (a, b))
    assert set(ma) == set(mb)
    assert ma["paths"] == mb["paths"]
    assert set(ma["dtypes"]) == set(mb["dtypes"])
    with np.load(os.path.join(a, "step_00000006", "shard_0.npz")) as za, \
            np.load(os.path.join(b, "step_00000006", "shard_0.npz")) as zb:
        assert set(za.files) == set(zb.files)
