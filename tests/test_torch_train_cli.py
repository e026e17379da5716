"""``python -m repro_torch.launch.train`` on the CPU (subprocesses, smoke
size) and checkpoints of a training state.

The CLI: a run interrupted after its step-3 checkpoint and resumed prints
the same step lines and final loss as an uninterrupted run (the data
pipeline and the train step are functions of the step and the state), and
without ``--device`` and without a card it exits 2 with the device error.
A ``(params, OptState)`` state saved by ``repro_torch.checkpoint`` restores
in ``repro.checkpoint`` bit for bit, and the other way round (bfloat16
leaves, the int32 step and adafactor's per-leaf dicts included). No
tolerance: equal strings and bits.
"""
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_arch
from repro_torch.models import zoo
from repro_torch.optim import OptState, get_optimizer
from repro_torch.optim.optimizers import tree_leaves, tree_unflatten

try:
    import jax
    import jax.numpy as jnp

    from repro import checkpoint as jckpt
    from repro import optim as j_optim
except ModuleNotFoundError:     # a CUDA host may have no JAX installed
    jax = None

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
ARGS = ["--arch", "stablelm-3b", "--smoke", "--steps", "6", "--batch", "2",
        "--seq", "32", "--log-interval", "1"]


def _train(args, device="cpu", timeout=300):
    dev = ["--device", device] if device else []
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args, *dev],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=timeout)


def _lines(r):
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip().splitlines()


def test_train_cli_resume_equals_uninterrupted(tmp_path):
    whole = _lines(_train(ARGS))
    assert len(whole) == 7 and whole[0].startswith("step     0 loss ")
    assert whole[-1].startswith("final loss: ")
    full = str(tmp_path / "full")
    _lines(_train(ARGS + ["--ckpt-dir", full, "--ckpt-interval", "3"]))
    assert ckpt.latest_step(full) == 6
    # a crash after step 3's checkpoint leaves only that one behind
    cut = str(tmp_path / "cut")
    os.makedirs(cut)
    shutil.copytree(os.path.join(full, "step_00000003"),
                    os.path.join(cut, "step_00000003"))
    resumed = _lines(_train(ARGS + ["--ckpt-dir", cut, "--ckpt-interval",
                                    "3"]))
    assert resumed[:3] == whole[3:6]           # steps 3, 4, 5
    assert resumed[-1].split(" (")[0] == whole[-1].split(" (")[0]


def test_train_cli_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card error cannot occur")
    r = _train(ARGS, device=None)
    assert r.returncode == 2
    assert "device='cpu'" in r.stderr
    assert "final loss" not in r.stdout


# --- checkpoints of a training state, across the two packages -----------------

def _state(name):
    """(params, OptState) of a smoke arch in bfloat16, after the optimizer
    moved its state once (nonzero moments, step 1)."""
    cfg = get_arch(name).smoke()
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    params = zoo.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    init, update = get_optimizer(cfg.optimizer)
    grads = [torch.randn(p.shape, generator=torch.Generator().manual_seed(i)
                         ).to(p.dtype) for i, p in enumerate(
                             tree_leaves(params))]
    params, state = update(params, tree_unflatten(params, grads),
                           init(params), 1e-3)
    return params, state


def _jax_template(tree):
    return jax.tree.map(lambda t: jnp.zeros(tuple(t.shape), {
        torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
        torch.int32: jnp.int32}[t.dtype]), tree)


def _as_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("name", ["stablelm-3b", "arctic-480b"])
def test_train_state_checkpoint_interchanges(tmp_path, name):
    if jax is None:
        pytest.skip("needs the JAX reference package `repro`, and JAX is "
                    "not installed")
    params, state = _state(name)
    tree = (params, state)
    ours = str(tmp_path / "ours")
    ckpt.save(ours, 1, tree)
    j_tmpl = (_jax_template(params),
              j_optim.OptState(jnp.zeros((), jnp.int32),
                               _jax_template(state.inner)))
    back = jckpt.restore(ours, 1, j_tmpl)
    got = jax.tree.leaves(back)
    want = [_as_numpy(x) for _, x in ckpt.checkpointer._leaves(tree)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a), b)
    theirs = str(tmp_path / "theirs")
    os.makedirs(theirs)
    jckpt.save(theirs, 2, back)
    again = ckpt.restore(theirs, 2, ckpt.stand_ins(tree), device="cpu")
    assert isinstance(again[1], OptState)
    for (_, a), (_, b) in zip(ckpt.checkpointer._leaves(again),
                              ckpt.checkpointer._leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
