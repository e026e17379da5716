"""repro_torch.launch.pso_run on the CPU (subprocesses, small sizes): the
reference's CLI tests (tests/test_cli.py, tests/test_islands_ring.py,
tests/test_constraints.py) with ``--device cpu``, checkpoints a chunk that
restore and continue bit for bit, and the no-card error without
``--device``."""
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.core import PSOConfig, init_swarm
from repro_torch.kernels import ops

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))


def _run(args, device="cpu", timeout=300):
    dev = ["--device", device] if device else []
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.pso_run", *args, *dev],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=timeout)


def test_pso_run_cli():
    r = _run(["--dim", "2", "--particles", "256", "--iters", "100",
              "--variant", "queue_lock"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "gbest_fit=" in r.stdout
    assert "us/iter" in r.stdout


def test_pso_run_cli_islands():
    r = _run(["--dim", "3", "--particles", "128", "--iters", "40",
              "--islands", "1", "--exchange", "10"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "gbest_fit=" in r.stdout


@pytest.mark.parametrize("islands,extra", [
    ("4", ["--dim", "3", "--particles", "256", "--iters", "30",
           "--exchange", "10", "--sync-every", "5"]),
    ("1", ["--dim", "2", "--particles", "128", "--iters", "20",
           "--exchange", "5"]),
])
def test_pso_run_cli_islands_async(islands, extra):
    """``--islands N --variant async``: the island ring, here four islands
    on the one device (the reference needs four devices for it)."""
    r = _run(["--variant", "async", "--islands", islands, *extra])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "gbest_fit=" in r.stdout


def test_pso_run_cli_kernel_islands_and_refusals():
    r = _run(["--dim", "3", "--particles", "128", "--iters", "8", "--kernel",
              "--islands", "2", "--exchange", "4", "--variant",
              "queue_lock"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "kernel launches:" in r.stdout
    r = _run(["--iters", "4", "--kernel", "--islands", "2", "--variant",
              "async"])
    assert r.returncode != 0 and "does not support --variant async" in r.stderr
    r = _run(["--iters", "4", "--kernel", "--variant", "queue"])
    assert r.returncode != 0 and "implements queue_lock/async" in r.stderr


def test_pso_run_cli_constrained():
    r = _run(["--dim", "3", "--particles", "64", "--iters", "30",
              "--fitness", "sphere", "--constraint", "simplex",
              "--constraint-mode", "projection"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "feasible=True" in r.stdout


@pytest.mark.parametrize("variant", ["queue_lock", "async"])
def test_pso_run_cli_checkpoints_restore_and_continue(tmp_path, variant):
    """``--kernel --ckpt-dir --ckpt-every 10``: a checkpoint a chunk; the
    step-20 one restored and run 10 more iterations by the same kernel
    function is the step-30 one bit for bit."""
    d = str(tmp_path)
    r = _run(["--dim", "3", "--particles", "128", "--iters", "30",
              "--kernel", "--variant", variant, "--sync-every", "5",
              "--ckpt-dir", d, "--ckpt-every", "10", "--seed", "3"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert sorted(os.listdir(d)) == [f"step_{k:08d}" for k in (10, 20, 30)]
    cfg = PSOConfig(dim=3, particle_cnt=128).resolved()
    s = init_swarm(cfg, 3, device="cpu")
    if variant == "async":
        s = ops.run_queue_lock_fused_async(cfg, s, 10, sync_every=5)
    tmpl = ckpt.stand_ins(s)
    s20 = ckpt.restore(d, 20, tmpl, device="cpu")
    s30 = ckpt.restore(d, 30, tmpl, device="cpu")
    assert s20.iteration == 20 and s30.iteration == 30 and s30.seed == 3
    if variant == "async":
        cont = ops.run_queue_lock_fused_async(cfg, s20, 10, sync_every=5)
    else:
        cont = ops.run_queue_lock_fused(cfg, s20, 10)
    for f in s30._fields:
        x, y = getattr(cont, f), getattr(s30, f)
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y), f


def test_pso_run_cli_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card error cannot occur")
    r = _run(["--dim", "2", "--particles", "64", "--iters", "3"],
             device=None)
    assert r.returncode != 0
    assert "device='cpu'" in r.stderr
    assert "gbest_fit=" not in r.stdout
