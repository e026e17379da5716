"""The benchmark's plain reference (``reference.py``) against the port on
the CPU at small sizes: the initial draw and the synchronous and
asynchronous runs of the port's eager engine bit for bit, and the port's
kernel backend (its plain versions here), built-in and user objective, by
the check's numbers."""
import numpy as np
import pytest
import torch

import repro_torch
from pso_bench import check, reference
from pso_bench.spec import load_module
from pso_bench.test_bench_harness import CELLS, small
from pso_bench.workload import Workload
from repro_torch.core.pso import PSOConfig, init_swarm

SEEDS = (0, 7, 2**31 + 5)
BOX = dict(lo=-100.0, hi=100.0, max_v=100.0, w=1.0, c1=2.0, c2=2.0)


def _ref(d, n, block_n=512):
    cfg = dict(BOX, dim=d, particles=n, block_n=block_n)
    return reference.Reference(cfg, "cubic", device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_init_is_the_ports_draw(seed):
    d, n = 3, 256
    got = _ref(d, n).init([seed])
    st = init_swarm(PSOConfig(dim=d, particle_cnt=n, fitness="cubic"), seed,
                    device="cpu")
    assert torch.equal(got.pos[0], st.pos)
    assert torch.equal(got.vel[0], st.vel)
    assert torch.equal(got.pbest_fit[0], st.fit)
    assert torch.equal(got.gbest_pos[0], st.gbest_pos)


def _port(variant, seed, d, n, iters, backend, problem="cubic", **kw):
    return repro_torch.solve(problem, dim=d, particles=n, iters=iters,
                             seed=seed, variant=variant, backend=backend,
                             device="cpu", **kw)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("variant,kw", [
    ("queue_lock", {}), ("async", dict(sync_every=4, block_n=64))])
def test_runs_are_the_ports_eager_engine(variant, kw, seed):
    d, n, iters = 3, 256, 10
    ref = _ref(d, n, kw.get("block_n", 512))
    traffic = dict(variant=variant, sync_every=kw.get("sync_every", 8))
    out = ref.run([seed, seed + 1], iters, traffic)
    for j, s in enumerate((seed, seed + 1)):
        res = _port(variant, s, d, n, iters, "eager", **kw)
        st = res.state
        assert torch.equal(out.pos[j], st.pos)
        assert torch.equal(out.vel[j], st.vel)
        assert torch.equal(out.pbest_pos[j], st.pbest_pos)
        assert torch.equal(out.pbest_fit[j], st.pbest_fit)
        assert torch.equal(out.gbest_pos[j], st.gbest_pos)
        assert float(out.gbest_fit[j]) == res.best_fit


def test_queue_lock_is_the_ports_fused_plain_version():
    d, n, iters = 3, 512, 10
    out = _ref(d, n).run([11], iters, {"variant": "queue_lock"})
    st = _port("queue_lock", 11, d, n, iters, "kernel", block_n=128).state
    torch.testing.assert_close(st.pos, out.pos[0], rtol=2e-6, atol=1e-5)
    torch.testing.assert_close(st.pbest_fit, out.pbest_fit[0], rtol=2e-6,
                               atol=0.0)
    assert torch.equal(st.gbest_fit, out.gbest_fit[0])


@pytest.mark.parametrize("cell", CELLS)
def test_kernel_backend_passes_the_check(cell):
    """Each cell's call, at a small size on the port's plain versions, reads
    the check's numbers within the cell's limits."""
    c = small(cell)
    wl = Workload(c, device="cpu")
    samples = [check.sample_of(s, wl.solve(s)) for s in (3, 4)]
    vals = check.run_check(wl, samples, "cpu")
    assert check.verdict(vals, c.limits), vals


def test_objective64():
    cubic = load_module("objectives", "cubic")
    x = torch.tensor([[100.0, 100.0], [-18.0, 3.5]])
    f, scale = cubic.f64(x)
    assert f[0] == 1.8e6
    f32 = cubic.f32(x).double()
    assert torch.all((f - f32).abs() <= 1e-6 * scale)
    expect = sum(v**3 - 0.8 * v * v - 1000 * v + 8000 for v in (-18.0, 3.5))
    assert float(f[1]) == pytest.approx(expect, rel=1e-12)
    assert np.all(scale.numpy() > np.abs(f.numpy()))
    assert cubic.problem() == "cubic"


def test_the_port_at_d1_is_the_reference_bit_for_bit():
    """At one dimension the port's fused queue-lock (its plain version
    here) makes the reference's operations in the reference's order: the
    final state is the same, and ``state_gap`` reads 0."""
    d, n, iters = 1, 1024, 40
    ref = _ref(d, n, 256)
    out = ref.run([5, 6], iters, {"variant": "queue_lock"})
    for j, seed in enumerate((5, 6)):
        st = _port("queue_lock", seed, d, n, iters, "kernel",
                   block_n=256).state
        assert torch.equal(st.pos, out.pos[j])
        assert torch.equal(st.vel, out.vel[j])
        assert torch.equal(st.pbest_fit, out.pbest_fit[j])
