"""The check fails what it must, at a small size on the CPU: the control
(the same solves in bfloat16, the program's lower-precision path) and the
faults a solve can have, planted under the timed path: a run that returns
its state unchanged, half the particles left out (gbest taken over the
rest), an answer altered where it is produced, and a wrong update (the
second draw used for both terms, the cognitive term left out). Half the
iterations left out is no fault of the answer: both cells reach their
fixed point (every particle at the optimum's corner, its velocity frozen)
well before the half, so the state after the half is the state after the
whole, bit for bit."""
import dataclasses
import time

import pytest
import torch

from pso_bench import check, control, harness, reference
from pso_bench.test_bench_harness import CELLS, small
from repro_torch.core import rng
from repro_torch.kernels import ops


def _run(cell, **kw):
    out, _ = harness.run_cell(small(cell), 2**31 + 41, 0.3, False,
                              time.perf_counter(), device="cpu", **kw)
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell):
    out = _run(cell, dtype="bfloat16")
    assert not out["correct"], out["check"]


def _unchanged(real):
    def run(cfg, state, iters, variant, **kw):
        return state, (None, None), None
    return run


def _half(real):
    """The first half of the particles advanced, the rest left as they
    were; gbest the advanced half's."""
    def run(cfg, state, iters, variant, **kw):
        h = state.pos.shape[0] // 2
        first = state._replace(**{f: getattr(state, f)[:h] for f in (
            "pos", "vel", "fit", "pbest_pos", "pbest_fit")},
            lbest_pos=None, lbest_fit=None)
        kw["block_n"] = h // 2
        done, hist, cnt = real(cfg, first, iters, variant, **kw)
        joined = done._replace(**{f: torch.cat([getattr(done, f),
                                                getattr(state, f)[h:]])
                                  for f in ("pos", "vel", "fit", "pbest_pos",
                                            "pbest_fit")},
                               lbest_pos=None, lbest_fit=None)
        return joined, hist, cnt
    return run


def _altered(real):
    def run(cfg, state, iters, variant, **kw):
        done, hist, cnt = real(cfg, state, iters, variant, **kw)
        return done._replace(gbest_fit=done.gbest_fit * 1.001), hist, cnt
    return run


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_fails(monkeypatch, cell, fault):
    monkeypatch.setattr(ops, "run_queue_lock", fault(ops.run_queue_lock))
    out = _run(cell)
    assert not out["correct"], out["check"]


def test_a_nan_fails(monkeypatch):
    def nan_fit(real):
        def run(cfg, state, iters, variant, **kw):
            done, hist, cnt = real(cfg, state, iters, variant, **kw)
            return done._replace(
                pbest_fit=torch.full_like(done.pbest_fit, float("nan"))), \
                hist, cnt
        return run
    monkeypatch.setattr(ops, "run_queue_lock", nan_fit(ops.run_queue_lock))
    assert not _run(CELLS[0])["correct"]


def _c1_dropped(real):
    def run(cfg, state, iters, variant, **kw):
        return real(dataclasses.replace(cfg, c1=0.0), state, iters, variant,
                    **kw)
    return run


#: Cells whose numbers follow each particle's trajectory element by element.
TRAJECTORY = [c for c in CELLS if "state_gap" in small(c).limits]


@pytest.mark.parametrize("cell", TRAJECTORY)
def test_a_wrong_update_fails(monkeypatch, cell):
    monkeypatch.setattr(ops, "run_queue_lock", _c1_dropped(ops.run_queue_lock))
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", TRAJECTORY)
def test_one_draw_for_both_terms_fails(monkeypatch, cell):
    real = rng.uniform

    def same(seed, it, stream, idx, **kw):
        return real(seed, it, rng_r2 if stream == rng_r1 else stream, idx,
                    **kw)
    rng_r1, rng_r2 = reference.STREAM_R1, reference.STREAM_R2
    monkeypatch.setattr(rng, "uniform", same)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_second_half_of_the_iterations_changes_nothing(cell):
    """The reference's state after half the iterations is its state after
    all of them: the fixed point."""
    c = small(cell)
    ref = reference.Reference(c.config, c.objective)
    iters = int(c.config["iters"])
    half = ref.run([2**31 + 3], iters // 2, c.traffic)
    whole = ref.run([2**31 + 3], iters, c.traffic)
    for k in ("pos", "vel", "pbest_pos", "pbest_fit", "gbest_fit"):
        assert torch.equal(getattr(half, k), getattr(whole, k)), k


@pytest.mark.parametrize("fault", control.FAULTS)
def test_the_faults_planted_in_the_reference(fault):
    """``control.py``'s faults, at a small size: a wrong update moves the
    state, half the iterations leave it as it was."""
    c = small(TRAJECTORY[0])
    seeds = [2**31 + 7, 11]
    got = control.faulty(c, fault, seeds, "cpu")
    want = check.reference_run(c, got, "cpu")
    vals = check.compare(c, got, want, "cpu")
    assert (vals["state_gap"] == 0.0) == (fault == "half_iters"), vals
