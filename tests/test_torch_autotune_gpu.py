"""The autotuner on the card (``gpu`` marker; each test skips inside itself
without a CUDA card). No JAX here, so the card's machine runs them:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_autotune_gpu.py
"""
import json
import pathlib

import pytest
import torch

from repro_torch.core import autotune as at
from repro_torch.roofline import pso_cost

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_auto_on_the_card_measures_the_kernels(tmp_path):
    _card()
    cache = at.AutotuneCache(str(tmp_path / "autotune.json"))
    s = at.resolve_schedule("cubic", 1, 16384, 256, cache=cache)
    assert s.source == "measured" and s.backend == "kernel"
    assert s.measured_us > 0
    hit = at.resolve_schedule("cubic", 1, 16384, 256, cache=cache)
    assert hit.source == "cache"
    scope = at.cache_scope(True, torch.device("cuda"))
    assert scope == f"kernel:{torch.cuda.get_device_name()}"
    assert cache.get(scope, at.shape_key("cubic", 1, 16384, 256,
                                         "float32")) is not None


@pytest.mark.gpu
def test_card_feasibility_keeps_what_launches():
    """Every kernel candidate the card's occupancy queries keep at the
    paper's largest d=1 swarm launches; the ones dropped would raise."""
    _card()
    n, d = 131072, 1
    cands = at.candidate_schedules(d, n, 64, kernel_ok=True,
                                   max_candidates=64)
    kept = at.feasible_schedules(cands, "cubic", d, n, device="cuda")
    assert any(s.backend == "kernel" for s in kept)
    for s in kept:
        if s.backend == "kernel":
            assert at.measure_schedule(s, "cubic", d, n, iters=2,
                                       repeats=1) > 0


@pytest.mark.gpu
def test_committed_baseline_is_refused_on_the_card():
    _card()
    path = ROOT / "benchmarks" / "BENCH_pso.json"
    assert json.loads(path.read_text())["meta"]["device_kind"] == "cpu"
    fit = pso_cost.fit_calibration(str(path))
    assert "host-mismatch" in fit.source
    assert fit.grid_step_us == pso_cost.CUDA_CALIBRATION.grid_step_us
