"""The port's schedule autotuner (``repro_torch.core.autotune``) and its
hooks (``Method(schedule="auto")``, serving's ``autotune=True``) on the
CPU, against ``repro.core.autotune`` where the two must agree: shape keys
of the built-ins, the candidate enumeration, the model ranking (order and
predicted µs under ``DEFAULT_CALIBRATION``), the model-only resolution,
``tuned_sync_every`` and ``bucket_ladder``. Then the reference's own
resolve, cache, noise-margin, ``Method`` and serving tests case for case
with ``device="cpu"``, the card's feasibility filter with injected
occupancy, and the rule that an error of a measurement propagates.
"""
import json
import os
import subprocess
import sys
import pathlib

import numpy as np
import pytest
import torch

from repro.core import autotune as ref_at
from repro.roofline import pso_cost as ref_cost

import repro_torch
from repro_torch.core import autotune as at
from repro_torch.core import pso
from repro_torch.core.autotune import (AutotuneCache, Schedule,
                                       candidate_schedules, fixed_schedule,
                                       rank_schedules, resolve_schedule,
                                       shape_key)
from repro_torch.kernels import ops, pso_step
from repro_torch.launch.serve import SolveRequest, SolveServer
from repro_torch.roofline import pso_cost
from repro_torch.serving import ContinuousScheduler

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
BUILTINS = ("cubic", "sphere", "rosenbrock", "griewank", "rastrigin",
            "ackley")


@pytest.fixture
def cache(tmp_path):
    return AutotuneCache(str(tmp_path / "autotune.json"))


@pytest.fixture
def ref_default(monkeypatch):
    """The reference priced with its default constants, as the port prices
    the CPU: its baseline document is a CPU-interpret artifact."""
    monkeypatch.setattr(ref_at, "_bench_baseline_path", lambda: None)


def _key(s):
    return (s.variant, {"jnp": "eager"}.get(s.backend, s.backend),
            s.block_n, s.sync_every)


# --------------------------------------------------------------------------
# Against the reference: keys, candidates, ranking, model-only resolution.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("problem", BUILTINS)
@pytest.mark.parametrize("shape", [(1, 256, 50, 1, 0, "pso"),
                                   (8, 1024, 1000, 16, 0, "sso"),
                                   (10, 128, 64, 8, 6, "lowcost")])
def test_shape_key_equals_reference(problem, shape):
    d, n, iters, batch, hetero, rule = shape
    assert shape_key(problem, d, n, iters, "float32", batch, hetero,
                     rule=rule) == \
        ref_at.shape_key(problem, d, n, iters, "float32", batch, hetero,
                         rule=rule)


def test_shape_key_buckets_iters():
    a = shape_key("sphere", 4, 256, 50, "float32")
    b = shape_key("sphere", 4, 256, 64, "float32")
    c = shape_key("sphere", 4, 256, 65, "float32")
    assert a == b != c


def test_shape_key_distinguishes_custom_and_constrained():
    def bowl(x):
        return torch.sum(x ** 2, dim=-1)

    custom = repro_torch.Problem(name="my_bowl", sense="min", fn=bowl)
    key = shape_key(custom, 4, 256, 64, "float32")
    assert key.startswith(f"custom:{custom.cache_key()[:8]}|")
    assert key == shape_key(repro_torch.Problem(name="my_bowl", sense="min",
                                                fn=bowl), 4, 256, 64,
                            "float32")
    assert shape_key("sphere", 4, 256, 64, "float32") != \
        shape_key("sphere_simplex", 4, 256, 64, "float32")


@pytest.mark.parametrize("kernel_ok", [False, True])
@pytest.mark.parametrize("shape", [(4, 256, 64), (8, 384, 64), (1, 131072,
                                                                1000),
                                   (120, 32768, 200), (10, 1024, 3)])
def test_candidates_equal_reference(shape, kernel_ok):
    got = candidate_schedules(*shape, kernel_ok=kernel_ok)
    want = ref_at.candidate_schedules(*shape, kernel_ok=kernel_ok)
    assert [_key(s) for s in got] == [_key(s) for s in want]
    assert len(got) <= 24
    if not kernel_ok:
        assert all(s.backend == "eager" for s in got)


def test_candidates_without_a_card_are_eager():
    cands = candidate_schedules(4, 256, 64, device=CPU)
    assert cands and all(s.backend == "eager" for s in cands)
    assert {s.variant for s in cands} == {"reduction", "queue",
                                          "queue_lock", "async"}
    assert sum(s.variant == "async" for s in cands) > 1


@pytest.mark.parametrize("problem,d,n,iters,batch,hetero", [
    ("sphere", 4, 256, 64, 1, 0), ("cubic", 1, 131072, 1000, 1, 0),
    ("cubic", 120, 32768, 200, 1, 0), ("rastrigin", 10, 1024, 200, 128, 0),
    ("ackley", 10, 128, 16, 8, 6)])
@pytest.mark.parametrize("kernel_ok", [False, True])
def test_rank_equals_reference(problem, d, n, iters, batch, hetero,
                               kernel_ok):
    """The eager candidates rank exactly as the reference's jnp ones under
    the reference's default constants, in order and in predicted µs. With
    kernel candidates the eager rows keep their µs and the kernels'
    differ only where the CUDA kernels synchronise otherwise."""
    cands = candidate_schedules(d, n, iters, kernel_ok=kernel_ok)
    ref_cands = ref_at.candidate_schedules(d, n, iters, kernel_ok=kernel_ok)
    kw = dict(batch=batch, hetero_table=hetero)
    got = rank_schedules(cands, problem, d, n, iters,
                         calib=pso_cost.DEFAULT_CALIBRATION, **kw)
    want = ref_at.rank_schedules(ref_cands, problem, d, n, iters,
                                 calib=ref_cost.DEFAULT_CALIBRATION, **kw)
    if not kernel_ok:
        assert [(_key(s), s.predicted_us) for s in got] == \
            [(_key(s), s.predicted_us) for s in want]
    eager = {_key(s): s.predicted_us for s in got if s.backend == "eager"}
    assert eager == {_key(s): s.predicted_us for s in want
                     if s.backend == "jnp"}
    assert [s.predicted_us for s in got] == sorted(
        s.predicted_us for s in got)


def test_rank_drops_invalid_blocks():
    cands = [Schedule("queue", "eager"),
             Schedule("async", "eager", block_n=100, sync_every=8),
             Schedule("async", "eager", block_n=64, sync_every=8),
             Schedule("async", "kernel", block_n=64, sync_every=8)]
    ranked = rank_schedules(cands, "sphere", 4, 256, 64, device=CPU)
    assert [s.block_n for s in ranked if s.variant == "async"] == [64]
    assert all(s.source == "model" and s.predicted_us is not None
               for s in ranked)


@pytest.mark.parametrize("problem,d,n,iters", [
    ("sphere", 4, 256, 64), ("cubic", 1, 4096, 1000),
    ("rastrigin", 10, 1024, 200)])
def test_model_only_resolve_equals_reference(problem, d, n, iters, cache,
                                             tmp_path, ref_default):
    got = resolve_schedule(problem, d, n, iters, measure=False, cache=cache,
                           device=CPU)
    want = ref_at.resolve_schedule(
        problem, d, n, iters, measure=False, kernel_ok=False,
        cache=ref_at.AutotuneCache(str(tmp_path / "ref.json")))
    assert (_key(got), got.predicted_us, got.source) == \
        (_key(want), want.predicted_us, want.source)


@pytest.mark.parametrize("problem", ["sphere", "rastrigin", "cubic"])
def test_tuned_sync_every_equals_reference(problem, cache, tmp_path,
                                           ref_default):
    got = at.tuned_sync_every(problem, 4, 256, 64, cache=cache, device=CPU)
    want = ref_at.tuned_sync_every(
        problem, 4, 256, 64, cache=ref_at.AutotuneCache(
            str(tmp_path / "ref.json")))
    assert got == want and got in at.SYNC_EVERY_CHOICES


@pytest.mark.parametrize("problem,d,n,variant,max_batch", [
    ("sphere", 4, 128, "queue", 64), ("rastrigin", 10, 128, "async", 8),
    ("cubic", 1, 256, "queue_lock", 128), ("ackley", 10, 1024, "async",
                                           128)])
def test_bucket_ladder_equals_reference(problem, d, n, variant, max_batch,
                                        ref_default):
    got = at.bucket_ladder(problem, d, n, 32, max_batch=max_batch,
                           variant=variant, device=CPU)
    assert got == ref_at.bucket_ladder(problem, d, n, 32,
                                       max_batch=max_batch, variant=variant)
    assert got[0] == 4 and list(got) == sorted(set(got))
    assert all(b <= max_batch for b in got)
    assert all(got[i + 1] == 2 * got[i] for i in range(len(got) - 1))


def test_bucket_ladder_on_the_card_prices_the_eager_host(monkeypatch):
    """The card's eager constants amortize a host-bound iteration, so the
    ladder keeps doubling to the cap (what serving's lanes then use). The
    device is resolved without a card: only its constants are read."""
    monkeypatch.setattr(at._device, "resolve",
                        lambda device=None: torch.device(device or "cuda"))
    assert at.bucket_ladder("rastrigin", 10, 128, 16, max_batch=128,
                            variant="async", min_bucket=8,
                            device="cuda") == (8, 16, 32, 64, 128)


# --------------------------------------------------------------------------
# The card's feasibility filter, with injected occupancy.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,bn,s_cnt,held", [
    (131072, 1, 128, 1, 264), (131072, 1, 512, 1, 264),
    (32768, 120, 512, 1, 62), (32768, 120, 256, 1, 62),
    (1024, 10, 1024, 300, 10), (1024, 10, 512, 128, 1)])
def test_launch_fits_is_launch_plan_without_raising(n, d, bn, s_cnt, held):
    def capacity(c):
        return held

    def resident(c):
        return held

    fits = pso_step.launch_fits("queue_lock", n, d, bn, s_cnt, capacity,
                                resident)
    try:
        pso_step.launch_plan(n, d, bn, s_cnt, capacity, resident)
        planned = True
    except RuntimeError:
        planned = False
    assert fits == planned
    assert pso_step.launch_fits("async", n, d, bn, s_cnt, capacity,
                                resident)


def test_feasible_schedules_drop_blocks_the_card_cannot_hold():
    n, d = 131072, 1
    cands = candidate_schedules(d, n, 1000, kernel_ok=True,
                                max_candidates=64)
    held = {128: 1056, 256: 264, 512: 264}
    calls = []

    def resident(bn, c):
        calls.append((bn, c))
        return held[bn]

    kept = at.feasible_schedules(cands, "cubic", d, n, device=CPU,
                                 capacity=lambda bn, c: held[bn],
                                 resident=resident)
    fused = {s.block_n for s in kept
             if s.backend == "kernel" and s.variant == "queue_lock"}
    assert fused == {128, 512, None}          # 512 blocks of 256 do not fit
    assert [s for s in cands if s.variant == "async"] == \
        [s for s in kept if s.variant == "async"]
    assert all(c == 1 for _, c in calls)      # d=1: one CTA a block
    # without injected occupancy the CPU's plain versions take any block
    assert at.feasible_schedules(cands, "cubic", d, n, device=CPU) == cands


def test_feasible_schedules_keep_the_split_path():
    def bowl(x):
        return -torch.sum(x * x, dim=-1)

    cands = candidate_schedules(4, 131072, 64, kernel_ok=True)
    custom = repro_torch.Problem(name="bowl", fn=bowl)
    assert at.feasible_schedules(cands, custom, 4, 131072, device=CPU,
                                 capacity=lambda bn, c: 0,
                                 resident=lambda bn, c: 0) == cands


# --------------------------------------------------------------------------
# Resolution: the reference's tests, on the port.
# --------------------------------------------------------------------------

def test_resolve_model_only_no_measurement(cache, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("measure_schedule called under measure=False")
    monkeypatch.setattr(at, "measure_schedule", boom)
    s = resolve_schedule("sphere", 4, 256, 64, measure=False, cache=cache,
                         kernel_ok=False, device=CPU)
    assert s.source == "model" and s.backend == "eager"


def test_resolve_measured_includes_fixed_anchor(cache, monkeypatch):
    measured = []

    def fake_measure(sched, *a, **k):
        measured.append(sched)
        return 100.0 if sched.variant != "queue" else 1.0
    monkeypatch.setattr(at, "measure_schedule", fake_measure)
    monkeypatch.setattr(at, "rank_schedules", lambda cands, *a, **k: [
        Schedule("async", "eager", block_n=64, sync_every=k_,
                 source="model", predicted_us=float(k_))
        for k_ in (1, 2, 4, 8)])
    s = resolve_schedule("sphere", 4, 256, 64, cache=cache, kernel_ok=False,
                         top_k=3, device=CPU)
    assert any(m.variant == "queue" for m in measured)
    assert len(measured) == 4
    assert s.variant == "queue" and s.source == "measured"
    assert s.measured_us == 1.0


def test_resolve_noise_margin_keeps_fixed_default(cache, monkeypatch):
    monkeypatch.setattr(at, "measure_schedule", lambda sched, *a, **k: (
        95.0 if sched.variant == "async" else 100.0))
    monkeypatch.setattr(at, "rank_schedules", lambda cands, *a, **k: [
        Schedule("async", "eager", block_n=64, sync_every=8,
                 source="model", predicted_us=1.0)])
    s = resolve_schedule("sphere", 4, 256, 64, cache=cache, kernel_ok=False,
                         device=CPU)
    assert s.variant == "queue"             # the fixed default held
    monkeypatch.setattr(at, "measure_schedule", lambda sched, *a, **k: (
        50.0 if sched.variant == "async" else 100.0))
    s2 = resolve_schedule("sphere", 4, 512, 64, cache=cache,
                          kernel_ok=False, device=CPU)
    assert s2.variant == "async"            # a 2x win displaces it


@pytest.mark.parametrize("error", [RuntimeError("nvcc failed"),
                                   ValueError("launch refused")])
def test_an_error_of_a_measurement_propagates(cache, monkeypatch, error):
    def broken(*a, **k):
        raise error
    monkeypatch.setattr(at, "measure_schedule", broken)
    with pytest.raises(type(error), match=str(error)):
        resolve_schedule("sphere", 4, 256, 64, cache=cache, device=CPU)
    assert cache.get(at.cache_scope(False, torch.device(CPU)),
                     shape_key("sphere", 4, 256, 64, "float32")) is None


def test_a_kernel_that_fails_to_launch_fails_the_resolve(cache, monkeypatch):
    """A kernel candidate's launch error reaches the caller through the
    real ``measure_schedule``: the candidate is not dropped."""
    def refused(*a, **k):
        raise RuntimeError("fused kernel launch: too many resources")
    monkeypatch.setattr(ops, "run_queue_lock_fused", refused)
    monkeypatch.setattr(at, "rank_schedules", lambda cands, *a, **k: [
        Schedule("queue_lock", "kernel", block_n=128, source="model",
                 predicted_us=1.0)])
    with pytest.raises(RuntimeError, match="too many resources"):
        resolve_schedule("sphere", 4, 256, 64, cache=cache, kernel_ok=True,
                         device=CPU)


def test_resolve_cache_hit_skips_measurement(cache, monkeypatch):
    calls = {"n": 0}
    real = at.measure_schedule

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)
    monkeypatch.setattr(at, "measure_schedule", counting)
    first = resolve_schedule("sphere", 4, 128, 16, cache=cache,
                             kernel_ok=False, top_k=1, device=CPU)
    n_first = calls["n"]
    assert n_first >= 1 and first.source == "measured"
    second = resolve_schedule("sphere", 4, 128, 16, cache=cache,
                              kernel_ok=False, top_k=1, device=CPU)
    assert calls["n"] == n_first
    assert second.source == "cache"
    assert _key(second) == _key(first)


def test_cache_survives_process_restart(cache):
    cache.put("eager:cpu", "k1", Schedule("async", "eager", block_n=64,
                                          sync_every=16, measured_us=3.0))
    fresh = AutotuneCache(cache.path)
    hit = fresh.get("eager:cpu", "k1")
    assert hit is not None and hit.source == "cache"
    assert (hit.variant, hit.block_n, hit.sync_every) == ("async", 64, 16)
    assert fresh.get("kernel:cpu", "k1") is None


def test_cache_tolerates_corrupt_file(tmp_path):
    p = tmp_path / "autotune.json"
    p.write_text("{not json")
    c = AutotuneCache(str(p))
    assert c.get("eager:cpu", "k") is None
    c.put("eager:cpu", "k", Schedule("queue", "eager"))
    assert json.load(open(p))


def test_reference_scope_entries_are_not_read(cache, ref_default):
    """An optimum the reference measured (scope ``jnp``/``kernel``) in the
    same file is never read back by the port (scope ``eager:cpu``)."""
    key = shape_key("sphere", 4, 256, 64, "float32")
    ref_cache = ref_at.AutotuneCache(cache.path)
    for scope in ("jnp", "kernel"):
        ref_cache.put(scope, key, ref_at.Schedule(
            "async", "jnp", block_n=2, sync_every=64, measured_us=0.01))
    s = resolve_schedule("sphere", 4, 256, 64, measure=False,
                         cache=AutotuneCache(cache.path), device=CPU)
    assert s.source == "model" and s.block_n != 2
    assert at.cache_scope(False, torch.device(CPU)) == "eager:cpu"
    assert at.cache_scope(True, torch.device(CPU)) == "kernel:cpu"


def test_default_cache_path(monkeypatch, tmp_path):
    monkeypatch.delenv(at.CACHE_ENV, raising=False)
    assert AutotuneCache().path == os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json")
    monkeypatch.setenv(at.CACHE_ENV, str(tmp_path / "c.json"))
    assert at.default_cache().path == str(tmp_path / "c.json")


@pytest.mark.parametrize("sched", [
    Schedule("queue", "eager"), Schedule("async", "eager", block_n=32),
    Schedule("queue_lock", "kernel", block_n=64),
    Schedule("async", "kernel", block_n=64, sync_every=4)])
def test_measure_schedule_smoke(sched):
    t = at.measure_schedule(sched, "sphere", 2, 128, iters=4, repeats=1,
                            device=CPU)
    assert 0 < t < 1e6


def test_fixed_schedule_rule():
    assert _key(fixed_schedule(device=CPU)) == ("queue", "eager", None, 8)
    assert fixed_schedule("queue_lock", device=CPU).backend == "eager"
    assert fixed_schedule("async", device="cuda" if
                          torch.cuda.is_available() else CPU).backend == (
        "kernel" if torch.cuda.is_available() else "eager")


def test_seed_priors_cli(tmp_path):
    path = tmp_path / "priors.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.autotune", "--seed-priors",
         "--cache", str(path), "--dims", "1,4", "--particles", "64",
         "--iters", "32", "--device", CPU],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert "seeded 12 schedule prior(s)" in out.stdout
    doc = json.loads(path.read_text())
    assert len(doc) == 12 and all(k.startswith("eager:cpu::") for k in doc)
    again = at.seed_priors(cache=AutotuneCache(str(path)), dims=(1, 4),
                           particles=(64,), iters=32, device=CPU)
    assert again == 0
    if not torch.cuda.is_available():
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.core.autotune",
             "--seed-priors", "--cache", str(path)],
            capture_output=True, text=True, timeout=300, env=env)
        assert out.returncode == 2 and "device='cpu'" in out.stderr


# --------------------------------------------------------------------------
# The facade: Method(schedule=...).
# --------------------------------------------------------------------------

def test_method_schedule_validation():
    assert repro_torch.Method().schedule == "fixed"
    repro_torch.Method(schedule="auto")
    with pytest.raises(ValueError, match="schedule"):
        repro_torch.Method(schedule="bogus")
    with pytest.raises(ValueError, match="island"):
        repro_torch.Method(schedule="auto", islands=2)


def test_method_fixed_schedule_matches_legacy_rule():
    s = repro_torch.Method(variant="queue").resolve_schedule(
        "sphere", 4, 128, 8, device=CPU)
    assert (s.variant, s.backend, s.source) == ("queue", "eager", "fixed")
    s = repro_torch.Method(variant="async", backend="kernel",
                           sync_every=4).resolve_schedule(
        "sphere", 4, 128, 8, device=CPU)
    assert _key(s) == ("async", "kernel", None, 4)


def test_method_auto_schedule_resolves_and_solves(tmp_path, monkeypatch):
    monkeypatch.setenv(at.CACHE_ENV, str(tmp_path / "cache.json"))
    m = repro_torch.Method(schedule="auto")
    s = m.resolve_schedule("sphere", 4, 128, 16, device=CPU, measure=False)
    assert s.source in ("model", "cache")
    r = repro_torch.solve("sphere", dim=4, particles=128, iters=16, seed=0,
                          schedule="auto", device=CPU)
    assert np.isfinite(r.best_fit) and r.method.schedule == "fixed"
    rf = repro_torch.solve("sphere", dim=4, particles=128, iters=16, seed=0,
                           device=CPU)
    assert np.isfinite(rf.best_fit)


def test_record_history_restricts_auto_to_eager(tmp_path, monkeypatch):
    monkeypatch.setenv(at.CACHE_ENV, str(tmp_path / "cache.json"))
    m = repro_torch.Method(schedule="auto", record_history=True)
    s = m.resolve_schedule("sphere", 4, 128, 16, device=CPU, measure=False)
    assert s.backend == "eager"


@pytest.mark.parametrize("kw,scope", [
    (dict(), "eager:cpu"), (dict(backend="eager"), "eager:cpu"),
    (dict(backend="kernel", variant="queue_lock"), "kernel:cpu"),
    (dict(telemetry=True, variant="async"), "kernel:cpu")])
def test_method_pins_the_kernel_candidates(kw, scope, tmp_path, monkeypatch):
    monkeypatch.setenv(at.CACHE_ENV, str(tmp_path / "cache.json"))
    seen = {}
    real = at.resolve_schedule

    def spy(*a, **k):
        seen["scope"] = at.cache_scope(
            k["kernel_ok"] if k["kernel_ok"] is not None
            else at._kernel_ok(k["device"], k["rule"]), k["device"])
        return real(*a, **k)
    monkeypatch.setattr(at, "resolve_schedule", spy)
    repro_torch.Method(schedule="auto", **kw).resolve_schedule(
        "sphere", 4, 128, 16, device=CPU, measure=False)
    assert seen["scope"] == scope


def test_auto_equals_the_resolved_fixed_method(tmp_path, monkeypatch):
    """solve(schedule="auto") runs exactly the fixed Method it resolved to,
    for one swarm and a batch (the resolution is cached, so the fixed
    re-run does not resolve again)."""
    monkeypatch.setenv(at.CACHE_ENV, str(tmp_path / "cache.json"))
    kw = dict(dim=3, particles=128, iters=16, seed=4, device=CPU)
    auto = repro_torch.solve("rastrigin", schedule="auto", **kw)
    fixed = repro_torch.solve("rastrigin", method=auto.method, **kw)
    assert auto.method.schedule == "fixed"
    assert auto.gbest_fit == fixed.gbest_fit
    assert np.array_equal(auto.best_pos, fixed.best_pos)
    many = dict(dim=3, particles=64, iters=8, device=CPU)
    a = repro_torch.solve_many("sphere", range(8), schedule="auto", **many)
    f = repro_torch.solve_many("sphere", range(8), method=a[0].method,
                               **many)
    assert [r.gbest_fit for r in a] == [r.gbest_fit for r in f]
    mixed = ["rastrigin", "sphere", "ackley", "cubic"] * 2
    a = repro_torch.solve_many(problems=mixed, seeds=range(8),
                               schedule="auto", **many)
    f = repro_torch.solve_many(problems=mixed, seeds=range(8),
                               method=a[0].method, **many)
    assert [r.gbest_fit for r in a] == [r.gbest_fit for r in f]


def test_auto_keeps_an_lbest_topology_on_async(tmp_path, monkeypatch):
    monkeypatch.setenv(at.CACHE_ENV, str(tmp_path / "cache.json"))
    r = repro_torch.solve("rastrigin", dim=3, particles=128, iters=16,
                          variant="async", topology="ring",
                          schedule="auto", device=CPU)
    assert r.method.variant == "async" and r.method.topology == "ring"


# --------------------------------------------------------------------------
# Serving (model-only).
# --------------------------------------------------------------------------

def test_serve_autotune_rewrites_async_sync_every(tmp_path, monkeypatch):
    monkeypatch.setenv(at.CACHE_ENV, str(tmp_path / "cache.json"))
    srv = SolveServer(max_batch=4, autotune=True, device=CPU)
    r = SolveRequest(fitness="sphere", dim=4, particle_cnt=64, iters=16,
                     seed=0, variant="async")
    tuned = srv._tuned_request(r)
    assert tuned.sync_every in at.SYNC_EVERY_CHOICES
    assert tuned.sync_every == at.tuned_sync_every("sphere", 4, 64, 16,
                                                   device=CPU)
    rq = SolveRequest(fitness="sphere", dim=4, particle_cnt=64, iters=16,
                      seed=0, variant="queue")
    assert srv._tuned_request(rq) is rq
    assert srv._buckets_for(r) == at.bucket_ladder(
        "sphere", 4, 64, 16, max_batch=4, variant="async", device=CPU)
    assert SolveServer(max_batch=4, device=CPU)._buckets_for(r) == \
        (4, 8, 16, 32, 64, 128)


@pytest.mark.parametrize("backend", ["eager", "kernel"])
def test_serve_autotune_end_to_end(tmp_path, monkeypatch, backend):
    monkeypatch.setenv(at.CACHE_ENV, str(tmp_path / "cache.json"))
    plain = SolveServer(max_batch=4, backend=backend, device=CPU)
    tuned = SolveServer(max_batch=4, backend=backend, autotune=True,
                        device=CPU)
    reqs = [SolveRequest(fitness="sphere", dim=4, particle_cnt=64,
                         iters=16, seed=s, variant="queue_lock")
            for s in range(3)]
    for x, y in zip(plain.solve_all(reqs), tuned.solve_all(reqs)):
        assert x.gbest_fit == y.gbest_fit   # sync variants: no change
    areqs = [SolveRequest(fitness=f, dim=4, particle_cnt=64, iters=16,
                          seed=s, variant="async")
             for s, f in enumerate(("sphere", "rastrigin", "ackley"))]
    k = at.tuned_sync_every("sphere", 4, 64, 16, device=CPU)
    got = tuned.solve_all(areqs)
    want = plain.solve_all([SolveRequest(**{**r.__dict__, "sync_every": k})
                            for r in areqs])
    assert [x.gbest_fit for x in got] == [x.gbest_fit for x in want]
    assert all(x.ok for x in got)


@pytest.mark.parametrize("backend", ["eager", "kernel"])
def test_scheduler_autotune_results_are_standalone_solves(
        tmp_path, monkeypatch, backend):
    """The reference serving trace's shape through ContinuousScheduler(
    autotune=True): every lane request equals its standalone solve at the
    tuned sync_every bit for bit; the lane width is the ladder's top."""
    monkeypatch.setenv(at.CACHE_ENV, str(tmp_path / "cache.json"))
    budgets = (16, 8, 24, 16, 8, 16, 24, 8, 16, 20, 4)
    names = ("cubic", "sphere", "rastrigin", "ackley", "griewank",
             "rosenbrock")
    reqs = [SolveRequest(dim=4, particle_cnt=64, fitness=names[k % 6],
                         seed=k, iters=t, variant="async", sync_every=8)
            for k, t in enumerate(budgets)]
    sched = ContinuousScheduler(lane_width=8, autotune=True, backend=backend,
                                device=CPU)
    res = sched.run(reqs)
    for r, x in zip(reqs, res):
        k = at.tuned_sync_every(r.fitness, r.dim, r.particle_cnt, r.iters,
                                device=CPU)
        assert k in at.SYNC_EVERY_CHOICES and x.ok
        if backend == "eager":
            cfg = pso.PSOConfig(dim=r.dim, particle_cnt=r.particle_cnt,
                                fitness=r.fitness)
            want = pso.solve(cfg, r.seed, r.iters, "async", sync_every=k,
                             device=CPU).gbest_fit
        else:
            want = repro_torch.solve(
                r.fitness, dim=r.dim, particles=r.particle_cnt,
                iters=r.iters, seed=r.seed, variant="async", sync_every=k,
                backend="kernel", record_history=True, device=CPU).gbest_fit
        assert x.gbest_fit == float(want), (r, k)
    ladder = at.bucket_ladder("cubic", 4, 64, 16, max_batch=8,
                              variant="async", min_bucket=8, device=CPU)
    assert all(lane.width == max(8, ladder[-1])
               for lane in sched._lanes.values())
    assert {key[3] for key in sched._lanes} <= set(at.SYNC_EVERY_CHOICES)


def test_solve_stream_autotune_runs(tmp_path, monkeypatch):
    monkeypatch.setenv(at.CACHE_ENV, str(tmp_path / "cache.json"))
    reqs = [SolveRequest(dim=4, particle_cnt=64, fitness="sphere", seed=k,
                         iters=16, variant=v)
            for k, v in enumerate(("async", "async", "queue"))]
    out = repro_torch.solve_stream(reqs, autotune=True, device=CPU)
    assert len(out) == 3 and all(r.ok and np.isfinite(r.gbest_fit)
                                 for r in out)
