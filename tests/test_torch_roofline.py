"""The port's cost model (``repro_torch.roofline.pso_cost``) against the
reference's (``repro.roofline.pso_cost``) on the CPU.

The eager backend's counts are the reference's ``backend="jnp"`` counts
exactly, field by field, and so are the microseconds under
``DEFAULT_CALIBRATION``; ``fit_calibration`` fits the same constants from
the same documents. The kernel backend's scheduling terms follow the CUDA
kernels and are held to their own golden values; its flops and gbest
traffic are the reference's. A custom objective's op mix comes from a
``TorchDispatchMode`` count of its torch code, held to ``FITNESS_MIX`` for
a torch sphere (exact) and a torch rastrigin (within one operation a
particle: the table counts its ``10 d`` constant's add, the torch code
folds it into a Python float).
"""
import dataclasses
import math
import os

import pytest
import torch

from repro.roofline import pso_cost as ref_cost
import repro.roofline as ref_roofline

import repro_torch
from repro_torch import roofline
from repro_torch.roofline import analysis, pso_cost
from repro_torch.roofline.pso_cost import (DEFAULT_CALIBRATION, FITNESS_MIX,
                                           estimate_us_per_iter,
                                           fit_calibration, fitness_op_mix,
                                           iteration_cost)

BUILTINS = ("cubic", "sphere", "rosenbrock", "griewank", "rastrigin",
            "ackley")
VARIANTS = ("reduction", "queue", "queue_lock", "async")
RULES = ("pso", "sso", "lowcost")
FIELDS = ("flops", "transcendentals", "bytes_hbm", "gbest_bytes",
          "const_bytes", "grid_steps", "dispatches")


def _as_tuple(cost):
    return tuple(getattr(cost, f) for f in FIELDS)


# --------------------------------------------------------------------------
# Exports and tables.
# --------------------------------------------------------------------------

def test_roofline_exports_the_reference_pso_cost_names():
    """The reference's exports: pso_cost's names are pso_cost's objects,
    and analysis's sit beside them, with the H100's NVLink rate for the
    TPU's ICI and the op counter for the HLO collective parser."""
    swapped = {"ICI_BW": "NVLINK_BW", "collective_bytes": "CostCounter"}
    want = [swapped.get(n, n) for n in ref_roofline.__all__]
    assert sorted(roofline.__all__) == sorted(want)
    for name in roofline.__all__:
        mod = pso_cost if hasattr(ref_cost, name) else analysis
        assert getattr(roofline, name) is getattr(mod, name)


def test_tables_equal_the_reference():
    assert {k: dataclasses.astuple(v) for k, v in FITNESS_MIX.items()} == \
        {k: dataclasses.astuple(v) for k, v in ref_cost.FITNESS_MIX.items()}
    assert {k: dataclasses.astuple(v)
            for k, v in pso_cost.RULE_MIX.items()} == \
        {k: dataclasses.astuple(v)
         for k, v in ref_cost.RULE_MIX.items()}
    for name in ("DTYPE_BYTES", "RARE_IMPROVE", "VEL_FLOPS", "POS_FLOPS",
                 "PBEST_SELECT_FLOPS", "PBEST_FLOPS_PER_PARTICLE",
                 "RNG_DRAWS", "HETERO_SWITCH_FLOPS", "_MEASURE_N"):
        assert getattr(pso_cost, name) == getattr(ref_cost, name), name
    assert dataclasses.astuple(DEFAULT_CALIBRATION) == \
        dataclasses.astuple(ref_cost.DEFAULT_CALIBRATION)


def test_golden_fitness_mix_table():
    """The reference's golden values, on the port."""
    mix = fitness_op_mix("sphere", 4)
    assert mix.flops(4, 256) == 256 * 9
    assert mix.transcendentals(4, 256) == 0


# --------------------------------------------------------------------------
# The eager backend: the reference's jnp counts exactly.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("problem", BUILTINS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_eager_cost_equals_reference_jnp(variant, problem, rule):
    kw = dict(block_n=64, sync_every=8) if variant == "async" else {}
    got = iteration_cost(variant, problem, 6, 256, rule=rule, **kw)
    want = ref_cost.iteration_cost(variant, problem, 6, 256, rule=rule,
                                   backend="jnp", **kw)
    assert _as_tuple(got) == _as_tuple(want)
    assert estimate_us_per_iter(variant, problem, 6, 256, rule=rule,
                                **kw) == \
        ref_cost.estimate_us_per_iter(variant, problem, 6, 256, rule=rule,
                                      backend="jnp", **kw)


@pytest.mark.parametrize("batch,hetero", [(16, 0), (8, 6), (1, 3)])
@pytest.mark.parametrize("variant", VARIANTS)
def test_eager_cost_batch_and_hetero_equal_reference(variant, batch, hetero):
    kw = dict(sync_every=4) if variant == "async" else {}
    got = iteration_cost(variant, "rastrigin", 8, 512, batch=batch,
                         hetero_table=hetero, **kw)
    want = ref_cost.iteration_cost(variant, "rastrigin", 8, 512,
                                   batch=batch, hetero_table=hetero, **kw)
    assert _as_tuple(got) == _as_tuple(want)
    assert estimate_us_per_iter(variant, "rastrigin", 8, 512, batch=batch,
                                hetero_table=hetero, **kw) == \
        ref_cost.estimate_us_per_iter(variant, "rastrigin", 8, 512,
                                      batch=batch, hetero_table=hetero, **kw)


def test_golden_reduction_eager_sphere():
    """reduction/eager, sphere, d=4, n=256, f32: every term by hand."""
    c = iteration_cost("reduction", "sphere", 4, 256)
    d, n = 4, 256
    assert c.flops == n * (d * 2 + 1) + n * d * 15 + n * 2 + (n + d + 1)
    assert c.bytes_hbm == 4 * (8 * n * d + 4 * n) + 4 * (d + 1) * 2
    assert c.const_bytes == 0 and c.grid_steps == 0 and c.dispatches == 0


def test_constrained_tabled_problem_doubles_mix():
    from repro_torch.core.constraints import (ConstraintSet,
                                              project_simplex,
                                              simplex_constraints)
    plain = repro_torch.resolve_problem("sphere")
    con = dataclasses.replace(plain, constraints=ConstraintSet(
        constraints=simplex_constraints(), mode="projection",
        projection=project_simplex))
    a, b = fitness_op_mix(plain, 4), fitness_op_mix(con, 4)
    assert b.flops_per_dim == 2 * a.flops_per_dim
    assert b.flops_per_particle == 2 * a.flops_per_particle + 4
    assert fitness_op_mix("sphere_simplex", 4).flops_per_dim > 0


# --------------------------------------------------------------------------
# Custom objectives: the dispatch-mode count.
# --------------------------------------------------------------------------

def _torch_sphere(x):
    return -torch.sum(x * x, dim=-1)


def _torch_rastrigin(x):
    d = x.shape[-1]
    return -(10.0 * d + torch.sum(x * x - 10.0 * torch.cos(
        2.0 * math.pi * x), dim=-1))


@pytest.mark.parametrize("d", [1, 4, 9])
def test_dispatch_count_of_a_torch_sphere_is_the_table(d):
    prob = repro_torch.Problem(name="my_sphere", fn=_torch_sphere)
    got, want = fitness_op_mix(prob, d), FITNESS_MIX["sphere"]
    for n in (64, 1000):
        assert got.flops(d, n) == pytest.approx(want.flops(d, n), rel=1e-12)
        assert got.transcendentals(d, n) == 0
    assert pso_cost.torch_step_calls(prob, d) == 3      # mul, sum, neg


@pytest.mark.parametrize("d", [1, 4, 9])
def test_dispatch_count_of_a_torch_rastrigin_is_the_table(d):
    prob = repro_torch.Problem(name="my_rastrigin", fn=_torch_rastrigin)
    got, want = fitness_op_mix(prob, d), FITNESS_MIX["rastrigin"]
    for n in (64, 1000):
        assert abs(got.flops(d, n) - want.flops(d, n)) <= n + 1e-6
        assert got.transcendentals(d, n) == pytest.approx(
            want.transcendentals(d, n), rel=1e-12)


def test_dispatch_count_is_cached_per_content():
    prob = repro_torch.Problem(name="bowl", fn=_torch_sphere)
    twin = repro_torch.Problem(name="bowl", fn=_torch_sphere)
    assert fitness_op_mix(prob, 3) is fitness_op_mix(twin, 3)
    other = repro_torch.Problem(name="bowl", fn=_torch_rastrigin)
    assert fitness_op_mix(other, 3) != fitness_op_mix(prob, 3)


def test_builtins_and_custom_problems_stream_no_consts():
    assert pso_cost.const_operand_bytes("sphere", 4, 128) == 0.0
    assert pso_cost.const_operand_bytes("sphere_simplex", 8, 128) == 0.0


# --------------------------------------------------------------------------
# The kernel backend: the CUDA kernels' scheduling terms.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["queue", "queue_lock", "async"])
def test_kernel_work_terms_equal_reference(variant):
    """Flops, transcendentals and gbest traffic are the reference's kernel
    counts; only the synchronisation and the state streaming differ."""
    kw = dict(block_n=128, sync_every=8, backend="kernel")
    got = iteration_cost(variant, "ackley", 8, 1024, hetero_table=4, **kw)
    want = ref_cost.iteration_cost(variant, "ackley", 8, 1024,
                                   hetero_table=4, **kw)
    assert (got.flops, got.transcendentals, got.gbest_bytes) == \
        (want.flops, want.transcendentals, want.gbest_bytes)


def test_golden_fused_kernel_grid_barrier():
    """The fused kernel: every block at one grid-wide barrier an
    iteration, none with one block; one launch a run."""
    d, n = 2, 1024
    many = iteration_cost("queue_lock", "sphere", d, n, block_n=128,
                          backend="kernel")
    one = iteration_cost("queue_lock", "sphere", d, n, block_n=n,
                         backend="kernel")
    assert (many.grid_steps, many.dispatches) == (8.0, 0.0)
    assert (one.grid_steps, one.dispatches) == (0.0, 0.0)
    assert pso_cost.fused_grid_steps(1) == 0.0
    assert pso_cost.fused_grid_steps(7) == 7.0


def test_golden_queue_kernel_dispatch():
    c = iteration_cost("queue", "sphere", 2, 256, block_n=128,
                       backend="kernel")
    assert c.grid_steps == 2 and c.dispatches == 1.0


def test_golden_async_kernel_streams_state_every_iteration():
    """The CUDA async kernel reads and writes the state every iteration
    (the reference's TPU kernel keeps a block resident over a chunk); its
    boundaries are every block's a chunk."""
    d, n, bn, k = 4, 256, 128, 8
    cj = iteration_cost("async", "sphere", d, n, block_n=bn, sync_every=k)
    ck = iteration_cost("async", "sphere", d, n, block_n=bn, sync_every=k,
                        backend="kernel")
    state = 4 * (8 * n * d + 4 * n)
    assert ck.bytes_hbm - ck.gbest_bytes == state
    assert cj.bytes_hbm == ck.bytes_hbm
    assert ck.grid_steps == pytest.approx((n // bn) / k)


def test_golden_split_path_dispatches():
    """A non-built-in Problem on the kernel backend: two launches an
    iteration plus its torch step's calls, no synchronisation arrivals."""
    prob = repro_torch.Problem(name="my_sphere", fn=_torch_sphere)
    for variant in ("queue_lock", "async"):
        c = iteration_cost(variant, prob, 8, 1024, backend="kernel")
        assert c.dispatches == pso_cost.SPLIT_LAUNCHES + 3
        assert c.grid_steps == 0 and c.const_bytes == 0
        assert c.bytes_hbm - c.gbest_bytes == 4 * (8 * 1024 * 8 + 4 * 1024)


@pytest.mark.parametrize("variant", VARIANTS)
def test_cost_monotone_in_n(variant):
    prev = None
    for n in (64, 128, 256, 512, 1024, 2048):
        c = iteration_cost(variant, "rastrigin", 8, n, sync_every=8)
        us = estimate_us_per_iter(variant, "rastrigin", 8, n, sync_every=8)
        if prev is not None:
            assert c.flops > prev[0].flops
            assert c.bytes_hbm > prev[0].bytes_hbm
            assert us > prev[1]
        prev = (c, us)


@pytest.mark.parametrize("backend", ["eager", "kernel"])
def test_async_gbest_traffic_decreasing_in_sync_every(backend):
    prev = None
    for k in (1, 2, 4, 8, 16, 32, 64):
        c = iteration_cost("async", "sphere", 8, 512, block_n=128,
                           sync_every=k, backend=backend)
        if prev is not None:
            assert c.gbest_bytes < prev.gbest_bytes
            assert c.bytes_hbm <= prev.bytes_hbm
        prev = c


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_async_kernel_estimate_decreasing_in_sync_every(device):
    calib = pso_cost.default_calibration(device)
    prev = None
    for k in (1, 4, 16, 64):
        us = estimate_us_per_iter("async", "sphere", 8, 512, block_n=128,
                                  sync_every=k, backend="kernel",
                                  calib=calib)
        if prev is not None:
            assert us < prev
        prev = us


def test_cost_model_invalid_inputs_raise():
    with pytest.raises(ValueError, match="variant"):
        iteration_cost("bogus", "sphere", 4, 64)
    with pytest.raises(ValueError, match="backend"):
        iteration_cost("queue", "sphere", 4, 64, backend="jnp")
    with pytest.raises(ValueError, match="reduction kernel"):
        iteration_cost("reduction", "sphere", 4, 64, backend="kernel")


# --------------------------------------------------------------------------
# Calibration.
# --------------------------------------------------------------------------

def test_default_calibration_per_device_and_backend():
    assert pso_cost.default_calibration() is DEFAULT_CALIBRATION
    assert pso_cost.default_calibration("cpu", "eager") is \
        DEFAULT_CALIBRATION
    card = pso_cost.default_calibration(torch.device("cuda"))
    eager = pso_cost.default_calibration("cuda", "eager")
    assert card is pso_cost.CUDA_CALIBRATION
    assert card.source == "cuda-default"
    assert eager.source == "cuda-eager-default"
    # on the card the eager engine pays the host's launches an iteration
    assert eager.iter_overhead_us > 100 * max(card.iter_overhead_us, 1.0)
    with pytest.raises(ValueError, match="backend"):
        pso_cost.default_calibration("cuda", "jnp")


def test_card_calibration_ranks_kernels_over_the_eager_engine():
    """With the card's constants the fused kernel prices far below the
    eager engine at the paper's largest d=1 swarm, and the async kernel
    below the fused one there (PERF.md: 2.99 against 3.92 µs/iter)."""
    kw = dict(problem="cubic", d=1, n=131072)
    card = pso_cost.default_calibration("cuda")
    eager = pso_cost.default_calibration("cuda", "eager")
    fused = estimate_us_per_iter("queue_lock", backend="kernel",
                                 calib=card, **kw)
    asyn = estimate_us_per_iter("async", backend="kernel", sync_every=64,
                                calib=card, **kw)
    slow = estimate_us_per_iter("queue", backend="eager", calib=eager, **kw)
    assert asyn < fused < slow / 10


def _synthetic_bench(mod, meta=None):
    """The reference test's synthetic document, priced by ``mod``."""
    true = dataclasses.replace(mod.DEFAULT_CALIBRATION, flops_per_us=2000.0,
                               iter_overhead_us=1.0, grid_step_us=30.0)
    recs = []
    for n in (64, 256, 1024):
        for v in ("reduction", "queue", "queue_lock"):
            cost = mod.iteration_cost(v, "cubic", 1, n)
            us = true.us_per_iter(cost, rng_elems=n * mod.RNG_DRAWS)
            recs.append({"name": f"table3/p{n}/{v}", "us_per_call": us})
    for k in (1, 4, 16, 64):
        nb = 1024 // 256
        recs.append({"name": f"async_sweep/d1_n1024_b256/sync_every_{k}",
                     "us_per_call": 100.0 + true.grid_step_us * nb / k})
    recs.append({"name": "async_sweep/d1_n1024_b256/sync_kernel",
                 "us_per_call": 100.0 + true.grid_step_us * nb})
    return {"meta": meta or {}, "benchmarks": recs}, true


@pytest.mark.parametrize("meta", [None, {"cpu_count": os.cpu_count(),
                                         "device_kind": "cpu"}])
def test_fit_calibration_equals_reference(meta):
    doc, true = _synthetic_bench(pso_cost, meta)
    ref_doc, _ = _synthetic_bench(ref_cost, meta)
    assert doc == ref_doc
    got, want = fit_calibration(doc), ref_cost.fit_calibration(ref_doc)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.source.startswith("bench-fit")
    assert got.flops_per_us == pytest.approx(true.flops_per_us, rel=0.25)
    assert got.grid_step_us == pytest.approx(true.grid_step_us, rel=0.05)


def test_fit_calibration_refuses_host_mismatch():
    doc, _ = _synthetic_bench(pso_cost, {"host": "other-box",
                                         "cpu_count": 9999})
    fit = fit_calibration(doc)
    assert dataclasses.astuple(fit) == dataclasses.astuple(
        ref_cost.fit_calibration(doc))
    assert "host-mismatch" in fit.source
    assert fit.flops_per_us == DEFAULT_CALIBRATION.flops_per_us
    doc, _ = _synthetic_bench(pso_cost, {"device_kind": "TPU v5 lite"})
    assert "host-mismatch" in fit_calibration(doc).source


def test_fit_calibration_onto_a_base():
    doc, _ = _synthetic_bench(pso_cost, {"device_kind": "cpu"})
    card = pso_cost.default_calibration("cuda")
    fit = fit_calibration(doc, base=card)
    assert fit.bytes_per_us == card.bytes_per_us
    assert fit.grid_step_us != card.grid_step_us


def test_fit_calibration_missing_artifact_is_default(tmp_path):
    assert fit_calibration(None) == DEFAULT_CALIBRATION
    assert fit_calibration(str(tmp_path / "none.json")) == \
        DEFAULT_CALIBRATION
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert fit_calibration(str(bad)) == DEFAULT_CALIBRATION


def test_fit_calibration_committed_baseline_equals_reference():
    path = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                        "BENCH_pso.json")
    got, want = fit_calibration(path), ref_cost.fit_calibration(path)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.flops_per_us > 0 and got.grid_step_us > 0
