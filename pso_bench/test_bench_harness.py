"""The harness's own checks: ``BENCHMARK.json`` against the contract's
shape, every file a cell names found by name, the chip path free of JAX,
the JAX package and the JAX package's benchmark harness, and whole runs of
every cell at a small size on the CPU."""
import dataclasses
import json
import shutil
import subprocess
import sys
import time

import pytest

from pso_bench import harness, peaks, spec, trace
from pso_bench.workload import Workload

BENCH = spec.load_benchmark()
ENTRIES = {w["name"]: w for w in BENCH["workloads"]}
CELLS = list(ENTRIES)
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_benchmark_shape():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "pso_bench/run.py"]
    assert BENCH["paths"] == ["pso_bench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert spec.problems(BENCH) == []
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"solve_ms", "solve_ms_p95", "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200


@pytest.mark.parametrize("bad", ["a b", "a,b", "a/b", "-a", "", "x" * 65])
def test_bad_names_are_refused(bad):
    assert not spec.NAME.match(bad)


@pytest.mark.parametrize("unit,ok", [("ms", True), ("launches/solve", True),
                                     ("%", True), ("tokens per s", False),
                                     ("x" * 17, False), ("", False)])
def test_units(unit, ok):
    assert bool(spec.UNIT.match(unit)) == ok


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_of_a_cell_is_found(cell):
    c = spec.cell_of(BENCH, ENTRIES[cell])
    assert c.limits
    for name in c.limits:
        assert callable(spec.load_module("numbers", name).value)
    assert callable(spec.load_module("variants", c.traffic["variant"]).run)
    obj = spec.load_module("objectives", c.objective)
    assert obj.FP_OPS > 0 and callable(obj.f32) and callable(obj.f64)
    assert {m["name"] for m in c.end_to_end} == {
        "solve_ms", "solve_ms_p95", "setup_s"}
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.load_reader(m["name"]))
        assert m["moves"] == "solve_ms"
    call = Workload(c, device="cpu").call
    kernels = [m["name"].split(".", 1)[1] for m in c.per_layer
               if m["name"].startswith("roofline_pct.")]
    assert kernels
    for k in kernels:
        cost = spec.load_module("costs", f"{k}_kernel")
        plan = cost.launches(call)
        assert sum(launch["iters"] for launch in plan) == call["iters"]
        assert all(cost.cost(launch)["bytes"] > 0 for launch in plan)


def test_forbidden_names_compare_whole():
    mods = ["repro_torch", "repro_torch.api", "repro", "repro.core.pso",
            "jax", "jax.numpy", "jaxlib", "jaxtyping", "flax.linen",
            "benchmarks", "benchmarks.run", "benchmarks_x", "pso_bench"]
    assert harness.forbidden_modules(mods) == [
        "benchmarks", "benchmarks.run", "flax.linen", "jax", "jax.numpy",
        "jaxlib", "repro", "repro.core.pso"]


CHIP_PATH = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
from pso_bench import check, control, harness, peaks, reference, spec, trace
from pso_bench import workload
import repro_torch, repro_torch.api, repro_torch.kernels.ops
import repro_torch.kernels.pso_split, repro_torch.kernels.pso_step
b = spec.load_benchmark()
for w in b["workloads"]:
    c = spec.find_cell(b, w["name"])
    wl = workload.Workload(c, device="cpu")
    reference.Reference(c.config, c.objective)
    for name in c.limits:
        spec.load_module("numbers", name)
    spec.load_module("variants", c.traffic["variant"])
    for m in c.per_layer:
        spec.load_reader(m["name"])
    for k in ("fused_kernel", "async_kernel"):
        spec.load_cost(k)
print(harness.forbidden_modules(sys.modules))
"""


def test_chip_path_imports_no_jax():
    code = CHIP_PATH.format(src=str(spec.ROOT / "src"), root=str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result(tmp_path):
    cmd = [sys.executable, "pso_bench/run.py", "--workload", CELLS[0],
           "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                         cwd=spec.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "pso_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def small(cell: str):
    """``cell`` at a size the CPU runs in a moment."""
    c = spec.cell_of(BENCH, ENTRIES[cell])
    cfg = dict(c.config, dim=min(c.config["dim"], 4), particles=1024,
               iters=24, block_n=256)
    return dataclasses.replace(c, config=cfg)


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_on_the_cpu(cell, traced):
    c = small(cell)
    out, lines = harness.run_cell(c, 2**31 + 17, 0.3, traced,
                                  time.perf_counter(), device="cpu")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "check"
    assert list(out["check"]) == list(c.limits)
    assert lines[0].startswith("setup_s ") and "warm_solve" in lines[0]
    assert len(lines) == 1 + len(c.limits)
    assert all(ln.startswith("check ") for ln in lines[1:])
    if traced:
        assert "breakdown" in out and "window_s" in out["device"]
        assert set(out["metrics"]) <= {m["name"] for m in c.per_layer}
    else:
        assert set(out["metrics"]) == {"solve_ms", "solve_ms_p95", "setup_s"}
        assert all(m["value"] > 0 for m in out["metrics"].values())
    json.dumps(out)


def _summary():
    """A traced window of two solves, each an async launch and two
    elementwise kernels, with a copy between the solves; the host in a
    runtime call over part of it."""
    ops, t = [], 0.0
    for _ in range(2):
        for name, dur in (("void (anonymous namespace)::async_kernel"
                           "<float, 0>(Params)", 4.0),
                          ("void at::native::vectorized_elementwise_kernel"
                           "<4, Mul>(int)", 2.0),
                          ("void at::native::reduce_kernel<512, 1>(R)", 1.0),
                          ("Memcpy DtoH (Device -> Pageable)", 2.0)):
            ops.append((name, t, t + dur))
            t += dur + 1.0
        t += 2.0
    busy, gaps = trace._union(ops)
    call = dict(d=1, n=1024, iters=8, sync_every=8, block_n=512, esize=4,
                objective="cubic", variant="async")
    return {"window_s": 40e-6, "busy_s": busy / 1e6, "solves": 2,
            "ops": ops, "gaps": gaps, "call": call,
            "host": [("cudaStreamSynchronize", 5.5, 8.0)]}


def test_union_of_the_ops():
    s = _summary()
    assert s["busy_s"] == pytest.approx(18e-6)
    assert [g[:2] for g in s["gaps"]][:2] == [(4.0, 5.0), (7.0, 8.0)]
    assert len(s["gaps"]) == 7


@pytest.mark.parametrize("metric,want", [
    ("device_idle_pct", 55.0), ("launches_per_solve", 4.0),
    ("roofline_pct.fused", None)])
def test_readers_on_a_summary(metric, want):
    got = spec.load_reader(metric)(_summary())
    assert got == (None if want is None else pytest.approx(want))


def test_roofline_reads_the_planned_launches():
    s = _summary()
    cost = spec.load_module("costs", "async_kernel")
    bound = sum(peaks.bound_ms(cost.cost(x)) for x in cost.launches(s["call"]))
    want = 100.0 * bound * 2 * 1e3 / 8.0
    assert spec.load_reader("roofline_pct.async")(s) == pytest.approx(want)
    s["call"] = dict(s["call"], iters=12)      # two launches a solve planned
    assert spec.load_reader("roofline_pct.async")(s) is None


def test_breakdown_names_gaps_by_the_host():
    b = trace.breakdown(_summary())
    assert b["idle_gaps"][0] == ["python: Memcpy DtoH (Device -> Pageable)"
                                 " > async_kernel", 3e-6]
    assert ["cudaStreamSynchronize: vectorized_elementwise_kernel"
            " > reduce_kernel", 1e-6] in b["idle_gaps"]
    assert b["device_ops"][0] == ["async_kernel", 8e-6]
