"""The kernel cost files (``costs/*.py``) against ``chip_smoke``'s counts
at the shapes of the port's kernel table: the same bytes and operations,
and a bound in ms that differs only by the corrected rates (float32 and
integer at twice chip_smoke's rates, an FMA or IMAD counted as two
operations, and no issue-rate term); and the launches a solve plans."""
import pytest

import chip_smoke as cs
from pso_bench import peaks
from pso_bench.spec import load_cost, load_module

SHAPES = [(1, 131072, 1000), (1, 131072, 10000), (120, 32768, 200)]


def _counts(monkeypatch, fn, *args, **kw):
    """What ``chip_smoke`` passes to ``roof``: (bytes, int ops, fp ops)."""
    monkeypatch.setattr(cs, "roof", lambda b, i, f: (b, i, f))
    return fn(*args, **kw)


def _as_tuple(cost):
    return cost["bytes"], cost["int_ops"], cost["fp_ops"]


@pytest.mark.parametrize("d,n,iters", SHAPES)
@pytest.mark.parametrize("kernel", ["fused_kernel", "async_kernel"])
def test_pso_step_counts_are_chip_smokes(monkeypatch, kernel, d, n, iters):
    nb = n // 512 if kernel == "async_kernel" else 0
    got = load_cost(kernel)(dict(d=d, n=n, iters=iters, nb=nb, esize=4,
                                 objective="cubic"))
    assert _as_tuple(got) == _counts(monkeypatch, cs.bound, d, n, iters, nb)


@pytest.mark.parametrize("iters,every,want", [
    (200, 8, [200]), (10000, 8, [10000]), (13, 8, [8, 5]), (5, 8, [5])])
def test_async_launches_by_chunk(iters, every, want):
    call = dict(d=1, n=1024, iters=iters, sync_every=every, block_n=512,
                esize=4, objective="cubic")
    plan = load_module("costs", "async_kernel").launches(call)
    assert [x["iters"] for x in plan] == want
    assert all(x["nb"] == 2 for x in plan)
    fused = load_module("costs", "fused_kernel").launches(call)
    assert [(x["iters"], x["nb"]) for x in fused] == [(iters, 0)]


def test_rates_are_chip_smokes_corrected():
    assert peaks.HBM_BYTES_PER_S == cs.HBM_BYTES_PER_S
    assert peaks.FP32_OPS_PER_S == 2 * cs.FP32_OPS_PER_S
    assert peaks.INT32_OPS_PER_S == 2 * cs.INT32_OPS_PER_S


@pytest.mark.parametrize("d,n,iters", SHAPES)
def test_bound_differs_only_by_the_rates(monkeypatch, d, n, iters):
    cost = load_cost("async_kernel")(dict(d=d, n=n, iters=iters,
                                          nb=n // 512, objective="cubic"))
    b, i, f = _as_tuple(cost)
    want = 1e3 * max(b / cs.HBM_BYTES_PER_S, i / (2 * cs.INT32_OPS_PER_S),
                     f / (2 * cs.FP32_OPS_PER_S))
    assert peaks.bound_ms(cost) == pytest.approx(want, rel=1e-12)
    chip_ms, _ = cs.bound(d, n, iters, n // 512)
    assert peaks.bound_ms(cost) <= chip_ms
