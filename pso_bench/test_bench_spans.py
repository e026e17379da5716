"""The readers of the program's spans (``spans.py``, ``metrics/host_ms.*``,
``wait_ms.read``, ``launches_per_solve.init``, ``device_ms.init``,
``idle_pct.*``) on a synthetic traced window, and on the CPU's traced runs
of every cell."""
import time

import pytest

from pso_bench import harness, spans, spec, trace
from pso_bench.test_bench_harness import CELLS, small

NEW = ["host_ms.facade", "host_ms.init", "host_ms.ops", "wait_ms.read",
       "launches_per_solve.init", "device_ms.init", "idle_pct.facade",
       "idle_pct.init", "idle_pct.ops"]


def _span(name, start, end, sid, parent, solve):
    return {"name": name, "ph": "X", "cat": "repro_torch", "ts": start,
            "dur": end - start, "pid": 1, "tid": 1,
            "args": {"id": sid, "parent": parent, "solve": solve}}


def _window():
    """Two solves 100 us apart: ``api.solve`` [0, 60] holding init [2,
    20], pack [22, 30], launch [32, 40] and unpack [42, 50], then
    ``api.read`` [62, 90]; the caller's own code to 100. Init issues two
    kernels, pack one, the launch the long kernel, the unpack one and the
    read a copy, each by its runtime call; a ``cudaMalloc`` and a
    ``cudaStreamSynchronize`` issue nothing. The first operation starts at
    4 and the window at 4, the last ends at 173 and the window there: no
    idle edge. Spans of an earlier profiled region lie before it."""
    ops, host, events = [], [], []
    for k in range(2):
        b, i = 100.0 * k, 10 * k
        events += [_span("api.solve", b, b + 60, i + 1, None, i + 1),
                   _span("pso.init_swarm", b + 2, b + 20, i + 2, i + 1, i + 1),
                   _span("ops.pack", b + 22, b + 30, i + 3, i + 1, i + 1),
                   _span("ops.launch", b + 32, b + 40, i + 4, i + 1, i + 1),
                   _span("ops.unpack", b + 42, b + 50, i + 5, i + 1, i + 1),
                   _span("api.read", b + 62, b + 90, i + 6, None, i + 1)]
        for call, at, op, s, e in (
                ("cudaLaunchKernel", 3, "k_init_a", 4, 8),
                ("cudaMalloc", 6, None, 0, 0),
                ("cudaLaunchKernel", 7, "k_init_b", 9, 12),
                ("cudaLaunchKernel", 23, "k_pack", 24, 26),
                ("cudaLaunchKernelExC", 33, "async_kernel", 34, 70),
                ("cudaLaunchKernel", 43, "k_unpack", 70, 72),
                ("cudaMemcpyAsync", 63, "Memcpy DtoH", 72, 73),
                ("cudaStreamSynchronize", 64, None, 0, 0)):
            host.append((call, b + at, b + at + 0.5))
            if op:
                ops.append((op, b + s, b + e))
    busy, gaps = trace._union(ops)
    earlier = [_span("api.solve", -900.0, -800.0, 99, None, 99),
               _span("pso.init_swarm", -890.0, -850.0, 98, 99, 99)]
    summary = {"window_s": 169e-6, "busy_s": busy / 1e6, "solves": 2,
               "ops": ops, "gaps": gaps, "host": host, "call": {}}
    return summary, earlier + events


@pytest.mark.parametrize("metric,want", [
    ("host_ms.facade", 0.018),      # 60 less 18 + 8 + 8 + 8 a solve
    ("host_ms.init", 0.018), ("host_ms.ops", 0.024),
    ("wait_ms.read", 0.028), ("launches_per_solve.init", 2.0),
    ("device_ms.init", 0.007),
    ("idle_pct.facade", 100 * 10 / 169), ("idle_pct.init", 100 * 20 / 169),
    ("idle_pct.ops", 100 * 16 / 169)])
def test_readers_on_a_window(metric, want):
    summary, events = _window()
    got = spec.load_reader(metric)(summary, events)
    assert got == pytest.approx(want)


def test_the_idle_parts_add_up_to_the_idle_share():
    summary, events = _window()
    parts = spans.idle_us(summary, events)
    assert parts == pytest.approx({"facade": 10.0, "init": 20.0,
                                   "ops": 16.0, "read": 17.0, "other": 0.0,
                                   "caller": 10.0})
    idle = spec.load_reader("device_idle_pct")(summary)
    assert 100 * sum(parts.values()) / 169 == pytest.approx(idle)


def test_a_device_clock_that_leads_is_moved_onto_the_host():
    """Device timestamps 50 us early (every operation then starts before
    its call, by 50 less its 1 or 2 us of launch latency) are moved 48 or
    49 us later before the gaps are split: each gap lies 1 or 2 us before
    its place on the true clock."""
    summary, events = _window()
    assert spans.device_lags(summary) == [0.0] * len(summary["gaps"])
    early = dict(summary, ops=[(n, s - 50, e - 50) for n, s, e in
                               summary["ops"]],
                 gaps=[(a - 50, b - 50, i) for a, b, i in summary["gaps"]])
    assert spans.device_lags(early) == [48.0, 49.0, 49.0, 49.0, 48.0, 49.0,
                                        49.0]
    got = spans.idle_us(early, events)
    want = spans.idle_us(dict(summary, gaps=[
        (a + lag - 50, b + lag - 50, i) for (a, b, i), lag in
        zip(summary["gaps"], spans.device_lags(early))]), events)
    assert got == pytest.approx(want)
    assert sum(got.values()) == pytest.approx(73.0)


def test_a_device_clock_that_drifts_is_followed():
    """Device timestamps that fall behind from the second solve on (every
    operation of it 30 us early, so the gap before it reads 1 us where it
    was 31): the first solve's gaps stay, the second's move 28 or 29 us
    later and fall in init, pack and the launch as the first solve's do
    (init 11 us, ``api.solve`` 4, ops 7), none in the read or the
    caller."""
    summary, events = _window()
    ops = [(n, s - 30 * (s > 100), e - 30 * (s > 100))
           for n, s, e in summary["ops"]]
    busy, gaps = trace._union(ops)
    drift = dict(summary, ops=ops, gaps=gaps, busy_s=busy / 1e6)
    assert spans.device_lags(drift) == [0.0] * 3 + [29.0, 28.0, 29.0, 29.0]
    assert spans.idle_us(drift, events) == pytest.approx(
        {"facade": 8.0, "init": 20.0, "ops": 15.0, "read": 0.0,
         "other": 0.0, "caller": 0.0})


def test_one_operation_that_leads_its_call_moves_no_other_gap():
    """An operation whose own start is early (the first pack kernel at
    13, ten us before its call) shortens its own gap, 12 to 24 become 12
    to 13, which it moves ten us later, into pack; the next operation
    issued into an idle device (the async kernel, 1 us after its call)
    puts the lag back to 0, so no other gap moves."""
    summary, events = _window()
    ops = list(summary["ops"])
    ops[2] = ("k_pack", 13.0, 26.0)
    busy, gaps = trace._union(ops)
    odd = dict(summary, ops=ops, gaps=gaps, busy_s=busy / 1e6)
    assert spans.device_lags(odd) == [0.0, 10.0] + [0.0] * 5
    got = spans.idle_us(odd, events)
    assert got == pytest.approx({"facade": 8.0, "init": 12.0, "ops": 15.0,
                                 "read": 17.0, "other": 0.0,
                                 "caller": 10.0})


def test_operations_pair_with_their_calls_in_issue_order():
    summary, events = _window()
    assert spans.issued(summary, events) == [
        "pso.init_swarm", "pso.init_swarm", "ops.pack", "ops.launch",
        "ops.unpack", "api.read"] * 2


def _lose(summary, op=None, call=None):
    """``summary`` with the trace's record of device operation ``op`` or of
    issuing call ``call`` (indices among those) lost."""
    ops = [o for k, o in enumerate(summary["ops"]) if k != op]
    issuing = [h for h in summary["host"] if h[0] in spans.ISSUING]
    host = [h for h in summary["host"]
            if h[0] not in spans.ISSUING or h is not
            (issuing[call] if call is not None else None)]
    busy, gaps = trace._union(ops)
    return dict(summary, ops=ops, host=host, gaps=gaps, busy_s=busy / 1e6)


def test_a_lost_operation_shifts_the_pairing_until_the_kinds_differ():
    """Init's second kernel lost: the pack's, the launch's and the unpack's
    kernels pair one call early until the read's copy meets its copy call;
    the second solve pairs as it should. Init's launches are counted by
    their calls, so they read 2 a solve still."""
    summary, events = _window()
    lost = _lose(summary, op=1)
    assert spans.issued(lost, events) == [
        "pso.init_swarm", "pso.init_swarm", "ops.pack", "ops.launch",
        "api.read"] + ["pso.init_swarm", "pso.init_swarm", "ops.pack",
                       "ops.launch", "ops.unpack", "api.read"]
    assert spec.load_reader("launches_per_solve.init")(
        lost, events) == pytest.approx(2.0)
    # init's kernels (4 + 3 us) and, one call early, the pack's (2 us)
    assert spec.load_reader("device_ms.init")(
        lost, events) == pytest.approx((4 + 2 + 4 + 3) / 2e3)


def test_a_lost_call_shifts_the_pairing_until_the_kinds_differ():
    """The second solve's first init call lost: its kernels pair one call
    late until the unpack's kernel meets the read's copy call, and that
    kernel is left unpaired."""
    summary, events = _window()
    lost = _lose(summary, call=6)
    got = spans.issued(lost, events)
    assert got == ["pso.init_swarm", "pso.init_swarm", "ops.pack",
                   "ops.launch", "ops.unpack", "api.read"] + [
        "pso.init_swarm", "ops.pack", "ops.launch", "ops.unpack", "",
        "api.read"]
    assert spec.load_reader("launches_per_solve.init")(
        lost, events) == pytest.approx(1.5)


def test_spans_outside_the_window_are_left_out():
    summary, events = _window()
    got = spans.window(summary, events)
    assert len(got) == 12 and all(s.id < 90 for s in got)
    outside = [e for e in events if e["args"]["id"] > 90]
    assert spans.window(summary, outside) == []
    assert spec.load_reader("host_ms.init")(summary, outside) is None


def test_no_spans_read_nothing():
    summary, _ = _window()
    for m in NEW:
        assert spec.load_reader(m)(summary, []) is None


def test_innermost_pieces():
    summary, events = _window()
    pieces = spans.innermost(spans.window(summary, events))
    assert pieces[:6] == [(0.0, 2.0, "api.solve"),
                          (2.0, 20.0, "pso.init_swarm"),
                          (20.0, 22.0, "api.solve"),
                          (22.0, 30.0, "ops.pack"),
                          (30.0, 32.0, "api.solve"),
                          (32.0, 40.0, "ops.launch")]
    assert (62.0, 90.0, "api.read") in pieces
    assert all(a[1] <= b[0] for a, b in zip(pieces, pieces[1:]))


@pytest.mark.parametrize("cell", CELLS)
def test_readers_on_a_traced_run_on_the_cpu(cell):
    """The CPU's traced run: every new reader gives a number or nothing
    (the CPU has no device operations), never an error."""
    c = small(cell)
    out, _ = harness.run_cell(c, 2**31 + 29, 0.3, True, time.perf_counter(),
                              device="cpu")
    assert {m["name"] for m in c.per_layer} >= set(NEW)
    got = out["metrics"]
    for m in ("host_ms.facade", "host_ms.init", "host_ms.ops",
              "wait_ms.read"):
        assert got[m]["value"] > 0
    for m in ("launches_per_solve.init", "device_ms.init", "idle_pct.facade",
              "idle_pct.init", "idle_pct.ops"):
        assert m not in got
