"""The port's program spans (``repro_torch.telemetry.trace``) on the CPU:
the spans of one solve, their ids and parents, the clock they share with
``torch.profiler``'s events, when they record, the default writer's bound,
and the writers ``profiler_session``, ``pso_run --trace-out`` and
``solve_stream(trace=)`` fill."""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch
from repro_torch.core import pso
from repro_torch.kernels import ops, pso_step
from repro_torch.launch import pso_run
from repro_torch.launch.serve import SolveRequest
from repro_torch.telemetry import (TraceWriter, profiler_session, recording,
                                   spans)
from repro_torch.telemetry import trace

torch.set_num_threads(1)

#: (variant, iterations, the kernel's launches): one fused launch; the
#: async kernel's 16 iterations in chunks of 8, then a remainder launch of
#: 4, in one call of its wrapper and one ``ops.launch`` span.
CALLS = [("queue_lock", 12, 1), ("async", 20, 2)]


def _solve(variant, iters):
    return repro_torch.solve("cubic", dim=3, particles=256, iters=iters,
                             seed=4, variant=variant, sync_every=8,
                             block_n=64, backend="kernel", device="cpu")


def _traced(variant, iters):
    """One solve and a read of ``best_fit`` under ``torch.profiler``:
    (the spans they recorded, the profiler's operator events as (name,
    start us, end us))."""
    n0 = len(spans())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _solve(variant, iters).best_fit
    got = spans()[n0:]
    ev = [(e.name(), e.start_ns() / 1e3,
           (e.start_ns() + e.duration_ns()) / 1e3)
          for e in prof.profiler.kineto_results.events()
          if e.name().startswith("aten::")]
    return got, ev


@pytest.mark.parametrize("variant,iters,launches", CALLS)
def test_a_solve_records_its_spans(variant, iters, launches):
    got, _ = _traced(variant, iters)
    names = [e["name"] for e in got]
    assert sorted(names) == sorted(
        ["api.solve", "pso.init_swarm", "ops.pack", "ops.launch",
         "ops.unpack", "api.read"])
    by = {e["args"]["id"]: e for e in got}
    solve, = [e for e in got if e["name"] == "api.solve"]
    sid = solve["args"]["id"]
    assert solve["args"]["parent"] is None and solve["args"]["solve"] == sid
    inner = [e for e in got if e["name"] not in ("api.solve", "api.read")]
    # init, pack, the launches and the unpack, in order, inside the solve
    order = sorted(inner, key=lambda e: e["ts"])
    assert [e["name"] for e in order] == [
        "pso.init_swarm", "ops.pack", "ops.launch", "ops.unpack"]
    for a, b in zip(order, order[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]
    for e in inner:
        assert e["args"]["parent"] == sid and e["args"]["solve"] == sid
        assert solve["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= solve["ts"] + solve["dur"]
    launch, = [e["args"] for e in order if e["name"] == "ops.launch"]
    assert launch["iters"] == iters
    if variant == "queue_lock":
        assert launch["kernel"] == "fused_kernel"
        assert launch["sync_every"] is None
    else:               # the remainder, read off the span's args
        assert launch["kernel"] == "async_kernel"
        assert len(pso_step.async_spans(iters, launch["sync_every"])) \
            == launches
    read, = [e for e in got if e["name"] == "api.read"]
    assert read["args"]["solve"] == sid and read["args"]["parent"] is None
    assert read["ts"] >= solve["ts"] + solve["dur"]
    assert len(by) == len(got)


@pytest.mark.parametrize("variant,iters,launches", CALLS)
def test_spans_hold_the_operators_they_issued(variant, iters, launches):
    """The clock check: every torch operator the solve ran lies inside
    ``api.solve``, and each one that starts inside a span of init, pack,
    launch or unpack ends inside it; each of those spans holds some."""
    got, ev = _traced(variant, iters)
    solve, = [e for e in got if e["name"] == "api.solve"]
    s0, s1 = solve["ts"], solve["ts"] + solve["dur"]
    read, = [e for e in got if e["name"] == "api.read"]
    r0, r1 = read["ts"], read["ts"] + read["dur"]
    assert all(s0 <= a and b <= s1 or r0 <= a and b <= r1
               for _, a, b in ev)
    for e in got:
        if e["name"] == "api.solve":
            continue
        t0, t1 = e["ts"], e["ts"] + e["dur"]
        held = [(a, b) for _, a, b in ev if t0 <= a < t1]
        assert held, e["name"]
        assert all(b <= t1 for _, b in held), e["name"]


def test_nothing_records_without_a_profiler_or_a_writer():
    n0 = len(spans())
    assert trace.begin("api.solve") is None
    trace.end(None)
    _solve("async", 20).best_fit
    assert len(spans()) == n0


def test_an_installed_writer_records_without_a_profiler():
    n0 = len(spans())
    w = TraceWriter()
    with recording(w):
        _solve("queue_lock", 12).best_fit
    assert len(spans()) == n0
    assert [e["name"] for e in spans(w)] == [
        "pso.init_swarm", "ops.pack", "ops.launch", "ops.unpack",
        "api.solve", "api.read"]


def test_the_default_writer_is_bounded(monkeypatch):
    monkeypatch.setattr(trace, "_default", TraceWriter())
    monkeypatch.setattr(trace, "SPAN_LIMIT", 4)
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(50):
            trace.end(trace.begin(f"s{k}"))
    kept = spans()
    assert 4 <= len(kept) <= 8
    assert kept[-1]["name"] == "s49"
    assert [e["args"]["id"] for e in kept] == sorted(
        e["args"]["id"] for e in kept)
    assert len(trace._default._events) <= 8
    w = TraceWriter()       # an installed writer keeps every span
    with recording(w):
        for k in range(50):
            trace.end(trace.begin(f"s{k}"))
    assert len(spans(w)) == 50


def test_a_span_left_open_by_an_error_is_dropped():
    w = TraceWriter()
    with recording(w):
        outer = trace.begin("outer")
        trace.begin("left open")
        trace.end(outer)
        after = trace.begin("after")
        trace.end(after)
    got = {e["name"]: e["args"] for e in spans(w)}
    assert set(got) == {"outer", "after"}
    assert got["after"]["parent"] is None


def test_an_async_remainder_is_one_wrapper_call(monkeypatch):
    """Traced or not, a solve whose async iterations leave a remainder
    calls the async wrapper once, as without spans: the remainder is the
    wrapper's second launch, not a call of its own."""
    calls = []
    wrapped = pso_step.fused_async

    def counted(*a, **k):
        calls.append(k["iters"])
        return wrapped(*a, **k)

    monkeypatch.setattr(pso_step, "fused_async", counted)
    _solve("async", 20).best_fit
    with recording(TraceWriter()):
        _solve("async", 20).best_fit
    assert calls == [20, 20]


def test_profiler_session_writes_the_spans_on_its_clock(tmp_path):
    n0 = len(spans())
    with profiler_session(str(tmp_path)) as on:
        res = _solve("async", 20)
    assert on
    sid = res.solve_id
    assert sid is not None
    doc = json.loads((tmp_path / "torch_trace.json").read_text())
    ev = doc["traceEvents"]
    solve, = [e for e in ev if e.get("name") == "api.solve"]
    assert solve["args"]["id"] == sid
    assert len([e for e in ev if e.get("cat") == trace.SPAN_CAT]) == 5
    aten = [e for e in ev if e.get("name", "").startswith("aten::")]
    assert aten
    assert all(solve["ts"] <= e["ts"]
               and e["ts"] + e["dur"] <= solve["ts"] + solve["dur"]
               for e in aten)
    assert len(spans()) - n0 == 5


def test_pso_run_writes_its_spans_beside_its_chunks(tmp_path, capsys):
    out, prof = tmp_path / "trace.json", tmp_path / "prof"
    assert pso_run.main([
        "--dim", "2", "--particles", "128", "--iters", "12",
        "--variant", "async", "--sync-every", "4", "--kernel",
        "--ckpt-every", "6", "--device", "cpu", "--trace-out", str(out),
        "--profile-dir", str(prof)]) == 0
    ev = [e for e in json.loads(out.read_text())["traceEvents"]
          if e["ph"] == "X"]
    chunks = [e for e in ev if e["name"].startswith("chunk")]
    launches = [e for e in ev if e["name"] == "ops.launch"]
    assert len(chunks) == 2 and len(launches) == 2     # 4 + a remainder of 2
    for c in chunks:
        inside = [e for e in launches if c["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= c["ts"] + c["dur"]]
        assert [e["args"]["iters"] for e in inside] == [6]
    doc = json.loads((prof / "torch_trace.json").read_text())
    assert len([e for e in doc["traceEvents"]
                if e.get("name") == "ops.launch"]) == 2


def test_solve_stream_trace_shares_the_spans_clock():
    """A writer given to ``solve_stream`` as ``trace=`` and installed with
    ``recording`` holds the scheduler's timeline and the program's spans
    on one clock: every event lies within the call, and a standalone
    request's ``api.solve`` inside its ``standalone`` event."""
    reqs = [SolveRequest(fitness="cubic", dim=4, particle_cnt=128, iters=12,
                         seed=5, variant="async", sync_every=4),
            SolveRequest(fitness="cubic", dim=4, particle_cnt=128, iters=12,
                         seed=9, variant="queue")]
    w = TraceWriter()
    t0 = trace.now_us()
    with recording(w):
        repro_torch.solve_stream(reqs, lane_width=4, trace=w,
                                 backend="kernel", device="cpu")
    t1 = trace.now_us()
    ev = [e for e in w._events if "ts" in e]
    assert all(t0 <= e["ts"] and e["ts"] + e.get("dur", 0) <= t1
               for e in ev)
    alone, = [e for e in ev if e["name"].startswith("standalone t")]
    solves = [e for e in spans(w) if e["name"] == "api.solve"
              and alone["ts"] <= e["ts"]
              and e["ts"] + e["dur"] <= alone["ts"] + alone["dur"]]
    assert len(solves) == 1
