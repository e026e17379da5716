#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA Hopper card.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and ``nvidia-smi``; it
imports only ``repro_torch`` (from ``src/``), ``torch``, ``numpy`` and the
standard library, and exits non-zero on any failure. Phases:

1. identity: torch and CUDA versions, ``nvcc --version``, the card's name
   and power limit;
2. build: compiles ``src/repro_torch/kernels/csrc/*.cu`` for ``sm_90a`` (one
   ``nvcc`` per source, started together) and prints ``-Xptxas -v``;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes, with the tolerances stated below: fused launches of one
   to six iterations, the async kernel with one block, and the async
   kernel over many blocks held to its invariants;
4. the main path: ``repro_torch.solve`` on the default device with
   ``backend="auto"`` for the paper's largest swarms (Table 4: cubic d=1
   n=131072; Table 5: cubic d=120 n=32768), both kernel variants, with the
   kernel launch counts of each run, and the eager ``reduction`` variant
   timed at the same shapes as the paper's baseline;
5. one JSON line ``{"kernels": [...]}`` (launches on the main path, maximum
   error against the plain version, kernel and plain times on the same
   call, and the card's bound for that call), the card line, and a last
   line ``{"ok": true, "device": {...}}``.
"""
import concurrent.futures
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import repro_torch  # noqa: E402
from repro_torch.core import pso  # noqa: E402
from repro_torch.core.fitness import FITNESS_IDS  # noqa: E402
from repro_torch.core.update_rules import RULE_IDS  # noqa: E402
from repro_torch.kernels import _build, ops, pso_step  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and 67 TFLOP/s of
# float32 outside the tensor cores, which counts an FMA as two operations.
# The kernels issue no FMA (see csrc/pso_step.cu), so a single float32
# operation runs at half that rate. An sm_90 SM has half as many 32-bit
# integer lanes as float32 lanes (64 against 128 a clock; CUDA C++
# Programming Guide, arithmetic instruction throughput), and its four
# schedulers issue 128 thread-operations a clock in all: the float32 rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
INT32_OPS_PER_S = FP32_OPS_PER_S / 2
ISSUE_OPS_PER_S = FP32_OPS_PER_S

# Operations per particle-dimension-iteration of the cubic/pso path, counted
# from csrc/pso_step.cu, work shared by all elements of an iteration left
# out. Integer: the element index (1); the two draws' first terms, idx * C
# plus a per-stream constant (2); their shared second term (1); two mix32
# rounds per draw, each three shift-xors and two multiplies (2 * 2 * 8);
# the xor of the second term (2); the shift and int-to-float conversion (4).
# Float: the 2^-24 scale (2), the pso rule (14), the cubic term and its
# accumulation (8). Per particle-iteration: the pbest and queue compares.
INT_PER_ELEMENT = 1 + 2 + 1 + 32 + 2 + 4
FP_PER_ELEMENT = 2 + 14 + 8
FP_PER_PARTICLE = 2

# Phase-3 tolerances. The kernels round like the plain versions (no FMA
# contraction, same operation order), so positions agree to rounding; the
# objective sums D terms in another order than torch.sum, which moves a
# fitness by an ulp of its largest terms.
POS_TOL = dict(rtol=2e-6, atol=1e-5)
FIT_RTOL = 1e-5

OPTIMUM_PER_DIM = 9.0e5   # cubic's maximum, at x = 100 in every dimension


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def sync_time(fn, reps: int = 1) -> float:
    """Seconds per call of ``fn`` with CUDA events, after one warm call."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def max_err(got, want) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def fit_tol(ref) -> dict:
    return dict(rtol=FIT_RTOL, atol=FIT_RTOL * max(1.0, float(ref.abs().max())))


def disagreeing(got, want, names) -> dict:
    """The fields where a kernel's state leaves the tolerance against the
    plain one, each with its max |kernel - plain|."""
    bad = {}
    for a, b, name in zip(got, want, names):
        tol = fit_tol(b) if name in ("pbf", "gf", "lf") else POS_TOL
        if not torch.allclose(a, b, **tol):
            bad[name] = float((a - b).abs().max())
    return bad


def compare(got, want, names, what):
    """Field-by-field check of a kernel's state against the plain one."""
    bad = disagreeing(got, want, names)
    check(not bad, f"{what}: kernel and plain disagree, max error {bad}")
    return max_err(got, want)


FUSED_FIELDS = ("pos", "vel", "pbp", "pbf", "gp", "gf")
ASYNC_FIELDS = FUSED_FIELDS + ("lp", "lf")


def gbest_is_a_pbest(pbp, pbf, gp, gf) -> bool:
    """The torn-write check that holds at any D: gbest_pos is, bit for bit,
    the pbest position (``pbp`` D-major) of a particle whose pbest fitness
    is gbest_fit. A gbest copied half from one winner and half from another
    matches no column, whatever fitness it has."""
    cols = pbp[:, pbf == gf.reshape(1)]
    return bool((cols == gp[:, None]).all(0).any())


def is_flip(cfg, prev, want, got) -> bool:
    """Whether a fused launch's first disagreement with its plain version
    is a comparison flip at its last iteration. The two sum a particle's
    objective in different orders, so a fitness within the fitness
    tolerance of what it is compared with may go either way. Such a flip
    moves only pbest positions and gbest_pos; pos and vel, which depend on
    the iteration before, still agree. Every particle whose pbest position
    moved, and gbest if it moved, must have had that near tie in the plain
    run (``prev`` -> ``want``)."""
    bad = disagreeing(got, want, FUSED_FIELDS)
    if set(bad) - {"pbp", "gp"}:
        return False
    fit = cfg.fitness_fn(want[0].T)           # the plain run's last fitness
    tol = fit_tol(prev[3])["atol"]
    moved = ~torch.isclose(got[2], want[2], **POS_TOL).all(0)
    if bool((moved & ((fit - prev[3]).abs() > tol)).any()):
        return False
    if "gp" in bad:
        top, g = float(fit.max()), float(prev[5][0])
        if int((fit >= top - tol).sum()) < 2 and abs(top - g) > tol:
            return False
    return True


def kernel_state(fit: str, d: int, n: int, seed: int = 0):
    cfg = pso.PSOConfig(dim=d, particle_cnt=n, fitness=fit).resolved()
    s = pso.init_swarm(cfg, seed, device="cuda")
    return cfg, ops.kernel_spec(cfg), ops.state_to_kernel(s), s.seed


def with_locals(state, nb: int):
    return state + (state[4][:, None].repeat(1, nb).contiguous(),
                    state[5].repeat(nb))


def phase_build() -> None:
    sources = sorted(_build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        builds = list(pool.map(lambda p: _build.build(p.stem), sources))
    print(f"phase 2: built {len(sources)} source(s) for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    fits = {str(i): name for name, i in FITNESS_IDS.items()}
    rules = {str(i): name for name, i in RULE_IDS.items()}
    for (lib, log), src in zip(builds, sources):
        print(f"  {src.name} -> {lib.name}")
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
                # mangled <kernel>ILi<fitness>ELi<rule>E -> kernel<f,r>
                m = re.search(r"([a-z]+_kernel)ILi(\d+)ELi(\d+)E", entry)
                if m:
                    entry = f"{m[1]}<{fits[m[2]]},{rules[m[3]]}>"
            elif "Used" in line and entry:
                print(f"  {entry:34s} {line.split(':', 1)[1].strip()}")
            elif "spill" in line and \
                    "0 bytes spill stores, 0 bytes spill loads" not in line:
                print(f"  SPILL {entry}: {line.strip()}")


def fused_against_plain(fit, d, n, iters, offset, flips, errs) -> None:
    """Launches of k = 1..iters iterations, each ONE launch from the same
    state at a nonzero iteration offset, against the plain version iterated
    k times: they run the kernel's whole iteration loop, both key and
    candidate slots, each slot's reuse two iterations on, and the grid
    sync. Where ``flips`` is set (D > 1, where the objective is summed in
    another order) the check stops at the first comparison flip; at D = 1
    the two round alike and every launch must agree."""
    cfg, spec, state, seed = kernel_state(fit, d, n)
    bn = ops._resolve_block(n, None)
    want = state
    for k in range(1, iters + 1):
        prev = want
        want = pso_step.fused_plain(*prev, spec, seed=seed,
                                    iteration=offset + k - 1, iters=1,
                                    block_n=bn)
        got = pso_step.fused(*[x.clone() for x in state], spec, seed=seed,
                             iteration=offset, iters=k, block_n=bn)
        torch.cuda.synchronize()
        what = (f"fused {fit} d={d} n={n} ({n // bn} CTAs), iterations "
                f"{offset + 1}..{offset + k} in one launch")
        if flips and disagreeing(got, want, FUSED_FIELDS) \
                and is_flip(cfg, prev, want, got):
            print(f"  {what}: a comparison flip at a near tie in the last "
                  f"iteration; stopped there")
            return
        e = compare(got, want, FUSED_FIELDS, what)
        errs["fused"] = max(errs["fused"], e)
        print(f"  {what}: max |kernel - plain| = {e:.3g}")


def async_invariants(fit, d, n, sync_every, launches, iters) -> None:
    """The async kernel over several CTAs, whose order of publications is a
    race: held across launches to gbest monotone, gbest == max(pbest),
    positions inside the bounds, gbest_pos bit for bit a pbest position of
    fitness gbest (the torn-write check), and the fitness recomputed at
    gbest_pos equal to gbest_fit (exactly at D = 1; at D > 1 torch sums the
    objective in another order, so within the fitness tolerance)."""
    cfg, spec, state, seed = kernel_state(fit, d, n, seed=1)
    nb = n // 512
    state = with_locals(state, nb)
    prev = float(state[5][0])
    for launch in range(launches):
        pso_step.fused_async(*state, spec, seed=seed,
                             iteration=iters * launch, iters=iters,
                             sync_every=sync_every, block_n=512)
        torch.cuda.synchronize()
        pos, _, pbp, pbf, gp, gf = state[:6]
        g = float(gf[0])
        check(g >= prev, f"async gbest monotone ({g} < {prev})")
        check(g == float(pbf.max()), "async gbest == max(pbest)")
        check(gbest_is_a_pbest(pbp, pbf, gp, gf),
              "async gbest_pos is the pbest position of a particle of "
              "fitness gbest_fit")
        refit = cfg.fitness_fn(gp[None, :])
        check(float(refit[0]) == g if d == 1 else
              torch.allclose(refit, gf, **fit_tol(gf)),
              f"async fitness at gbest_pos {float(refit[0])} == {g}")
        lo, hi, _ = pso_step._operands(spec, pos.device)
        check(bool(((pos >= lo) & (pos <= hi)).all()),
              "async positions inside the bounds")
        prev = g
    print(f"  async {fit} d={d} n={n} {nb} blocks sync_every={sync_every}: "
          f"{launches} launches of {iters}, gbest {prev:.7g} monotone, == "
          f"max(pbest), == a pbest column, == f(gbest_pos); in bounds")


def phase_compare(errs) -> None:
    print("phase 3: kernels against their plain versions on the card")
    fused_against_plain("cubic", 1, 131072, 6, 37, False, errs)
    fused_against_plain("rastrigin", 120, 32768, 6, 5, True, errs)
    # Async, one block: equal to the plain block-major version, including
    # the remainder phase (53 = 6 * 8 + 5: two launches).
    _, spec, state, seed = kernel_state("cubic", 8, 512)
    state = with_locals(state, 1)
    kw = dict(seed=seed, iteration=0, iters=53, sync_every=8, block_n=512)
    want = pso_step.fused_async_plain(*state, spec, **kw)
    got = pso_step.fused_async(*[x.clone() for x in state], spec, **kw)
    torch.cuda.synchronize()
    e = compare(got, want, ASYNC_FIELDS, "async single block")
    errs["fused_async"] = max(errs["fused_async"], e)
    print(f"  async cubic d=8 n=512 one block, 53 iterations, sync_every=8: "
          f"max |kernel - plain| = {e:.3g}")
    # Async, several blocks, at both main-path shapes; rastrigin at d=120
    # does not run to the bounds, so its gbest_pos is no corner of the box
    # and a torn copy of it shows.
    for sync_every in (8, 1):
        async_invariants("cubic", 1, 131072, sync_every, 3, 16)
        async_invariants("rastrigin", 120, 32768, sync_every, 3, 8)


def phase_main_path(card: str):
    print("phase 4: main path, repro_torch.solve(backend='auto') on the "
          "default device")
    launches = {"fused": 0, "fused_async": 0}
    wrappers = {"fused": pso_step.fused, "fused_async": pso_step.fused_async}
    runs = []
    for d, n, iters in ((1, 131072, 1000), (120, 32768, 200)):
        for variant in ("queue_lock", "async", "reduction"):
            kw = dict(dim=d, particles=n, seed=0, variant=variant)
            repro_torch.solve("cubic", iters=2, **kw)          # warm-up
            for w in wrappers.values():
                w.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = repro_torch.solve("cubic", iters=iters, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = {k: w.launches for k, w in wrappers.items()}
            for k in counts:
                launches[k] += counts[k]
            s = res.state
            g = res.best_fit
            want = {"queue_lock": "fused", "async": "fused_async"}.get(variant)
            if want:
                check(counts[want] > 0, f"{variant}: kernel {want} launched")
            else:
                check(not any(counts.values()), "reduction runs eager")
            check(s.pos.device.type == "cuda", "state on the card")
            check(math.isfinite(g), f"{variant} d={d}: finite gbest")
            check(g <= OPTIMUM_PER_DIM * d * (1 + 1e-6), "gbest <= optimum")
            check(g == float(s.pbest_fit.max()), "gbest == max(pbest)")
            check(gbest_is_a_pbest(s.pbest_pos.T, s.pbest_fit, s.gbest_pos,
                                   s.gbest_fit), "gbest_pos is a pbest")
            refit = float(res.config.fitness_fn(s.gbest_pos[None, :])[0])
            check(abs(refit - g) <= FIT_RTOL * abs(g), "f(gbest_pos) == gbest")
            mem = torch.cuda.max_memory_allocated()
            us = dt / iters * 1e6
            runs.append(dict(d=d, n=n, iters=iters, variant=variant, us=us))
            print(f"  cubic d={d} n={n} iters={iters} {variant:10s} "
                  f"gbest {g:.7g} (optimum {OPTIMUM_PER_DIM * d:.7g}) "
                  f"{us:9.2f} us/iter launches {counts} peak memory "
                  f"{mem / 2**20:.1f} MiB [{card}]")
    return launches, runs


def bound(d: int, n: int, iters: int, nb: int = 0):
    """(ms, "bytes" | "operations"): the least time for the call — each
    input read once and each output written once (pos, vel, pbp, pbf,
    gbest, plus the async locals) at the HBM rate, or the operations at the
    card's rates (integer pipe, float32 pipe, issue), whichever is
    largest."""
    words = 3 * n * d + n + d + 1 + nb * (d + 1)
    by_bytes = 2 * 4 * words / HBM_BYTES_PER_S
    ints = iters * n * d * INT_PER_ELEMENT
    fps = iters * n * (d * FP_PER_ELEMENT + FP_PER_PARTICLE)
    by_ops = max(ints / INT32_OPS_PER_S, fps / FP32_OPS_PER_S,
                 (ints + fps) / ISSUE_OPS_PER_S)
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def phase_times():
    """Kernel and plain version on the same call: the main path's cubic
    d=1 n=131072 swarm, 32 iterations (4 async chunks of 8)."""
    d, n, iters, bn = 1, 131072, 32, 512
    nb = n // bn
    _, spec, state, seed = kernel_state("cubic", d, n)
    kw = dict(seed=seed, iteration=0, iters=iters, block_n=bn)
    akw = dict(kw, sync_every=8)
    fstate = [x.clone() for x in state]
    astate = [x.clone() for x in with_locals(state, nb)]
    t = {
        "fused": sync_time(lambda: pso_step.fused(*fstate, spec, **kw), 20),
        "fused_plain": sync_time(
            lambda: pso_step.fused_plain(*state, spec, **kw), 3),
        "fused_async": sync_time(
            lambda: pso_step.fused_async(*astate, spec, **akw), 20),
        "fused_async_plain": sync_time(
            lambda: pso_step.fused_async_plain(*with_locals(state, nb), spec,
                                               **akw), 1),
    }
    shape = dict(d=d, n=n, iters=iters, nb=nb)
    return t, shape


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"phase 1: torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"{nvcc[-1]}; card: {card}; "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    phase_build()
    errs = {"fused": 0.0, "fused_async": 0.0}
    phase_compare(errs)
    launches, _ = phase_main_path(card)
    times, shape = phase_times()
    print(f"phase 5: kernel and plain times on cubic d={shape['d']} "
          f"n={shape['n']}, {shape['iters']} iterations [{card}]")
    src = "src/repro_torch/kernels/csrc/pso_step.cu"
    kernels = []
    for name, replaces, nb in (
            ("fused", "src/repro/kernels/pso_step.py:874", 0),
            ("fused_async", "src/repro/kernels/pso_step.py:1349",
             shape["nb"])):
        b_ms, b_by = bound(shape["d"], shape["n"], shape["iters"], nb)
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": times[name] * 1e3, "plain_ms": times[name + "_plain"] * 1e3,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
        k = kernels[-1]
        print(f"  {name}: {k['ms']:.4f} ms (plain {k['plain_ms']:.2f} ms, "
              f"bound {k['bound_ms']:.4f} ms by {k['bound_by']}), "
              f"{k['launches']} launch(es) on the main path")
    check(all(k["launches"] > 0 for k in kernels), "every kernel launched")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
