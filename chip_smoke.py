#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA Hopper card.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and ``nvidia-smi``; it
imports only ``repro_torch`` (from ``src/``), ``torch``, ``numpy`` and the
standard library, and exits non-zero on any failure. Phases:

1. identity: torch and CUDA versions, ``nvcc --version``, the card's name
   and power limit;
2. build: compiles ``src/repro_torch/kernels/csrc/*.cu`` for ``sm_90a`` (one
   ``nvcc`` per source, started together) and prints each kernel's
   registers and spills from ``-Xptxas -v``, and the tensor-core (HMMA)
   instructions of each GLA kernel's SASS (``cuobjdump``), which the
   chunk-state and chunk-output kernels must have;
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, with the tolerances stated below. Single swarm: the
   queue kernel chained over one to six iterations (each followed by the
   cross-block epilogue), also bit for bit against one fused launch of as
   many iterations; fused launches of one to six iterations, the async
   kernel with one block, and the async kernel over many blocks held to
   its invariants, also on clusters of 2 and 8 with a boundary every
   iteration; then the queue, fused and async kernels with each particle
   block on a cluster of CTAs, every objective with every rule at d=120
   and an uneven d=37, one block (the async kernel bit for bit the fused
   kernel) and two (the async kernel held to its invariants); d=1 kernels
   must equal their plain versions exactly. Batches:
   fused launches over S swarms at per-row iteration counters (several
   iterations where kernel and plain round alike), batch rows bit-equal to
   the single-swarm kernel (also across the waves of a batch larger than
   the card holds at once, and at one block a swarm in both variants),
   heterogeneous rows equal to their problem's single-swarm kernel, the
   same on clusters at d=120 for both kernels, and
   multi-block async batches held to the invariants row by row, also on
   clusters. GLA (3c):
   the kernel path at hymba-1.5B's SSD width (with the reference tests'
   gates and with the model's own), at the xLSTM-350M mLSTM head shape and
   at a padded sequence length, then each of its three kernels against its
   plain stage at the same shapes (H_in at every chunk). Every fused and
   async check runs with the contention counters too: on and off bit for
   bit the same state, the counts equal to the counting plain version's
   (batch rows: the single-swarm kernel's, across the waves) where the
   trajectory is deterministic, else held to the async invariants;
4. the main paths, each with every launch count set to 0 just before it and
   read just after: ``repro_torch.solve`` on the default device with
   ``backend="auto"`` for the paper's largest swarms (Table 4: cubic d=1
   n=131072; Table 5: cubic d=120 n=32768), both kernel variants, plus the
   eager ``reduction`` variant as the paper's baseline; then
   ``repro_torch.solve_many`` at the shapes of ``benchmarks/run.py``'s
   ``multi_swarm`` sweep (d=10, n=1024 and n=256) with S raised to fill the
   card, homogeneous and over the six built-ins, both kernel variants;
   4c: the paper's Tables 3, 4 and 5 at ``benchmarks/run.py``'s shapes,
   the numpy serial baseline on the host against the eager ``reduction`` and
   ``queue``, ``ops.queue_step`` iterated and the fused and async kernels
   (us per iteration and speed-up over serial); 4d: ``gla_forward`` at
   hymba-1.5B's SSD width, with the model's own gates; 4e: ``solve`` with
   ``telemetry=True, record_history=True`` at the paper's largest swarms,
   both kernel variants, in turns with telemetry off and counters only
   (the fused kernel's final state bit for bit the same in all three),
   ``solve_many`` with both at d=10, and a ``profiler_session`` whose
   trace names the fused kernel; 4f: the async kernel at cubic d=120
   n=32768 chunk by chunk, per chunk its counts, the particles whose pbest
   rose and its device us;
5. kernel and plain times on one call (GLA at hymba-1.5B's SSD width with
   both kinds of gates and at the xLSTM-350M head shape, each beside its
   bound, and the CTAs an SM of its kernels); the fused kernel at
   each cluster size (5b: single swarms, the queue
   kernel alone, and batches) and the async kernel at each cluster size
   (single swarms at d=120, a d=24 batch), each kernel's device time
   summed over its main-path launches (phases 4-4e) under
   ``torch.profiler`` beside its bound on the same launches (5c), then one
   JSON line ``{"kernels": [...]}`` (launches on the main paths, maximum
   error against the plain version, kernel and plain times on the
   same call, and the card's bound for that call; for the six fused and
   async rows also the counter checks made and the device us an iteration
   with counters off and on, each run from a copy of one starting state,
   in turns), the card line, and a last line ``{"ok": true, "device":
   {...}}``. Phase 5 also times the fused and async kernels alone at the
   paper's largest swarms with counters off and on, in turns.

Before the JSON line: 6, the split path (6a its three kernels against
their plain versions, 6b ``solve``/``solve_many`` of custom and constrained
Problems, 6c each split kernel's time); 7, the lbest topologies (ring, von
Neumann): the card's neighbour ids, one-block lbest runs bit for bit the
star's kernel and against their plain versions, the multi-block
invariants (a torn-read check in the kernels' own arithmetic) and ``solve``
of the star beside both topologies at the paper's largest swarms (us/iter,
gbest, the async kernel alone in turns, the counters and pbest rises),
``solve_many`` at phase 4e's batches, and the split path's lbest bit for
bit the eager engine's. The JSON line counts phase 7's lbest launches
under the async rows. 8, serving (``repro_torch.serving``,
``launch.serve``) on the kernel backend: 8a the reference serving tests'
11-request trace (d=10, sync_every 8, lane width 8) through
``ContinuousScheduler``, at n=128 bit for bit each request's standalone
``solve(..., backend="kernel", record_history=True)`` in one heterogeneous
lane (row 7) and in a homogeneous lane a built-in (row 6), at n=1024 held
to the async invariants; 8b 512 requests in waves of 64 (d=10, n=1024,
budgets 200-800) through one 128-row heterogeneous lane and through
``SolveServer`` (requests/s, e2e p50/p99, batch fill; the lane's CUDA
graph replay against ``ops.run_queue_lock`` for the same chunk, host and
device us; admission us; mean gbest beside ``solve_many``); 8c a
``queue_lock`` flush (rows 4 and 3), a custom Problem's lane (the split
path), a ``queue`` request and a ``CompileCache`` cold then warm. Its
launches count under rows 3-7 and the split rows of the JSON. 9, the
launcher, checkpoints and islands: 9a ``python -m
repro_torch.launch.pso_run --kernel`` in a subprocess at cubic d=120
n=32768 x200, a checkpoint every 50 iterations, ``queue_lock`` (its chunks
and a restored step 100 continued by one launch bit for bit one fused
launch of 200) and ``async --sync-every 8`` (gbest monotone over its
checkpoints, == max pbest, in the box); 9b ``solve`` with
``Method(queue_lock, islands=k, exchange_interval=10)`` at the same cell
(one island bit for bit one fused launch; 4 islands x10 against the fused
kernel's plain version as every island's local step; the invariants at
200; us/iter of 1 and 4 islands beside one launch) and the eager async
ring at d=10 n=4096; 9c ``checkpoint.save``/``restore`` of the 9a state.
Its launches, the CLI's from its printout, count under rows 2 and 5. 10,
the schedule autotuner (``core/autotune.py``, ``roofline/pso_cost.py``):
10a ``resolve_schedule(measure=True)`` on a fresh cache at cubic d=1
n=131072 x1000, cubic d=120 n=32768 x200 and rastrigin d=10 n=1024 S=128,
every measured candidate (variant, backend, block_n, cluster size C,
sync_every, predicted and measured µs/iter), the pick no slower than the
fixed anchor, a second resolve a cache hit with no launch; 10b
``solve``/``solve_many(schedule="auto")`` against the fixed Method it
resolved to (bit for bit where the run is one trajectory, else the async
invariants) and the fixed default, with the resolve's cost; 10c the card's
calibration from its own records (the eager engine's Table 3 cells, the
kernels' async sweep, the split path's dispatches: the constants of
``pso_cost.CUDA_CALIBRATION`` and ``CUDA_EAGER_CALIBRATION``), 10a's
candidates predicted against measured with Spearman's rank correlation
(printed, not gated), ``BENCH_pso.json`` refused on the card; 10d phase
8a's trace at n=128 through ``SolveServer(autotune=True)`` and
``ContinuousScheduler(autotune=True)``, each result bit for bit its
standalone kernel solve at the tuned ``sync_every``. Its launches count
under rows 2, 3, 5 and 7.
"""
import concurrent.futures
import ctypes
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import repro_torch  # noqa: E402
from repro_torch.core import multi_swarm as ms  # noqa: E402
from repro_torch.core import pso  # noqa: E402
from repro_torch.core.fitness import (  # noqa: E402
    BUILTIN_PROBLEMS, FITNESS_IDS)
from repro_torch.core.serial import run_serial_fast  # noqa: E402
from repro_torch.core.update_rules import RULE_IDS  # noqa: E402
from repro_torch.kernels import _build, gla, ops, pso_step  # noqa: E402
try:    # tools/kernel_trees.py drives older checkouts, without the split path
    from repro_torch.core import constraints as cons
    from repro_torch.kernels import pso_split
except ImportError:
    cons = pso_split = None
try:    # nor the lbest topologies
    from repro_torch.core import topology
except ImportError:
    topology = None
try:    # nor serving
    from repro_torch import serving
    from repro_torch.launch.serve import SolveRequest, SolveServer
except ImportError:
    serving = None
try:    # nor the autotuner
    from repro_torch.core import autotune
    from repro_torch.roofline import pso_cost
except ImportError:
    autotune = pso_cost = None


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
# Dense TF32 on the tensor cores (the same data sheet), an FMA two
# operations.
TF32_OPS_PER_S = 495e12

# Operations per particle-dimension-iteration of the cubic/pso path, counted
# from csrc/pso_step.cu, work shared by all elements of an iteration left
# out. Integer: the element index (1); the two draws' first terms, idx * C
# plus a per-stream constant (2); their shared second term (1); two mix32
# rounds per draw, each three shift-xors and two multiplies (2 * 2 * 8);
# the xor of the second term (2); the shift and int-to-float conversion (4).
# Float: the 2^-24 scale (2), the pso rule (14), and the objective's own
# (FP_OBJECTIVE below; the cubic term and its accumulation, 8). Per
# particle-iteration: the pbest and queue compares.
INT_PER_ELEMENT = 1 + 2 + 1 + 32 + 2 + 4
FP_DRAWS_RULE = 2 + 14
FP_PER_PARTICLE = 2
# The objectives' float operations per element (Objective::add), each
# division, square root and cosine counted as one operation, so the bound
# stays a lower bound: cubic 8 as above; sphere x*x and the sum (2);
# rosenbrock prev*prev, x - it, 1 - prev, the two squares, 100*, the add
# and the sum (8); griewank x*x, the sum, sqrt, the division, cos and the
# product (6); rastrigin x*x, 2*pi*x, cos, 10*, the subtraction and the
# sum (6); ackley x*x, the sum, 2*pi*x, cos and its sum (5).
FP_OBJECTIVE = dict(cubic=8, sphere=2, rosenbrock=8, griewank=6, rastrigin=6,
                    ackley=5)
BUILTINS = ("cubic", "sphere", "rosenbrock", "griewank", "rastrigin",
            "ackley")

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


# The eight kernels of the port as the TPU kernels they replace, and the
# wrapper counter that counts each one's launches.
COUNTERS = {
    "queue_step": (pso_step.queue_step, "launches"),
    "fused": (pso_step.fused, "launches"),
    "fused_async": (pso_step.fused_async, "launches"),
    "fused_batch": (pso_step.fused_batch, "launches"),
    "hetero_fused_batch": (pso_step.fused_batch, "hetero_launches"),
    "fused_async_batch": (pso_step.fused_async_batch, "launches"),
    "hetero_fused_async_batch": (pso_step.fused_async_batch,
                                 "hetero_launches"),
    "gla_forward": (gla.gla_forward, "launches"),
}
if pso_split is not None:
    COUNTERS.update(split_advance=(pso_split.advance, "launches"),
                    split_fold=(pso_split.fold, "launches"),
                    split_publish=(pso_split.publish, "launches"))


#: The main paths' kernel calls, each registered where its phase runs it:
#: (counter name, what the call is, its iterations, a call that runs it
#: again, its bound (ms, by)).
REPLAY = []


def replay(name: str, what: str, iters: int, fn, bound_ms) -> None:
    REPLAY.append((name, what, iters, fn, bound_ms))


def zero_counts() -> None:
    for w, attr in COUNTERS.values():
        setattr(w, attr, 0)


def read_counts() -> dict:
    return {k: getattr(w, attr) for k, (w, attr) in COUNTERS.items()}


#: The six fused and async kernels' contention-counter checks (phase 3):
#: runs whose counts equal, exactly, the counting plain version's (or, for
#: batch rows, the single-swarm kernel's), and runs held to the invariants.
COUNTER_KEYS = ("fused", "fused_async", "fused_batch", "hetero_fused_batch",
                "fused_async_batch", "hetero_fused_async_batch")
COUNTER_CHECKS = {k: {"exact": 0, "invariants": 0} for k in COUNTER_KEYS}


def new_counts(s_cnt: int = 1):
    """A zeroed counter buffer on the card (``[3*S]`` int32)."""
    return torch.zeros(3 * s_cnt, dtype=torch.int32, device="cuda")


def n_chunks(iters: int, sync_every: int) -> int:
    """Boundaries that may publish: the chunks of every async phase."""
    return sum(span // k for _, span, k in
               pso_step.async_spans(iters, sync_every))


def counts_invariants(cnt, iters: int, nb: int, what: str, key: str,
                      chunks=None) -> None:
    """Every swarm's counts after ``iters`` iterations of ``nb`` blocks:
    queue updates <= block improvements <= iters * nb (a lane that beats
    the working best beats its own pbest); publications == queue updates
    for the fused kernel, <= chunks * nb for the async kernel (``chunks``
    given), whose publish order is a race."""
    for s, (q, p, i) in enumerate(cnt.view(-1, 3).tolist()):
        check(q <= i <= iters * nb, f"{what}: swarm {s} counts {q} queue "
              f"updates <= {i} block improvements <= {iters * nb}")
        if chunks is None:
            check(q == p, f"{what}: swarm {s} queue updates {q} == "
                  f"publications {p}")
        else:
            check(p <= chunks * nb, f"{what}: swarm {s} publications {p} "
                  f"<= {chunks} chunks x {nb} blocks")
    COUNTER_CHECKS[key]["invariants"] += 1


def counts_exact(got, want, what: str, key: str) -> None:
    check(torch.equal(got, want), f"{what}: counts {got.view(-1, 3).tolist()}"
          f" == {want.view(-1, 3).tolist()} exactly")
    COUNTER_CHECKS[key]["exact"] += 1


def same(a, b) -> bool:
    """Two states (tuples of tensors) bit for bit."""
    return all(torch.equal(x, y) for x, y in zip(a, b))


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


def kernel_state(fit: str, d: int, n: int, seed: int = 0, rule: str = "pso"):
    cfg = pso.PSOConfig(dim=d, particle_cnt=n, fitness=fit,
                        update_rule=rule).resolved()
    s = pso.init_swarm(cfg, seed, device="cuda")
    return cfg, ops.kernel_spec(cfg), ops.state_to_kernel(s), s.seed


def with_locals(state, nb: int):
    return state + (state[4][:, None].repeat(1, nb).contiguous(),
                    state[5].repeat(nb))


# A GLA kernel's name in a mangled symbol (after its length), with the
# template arguments of gla_chunk_state.
GLA_KERNEL = (r"\d(gla_(?:chunk_state|state_pass|chunk_output(?:_narrow)?))"
              r"(?:ILi(\d+)ELi(\d+)E)?")


def phase_build() -> None:
    sources = sorted(_build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        builds = list(pool.map(lambda p: _build.build(p.stem), sources))
    print(f"phase 2: built {len(sources)} source(s) for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    for (lib, log), src in zip(builds, sources):
        print(f"  {src.name} -> {lib.name}")
        lines = ptxas_lines(log)
        for i in range(0, len(lines), 3):
            print("  " + " | ".join(lines[i:i + 3]))
    gla_hmma(next(lib for lib, _ in builds if lib.name.startswith("libgla")))


def ptxas_lines(log: str) -> list:
    """One line a kernel from ``-Xptxas -v``: registers, and spills where
    there are any."""
    fits = {str(i): name for name, i in FITNESS_IDS.items()}
    rules = {str(i): name for name, i in RULE_IDS.items()}
    entry, spill, lines = None, "", []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            # mangled <kernel>ILi<fitness>ELi<rule>E[Lb<flag>E...] ->
            # kernel<f,r[,grid|block][,cluster][,lbest]>: the fused
            # kernel's flags are grid sync and cluster, the queue kernel's
            # cluster, the async kernel's cluster and lbest; fitness 6 is
            # the hetero kernel
            m = re.search(r"([a-z]+_kernel)ILi(\d+)ELi(\d+)E((?:Lb\dE)*)",
                          entry)
            if m:
                flags, g = re.findall(r"Lb(\d)E", m[4]), ""
                if m[1] == "fused_kernel":
                    g = ",grid" if flags.pop(0) == "1" else ",block"
                # the async kernel's lbest flag (trees before it have none)
                lbest = m[1] == "async_kernel" and len(flags) == 2 \
                    and flags.pop() == "1"
                if flags == ["1"]:
                    g += ",cluster"
                if lbest:
                    g += ",lbest"
                entry = (f"{m[1]}<{fits.get(m[2], 'hetero')},"
                         f"{rules[m[3]]}{g}>")
            else:     # GLA (gla_chunk_state<WM>) or no template
                m = re.search(GLA_KERNEL + r"|([a-z]+_kernel)", entry)
                entry = (m[4] or m[1] + (f"<{m[2]},{m[3]}>" if m[2]
                                         else "") if m else entry)
            spill = ""
        elif "spill" in line and \
                "0 bytes spill stores, 0 bytes spill loads" not in line:
            spill = " " + line.strip().replace("bytes ", "B ")
        elif "Used" in line and entry:
            regs = re.search(r"Used (\d+) registers", line)
            lines.append(f"{entry}:{regs[1] if regs else '?'}r{spill}")
    return lines


def gla_hmma(lib) -> None:
    """The tensor-core instructions (HMMA) in each GLA kernel's SASS: the
    chunk-state and chunk-output kernels must have them."""
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = re.search(GLA_KERNEL, part.split("\n")[0])
        if name:
            key = name[1] + (f"<{name[2]},{name[3]}>" if name[2] else "")
            counts[key] = part.count("HMMA")
    print("  HMMA instructions in SASS: " + ", ".join(
        f"{k} {v}" for k, v in sorted(counts.items())))
    for k in ("gla_chunk_state", "gla_chunk_output"):
        mine = [v for n, v in counts.items() if n.startswith(k)]
        check(bool(mine) and min(mine) > 0,
              f"{k} has tensor-core instructions ({counts})")


def cluster_of(n: int, d: int) -> int:
    """The cluster size the wrappers pick for a swarm of this shape."""
    return pso_step._cluster(n, d, ops._resolve_block(n, None),
                             torch.device("cuda"))


def fused_against_plain(fit, d, n, iters, offset, flips, errs, rule="pso",
                        say=print) -> int:
    """Launches of k = 1..iters iterations, each ONE launch from the same
    state at a nonzero iteration offset, against the plain version iterated
    k times: they run the kernel's whole iteration loop, both key and
    candidate slots, each slot's reuse two iterations on, and the grid
    sync. Where ``flips`` is set (D > 1, where the objective is summed in
    another order) the check stops at the first comparison flip; at D = 1
    the two round alike and every launch must agree exactly. Each launch
    runs again with counters: bit for bit the same state, the counter
    invariants, and the counts of the plain version over the same
    iterations exactly wherever no comparison flipped. Returns the
    comparison flips met (0 or 1)."""
    cfg, spec, state, seed = kernel_state(fit, d, n, rule=rule)
    bn = ops._resolve_block(n, None)
    want, plain_cnt = state, new_counts()
    for k in range(1, iters + 1):
        prev = want
        want = pso_step.fused_plain(*prev, spec, seed=seed,
                                    iteration=offset + k - 1, iters=1,
                                    block_n=bn, counts=plain_cnt)
        kw = dict(seed=seed, iteration=offset, iters=k, block_n=bn)
        got = pso_step.fused(*[x.clone() for x in state], spec, **kw)
        cnt = new_counts()
        counted = pso_step.fused(*[x.clone() for x in state], spec,
                                 counts=cnt, **kw)
        torch.cuda.synchronize()
        what = (f"fused {fit}/{rule} d={d} n={n} ({n // bn} blocks, "
                f"clusters of {cluster_of(n, d)}), iterations "
                f"{offset + 1}..{offset + k} in one launch")
        check(same(got, counted), f"{what}: counters on == off bit for bit")
        counts_invariants(cnt, k, n // bn, what, "fused")
        if flips and disagreeing(got, want, FUSED_FIELDS) \
                and is_flip(cfg, prev, want, got):
            say(f"  {what}: a comparison flip at a near tie in the last "
                f"iteration; stopped there")
            return 1
        e = compare(got, want, FUSED_FIELDS, what)
        if d == 1:
            check(e == 0.0, f"{what}: d=1 rounds as the plain version ({e})")
        counts_exact(cnt, plain_cnt, what, "fused")
        errs["fused"] = max(errs["fused"], e)
        say(f"  {what}: max |kernel - plain| = {e:.3g}; counters on == off "
            f"bit for bit, counts {cnt.tolist()} == plain")
    return 0


def async_invariants(fit, d, n, sync_every, launches, iters, rule="pso",
                     say=print) -> None:
    """The async kernel over several CTAs (or clusters), whose order of
    publications is a race: held across launches to gbest monotone, gbest
    == max(pbest), positions inside the bounds, gbest_pos bit for bit a
    pbest position of fitness gbest (the torn-write check), and the fitness
    recomputed at gbest_pos equal to gbest_fit (exactly at D = 1; at D > 1
    torch sums the objective in another order, so within the fitness
    tolerance). The launches carry counters, held to the async invariants
    over all of them."""
    cfg, spec, state, seed = kernel_state(fit, d, n, seed=1, rule=rule)
    nb = n // 512
    state = with_locals(state, nb)
    prev = float(state[5][0])
    cnt = new_counts()
    for launch in range(launches):
        pso_step.fused_async(*state, spec, seed=seed,
                             iteration=iters * launch, iters=iters,
                             sync_every=sync_every, block_n=512, counts=cnt)
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
    what = (f"async {fit}/{rule} d={d} n={n} {nb} blocks (clusters of "
            f"{cluster_of(n, d)}) sync_every={sync_every}")
    counts_invariants(cnt, launches * iters, nb, what, "fused_async",
                      chunks=launches * n_chunks(iters, sync_every))
    say(f"  {what}: {launches} launches "
        f"of {iters}, gbest {prev:.7g} monotone, == max(pbest), == a pbest "
        f"column, == f(gbest_pos); in bounds; counts {cnt.tolist()} within "
        f"the async invariants")


def queue_iteration(step, state, spec, seed, iteration, bn):
    """One queue-algorithm iteration on D-major operands: ``step`` (the
    kernel's wrapper, in place, or its plain version), then the port's
    cross-block epilogue."""
    pos, vel, pbp, pbf, aux_fit, aux_idx = step(
        *state, spec, seed=seed, iteration=iteration, block_n=bn)
    gp, gf = ops.queue_epilogue(pos, state[4], state[5], aux_fit, aux_idx)
    return pos, vel, pbp, pbf, gp, gf


def queue_against_plain(fit, d, n, iters, offset, flips, errs, rule="pso",
                        say=print) -> int:
    """The queue kernel chained over k = 1..iters iterations from an
    iteration offset, each followed by the epilogue: against its plain
    version chained alike, within the phase-3 tolerances (where ``flips``,
    up to the first comparison flip, as for the fused kernel), and bit for
    bit against ONE fused launch of k iterations from the same state: both
    are synchronous PPSO with the same rounding and tie-break, so any
    difference is a fault. At D = 1 kernel and plain must agree exactly.
    Returns the comparison flips met (0 or 1)."""
    cfg, spec, state, seed = kernel_state(fit, d, n, rule=rule)
    bn = ops._resolve_block(n, None)
    got, want, plain = tuple(x.clone() for x in state), state, True
    for k in range(1, iters + 1):
        it = offset + k - 1
        got = queue_iteration(pso_step.queue_step, got, spec, seed, it, bn)
        fused = pso_step.fused(*[x.clone() for x in state], spec, seed=seed,
                               iteration=offset, iters=k, block_n=bn)
        torch.cuda.synchronize()
        what = (f"queue {fit}/{rule} d={d} n={n} ({n // bn} blocks, "
                f"clusters of {cluster_of(n, d)}), iterations "
                f"{offset + 1}..{offset + k}")
        for a, b, name in zip(got, fused, FUSED_FIELDS):
            check(torch.equal(a, b), f"{what}: {name} bit for bit the fused "
                  f"kernel's launch of {k}")
        if not plain:
            say(f"  {what}: == one fused launch bit for bit")
            continue
        prev = want
        want = queue_iteration(pso_step.queue_plain, prev, spec, seed, it, bn)
        if flips and disagreeing(got, want, FUSED_FIELDS) \
                and is_flip(cfg, prev, want, got):
            say(f"  {what}: == one fused launch bit for bit; a comparison "
                f"flip at a near tie against the plain version in the last "
                f"iteration, plain comparison stopped there")
            plain = False
            continue
        e = compare(got, want, FUSED_FIELDS, what)
        if d == 1:
            check(e == 0.0, f"{what}: d=1 rounds as the plain version ({e})")
        errs["queue_step"] = max(errs["queue_step"], e)
        say(f"  {what}: max |kernel - plain| = {e:.3g}; == one fused "
            f"launch bit for bit")
    return int(not plain)


def phase_compare(errs) -> None:
    print("phase 3: kernels against their plain versions on the card")
    queue_against_plain("cubic", 1, 131072, 6, 37, False, errs)
    queue_against_plain("rastrigin", 120, 32768, 6, 5, True, errs)
    fused_against_plain("cubic", 1, 131072, 6, 37, False, errs)
    fused_against_plain("rastrigin", 120, 32768, 6, 5, True, errs)
    # Async, one block: equal to the plain block-major version, including
    # the remainder phase (53 = 6 * 8 + 5: two launches).
    _, spec, state, seed = kernel_state("cubic", 8, 512)
    state = with_locals(state, 1)
    kw = dict(seed=seed, iteration=0, iters=53, sync_every=8, block_n=512)
    want_cnt, cnt = new_counts(), new_counts()
    want = pso_step.fused_async_plain(*state, spec, counts=want_cnt, **kw)
    got = pso_step.fused_async(*[x.clone() for x in state], spec, **kw)
    counted = pso_step.fused_async(*[x.clone() for x in state], spec,
                                   counts=cnt, **kw)
    torch.cuda.synchronize()
    check(same(got, counted), "async single block: counters on == off bit "
          "for bit")
    e = compare(got, want, ASYNC_FIELDS, "async single block")
    counts_exact(cnt, want_cnt, "async single block", "fused_async")
    errs["fused_async"] = max(errs["fused_async"], e)
    print(f"  async cubic d=8 n=512 one block, 53 iterations, sync_every=8: "
          f"max |kernel - plain| = {e:.3g}; counters on == off bit for bit, "
          f"counts {cnt.tolist()} == plain")
    # Async, several blocks, at both main-path shapes and on clusters of 2
    # (n=32768) and 8 (n=1024) at d=120; rastrigin at d=120 does not run to
    # the bounds, so its gbest_pos is no corner of the box and a torn copy
    # of it shows. sync_every=1 runs the cluster-wide seqlock every
    # iteration.
    for n, c in ((32768, 2), (1024, 8)):
        check(cluster_of(n, 120) == c, f"d=120 n={n} runs on clusters of {c}")
    for sync_every in (8, 1):
        async_invariants("cubic", 1, 131072, sync_every, 3, 16)
        for fit in ("rastrigin", "cubic"):
            for n in (32768, 1024):
                async_invariants(fit, 120, n, sync_every, 3, 8)
    phase_compare_clusters(errs)


# The cluster shapes of phase 3: d=120 and an uneven d=37, one block (n=128)
# and two (n=1024).
CLUSTER_SHAPES = ((120, 128), (120, 1024), (37, 128), (37, 1024))


def async_one_block(fit, d, n, rule, errs) -> int:
    """One block on a cluster: the async kernel bit for bit the fused
    kernel at the same C over iterations 6..10, at sync_every=1 (a boundary
    every iteration) and 2 (two chunks of 2, then a remainder launch of 1),
    its local best equal to gbest; and against ``fused_async_plain`` within
    the phase-3 tolerances (up to a comparison flip in the last iteration,
    as for the fused kernel). With counters: the fused and async launches
    the same states; the async counts' queue updates and block
    improvements those of the fused kernel (the same trajectory), at most
    a publication a chunk, and the plain version's exactly where the two
    agree; the async kernel with counters off bit for bit the same. Returns
    the comparison flips met (0 or 1)."""
    cfg, spec, state, seed = kernel_state(fit, d, n, rule=rule)
    kw = dict(seed=seed, iteration=5, iters=5,
              block_n=ops._resolve_block(n, None))
    fcnt = new_counts()
    fused = pso_step.fused(*[x.clone() for x in state], spec, counts=fcnt,
                           **kw)
    what = (f"async {fit}/{rule} d={d} n={n} one block on clusters of "
            f"{cluster_of(n, d)}, iterations 6..10")
    for sync_every in (1, 2):
        cnt = new_counts()
        got = pso_step.fused_async(*[x.clone() for x in with_locals(state, 1)],
                                   spec, sync_every=sync_every, counts=cnt,
                                   **kw)
        torch.cuda.synchronize()
        for a, b, name in zip(got, fused, FUSED_FIELDS):
            check(torch.equal(a, b), f"{what}, sync_every={sync_every}: "
                  f"{name} bit for bit the fused kernel's")
        check(torch.equal(got[6][:, 0], got[4]) and torch.equal(got[7],
                                                                 got[5]),
              f"{what}, sync_every={sync_every}: local best == gbest")
        counts_invariants(cnt, 5, 1, f"{what}, sync_every={sync_every}",
                          "fused_async", chunks=n_chunks(5, sync_every))
        check(cnt[0] == fcnt[0] and cnt[2] == fcnt[2],
              f"{what}, sync_every={sync_every}: queue updates and block "
              f"improvements {cnt.tolist()} == the fused kernel's "
              f"{fcnt.tolist()}")
    off = pso_step.fused_async(*[x.clone() for x in with_locals(state, 1)],
                               spec, sync_every=2, **kw)
    check(same(off, got), f"{what}: counters on == off bit for bit")
    want_cnt = new_counts()
    want = pso_step.fused_async_plain(*with_locals(state, 1), spec,
                                      sync_every=2, counts=want_cnt, **kw)
    if disagreeing(got, want, ASYNC_FIELDS):
        prev = pso_step.fused_plain(*state, spec, **dict(kw, iters=4))
        check(is_flip(cfg, prev, want[:6], got[:6]),
              f"{what}: kernel and plain disagree, max error "
              f"{disagreeing(got, want, ASYNC_FIELDS)}")
        return 1
    e = compare(got, want, ASYNC_FIELDS, what)
    counts_exact(cnt, want_cnt, what, "fused_async")
    errs["fused_async"] = max(errs["fused_async"], e)
    return 0


def phase_compare_clusters(errs) -> None:
    """The queue, fused and async kernels with each particle block on a
    cluster, every objective with every rule, at each cluster shape: the
    queue kernel chained over two iterations against its plain version and
    bit for bit against one fused launch, and fused launches of one and two
    iterations against the plain version (up to a comparison flip, as
    above); with one block the async kernel bit for bit the fused kernel
    and against its plain version (``async_one_block``), with two blocks
    held to its invariants at a boundary every iteration. One line a
    shape."""
    for d, n in CLUSTER_SHAPES:
        c = cluster_of(n, d)
        check(c > 1, f"d={d} n={n} runs on clusters ({c})")
        before = dict(errs)
        for k in ("queue_step", "fused", "fused_async"):
            errs[k] = 0.0
        flips = async_flips = 0
        bn = ops._resolve_block(n, None)
        for fit in BUILTINS:
            for rule in RULE_IDS:
                flips += queue_against_plain(fit, d, n, 2, 5, True, errs,
                                             rule, say=lambda _: None)
                flips += fused_against_plain(fit, d, n, 2, 5, True, errs,
                                             rule, say=lambda _: None)
                if n == bn:
                    async_flips += async_one_block(fit, d, n, rule, errs)
                else:
                    async_invariants(fit, d, n, 1, 2, 4, rule,
                                     say=lambda _: None)
        if n == bn:
            async_line = (f"async == the fused kernel bit for bit at "
                          f"sync_every 1 and 2 (iterations 6..10, a "
                          f"remainder launch), max |kernel - plain| "
                          f"{errs['fused_async']:.3g}, {async_flips} "
                          f"comparison flip(s)")
        else:
            async_line = ("async at sync_every=1, 2 launches of 4: gbest "
                          "monotone, == max(pbest), == a pbest column, == "
                          "f(gbest_pos), in bounds")
        print(f"  clusters of {c}: d={d} n={n} ({n // bn} block(s), slices "
              f"of {d // c}-{-(-d // c)} dimensions), 6 objectives x 3 rules,"
              f" iterations 6..7: queue == one fused launch bit for bit; "
              f"max |kernel - plain| queue {errs['queue_step']:.3g}, fused "
              f"{errs['fused']:.3g}; {flips} comparison flip(s) at near "
              f"ties; {async_line}")
        for k in ("queue_step", "fused", "fused_async"):
            errs[k] = max(errs[k], before[k])


def batch_state(d: int, n: int, s_cnt: int, fit="rastrigin", mixed=False,
                its0: int = 0):
    """A batch on the card, its kernel operands' table and fids. Row s
    starts at iteration its0 + 3 s: serving lanes admit rows at chunk
    boundaries, so the kernels must take a counter per row."""
    cfg = pso.PSOConfig(dim=d, particle_cnt=n,
                        **({} if mixed else dict(fitness=fit))).resolved()
    if mixed:
        rows, table = ms.problem_rows(
            [BUILTINS[s % 6] for s in range(s_cnt)], d, device="cuda")
        b = ms.init_batch(cfg, range(s_cnt), rows=rows, table=table,
                          device="cuda")
        fids, specs = rows.fid, ops._hetero_members(cfg, table)
    else:
        b = ms.init_batch(cfg, range(s_cnt), device="cuda")
        fids, specs, table = None, (ops.kernel_spec(cfg),), None
    b = b._replace(iteration=its0 + 3 * torch.arange(s_cnt, device="cuda"))
    return cfg, b, fids, specs, table


def batch_operands(b, nb: int = 0):
    """New D-major operands of a batch (plus seeded locals when nb)."""
    out = [ops.pack_dmajor_batch(b.pos), ops.pack_dmajor_batch(b.vel),
           ops.pack_dmajor_batch(b.pbest_pos),
           b.pbest_fit.reshape(-1).clone(), ops.pack_dmajor(b.gbest_pos),
           b.gbest_fit.clone()]
    if nb:
        out += [out[4].repeat_interleave(nb, 1), out[5].repeat_interleave(nb)]
    return out


def batch_disagreeing(got, want, names, s_cnt: int) -> dict:
    """``disagreeing`` for a batch: fitness within FIT_RTOL of each swarm's
    own largest |fitness| (a batch mixes objectives of very different
    scale), positions within POS_TOL."""
    bad = {}
    for a, w, name in zip(got, want, names):
        if name in ("pbf", "gf", "lf"):
            ra, rw = a.reshape(s_cnt, -1), w.reshape(s_cnt, -1)
            atol = FIT_RTOL * rw.abs().amax(1, keepdim=True).clamp_min(1.0)
            ok = bool(((ra - rw).abs() <= atol + FIT_RTOL * rw.abs()).all())
        else:
            ok = torch.allclose(a, w, **POS_TOL)
        if not ok:
            bad[name] = float((a - w).abs().max())
    return bad


def row_operands(state, s: int, n: int, nb: int = 0):
    """Swarm s's single-swarm operands, cut out of batch operands."""
    c = slice(s * n, (s + 1) * n)
    out = [x[:, c].contiguous() for x in state[:3]] + [
        state[3][c].clone(), state[4][:, s].contiguous(),
        state[5][s:s + 1].clone()]
    if nb:
        out += [state[6][:, s * nb:(s + 1) * nb].contiguous(),
                state[7][s * nb:(s + 1) * nb].clone()]
    return out


def batch_against_plain(what, d, n, s_cnt, bn, iters, errs, key, mixed=False,
                        fit="rastrigin", its0=0, sync_every=0) -> None:
    """One launch of the batched kernel (fused, or async if sync_every)
    against its plain version on the same batch, both with counters: the
    counts equal row by row (the fused kernel at any block count and the
    async kernel with one block follow the plain trajectory), else the
    async invariants."""
    _, b, fids, specs, _ = batch_state(d, n, s_cnt, fit, mixed, its0)
    nb = n // bn if sync_every else 0
    state = batch_operands(b, nb)
    kw = dict(iters=iters, block_n=bn, fids=fids)
    if sync_every:
        kw["sync_every"] = sync_every
        plain, kernel = (pso_step.fused_async_batch_plain,
                         pso_step.fused_async_batch)
    else:
        plain, kernel = pso_step.fused_batch_plain, pso_step.fused_batch
    want_cnt, cnt = new_counts(s_cnt), new_counts(s_cnt)
    want = plain(*state, b.seed, b.iteration, specs, counts=want_cnt, **kw)
    got = kernel(*[x.clone() for x in state], b.seed, b.iteration, specs,
                 counts=cnt, **kw)
    torch.cuda.synchronize()
    names = ASYNC_FIELDS if sync_every else FUSED_FIELDS
    bad = batch_disagreeing(got, want, names, s_cnt)
    check(not bad, f"{what}: kernel and plain disagree, max error {bad}")
    if sync_every and n != bn:
        counts_invariants(cnt, iters, n // bn, what, key,
                          chunks=n_chunks(iters, sync_every))
    else:
        counts_exact(cnt, want_cnt, what, key)
    e = max_err(got, want)
    errs[key] = max(errs[key], e)
    tot = cnt.view(-1, 3).sum(0).tolist()
    print(f"  {what}: max |kernel - plain| = {e:.3g}; counts == plain row "
          f"by row (summed over the rows {tot})")


def rows_equal_single(what, d, n, s_cnt, bn, iters, mixed=False,
                      sync_every=0) -> int:
    """Every row of one batched launch bit for bit the single-swarm kernel
    on that swarm (with the member's bounds and objective for a mixed
    batch), and the same launch with counters: bit for bit the same state,
    and each row's counts those of the single-swarm kernel with counters
    (across the waves of a batch larger than the card holds at once).
    Returns the batched launches (waves) made."""
    _, b, fids, specs, _ = batch_state(d, n, s_cnt, mixed=mixed, its0=37)
    nb = n // bn if sync_every else 0
    orig = batch_operands(b, nb)
    state = [x.clone() for x in orig]
    counted, cnt = [x.clone() for x in orig], new_counts(s_cnt)
    counter = pso_step.fused_async_batch if sync_every else \
        pso_step.fused_batch
    before = counter.launches + counter.hetero_launches
    kw = dict(iters=iters, block_n=bn)
    if sync_every:
        kw["sync_every"] = sync_every
    batched = pso_step.fused_async_batch if sync_every else \
        pso_step.fused_batch
    batched(*state, b.seed, b.iteration, specs, fids=fids, **kw)
    waves = counter.launches + counter.hetero_launches - before
    batched(*counted, b.seed, b.iteration, specs, fids=fids, counts=cnt,
            **kw)
    check(same(state, counted), f"{what}: counters on == off bit for bit")
    members = [0] * s_cnt if fids is None else fids.tolist()
    seeds, its = b.seed.tolist(), b.iteration.tolist()
    want_cnt = new_counts(s_cnt)
    for s in range(s_cnt):
        one = row_operands(orig, s, n, nb)
        single = pso_step.fused_async if sync_every else pso_step.fused
        single(*one, specs[members[s]], seed=seeds[s], iteration=its[s],
               counts=want_cnt[3 * s:3 * s + 3], **kw)
        for a, w in zip(one, row_operands(state, s, n, nb)):
            check(torch.equal(a, w), f"{what}: row {s} equals the "
                  f"single-swarm kernel")
    torch.cuda.synchronize()
    key = (("hetero_" if mixed else "")
           + ("fused_async_batch" if sync_every else "fused_batch"))
    counts_exact(cnt, want_cnt, what, key)
    print(f"  {what}: {s_cnt} rows in {waves} launch(es), each bit for bit "
          f"the single-swarm kernel; with counters the same state, every "
          f"row's counts the single-swarm kernel's")
    return waves


def batch_gbest_fit(cfg, table, fids, gp):
    """Each swarm's fitness at its gbest_pos (``gp`` [D, S])."""
    if table is None:
        return cfg.fitness_fn(gp.T)
    out = torch.empty(gp.shape[1], device=gp.device)
    for k in torch.unique(fids).tolist():
        rows = (fids == k).nonzero()[:, 0]
        out[rows] = table[k].max_fn(gp.T[rows])
    return out


def batch_invariants(b, state, cfg, table, fids, d, n, prev, what) -> None:
    """Every swarm of a batch after an async launch: gbest monotone (from
    ``prev``), gbest == max(pbest), gbest_pos bit for bit the pbest
    position of a particle of fitness gbest (the torn-write check), the
    fitness at gbest_pos equal to gbest within the fitness tolerance (the
    objective is summed in another order), positions inside the swarm's
    bounds."""
    s_cnt = b.swarm_cnt
    pos, pbp = state[0].view(d, s_cnt, n), state[2].view(d, s_cnt, n)
    pbf, gp, gf = state[3].view(s_cnt, n), state[4], state[5]
    check(bool((gf >= prev).all()), f"{what}: gbest monotone")
    check(bool((gf == pbf.amax(1)).all()), f"{what}: gbest == max(pbest)")
    hit = (pbf == gf[:, None]) & (pbp == gp[:, :, None]).all(0)
    check(bool(hit.any(1).all()), f"{what}: gbest_pos is a pbest position "
          f"of fitness gbest")
    refit = batch_gbest_fit(cfg, table, fids, gp)
    check(bool((refit - gf).abs().le(FIT_RTOL * gf.abs().clamp_min(1.0))
               .all()), f"{what}: f(gbest_pos) == gbest")
    if table is None:
        lo = torch.full((s_cnt, d), cfg.min_pos, device=gp.device)
        hi = torch.full((s_cnt, d), cfg.max_pos, device=gp.device)
    else:
        rows, _ = ms.problem_rows([table[k] for k in fids.tolist()], d,
                                  device="cuda")
        lo, hi = rows.lo, rows.hi
    check(bool(((pos >= lo.T[:, :, None]) & (pos <= hi.T[:, :, None]))
               .all()), f"{what}: positions inside each swarm's bounds")


def async_batch_invariants(what, d, n, s_cnt, bn, sync_every, launches,
                           iters, mixed=False) -> None:
    cfg, b, fids, _, table = batch_state(d, n, s_cnt, mixed=mixed)
    specs = (ops._hetero_members(cfg, table) if mixed
             else (ops.kernel_spec(cfg),))
    state = batch_operands(b, n // bn)
    prev = state[5].clone()
    its = b.iteration
    cnt = new_counts(s_cnt)
    for _ in range(launches):
        pso_step.fused_async_batch(*state, b.seed, its, specs, iters=iters,
                                   sync_every=sync_every, block_n=bn,
                                   fids=fids, counts=cnt)
        torch.cuda.synchronize()
        batch_invariants(b, state, cfg, table, fids, d, n, prev, what)
        prev, its = state[5].clone(), its + iters
    counts_invariants(cnt, launches * iters, n // bn, what,
                      ("hetero_" if mixed else "") + "fused_async_batch",
                      chunks=launches * n_chunks(iters, sync_every))
    print(f"  {what}: {launches} launches of {iters}, every swarm: gbest "
          f"monotone, == max(pbest), == a pbest column, == f(gbest_pos); "
          f"in bounds; counts within the async invariants (summed over the "
          f"rows {cnt.view(-1, 3).sum(0).tolist()})")


def phase_compare_batches(errs) -> None:
    print("phase 3b: batched kernels against their plain versions and the "
          "single-swarm kernel")
    # Several iterations in one launch where kernel and plain round alike
    # (d=1), from per-row iteration counters 37 + 3 s; the rows' two
    # blocks meet at the grid sync each iteration.
    batch_against_plain("fused batch cubic d=1 n=1024 S=128 (2 blocks), "
                        "iterations its[s]+1..+6 in one launch", 1, 1024,
                        128, 512, 6, errs, "fused_batch", fit="cubic",
                        its0=37)
    batch_against_plain("fused batch rastrigin d=10 n=1024 S=128, one "
                        "iteration", 10, 1024, 128, 512, 1, errs,
                        "fused_batch")
    batch_against_plain("fused batch rastrigin d=10 n=256 S=1024 (one block,"
                        " normal launch), one iteration", 10, 256, 1024, 256,
                        1, errs, "fused_batch")
    batch_against_plain("hetero fused batch six built-ins d=10 n=1024 S=96, "
                        "one iteration", 10, 1024, 96, 512, 1, errs,
                        "hetero_fused_batch", mixed=True)
    batch_against_plain("async batch rastrigin d=10 n=256 S=1024 (one "
                        "block), 6 iterations, sync_every=4", 10, 256, 1024,
                        256, 6, errs, "fused_async_batch", sync_every=4)
    batch_against_plain("hetero async batch six built-ins d=10 n=1024 S=96 "
                        "(one block of 1024), 11 iterations, sync_every=4",
                        10, 1024, 96, 1024, 11, errs,
                        "hetero_fused_async_batch", mixed=True, sync_every=4)
    rows_equal_single("fused batch rastrigin d=10 n=1024 S=128, 5 "
                      "iterations", 10, 1024, 128, 512, 5)
    waves = rows_equal_single("fused batch rastrigin d=10 n=1024 S=300, 5 "
                              "iterations", 10, 1024, 300, 512, 5)
    check(waves >= 2, f"S=300 of 2 blocks runs in waves ({waves})")
    rows_equal_single("fused batch rastrigin d=10 n=256 S=1024 (one block)",
                      10, 256, 1024, 256, 5)
    rows_equal_single("async batch rastrigin d=10 n=256 S=1024 (one block),"
                      " sync_every=4", 10, 256, 1024, 256, 11, sync_every=4)
    rows_equal_single("hetero fused batch six built-ins d=10 n=1024 S=96",
                      10, 1024, 96, 512, 5, mixed=True)
    rows_equal_single("hetero async batch six built-ins d=10 n=1024 S=96 "
                      "(one block of 1024)", 10, 1024, 96, 1024, 11,
                      mixed=True, sync_every=4)
    # Clusters: the cluster size follows the swarm's shape, not S, so rows
    # still equal the single swarm bit for bit.
    c = cluster_of(1024, 120)
    check(c > 1, f"d=120 n=1024 runs on clusters ({c})")
    batch_against_plain(f"fused batch rastrigin d=120 n=1024 S=4 (clusters "
                        f"of {c}), one iteration", 120, 1024, 4, 512, 1,
                        errs, "fused_batch")
    rows_equal_single(f"fused batch rastrigin d=120 n=1024 S=4 (clusters of "
                      f"{c}), 5 iterations", 120, 1024, 4, 512, 5)
    rows_equal_single(f"hetero fused batch six built-ins d=120 n=1024 S=6 "
                      f"(clusters of {c})", 120, 1024, 6, 512, 5, mixed=True)
    # The async kernel on clusters: one block of 512 (C=8) for the rows,
    # two blocks (n=1024, C=8) for the invariants.
    c = cluster_of(512, 120)
    check(c > 1 and cluster_of(1024, 120) == c,
          f"d=120 n=512 and n=1024 run on clusters ({c})")
    batch_against_plain(f"async batch rastrigin d=120 n=512 S=4 (one block, "
                        f"clusters of {c}), 6 iterations, sync_every=4", 120,
                        512, 4, 512, 6, errs, "fused_async_batch",
                        sync_every=4)
    batch_against_plain(f"hetero async batch six built-ins d=120 n=512 S=6 "
                        f"(one block, clusters of {c}), 6 iterations, "
                        f"sync_every=4", 120, 512, 6, 512, 6, errs,
                        "hetero_fused_async_batch", mixed=True, sync_every=4)
    rows_equal_single(f"async batch rastrigin d=120 n=512 S=4 (one block, "
                      f"clusters of {c}), sync_every=4", 120, 512, 4, 512,
                      11, sync_every=4)
    rows_equal_single(f"hetero async batch six built-ins d=120 n=512 S=6 "
                      f"(one block, clusters of {c}), sync_every=4", 120,
                      512, 6, 512, 11, mixed=True, sync_every=4)
    for sync_every in (1, 8):
        async_batch_invariants(f"async batch rastrigin d=120 n=1024 S=4 (2 "
                               f"blocks, clusters of {c}), sync_every="
                               f"{sync_every}", 120, 1024, 4, 512,
                               sync_every, 3, 8)
    async_batch_invariants(f"hetero async batch six built-ins d=120 n=1024 "
                           f"S=6 (2 blocks, clusters of {c}), sync_every=1",
                           120, 1024, 6, 512, 1, 3, 8, mixed=True)
    async_batch_invariants("async batch rastrigin d=10 n=1024 S=128 (2 "
                           "blocks), sync_every=8", 10, 1024, 128, 512, 8, 3,
                           16)
    async_batch_invariants("async batch rastrigin d=10 n=1024 S=128, "
                           "sync_every=1", 10, 1024, 128, 512, 1, 2, 8)
    async_batch_invariants("hetero async batch six built-ins d=10 n=1024 "
                           "S=96 (2 blocks), sync_every=8", 10, 1024, 96,
                           512, 8, 3, 16, mixed=True)


# GLA: the reference test's tolerance (tests/test_gla_kernel.py); the
# chunk's running sums and the products are summed in other orders.
GLA_TOL = dict(rtol=2e-4, atol=2e-4)
# hymba-1.5B's SSD branch (src/repro/configs/hymba_1_5b.py): d_in = 2 * 1600
# over 25 heads, so P = 128; state N = 16; the model's chunk, 128.
HYMBA = dict(h=25, n=16, p=128)
# xLSTM-350M's mLSTM heads (src/repro/configs/xlstm_350m.py): 4 of 256,
# v augmented with the normalizer's ones column, so P = 257.
XLSTM = dict(h=4, n=256, p=256)


def gla_inputs(b, s, h, n, p, seed=0, ones=False, model_gates=False):
    """(q, k, v, log_decay, log_inc) on the card, made from a numpy seed as
    tests/test_gla_kernel.py's _inputs makes them: q, k ~ 0.3 N(0,1),
    v ~ N(0,1), log_decay = -0.1 softplus(N(0,1)), log_inc =
    clip(0.3 N(0,1), -2, 2); ``ones`` appends mLSTM's ones column to v.
    ``model_gates``: the gates as hymba's SSD branch makes them at its
    initialisation (``_ssd_gates`` of src/repro/models/ssm.py): dt =
    softplus(x w_dt), x w_dt ~ N(0, 1600 * 0.02^2) for unit activations
    (d_model 1600, w_dt's scale 0.02, dt_bias 0), log_decay = -dt exp(a_log)
    with a_log = 0, log_inc = log(dt + 1e-9). Their running sum falls by
    about 100 over a chunk of 128, so the clips bite inside every chunk."""
    r = np.random.default_rng(seed)

    def normal(*shape):
        return r.standard_normal(shape, dtype=np.float32)

    q, k, v = normal(b, s, h, n) * 0.3, normal(b, s, h, n) * 0.3, normal(
        b, s, h, p)
    if ones:
        v = np.concatenate([v, np.ones((b, s, h, 1), np.float32)], -1)
    if model_gates:
        dt = np.logaddexp(0.0, normal(b, s, h) * 0.8).astype(np.float32)
        ld = -dt
        li = np.log(dt + np.float32(1e-9))
    else:
        ld = -np.logaddexp(0.0, normal(b, s, h)).astype(np.float32) * 0.1
        li = np.clip(normal(b, s, h) * 0.3, -2, 2)
    return [torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
            for a in (q, k, v, ld, li)]


def gla_against_plain(what, b, s, shape, errs, ones=False, chunk=128,
                      model_gates=False):
    x = gla_inputs(b, s, **shape, ones=ones, model_gates=model_gates)
    want = gla.gla_forward_plain(*x, chunk=chunk)
    got = gla.gla_forward(*x, chunk=chunk)
    torch.cuda.synchronize()
    check(got.shape == want.shape == x[2].shape, f"{what}: shape")
    check(bool(torch.isfinite(got).all()), f"{what}: finite")
    e = float((got - want).abs().max())
    check(torch.allclose(got, want, **GLA_TOL),
          f"{what}: kernel and plain disagree, max error {e}")
    errs["gla_forward"] = max(errs["gla_forward"], e)
    print(f"  {what}: max |kernel - plain| = {e:.3g} (|y| up to "
          f"{float(want.abs().max()):.3g})")


def gla_folded(x, chunk=128):
    """gla_forward's padded, folded operands ([BH, S, .])."""
    b, _, h = x[3].shape
    padded = gla._pad(*x, chunk)
    return [a.transpose(1, 2).reshape(b * h, a.shape[1], *a.shape[3:])
            .contiguous() for a in padded]


def gla_stages_against_plain(what, b, s, shape, ones=False, chunk=128,
                             model_gates=False):
    """Each of the three GLA kernels against its plain stage on the same
    inputs: the chunks' own states and total decays (all but the last
    chunk's, which nothing reads), H_in at every chunk from the plain
    states, and y from the plain H_in."""
    q, k, v, ld, li = gla_folded(gla_inputs(
        b, s, **shape, ones=ones, model_gates=model_gates), chunk)
    want_s, want_tot = gla.gla_chunk_states_plain(k, v, ld, li, chunk)
    want_h = gla.gla_state_pass_plain(want_s, want_tot)
    got_s, got_tot = gla.chunk_states(k, v, ld, li, chunk)
    got_h = gla.state_pass(want_s.clone(), want_tot)
    got_y = gla.chunk_output(q, k, v, ld, li, want_h, chunk)
    torch.cuda.synchronize()
    want_y = gla.gla_chunk_output_plain(q, k, v, ld, li, want_h, chunk)
    pairs = [("states", got_s[:, :-1], want_s[:, :-1]),
             ("tot", got_tot[:, :-1], want_tot[:, :-1])]
    pairs += [(f"H_in[{c}]", got_h[:, c], want_h[:, c])
              for c in range(want_h.shape[1])]
    pairs.append(("y", got_y, want_y))
    errs = {}
    for name, got, want in pairs:
        e = float((got - want).abs().max()) if got.numel() else 0.0
        check(bool(torch.isfinite(got).all()) and
              torch.allclose(got, want, **GLA_TOL),
              f"{what}: {name} of the stage kernel and plain disagree, max "
              f"error {e}")
        errs[name.split("[")[0]] = max(errs.get(name.split("[")[0], 0.0), e)
    print(f"  {what}, stage by stage: max |kernel - plain| " + ", ".join(
        f"{k} {e:.3g}" for k, e in errs.items()) +
        f" (H_in at each of {want_h.shape[1]} chunks)")


def phase_compare_gla(errs) -> None:
    print("phase 3c: the GLA kernels against their plain versions on the "
          f"card (rtol = atol = {GLA_TOL['rtol']})")
    hymba = "hymba-1.5B SSD B=4 S=4096 H=25 N=16 P=128 chunk 128"
    model = hymba + ", the model's gates"
    xlstm = ("xLSTM-350M mLSTM B=1 S=1024 H=4 N=256 P=257 (ones column) "
             "chunk 128")
    padded = "hymba-1.5B SSD B=1 S=1000 (padded to 1024) chunk 128"
    gla_against_plain(hymba, 4, 4096, HYMBA, errs)
    gla_against_plain(model, 4, 4096, HYMBA, errs, model_gates=True)
    gla_against_plain(xlstm, 1, 1024, XLSTM, errs, ones=True)
    gla_against_plain(padded, 1, 1000, HYMBA, errs)
    gla_stages_against_plain(hymba, 4, 4096, HYMBA)
    gla_stages_against_plain(model, 4, 4096, HYMBA, model_gates=True)
    gla_stages_against_plain(xlstm, 1, 1024, XLSTM, ones=True)
    gla_stages_against_plain(padded, 1, 1000, HYMBA)


#: The paper's largest swarms (Table 4: cubic d=1; Table 5: cubic d=120),
#: (d, n, iterations) as phase 4 solves them.
SOLVE_CELLS = ((1, 131072, 1000), (120, 32768, 200))
#: solve_many with telemetry and histories (phase 4e): (label, where, S, n).
MANY_TELEMETRY = (
    ("rastrigin d=10 n=1024 S=128", dict(problem="rastrigin"), 128, 1024),
    ("six built-ins d=10 n=1024 S=96",
     dict(problems=[BUILTINS[s % 6] for s in range(96)]), 96, 1024))
#: Phase 4f's async run chunk by chunk: (d, n, iterations, sync_every), and
#: the chunks of its first part (Table 5's first 50 iterations, to a
#: multiple of sync_every).
CHUNK_CELL, EARLY_CHUNKS = (120, 32768, 200, 8), 6


def phase_main_path(card: str):
    print("phase 4: main path, repro_torch.solve(backend='auto') on the "
          "default device")
    launches = dict.fromkeys(COUNTERS, 0)
    runs = []
    for d, n, iters in SOLVE_CELLS:
        for variant in ("queue_lock", "async", "reduction"):
            kw = dict(dim=d, particles=n, seed=0, variant=variant)
            repro_torch.solve("cubic", iters=2, **kw)          # warm-up
            zero_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = repro_torch.solve("cubic", iters=iters, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = read_counts()
            for k in counts:
                launches[k] += counts[k]
            counts = {k: v for k, v in counts.items() if v}
            s = res.state
            g = res.best_fit
            want = {"queue_lock": "fused", "async": "fused_async"}.get(variant)
            if want:
                check(set(counts) == {want}, f"{variant}: kernel {want} "
                      f"launched, and no other ({counts})")
            else:
                check(not counts, "reduction runs eager")
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
            if want:
                nb = n // ops._resolve_block(n, None)
                replay(want, f"solve cubic d={d} n={n} {variant}", iters,
                       functools.partial(repro_torch.solve, "cubic",
                                         iters=iters, **kw),
                       bound(d, n, iters, nb if variant == "async" else 0))
            c = cluster_of(n, d) if variant != "reduction" else 1
            print(f"  cubic d={d} n={n} iters={iters} {variant:10s} "
                  f"(clusters of {c}) "
                  f"gbest {g:.7g} (optimum {OPTIMUM_PER_DIM * d:.7g}) "
                  f"{us:9.2f} us/iter launches {counts} peak memory "
                  f"{mem / 2**20:.1f} MiB [{card}]")
    return launches, runs


def history_ok(res, iters: int, sync_every: int, what: str) -> None:
    """A Result's history: one sample a sync point (every iteration for
    the fused kernel, ceil(iters / sync_every) for async), gbest monotone,
    the last sample the result's gbest."""
    h = res.history
    want = iters if res.method.variant != "async" else -(-iters // sync_every)
    check(h is not None and len(h) == want and int(h.iteration[-1]) == iters,
          f"{what}: {want} history samples ending at iteration {iters}")
    check(bool(np.all(np.diff(h.gbest_fit) >= 0)), f"{what}: history "
          f"monotone")
    check(float(h.gbest_fit[-1]) == res.gbest_fit,
          f"{what}: last sample {h.gbest_fit[-1]} == gbest {res.gbest_fit}")


def phase_telemetry_path(card: str, launches: dict):
    """``repro_torch.solve(telemetry=True, record_history=True)`` at Table
    4's and Table 5's largest cells, both kernel variants, each with every
    launch count set to 0 just before and read just after, in turns with
    telemetry off and with counters only: us an iteration of the three, the
    counters and the history lengths; the fused kernel's final state bit
    for bit the same in all three. Then ``solve_many`` with both flags, and
    a ``profiler_session`` around a fused solve whose trace must name the
    fused kernel. Returns {(d, variant): (us off, counters, both)}."""
    print("phase 4e: main path with telemetry, repro_torch.solve("
          "telemetry=True, record_history=True) on the default device")
    out = {}
    se = pso.ASYNC_SYNC_EVERY
    for d, n, iters in SOLVE_CELLS:
        nb = n // ops._resolve_block(n, None)
        for variant in ("queue_lock", "async"):
            kind = "fused" if variant == "queue_lock" else "fused_async"
            kw = dict(dim=d, particles=n, seed=0, variant=variant)
            repro_torch.solve("cubic", iters=2, telemetry=True,
                              record_history=True, **kw)     # warm-up
            us, res = {}, {}
            for mode, flags in (("off", {}), ("counters",
                                              dict(telemetry=True)),
                                ("counters+history", dict(
                                    telemetry=True, record_history=True))):
                zero_counts()
                us[mode], res[mode] = host_us(functools.partial(
                    repro_torch.solve, "cubic", iters=iters, **kw, **flags),
                    iters)
                counts = {k: v for k, v in read_counts().items() if v}
                for k in counts:
                    launches[k] += counts[k]
                want = (1 if kind == "fused" else len(
                    pso_step.async_spans(iters, se)))
                if "history" in mode:
                    want = iters if kind == "fused" else -(-iters // se)
                check(counts == {kind: want}, f"{variant} d={d} {mode}: "
                      f"{want} launch(es) of {kind} and no other ({counts})")
                replay(kind, f"solve cubic d={d} n={n} {variant} {mode}",
                       iters, functools.partial(
                           repro_torch.solve, "cubic", iters=iters, **kw,
                           **flags),
                       bound(d, n, iters, nb if kind == "fused_async" else 0))
            both, off = res["counters+history"], res["off"]
            what = f"solve cubic d={d} n={n} x{iters} {variant}"
            history_ok(both, iters, se, what)
            tel = both.telemetry.as_dict()
            check(tel == res["counters"].telemetry.as_dict() or
                  kind == "fused_async", f"{what}: the fused counts with "
                  f"and without history")
            counts_invariants(torch.tensor(list(tel.values())), iters, nb,
                              what, kind, chunks=None if kind == "fused"
                              else n_chunks(iters, se))
            if kind == "fused":
                for mode in ("counters", "counters+history"):
                    check(same(res[mode].state[:7], off.state[:7]),
                          f"{what}: {mode} final state == telemetry off bit "
                          f"for bit")
            for r in res.values():
                check(math.isfinite(r.best_fit) and r.gbest_fit == float(
                    r.state.pbest_fit.max()), f"{what}: gbest == max(pbest)")
            out[(d, variant)] = (us["off"], us["counters"],
                                 us["counters+history"])
            print(f"  {what} (clusters of {cluster_of(n, d)}): us/iter off "
                  f"{us['off']:.2f}, counters {us['counters']:.2f}, counters "
                  f"+ history {us['counters+history']:.2f}; counters {tel}; "
                  f"history {len(both.history)} samples, last "
                  f"{both.history.gbest_fit[-1]:.7g} == gbest; gbest off "
                  f"{off.best_fit:.7g} [{card}]")
    for label, where, s_cnt, n in MANY_TELEMETRY:
        for variant in ("queue_lock", "async"):
            iters = 200
            kw = dict(seeds=range(s_cnt), dim=10, particles=n,
                      variant=variant, telemetry=True, record_history=True,
                      **where)
            repro_torch.solve_many(iters=2, **kw)              # warm-up
            zero_counts()
            us, rows = host_us(lambda: repro_torch.solve_many(iters=iters,
                                                              **kw), iters)
            counts = {k: v for k, v in read_counts().items() if v}
            for k in counts:
                launches[k] += counts[k]
            kind = ("hetero_" if "problems" in where else "") + (
                "fused_batch" if variant == "queue_lock"
                else "fused_async_batch")
            check(set(counts) == {kind}, f"solve_many {label} {variant}: "
                  f"{kind} only ({counts})")
            nb = n // ops._resolve_block(n, None)
            problems = where.get("problems") or [where["problem"]] * s_cnt
            replay(kind, f"solve_many {label} {variant} counters+history",
                   iters, functools.partial(repro_torch.solve_many,
                                            iters=iters, **kw),
                   bound(10, n, iters, nb if variant == "async" else 0,
                         objectives=problems, members=len(set(problems))))
            what = f"solve_many {label} x{iters} {variant}"
            tel = torch.tensor([list(r.telemetry.as_dict().values())
                                for r in rows])
            for s, r in enumerate(rows):
                history_ok(r, iters, pso.ASYNC_SYNC_EVERY, f"{what} row {s}")
            counts_invariants(tel.reshape(-1), iters, nb, what, kind,
                              chunks=None if variant == "queue_lock"
                              else n_chunks(iters, se))
            print(f"  {what}: {us:.2f} us/iter with counters and history; "
                  f"{len(rows[0].history)} samples a row; counts summed over "
                  f"the rows {tel.sum(0).tolist()}, a row's queue updates "
                  f"{int(tel[:, 0].min())}..{int(tel[:, 0].max())}; launches "
                  f"{counts} [{card}]")
    from repro_torch.telemetry import profiler_session
    logdir = Path(__file__).resolve().parent / "build" / "chip_smoke_trace"
    d, n, _ = SOLVE_CELLS[-1]
    with profiler_session(str(logdir)) as started:
        repro_torch.solve("cubic", dim=d, particles=n, iters=10,
                          variant="queue_lock", telemetry=True)
        torch.cuda.synchronize()
    check(started, "profiler_session started on the card")
    trace = json.loads((logdir / "torch_trace.json").read_text())
    names = {e.get("name", "") for e in trace.get("traceEvents", [])}
    check(any("fused_kernel" in n for n in names),
          "the profiler trace names the fused kernel")
    print(f"  profiler_session: started, {len(names)} event names in "
          f"{logdir.name}/torch_trace.json, fused_kernel among them")
    return out


def phase_async_chunks(card: str) -> None:
    """PERF.md's open question on the async kernel's early iterations: at
    Table 5's largest swarm (cubic d=120 n=32768, 200 iterations,
    sync_every=8) the async kernel launched chunk by chunk on one state,
    each launch one chunk of 8, with counters: per chunk the publications,
    queue updates and block improvements, the particles whose pbest rose
    (pbest fitness before and after), and the chunk's device us (CUDA
    events); beside it the same chunks with counters off on a second copy
    of the same start, the two copies advanced in turns, chunk by chunk.
    Summed over the first 48 iterations (Table 5's 50 is not a multiple of
    8) and over the rest."""
    d, n, iters, se = CHUNK_CELL
    print(f"phase 4f: the async kernel chunk by chunk, cubic d={d} n={n} "
          f"x{iters}, sync_every={se} [{card}]")
    bn = ops._resolve_block(n, None)
    nb = n // bn
    _, spec, state0, seed = kernel_state("cubic", d, n)
    pso_step.fused_async(*with_locals(tuple(x.clone() for x in state0), nb),
                         spec, seed=seed, iteration=0, iters=se,
                         sync_every=se, block_n=bn)           # warm-up
    rows = {True: [], False: []}
    states = {c: with_locals(tuple(x.clone() for x in state0), nb)
              for c in rows}
    for c in range(iters // se):
        for counted in (True, False) if c % 2 else (False, True):
            state, cnt = states[counted], new_counts() if counted else None
            before = state[3].clone()
            us = device_us(lambda st: pso_step.fused_async(
                *st, spec, seed=seed, iteration=c * se, iters=se,
                sync_every=se, block_n=bn, counts=cnt), state, copy=False)
            rose = int((state[3] > before).sum())
            rows[counted].append((us / se, *(cnt.tolist() if counted
                                             else (0, 0, 0)), rose))
    for c, (on, off) in enumerate(zip(rows[True], rows[False])):
        print(f"  chunk {c + 1:2d} (iterations {c * se + 1}..{(c + 1) * se}): "
              f"{on[2]} publications, {on[1]} queue updates, {on[3]} block "
              f"improvements, {on[4]} pbest rises; {on[0]:.2f} us/iter with "
              f"counters, {off[0]:.2f} without")
    cut = EARLY_CHUNKS * se
    for label, part in ((f"iterations 1..{cut}", slice(0, EARLY_CHUNKS)),
                        (f"iterations {cut + 1}..{iters}",
                         slice(EARLY_CHUNKS, None))):
        on, off = rows[True][part], rows[False][part]
        tot = [sum(r[i] for r in on) for i in range(1, 5)]
        print(f"  {label}: {sum(r[0] for r in on) / len(on):.2f} us/iter "
              f"with counters, {sum(r[0] for r in off) / len(off):.2f} "
              f"without; a chunk {tot[1] / len(on):.1f} publications, "
              f"{tot[0] / len(on):.1f} queue updates, {tot[2] / len(on):.1f} "
              f"block improvements (of {se * nb}), {tot[3] / len(on):.0f} "
              f"pbest rises [{card}]")


def phase_many_path(card: str, launches: dict):
    """``repro_torch.solve_many`` on the default device, backend 'auto',
    at the multi_swarm sweep's shapes with S raised to fill the card."""
    print("phase 4b: main path, repro_torch.solve_many(backend='auto') on "
          "the default device")
    mixed96 = [BUILTINS[s % 6] for s in range(96)]
    shapes = (("rastrigin d=10 n=1024 S=128", "rastrigin", None, 128, 1024),
              ("rastrigin d=10 n=1024 S=300", "rastrigin", None, 300, 1024),
              ("rastrigin d=10 n=256 S=1024", "rastrigin", None, 1024, 256),
              ("six built-ins d=10 n=1024 S=96", None, mixed96, 96, 1024))
    iters, d = 200, 10
    runs = []
    for label, prob, problems, s_cnt, n in shapes:
        for variant in ("queue_lock", "async"):
            kw = dict(seeds=range(s_cnt), dim=d, particles=n,
                      variant=variant)
            if problems is None:
                kw["problem"] = prob
            else:
                kw["problems"] = problems
            repro_torch.solve_many(iters=2, **kw)              # warm-up
            zero_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = repro_torch.solve_many(iters=iters, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = {k: v for k, v in read_counts().items() if v}
            for k in counts:
                launches[k] += counts[k]
            mem = torch.cuda.max_memory_allocated()
            want = ("hetero_" if problems else "") + (
                "fused_batch" if variant == "queue_lock"
                else "fused_async_batch")
            check(set(counts) == {want}, f"{label} {variant}: launched "
                  f"{want} only ({counts})")
            check(len(res) == s_cnt, "one Result per seed")
            check(all(r.state.pos.device.type == "cuda" for r in res[:1]),
                  "state on the card")
            gf = torch.stack([r.state.gbest_fit for r in res])
            pbf = torch.stack([r.state.pbest_fit for r in res])
            pbp = torch.stack([r.state.pbest_pos for r in res])
            gp = torch.stack([r.state.gbest_pos for r in res])
            check(bool(torch.isfinite(gf).all()), f"{label}: finite gbest")
            check(bool((gf == pbf.amax(1)).all()), "gbest == max(pbest)")
            hit = (pbf == gf[:, None]) & (pbp == gp[:, None, :]).all(2)
            check(bool(hit.any(1).all()), "gbest_pos is a pbest")
            refit = torch.stack([r.config.fitness_fn(r.state.gbest_pos[None])
                                 [0] for r in res])
            check(bool((refit - gf).abs().le(FIT_RTOL * gf.abs()
                                             .clamp_min(1.0)).all()),
                  "f(gbest_pos) == gbest")
            # The built-ins are maximized: cubic's optimum is 9e5 a
            # dimension, the others' are negated minimizations with
            # optimum 0 (reached within rounding of terms of about 10*d).
            best = [r.best_fit for r in res]
            check(all(r.best_fit <= OPTIMUM_PER_DIM * d * (1 + 1e-6)
                      if r.problem.name == "cubic"
                      else r.best_fit <= FIT_RTOL * 10 * d for r in res),
                  "no row beyond its optimum")
            us = dt / iters * 1e6
            runs.append(dict(label=label, variant=variant, us=us,
                             swarms_per_s=s_cnt / dt))
            nb = n // ops._resolve_block(n, None)
            replay(want, f"solve_many {label} {variant}", iters,
                   functools.partial(repro_torch.solve_many, iters=iters,
                                     **kw),
                   bound(d, n, iters, nb if variant == "async" else 0,
                         objectives=problems or [prob] * s_cnt,
                         members=len(set(problems or [prob]))))
            c = cluster_of(n, d)
            print(f"  {label} x{iters} {variant:10s} (clusters of {c}) "
                  f"{us:9.2f} us/iter for "
                  f"the batch, {s_cnt / dt:9.1f} swarms/s, best of batch "
                  f"{max(best):.6g}, median {sorted(best)[s_cnt // 2]:.6g}; "
                  f"launches "
                  f"{counts}; peak memory {mem / 2**20:.1f} MiB [{card}]")
            many_layers(s_cnt, n, d, iters, variant, problems)
    return runs


# benchmarks/run.py's sweeps: table3 (cubic d=1, ITERS_1D iterations),
# table4 (cubic d=1, ITERS_1D // 2) and table5 (cubic d=120, iterations per
# swarm size).
TABLE3 = tuple((n, 2000) for n in (32, 64, 128, 256, 512, 1024, 2048))
TABLE4 = tuple((n, 1000) for n in (128, 512, 2048, 8192, 32768, 131072))
TABLE5 = ((128, 200), (1024, 150), (8192, 100), (32768, 50))
VARIANTS = ("reduction", "queue", "ops.queue_step", "queue_lock", "async")
# The serial baseline runs at most this many particle-dimension-iterations
# (a few seconds of numpy on one host core) and is cut to fewer iterations
# beyond it; its time per iteration is what the tables compare.
SERIAL_ELEMENTS = 2e7


def host_us(fn, iters: int):
    """(us per iteration, result) of one call of ``fn`` on the host clock,
    synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6, out


def queue_loop(cfg, s, iters: int):
    for _ in range(iters):
        s = ops.queue_step(cfg, s)
    return s


def queue_kernel_time(state, spec, kw, reps: int = 20, cluster=None):
    """The queue kernel alone and its wrapper's kernel path, on copies of
    ``state``: (us a launch, from a CUDA graph of ``reps`` calls replayed,
    so no host work sits between the launches; the host us a call,
    enqueued back to back; pbest columns a timed launch wrote, on average,
    counted on the same launches replayed one at a time). ``cluster`` sets
    the cluster size in place of the wrappers' rule."""
    def step(run):
        pso_step._queue_launch(run[:4], run[4], run[5], spec,
                               cluster=cluster, **kw)

    run = [x.clone() for x in state]
    step(run)                           # warm: the build, the bounds table
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            step(run)
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    kernel_us = start.elapsed_time(end) * 1e3 / reps
    again = [x.clone() for x in state]
    for _ in range(1 + reps):
        step(again)
    improved = 0
    for _ in range(reps):
        before = again[3].clone()
        step(again)
        improved += int((again[3] > before).sum())
    check(all(torch.equal(a, b) for a, b in zip(run, again)),
          "the graph's replays advanced the state as the wrapper's calls do")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step(again)
    wrapper_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return kernel_us, wrapper_us, improved / reps


def queue_layers(cfg, s) -> str:
    """Where one ``ops.queue_step`` call's time goes: its layers in the
    order it runs them, each on the host clock between synchronisations
    (the launch includes the kernel's run), after one warm call."""
    for _ in range(2):
        marks = []

        def lap():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        lap()
        c = cfg.resolved()
        spec = ops.kernel_spec(c)
        bn = ops._resolve_block(c.particle_cnt, None)
        lap()
        state = ops.state_to_kernel(s)
        lap()
        pos, vel, pbp, pbf, aux_fit, aux_idx = pso_step.queue_step(
            *state, spec, seed=s.seed, iteration=s.iteration, block_n=bn)
        lap()
        gp, gf = ops.queue_epilogue(pos, state[4], state[5], aux_fit,
                                    aux_idx)
        lap()
        ops.kernel_to_state(s, pos, vel, pbp, pbf, gp, gf, 1)
        lap()
    names = ("config", "pack", "launch+kernel", "epilogue", "unpack")
    return ", ".join(f"{name} {(b - a) * 1e6:.1f} us"
                     for name, a, b in zip(names, marks, marks[1:]))


def table_runs(cfg, s0) -> dict:
    """A Table cell's variants from the swarm ``s0``: name -> (a call of k
    iterations, the counter of the kernel it launches or None)."""
    return {
        "reduction": (lambda k: pso.run(cfg, s0, k, "reduction"), None),
        "queue": (lambda k: pso.run(cfg, s0, k, "queue"), None),
        "ops.queue_step": (lambda k: queue_loop(cfg, s0, k), "queue_step"),
        "queue_lock": (lambda k: ops.run_queue_lock_fused(cfg, s0, k),
                       "fused"),
        "async": (lambda k: ops.run_queue_lock_fused_async(cfg, s0, k),
                  "fused_async"),
    }


def rerun_cell(cfg, name: str, iters: int):
    """A Table cell's variant again, on its initial swarm made anew: a
    replay then keeps no swarm on the card between phases."""
    return table_runs(cfg, pso.init_swarm(cfg, 0, device="cuda"))[name][0](
        iters)


def table_cell(card, launches, d, n, iters, variants) -> None:
    """One cell of Table 3, 4 or 5: the serial CPU baseline and each GPU
    variant from the same initial swarm, us per iteration and speed-up over
    serial. Kernel variants run with every count set to 0 just before and
    read just after; the queue variant's final state must equal the fused
    kernel's bit for bit (both synchronous PPSO, same rounding)."""
    cfg = pso.PSOConfig(dim=d, particle_cnt=n, fitness="cubic").resolved()
    s_iters = int(min(iters, max(5, SERIAL_ELEMENTS // (n * d))))
    run_serial_fast(cfg, 0, 1)

    def serial_s(k):
        """The faster of two runs of init and ``k`` iterations, seconds."""
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            fit, _ = run_serial_fast(cfg, 0, k)
            times.append(time.perf_counter() - t0)
        return min(times), fit

    init_s, _ = serial_s(0)
    total_s, serial_fit = serial_s(s_iters)
    # The GPU variants start from a built swarm, so serial's init is left
    # out too.
    serial = (total_s - init_s) / s_iters * 1e6
    cut = (f", cut to {s_iters} of {iters} iterations" if s_iters < iters
           else "")
    print(f"  cubic d={d} n={n} x{iters} (queue, fused and async on clusters "
          f"of {cluster_of(n, d)}): serial (numpy, host, the faster "
          f"of two runs, init of {init_s * 1e3:.2f} ms left out{cut}) "
          f"{serial:.2f} us/iter, gbest {serial_fit:.7g}")
    s0 = pso.init_swarm(cfg, 0, device="cuda")
    runs = table_runs(cfg, s0)
    out = {}
    for name in variants:
        fn, kernel = runs[name]
        fn(2)                                                # warm-up
        zero_counts()
        us, res = host_us(lambda: fn(iters), iters)
        counts = {k: v for k, v in read_counts().items() if v}
        for k in counts:
            launches[k] += counts[k]
        check(set(counts) == ({kernel} if kernel else set()),
              f"{name}: launched {kernel or 'no kernel'} only ({counts})")
        if name == "ops.queue_step":
            check(counts.get(kernel) == iters, "one queue launch an iteration")
        g = float(res.gbest_fit)
        check(math.isfinite(g) and g <= OPTIMUM_PER_DIM * d * (1 + 1e-6),
              f"{name}: finite gbest within the optimum")
        check(g == float(res.pbest_fit.max()), f"{name}: gbest == max(pbest)")
        out[name] = res
        if kernel:
            nb = n // ops._resolve_block(n, None)
            if name == "ops.queue_step":
                one, by = queue_bound(d, n, nb, 0.0)
                b = (iters * one, by)
            else:
                b = bound(d, n, iters, nb if name == "async" else 0)
            replay(kernel, f"table cubic d={d} n={n} {name}", iters,
                   functools.partial(rerun_cell, cfg, name, iters), b)
        print(f"    {name:15s} {us:10.2f} us/iter  x{serial / us:9.1f} over "
              f"serial  gbest {g:.7g}  launches {counts} [{card}]")
    if "ops.queue_step" in out and "queue_lock" in out:
        a, b = out["ops.queue_step"], out["queue_lock"]
        for f in ("pos", "vel", "pbest_pos", "pbest_fit", "gbest_pos",
                  "gbest_fit"):
            check(torch.equal(getattr(a, f), getattr(b, f)),
                  f"d={d} n={n}: ops.queue_step x{iters} {f} == the fused "
                  f"kernel's bit for bit")
        kernel_us, wrapper_us, _ = queue_kernel_time(
            ops.state_to_kernel(s0), ops.kernel_spec(cfg),
            dict(seed=s0.seed, iteration=0,
                 block_n=ops._resolve_block(n, None)))
        print(f"    ops.queue_step x{iters} == queue_lock bit for bit; "
              f"the queue kernel alone {kernel_us:.2f} us a launch (CUDA "
              f"graph replayed, CUDA events), pso_step.queue_step's host "
              f"time {wrapper_us:.2f} us a call; one ops.queue_step call's "
              f"layers (host clock, synchronised): {queue_layers(cfg, s0)}")


def phase_tables(card: str, launches: dict) -> None:
    print("phase 4c: the paper's Tables 3 and 4 (cubic d=1) and 5 (cubic "
          "d=120) at benchmarks/run.py's shapes, serial CPU against the card")
    for n, iters in TABLE3:
        table_cell(card, launches, 1, n, iters, VARIANTS)
    for n, iters in TABLE4:
        table_cell(card, launches, 1, n, iters, ("queue_lock",))
    for n, iters in TABLE5:
        table_cell(card, launches, 120, n, iters, VARIANTS)


def phase_gla_path(card: str, launches: dict) -> None:
    """``gla_forward`` at hymba-1.5B's SSD width with the model's own
    gates, counts set to 0 just before and read just after."""
    print("phase 4d: main path, repro_torch.kernels.gla.gla_forward at "
          "hymba-1.5B SSD width, the model's gates")
    b, s = 4, 4096
    x = gla_inputs(b, s, **HYMBA, seed=1, model_gates=True)
    gla.gla_forward(*x)                                      # warm-up
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    us, y = host_us(lambda: gla.gla_forward(*x), 1)
    replay("gla_forward", "gla_forward hymba B=4 S=4096", 1,
           lambda: gla.gla_forward(*gla_inputs(b, s, **HYMBA, seed=1,
                                               model_gates=True)),
           gla_bound(b * HYMBA["h"], s, HYMBA["n"], HYMBA["p"], 128))
    counts = {k: v for k, v in read_counts().items() if v}
    for k in counts:
        launches[k] += counts[k]
    check(counts == {"gla_forward": 1}, f"one GLA launch ({counts})")
    check(tuple(y.shape) == (b, s, HYMBA["h"], HYMBA["p"]), "y shape")
    check(bool(torch.isfinite(y).all()), "finite y")
    print(f"  B={b} S={s} H=25 N=16 P=128 chunk 128: {us / 1e3:.3f} ms (pad, "
          f"fold, launch, unfold), |y| up to {float(y.abs().max()):.3g}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
          f"[{card}]")


def many_layers(s_cnt, n, d, iters, variant, problems) -> None:
    """Where a solve_many call's time goes, layer by layer (the facade's
    own steps through the public functions): init_batch on the host clock,
    the kernel path (packing, launches, unpacking) in CUDA events, and
    cutting the batch into one SwarmState a row (batch_rows) on the host
    clock. The kernel path's share of the sum bounds the card's busy share
    from above."""
    cfg = pso.PSOConfig(dim=d, particle_cnt=n,
                        **({} if problems else dict(fitness="rastrigin")))
    cfg = cfg.resolved()
    rows, table = (ms.problem_rows(problems, d, device="cuda") if problems
                   else (None, None))
    fids = None if rows is None else rows.fid
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b = ms.init_batch(cfg, range(s_cnt), rows=rows, table=table,
                      device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    if variant == "async":
        b = ops.run_queue_lock_fused_async_batch(cfg, b, iters, fids=fids,
                                                 table=table)
    else:
        b = ops.run_queue_lock_fused_batch(cfg, b, iters, fids=fids,
                                           table=table)
    end.record()
    torch.cuda.synchronize()
    t_run = start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    ms.batch_rows(b)
    t_rows = time.perf_counter() - t0
    total = t_init + t_run + t_rows
    print(f"    layers: init_batch {t_init * 1e3:.2f} ms, kernel path "
          f"{t_run * 1e3:.2f} ms ({t_run / iters * 1e6:.2f} us/iter), "
          f"batch_rows {t_rows * 1e3:.2f} ms; kernel path "
          f"{100 * t_run / total:.0f}% of the three")


def bound(d: int, n: int, iters: int, nb: int = 0,
          objectives=("cubic",), members: int = 1):
    """(ms, "bytes" | "operations"): the least time for the call on a batch
    of ``len(objectives)`` swarms (one objective each) — each input read
    once and each output written once (pos, vel, pbp, pbf, gbest, plus the
    async locals; seeds, iteration counters, the bounds table and fids
    read) at the HBM rate, or the operations at the card's rates (integer
    pipe, float32 pipe, issue), whichever is largest."""
    s_cnt = len(objectives)
    state = s_cnt * (3 * n * d + n + d + 1 + nb * (d + 1))
    inputs = state + 2 * s_cnt + members * 4 * d + (s_cnt if members > 1
                                                    else 0)
    ints = iters * s_cnt * n * d * INT_PER_ELEMENT
    fps = iters * n * sum(d * (FP_DRAWS_RULE + FP_OBJECTIVE[o])
                          + FP_PER_PARTICLE for o in objectives)
    return roof(4 * (inputs + state), ints, fps)


def roof(nbytes: float, ints: float, fps: float):
    """(ms, "bytes" | "operations"): the larger of the bytes at the HBM
    rate and the operations at the card's rates (integer pipe, float32
    pipe, issue)."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = max(ints / INT32_OPS_PER_S, fps / FP32_OPS_PER_S,
                 (ints + fps) / ISSUE_OPS_PER_S)
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def queue_bound(d: int, n: int, nb: int, improved: float):
    """The queue kernel's one iteration of cubic/pso: pos, vel, pbp, pbf,
    gbest and the bounds read; pos and vel written, and pbf and the pbp
    column only for the ``improved`` particles (the kernel folds pbest in
    place, so an unchanged column is not an output); the [nb] pair
    written; the operations of one iteration."""
    nbytes = 4 * (3 * n * d + n + d + 1 + 4 * d
                  + 2 * n * d + improved * (d + 1) + 2 * nb)
    fps = n * (d * (FP_DRAWS_RULE + FP_OBJECTIVE["cubic"]) + FP_PER_PARTICLE)
    return roof(nbytes, n * d * INT_PER_ELEMENT, fps)


def gla_fmas(bh: int, s: int, n: int, p: int, chunk: int) -> int:
    """The GLA forward's least multiply-adds on folded operands (S a
    multiple of the chunk): per (batch.head) and chunk q k^T and
    (q k^T o W) v on the causal half, and q H and the state update where
    they are not zero or unused (H = 0 in the first chunk; the last chunk's
    update is never read)."""
    nc = s // chunk
    tri = chunk * (chunk + 1) // 2
    return bh * (nc * tri * (n + p) + 2 * (nc - 1) * chunk * n * p)


def gla_bound(bh: int, s: int, n: int, p: int, chunk: int):
    """(ms, by) of the tensor-core design: q, k, v and both gates read and
    y written once at the HBM rate, against the multiply-adds as three
    TF32 MMAs each (3xTF32) at the dense TF32 rate."""
    nbytes = 4 * bh * s * (2 * n + 2 * p + 2)
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = 3 * 2 * gla_fmas(bh, s, n, p, chunk) / TF32_OPS_PER_S
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def gla_ffma_ms(bh: int, s: int, n: int, p: int, chunk: int) -> float:
    """The same multiply-adds as float32 FMAs outside the tensor cores (one
    instruction each): the yardstick of the kernel before tensor cores."""
    return 1e3 * gla_fmas(bh, s, n, p, chunk) / FP32_OPS_PER_S


_L2_SCRUB = []


def flush_l2() -> None:
    """Evict the card's L2 (50 MB on the H100) by writing 256 MB, so that
    what a timed call reads next comes from HBM."""
    if not _L2_SCRUB:
        _L2_SCRUB.append(torch.empty(2 ** 26, dtype=torch.int32,
                                     device="cuda"))
    _L2_SCRUB[0].zero_()


def kernel_device_us(fn, reps: int = 3) -> dict:
    """Device us a call of each kernel that ``fn`` launches, summed by name
    (template arguments kept) under torch.profiler over ``reps`` calls
    after a warm one; empty if three tries record nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    out = {}
    for _ in range(3):     # the profiler now and then records nothing
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                m = re.search(r"::(\w+(?:<[^>(]*>)?)\(", e.name)
                name = m[1] if m else e.name[:40]
                out[name] = (out.get(name, 0.0)
                             + e.time_range.elapsed_us() / reps)
        if out:
            break
    return out


def gla_times(card: str) -> dict:
    """``gla._launch`` (the kernel path on folded operands) and the plain
    version at hymba-1.5B's SSD width, with the reference tests' gates and
    with the model's own, and at the xLSTM-350M head shape: CUDA events
    over 5 launches after a warm one, and each kernel's device us a call.
    Returns {shape: (ms, plain ms, bound)}; no single PyTorch call computes
    the function, so the library time is None."""
    out = {}
    for name, b, s, shape, ones, model in (
            ("hymba", 4, 4096, HYMBA, False, False),
            ("hymba, the model's gates", 4, 4096, HYMBA, False, True),
            ("xlstm", 1, 1024, XLSTM, True, False)):
        chunk = 128
        folded = gla_folded(gla_inputs(b, s, **shape, ones=ones,
                                       model_gates=model), chunk)
        bh, p = folded[0].shape[0], folded[2].shape[-1]
        ms = 1e3 * sync_time(lambda: gla._launch(*folded, chunk), 5)
        plain = 1e3 * sync_time(lambda: gla.gla_folded_plain(*folded, chunk),
                                2)
        per = kernel_device_us(lambda: gla._launch(*folded, chunk))
        stages = "; device us a call: " + (", ".join(
            f"{k} {us:.1f}" for k, us in per.items()) or "not measured")
        bnd = gla_bound(bh, s, shape["n"], p, chunk)
        ffma = gla_ffma_ms(bh, s, shape["n"], p, chunk)
        out[name] = (ms, plain, bnd)
        print(f"  gla_forward {name} BH={bh} S={s} N={shape['n']} P={p} "
              f"chunk {chunk}: {ms:.4f} ms (plain {plain:.2f} ms, library "
              f"None), bound {bnd[0]:.4f} ms by {bnd[1]} (float32 FMAs "
              f"alone {ffma:.4f} ms), {bnd[0] / ms:.1%} of the bound"
              f"{stages} [{card}]")
    return out


def gla_residency(chunk: int = 128) -> None:
    """CTAs an SM of the chunk-state and chunk-output kernels that the
    forward launches at each GLA shape's state width."""
    fn = gla._lib().gla_resident
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    for name, shape in (("hymba", HYMBA), ("xlstm", XLSTM)):
        ctas = [ctypes.c_int(), ctypes.c_int()]
        check(fn(shape["n"], chunk, *map(ctypes.byref, ctas)) == 0,
              "gla_resident")
        print(f"  gla {name} N={shape['n']} chunk {chunk}: CTAs an SM, "
              f"chunk states {ctas[0].value}, chunk outputs {ctas[1].value}")


def phase_times(card: str):
    """Kernel and plain version on the same call. The queue kernel: one
    iteration at Table 5's largest swarm, cubic d=120 n=32768, timed from a
    CUDA graph (its wrapper's host time is as long as the kernel). GLA: the
    launch alone on folded operands at hymba-1.5B's SSD width (B=4,
    S=4096; the JSON line takes the model's own gates), and beside it at
    the xLSTM-350M head shape (``gla_times``).
    Single swarm: the main path's cubic d=1 n=131072 swarm, 32 iterations
    (4 async chunks of 8).
    Batches: the solve_many shape, rastrigin d=10 n=1024 S=128 (the six
    built-ins cycled over S=96 for the hetero kernels), 16 iterations (2
    async chunks of 8), from per-row iteration counters. The fused and
    async kernels with counters off and on (``<name>_counters``), every
    call from a copy of one starting state (``off_on``); ``iters``
    maps each of them to the iterations a call runs. Then the fused and
    async kernels alone at the main path's two solve cells, counters off
    and on (``solve_cell_times``)."""
    d, n, bn = 120, 32768, 512
    _, spec, state, seed = kernel_state("cubic", d, n)
    qkw = dict(seed=seed, iteration=0, block_n=bn)
    kernel_us, wrapper_us, improved = queue_kernel_time(state, spec, qkw)
    t = {"queue_step": kernel_us / 1e6,
         "queue_step_plain": sync_time(
             lambda: pso_step.queue_plain(*state, spec, **qkw), 3)}
    bounds = {"queue_step": queue_bound(d, n, n // bn, improved)}
    print(f"  queue_step: cubic d={d} n={n}, one iteration: the kernel "
          f"{kernel_us:.2f} us a launch (a CUDA graph of 20 replayed), the "
          f"wrapper's host time {wrapper_us:.2f} us a call, {improved:.1f} "
          f"pbest columns written a launch")
    ms, plain, bounds["gla_forward"] = gla_times(card)[
        "hymba, the model's gates"]
    gla_residency()
    t["gla_forward"], t["gla_forward_plain"] = ms / 1e3, plain / 1e3
    d, n, iters, bn = 1, 131072, 32, 512
    nb = n // bn
    _, spec, state, seed = kernel_state("cubic", d, n)
    kw = dict(seed=seed, iteration=0, iters=iters, block_n=bn)
    akw = dict(kw, sync_every=8)
    runs = {"fused": (lambda st, c: pso_step.fused(*st, spec, counts=c,
                                                   **kw), state, 1),
            "fused_async": (lambda st, c: pso_step.fused_async(
                *st, spec, counts=c, **akw), with_locals(state, nb), 1)}
    for key, args in runs.items():
        t[key], t[key + "_counters"] = off_on(*args)
        kernel_off_on(key, *args, iters)
    t.update({
        "fused_plain": sync_time(
            lambda: pso_step.fused_plain(*state, spec, **kw), 3),
        "fused_async_plain": sync_time(
            lambda: pso_step.fused_async_plain(*with_locals(state, nb), spec,
                                               **akw), 1),
    })
    t["iters"] = dict(fused=iters, fused_async=iters)
    bounds["fused"] = bound(d=d, n=n, iters=iters)
    bounds["fused_async"] = bound(d=d, n=n, iters=iters, nb=nb)
    d, n, iters, bn = 10, 1024, 16, 512
    for key, mixed, s_cnt, sync_every in (
            ("fused_batch", False, 128, 0),
            ("hetero_fused_batch", True, 96, 0),
            ("fused_async_batch", False, 128, 8),
            ("hetero_fused_async_batch", True, 96, 8)):
        _, b, fids, specs, _ = batch_state(d, n, s_cnt, mixed=mixed)
        nb = n // bn if sync_every else 0
        state = batch_operands(b, nb)
        kw = dict(iters=iters, block_n=bn, fids=fids)
        if sync_every:
            kw["sync_every"] = sync_every
            kernel, plain = (pso_step.fused_async_batch,
                             pso_step.fused_async_batch_plain)
        else:
            kernel, plain = pso_step.fused_batch, pso_step.fused_batch_plain
        args = (lambda st, c: kernel(*st, b.seed, b.iteration, specs,
                                     counts=c, **kw), state, s_cnt)
        t[key], t[key + "_counters"] = off_on(*args)
        kernel_off_on(key, *args, iters)
        t["iters"][key] = iters
        t[key + "_plain"] = sync_time(lambda: plain(*state, b.seed,
                                                    b.iteration, specs,
                                                    **kw), 1)
        bounds[key] = bound(d=d, n=n, iters=iters, nb=nb,
                            objectives=[BUILTINS[s % 6] if mixed
                                        else "rastrigin"
                                        for s in range(s_cnt)],
                            members=len(specs))
        # Streaming bound: the state read and written once an iteration,
        # S*(20*N*D + 8*N) bytes, for when it does not stay in L2.
        stream = s_cnt * (20 * n * d + 8 * n) * iters / HBM_BYTES_PER_S
        print(f"  {key}: S={s_cnt} d={d} n={n}, {iters} iterations: "
              f"{s_cnt * (20 * n * d + 8 * n) / 1e6:.1f} MB an iteration "
              f"streamed, {stream * 1e3:.4f} ms at the HBM rate")
    solve_cell_times(card)
    return t, bounds


def device_us(fn, state, copy: bool = True) -> float:
    """Device us of ``fn(st)`` in CUDA events around the call alone, ``st``
    a fresh copy of ``state`` (``copy=False``: ``state`` itself)."""
    st = [x.clone() for x in state] if copy else state
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    fn(st)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3


def off_on(run, state, s_cnt: int = 1, rounds: int = 5, reps: int = 5):
    """Seconds a call of ``run(st, counts)`` takes with counters off
    (``counts`` None) and on: each round makes ``reps`` copies of
    ``state`` and runs one call on each, back to back, between two CUDA
    events, so every call starts from the same state and the host's work
    overlaps the card's as in a run; off and on in turns (off first, then
    on first), after a warm round. The medians (off, on) over ``rounds``."""
    per = {False: [], True: []}
    for k in range(rounds + 1):
        for on in (False, True) if k % 2 else (True, False):
            cnt = new_counts(s_cnt) if on else None
            copies = [[x.clone() for x in state] for _ in range(reps)]
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            for st in copies:
                run(st, cnt)
            end.record()
            torch.cuda.synchronize()
            if k:
                per[on].append(start.elapsed_time(end) / 1e3 / reps)
            del copies
    return tuple(sorted(v)[len(v) // 2] for v in per.values())


def kernel_off_on(name: str, run, state, s_cnt: int, iters: int,
                  rounds: int = 3) -> None:
    """Prints the device us an iteration of ``name``'s kernels alone
    (``kernel_device_us``, FAMILY[name]) in ``run(st, counts)`` on copies
    of ``state``, counters off and on in turns: the medians over
    ``rounds``, "not measured" where the profiler recorded no kernel. The
    phase-5 times less these are the host's share."""
    per = {False: [], True: []}
    for k in range(rounds):
        for on in (False, True) if k % 2 else (True, False):
            cnt = new_counts(s_cnt) if on else None
            us = kernel_device_us(
                lambda: run([x.clone() for x in state], cnt), reps=5)
            us = sum(v for kn, v in us.items() if re.search(FAMILY[name], kn))
            if us:
                per[on].append(us / iters)
    got = [f"{sorted(v)[len(v) // 2]:.3f}" if v else "not measured"
           for v in per.values()]
    print(f"  {name}: its kernels alone (torch.profiler, median of "
          f"{rounds} rounds of 5 calls, off and on in turns), device us/iter "
          f"counters off {got[0]}, on {got[1]}")


def solve_cell_times(card: str) -> None:
    """The fused and async kernels alone at the main path's two solve
    cells (Table 4's and Table 5's largest: cubic d=1 n=131072 x1000,
    cubic d=120 n=32768 x200; async at sync_every=8), from the initial
    swarm as ``solve`` runs them: device us an iteration of the wrapper's
    launches, counters off and on (``off_on``)."""
    for d, n, iters in SOLVE_CELLS:
        _, spec, state, seed = kernel_state("cubic", d, n)
        bn = ops._resolve_block(n, None)
        nb = n // bn
        kw = dict(seed=seed, iteration=0, iters=iters, block_n=bn)
        off, on = off_on(lambda st, c: pso_step.fused(*st, spec, counts=c,
                                                      **kw), state)
        aoff, aon = off_on(lambda st, c: pso_step.fused_async(
            *st, spec, counts=c, sync_every=pso.ASYNC_SYNC_EVERY, **kw),
            with_locals(state, nb))
        print(f"  cubic d={d} n={n} x{iters} (clusters of {cluster_of(n, d)})"
              f", the kernels alone, device us/iter (median of 5 rounds of "
              f"5 calls, counters off and on in turns): fused "
              f"{off / iters * 1e6:.3f} / {on / iters * 1e6:.3f}, async "
              f"{aoff / iters * 1e6:.3f} / {aon / iters * 1e6:.3f} [{card}]")


# Each counter's kernel as torch.profiler names it.
FAMILY = {"queue_step": "queue_kernel", "fused": "fused_kernel",
          "fused_batch": "fused_kernel", "hetero_fused_batch": "fused_kernel",
          "fused_async": "async_kernel", "fused_async_batch": "async_kernel",
          "hetero_fused_async_batch": "async_kernel",
          "gla_forward": "gla_(chunk_state|state_pass|chunk_output)"}


def phase_main_path_kernels(card: str) -> dict:
    """Each kernel's device time summed over its main-path launches at
    their own shapes and iteration counts, beside its bound on the same
    launches: every main-path kernel call of phases 4-4d run once more
    under torch.profiler (CUDA activity), its kernels' durations summed.
    Returns {counter: (ms, bound ms)}; ms is None where the profiler saw
    no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    print(f"phase 5c: kernel time on the main paths (torch.profiler) [{card}]")
    out = {}
    for name, what, iters, fn, (b_ms, _) in REPLAY:
        for _ in range(3):     # the profiler now and then records nothing
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            us = sum(e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and re.search(FAMILY[name], e.name))
            if us:
                break
        got = f"{us / iters:.2f} us an iteration" if us else "not measured"
        print(f"    {what} x{iters}: {FAMILY[name]} {got}, bound "
              f"{b_ms * 1e3 / iters:.3f}")
        ms, bms = out.get(name, (0.0, 0.0))
        out[name] = (ms + us / 1e3, bms + b_ms)
    for name, (ms, bms) in out.items():
        if ms == 0.0:
            out[name] = (None, bms)
        print(f"  {name}: {'not measured' if ms == 0.0 else f'{ms:.3f}'} ms "
              f"on the main paths, bound {bms:.3f} ms")
    return out


def phase_cluster_sweep(card: str) -> None:
    """The fused kernel on cubic/pso at each cluster size, for the cluster
    rule (pso_step.cluster_size): us an iteration of one launch of 20
    iterations, CUDA events over 5 launches after one warm launch."""
    print(f"phase 5b: fused kernel at each cluster size, us an iteration "
          f"[{card}]")
    iters, fit, rule = 20, FITNESS_IDS["cubic"], RULE_IDS["pso"]
    for n in (128, 1024, 32768):
        bn = ops._resolve_block(n, None)
        for d in (6, 12, 24, 48, 120):
            _, spec, state, seed = kernel_state("cubic", d, n)
            cells = []
            sizes = [c for c in (1, 2, 3, 4, 6, 8) if c <= d]
            for c in sizes:
                if n // bn > 1 and pso_step._resident(
                        fit, rule, bn, d, c, device_index=0) < n // bn:
                    cells.append(f"C={c} does not fit")
                    continue
                t = sync_time(lambda: pso_step._fused_launch(
                    state, spec, seed=seed, iteration=0, iters=iters,
                    block_n=bn, cluster=c), 5)
                cells.append(f"C={c} {t / iters * 1e6:.2f}")
            caps = ", ".join(f"{pso_step._capacity(bn, d, 0, c)}x{c}"
                             for c in sizes[1:])
            print(f"  cubic d={d} n={n}: {', '.join(cells)}; the rule picks "
                  f"C={cluster_of(n, d)}; resident clusters {caps}")
    # The queue kernel alone needs no residency; it keeps the fused
    # kernel's cluster size so that the two agree bit for bit.
    d, n = 120, 32768
    _, spec, state, seed = kernel_state("cubic", d, n)
    cells = []
    qkw = dict(seed=seed, iteration=0, block_n=512)
    for c in (1, 2, 3, 4, 8):
        us = queue_kernel_time(state, spec, qkw, cluster=c)[0]
        cells.append(f"C={c} {us:.2f}")
    print(f"  queue kernel alone cubic d={d} n={n}, us a launch (CUDA graph): "
          f"{', '.join(cells)}; the rule picks C={cluster_of(n, d)}")
    # Batches fill the card without clusters; a cluster of C gives each
    # cooperative wave C times fewer swarms.
    for d, n, s_cnt in ((10, 1024, 128), (10, 256, 1024), (24, 1024, 128)):
        bn = ops._resolve_block(n, None)
        _, b, _, specs, _ = batch_state(d, n, s_cnt)
        state = batch_operands(b)
        cells = []
        for c in (1, 2, 4):
            if n // bn > 1 and pso_step._resident(
                    FITNESS_IDS["rastrigin"], rule, bn, d, c,
                    device_index=0) < n // bn:
                continue
            t = sync_time(lambda: pso_step._fused_batch_launch(
                state, b.seed, b.iteration, specs, iters=iters, block_n=bn,
                cluster=c), 5)
            cells.append(f"C={c} {t / iters * 1e6:.2f}")
        print(f"  fused batch rastrigin d={d} n={n} S={s_cnt}, us an "
              f"iteration of the batch: {', '.join(cells)}; the rule picks "
              f"C={cluster_of(n, d)}")
    async_cluster_sweep(card)


def async_cluster_sweep(card: str) -> None:
    """The async kernel at each C of CLUSTER_SIZES where a swarm's clusters
    all fit at once (it takes the fused kernel's C): cubic d=120 n=32768
    (the main path's swarm) and n=1024 (Table 5), and the smallest batch
    shape that takes a cluster, rastrigin d=24 n=1024 S=128. us an
    iteration of one launch of 24 iterations at sync_every=8, CUDA events
    over 5 launches after one warm launch."""
    print(f"phase 5b: async kernel at each cluster size, us an iteration "
          f"[{card}]")
    iters, sync_every = 24, 8
    for d, n, s_cnt, fit in ((120, 32768, 1, "cubic"), (120, 1024, 1, "cubic"),
                             (24, 1024, 128, "rastrigin")):
        bn = ops._resolve_block(n, None)
        nb = n // bn
        if s_cnt == 1:
            _, spec, state, seed = kernel_state(fit, d, n)
            state = with_locals(state, nb)

            def run(c):
                pso_step.fused_async(*state, spec, seed=seed, iteration=0,
                                     iters=iters, sync_every=sync_every,
                                     block_n=bn, cluster=c)
        else:
            _, b, _, specs, _ = batch_state(d, n, s_cnt, fit=fit)
            state = batch_operands(b, nb)

            def run(c):
                pso_step.fused_async_batch(
                    *state, b.seed, b.iteration, specs, iters=iters,
                    sync_every=sync_every, block_n=bn, cluster=c)
        cells = []
        for c in (1,) + pso_step.CLUSTER_SIZES:
            if c > 1 and pso_step._capacity(bn, d, 0, c) < nb:
                cells.append(f"C={c} does not fit")
                continue
            t = sync_time(functools.partial(run, c), 5)
            cells.append(f"C={c} {t / iters * 1e6:.2f}")
        print(f"  async {fit} d={d} n={n} S={s_cnt}, us an iteration of the "
              f"batch: {', '.join(cells)}; the rule picks "
              f"C={cluster_of(n, d)}")


# ---------------------------------------------------------------------------
# Phase 6: the split path (kernels/pso_split.py), every Problem that is not
# one of the six unconstrained built-ins: three kernels an iteration around
# the user's torch operators.
# ---------------------------------------------------------------------------

SPLIT = ("split_advance", "split_fold", "split_publish")
#: Each split kernel as torch.profiler names it.
SPLIT_FAMILY = {"split_advance": "split_advance_kernel",
                "split_fold": "split_fold_kernel",
                "split_publish": "split_publish_kernel"}


def plane_ball():
    """Repair mode (the reference tests' ``_plane_ball``): maximize sum(x) in
    [-2, 2]^D subject to ||x||^2 <= 2.25, whose box corner is infeasible."""
    return repro_torch.Problem(
        name="plane_ball", fn=lambda x: torch.sum(x, -1), lo=-2.0, hi=2.0,
        constraints=cons.ConstraintSet(
            constraints=(cons.Constraint(
                fn=lambda x: torch.sum(x * x, -1) - 2.25, name="ball"),),
            mode="repair", repair_tries=64))


def custom_sphere():
    """The built-in sphere's objective and box as a custom Problem: the
    split path beside the built-in fused kernel on the same swarm."""
    return repro_torch.Problem(name="my_sphere",
                               fn=lambda x: -torch.sum(x * x, -1),
                               lo=-100.0, hi=100.0)


def ramped_penalty():
    """sphere_simplex_pen with its weight doubled every 50 iterations."""
    pen = repro_torch.get_problem("sphere_simplex_pen")
    return cons.constrain_problem(pen, cons.ConstraintSet(
        constraints=pen.constraints.constraints, mode="penalty", weight=50.0,
        ramp=2.0, ramp_every=50), name="sphere_simplex_pen_ramp")


def split_round(what, cfg, b, rows, table, variant, bn, errs) -> None:
    """One split iteration of batch ``b`` (S >= 1, two eager iterations in)
    on the card: each kernel against its plain version on the same card
    tensors. The advance must equal bit for bit; the fold (given the same
    fit/viol tensors, counters on) and the publish exactly."""
    fids = None if rows is None else rows.fid
    b = ms.run_many(cfg, b, 2, "queue", rows=rows, table=table)
    s_cnt, n, d = b.pos.shape
    nb = n // bn
    state, specs = ops._batch_to_kernel(cfg, b, fids, table)
    pos, vel, pbp, pbf, gp, gf = state
    fused = variant == "fused"
    attractor, gdiv = ((gp, n) if fused
                   else (gp.repeat_interleave(nb, 1).contiguous(), bn))
    akw = dict(n=n, it_off=0, gdiv=gdiv)
    want = pso_split.split_advance_plain(pos, vel, pbp, attractor, b.seed,
                                         b.iteration, specs, fids, **akw)
    pso_split.advance(pos, vel, pbp, attractor, b.seed, b.iteration, specs,
                      fids, **akw)
    err = max_err((pos, vel), want)
    check(torch.equal(pos, want[0]) and torch.equal(vel, want[1]),
          f"{what}: advance kernel bit for bit its plain version ({err})")
    fit, viol = pso_split.torch_step((cfg.problem,) if table is None
                                     else table, fids, n, (s_cnt, n))(pos)
    pbv = ops._pbv(cfg, fids, b.pbest_pos)
    fkw = dict(n=n, block_n=bn, mode=variant, pbv=pbv, viol=viol)
    if fused:
        fkw.update(gf=gf, keys=torch.zeros(s_cnt, dtype=torch.int64,
                                           device="cuda"))
    else:
        fkw.update(lp=attractor.clone(), lf=gf.repeat_interleave(nb))
    cnt, plain_cnt = new_counts(s_cnt), new_counts(s_cnt)
    want = pso_split.split_fold_plain(pos, pbp, pbf, fit, counts=plain_cnt,
                                      **fkw)
    pso_split.fold(pos, pbp, pbf, fit, counts=cnt, **fkw)
    got = dict(fkw, pbp=pbp, pbf=pbf)
    bad = [k for k, w in want.items() if not torch.equal(got[k], w)]
    check(not bad and torch.equal(cnt, plain_cnt),
          f"{what}: fold kernel equals its plain version ({bad}, counts "
          f"{cnt.tolist()} / {plain_cnt.tolist()})")
    fold_err = max(max_err([got[k]], [w]) for k, w in want.items()
                   if got[k].dtype.is_floating_point)
    pkw = dict(n=n, mode=variant)
    if fused:
        pkw["keys"] = fkw["keys"]
    else:
        pkw.update(lp=fkw["lp"], lf=fkw["lf"], act=torch.full(
            (s_cnt,), pso_split.ACT_SYNC, dtype=torch.int32, device="cuda"))
        pkw["act"][::2] = pso_split.ACT_FLUSH
    want = pso_split.split_publish_plain(pos, fit, gp, gf, counts=plain_cnt,
                                         **pkw)
    pso_split.publish(pos, fit, gp, gf, counts=cnt, **pkw)
    got = dict(gp=gp, gf=gf, **pkw)
    bad = [k for k, w in want.items() if not torch.equal(got[k], w)]
    check(not bad and torch.equal(cnt, plain_cnt),
          f"{what}: publish kernel equals its plain version ({bad})")
    pub_err = max(max_err([got[k]], [w]) for k, w in want.items()
                  if got[k].dtype.is_floating_point)
    for k, e in zip(SPLIT, (err, fold_err, pub_err)):
        errs[k] = max(errs[k], e)
    print(f"  {what} {variant}: advance, fold and publish equal their plain "
          f"versions (max error {max(err, fold_err, pub_err)}; "
          f"{int(cnt[2::3].sum())} block improvements, "
          f"{int(cnt[0::3].sum())} queue updates)")


def phase_split_compare(errs) -> None:
    print("phase 6a: the split kernels against their plain versions on the "
          "card")
    cells = [("sphere_simplex d=8 n=1024", "sphere_simplex", 8, 1024, None),
             ("sphere_simplex d=120 n=32768", "sphere_simplex", 120, 32768,
              512),
             ("plane_ball (repair) d=3 n=64, one block", plane_ball(), 3, 64,
              64)]
    for what, prob, d, n, bn in cells:
        cfg = pso.PSOConfig(dim=d, particle_cnt=n, w=0.7,
                            fitness=prob).resolved()
        b = ms.init_batch(cfg, [0], device="cuda")
        for variant in ("fused", "async"):
            split_round(what, cfg, b, None, None, variant,
                        ops._resolve_block(n, bn), errs)
    # a heterogeneous batch holding a custom member beside built-ins and a
    # penalty-mode member
    table = (repro_torch.get_problem("cubic"), custom_sphere(),
             repro_torch.get_problem("sphere_simplex_pen"),
             repro_torch.get_problem("rastrigin"))
    rows, table = ms.problem_rows([table[s % 4] for s in range(8)], 8,
                                  table=table, device="cuda")
    cfg = pso.PSOConfig(dim=8, particle_cnt=1024, w=0.7).resolved()
    b = ms.init_batch(cfg, range(8), rows=rows, table=table, device="cuda")
    for variant in ("fused", "async"):
        split_round("mixed batch (cubic, custom, penalty, rastrigin) d=8 "
                    "n=1024 S=8", cfg, b, rows, table, variant, 512, errs)
    # the queue mode: one iteration of ops.queue_step, against the plain
    # versions chained alike on the CPU copy
    cfg = pso.PSOConfig(dim=8, particle_cnt=1024, w=0.7,
                        fitness="sphere_simplex").resolved()
    s = pso.run(cfg, pso.init_swarm(cfg, 0, device="cuda"), 2, "queue")
    got = ops.queue_step(cfg, s, block_n=256)
    want = pso.step_queue(cfg, s)
    check(torch.equal(got.pos, want.pos) and torch.equal(
        got.gbest_pos, want.gbest_pos), "split queue step == step_queue")
    print("  sphere_simplex d=8 n=1024 queue mode: ops.queue_step equals "
          "core.pso.step_queue bit for bit")


#: Phase 6b's cells: (label, problem, d, n, iterations).
SPLIT_CELLS = (
    ("sphere_simplex", "sphere_simplex", 8, 1024, 200),
    ("sphere_simplex_pen", "sphere_simplex_pen", 8, 1024, 200),
    ("sphere_simplex_pen ramp 2.0/50", "ramp", 8, 1024, 200),
    ("plane_ball (repair)", "plane_ball", 3, 1024, 200),
    ("custom sphere", "custom", 8, 1024, 200),
    ("sphere_simplex", "sphere_simplex", 120, 32768, 200),
    ("custom sphere", "custom", 120, 32768, 200),
)


def split_problem(key):
    return {"ramp": ramped_penalty, "plane_ball": plane_ball,
            "custom": custom_sphere}.get(
        key, lambda: repro_torch.get_problem(key))()


def split_invariants(what, res, prob, iters) -> None:
    """Feasibility, history and gbest invariants of a split-path Result."""
    s = res.state
    cs = prob.constraints
    check(math.isfinite(res.best_fit), f"{what}: finite gbest")
    if prob.projection_fn is not None:
        check(float(s.pos.min()) >= 0.0 and float(
            (s.pos.sum(-1) - 1).abs().max()) <= 1e-5 and res.feasible,
            f"{what}: every position on the simplex")
    if cs is not None and cs.mode == "repair":
        v = prob.violation_fn(s.pbest_pos)
        check(float(v.max()) <= 0.0, f"{what}: every pbest feasible")
    if cs is None or cs.mode == "penalty":
        check(float(s.gbest_fit) == float(s.pbest_fit.max()),
              f"{what}: gbest == max pbest")
    h = res.history
    every = cs.ramp_every if cs is not None and cs.ramp_every else iters
    seg = (h.iteration - 1) // every          # the ramp's weight segments
    check(int(h.iteration[-1]) == iters and all(
        bool(np.all(np.diff(h.gbest_fit[seg == k]) >= 0))
        for k in np.unique(seg)), f"{what}: gbest monotone within each "
          f"weight, the history ending at iteration {iters}")


def phase_split_path(card: str):
    """The split path's main path: ``repro_torch.solve`` on the kernel
    backend (auto on the card) for each cell of SPLIT_CELLS and both kernel
    variants, each run with every launch count set to 0 just before it and
    read just after. Returns (launches, the split kernels' device us an
    iteration at sphere_simplex d=120 n=32768 queue_lock)."""
    print(f"phase 6b: main path, repro_torch.solve(backend='auto') on the "
          f"split path [{card}]")
    launches = dict.fromkeys(SPLIT, 0)
    by_variant = {v: dict.fromkeys(SPLIT, 0) for v in ("queue_lock", "async")}
    main_ms = dict.fromkeys(SPLIT, 0.0)
    main_bound = dict.fromkeys(SPLIT, 0.0)
    big = {}
    for label, key, d, n, iters in SPLIT_CELLS:
        prob = split_problem(key)
        for variant in ("queue_lock", "async"):
            what = f"{label} d={d} n={n} x{iters} {variant}"
            kw = dict(dim=d, particles=n, seed=0, variant=variant, w=0.7)
            repro_torch.solve(prob, iters=2, **kw)           # warm-up
            zero_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = repro_torch.solve(prob, iters=iters, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = {k: v for k, v in read_counts().items() if v}
            check(set(counts) == set(SPLIT) and all(
                counts[k] >= iters for k in SPLIT),
                f"{what}: the three split kernels, and no other "
                f"({counts})")
            for k in SPLIT:
                launches[k] += counts[k]
                by_variant[variant][k] += counts[k]
            mem = torch.cuda.max_memory_allocated()
            hist = repro_torch.solve(prob, iters=iters, record_history=True,
                                     **kw)
            check(hist.best_fit == res.best_fit, f"{what}: history on and "
                  f"off agree")
            split_invariants(what, hist, prob, iters)
            dev = kernel_device_us(functools.partial(
                repro_torch.solve, prob, iters=iters, **kw), reps=1)
            per = {k: sum(v for kn, v in dev.items()
                          if re.search(SPLIT_FAMILY[k], kn)) / iters
                   for k in SPLIT}
            other = (sum(dev.values()) / iters - sum(per.values())
                     if dev else 0.0)
            for k, (b_ms, _) in split_bounds(d, n, prob.deb).items():
                main_ms[k] += per[k] * iters / 1e3
                main_bound[k] += b_ms * counts[k]
            if d == 120 and key == "sphere_simplex" and variant == \
                    "queue_lock":
                big = per
            opt = ("" if key in ("custom", "plane_ball")
                   else f" (optimum 1/D = {1 / d:.7g})")
            dev_txt = (", ".join(f"{k[6:]} {v:.2f}" for k, v in per.items())
                       + f", torch step and the rest {other:.2f}"
                       if dev else "not measured")
            print(f"  {what}: {dt / iters * 1e6:.2f} us/iter [device us/iter "
                  f"{dev_txt}]; gbest {res.best_fit:.7g}{opt}, violation "
                  f"{res.violation:.3g}, feasible {res.feasible}; peak "
                  f"memory {mem / 2**20:.1f} MiB")
    batch_launches = split_many_path(main_ms, main_bound)
    for k in SPLIT:
        launches[k] += batch_launches[k]
    print(f"  launches on this main path: solve queue_lock (fused mode) "
          f"{by_variant['queue_lock']}, solve async {by_variant['async']}, "
          f"solve_many {batch_launches}")
    print("  device ms summed over these launches (torch.profiler), beside "
          "their bound (the fold's without its data-dependent pbest copies): "
          + ", ".join(f"{k} {main_ms[k]:.3f} ({main_bound[k]:.3f})"
                      for k in SPLIT))
    split_beside_builtin(card)
    return launches, big


#: split_many_path's batch: (d, n, S, iterations).
SPLIT_MANY = (8, 1024, 64, 100)


def split_many_path(main_ms: dict, main_bound: dict) -> dict:
    """``repro_torch.solve_many`` of sphere_simplex on the split path, both
    kernel variants (the batched converted forms, rows 3c and 6c), each run
    with the launch counts set to 0 just before it and read just after;
    every row's positions on the simplex. Adds the kernels' device ms and
    bounds into ``main_ms``/``main_bound``; returns the launches."""
    d, n, s_cnt, iters = SPLIT_MANY
    launches = dict.fromkeys(SPLIT, 0)
    for variant in ("queue_lock", "async"):
        what = f"solve_many sphere_simplex d={d} n={n} S={s_cnt} x{iters} " \
               f"{variant}"
        kw = dict(dim=d, particles=n, variant=variant, w=0.7)
        repro_torch.solve_many("sphere_simplex", range(2), iters=2, **kw)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = repro_torch.solve_many("sphere_simplex", range(s_cnt),
                                      iters=iters, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k: v for k, v in read_counts().items() if v}
        check(set(counts) == set(SPLIT), f"{what}: the three split kernels, "
              f"and no other ({counts})")
        for k in SPLIT:
            launches[k] += counts[k]
        pos = torch.stack([r.state.pos for r in rows])
        check(float(pos.min()) >= 0.0 and float(
            (pos.sum(-1) - 1).abs().max()) <= 1e-5 and all(
            r.feasible for r in rows), f"{what}: every row on the simplex")
        dev = kernel_device_us(functools.partial(
            repro_torch.solve_many, "sphere_simplex", range(s_cnt),
            iters=iters, **kw), reps=1)
        per = {k: sum(v for kn, v in dev.items()
                      if re.search(SPLIT_FAMILY[k], kn)) for k in SPLIT}
        for k, (b_ms, _) in split_bounds(d, s_cnt * n, True,
                                         s_cnt=s_cnt).items():
            main_ms[k] += per[k] / 1e3
            main_bound[k] += b_ms * counts[k]
        best = repro_torch.best(rows)
        print(f"  {what}: {dt / iters * 1e6:.2f} us/iter of the batch "
              f"[device us/iter " + ", ".join(
                  f"{k[6:]} {per[k] / iters:.2f}" for k in SPLIT)
              + f"]; best row gbest {best.best_fit:.7g} (optimum "
              f"{1 / d:.7g}), launches {counts}")
    return launches


#: split_beside_builtin's swarms (d, n) and its solves' iterations.
BESIDE_CELLS, BESIDE_ITERS = ((8, 1024), (120, 32768)), 200


def split_beside_builtin(card: str) -> None:
    """The custom sphere (split path) beside the built-in sphere (fused
    kernel) on the same swarm: iteration 1's positions bit for bit, then
    ten iterations one at a time from the built-in's state (positions bit
    for bit, fitness within FIT_RTOL, a differing gbest only as a named
    comparison flip), and both solves' us/iter."""
    for d, n in BESIDE_CELLS:
        cb = pso.PSOConfig(dim=d, particle_cnt=n, w=0.7,
                           fitness="sphere").resolved()
        cc = pso.PSOConfig(dim=d, particle_cnt=n, w=0.7,
                           fitness=custom_sphere()).resolved()
        s = pso.init_swarm(cb, 0, device="cuda")
        flips = []
        for t in range(10):
            a = ops.run_queue_lock_fused(cb, s, 1)
            c = ops.run_queue_lock_fused(cc, s, 1)
            check(torch.equal(a.pos, c.pos) and torch.equal(a.vel, c.vel),
                  f"custom vs built-in sphere d={d}: iteration {t + 1}'s "
                  f"positions bit for bit")
            tol = FIT_RTOL * max(1.0, abs(float(a.gbest_fit)))
            check(abs(float(a.gbest_fit) - float(c.gbest_fit)) <= tol and
                  torch.allclose(a.pbest_fit, c.pbest_fit, rtol=FIT_RTOL,
                                 atol=tol),
                  f"custom vs built-in sphere d={d}: fitness within "
                  f"FIT_RTOL at iteration {t + 1}")
            if not torch.equal(a.gbest_pos, c.gbest_pos):
                flips.append(t + 1)
            s = a
        times = []
        for prob in ("sphere", custom_sphere()):
            kw = dict(dim=d, particles=n, iters=BESIDE_ITERS, seed=0,
                      variant="queue_lock", w=0.7)
            repro_torch.solve(prob, **dict(kw, iters=2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            repro_torch.solve(prob, **kw)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / BESIDE_ITERS * 1e6)
        print(f"  custom sphere beside the built-in sphere d={d} n={n}: ten "
              f"iterations step by step, positions bit for bit, fitness "
              f"within {FIT_RTOL:g}, gbest comparison flips at "
              f"{flips or 'none'}; solve x{BESIDE_ITERS} queue_lock: "
              f"built-in fused kernel {times[0]:.2f} us/iter, split path "
              f"{times[1]:.2f} us/iter "
              f"[{card}]")


def split_bounds(d: int, n: int, deb: bool, improved: int = 0,
                 s_cnt: int = 1) -> dict:
    """Each split kernel's bound (ms, by) for one launch on ``s_cnt``
    swarms of ``n`` particles in all, in ``d`` dimensions (``roof``): the
    advance reads pos, vel, pbp, the attractor column, the bounds rows and
    the counters and writes pos and vel, against its integer and float
    operations; the fold reads fit, pbf and gf (and viol, pbv under Deb's
    rule) and writes pbf (pbv) and a pbest column (pos read, pbp written)
    for each of ``improved`` particles, and the key; the publish reads the
    key, the winner's column and fitness and writes gbest and clears the
    key."""
    per = 3 if deb else 2           # fit, pbf (viol, pbv) read a particle
    return {
        "split_advance": roof(4 * (5 * n * d + d + 4 * d + 2),
                              n * d * INT_PER_ELEMENT,
                              n * d * FP_DRAWS_RULE),
        "split_fold": roof(4 * (per * n + s_cnt) + improved * (
            (8 if deb else 4) + 8 * d) + 8 * s_cnt, 0, 4 * n),
        "split_publish": roof(s_cnt * (8 + 8 * (d + 1) + 8), 0, 0)}


def split_times(card: str, times: dict, bounds: dict) -> None:
    """Each split kernel and its plain version on one call at the main
    path's largest cell (sphere_simplex d=120 n=32768, block 512, fused
    mode, two eager iterations in), each call on a fresh copy of the
    operands with the L2 flushed after the copy (``flush_l2``: the inputs
    come from HBM, as the bound counts them): the kernel alone under
    torch.profiler (the mean of 5 calls; the JSON's ms), the call in CUDA
    events (the median of 5; host-paced, the wrapper's host work inside),
    the plain version in CUDA events; beside them the card's bound for that
    call (``split_bounds``), counted from this call's data. A profiler
    reading below the bound or above the call's events is not the
    kernel's: it is taken again, and after three tries the events' reading
    stands in for it (an upper bound of the kernel's time)."""
    print(f"phase 6c: the split kernels and their plain versions on one "
          f"call, sphere_simplex d=120 n=32768 [{card}]")
    d, n, bn = 120, 32768, 512
    cfg = pso.PSOConfig(dim=d, particle_cnt=n, w=0.7,
                        fitness="sphere_simplex").resolved()
    s = pso.run(cfg, pso.init_swarm(cfg, 0, device="cuda"), 2, "queue")
    state = list(ops.state_to_kernel(s))
    state[4] = state[4][:, None].contiguous()
    pos, vel, pbp, pbf, gp, gf = state
    spec, (seed, it) = ops.kernel_spec(cfg), ops._seed_rows(s)
    akw = dict(n=n, it_off=0, gdiv=n)
    events, read_by = {}, {}

    def cold(args):
        st = [x.clone() for x in args]
        flush_l2()
        return st

    def med(fn, args):
        return sorted(device_us(fn, cold(args), copy=False)
                      for _ in range(5))[2] / 1e6

    def alone(key, fn, args):
        """(kernel alone s, call in events s); how the first was read
        goes to ``read_by``."""
        ev, lo = med(fn, args), bounds[key][0] / 1e3
        seen = []
        for _ in range(3):
            us = kernel_device_us(lambda: fn(cold(args)), reps=5)
            us = sum(v for kn, v in us.items()
                     if re.search(SPLIT_FAMILY[key], kn)) / 1e6
            seen.append(us)
            if lo <= us <= 1.1 * ev:
                read_by[key] = "torch.profiler"
                return us, ev
        read_by[key] = (f"CUDA events (torch.profiler read "
                        f"{', '.join(f'{x * 1e6:.2f}' for x in seen)} us, "
                        f"outside [bound, events])")
        return ev, ev

    bounds["split_advance"] = split_bounds(d, n, True)["split_advance"]
    times["split_advance"], events["split_advance"] = alone(
        "split_advance", lambda st: pso_split.advance(
            *st, gp, seed, it, (spec,), **akw), (pos, vel, pbp))
    times["split_advance_plain"] = med(lambda st: pso_split.
                                       split_advance_plain(
                                           *st, gp, seed, it, (spec,),
                                           **akw), (pos, vel, pbp))
    pso_split.advance(pos, vel, pbp, gp, seed, it, (spec,), **akw)
    fit, viol = pso_split.torch_step((cfg.problem,), None, n, (n,))(pos)
    pbv = ops._pbv(cfg, None, s.pbest_pos)
    keys = torch.zeros(1, dtype=torch.int64, device="cuda")
    fkw = dict(n=n, block_n=bn, mode="fused", gf=gf, viol=viol)
    improved = int(cons.deb_improved(fit, viol, pbf, pbv).sum())
    bounds.update(split_bounds(d, n, True, improved))

    def fold(st):
        pso_split.fold(pos, st[0], st[1], fit, pbv=st[2], keys=st[3], **fkw)

    def fold_plain(st):
        pso_split.split_fold_plain(pos, st[0], st[1], fit, pbv=st[2],
                                   keys=st[3], **fkw)
    fstate = (pbp, pbf, pbv, keys)
    times["split_fold"], events["split_fold"] = alone("split_fold", fold,
                                                      fstate)
    times["split_fold_plain"] = med(fold_plain, fstate)
    pso_split.fold(pos, pbp, pbf, fit, pbv=pbv, keys=keys, **fkw)
    pkw = dict(n=n, mode="fused")
    pstate = (gp, gf, keys)
    times["split_publish"], events["split_publish"] = alone(
        "split_publish", lambda st: pso_split.publish(
            pos, fit, st[0], st[1], keys=st[2], **pkw), pstate)
    times["split_publish_plain"] = med(lambda st: pso_split.
                                       split_publish_plain(
                                           pos, fit, st[0], st[1],
                                           keys=st[2], **pkw), pstate)
    for k in SPLIT:
        print(f"  {k}: the kernel alone {times[k] * 1e6:.2f} us (read by "
              f"{read_by[k]}), the call {events[k] * 1e6:.2f} us (plain "
              f"{times[k + '_plain'] * 1e6:.2f} us), bound "
              f"{bounds[k][0] * 1e3:.3f} us by {bounds[k][1]}"
              + (f"; {improved} pbest columns written" if k == "split_fold"
                 else ""))


# ---------------------------------------------------------------------------
# Phase 7: the lbest topologies (ring, von Neumann) of the async kernel
# (rows 5-7) and of the split path's publish kernel.
# ---------------------------------------------------------------------------

LBEST = ("ring", "vonneumann")
#: The async rows: their wrappers count the lbest launches as well.
ASYNC_ROWS = ("fused_async", "fused_async_batch", "hetero_fused_async_batch")
#: Block counts whose neighbour ids the card computes (1..7: degenerate
#: grids; 64, 256: the solve cells' von Neumann 8x8 and 16x16).
NEIGHBOR_NBS = (1, 2, 3, 7, 64, 256)
#: The multi-block invariant runs: (d, n, launches, iterations a launch) at
#: the solve cells, and solve_many's iterations.
LBEST_CELLS = ((1, 131072, 3, 16), (120, 32768, 2, 16))
LBEST_MANY_ITERS = 200


def kernel_fitness(spec, cols, c: int):
    """The kernels' own fitness of each column of ``cols`` ``[D, m]`` on
    the card, summed as the fused and async kernels sum it on clusters of
    ``c``: one fused iteration that leaves every position where it is
    (w = c1 = c2 = 0, pbest at the position, no velocity) folds it into a
    pbest of -inf. A check that a stored (position, fitness) pair is whole
    then depends on no reduction order."""
    still = dataclasses.replace(spec, rule="pso", w=0.0, c1=0.0, c2=0.0)
    pos = cols.contiguous().clone()
    m = pos.shape[1]
    pbf = torch.full((m,), -math.inf, device=pos.device)
    state = (pos, torch.zeros_like(pos), pos.clone(), pbf, pos[:, 0].clone(),
             torch.full((1,), -math.inf, device=pos.device))
    pso_step._fused_launch(state, still, seed=0, iteration=0, iters=1,
                           block_n=m, cluster=c)
    torch.cuda.synchronize()
    check(torch.equal(pos, cols), "kernel_fitness leaves positions alone")
    return pbf


def whole_slots(what, spec, lp, lf, gp, gf, c: int) -> None:
    """The torn-read check: every local-best slot's position (``lp``
    ``[D, m]``) and every gbest's (``gp`` ``[D]`` or ``[D, S]``) evaluate,
    in the kernels' own arithmetic, to exactly the fitness stored with
    them."""
    got = kernel_fitness(spec, torch.cat((lp, gp.reshape(lp.shape[0], -1)),
                                         1), c)
    want = torch.cat((lf.reshape(-1), gf.reshape(-1)))
    bad = int((got != want).sum())
    check(bad == 0, f"{what}: {bad} slot(s) whose position does not "
          f"evaluate to its stored fitness (a torn copy)")


def lbest_neighbor_ids() -> None:
    for topo in LBEST:
        for nb in NEIGHBOR_NBS:
            got = pso_step.neighbor_ids(nb, topo, "cuda").cpu()
            want = pso_step.neighbor_ids(nb, topo, "cpu")
            check(torch.equal(got, want), f"{topo} nb={nb}: the card's "
                  f"neighbour ids == kernel_neighbor_ids")
    print(f"  neighbour ids on the card == core.topology.kernel_neighbor_ids "
          f"exactly, nb in {NEIGHBOR_NBS}, ring and von Neumann")


def lbest_one_block(errs) -> None:
    """One block: an lbest fold reads only the block itself, so the lbest
    kernel equals the star's bit for bit; against its plain version at
    C = 1 (cubic d=8 n=512, 53 iterations at sync_every=8: a remainder
    launch) within the phase-3 tolerances, and at C = 8 (rastrigin d=120
    n=128, iterations 6..10 at sync_every=2) up to a comparison flip in the
    last iteration, as ``async_one_block``."""
    for topo in LBEST:
        for fit, d, n, kw in (
                ("cubic", 8, 512, dict(iteration=0, iters=53, sync_every=8)),
                ("rastrigin", 120, 128, dict(iteration=5, iters=5,
                                             sync_every=2))):
            cfg, spec, state, seed = kernel_state(fit, d, n)
            c = cluster_of(n, d)
            check(c == (1 if d == 8 else 8), f"d={d} n={n}: clusters of {c}")
            kw = dict(kw, seed=seed, block_n=n)
            loc = with_locals(state, 1)
            got = pso_step.fused_async(*[x.clone() for x in loc], spec,
                                       topology=topo, **kw)
            star = pso_step.fused_async(*[x.clone() for x in loc], spec,
                                        **kw)
            want = pso_step.fused_async_plain(*loc, spec, topology=topo,
                                              **kw)
            torch.cuda.synchronize()
            what = (f"async {topo} {fit} d={d} n={n} one block, clusters of "
                    f"{c}")
            check(same(got, star), f"{what}: bit for bit the star's kernel")
            if c > 1 and disagreeing(got, want, ASYNC_FIELDS):
                prev = pso_step.fused_plain(
                    *state, spec, seed=seed, iteration=kw["iteration"],
                    iters=kw["iters"] - 1, block_n=n)
                check(is_flip(cfg, prev, want[:6], got[:6]),
                      f"{what}: kernel and plain disagree, max error "
                      f"{disagreeing(got, want, ASYNC_FIELDS)}")
                print(f"  {what}: == the star's kernel bit for bit; a "
                      f"comparison flip at a near tie in the last iteration")
                continue
            e = compare(got, want, ASYNC_FIELDS, what)
            errs["fused_async"] = max(errs["fused_async"], e)
            print(f"  {what}, {kw['iters']} iterations at sync_every="
                  f"{kw['sync_every']}: == the star's kernel bit for bit, "
                  f"max |kernel - plain| = {e:.3g}")


def lbest_invariants(topo, d, n, launches, iters, sync_every=8) -> None:
    """The lbest kernel over many blocks, a race by design, at a main-path
    cell: ``launches`` launches of ``iters`` from the initial cubic swarm,
    each held to gbest monotone, == max(pbest) after the final flush and ==
    a pbest column, positions in the box, every slot's fitness
    non-decreasing and at least its neighbourhood's best at launch, every
    slot whole (``whole_slots``); over all launches, publications <=
    chunks x blocks."""
    cfg, spec, state, seed = kernel_state("cubic", d, n, seed=1)
    bn = ops._resolve_block(n, None)
    nb = n // bn
    c = cluster_of(n, d)
    state = with_locals(state, nb)
    prev = float(state[5][0])
    cnt = new_counts()
    for launch in range(launches):
        lf0 = state[7].clone()
        _, hood = topology.block_neighbor_best(lf0, state[6].T, topo)
        pso_step.fused_async(*state, spec, seed=seed,
                             iteration=iters * launch, iters=iters,
                             sync_every=sync_every, block_n=bn, counts=cnt,
                             topology=topo)
        torch.cuda.synchronize()
        pos, _, pbp, pbf, gp, gf, lp, lf = state
        what = (f"async {topo} cubic d={d} n={n} ({nb} blocks, clusters of "
                f"{c}), launch {launch + 1}")
        g = float(gf[0])
        check(g >= prev, f"{what}: gbest monotone ({g} < {prev})")
        check(g == float(pbf.max()), f"{what}: gbest == max(pbest)")
        check(gbest_is_a_pbest(pbp, pbf, gp, gf), f"{what}: gbest_pos a "
              f"pbest column of fitness gbest")
        lo, hi, _ = pso_step._operands(spec, pos.device)
        check(bool(((pos >= lo) & (pos <= hi)).all()), f"{what}: in bounds")
        check(bool((lf >= lf0).all()), f"{what}: every slot non-decreasing")
        check(bool((lf >= hood).all()), f"{what}: every slot >= its "
              f"neighbourhood's best at launch")
        whole_slots(what, spec, lp, lf, gp, gf, c)
        if d == 1:
            check(torch.equal(cfg.fitness_fn(lp.T.contiguous()), lf),
                  f"{what}: torch's fitness at every slot == its own")
        prev = g
    counts_invariants(cnt, launches * iters, nb, f"async {topo} d={d}",
                      "fused_async",
                      chunks=launches * n_chunks(iters, sync_every))
    print(f"  async {topo} cubic d={d} n={n} ({nb} blocks, clusters of {c}) "
          f"{launches} launches of {iters} at sync_every={sync_every}: gbest "
          f"{prev:.7g} monotone, == max(pbest), a pbest column; in bounds; "
          f"every slot non-decreasing, >= its neighbourhood at launch and "
          f"whole; counts {cnt.tolist()} within the async invariants")


def lbest_main(what, fn, want_counts):
    """One main-path call with every launch count set to 0 just before it
    and read just after: (its result, host seconds, the counts)."""
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {k: v for k, v in read_counts().items() if v}
    check(set(counts) == want_counts, f"{what}: launched {want_counts} and "
          f"no other ({counts})")
    return res, dt, counts


def lbest_solve_cells(card: str, launches: dict) -> None:
    """``repro_torch.solve(variant="async", topology=...)`` at the paper's
    largest solve cells, the star beside ring and von Neumann (every lbest
    launch counted under its row): us an iteration, gbest, the result's
    slots whole; then the async kernel alone from one state, device us an
    iteration in turns (the median of five)."""
    for d, n, iters in SOLVE_CELLS:
        bn = ops._resolve_block(n, None)
        c = cluster_of(n, d)
        line = []
        for topo in ("gbest",) + LBEST:
            kw = dict(dim=d, particles=n, seed=0, variant="async",
                      topology=topo)
            repro_torch.solve("cubic", iters=2, **kw)          # warm-up
            what = f"solve cubic d={d} n={n} x{iters} async {topo}"
            res, dt, counts = lbest_main(what, functools.partial(
                repro_torch.solve, "cubic", iters=iters, **kw),
                {"fused_async"})
            if topo != "gbest":
                launches["fused_async"] += counts["fused_async"]
            st = res.state
            g = res.best_fit
            check(math.isfinite(g) and g <= OPTIMUM_PER_DIM * d * (1 + 1e-6),
                  f"{what}: finite gbest <= the optimum")
            check(g == float(st.pbest_fit.max()), f"{what}: gbest == "
                  f"max(pbest)")
            check(gbest_is_a_pbest(st.pbest_pos.T, st.pbest_fit,
                                   st.gbest_pos, st.gbest_fit),
                  f"{what}: gbest_pos a pbest")
            whole_slots(what, ops.kernel_spec(res.config), st.lbest_pos.T,
                        st.lbest_fit, st.gbest_pos, st.gbest_fit, c)
            line.append(f"{topo} {dt / iters * 1e6:.2f} us/iter gbest "
                        f"{g:.7g}")
        rows, cols = topology.grid_dims(n // bn)
        print(f"  solve cubic d={d} n={n} x{iters} async, sync_every=8, "
              f"{n // bn} blocks (von Neumann {rows}x{cols}), "
              f"clusters of {c}: " + "; ".join(line)
              + f" (optimum {OPTIMUM_PER_DIM * d:.7g}); every slot whole "
              f"[{card}]")
        _, spec, state, seed = kernel_state("cubic", d, n)
        state = with_locals(state, n // bn)
        kw = dict(seed=seed, iteration=0, iters=iters, block_n=bn,
                  sync_every=pso.ASYNC_SYNC_EVERY)
        us = {t: [] for t in ("gbest",) + LBEST}
        for k in range(6):
            order = list(us) if k % 2 else list(us)[::-1]
            for topo in order:
                t = device_us(lambda st: pso_step.fused_async(
                    *st, spec, topology=topo, **kw), state)
                if k:
                    us[topo].append(t / iters)
        print(f"  cubic d={d} n={n} x{iters}, the async kernel alone from "
              f"one state, device us/iter (CUDA events, median of 5, in "
              f"turns): " + ", ".join(
                  f"{t} {sorted(v)[2]:.3f} ("
                  + ", ".join(f"{u:.3f}" for u in v) + ")"
                  for t, v in us.items()) + f" [{card}]")
        # what the topologies change in the swarm's work: the counters of
        # the run, the particles whose pbest rose (each a pbest column
        # copy) and the device time, chunk by chunk, the first four chunks
        # (where the swarm still climbs) apart from the rest
        work = []
        se = kw["sync_every"]
        for topo in us:
            st, cnt, rises, t = [x.clone() for x in state], new_counts(), 0, []
            for ch in range(iters // se):
                prev = st[3].clone()
                t.append(device_us(lambda x: pso_step.fused_async(
                    *x, spec, topology=topo, counts=cnt,
                    **dict(kw, iteration=ch * se, iters=se)), st, copy=False))
                rises += int((st[3] > prev).sum())
            q, pub, imp = cnt.tolist()
            work.append(f"{topo} {q} queue updates, {pub} publications, "
                        f"{imp} block improvements, {rises} pbest rises, "
                        f"device us/iter {sum(t[:4]) / (4 * se):.2f} in "
                        f"chunks 1-4, "
                        f"{sum(t[4:]) / max(1, len(t[4:]) * se):.2f} after")
        print(f"  cubic d={d} n={n} x{iters}, chunk by chunk (launches of "
              f"{se}, counters on): " + "; ".join(work) + f" [{card}]")


def lbest_many(card: str, launches: dict) -> None:
    """``repro_torch.solve_many`` under both lbest topologies, beside the
    star, at phase 4e's batches (rastrigin d=10 n=1024 S=128; the six
    built-ins over S=96), counters on: every row's gbest == max(pbest),
    positions in its box, publications <= chunks x blocks, its slots
    whole (every lbest launch counted under its row)."""
    for label, where, s_cnt, n in MANY_TELEMETRY:
        key = ("hetero_fused_async_batch" if "problems" in where
               else "fused_async_batch")
        bn = ops._resolve_block(n, None)
        nb = n // bn
        for topo in ("gbest",) + LBEST:
            iters = LBEST_MANY_ITERS
            kw = dict(where, seeds=range(s_cnt), dim=10, particles=n,
                      iters=iters, variant="async", topology=topo,
                      telemetry=True)
            what = f"solve_many {label} x{iters} async {topo}"
            repro_torch.solve_many(**dict(kw, iters=2))       # warm-up
            rows, dt, counts = lbest_main(what, functools.partial(
                repro_torch.solve_many, **kw), {key})
            if topo != "gbest":
                launches[key] += counts[key]
            groups = {}
            for r in rows:
                st = r.state
                check(r.config.topology == topo, f"{what}: the topology "
                      f"reported")
                check(r.gbest_fit == float(st.pbest_fit.max()),
                      f"{what}: gbest == max(pbest) in every row")
                check(bool(((st.pos >= r.config.min_pos)
                            & (st.pos <= r.config.max_pos)).all()),
                      f"{what}: every row in its box")
                check(r.telemetry.publications
                      <= n_chunks(iters, pso.ASYNC_SYNC_EVERY) * nb,
                      f"{what}: publications <= chunks x blocks")
                groups.setdefault(ops.kernel_spec(r.config), []).append(st)
            for spec, sts in groups.items():
                whole_slots(what, spec,
                            torch.cat([x.lbest_pos.T for x in sts], 1),
                            torch.cat([x.lbest_fit for x in sts]),
                            torch.stack([x.gbest_pos for x in sts], 1),
                            torch.stack([x.gbest_fit for x in sts]),
                            cluster_of(n, 10))
            best = max(r.gbest_fit for r in rows)
            print(f"  {what}: {dt / iters * 1e6:.2f} us/iter of the "
                  f"batch, best row {best:.7g}; every row's gbest == "
                  f"max(pbest), in its box, its slots whole, publications "
                  f"<= chunks x {nb}; launches {counts} [{card}]")


def lbest_split(card: str) -> None:
    """The split path's lbest (the pull inside the publish kernel) on the
    card: sphere_simplex d=8 n=1024 x100 through ``solve`` on the kernel
    backend equals the eager engine's, bit for bit."""
    if pso_split is None:
        return
    for topo in LBEST:
        m = dict(variant="async", topology=topo, block_n=128, w=0.7)
        zero_counts()
        kern = repro_torch.solve("sphere_simplex", dim=8, particles=1024,
                                 iters=100, backend="kernel", **m)
        counts = {k: v for k, v in read_counts().items() if v}
        check(set(counts) == set(SPLIT), f"split {topo}: the split kernels "
              f"({counts})")
        eager = repro_torch.solve("sphere_simplex", dim=8, particles=1024,
                                  iters=100, backend="eager", **m)
        for f in ("pos", "vel", "pbest_pos", "pbest_fit", "gbest_pos",
                  "gbest_fit", "lbest_pos", "lbest_fit"):
            check(torch.equal(getattr(kern.state, f),
                              getattr(eager.state, f)),
                  f"split {topo}: {f} bit for bit the eager engine's")
        print(f"  split path sphere_simplex d=8 n=1024 x100 async {topo} (8 "
              f"blocks): == the eager run_async bit for bit, gbest "
              f"{kern.best_fit:.7g} (optimum 0.125), feasible "
              f"{kern.feasible} [{card}]")


def phase_lbest(card: str, errs) -> dict:
    """Phase 7; returns the lbest launches of its main-path calls."""
    print(f"phase 7: the lbest topologies, ring and von Neumann [{card}]")
    t0 = time.perf_counter()
    launches = dict.fromkeys(ASYNC_ROWS, 0)
    lbest_neighbor_ids()
    lbest_one_block(errs)
    for topo in LBEST:
        for cell in LBEST_CELLS:
            lbest_invariants(topo, *cell)
    lbest_solve_cells(card, launches)
    lbest_many(card, launches)
    lbest_split(card)
    print(f"  phase 7: {time.perf_counter() - t0:.1f} s; lbest launches on "
          f"its main paths {launches}")
    return launches


#: Phase 8: the reference serving tests' trace (tests/test_serving.py:
#: d=10, n=128, sync_every 8, lane width 8, the six built-ins): budgets of
#: whole chunks, one with a remainder of 4 (a tail ejection) and one under a
#: chunk (a standalone solve); 11 requests for 8 slots (row swaps).
SERVE_BUDGETS = (16, 8, 24, 16, 8, 16, 24, 8, 16, 20, 4)
SERVE_NAMES = ("cubic", "sphere", "rastrigin", "ackley", "griewank",
               "rosenbrock")
SERVE_D, SERVE_SE = 10, 8
#: 8b: per-request solves at a size users serve (PERF.md section 1): 512
#: async requests over the six built-ins, d=10 n=1024, budgets round-robin,
#: in waves of 64, through one heterogeneous lane of 128 rows.
STREAM = dict(requests=512, wave=64, width=128, n=1024,
              budgets=(200, 400, 600, 800))
SERVE_METRICS = ("row_swaps", "tail_ejections", "standalone_solves",
                 "dispatches", "lane_slots", "lane_active_slots")


def serve_requests(budgets, n: int, d: int = SERVE_D, se: int = SERVE_SE,
                   fitness=None, variant: str = "async"):
    return [SolveRequest(dim=d, particle_cnt=n, seed=k, iters=t,
                         fitness=fitness or SERVE_NAMES[k % 6],
                         variant=variant, sync_every=se)
            for k, t in enumerate(budgets)]


def serving_main(what: str, fn):
    """A serving drive with every launch count set to 0 just before it and
    read just after: (its result, host seconds, the counts that moved)."""
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return out, dt, {k: v for k, v in read_counts().items() if v}


def standalone_kernel(r, **kw):
    """The request's standalone solve on the kernel backend, a launch a
    chunk (``record_history=True``): what a lane row equals."""
    return repro_torch.solve(r.fitness, dim=r.dim, particles=r.particle_cnt,
                             iters=r.iters, seed=r.seed, variant=r.variant,
                             sync_every=r.sync_every, backend="kernel",
                             record_history=True, **kw)


def same_result(res, want) -> bool:
    return res.ok and res.gbest_fit == want.gbest_fit and np.array_equal(
        res.gbest_pos, want.best_pos if hasattr(want, "best_pos")
        else want.gbest_pos.cpu().numpy())


def metric_counts(m) -> dict:
    return {k: int(m.get(k)) for k in SERVE_METRICS} | {
        "batch_fill": round(m.batch_fill, 4)}


def serving_exact(card: str, launches: dict) -> None:
    """8a: the reference trace on the card. One block (n=128): every result
    bit for bit its standalone kernel solve, in one heterogeneous lane
    (row 7) and with coalescing off in a homogeneous lane a built-in (row
    6); two blocks (n=1024, a race): the async invariants on every lane
    row."""
    for n, coalesce in ((128, True), (128, False), (1024, True)):
        reqs = serve_requests(SERVE_BUDGETS, n)
        sched = serving.ContinuousScheduler(lane_width=8, backend="kernel",
                                            record_history=True,
                                            coalesce_registry=coalesce)
        caps = ops.AsyncLane.captures
        res, dt, counts = serving_main("8a", functools.partial(
            sched.run, reqs))
        for k, v in counts.items():
            launches[k] += v
        lane_row = ("hetero_fused_async_batch" if coalesce
                    else "fused_async_batch")
        check(set(counts) == {lane_row, "fused_async"},
              f"8a n={n}: the async batch kernel (lanes) and the "
              f"single-swarm async kernel (ejection, standalone): {counts}")
        check(ops.AsyncLane.captures - caps == len(sched._lanes),
              f"8a n={n}: one capture a lane key")
        m = metric_counts(sched.metrics)
        check(m["tail_ejections"] == 1 and m["standalone_solves"] == 1
              and (m["row_swaps"] >= 1 or not coalesce),
              f"8a n={n}: trace shape {m}")
        nb = n // ops._resolve_block(n, None)
        if nb == 1:
            for r, x in zip(reqs, res):
                check(same_result(x, standalone_kernel(r)),
                      f"8a n={n} {r.fitness} x{r.iters}: == its standalone "
                      f"kernel solve bit for bit")
            how = "every result == its standalone kernel solve bit for bit"
        else:
            for r, x in zip(reqs, res):
                cfg = r.config().resolved()
                pos = torch.as_tensor(x.gbest_pos, device="cuda")
                check(bool(((pos >= cfg.min_pos) & (pos <= cfg.max_pos))
                           .all()), f"8a n={n} {r.fitness}: gbest in box")
                got = kernel_fitness(ops.kernel_spec(cfg), pos[:, None],
                                     cluster_of(n, SERVE_D))
                check(float(got[0]) == x.gbest_fit, f"8a n={n} {r.fitness}: "
                      f"gbest_pos evaluates to gbest_fit bit for bit")
                if r.iters < SERVE_SE:
                    continue
                h = x.history
                check(bool(np.all(np.diff(h.gbest_fit) >= 0))
                      and float(h.gbest_fit[-1]) == x.gbest_fit
                      and int(h.iteration[-1]) == r.iters,
                      f"8a n={n} {r.fitness} x{r.iters}: history monotone, "
                      f"its last sample the result")
            how = ("every row in its box, gbest_pos evaluated to gbest_fit "
                   "by the fused kernel bit for bit, histories monotone "
                   "ending at the result")
        print(f"  8a: reference trace d={SERVE_D} n={n} ({nb} block(s)) "
              f"se={SERVE_SE} lane width 8, coalesce {coalesce} "
              f"({len(sched._lanes)} lane(s), as many captures): {how}; {m}; "
              f"launches {counts}; {dt:.3f} s [{card}]")


def stream_requests():
    b = STREAM["budgets"]
    return serve_requests([b[k % len(b)] for k in range(STREAM["requests"])],
                          STREAM["n"])


def stream_pass(reqs, leg: str):
    """One pass of 8b's trace, wave by wave: (results in request order,
    seconds, metrics, the front end)."""
    wave = STREAM["wave"]
    metrics = serving.ServingMetrics()
    if leg == "continuous":
        fe = serving.ContinuousScheduler(lane_width=STREAM["width"],
                                         backend="kernel", metrics=metrics)
    else:
        fe = SolveServer(max_batch=STREAM["width"], backend="kernel",
                         metrics=metrics)
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tickets = []
    for w in range(0, len(reqs), wave):
        tickets += [fe.submit(r) for r in reqs[w:w + wave]]
        out.update(fe.step() if leg == "continuous" else fe.flush())
    if leg == "continuous":
        out.update(fe.drain())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return [out[t] for t in tickets], dt, metrics, fe


def chunk_times(step, reps: int = 50):
    """(host us a call, device us a call) of ``step``: the host clock
    around ``reps`` calls before the device finishes them, CUDA events
    around the same calls."""
    step()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    host = (time.perf_counter() - t0) / reps * 1e6
    end.record()
    torch.cuda.synchronize()
    return host, start.elapsed_time(end) / reps * 1e3


def admission_us(reqs) -> float:
    """Host us a request of admitting 128 requests into a built lane (the
    one-row descriptors, ``init_swarm_async``, the writes into the lane's
    columns), until the card has finished them."""
    sched = serving.ContinuousScheduler(lane_width=STREAM["width"],
                                        backend="kernel")
    sched._lane_program(sched._lane_for(reqs[0]))
    for r in reqs[:STREAM["width"]]:
        sched.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched._admit()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / STREAM["width"] * 1e6


def device_span_us(fn, reps: int = 10) -> float:
    """Device wall us a call of ``fn`` over ``reps`` calls back to back
    under torch.profiler: the first kernel's start to the last kernel's
    end, gaps included (0 if the profiler records nothing)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ranges = [e.time_range for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    if not ranges:
        return 0.0
    return (max(r.end for r in ranges) - min(r.start for r in ranges)) / reps


def kernels_fit(kern: float, host: float, dev: float) -> bool:
    """Whether a profiler reading of the kernels' device us a call can be
    theirs, held to the CUDA events' device us a call, back to back: no
    more than it (10% for the two clocks) and, where the host enqueues a
    call in under 90% of the card's time for it (so the calls run back to
    back and the card is the pace), most of it (80%). Elsewhere the gaps
    between calls are the host's, and only the ceiling holds."""
    return kern <= 1.1 * dev and (host >= 0.9 * dev or kern >= 0.8 * dev)


def lane_chunk(lane, card: str) -> None:
    """8b's lane (its rows as the stream left them) a chunk at a time three
    ways: the CUDA graph's replay; the same launch uncaptured
    (``pso_step.async_lane_launch``, every check and buffer hoisted); and
    ``ops.run_queue_lock`` on a ``SwarmBatch`` of the same rows (pack,
    checks, launch, unpack), each call from that batch. Host us a call,
    device us a call in CUDA events (back to back, and the median of 9
    calls alone, each after a sync), the device's span and
    the kernels alone under torch.profiler, the last taken again (three
    tries) until it fits the others (``kernels_fit``)."""
    batch = ms.stack_states([lane.row(s) for s in range(lane.width)])
    fids = lane.fids.clone()

    def uncaptured():
        ops.run_queue_lock(lane.cfg, batch, lane.sync_every, "async",
                           sync_every=lane.sync_every, fids=fids,
                           table=BUILTIN_PROBLEMS)
    out = []
    for what, fn in (("graph replay", lane.dispatch),
                     ("hoisted launch, uncaptured", lane._launch),
                     ("ops.run_queue_lock on a SwarmBatch", uncaptured)):
        host, dev = chunk_times(fn)
        iso = sorted(device_us(lambda _: fn(), [], copy=False)
                     for _ in range(9))[4]
        span = device_span_us(fn)
        kern, seen = None, []
        for _ in range(3):
            us = kernel_device_us(fn)
            seen.append(sum(us.values()))
            if kernels_fit(seen[-1], host, dev):
                kern = us
                break
        out.append(f"{what} {host:.1f} host us, {dev:.1f} device us "
                   f"(events; {iso:.1f} a call alone), span {span:.1f}, " + (
                       f"kernels {sum(kern.values()):.1f} (async "
                       f"{sum(v for k, v in kern.items() if 'async' in k):.1f}"
                       f", {len(kern)} kernels)" if kern else
                       f"kernels not measured (torch.profiler read "
                       f"{', '.join(f'{x:.1f}' for x in seen)}, against "
                       f"the events)"))
    print(f"  8b a chunk of the lane ({lane.width} rows d={lane.cfg.dim} "
          f"n={lane.cfg.particle_cnt}, {lane.sync_every} iterations, a call "
          f"each): {'; '.join(out)} [{card}]")


def serving_stream(card: str, launches: dict) -> None:
    """8b: 512 async requests in waves of 64 through the continuous
    scheduler (one heterogeneous lane of 128 x 1024 x 10, row 7) and the
    flush server (a flush a wave), two passes each (the first warms up)."""
    reqs = stream_requests()
    n, d, se = STREAM["n"], SERVE_D, SERVE_SE
    for leg in ("continuous", "flush"):
        caps = ops.AsyncLane.captures
        for p in range(2):
            (res, dt, metrics, fe), _, counts = serving_main(
                "8b", functools.partial(stream_pass, reqs, leg))
        for k, v in counts.items():
            launches[k] += v
        check(all(x.ok and math.isfinite(x.gbest_fit) for x in res),
              f"8b {leg}: every request answered, finite")
        e2e = metrics.span("e2e_us")
        m = metric_counts(metrics)
        line = (f"  8b {leg}: {len(reqs)} requests d={d} n={n} se={se} in "
                f"{dt:.3f} s, {len(reqs) / dt:.1f} requests/s, e2e p50 "
                f"{e2e.p50_us / 1e3:.2f} ms p99 {e2e.p99_us / 1e3:.2f} ms; "
                f"{m}; launches {counts}")
        if leg == "continuous":
            check(ops.AsyncLane.captures - caps == 2 and len(fe._lanes) == 1,
                  "8b: one capture a lane key a pass (one lane)")
            line += (f"; {ops.AsyncLane.captures - caps} graph captures in "
                     f"2 passes, 1 lane key; dispatch_us "
                     f"{metrics.span('dispatch_us').total_us / 1e3:.1f} ms of "
                     f"the pass, admission {admission_us(reqs):.0f} us a "
                     f"request")
            stream_res = res
        print(line + f" [{card}]")
        if leg == "continuous":
            lane_chunk(next(iter(fe._lanes.values())).program, card)
    # quality: mean gbest per objective beside solve_many of the requests
    many = {}
    for t in STREAM["budgets"]:
        sub = [r for r in reqs if r.iters == t]
        rows = repro_torch.solve_many(
            problems=[r.fitness for r in sub], seeds=[r.seed for r in sub],
            dim=d, particles=n, iters=t, variant="async", sync_every=se)
        many.update(zip((r.seed for r in sub), rows))
    line = []
    for name in SERVE_NAMES:
        lane = [x.gbest_fit for x in stream_res if x.request.fitness == name]
        ref = [many[x.request.seed].gbest_fit for x in stream_res
               if x.request.fitness == name]
        line.append(f"{name} {np.mean(lane):.6g} / {np.mean(ref):.6g}")
    print(f"  8b mean gbest (canonical) per objective, lane / solve_many: "
          f"{'; '.join(line)} [{card}]")


def custom_quad():
    """A custom torch objective (a shifted sphere, max sense)."""
    return repro_torch.Problem(
        name="serving_quad", fn=lambda x: -((x - 1.0) ** 2).sum(-1),
        lo=-5.0, hi=5.0)


def serving_routes(card: str, launches: dict) -> None:
    """8c: a queue_lock flush on the kernel backend (rows 4, then 3 with
    coalescing off), a custom Problem's content lane (the split path), a
    queue request (standalone, eager), and a CompileCache cold then warm."""
    reqs = serve_requests((50,) * 6, 1024, variant="queue_lock")
    for coalesce, key in ((True, "hetero_fused_batch"),
                          (False, "fused_batch")):
        srv = SolveServer(backend="kernel", coalesce_registry=coalesce)
        res, dt, counts = serving_main("8c", functools.partial(
            srv.solve_all, reqs))
        launches[key] += counts.get(key, 0)
        check(key in counts, f"8c queue_lock flush: {key} launched")
        for r, x in zip(reqs, res):
            want = repro_torch.solve(r.fitness, dim=r.dim, particles=1024,
                                     iters=r.iters, seed=r.seed,
                                     variant="queue_lock", backend="kernel")
            check(same_result(x, want), f"8c queue_lock {r.fitness}: the "
                  f"batch row == the single-swarm fused kernel bit for bit")
        print(f"  8c: queue_lock flush of 6 built-ins d=10 n=1024 x50, "
              f"coalesce {coalesce}: {srv.stats.as_dict()}, every row == "
              f"its single-swarm fused kernel bit for bit; launches "
              f"{counts}; {dt:.3f} s [{card}]")
    quad = custom_quad()
    reqs = serve_requests((16, 24, 20), 1024, d=8, fitness=quad)
    sched = serving.ContinuousScheduler(backend="kernel")
    res, dt, counts = serving_main("8c", functools.partial(sched.run, reqs))
    for k, v in counts.items():
        launches[k] += v
    check(set(SPLIT) <= set(counts), f"8c content lane: the split kernels "
          f"({counts})")
    for r, x in zip(reqs, res):
        check(same_result(x, standalone_kernel(r)), f"8c content lane "
              f"x{r.iters}: == its standalone split-path solve bit for bit")
    print(f"  8c: custom Problem d=8 n=1024 se=8 x16/24/20 in a content lane "
          f"(split path): every result == its standalone kernel solve bit "
          f"for bit; {metric_counts(sched.metrics)}; launches {counts}; "
          f"{dt:.3f} s [{card}]")
    r = serve_requests((40,), 1024, variant="queue")[0]
    sched = serving.ContinuousScheduler(backend="kernel")
    x = sched.run([r])[0]
    want = pso.solve(r.config(), r.seed, r.iters, "queue", device="cuda")
    check(same_result(x, want) and sched.metrics.get("standalone_solves")
          == 1, "8c queue request: standalone, == the eager pso.solve bit "
          "for bit")
    print(f"  8c: a queue request on the kernel backend: standalone on the "
          f"eager engine, == pso.solve bit for bit [{card}]")
    path = Path(__file__).resolve().parent / "build" / "serving_cache"
    shutil.rmtree(path, ignore_errors=True)
    reqs = serve_requests((16,) * 4, 128)
    cold = serving.CompileCache(str(path))
    a = serving.ContinuousScheduler(compile_cache=cold,
                                    backend="kernel").run(reqs)
    check(cold.aot_misses == 1 and cold.trace_events == 1,
          f"8c cold cache: one miss, one build ({cold.snapshot()})")
    warm = serving.CompileCache(str(path))
    caps = ops.AsyncLane.captures
    t0 = time.perf_counter()
    check(warm.prewarm() == 1, "8c warm cache: prewarm builds 1 program")
    t_pre = time.perf_counter() - t0
    b = serving.ContinuousScheduler(compile_cache=warm,
                                    backend="kernel").run(reqs)
    check(warm.aot_hits == 1 and warm.aot_misses == 0
          and warm.trace_events == 0, f"8c warm cache: no build on the "
          f"request path ({warm.snapshot()})")
    check(all(same_result(y, standalone_kernel(r)) and x.gbest_fit
              == y.gbest_fit and np.array_equal(x.gbest_pos, y.gbest_pos)
              for r, x, y in zip(reqs, a, b)),
          "8c warm results == cold results bit for bit")
    print(f"  8c: CompileCache cold {cold.snapshot()}; warm (prewarm "
          f"{t_pre * 1e3:.1f} ms, {ops.AsyncLane.captures - caps} capture) "
          f"{warm.snapshot()}; warm == cold bit for bit [{card}]")


def phase_serving(card: str) -> dict:
    """Phase 8; returns the launches of its serving drives."""
    print(f"phase 8: serving on the card, SolveServer, ContinuousScheduler "
          f"and CompileCache [{card}]")
    t0 = time.perf_counter()
    check(serving is not None, "phase 8: repro_torch.serving and "
          "repro_torch.launch.serve import")
    launches = dict.fromkeys(COUNTERS, 0)
    serving_exact(card, launches)
    serving_stream(card, launches)
    serving_routes(card, launches)
    print(f"  phase 8: {time.perf_counter() - t0:.1f} s; launches of its "
          f"serving drives {dict((k, v) for k, v in launches.items() if v)}")
    return launches


# ---------------------------------------------------------------------------
# Phase 9: the launcher, checkpoints and islands on the card.
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parent
#: The launcher's own width (its docstring's cell): cubic d=120 n=32768 x200.
LAUNCH_D, LAUNCH_N, LAUNCH_ITERS, LAUNCH_CHUNK = 120, 32768, 200, 50
ISLANDS, ISLAND_EXCHANGE = 4, 10
RING_D, RING_N = 10, 4096


def pso_run_cli(args, what: str, card: str) -> dict:
    """``python -m repro_torch.launch.pso_run`` in a subprocess (it loads
    the kernels built by phase 2: ``_build`` keys them by source hash);
    returns its gbest_fit, us/iter and kernel launches as it prints them."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.pso_run", *map(str, args)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    check(out.returncode == 0, f"9a {what}: pso_run exits 0 "
          f"({out.stderr[-2000:]})")
    got = re.search(r"gbest_fit=(\S+) .*\(([\d.]+) us/iter\)", out.stdout)
    cnt = re.search(r"kernel launches: fused=(\d+)\s+fused_async=(\d+)",
                    out.stdout)
    check(got is not None and cnt is not None,
          f"9a {what}: pso_run prints its result and launches")
    res = dict(gbest_fit=float(got.group(1)), us=float(got.group(2)),
               fused=int(cnt.group(1)), fused_async=int(cnt.group(2)))
    print(f"  9a {what}: gbest_fit={res['gbest_fit']:.7g} "
          f"{res['us']:.1f} us/iter (the CLI's wall clock: process, init, "
          f"kernel loads, checkpoints), launches fused={res['fused']} "
          f"fused_async={res['fused_async']}, "
          f"{time.perf_counter() - t0:.1f} s with the process [{card}]")
    return res


def equal_states(a, b) -> bool:
    """Two SwarmStates bit for bit (tensors and counters)."""
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(a, b))


def in_box(cfg, s) -> bool:
    return bool(((s.pos >= cfg.min_pos) & (s.pos <= cfg.max_pos)).all())


def launcher_runs(card: str, launches: dict, tmp: Path):
    """9a; returns the queue_lock run's config and final state."""
    from repro_torch import checkpoint as ckpt
    cfg = pso.PSOConfig(dim=LAUNCH_D, particle_cnt=LAUNCH_N).resolved()
    base = ["--dim", LAUNCH_D, "--particles", LAUNCH_N, "--iters",
            LAUNCH_ITERS, "--kernel", "--seed", 0, "--ckpt-every",
            LAUNCH_CHUNK]
    steps = list(range(LAUNCH_CHUNK, LAUNCH_ITERS + 1, LAUNCH_CHUNK))
    ql = pso_run_cli(base + ["--variant", "queue_lock", "--ckpt-dir",
                             tmp / "queue_lock"], "queue_lock", card)
    an = pso_run_cli(base + ["--variant", "async", "--sync-every", 8,
                             "--ckpt-dir", tmp / "async"], "async", card)
    check(ql["fused"] == len(steps) and ql["fused_async"] == 0,
          f"9a queue_lock: a fused launch a chunk ({ql})")
    check(an["fused_async"] > 0 and an["fused"] == 0,
          f"9a async: the async kernel launched ({an})")
    for k in ("fused", "fused_async"):
        launches[k] += ql[k] + an[k]
    s0 = pso.init_swarm(cfg, 0, device="cuda")
    tmpl = ckpt.stand_ins(s0)
    check(ckpt.latest_step(str(tmp / "queue_lock")) == LAUNCH_ITERS,
          "9a: the newest checkpoint is the last chunk's")
    final = ckpt.restore(str(tmp / "queue_lock"), LAUNCH_ITERS, tmpl)
    one = ops.run_queue_lock_fused(cfg, s0, LAUNCH_ITERS)
    check(equal_states(final, one), "9a: the CLI's chunks (4 launches) == "
          "one fused launch of 200 iterations, bit for bit")
    mid = ckpt.restore(str(tmp / "queue_lock"), LAUNCH_ITERS // 2, tmpl)
    cont = ops.run_queue_lock_fused(cfg, mid, LAUNCH_ITERS - mid.iteration)
    check(equal_states(cont, one), f"9a: restored step {mid.iteration} + "
          f"one launch to {LAUNCH_ITERS} == the uninterrupted fused run, bit "
          f"for bit")
    # the CLI prints 6 significant digits
    check(math.isclose(float(one.gbest_fit), ql["gbest_fit"], rel_tol=1e-5),
          "9a: the printed gbest is the run's")
    # the async run: a race across blocks, held to the invariants chunk by
    # chunk (its checkpoints carry the block locals)
    nb = LAUNCH_N // ops._resolve_block(LAUNCH_N, None)
    tmpl_async = ckpt.stand_ins(s0._replace(
        lbest_pos=s0.pos[:nb], lbest_fit=s0.fit[:nb]))
    prev = -math.inf
    for st in steps:
        a = ckpt.restore(str(tmp / "async"), st, tmpl_async)
        g = float(a.gbest_fit)
        check(a.iteration == st, f"9a async step {st}: its iteration")
        check(g >= prev, f"9a async: gbest monotone across chunks ({prev} "
              f"-> {g} at {st})")
        check(g == float(a.pbest_fit.max()), f"9a async step {st}: gbest "
              f"== max pbest")
        check(in_box(cfg, a), f"9a async step {st}: positions in the box")
        check(gbest_is_a_pbest(a.pbest_pos.T, a.pbest_fit, a.gbest_pos,
                               a.gbest_fit), f"9a async step {st}: "
              f"gbest_pos is a pbest")
        prev = g
    check(math.isclose(prev, an["gbest_fit"], rel_tol=1e-5),
          "9a async: the printed gbest is the last checkpoint's")
    print(f"  9a: the CLI's queue_lock chunks and a restored step "
          f"{mid.iteration} continued equal one fused launch bit for bit; "
          f"async gbest "
          f"monotone over {len(steps)} checkpoints, == max pbest, in the "
          f"box [{card}]")
    return cfg, final


def plain_local_step(cfg, s):
    """The fused kernel's plain version as an island's local step (one
    iteration), on the card's tensors."""
    n = s.pos.shape[0]
    out = pso_step.fused_plain(*ops.state_to_kernel(s), ops.kernel_spec(cfg),
                               seed=s.seed, iteration=s.iteration, iters=1,
                               block_n=ops._resolve_block(n, None))
    return ops.kernel_to_state(s, *out, 1)


def island_runs(card: str, launches: dict, errs: dict) -> None:
    """9b: islands on row 2 through the facade, and the eager ring."""
    from repro_torch.core import distributed as dist
    from repro_torch.core.blocking import default_block_count
    cfg = pso.PSOConfig(dim=LAUNCH_D, particle_cnt=LAUNCH_N).resolved()
    s0 = pso.init_swarm(cfg, 0, device="cuda")
    one = ops.run_queue_lock_fused(cfg, s0, LAUNCH_ITERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ops.run_queue_lock_fused(cfg, s0, LAUNCH_ITERS)
    torch.cuda.synchronize()
    us_one = (time.perf_counter() - t0) / LAUNCH_ITERS * 1e6
    local_n = LAUNCH_N // ISLANDS
    print(f"  9b: islands at cubic d={LAUNCH_D} n={LAUNCH_N}: {ISLANDS} of "
          f"{local_n} on clusters of {cluster_of(local_n, LAUNCH_D)}, one "
          f"swarm on clusters of {cluster_of(LAUNCH_N, LAUNCH_D)}")
    # 10 iterations of 4 islands: the fused kernel against its plain version
    st = dist.init_sharded_swarm(cfg, 0, ISLANDS, device="cuda")
    got = dist.make_distributed_run(
        cfg, ISLANDS, ISLAND_EXCHANGE, "queue_lock", ISLAND_EXCHANGE,
        local_step_fn=ops.make_fused_local_step())(st)
    want = dist.make_distributed_run(
        cfg, ISLANDS, ISLAND_EXCHANGE, "queue_lock", ISLAND_EXCHANGE,
        local_step_fn=plain_local_step)(st)
    err = compare(ops.state_to_kernel(got), ops.state_to_kernel(want),
                  FUSED_FIELDS, f"9b {ISLANDS} islands x{ISLAND_EXCHANGE}")
    errs["fused"] = max(errs["fused"], err)
    print(f"  9b: {ISLANDS} islands x{ISLAND_EXCHANGE} on the fused kernel "
          f"== its plain version as the local step, max error {err:.3g} "
          f"[{card}]")
    timings = {}
    for k in (1, ISLANDS):
        m = repro_torch.Method(variant="queue_lock", islands=k,
                               exchange_interval=ISLAND_EXCHANGE)
        kw = dict(dim=LAUNCH_D, particles=LAUNCH_N, seed=0, method=m)
        repro_torch.solve("cubic", iters=2, **kw)             # warm-up
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = repro_torch.solve("cubic", iters=LAUNCH_ITERS, **kw)
        torch.cuda.synchronize()
        timings[k] = (time.perf_counter() - t0) / LAUNCH_ITERS * 1e6
        counts = {c: v for c, v in read_counts().items() if v}
        check(counts == {"fused": k * LAUNCH_ITERS}, f"9b {k} island(s): "
              f"a fused launch an iteration an island ({counts})")
        launches["fused"] += counts.get("fused", 0)
        s = res.state
        check(s.iteration == LAUNCH_ITERS, f"9b {k} island(s): iterations")
        check(float(s.gbest_fit) == float(s.pbest_fit.max()),
              f"9b {k} island(s): gbest == max pbest after the exchange")
        check(in_box(cfg, s), f"9b {k} island(s): positions in the box")
        check(gbest_is_a_pbest(s.pbest_pos.T, s.pbest_fit, s.gbest_pos,
                               s.gbest_fit), f"9b {k} island(s): gbest_pos "
              f"is a pbest")
        if k == 1:
            check(equal_states(s, one), "9b: one island (200 one-iteration "
                  "launches) == one fused launch of 200, bit for bit")
        print(f"  9b: solve(Method(queue_lock, islands={k}, exchange "
              f"{ISLAND_EXCHANGE})) gbest {res.best_fit:.7g} "
              f"{timings[k]:.2f} us/iter, launches {counts} [{card}]")
    per_island = bound(LAUNCH_D, local_n, 1)[0] * ISLANDS
    print(f"  9b: us/iter one fused launch {us_one:.2f}, 1 island "
          f"{timings[1]:.2f}, {ISLANDS} islands {timings[ISLANDS]:.2f} "
          f"(a launch, a D-major pack and unpack an island an iteration; "
          f"bound {per_island * 1e3:.2f} us/iter for {ISLANDS} islands' "
          f"launches, {bound(LAUNCH_D, LAUNCH_N, LAUNCH_ITERS)[0] * 1e3 / LAUNCH_ITERS:.2f}"
          f" for the one launch) [{card}]")
    # the async island ring: the eager engine on the card
    rcfg = pso.PSOConfig(dim=RING_D, particle_cnt=RING_N).resolved()
    ring = {}
    for k in (1, ISLANDS):
        m = repro_torch.Method(variant="async", islands=k,
                               exchange_interval=8, sync_every=8)
        kw = dict(dim=RING_D, particles=RING_N, seed=1, method=m)
        repro_torch.solve("cubic", iters=8, **kw)             # warm-up
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = repro_torch.solve("cubic", iters=LAUNCH_ITERS, **kw)
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) / LAUNCH_ITERS * 1e6
        check(not any(read_counts().values()), "9b ring: eager, no kernel")
        s = res.state
        check(float(s.gbest_fit) == float(s.pbest_fit.max()),
              f"9b ring {k}: gbest == max pbest after the drain")
        check(in_box(rcfg, s), f"9b ring {k}: positions in the box")
        check(tuple(s.lbest_fit.shape) == (k * default_block_count(
            RING_N // k),), f"9b ring {k}: the islands' block locals")
        ring[k] = res
        print(f"  9b: async ring, {k} island(s) of {RING_N // k} at cubic "
              f"d={RING_D}, exchange 8, sync_every 8: gbest "
              f"{res.best_fit:.7g} {us:.1f} us/iter (eager) [{card}]")
    eager = pso.run_async(rcfg, pso.init_swarm(rcfg, 1, device="cuda"),
                          LAUNCH_ITERS, sync_every=8)
    check(equal_states(ring[1].state, eager), "9b ring: one island == "
          "run_async on the card, bit for bit")


def checkpoint_times(card: str, state, tmp: Path) -> None:
    """9c: save and restore of the launcher's final state."""
    from repro_torch import checkpoint as ckpt
    tmpl = ckpt.stand_ins(state)
    path = tmp / "times"
    ckpt.save(str(path), 0, state)                  # warm-up
    ckpt.restore(str(path), 0, tmpl)
    saves, restores = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(str(path), 1, state)
        saves.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = ckpt.restore(str(path), 1, tmpl)
        torch.cuda.synchronize()
        restores.append(time.perf_counter() - t0)
    check(equal_states(back, state), "9c: restore == the saved state")
    nbytes = sum(f.stat().st_size for f in (path / "step_00000001").iterdir())
    tensor_bytes = sum(x.numel() * x.element_size() for x in state
                       if isinstance(x, torch.Tensor))
    print(f"  9c: checkpoint of the 9a state ({tensor_bytes / 1e6:.1f} MB of "
          f"tensors, {nbytes / 1e6:.1f} MB written): save "
          f"{min(saves) * 1e3:.1f}-{max(saves) * 1e3:.1f} ms, restore "
          f"{min(restores) * 1e3:.1f}-{max(restores) * 1e3:.1f} ms, "
          f"3 rounds [{card}]")


def phase_launcher(card: str, errs: dict) -> dict:
    """Phase 9; returns the launches of its main-path drives (the CLI's
    from its printout)."""
    print(f"phase 9: the launcher, checkpoints and islands on the card "
          f"[{card}]")
    t0 = time.perf_counter()
    launches = dict.fromkeys(COUNTERS, 0)
    tmp = ROOT / "build" / "chip_smoke_phase9"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        _, state = launcher_runs(card, launches, tmp)
        island_runs(card, launches, errs)
        checkpoint_times(card, state, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  phase 9: {time.perf_counter() - t0:.1f} s; launches "
          f"{dict((k, v) for k, v in launches.items() if v)}")
    return launches


#: Phase 10: the autotuner's cells, (problem, d, n, iters, S): phase 4's two
#: solve cells (the paper's largest swarms) and phase 4b's first batch.
TUNE_CELLS = (("cubic", 1, 131072, 1000, 1), ("cubic", 120, 32768, 200, 1),
              ("rastrigin", 10, 1024, 200, 128))
#: 10c: the records ``pso_cost.fit_calibration`` reads, in the reference's
#: names: Table 3's eager cubic d=1 at these n (``table3/p{n}/{variant}``),
#: and the async sweep of the kernels at rastrigin d=1 on blocks of 512
#: (``async_sweep/d1_n{n}_b512/{sync_kernel,sync_every_k}``), 256, 64 and
#: 16 blocks, each call CALIB_ITERS iterations.
CALIB_EAGER_N = (1024, 65536, 1048576, 8388608)
CALIB_SWEEP_N = (131072, 32768, 8192)
CALIB_SYNC = (1, 4, 16, 64)
CALIB_ITERS = 400


def tune_label(prob: str, d: int, n: int, iters: int, s_cnt: int) -> str:
    return f"{prob} d={d} n={n} x{iters}" + (f" S={s_cnt}" if s_cnt > 1
                                            else "")


def schedule_text(s, n: int, d: int) -> str:
    """A schedule as phase 10 prints it: variant and backend, the block
    size and, on the kernels, the cluster size C; sync_every for async."""
    if s.backend == "kernel":
        bn = s.block_n or ops._resolve_block(n, None)
        where = (f"kernel block_n={bn} C="
                 f"{pso_step._cluster(n, d, bn, torch.device('cuda'))}")
    else:
        where = f"eager block_n={s.block_n}"
    se = f" sync_every={s.sync_every}" if s.variant == "async" else ""
    return f"{s.variant} {where}{se}"


def sched_key(s):
    return (s.variant, s.backend, s.block_n,
            s.sync_every if s.variant == "async" else None)


def tune_cells(card: str, launches: dict, cache) -> dict:
    """10a: ``resolve_schedule(measure=True)`` on a fresh cache at each
    cell, every measured candidate printed beside its prediction; the pick
    no slower than the fixed anchor in the same measurement; a second
    resolve a cache hit with no launch. Returns per cell (the pick, the
    measured candidates, the resolve's seconds)."""
    out = {}
    real = autotune.measure_schedule
    anchor = autotune.fixed_schedule(device="cuda")
    for cell in TUNE_CELLS:
        prob, d, n, iters, s_cnt = cell
        label = tune_label(*cell)
        measured = []

        def recording(sched, *a, **k):
            us = real(sched, *a, **k)
            measured.append(sched.replace(measured_us=us))
            return us

        kw = dict(batch=s_cnt, cache=cache, device="cuda")
        autotune.measure_schedule = recording
        try:
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pick = autotune.resolve_schedule(prob, d, n, iters, **kw)
            dt = time.perf_counter() - t0
        finally:
            autotune.measure_schedule = real
        counts = read_counts()
        for k, v in counts.items():
            launches[k] += v
        check(pick.source == "measured" and len(measured) >= 2,
              f"10a {label}: a measured pick ({pick})")
        anch = [m for m in measured if sched_key(m) == sched_key(anchor)]
        check(len(anch) == 1, f"10a {label}: the fixed anchor measured once")
        check(pick.measured_us <= anch[0].measured_us,
              f"10a {label}: pick {pick.measured_us:.2f} us/iter <= the "
              f"anchor's {anch[0].measured_us:.2f}")
        check(any(m.backend == "kernel" for m in measured),
              f"10a {label}: kernel candidates measured")
        measured = [m.replace(predicted_us=autotune.rank_schedules(
            [m], prob, d, n, iters, batch=s_cnt,
            device="cuda")[0].predicted_us) for m in measured]
        for m in measured:
            print(f"  10a {label}: {schedule_text(m, n, d):52s} predicted "
                  f"{m.predicted_us:10.3f} measured {m.measured_us:10.3f} "
                  f"us/iter" + (" (the fixed anchor)" if sched_key(m)
                                == sched_key(anchor) else "")
                  + (" <- the pick" if sched_key(m) == sched_key(pick)
                     else ""))
        zero_counts()
        t0 = time.perf_counter()
        hit = autotune.resolve_schedule(prob, d, n, iters, **kw)
        dt_hit = time.perf_counter() - t0
        again = {k: v for k, v in read_counts().items() if v}
        check(hit.source == "cache" and sched_key(hit) == sched_key(pick)
              and not again, f"10a {label}: the second resolve is a cache "
              f"hit with no launch ({hit.source}, {again})")
        print(f"  10a {label}: pick {schedule_text(pick, n, d)} "
              f"{pick.measured_us:.3f} us/iter against the anchor "
              f"{schedule_text(anchor, n, d)} {anch[0].measured_us:.3f} "
              f"({anch[0].measured_us / pick.measured_us:.1f}x); resolve "
              f"{dt:.3f} s, {len(measured)} candidates measured, launches "
              f"{dict((k, v) for k, v in counts.items() if v)}; second "
              f"resolve {dt_hit * 1e6:.0f} us, a cache hit, no launch "
              f"[{card}]")
        out[cell] = (pick, measured, dt)
    return out


def deterministic(m, n: int) -> bool:
    """Whether a fixed Method's run is one trajectory: the eager engine, the
    fused kernel (synchronous PPSO) or the async kernel with one block."""
    return (m.backend == "eager" or m.variant == "queue_lock"
            or n // (m.block_n or ops._resolve_block(n, None)) == 1)


def state_invariants(cfg, s, what: str) -> None:
    """Phase 3's invariants of a multi-block async run (a race)."""
    check(float(s.gbest_fit) == float(s.pbest_fit.max()),
          f"{what}: gbest == max pbest")
    check(in_box(cfg, s), f"{what}: positions in the box")
    check(gbest_is_a_pbest(s.pbest_pos.T, s.pbest_fit, s.gbest_pos,
                           s.gbest_fit), f"{what}: gbest_pos is a pbest")


def timed(fn, iters: int):
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / iters * 1e6, {
        k: v for k, v in read_counts().items() if v}


def auto_against_fixed(card: str, launches: dict, tuned: dict) -> None:
    """10b: ``schedule="auto"`` (a cache hit of 10a's resolve) against the
    fixed Method it resolved to from the same seed: bit for bit where the
    run is one trajectory, else both held to the invariants; µs/iter of
    auto, of the resolved fixed Method and of the fixed default
    (``Method()``: the eager queue variant), beside the resolve's cost."""
    for cell, (pick, _, resolve_s) in tuned.items():
        prob, d, n, iters, s_cnt = cell
        label = tune_label(*cell)
        if s_cnt == 1:
            def run(iters=iters, **kw):
                return [repro_torch.solve(prob, dim=d, particles=n,
                                          iters=iters, seed=0, **kw)]
        else:
            def run(iters=iters, **kw):
                return repro_torch.solve_many(prob, range(s_cnt), dim=d,
                                              particles=n, iters=iters, **kw)
        # warm-ups (first launches at this shape: occupancy queries, tables)
        # of the pick as a fixed Method and of the default, two iterations
        run(iters=2, method=repro_torch.Method(
            variant=pick.variant, backend=pick.backend, block_n=pick.block_n,
            sync_every=pick.sync_every))
        run(iters=2)
        auto, us_auto, counts = timed(lambda: run(schedule="auto"), iters)
        for k, v in counts.items():
            launches[k] += v
        m = auto[0].method
        check(m.schedule == "fixed" and (m.variant, m.backend, m.block_n,
                                         m.sync_every) == (
            pick.variant, pick.backend, pick.block_n, pick.sync_every),
              f"10b {label}: auto ran the pick ({m})")
        fixed, us_fixed, counts = timed(lambda: run(method=m), iters)
        for k, v in counts.items():
            launches[k] += v
        default, us_default, _ = timed(lambda: run(), iters)
        cfg = auto[0].config
        if deterministic(m, n):
            check(all(equal_states(a.state, f.state)
                      for a, f in zip(auto, fixed)),
                  f"10b {label}: auto == the resolved fixed Method bit for "
                  f"bit")
            how = "bit for bit"
        else:
            for j, (a, f) in enumerate(zip(auto, fixed)):
                state_invariants(cfg, a.state, f"10b {label} auto row {j}")
                state_invariants(cfg, f.state, f"10b {label} fixed row {j}")
            how = "both held to the async invariants (a race)"
        best = max(r.best_fit for r in auto)
        print(f"  10b {label}: auto {us_auto:.2f} us/iter ({m.variant} "
              f"{m.backend} block_n={m.block_n} sync_every={m.sync_every}; "
              f"{how}), the resolved fixed Method {us_fixed:.2f}, the fixed "
              f"default (eager queue) {us_default:.2f} "
              f"({us_default / us_auto:.1f}x auto); the resolve "
              f"{resolve_s:.3f} s = {resolve_s * 1e6 / iters:.1f} us/iter "
              f"of this budget; best gbest {best:.7g} (default "
              f"{max(r.best_fit for r in default):.7g}) [{card}]")


def spearman(a, b) -> float:
    ra = np.argsort(np.argsort(a)).astype(float)
    rb = np.argsort(np.argsort(b)).astype(float)
    if ra.std() == 0 or rb.std() == 0:
        return float("nan")
    return float(np.corrcoef(ra, rb)[0, 1])


def best_of(fn, rounds: int = 3) -> float:
    """Host seconds of the fastest of ``rounds`` synchronized calls, after a
    warm call."""
    fn()
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def calibration_records():
    """10c's records: (eager table3 records, kernel async_sweep records),
    each ``{"name", "us_per_call"}`` in µs an iteration."""
    eager = []
    for n in CALIB_EAGER_N:
        cfg = pso.PSOConfig(dim=1, particle_cnt=n).resolved()
        s0 = pso.init_swarm(cfg, 0, device="cuda")
        for v in ("reduction", "queue", "queue_lock"):
            t = best_of(lambda: pso.run(cfg, s0, 10, v))
            eager.append({"name": f"table3/p{n}/{v}",
                          "us_per_call": t / 10 * 1e6})
        del s0
    sweep = []
    for n in CALIB_SWEEP_N:
        cfg = pso.PSOConfig(dim=1, particle_cnt=n,
                            fitness="rastrigin").resolved()
        s0 = pso.init_swarm(cfg, 0, device="cuda")
        fns = {"sync_kernel": lambda: ops.run_queue_lock_fused(
            cfg, s0, CALIB_ITERS, block_n=512)}
        for k in CALIB_SYNC:
            fns[f"sync_every_{k}"] = functools.partial(
                ops.run_queue_lock_fused_async, cfg, s0, CALIB_ITERS,
                sync_every=k, block_n=512)
        best = dict.fromkeys(fns, float("inf"))
        for fn in fns.values():
            fn()
        for _ in range(3):                   # interleaved, keep the min
            for name, fn in fns.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                best[name] = min(best[name], time.perf_counter() - t0)
        sweep += [{"name": f"async_sweep/d1_n{n}_b512/{name}",
                   "us_per_call": t / CALIB_ITERS * 1e6}
                  for name, t in best.items()]
    return eager, sweep


def sweep_cost(name: str):
    """The kernel ``IterCost`` of an async_sweep record, and its n."""
    shape, what = name.split("/")[1:]
    n = int(shape.split("_n")[1].split("_b")[0])
    bn = int(shape.split("_b")[1])
    if what == "sync_kernel":
        return pso_cost.iteration_cost("queue_lock", "rastrigin", 1, n,
                                       block_n=bn, backend="kernel"), n
    return pso_cost.iteration_cost(
        "async", "rastrigin", 1, n, block_n=bn,
        sync_every=int(what.rsplit("_", 1)[1]), backend="kernel"), n


def calibrate(card: str, tuned: dict) -> None:
    """10c: the card's calibration from its own records (the eager engine's
    Table 3 cells, the kernels' async sweep, the split path's dispatches),
    printed as the constants of ``pso_cost.CUDA_CALIBRATION`` and
    ``CUDA_EAGER_CALIBRATION``; 10a's candidates predicted against
    measured (Spearman's rank correlation, printed, not gated) under the
    shipped constants and the fitted ones; the committed CPU baseline
    refused on the card."""
    t0 = time.perf_counter()
    eager_recs, sweep_recs = calibration_records()
    meta = dict(pso_cost._host_fingerprint(), torch=torch.__version__)
    check(meta["device_kind"] == torch.cuda.get_device_name(0),
          "10c: the records name the card")
    eager = pso_cost.fit_calibration({"meta": meta, "benchmarks": eager_recs},
                                     base=pso_cost.CUDA_EAGER_CALIBRATION)
    kern = pso_cost.fit_calibration({"meta": meta, "benchmarks": sweep_recs},
                                    base=pso_cost.CUDA_CALIBRATION)
    check(kern.source == "bench-fit", f"10c: the async sweep fits "
          f"({kern.source})")
    for r in eager_recs + sweep_recs:
        print(f"  10c record {r['name']}: {r['us_per_call']:.3f} us/iter "
              f"[{card}]")
    base = dataclasses.replace(kern, iter_overhead_us=0.0, dispatch_us=0.0)
    resid = []
    for r in sweep_recs:
        cost, n = sweep_cost(r["name"])
        resid.append(r["us_per_call"] - base.us_per_iter(
            cost, rng_elems=n * pso_cost.RNG_DRAWS))
    overhead = max(0.0, float(np.median(resid)))
    # the split path: a custom sphere at d=8 n=1024, fused mode
    prob = custom_sphere()
    cfg = pso.PSOConfig(dim=8, particle_cnt=1024, fitness=prob).resolved()
    s0 = pso.init_swarm(cfg, 0, device="cuda")
    split_us = best_of(lambda: ops.run_queue_lock_fused(cfg, s0, 50)) / 50 \
        * 1e6
    cost = pso_cost.iteration_cost("queue_lock", prob, 8, 1024,
                                   backend="kernel")
    rest = dataclasses.replace(base, iter_overhead_us=overhead).us_per_iter(
        cost, rng_elems=1024 * 8 * pso_cost.RNG_DRAWS)
    dispatch = max(0.0, (split_us - rest) / cost.dispatches)
    fitted = {"kernel": dataclasses.replace(
        kern, iter_overhead_us=overhead, dispatch_us=dispatch,
        source="cuda-default")}
    fitted["eager"] = dataclasses.replace(
        fitted["kernel"], flops_per_us=float(eager.flops_per_us),
        iter_overhead_us=eager.iter_overhead_us,
        source="cuda-eager-default")
    print(f"  10c fit: kernels grid_step_us={kern.grid_step_us:.6g} "
          f"iter_overhead_us={overhead:.6g} (median residual of "
          f"{len(sweep_recs)} sweep records) dispatch_us={dispatch:.6g} "
          f"(split path, custom sphere d=8 n=1024: {split_us:.1f} us/iter, "
          f"{cost.dispatches:.0f} dispatches); eager ({eager.source}) "
          f"flops_per_us={eager.flops_per_us:.6g} "
          f"iter_overhead_us={eager.iter_overhead_us:.6g} [{card}]")
    pooled = {"shipped": ([], []), "fitted": ([], [])}
    for cell, (_, measured, _) in tuned.items():
        prob, d, n, iters, s_cnt = cell
        got = [m.measured_us for m in measured]
        shipped = [m.predicted_us for m in measured]
        refit = [pso_cost.estimate_us_per_iter(
            m.variant, prob, d, n, backend=m.backend, block_n=m.block_n,
            sync_every=m.sync_every, batch=s_cnt, calib=fitted[m.backend])
            for m in measured]
        for which, pred in (("shipped", shipped), ("fitted", refit)):
            pooled[which][0].extend(pred)
            pooled[which][1].extend(got)
        print(f"  10c {tune_label(*cell)}: predicted (shipped / fitted) "
              f"against measured us/iter: " + "; ".join(
                  f"{schedule_text(m, n, d)} {p:.2f} / {q:.2f} / "
                  f"{m.measured_us:.2f}"
                  for m, p, q in zip(measured, shipped, refit))
              + f"; Spearman {spearman(shipped, got):.3f} / "
              f"{spearman(refit, got):.3f} [{card}]")
    print("  10c all cells pooled, Spearman shipped "
          f"{spearman(*pooled['shipped']):.3f}, fitted "
          f"{spearman(*pooled['fitted']):.3f}")
    for name, c in fitted.items():
        print(f"  10c {name} calibration: {c}")
    baseline = pso_cost.fit_calibration(
        str(ROOT / "benchmarks" / "BENCH_pso.json"))
    check("host-mismatch" in baseline.source, f"10c: BENCH_pso.json (a CPU "
          f"in interpret mode) refused on the card ({baseline.source})")
    print(f"  10c: BENCH_pso.json -> {baseline.source}; 10c took "
          f"{time.perf_counter() - t0:.1f} s [{card}]")


def serving_tuned(card: str, launches: dict) -> None:
    """10d: phase 8a's trace at n=128 (one block) through
    ``SolveServer(autotune=True)`` and ``ContinuousScheduler(autotune=
    True)`` on the kernel backend: every result equals ``solve(...,
    sync_every=<the tuned value>, backend="kernel")`` bit for bit."""
    reqs = serve_requests(SERVE_BUDGETS, 128)
    tuned = [dataclasses.replace(r, sync_every=autotune.tuned_sync_every(
        r.fitness, r.dim, r.particle_cnt, r.iters, device="cuda"))
        for r in reqs]
    check(all(r.sync_every in autotune.SYNC_EVERY_CHOICES for r in tuned),
          "10d: tuned sync_every in SYNC_EVERY_CHOICES")
    want = [standalone_kernel(r) for r in tuned]
    srv = SolveServer(backend="kernel", autotune=True)
    res, dt, counts = serving_main("10d", functools.partial(srv.solve_all,
                                                            reqs))
    for k, v in counts.items():
        launches[k] += v
    check(all(same_result(x, w) for x, w in zip(res, want)),
          "10d: SolveServer(autotune=True) == solve(sync_every=tuned, "
          "backend='kernel') bit for bit")
    print(f"  10d SolveServer(autotune=True): {len(reqs)} requests, "
          f"{srv.stats.dispatches} dispatches, ladders "
          f"{sorted(set(srv._ladders.values()))}; every result == its "
          f"standalone kernel solve at the tuned sync_every bit for bit; "
          f"launches {counts}; {dt:.3f} s [{card}]")
    sched = serving.ContinuousScheduler(lane_width=8, backend="kernel",
                                        autotune=True, record_history=True)
    res, dt, counts = serving_main("10d", functools.partial(sched.run, reqs))
    for k, v in counts.items():
        launches[k] += v
    check(all(same_result(x, w) for x, w in zip(res, want)),
          "10d: ContinuousScheduler(autotune=True) == solve(sync_every="
          "tuned, backend='kernel') bit for bit")
    widths = sorted({lane.width for lane in sched._lanes.values()})
    ladder = autotune.bucket_ladder("cubic", SERVE_D, 128, 16, max_batch=8,
                                    variant="async", min_bucket=8,
                                    device="cuda")
    print(f"  10d ContinuousScheduler(autotune=True): tuned sync_every by "
          f"budget {sorted({(r.iters, r.sync_every) for r in tuned})}, "
          f"{len(sched._lanes)} lane(s) of width {widths} (ladder {ladder} "
          f"at lane width 8; at 128: "
          f"{autotune.bucket_ladder('cubic', SERVE_D, 128, 16, max_batch=128, variant='async', min_bucket=8, device='cuda')}"
          f"), {metric_counts(sched.metrics)}; every result == its "
          f"standalone kernel solve bit for bit; launches {counts}; "
          f"{dt:.3f} s [{card}]")


def phase_autotune(card: str) -> dict:
    """Phase 10; returns the launches of 10a's resolves, 10b's solves and
    10d's serving drives."""
    print(f"phase 10: the schedule autotuner on the card [{card}]")
    t0 = time.perf_counter()
    launches = dict.fromkeys(COUNTERS, 0)
    tmp = ROOT / "build" / "chip_smoke_phase10"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    env = os.environ.get(autotune.CACHE_ENV)
    os.environ[autotune.CACHE_ENV] = str(tmp / "autotune.json")
    try:
        cache = autotune.AutotuneCache(str(tmp / "autotune.json"))
        tuned = tune_cells(card, launches, cache)
        auto_against_fixed(card, launches, tuned)
        calibrate(card, tuned)
        serving_tuned(card, launches)
    finally:
        if env is None:
            os.environ.pop(autotune.CACHE_ENV, None)
        else:
            os.environ[autotune.CACHE_ENV] = env
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  phase 10: {time.perf_counter() - t0:.1f} s; launches "
          f"{dict((k, v) for k, v in launches.items() if v)}")
    return launches


#: Each kernel of the port and the TPU kernel it replaces.
REPLACES = {
    "queue_step": "src/repro/kernels/pso_step.py:822",
    "fused": "src/repro/kernels/pso_step.py:874",
    "fused_async": "src/repro/kernels/pso_step.py:1349",
    "fused_batch": "src/repro/kernels/pso_step.py:938",
    "hetero_fused_batch": "src/repro/kernels/pso_step.py:1036",
    "fused_async_batch": "src/repro/kernels/pso_step.py:1419",
    "hetero_fused_async_batch": "src/repro/kernels/pso_step.py:1500",
    "gla_forward": "src/repro/kernels/gla.py:78",
    # the split kernels: the converted forms of rows 1-7 (SPLIT_REPLACES),
    # named by fused_call, the main path's
    "split_advance": "src/repro/kernels/pso_step.py:874",
    "split_fold": "src/repro/kernels/pso_step.py:874",
    "split_publish": "src/repro/kernels/pso_step.py:874",
}
#: The pallas_call functions whose converted forms (a custom objective, the
#: projection, the Deb fold, resolved by lower_statics) the split kernels
#: replace.
SPLIT_REPLACES = ["src/repro/kernels/pso_step.py:" + str(line)
                  for line in (822, 874, 938, 1036, 1349, 1419, 1500)]

#: Each kernel's CUDA source.
SOURCES = {name: "src/repro_torch/kernels/csrc/pso_step.cu" for name in REPLACES}
SOURCES["gla_forward"] = "src/repro_torch/kernels/csrc/gla.cu"
for _name in ("split_advance", "split_fold", "split_publish"):
    SOURCES[_name] = "src/repro_torch/kernels/csrc/pso_split.cu"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    # Full float32 in every plain version's products (GLA's einsums).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"phase 1: torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"{nvcc[-1]}; card: {card}; "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    phase_build()
    errs = dict.fromkeys(COUNTERS, 0.0)
    phase_compare(errs)
    phase_compare_batches(errs)
    phase_compare_gla(errs)
    launches, _ = phase_main_path(card)
    phase_many_path(card, launches)
    phase_tables(card, launches)
    phase_gla_path(card, launches)
    phase_telemetry_path(card, launches)
    phase_async_chunks(card)
    print(f"phase 5: kernel and plain times on the same call [{card}]")
    times, bounds = phase_times(card)
    phase_cluster_sweep(card)
    phase_main_path_kernels(card)
    phase_split_compare(errs)
    split_launches, split_us = phase_split_path(card)
    launches.update(split_launches)
    split_times(card, times, bounds)
    for k, v in phase_lbest(card, errs).items():
        launches[k] += v
    for k, v in phase_serving(card).items():
        launches[k] += v
    for k, v in phase_launcher(card, errs).items():
        launches[k] += v
    for k, v in phase_autotune(card).items():
        launches[k] += v
    kernels = []
    for name, replaces in REPLACES.items():
        b_ms, b_by = bounds[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": times[name] * 1e3, "plain_ms": times[name + "_plain"] * 1e3,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            # the contention counters (rows of the fused and async kernels)
            "counter_checks": COUNTER_CHECKS.get(name),
            "us_per_iter": None, "us_per_iter_counters": None,
        })
        k = kernels[-1]
        if name in split_us:
            # device us an iteration on the main path's largest cell
            k["us_per_iter"] = split_us[name]
            k["replaces_converted_forms_of"] = SPLIT_REPLACES
        if name in COUNTER_CHECKS:
            per = 1e6 / times["iters"][name]
            k["us_per_iter"] = times[name] * per
            k["us_per_iter_counters"] = times[name + "_counters"] * per
            check(all(COUNTER_CHECKS[name].values()), f"{name}: counters "
                  f"checked exactly and against the invariants "
                  f"({COUNTER_CHECKS[name]})")
        print(f"  {name}: {k['ms']:.4f} ms (plain {k['plain_ms']:.2f} ms, "
              f"bound {k['bound_ms']:.4f} ms by {k['bound_by']}), "
              f"{k['launches']} launch(es) on the main path" + (
                  f"; {k['us_per_iter']:.3f} us/iter, with counters "
                  f"{k['us_per_iter_counters']:.3f}; counter checks "
                  f"{k['counter_checks']}" if name in COUNTER_CHECKS else ""))
    check(all(k["launches"] > 0 for k in kernels), "every kernel launched")
    check(all(k["ms"] >= k["bound_ms"] for k in kernels),
          "no kernel's time under its bound")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
