#!/usr/bin/env python3
"""The fused and async kernels, or the split path's, of several checkouts
on one card, in turns.

    python3 tools/kernel_trees.py OLD/src src src OLD/src
    python3 tools/kernel_trees.py --source pso_split OLD/src src src OLD/src
    python3 tools/kernel_trees.py --source gla OLD/src src src OLD/src
    python3 tools/kernel_trees.py --may-move 'lbest|queue_pair' OLD/src src

Each argument is a checkout's ``src/``, run in a process of its own (a
package is imported once a process) in the order given, so ``P C C P``
compares two trees within one call on one card. For each tree: the build
of both libraries of its ``pso_step.cu`` (float32, and bfloat16 with
``-DPSO_T_BF16``, built together) and every kernel's ``-Xptxas -v`` line
(registers and spills), the element loop of each fused and async kernel of
cubic/pso in SASS by instruction class (``element_sass``), then the fused
and async kernels alone at the main path's two solve cells (cubic d=1
n=131072 x1000, cubic d=120 n=32768 x200; async at sync_every=8), counters
off, each run from a copy of the initial swarm, in float32 and in
bfloat16: device us an iteration (CUDA events), the median of five after a
warm run; the float32 async kernel under each topology at the same cells
(``lbest_turns``); and the fused kernel's x32 call from the fresh swarm at
d=1 in both dtypes (``fresh_turns``). Last, the kernels whose
``-Xptxas -v`` line or SASS differs between the first two distinct trees,
side by side, with the spill totals; the float32 ones counted apart (this
checkout's parser keys a tree's float32 kernels alike whether or not its
kernels take the storage type as a template parameter). A SASS digest
reads the function's text with its blanks collapsed and its branch labels
and internal subroutine names renumbered (``normalised``), so a function
that no change touched keeps its digest in a library that gained other
functions; for a few functions whose SASS moved, the first line that
differs is shown.

The timing and the swarms are chip_smoke.py's (``kernel_state``,
``with_locals``, ``device_us``); the tree's ``repro_torch`` is imported
before ``chip_smoke``, so chip_smoke's helpers drive that tree's package.

With ``--source pso_split`` each tree builds its ``pso_split.cu`` instead,
both libraries (float32, and bfloat16 with ``-DPSO_T_BF16``; the
``-Xptxas -v`` comparison covers both and counts the float32 lines that
moved apart), prints each advance kernel's SASS by instruction class
(``advance_sass``, ``cuobjdump -sass``), and runs its own checkout's
``chip_smoke.split_times`` and ``split_bf16_times`` (phases 6c and 16c:
each split kernel alone at sphere_simplex d=120 n=32768 in float32, then
in bfloat16, the L2 flushed by reading in every tree, beside its bound),
since the split kernels and their timing differ between trees, then phase
6b's solves below d=120 in float32 and all of them in bfloat16 (16b's
cells; ``split_solves``: host us/iter and each split kernel's device
us/iter).

With ``--source gla`` each tree builds its ``gla.cu`` and runs this
checkout's ``chip_smoke.gla_times`` (phase 5's float32 GLA kernel path at
hymba-1.5B's SSD width, both kinds of gates, and the xLSTM-350M head shape:
ms and each kernel's device us), then its bfloat16 kernel path at phase
11a's two shapes (``gla_bf16_turn``: each kernel's device us with the L2
flushed by reading before every call); this checkout's parser keys the
float32 kernels alike in trees with and without the bfloat16
instantiations, and the bfloat16 ones alike whether bfloat16 is their
template argument or their own kernel.

``--may-move PATTERN`` (a regular expression, searched in each kernel's
key) states which functions a change may move: the comparison ends with
the moved functions outside it, and the tool exits 1 if there are any.
Without it no function may move. Needs one CUDA card, ``nvcc`` and
``nvidia-smi``.
"""
import concurrent.futures
import functools
import json
import pickle
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one_tree(src: str, source: str, sass_out: str) -> None:
    """Build and time one tree's kernels of ``source``; the last line is
    its ``-Xptxas -v`` lines and SASS digests as JSON, and ``sass_out``
    gets each function's normalised SASS (``sass_digests``)."""
    sys.path.insert(0, src)
    import repro_torch  # noqa: F401  (the tree's package, first)
    sys.path.insert(1, str(ROOT if source in ("pso_step", "gla")
                           else Path(src).resolve().parent))
    import chip_smoke as cs
    import torch
    from repro_torch.kernels import _build, ops, pso_step
    if not torch.cuda.is_available():
        raise SystemExit("kernel_trees: no CUDA device")
    card = cs.card_line()
    variants = ("", "bf16") if source in ("pso_step", "pso_split") else ("",)
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        libs = list(pool.map(functools.partial(_build.build, source),
                             variants))
    lines = [line for _, log in libs for line in cs.ptxas_lines(log)]
    digests, bodies = sass_digests([lib for lib, _ in libs], cs)
    Path(sass_out).write_bytes(pickle.dumps(bodies))
    print(f"tree {src}: {', '.join(lib.name for lib, _ in libs)}, "
          f"{len(lines)} kernels [{card}]")
    for line in lines:
        print(f"  {line}")
    if source == "gla":
        torch.backends.cuda.matmul.allow_tf32 = False
        cs.gla_times(card)
        gla_bf16_turn(cs, card)
        print(json.dumps({"ptxas": lines, "sass": digests}))
        return
    if source == "pso_split":
        # every tree's 6c flushes the L2 alike: by reading 256 MB, as this
        # checkout's chip_smoke.flush_l2 does (an older one wrote zeros,
        # which the timed kernel then wrote back)
        scrub = torch.ones(2 ** 26, dtype=torch.int32, device="cuda")
        cs.flush_l2 = scrub.sum
        advance_sass([lib for lib, _ in libs], card)
        cs.split_times(card, {}, {})
        cs.split_bf16_times(card, {}, {})
        split_solves(cs, card)
        split_solves(cs, card, "bfloat16")
        print(json.dumps({"ptxas": lines, "sass": digests}))
        return
    element_sass([lib for lib, _ in libs], card)
    for d, n, iters in cs.SOLVE_CELLS:
        for dtype in ("float32", "bfloat16"):
            make = cs.kernel_state if dtype == "float32" else cs.bf16_state
            _, spec, state, seed = make("cubic", d, n)
            bn = ops._resolve_block(n, None)
            kw = dict(seed=seed, iteration=0, iters=iters, block_n=bn)
            runs = (("fused", lambda st: pso_step.fused(*st, spec, **kw),
                     state),
                    ("async", lambda st: pso_step.fused_async(
                        *st, spec, sync_every=cs.pso.ASYNC_SYNC_EVERY, **kw),
                     cs.with_locals(state, n // bn)))
            for kind, run, st in runs:
                cs.device_us(run, st)                         # warm-up
                us = sorted(cs.device_us(run, st) / iters for _ in range(5))
                print(f"  cubic d={d} n={n} x{iters} {kind} {dtype} "
                      f"(clusters of {cs.cluster_of(n, d)}), device us/iter, "
                      f"median {us[2]:.3f} "
                      f"({', '.join(f'{u:.3f}' for u in us)}) [{card}]")
    lbest_turns(cs, card)
    fresh_turns(cs, card)
    print(json.dumps({"ptxas": lines, "sass": digests}))


def gla_bf16_turn(cs, card: str) -> None:
    """The tree's bfloat16 GLA kernel path on folded operands at phase
    11a's shapes (hymba-1.5B's SSD width with the model's gates, the
    xLSTM-350M head shape), with ``cs``'s (chip_smoke's) inputs: each
    kernel's device us (torch.profiler, the mean of 5 calls, the L2
    flushed by reading before each, ``gla_cold_us``) and the call's ms in
    CUDA events, flushed alike (``cold_ms``)."""
    from repro_torch.kernels import gla
    chunk = 128
    for name, b, s, shape, ones, model in (
            ("hymba-1.5B B=4 S=4096, the model's gates", 4, 4096, cs.HYMBA,
             False, True),
            ("xLSTM-350M B=1 S=1024 P=257", 1, 1024, cs.XLSTM, True,
             False)):
        x = cs.gla_inputs(b, s, **shape, ones=ones, model_gates=model)
        folded = cs.gla_folded([a.bfloat16() for a in x[:3]] + x[3:], chunk)
        per = cs.gla_cold_us(folded, chunk)
        call = cs.cold_ms(lambda st: gla._launch(*st, chunk), folded)
        print(f"  gla bfloat16 {name}: " + ", ".join(
            f"{k} {us:.1f} us" for k, us in per.items()) + f"; the call "
            f"{call:.4f} ms, L2 flushed [{card}]")


def lbest_turns(cs, card: str) -> None:
    """The float32 async kernel alone under each topology (the star, the
    ring, von Neumann) at the two solve cells, from one state: device us an
    iteration in CUDA events, the median of five rounds in turns (the
    order reversed every other round), as chip_smoke's phase 7 times it."""
    from repro_torch.kernels import ops, pso_step
    for d, n, iters in cs.SOLVE_CELLS:
        bn = ops._resolve_block(n, None)
        _, spec, state, seed = cs.kernel_state("cubic", d, n)
        state = cs.with_locals(state, n // bn)
        kw = dict(seed=seed, iteration=0, iters=iters, block_n=bn,
                  sync_every=cs.pso.ASYNC_SYNC_EVERY)
        us = {t: [] for t in ("gbest", "ring", "vonneumann")}
        for k in range(6):
            for topo in (list(us) if k % 2 else list(us)[::-1]):
                t = cs.device_us(lambda st, topo=topo: pso_step.fused_async(
                    *st, spec, topology=topo, **kw), state)
                if k:
                    us[topo].append(t / iters)
        print(f"  cubic d={d} n={n} x{iters} async float32 (clusters of "
              f"{cs.cluster_of(n, d)}) by topology, device us/iter, median "
              f"of 5 in turns: " + ", ".join(
                  f"{t} {sorted(v)[2]:.3f}" for t, v in us.items())
              + f" [{card}]")


def fresh_turns(cs, card: str) -> None:
    """Row 2 at cubic d=1 n=131072 x32 in float32 and bfloat16, in turns
    (float32, bfloat16, bfloat16, float32): one call from the fresh swarm
    between two CUDA events (``device_us``), phase 5's
    (rounds of 5 calls back to back on copies of the fresh swarm,
    ``off_on``), the same rounds from the swarm after 1000 iterations, the
    host's us to enqueue one call, and the particles whose pbest rose in a
    call from each swarm, with ``cs``'s (chip_smoke's) swarms and clocks.
    A single call's events also time the host's work before its launch
    reaches the stream, which calls back to back hide; a fresh swarm's
    first iterations copy more pbest columns."""
    import time

    import torch
    from repro_torch.kernels import pso_step
    d, n, iters, bn = 1, 131072, 32, 512
    runs = {}
    for dt in ("float32", "bfloat16"):
        make = cs.kernel_state if dt == "float32" else cs.bf16_state
        _, spec, state, seed = make("cubic", d, n)
        steady = [x.clone() for x in state]
        pso_step.fused(*steady, spec, seed=seed, iteration=0, iters=1000,
                       block_n=bn)

        def run(st, c=None, spec=spec, seed=seed, it=0):
            return pso_step.fused(*st, spec, seed=seed, iteration=it,
                                  iters=iters, block_n=bn, counts=c)
        runs[dt] = (run, state, steady)
    got = {}
    for dt in ("float32", "bfloat16", "bfloat16", "float32"):
        run, state, steady = runs[dt]
        at = functools.partial(run, it=1000)
        one = cs.device_us(run, state) / iters
        fresh = cs.off_on(run, state)[0] * 1e6 / iters
        late = cs.off_on(at, steady)[0] * 1e6 / iters
        st = [x.clone() for x in state]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(st)
        host = (time.perf_counter() - t0) * 1e6
        torch.cuda.synchronize()
        rose = int((st[3] > state[3]).sum())
        st = [x.clone() for x in steady]
        at(st)
        rose_late = int((st[3] > steady[3]).sum())
        got.setdefault(dt, []).append(
            f"{one:.3f} / {fresh:.3f} / {late:.3f} us/iter, {host:.0f} host "
            f"us, pbest rose {rose} / {rose_late}")
    for dt, v in got.items():
        c = (cs.cluster_of(n, d) if dt == "float32"
             else cs.bf16_cluster(n, d, bn))
        print(f"  row 2 x{iters} cubic d={d} n={n} {dt} (C={c}), one "
              f"call from the fresh swarm / rounds from it / rounds from the "
              f"swarm after 1000 iterations; enqueue; particles whose pbest "
              f"rose in a call from each: " + "; ".join(v) + f" [{card}]")


def sass_functions(lib):
    """Each function of a library in SASS (``cuobjdump -sass``): (its
    mangled name, its instructions' text)."""
    from repro_torch.kernels import _build    # the tree's, imported first
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    for part in sass.split("Function : ")[1:]:
        head, _, body = part.partition("\n")
        yield head.strip(), body


def kernel_key(cs):
    """``chip_smoke.kernel_key``: ``cs``'s, else this checkout's (an older
    tree's chip_smoke, which ``--source pso_split`` imports, has none)."""
    if hasattr(cs, "kernel_key"):
        return cs.kernel_key
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.kernel_key


#: Names in a function's SASS that number what the whole library holds,
#: not what the function does: branch labels and the internal subroutines
#: (a division's or a cosine's slow path) that it calls.
LIBRARY_NUMBERED = re.compile(r"\.L_x_\d+|\$__internal_\d+_\$")


def normalised(body: str) -> str:
    """``body`` with every run of blanks made one space (``cuobjdump``
    pads the instruction column to the library's longest instruction) and
    every ``LIBRARY_NUMBERED`` name renumbered in the order it first
    appears, so a function keeps its text in a library that gained other
    functions."""
    ids = {}
    return LIBRARY_NUMBERED.sub(lambda m: ids.setdefault(
        m[0], f"<{len(ids)}>"), re.sub(r"[ \t]+", " ", body))


def sass_digests(libs, cs):
    """(digests, bodies): every function's SASS (``normalised``) as a
    digest of its text and, zlib-compressed, the text, both keyed as its
    ``-Xptxas -v`` line (``kernel_key``; a function of the bfloat16
    library whose key does not say so gets " (bf16 library)")."""
    import hashlib
    import zlib
    key_of = kernel_key(cs)
    digests, bodies = {}, {}
    for lib in libs:
        bf16 = "_bf16-" in lib.name
        for name, body in sass_functions(lib):
            key = key_of(name)
            if bf16 and "bf16" not in key:
                key += " (bf16 library)"
            body = normalised(body)
            digests[key] = hashlib.sha1(body.encode()).hexdigest()[:16]
            bodies[key] = zlib.compress(body.encode())
    return digests, bodies


def first_difference(a: bytes, b: bytes) -> str:
    """Where two functions' compressed SASS (``sass_digests``) first
    differ: the lines that differ, of how many, and the first pair."""
    import zlib
    la = zlib.decompress(a).decode().splitlines()
    lb = zlib.decompress(b).decode().splitlines()
    diff = [i for i in range(max(len(la), len(lb)))
            if i >= len(la) or i >= len(lb) or la[i] != lb[i]]
    i = diff[0]
    return (f"{len(diff)} of {max(len(la), len(lb))} lines differ; line "
            f"{i}: {la[i].strip() if i < len(la) else '(none)'!r} -> "
            f"{lb[i].strip() if i < len(lb) else '(none)'!r}")


#: The fused and async kernels whose element loop ``element_sass`` prints.
ELEMENT_KERNELS = ("fused_kernel", "fused_pair_kernel", "async_kernel",
                   "async_pair_kernel")


def element_sass(libs, card: str) -> None:
    """The element loop of each fused and async kernel of cubic/pso (star
    topology) in SASS: the longest innermost loop (a backward branch's
    range that holds no other) that stores, which is the loop over a
    thread's batched dimensions (the hash, the rule, the objective, the
    loads and the pos and vel stores; the pbest copies' loop is shorter).
    Its instructions by class over the elements its stores cover (two
    stores an element: pos and vel), static code, not a dynamic count."""
    import chip_smoke as cs
    for lib in libs:
        for name, body in sass_functions(lib):
            key = cs.kernel_key(name)
            kernel = key.split("<")[0]
            if kernel not in ELEMENT_KERNELS or not key.startswith(
                    kernel + "<cubic,pso,") or "lbest" in key:
                continue
            esize = 16 if key.endswith(",bf16>") else 32
            best = loop_per_element(body, esize)
            if best is None:
                print(f"  element loop {key}: none found [{card}]")
                continue
            n_ops, elements, by = best
            print(f"  element loop {key}: {n_ops} instructions, "
                  f"{elements} elements stored, {n_ops / elements:.1f} an "
                  f"element (" + ", ".join(
                      f"{c} {v / elements:.1f}" for c, v in by.items())
                  + f") [{card}]")


def loop_per_element(body: str, esize: int):
    """(instructions, elements stored, instructions by class) of the
    longest innermost loop of ``body`` that stores (lanes of ``esize``
    bits), or None."""
    addr, ops, labels, branches = [], [], {}, []
    pending = []
    for line in body.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab[1])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]+)(.*)", line)
        if not m:
            continue
        a = int(m[1], 16)
        for name in pending:
            labels[name] = a
        pending = []
        addr.append(a)
        ops.append(m[2])
        if m[2].startswith("BRA"):
            t = re.search(r"(0x[0-9a-f]+|\.L_x_\d+)", m[3])
            if t:
                branches.append((a, t[1]))
    loops = []
    for a, t in branches:
        target = labels.get(t) if t.startswith(".L") else int(t, 16)
        if target is not None and target <= a:
            loops.append((target, a))
    inner = [(lo, hi) for lo, hi in loops
             if not any((lo, hi) != (l2, h2) and lo <= l2 and h2 <= hi
                        for l2, h2 in loops)]
    best = None
    for lo, hi in inner:
        idx = [i for i, a in enumerate(addr) if lo <= a <= hi]
        lanes = 0
        for i in idx:
            if ops[i].startswith("STG"):
                w = re.search(r"\.(128|64|U16|S16|U8)\b", ops[i])
                lanes += {"128": 128, "64": 64, "U16": 16, "S16": 16,
                          "U8": 8}.get(w[1] if w else "", 32) // esize
        if lanes and (best is None or len(idx) > best[0]):
            base = [ops[i].split(".")[0] for i in idx]
            by = {c: sum(b in names for b in base)
                  for c, names in SASS_CLASSES.items()}
            best = (len(idx), lanes, by)
    if best is None:
        return None
    return best[0], best[1] // 2, best[2]


#: SASS instruction classes (``advance_sass``, ``element_sass``), by
#: opcode.
SASS_CLASSES = {
    "integer": ("IMAD", "IADD3", "IADD", "VIADD", "LOP3", "SHF", "LEA",
                "ISETP", "SEL", "IABS", "PRMT", "IMNMX", "FLO", "POPC"),
    "conversion": ("I2F", "I2FP", "F2F", "F2FP", "F2I", "MUFU"),
    "float": ("FMUL", "FADD", "FFMA", "FMNMX", "FSETP", "FSEL"),
    "packed bf16": ("HMUL2", "HADD2", "HFMA2", "HMNMX2"),
    "memory": ("LDG", "STG", "LDC", "LD", "ST")}


def advance_sass(libs, card: str) -> None:
    """Each advance kernel of the tree's libraries in SASS (``cuobjdump
    -sass``): its instructions in the binary by class, and for the pso
    rule's kernels those over the elements their stores cover (pos and vel
    stored: the lanes of every STG over two; the static code of one loop
    trip or tile, its set-up included)."""
    for lib in libs:
        for head, part in sass_functions(lib):
            m = re.search(r"\d(split_advance(?:_bf16)?_kernel)ILi(\d)E"
                          r"(?:Li(\d)E)?(13__nv_bfloat16)?", head)
            if not m:
                continue
            name = (f"{m[1]}<{m[2]}" + (f",{m[3]}" if m[3] else "")
                    + (",bf16" if m[4] else "") + ">")
            ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_.]+)", part)
            base = [op.split(".")[0] for op in ops]
            by = {c: sum(b in names for b in base)
                  for c, names in SASS_CLASSES.items()}
            esize = 16 if "bf16" in name else 32
            lanes = 0
            for op in ops:
                if op.startswith("STG"):
                    w = re.search(r"\.(128|64|U16|S16|U8)\b", op)
                    lanes += {"128": 128, "64": 64, "U16": 16, "S16": 16,
                              "U8": 8}.get(w[1] if w else "", 32) // esize
            per = (f"; {lanes // 2} elements stored, "
                   f"{len(ops) / (lanes // 2):.1f} an element ("
                   + ", ".join(f"{c} {v / (lanes // 2):.1f}"
                               for c, v in by.items()) + ")"
                   if m[2] == "0" and lanes else "")
            print(f"  sass {name}: {len(ops)} instructions ("
                  + ", ".join(f"{c} {v}" for c, v in by.items())
                  + f"){per} [{card}]")


def split_solves(cs, card: str, dtype: str = "float32") -> None:
    """The tree's chip_smoke.py phase 6b solves (``SPLIT_CELLS``; below
    d=120 in float32) through ``repro_torch.solve`` in ``dtype``: the
    host's us/iter (median of 3 solves) and, under torch.profiler, the
    device us/iter of each split kernel by name and of everything else on
    the card (the torch step)."""
    import time

    import repro_torch
    import torch
    for label, key, d, n, iters in cs.SPLIT_CELLS:
        if d >= 120 and dtype == "float32":
            continue
        for variant in ("queue_lock", "async"):
            run = functools.partial(repro_torch.solve, cs.split_problem(key),
                                    dim=d, particles=n, iters=iters, seed=0,
                                    variant=variant, w=0.7, dtype=dtype)
            run()                                               # warm-up
            host = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t0) / iters * 1e6)
            dev = cs.kernel_device_us(run, reps=1)
            split = {k: v / iters for k, v in dev.items()
                     if k.startswith("split_")}
            rest = sum(dev.values()) / iters - sum(split.values())
            print(f"  {dtype} {label} d={d} n={n} x{iters} {variant}: host "
                  f"{sorted(host)[1]:.2f} us/iter; device us/iter "
                  + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
                      split.items()))
                  + f", the split kernels {sum(split.values()):.3f}, the "
                  f"rest {rest:.3f} [{card}]")


#: The functions in both trees whose SASS moved that ``compare_trees``
#: shows the first difference of (the float32 ones first).
SHOWN_DIFFERENCES = 5


def spills(info: str) -> int:
    return sum(int(b) for b in re.findall(r"(\d+) B spill", info))


def main() -> int:
    args = sys.argv[1:]
    source, may_move = "pso_step", None
    if args[:1] == ["--source"]:
        source, args = args[1], args[2:]
    if args[:1] == ["--may-move"]:
        may_move, args = re.compile(args[1]), args[2:]
    if source not in ("pso_step", "pso_split", "gla"):
        raise SystemExit(f"kernel_trees: --source pso_step, pso_split or "
                         f"gla, not {source}")
    if args[:1] == ["--tree"]:
        one_tree(args[1], source, args[2])
        return 0
    trees = args
    if not trees:
        raise SystemExit(__doc__)
    with tempfile.TemporaryDirectory() as tmp:
        return compare_trees(trees, source, Path(tmp), may_move)


def compare_trees(trees, source: str, tmp: Path, may_move=None) -> int:
    """Runs each tree in a process of its own (``one_tree``), then prints
    what moved between the first two distinct trees; returns 1 if a
    function outside ``may_move`` (a compiled pattern, or None: none may)
    moved, by its ``-Xptxas -v`` line or its SASS."""
    ptxas, sass, bodies = {}, {}, {}
    unexpected = set()
    for i, src in enumerate(trees):
        out_file = tmp / f"sass{i}.pickle"
        out = subprocess.run([sys.executable, __file__, "--source", source,
                              "--tree", src, str(out_file)],
                             capture_output=True, text=True)
        if out.returncode:
            sys.stderr.write(out.stderr)
            raise SystemExit(f"kernel_trees: tree {src} failed")
        *shown, last = out.stdout.strip().splitlines()
        print("\n".join(shown), flush=True)
        got = json.loads(last)
        ptxas.setdefault(src, dict(l.split(":", 1) for l in got["ptxas"]))
        sass.setdefault(src, got["sass"])
        if src not in bodies:
            bodies[src] = pickle.loads(out_file.read_bytes())
    if len(ptxas) > 1:
        (a, pa), (b, pb) = list(ptxas.items())[:2]
        keys = list(pa) + [k for k in pb if k not in pa]
        moved = [k for k in keys if pa.get(k) != pb.get(k)]
        f32 = [k for k in keys if "bf16" not in k]
        print(f"-Xptxas -v, {a} -> {b}: {len(moved)} of {len(keys)} kernels "
              f"differ, {sum(k in f32 for k in moved)} of the {len(f32)} "
              f"float32 ones (a kernel in one tree only differs); spills "
              f"(stores + loads) {sum(map(spills, pa.values()))} -> "
              f"{sum(map(spills, pb.values()))} B in all")
        for k in moved:
            print(f"  {k}: {pa.get(k)} -> {pb.get(k)}")
        unexpected.update(moved)
        sa, sb = sass[a], sass[b]
        keys = list(sa) + [k for k in sb if k not in sa]
        moved = [k for k in keys if sa.get(k) != sb.get(k)]
        f32 = [k for k in keys if "bf16" not in k]
        print(f"SASS, {a} -> {b}: {len(moved)} of {len(keys)} functions "
              f"differ, {sum(k in f32 for k in moved)} of the {len(f32)} "
              f"float32 ones (a function in one tree only differs)")
        for k in moved:
            if k in f32:
                print(f"  float32 SASS moved: {k}")
        both = [k for k in moved if k in sa and k in sb]
        both.sort(key=lambda k: k not in f32)
        for k in both[:SHOWN_DIFFERENCES]:
            print(f"  {k}: {first_difference(bodies[a][k], bodies[b][k])}")
        unexpected.update(moved)
    unexpected = sorted(k for k in unexpected
                        if not (may_move and may_move.search(k)))
    print(f"moved outside --may-move "
          f"{may_move.pattern if may_move else '(none may move)'}: "
          f"{len(unexpected)}" + "".join(f"\n  {k}" for k in unexpected))
    return 1 if unexpected else 0


if __name__ == "__main__":
    sys.exit(main())
