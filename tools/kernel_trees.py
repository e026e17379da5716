#!/usr/bin/env python3
"""The fused and async kernels, or the split path's, of several checkouts
on one card, in turns.

    python3 tools/kernel_trees.py OLD/src src src OLD/src
    python3 tools/kernel_trees.py --source pso_split OLD/src src src OLD/src
    python3 tools/kernel_trees.py --source gla OLD/src src src OLD/src

Each argument is a checkout's ``src/``, run in a process of its own (a
package is imported once a process) in the order given, so ``P C C P``
compares two trees within one call on one card. For each tree: the build
of its ``pso_step.cu`` and every kernel's ``-Xptxas -v`` line (registers
and spills), then the fused and async kernels alone at the main path's two
solve cells (cubic d=1 n=131072 x1000, cubic d=120 n=32768 x200; async at
sync_every=8), counters off, each run from a copy of the initial swarm:
device us an iteration (CUDA events), the median of five after a warm
run. Last, the kernels whose ``-Xptxas -v`` line differs between the
first two distinct trees, side by side, with the spill totals (this
checkout's parser keys a tree's float32 kernels alike whether or not its
kernels take the storage type as a template parameter; the bfloat16
library, ``-DPSO_T_BF16``, is not built here).

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
ms and each kernel's device us); this checkout's parser keys the float32
kernels alike in trees with and without the bfloat16 instantiations.
Needs one CUDA card, ``nvcc`` and ``nvidia-smi``.
"""
import functools
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one_tree(src: str, source: str) -> None:
    """Build and time one tree's kernels of ``source``; the last line is
    its ``-Xptxas -v`` lines as JSON."""
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
    libs = [_build.build(source)]
    if source == "pso_split":
        libs.append(_build.build(source, "bf16"))
    lines = [line for _, log in libs for line in cs.ptxas_lines(log)]
    print(f"tree {src}: {', '.join(lib.name for lib, _ in libs)}, "
          f"{len(lines)} kernels [{card}]")
    for line in lines:
        print(f"  {line}")
    if source == "gla":
        torch.backends.cuda.matmul.allow_tf32 = False
        cs.gla_times(card)
        print(json.dumps(lines))
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
        print(json.dumps(lines))
        return
    for d, n, iters in cs.SOLVE_CELLS:
        _, spec, state, seed = cs.kernel_state("cubic", d, n)
        bn = ops._resolve_block(n, None)
        kw = dict(seed=seed, iteration=0, iters=iters, block_n=bn)
        runs = (("fused", lambda st: pso_step.fused(*st, spec, **kw), state),
                ("async", lambda st: pso_step.fused_async(
                    *st, spec, sync_every=cs.pso.ASYNC_SYNC_EVERY, **kw),
                 cs.with_locals(state, n // bn)))
        for kind, run, st in runs:
            cs.device_us(run, st)                             # warm-up
            us = sorted(cs.device_us(run, st) / iters for _ in range(5))
            print(f"  cubic d={d} n={n} x{iters} {kind} (clusters of "
                  f"{cs.cluster_of(n, d)}), device us/iter, median "
                  f"{us[2]:.3f} ({', '.join(f'{u:.3f}' for u in us)}) "
                  f"[{card}]")
    print(json.dumps(lines))


#: SASS instruction classes (``advance_sass``), by opcode.
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
    from repro_torch.kernels import _build    # the tree's, imported first
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    for lib in libs:
        sass = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        for part in sass.split("Function : ")[1:]:
            head = part.split("\n")[0]
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


def spills(info: str) -> int:
    return sum(int(b) for b in re.findall(r"(\d+) B spill", info))


def main() -> int:
    args = sys.argv[1:]
    source = "pso_step"
    if args[:1] == ["--source"]:
        source, args = args[1], args[2:]
    if source not in ("pso_step", "pso_split", "gla"):
        raise SystemExit(f"kernel_trees: --source pso_step, pso_split or "
                         f"gla, not {source}")
    if args[:1] == ["--tree"]:
        one_tree(args[1], source)
        return 0
    trees = args
    if not trees:
        raise SystemExit(__doc__)
    ptxas = {}
    for src in trees:
        out = subprocess.run([sys.executable, __file__, "--source", source,
                              "--tree", src], capture_output=True, text=True)
        if out.returncode:
            sys.stderr.write(out.stderr)
            raise SystemExit(f"kernel_trees: tree {src} failed")
        *shown, last = out.stdout.strip().splitlines()
        print("\n".join(shown), flush=True)
        ptxas.setdefault(src, dict(l.split(":", 1) for l in json.loads(last)))
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
