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

With ``--source pso_split`` each tree builds its ``pso_split.cu`` instead
and runs its own checkout's ``chip_smoke.split_times`` (phase 6c: each
split kernel alone at sphere_simplex d=120 n=32768, the L2 flushed, beside
its bound, the L2 flushed by reading in every tree), since the split
kernels and their timing differ between trees, then phase 6b's solves below d=120 (``split_solves``: host us/iter and each
split kernel's device us/iter).

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
    lib, log = _build.build(source)
    lines = cs.ptxas_lines(log)
    print(f"tree {src}: {lib.name}, {len(lines)} kernels [{card}]")
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
        cs.split_times(card, {}, {})
        split_solves(cs, card)
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


def split_solves(cs, card: str) -> None:
    """The tree's chip_smoke.py phase 6b solves below d=120 (``SPLIT_CELLS``)
    through ``repro_torch.solve``: the host's us/iter (median of 3 solves)
    and, under torch.profiler, the device us/iter of each split kernel by
    name and of everything else on the card (the torch step)."""
    import time

    import repro_torch
    import torch
    for label, key, d, n, iters in cs.SPLIT_CELLS:
        if d >= 120:
            continue
        for variant in ("queue_lock", "async"):
            run = functools.partial(repro_torch.solve, cs.split_problem(key),
                                    dim=d, particles=n, iters=iters, seed=0,
                                    variant=variant, w=0.7)
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
            print(f"  {label} d={d} n={n} x{iters} {variant}: host "
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
        moved = [k for k in pa if pa[k] != pb.get(k)]
        print(f"-Xptxas -v, {a} -> {b}: {len(moved)} of {len(pa)} kernels "
              f"differ; spills (stores + loads) "
              f"{sum(map(spills, pa.values()))} -> "
              f"{sum(map(spills, pb.values()))} B in all")
        for k in moved:
            print(f"  {k}: {pa[k]} -> {pb.get(k)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
