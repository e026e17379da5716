"""PSO launcher, the port of ``repro.launch.pso_run``: the paper's workload
from the command line, on the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.pso_run --dim 120 \\
        --particles 32768 --iters 1000 --variant queue_lock --kernel \\
        --islands 4 --exchange 50

``--kernel`` runs the fused queue-lock kernel (``--variant queue_lock``) or
the async kernel (``--variant async``), a launch a chunk of
``--ckpt-every`` iterations (all of them without it), saving a checkpoint
into ``--ckpt-dir`` after each chunk; on a CPU device their plain versions
run. ``--islands N`` splits the swarm into N islands on the one device
(``core/distributed.py``; the reference puts one on each device and
refuses more islands than devices): the synchronous variants exchange
their best every ``--exchange`` iterations, and with ``--kernel`` each
island's steps launch the fused kernel; ``--variant async`` runs the
island ring on the eager engine, with the staleness bound of
``--sync-every`` iterations within an island plus N exchange rounds across
them.

``--fitness`` takes any registered problem; ``--constraint`` attaches
constraints (``"sum(x)<=1"``-style expressions, repeatable, or the preset
``simplex``) enforced by ``--constraint-mode`` (penalty with
``--penalty-weight``, repair, or projection), and the run then reports
``violation=``/``feasible=``. ``--telemetry`` sums the kernels' contention
counters over the chunks; ``--trace-out`` and ``--metrics-out`` write a
trace.json and a Prometheus exposition of the chunks, the trace.json with
the program's spans (``telemetry.trace``) beside the chunks, on one
clock; ``--profile-dir`` brackets the run with
``telemetry.profiler_session``, whose ``torch_trace.json`` holds the spans
above the device's kernels. With ``--kernel`` the last line before the
result counts the kernels' launches.
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import Optional, Sequence

import torch

from .. import _device
from .. import checkpoint as ckpt
from ..core import ASYNC_SYNC_EVERY, PSOConfig, init_swarm, run
from ..core.constraints import constrain_problem, constraint_set_from_cli
from ..core.distributed import (gather_swarm, init_sharded_swarm,
                                make_distributed_run)
from ..core.problem import list_problems, resolve_problem
from ..core.update_rules import rule_names


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=120)
    ap.add_argument("--particles", type=int, default=32768)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--fitness", default="cubic",
                    help="registered problem name (see "
                         "repro_torch.list_problems)")
    ap.add_argument("--variant", default="queue",
                    choices=["reduction", "queue", "queue_lock", "async"])
    ap.add_argument("--sync-every", type=int, default=ASYNC_SYNC_EVERY,
                    help="async variant: iterations between gbest syncs")
    ap.add_argument("--rule", default="pso",
                    help="per-particle update rule (pso|sso|lowcost or a "
                         "custom repro_torch.core.update_rules "
                         "registration)")
    ap.add_argument("--topology", default="gbest",
                    choices=["gbest", "ring", "vonneumann"],
                    help="async variant: block-neighborhood best pull "
                         "(lbest topologies need --variant async)")
    ap.add_argument("--kernel", action="store_true",
                    help="use the fused CUDA kernels")
    ap.add_argument("--islands", type=int, default=0,
                    help="split the swarm into this many islands")
    ap.add_argument("--exchange", type=int, default=1,
                    help="island gbest exchange interval")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint every N iterations (0=off)")
    ap.add_argument("--constraint", action="append", default=[],
                    metavar="SPEC",
                    help="constraint preset: 'sum(x)<=1'-style expressions "
                         "(sum|norm|norm2|min|max, <=|>=|==; repeatable) "
                         "or the named preset 'simplex'")
    ap.add_argument("--constraint-mode", default="penalty",
                    choices=["penalty", "projection", "repair"],
                    help="how constraints are enforced (core.constraints)")
    ap.add_argument("--penalty-weight", type=float, default=1000.0,
                    help="penalty mode: weight per unit violation")
    ap.add_argument("--telemetry", action="store_true",
                    help="sum the kernels' contention counters over the "
                         "run (requires --kernel)")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="write a Perfetto-loadable trace.json of the "
                         "run's solve chunks here")
    ap.add_argument("--metrics-out", default="", metavar="PATH",
                    help="write a Prometheus text exposition (chunk "
                         "latency + kernel counters) here")
    ap.add_argument("--profile-dir", default="", metavar="DIR",
                    help="also capture a torch.profiler trace into DIR")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    try:
        dev = _device.resolve(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    if args.fitness not in list_problems():
        ap.error(f"unknown fitness {args.fitness!r}; registered problems: "
                 f"{', '.join(list_problems())}")
    fitness = args.fitness
    if args.constraint:
        try:
            cset = constraint_set_from_cli(args.constraint,
                                           mode=args.constraint_mode,
                                           weight=args.penalty_weight)
            fitness = constrain_problem(args.fitness, cset)
        except ValueError as e:
            ap.error(str(e))
    if args.rule not in rule_names():
        ap.error(f"unknown update rule {args.rule!r}; "
                 f"one of {', '.join(rule_names())}")
    if args.topology != "gbest" and args.variant != "async":
        ap.error(f"--topology {args.topology} generalizes the async "
                 f"variant's block-local pull; use --variant async")
    if args.topology != "gbest" and args.islands:
        ap.error("--topology applies within one island's block grid; "
                 "drop --islands (the island ring is its own topology)")
    cfg = PSOConfig(dim=args.dim, particle_cnt=args.particles,
                    fitness=fitness, update_rule=args.rule,
                    topology=args.topology).resolved()
    if args.kernel and not args.islands and args.variant not in (
            "queue_lock", "async"):
        # only the fused queue-lock kernels exist; queue_lock semantics
        # must not run under a reduction/queue label
        ap.error(f"--kernel implements queue_lock/async, not "
                 f"{args.variant!r}")
    if args.kernel and args.islands and args.variant == "async":
        ap.error("--kernel --islands does not support --variant async; "
                 "drop --kernel (the ring uses the eager async local loop)")
    if args.telemetry and not args.kernel:
        ap.error("--telemetry counts inside the fused CUDA kernels; add "
                 "--kernel (with --variant queue_lock or async)")
    if args.telemetry and args.islands:
        ap.error("--telemetry is single-island; drop --islands")
    from ..kernels import ops, pso_step
    from ..telemetry import trace as tracing
    trace = metrics = tel = None
    if args.trace_out:
        trace = tracing.TraceWriter()
    if args.metrics_out:
        from ..serving import ServingMetrics
        metrics = ServingMetrics()

    def note_chunk(done, n, t_start):
        """Record one solve chunk on the trace / metrics sinks."""
        if trace is None and metrics is None:
            return
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dur_us = (time.perf_counter() - t_start) * 1e6
        if trace is not None:
            trace.complete(f"chunk @{done}", tracing.wall_us(t_start * 1e6),
                           dur_us,
                           process="solver", thread="chunks", cat="solve",
                           args={"iters": n, "variant": args.variant})
        if metrics is not None:
            metrics.observe("chunk_us", dur_us)
            metrics.inc("chunks")

    prof = contextlib.ExitStack()
    if trace is not None:           # the program's spans beside the chunks
        prof.enter_context(tracing.recording(trace))
    if args.profile_dir:
        from ..telemetry import profiler_session
        prof.enter_context(profiler_session(args.profile_dir))
    t0 = time.time()
    if args.islands:
        state = init_sharded_swarm(cfg, args.seed, args.islands, device=dev)
        local_step = None
        if args.kernel:
            local_step = ops.make_fused_local_step(iters_per_call=1)
        runner = make_distributed_run(
            cfg, args.islands, iters=args.iters, variant=args.variant,
            exchange_interval=args.exchange, local_step_fn=local_step,
            sync_every=args.sync_every)
        state = runner(state)
    else:
        state = init_swarm(cfg, args.seed, device=dev)
        if args.kernel:
            if args.variant == "async":
                def step_chunk(st, k):
                    return ops.run_queue_lock_fused_async(
                        cfg, st, iters=k, sync_every=args.sync_every,
                        telemetry=args.telemetry)
            else:
                def step_chunk(st, k):
                    return ops.run_queue_lock_fused(
                        cfg, st, iters=k, telemetry=args.telemetry)
        else:
            def step_chunk(st, k):
                return run(cfg, st, k, args.variant,
                           sync_every=args.sync_every)
        chunk = args.ckpt_every or args.iters
        done = 0
        while done < args.iters:
            n = min(chunk, args.iters - done)
            tc = time.perf_counter()
            if args.telemetry:
                from ..telemetry import KernelCounters
                state, cnt = step_chunk(state, n)
                c = KernelCounters.from_array(cnt)
                tel = c if tel is None else tel + c
            else:
                state = step_chunk(state, n)
            done += n
            note_chunk(done, n, tc)
            if args.ckpt_dir:
                ckpt.save(args.ckpt_dir, done, gather_swarm(state))
    prof.close()
    gf = float(state.gbest_fit)
    dt = time.time() - t0
    extra = ""
    prob = resolve_problem(fitness)
    if prob.constrained:
        viol = prob.violation_at(state.gbest_pos)
        extra = f"violation={viol:.3g}  feasible={viol <= 0.0}  "
    if args.kernel:
        print(f"kernel launches: fused={pso_step.fused.launches}  "
              f"fused_async={pso_step.fused_async.launches}")
    print(f"gbest_fit={gf:.6g}  {extra}iters={args.iters}  "
          f"particles={args.particles}  dim={args.dim}  "
          f"wall={dt:.3f}s  ({1e6*dt/args.iters:.1f} us/iter)")
    if tel is not None:
        d = tel.as_dict()
        print("telemetry: " + "  ".join(f"{k}={v}" for k, v in d.items()))
    if trace is not None:
        trace.write(args.trace_out)
        print(f"trace: {args.trace_out}")
    if metrics is not None:
        with open(args.metrics_out, "w") as f:
            f.write(metrics.prometheus(
                kernel_counters=None if tel is None else tel.as_dict()))
        print(f"metrics: {args.metrics_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
