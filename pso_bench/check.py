"""The comparison that decides ``correct``: the solves a run sampled, as the
timed path returned them, against the plain reference (``reference.py``)
run from the same seeds, after the window.

The numbers compared are those the cell's limits file
(``limits/<cell>.json``) names, each beside its limit; each number is a
file ``numbers/<name>.py`` whose ``value(prog, ref, ctx)`` reads one solve
of the program (``sample_of``) against the reference's solve from the same
seed (``ctx``: the configuration and the objective's module). A run's
number is the worst over its sampled solves.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from pso_bench.reference import Reference, Swarms
from pso_bench.spec import load_module

#: The program's state a sample keeps, each as float32 on the host.
STATE = ("pos", "vel", "pbest_pos", "pbest_fit")


def sample_of(seed: int, result) -> dict:
    """What the check keeps of one solve's ``Result``, on the host: the
    best the user reads and the final state."""
    st = result.state
    out = {k: getattr(st, k).detach().float().cpu() for k in STATE}
    out.update(seed=int(seed), best_fit=float(result.best_fit),
               best_pos=torch.as_tensor(result.best_pos).float().cpu())
    return out


def sample_of_reference(seed: int, s: Swarms, j: int) -> dict:
    """Swarm ``j`` of the reference's ``s`` in ``sample_of``'s form, where
    a reference takes the program's place (the control's faults)."""
    out = {k: getattr(s, k)[j].float().cpu() for k in STATE}
    out.update(seed=int(seed), best_fit=float(s.gbest_fit[j]),
               best_pos=s.gbest_pos[j].float().cpu())
    return out


def reference_run(cell, samples: Sequence[dict], device) -> Swarms:
    """The reference's solves of ``samples``' seeds, all at once."""
    ref = Reference(cell.config, cell.objective, device)
    return ref.run([s["seed"] for s in samples], int(cell.config["iters"]),
                   cell.traffic)


def compare(cell, samples: Sequence[dict], out: Swarms, device
            ) -> Dict[str, float]:
    """The cell's numbers over ``samples`` against the reference's ``out``
    (swarm ``j`` from ``samples[j]``'s seed)."""
    ctx = {"config": cell.config,
           "objective": load_module("objectives", cell.objective)}
    values = {}
    for name in cell.limits:
        fn = load_module("numbers", name).value
        per = []
        for j, s in enumerate(samples):
            prog = {k: (v.to(device) if torch.is_tensor(v) else v)
                    for k, v in s.items()}
            ref = {k: getattr(out, k)[j] for k in STATE + (
                "gbest_fit", "gbest_pos")}
            per.append(float(fn(prog, ref, ctx)))
        # max keeps no NaN, so a NaN anywhere is the number
        values[name] = next((v for v in per if v != v), max(per))
    return values


def run_check(workload, samples: Sequence[dict], device) -> Dict[str, float]:
    """The cell's numbers over ``samples`` (``sample_of``'s) of
    ``workload``'s solves, the reference run on ``device``."""
    cell = workload.cell
    if not samples:                       # no solve completed: nothing holds
        return {k: float("nan") for k in cell.limits}
    out = reference_run(cell, samples, device)
    return compare(cell, samples, out, device)


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a NaN fails)."""
    return all(values[k] <= limits[k] for k in limits)


def report(values: Dict[str, float], limits: Dict[str, float]) -> dict:
    """Each number beside its limit, as the result's line carries them."""
    return {k: {"value": values[k], "limit": limits[k]} for k in limits}
