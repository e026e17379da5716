"""The one generator of every cell's traffic: a configuration file (the
swarm: objective, d, n, iterations, coefficients, box, dtype) and a traffic
file (the call: variant, sync interval, topology, callers) become the
``repro_torch.solve`` call a user makes, one solve a seed.

Closed loop, one caller: solve ``k`` of a run takes seed ``base + k``, so
every solve starts from a fresh swarm, as in a seed portfolio, and every
seed gives the same sizes and the same work.
"""
from __future__ import annotations

from typing import Optional

import torch

from pso_bench.spec import Cell, load_module


class Workload:
    """The solve call of ``cell`` on ``device``."""

    def __init__(self, cell: Cell, device: str = "cuda",
                 dtype: Optional[str] = None):
        cfg, tr = cell.config, cell.traffic
        if tr.get("callers", 1) != 1 or tr.get("loop", "closed") != "closed":
            raise ValueError("the generator drives one caller, closed loop")
        self.cell = cell
        dtype = dtype or cfg["dtype"]
        #: The call's sizes, as a kernel's cost file (``costs/*.py``)
        #: plans one solve's launches from them.
        self.call = dict(
            d=int(cfg["dim"]), n=int(cfg["particles"]),
            iters=int(cfg["iters"]), variant=tr["variant"],
            sync_every=int(tr.get("sync_every", 8)),
            block_n=int(cfg["block_n"]),
            esize=torch.empty((), dtype=getattr(torch, dtype)).element_size(),
            objective=cell.objective)
        self.kwargs = dict(
            dim=self.call["d"], particles=self.call["n"],
            iters=self.call["iters"], variant=tr["variant"],
            backend=tr["backend"], sync_every=self.call["sync_every"],
            block_n=self.call["block_n"],
            topology=tr.get("topology", "gbest"), schedule="fixed",
            w=cfg["w"], c1=cfg["c1"], c2=cfg["c2"], dtype=dtype,
            device=device)
        self.problem = load_module("objectives", cell.objective).problem()

    def solve(self, seed: int):
        """One ``repro_torch.solve`` from ``seed``: the timed call."""
        import repro_torch
        return repro_torch.solve(self.problem, seed=seed, **self.kwargs)
