"""Kernel contention counters: layout + host-side view, the port of
``repro.telemetry.counters``.

The fused and async CUDA kernels (``repro_torch.kernels.pso_step``) take an
optional int32 buffer of ``SLOTS_PER_SWARM`` slots per swarm and add into
it; their plain versions count at the same program points:

    [3*s + 0]  queue_updates       — (iteration, block) pairs whose
                                     intra-block queue was non-empty: some
                                     lane beat the working best (gbest for
                                     the fused kernel, the block-local best
                                     for the async kernel)
    [3*s + 1]  publications        — writes that landed in the shared
                                     gbest: the fused kernel's block key
                                     raised (so queue_updates ==
                                     publications), the async kernel's
                                     chunk-boundary write that won under
                                     the lock
    [3*s + 2]  block_improvements  — (iteration, block) pairs where at
                                     least one particle improved its pbest

The multi-block fused kernel is synchronous PPSO (every block reads the
previous iteration's gbest), so its counts differ from the TPU kernel's
sequential grid by design; with one block they equal
``ref.run_fused_oracle``'s. Counts add up across launches (waves, the async
remainder phase, chunked calls) into the same buffer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch

from .. import _device

#: Slot names, in buffer order.
COUNTER_NAMES = ("queue_updates", "publications", "block_improvements")

#: int32 slots per swarm in the kernel counter buffer.
SLOTS_PER_SWARM = len(COUNTER_NAMES)


def zero_counts(swarms: int = 1, device=None) -> torch.Tensor:
    """Fresh kernel counter buffer: ``[SLOTS_PER_SWARM * swarms]`` int32 on
    ``device`` (``None``: the card)."""
    return torch.zeros(SLOTS_PER_SWARM * swarms, dtype=torch.int32,
                       device=_device.resolve(device))


@dataclass(frozen=True)
class KernelCounters:
    """Host-side view of one swarm's kernel counter slots."""

    queue_updates: int
    publications: int
    block_improvements: int

    @classmethod
    def from_array(cls, arr) -> "KernelCounters":
        """[SLOTS_PER_SWARM] buffer -> one swarm's counters."""
        a = _device.host(arr).reshape(-1)
        if a.shape[0] != SLOTS_PER_SWARM:
            raise ValueError(
                f"expected {SLOTS_PER_SWARM} counter slots, got {a.shape}")
        return cls(*(int(v) for v in a))

    @classmethod
    def rows(cls, arr) -> List["KernelCounters"]:
        """[S * SLOTS_PER_SWARM] or [S, SLOTS_PER_SWARM] -> per-swarm."""
        a = _device.host(arr).reshape(-1, SLOTS_PER_SWARM)
        return [cls(*(int(v) for v in row)) for row in a]

    def as_dict(self) -> Dict[str, int]:
        return {n: getattr(self, n) for n in COUNTER_NAMES}

    def __add__(self, other: "KernelCounters") -> "KernelCounters":
        return KernelCounters(
            self.queue_updates + other.queue_updates,
            self.publications + other.publications,
            self.block_improvements + other.block_improvements)
