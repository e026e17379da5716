"""Particle-block sizing, identical to ``repro.core.blocking``.

The block partition decides the RNG indices of the async variant's blocks
and the CUDA kernels' grid (one CTA per block), so it must be the
reference's exactly. ``LANE`` keeps the reference's preference for
128-aligned blocks, which on Hopper are whole multiples of a warp.
"""
from __future__ import annotations

import warnings

LANE = 128

#: Grid-degeneracy guard: a layout with more than this many blocks (e.g. a
#: prime ``n`` above the target, whose only small divisor is 1) is refused;
#: ``pick_block_n`` then picks the smallest divisor keeping the count under
#: the cap. 256 blocks of 512 threads are also what the fused kernel's
#: cooperative launch can keep resident (2 CTAs on each of 132 SMs).
MAX_BLOCK_COUNT = 256


def pick_block_n(n: int, target: int = 512, lane: int = LANE) -> int:
    """Largest divisor of ``n`` that is <= ``target``, preferring
    ``lane``-aligned ones; capped to at most ``MAX_BLOCK_COUNT`` blocks
    (with a warning), so the result always divides ``n`` but is NOT always
    <= ``target``."""
    best = 1
    for bn in range(min(n, target), 0, -1):
        if n % bn == 0:
            if bn % lane == 0:
                best = bn
                break
            if best == 1:
                best = bn
    if n // best <= MAX_BLOCK_COUNT:
        return best
    floor = -(-n // MAX_BLOCK_COUNT)                 # ceil(n / cap)
    capped = next(b for b in range(floor, n + 1) if n % b == 0)
    warnings.warn(
        f"pick_block_n({n}, target={target}): best dividing block size "
        f"{best} would give {n // best} single-file blocks (> "
        f"{MAX_BLOCK_COUNT}); overriding the target with block_n={capped} "
        f"({n // capped} block(s)). Pad or resize the swarm to a "
        f"composite particle count to keep blocks near the target.",
        stacklevel=2)
    return capped


def default_block_count(n: int, target: int = 512) -> int:
    """Block COUNT for the eager async engine: the largest block size <=
    ``target`` dividing ``n``, alignment-free (``lane=1``), same cap."""
    return n // pick_block_n(n, target, lane=1)
