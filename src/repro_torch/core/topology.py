"""Block-neighbourhood (lbest) topologies of the async variant, ported from
``repro.core.topology``.

With ``PSOConfig(topology="ring")`` or ``"vonneumann"`` a particle block
refreshes its local best from its neighbourhood of block-local bests instead
of the shared gbest, so what the swarm knows spreads hop by hop; the shared
gbest is still flushed at every sync point, for monitoring and the final
answer. ``gbest`` (the paper's star) is handled inline by the engines.

* ``ring``: blocks on a cycle; the neighbourhood of b is {b-1, b, b+1}
  (mod nb).
* ``vonneumann``: blocks on a near-square 2-D torus (``grid_dims``); the
  neighbourhood is the 4-connected stencil and the block itself.

The eager engine folds rolls over the ``[..., nb, D]`` local bests
(``block_neighbor_best``: every block reads the values before the sync);
the kernels fold the same neighbours as reads of the local-best slots
(``kernel_neighbor_ids``; ``csrc/pso_step.cu`` computes the same ids on the
card). Both fold in one order, self first, with a strict ``>``, so on ties
the earlier candidate stays.
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor

#: The topologies whose pull folds neighbours (the ids the kernels take:
#: ``LBEST_IDS[name]``; 0 is the star).
LBEST_IDS = {"ring": 1, "vonneumann": 2}


def _neighborhood_best(fit: Tensor, pos: Tensor, radius: int
                       ) -> Tuple[Tensor, Tensor]:
    """Best (fit, pos) among each slot's ring neighbourhood (itself
    included), over the last axis of ``fit [..., m]`` and the second last of
    ``pos [..., m, D]``."""
    best_fit, best_pos = fit, pos
    for off in range(1, radius + 1):
        for sign in (off, -off):
            f = torch.roll(fit, sign, dims=-1)
            p = torch.roll(pos, sign, dims=-2)
            take = f > best_fit
            best_fit = torch.where(take, f, best_fit)
            best_pos = torch.where(take[..., None], p, best_pos)
    return best_fit, best_pos


def grid_dims(nb: int) -> Tuple[int, int]:
    """Near-square (rows, cols) of ``nb`` blocks for the von Neumann torus:
    rows is the largest divisor of ``nb`` up to its square root, so a prime
    or an ``nb`` below 4 gives a 1 x nb grid."""
    r = d = 1
    while d * d <= nb:
        if nb % d == 0:
            r = d
        d += 1
    return r, nb // r


def _unknown(topology: str) -> ValueError:
    return ValueError(f"unknown lbest topology {topology!r}; one of "
                      f"{tuple(LBEST_IDS)}")


def block_neighbor_best(lbf: Tensor, lbp: Tensor, topology: str
                        ) -> Tuple[Tensor, Tensor]:
    """The neighbourhood maximum of the block-local bests: ``(lbp', lbf')``.

    ``lbf [..., nb]`` / ``lbp [..., nb, D]`` (leading axes: a batch of
    swarms); each slot becomes the best over its ``topology``
    neighbourhood, itself included, so a local best never falls. Every slot
    reads the values before the call."""
    if topology == "ring":
        bf, bp = _neighborhood_best(lbf, lbp, radius=1)
        return bp, bf
    if topology == "vonneumann":
        nb, d = lbp.shape[-2:]
        lead = lbf.shape[:-1]
        rows, cols = grid_dims(nb)
        f = lbf.reshape(*lead, rows, cols)
        p = lbp.reshape(*lead, rows, cols, d)
        best_f, best_p = f, p
        for axis in (-2, -1):              # rows, then columns
            for shift in (1, -1):
                ff = torch.roll(f, shift, dims=axis)
                pp = torch.roll(p, shift, dims=axis - 1)
                take = ff > best_f
                best_f = torch.where(take, ff, best_f)
                best_p = torch.where(take[..., None], pp, best_p)
        return best_p.reshape(*lead, nb, d), best_f.reshape(*lead, nb)
    raise _unknown(topology)


def kernel_neighbor_ids(b: int, nb: int, topology: str) -> Tuple[int, ...]:
    """The neighbour block ids of block ``b`` (itself excluded, though a
    small ``nb`` may repeat it) in the order every engine folds them:
    ring b-1, b+1; von Neumann the row above, below, the column left,
    right."""
    if topology == "ring":
        return ((b + nb - 1) % nb, (b + 1) % nb)
    if topology == "vonneumann":
        rows, cols = grid_dims(nb)
        r, c = b // cols, b % cols
        return (((r + rows - 1) % rows) * cols + c,
                ((r + 1) % rows) * cols + c,
                r * cols + (c + cols - 1) % cols,
                r * cols + (c + 1) % cols)
    raise _unknown(topology)
