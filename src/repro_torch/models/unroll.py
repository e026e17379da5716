"""Inner-scan unroll switch, the port of ``repro.models.unroll``.

The reference's piecewise analyzer lowers single pieces with inner
``lax.scan``s unrolled, because XLA's ``cost_analysis`` counts a scan body
once. In eager torch there is no scan to lower: ``maybe_scan`` is always a
Python loop, in either mode, and gives the reference's results for the same
body. The ``unrolled()`` switch keeps its state and meaning for code
written against the reference; nothing in the port reads it, since the
port's piecewise count (``repro_torch.roofline.piecewise``) traces eager
ops and has no scan body to unroll.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils import _pytree as pytree

_STATE = {"unroll": False}


def is_unrolled() -> bool:
    return _STATE["unroll"]


@contextlib.contextmanager
def unrolled(on: bool = True):
    prev = _STATE["unroll"]
    _STATE["unroll"] = on
    try:
        yield
    finally:
        _STATE["unroll"] = prev


def maybe_scan(body, carry, xs, length=None):
    """``lax.scan``'s contract as a Python loop: ``body(carry, x_i) ->
    (carry, y_i)`` over the leading axis of every leaf of ``xs`` (a tree
    of stacked tensors, or None with ``length``). Returns ``(carry,
    ys)``, each leaf of ``ys`` the ``y_i`` stacked on a new leading axis
    (None when the body returns None or runs no step)."""
    n = length if xs is None else pytree.tree_leaves(xs)[0].shape[0]
    ys = []
    for i in range(int(n)):
        xi = None if xs is None else pytree.tree_map(lambda a: a[i], xs)
        carry, y = body(carry, xi)
        ys.append(y)
    if ys and ys[0] is not None:
        flat = [pytree.tree_flatten(y)[0] for y in ys]
        spec = pytree.tree_flatten(ys[0])[1]
        stacked = pytree.tree_unflatten(
            [torch.stack(leaves) for leaves in zip(*flat)], spec)
    else:
        stacked = None
    return carry, stacked
