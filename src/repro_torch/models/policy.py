"""Activation-sharding policy, the port of ``repro.models.policy``.

The reference pins intermediates to the Megatron-style tensor-parallel
layout with ``jax.lax.with_sharding_constraint`` so that XLA reshards the
(small) weights rather than the (huge) activations. The policy is set
(module-global) by a launcher before tracing; unset, every hook is the
identity. Constraints are divisibility-guarded: an axis is applied only
when the dim divides the mesh extent, so archs with awkward head counts
(qwen2: 28 heads, hymba: 25) degrade gracefully.

The port runs on one card, and its models do not call ``constrain``:
there is nothing to reshard. ``activation_spec`` is the reference's spec
as a pure function of (shape, layout, mesh), so the layout can be checked
against the reference's and reused by a multi-card launcher.
``constrain`` returns ``x`` itself: with no policy or a mesh of one
device as the reference does, and on a larger mesh too, since an eager
tensor carries no sharding for a constraint to pin.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

from ..launch.sharding import P

_POLICY: dict = {"mesh": None, "dp": None, "tp": None}


def set_policy(mesh, dp=None, tp: Optional[str] = None):
    _POLICY.update(mesh=mesh, dp=dp, tp=tp)


@contextlib.contextmanager
def activation_policy(mesh, dp, tp: str):
    prev = dict(_POLICY)
    set_policy(mesh, dp, tp)
    try:
        yield
    finally:
        _POLICY.update(prev)


def _axes_size(mesh, ax) -> int:
    if ax is None:
        return 1
    if isinstance(ax, tuple):
        n = 1
        for a in ax:
            n *= mesh.shape[a]
        return n
    return mesh.shape[ax]


def activation_spec(shape: Sequence[int], layout: Tuple[Optional[str], ...],
                    mesh, dp, tp) -> P:
    """The spec ``constrain`` applies to an array of ``shape``: layout
    entries "dp" (batch axes), "tp" (model axis) or None, each kept only
    where the dim divides the extent of its mesh axes."""
    spec = []
    for dim, tag in zip(shape, layout):
        ax = {"dp": dp, "tp": tp, None: None}[tag]
        if ax is not None and dim % _axes_size(mesh, ax) == 0:
            spec.append(ax)
        else:
            spec.append(None)
    return P(*spec)


def constrain(x, layout: Tuple[Optional[str], ...]):
    """``x`` itself (module docstring); ``activation_spec(x.shape, layout,
    mesh, dp, tp)`` is the spec the reference would apply."""
    return x
