"""Optimizers over parameter trees (dicts, lists and tuples of tensors),
the port of ``repro.optim.optimizers``.

Adam: float32 m/v states. Adafactor: a factored second moment (float32 row
and column vectors for leaves of two or more dims whose last two are >= 2)
and a bfloat16 momentum, with RMS update clipping. Each update is computed
in float32 and cast back to the parameter's dtype, as the reference's.

States mirror the parameter tree. An update writes the new values into the
parameter and state tensors in place (under ``torch.no_grad``), so a
full-width model keeps one copy of each, and returns them with a new
``OptState`` whose ``step`` is an int32 tensor on the parameters' device.
SGD and Adam are elementwise, so they update a large stacked leaf a
leading slice at a time (``_pieces``), which bounds their float32
temporaries without changing a value.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

Params = Any


class OptState(NamedTuple):
    step: torch.Tensor
    inner: Any


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts, lists, tuples), with the
    matching subtrees of ``rest`` (which may go deeper, as an optimizer
    state's per-leaf dicts do)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves``'s order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """``tree``'s structure holding ``leaves`` (in ``tree_leaves``
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


#: Elements of the largest slice an elementwise update takes at once.
_PIECE = 1 << 26


def _pieces(*leaves):
    """Same-index views of ``leaves`` (a parameter, its grad and states):
    runs of leading rows of at most ``_PIECE`` elements, a row split in
    turn where one row alone is larger."""
    lead = leaves[0]
    if lead.dim() < 2 or lead.numel() <= _PIECE:
        yield leaves
        return
    row = lead.numel() // lead.shape[0]
    if row > _PIECE:
        for i in range(lead.shape[0]):
            yield from _pieces(*(t[i] for t in leaves))
        return
    rows = _PIECE // row
    for i in range(0, lead.shape[0], rows):
        yield tuple(t[i:i + rows] for t in leaves)


def _zero_step(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _zeros(p, dtype=torch.float32):
    return torch.zeros_like(p, dtype=dtype)


# ---------------------------------------------------------------------------
# SGD (momentum)
# ---------------------------------------------------------------------------

def sgd_init(params: Params) -> OptState:
    return OptState(_zero_step(params), tree_map(_zeros, params))


@torch.no_grad()
def sgd_update(params, grads, state: OptState, lr, *, momentum=0.9,
               weight_decay=0.0):
    def upd(p, g, m):
        g = g.float() + weight_decay * p.float()
        m.copy_(momentum * m + g)
        p.copy_((p.float() - lr * m).to(p.dtype))

    tree_map(lambda *t: [upd(*x) for x in _pieces(*t)], params, grads,
             state.inner)
    return params, OptState(state.step + 1, state.inner)


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------

def adam_init(params: Params) -> OptState:
    return OptState(_zero_step(params), {"m": tree_map(_zeros, params),
                                         "v": tree_map(_zeros, params)})


@torch.no_grad()
def adam_update(params, grads, state: OptState, lr, *, b1=0.9, b2=0.95,
                eps=1e-8, weight_decay=0.0):
    step = state.step + 1
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float()
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        if weight_decay:
            u = u + weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))

    tree_map(lambda *t: [upd(*x) for x in _pieces(*t)], params, grads,
             state.inner["m"], state.inner["v"])
    return params, OptState(step, state.inner)


# ---------------------------------------------------------------------------
# Adafactor (factored 2nd moment, bf16 momentum)
# ---------------------------------------------------------------------------

def _factored(p) -> bool:
    return p.dim() >= 2 and p.shape[-1] >= 2 and p.shape[-2] >= 2


def adafactor_init(params: Params) -> OptState:
    def state_for(p):
        m = _zeros(p, torch.bfloat16)
        if _factored(p):
            return {"vr": p.new_zeros(p.shape[:-1], dtype=torch.float32),
                    "vc": p.new_zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32),
                    "m": m}
        return {"v": _zeros(p), "m": m}

    return OptState(_zero_step(params), tree_map(state_for, params))


@torch.no_grad()
def adafactor_update(params, grads, state: OptState, lr, *, b2=0.999,
                     b1=0.9, eps=1e-30, clip=1.0, weight_decay=0.0):
    def upd(p, g, s):
        g = g.float()
        g2 = g * g + eps
        if "vr" in s:
            vr = s["vr"].copy_(b2 * s["vr"] + (1 - b2) * g2.mean(-1))
            vc = s["vc"].copy_(b2 * s["vc"] + (1 - b2) * g2.mean(-2))
            denom = torch.sqrt(
                vr[..., None] * vc[..., None, :]
                / torch.clamp(vr.mean(-1, keepdim=True)[..., None], min=eps))
            u = g / torch.clamp(denom, min=eps)
        else:
            v = s["v"].copy_(b2 * s["v"] + (1 - b2) * g2)
            u = g / (torch.sqrt(v) + 1e-8)
        # update clipping (RMS)
        rms = torch.sqrt(torch.mean(u * u) + 1e-12)
        u = u / torch.clamp(rms / clip, min=1.0)
        m = b1 * s["m"].float() + (1 - b1) * u
        if weight_decay:
            m = m + weight_decay * p.float()
        s["m"].copy_(m.to(torch.bfloat16))
        p.copy_((p.float() - lr * m).to(p.dtype))

    tree_map(upd, params, grads, state.inner)
    return params, OptState(state.step + 1, state.inner)


def get_optimizer(name: str) -> Tuple[Callable, Callable]:
    return {"adam": (adam_init, adam_update),
            "adafactor": (adafactor_init, adafactor_update),
            "sgd": (sgd_init, sgd_update)}[name]
