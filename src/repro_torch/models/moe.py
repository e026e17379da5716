"""Mixture-of-Experts with top-k routing and capacity-based, gather/scatter
("sort-free") dispatch. The port of ``repro.models.moe``.

Slot indices come from a cumsum over the token→expert one-hot in the
flattened ``[T·k]`` (token, choice) order; tokens are gathered into
``[G, E, C, d]``, the experts run as batched einsums, and the results are
scatter-added back in float32, weighted by the renormalised router probs.
Tokens beyond an expert's capacity are dropped; the Switch-style auxiliary
loss keeps drops rare.

Where the reference is exact about an order, so is this module:

  * ``jax.lax.top_k`` breaks ties by the lower expert index; a stable
    descending sort does too (``torch.topk`` promises no order for ties);
  * the reference writes each (token, choice) into its (expert, slot) cell
    with a scatter whose duplicate writes (a dropped choice's cell is the
    next expert's slot 0) resolve as the last write in the flattened
    order, as XLA's sequential scatter does; ``_route`` resolves them the
    same way, so the same cells hold the same tokens and gates, and only
    the winning writes carry gradient (as JAX's scatter JVP).

The reference's ``policy.constrain`` sharding hints are the identity on one
device and are left out.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .layers import act_fn, dense_init, normal

Params = Dict[str, Any]
Tensor = torch.Tensor


def init_moe(gen, d: int, ff: int, n_experts: int, act: str, dtype,
             lead: Tuple[int, ...] = (), device=None) -> Params:
    scale = d ** -0.5
    p = {
        "router": dense_init(gen, d, n_experts, dtype, 0.02, lead, device),
        "w_in": normal(gen, (*lead, n_experts, d, ff), scale, dtype, device),
        "w_out": normal(gen, (*lead, n_experts, ff, d), ff ** -0.5, dtype,
                        device),
    }
    if act == "silu":
        p["w_gate"] = normal(gen, (*lead, n_experts, d, ff), scale, dtype,
                             device)
    return p


def _capacity(tokens: int, n_experts: int, top_k: int, cf: float) -> int:
    c = int(tokens * top_k * cf / n_experts)
    return max(8, -(-c // 8) * 8)                    # round up to 8


class Routing(NamedTuple):
    """One layer's dispatch: ``src`` [G, E·C] the token in each (expert,
    slot) cell (``g_tok``, the zero pad token, where empty), ``w`` [G, E·C]
    float32 its gate, ``keep`` [G, T·k] whether each (token, choice) got a
    slot, ``aux`` the auxiliary loss, ``cap`` the capacity C."""

    src: Tensor
    w: Tensor
    keep: Tensor
    aux: Tensor
    cap: int


def _top_k(probs: Tensor, k: int):
    """``jax.lax.top_k`` on the last axis: descending, ties by index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _last_write(dest: Tensor, n_slots: int) -> Tensor:
    """For each of ``n_slots`` cells, the position along ``dest``'s last
    axis of the last write to it (-1 where none); writes to ``n_slots``,
    the sentinel, are dropped."""
    order = torch.arange(dest.shape[-1], device=dest.device).expand_as(dest)
    last = torch.full((*dest.shape[:-1], n_slots + 1), -1,
                      dtype=order.dtype, device=dest.device)
    return last.scatter_reduce(-1, dest, order, "amax")[..., :n_slots]


def _route(experts: Tensor, gates: Tensor, n_experts: int, cap: int):
    """Integer routing of every group: (src, w, keep) as in ``Routing``."""
    g, t, k = experts.shape
    flat_e = experts.reshape(g, t * k)
    one_hot = F.one_hot(flat_e, n_experts)
    slot = (torch.cumsum(one_hot, 1) * one_hot - 1).amax(-1)  # [G, T*k]
    keep = slot < cap
    dest = flat_e * cap + torch.where(keep, slot, cap)        # drop: sentinel
    n = n_experts * cap
    last = _last_write(dest, n)
    src = torch.where(last >= 0, last.clamp(min=0) // k, t)  # t: pad token
    w = _slot_gate(torch.where(keep, gates.reshape(g, t * k), 0.0), dest, n)
    return src, w, keep


def dispatch(p: Params, xg: Tensor, *, n_experts: int, top_k: int,
             capacity_factor: float) -> Routing:
    """Routing of grouped tokens ``xg`` [G, T, d]."""
    cap = _capacity(xg.shape[1], n_experts, top_k, capacity_factor)
    logits = (xg @ p["router"]).float()                       # [G, T, E]
    probs = torch.softmax(logits, -1)
    gate_vals, experts = _top_k(probs, top_k)                 # [G, T, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)             # renormalize
    # Load-balancing auxiliary loss (Switch-style).
    me = probs.mean(1)                                        # [G, E]
    ce = F.one_hot(experts[..., 0], n_experts).float().mean(1)
    aux = (me * ce).sum(-1).mean() * n_experts
    src, w, keep = _route(experts, gate_vals, n_experts, cap)
    return Routing(src, w, keep, aux, cap)


def moe_apply(p: Params, x: Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float, act: str, group_tokens: int,
              expert_sharding: str = "tp") -> Tuple[Tensor, Tensor]:
    """x: [B, S, d] -> (out [B, S, d], aux_loss scalar).

    Tokens are processed in groups of ``group_tokens`` (capacity is
    per group). ``expert_sharding`` names the reference's layout hints
    and changes nothing on one device."""
    b, s, d = x.shape
    t_total = b * s
    g_tok = min(group_tokens, t_total)
    if t_total % g_tok:
        raise ValueError(f"{t_total} tokens do not split into groups of "
                         f"{g_tok}")
    n_groups = t_total // g_tok
    xg = x.reshape(n_groups, g_tok, d)
    r = dispatch(p, xg, n_experts=n_experts, top_k=top_k,
                 capacity_factor=capacity_factor)
    xg_pad = torch.cat([xg, xg.new_zeros((n_groups, 1, d))], 1)
    gathered = torch.gather(xg_pad, 1, r.src[..., None].expand(-1, -1, d))
    gathered = gathered.reshape(n_groups, n_experts, r.cap, d)
    h = torch.einsum("gecd,edf->gecf", gathered, p["w_in"])
    if "w_gate" in p:
        h = act_fn(act)(torch.einsum("gecd,edf->gecf", gathered,
                                     p["w_gate"])) * h
    else:
        h = act_fn(act)(h)
    out_ec = torch.einsum("gecf,efd->gecd", h, p["w_out"])
    contrib = (out_ec.reshape(n_groups, n_experts * r.cap, d)
               * r.w[..., None].to(out_ec.dtype))
    out = torch.zeros((n_groups, g_tok + 1, d), dtype=torch.float32,
                      device=x.device)
    out = out.scatter_add(1, r.src[..., None].expand(-1, -1, d),
                          contrib.float())[:, :g_tok]
    return out.to(x.dtype).reshape(b, s, d), r.aux


def _slot_gate(w_flat: Tensor, dest: Tensor, n_slots: int) -> Tensor:
    """Route per-(token, k) gate weights ``w_flat`` [..., T·k] to their
    (expert, slot) cells ``dest``, the last write winning."""
    last = _last_write(dest, n_slots)
    w = w_flat.float().gather(-1, last.clamp(min=0))
    return torch.where(last >= 0, w, 0.0)
