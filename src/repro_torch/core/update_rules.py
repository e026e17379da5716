"""Per-particle update rules, the port of ``repro.core.update_rules``.

A rule's ``advance`` is elementwise and broadcast-clean, so one body serves
the eager engine's ``[N, D]`` arrays (with a ``[1, D]`` or ``[N, D]``
attractor) and the kernels' plain versions on ``[D, N]`` arrays (with a
``[D, 1]`` attractor). The operations run in the reference's order. Every
rule draws two uniforms per (particle, dim) from the streams ``STREAM_R1``
and ``STREAM_R2``; the CUDA kernels carry the same three rules, selected by
``RULE_IDS`` through ``kernel_rule_id``, which refuses any other rule
(``kernel_carries``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class UpdateRule:
    """Frozen spec for one per-particle update rule. ``advance`` returns
    the new ``(pos, vel)``; ``mv``/``lo``/``hi`` are Python floats or
    tensors broadcasting against ``pos``."""

    name: str = "pso"
    #: uniform draws consumed per (particle, dim) per iteration
    rng_draws: int = 2
    #: whether the rule may run on a kernel backend at all; the CUDA
    #: kernels carry only the rules of ``RULE_IDS`` (``kernel_carries``)
    kernel_eligible: bool = True

    def advance(self, r1, r2, pos, vel, pbp, gp, *, w, c1, c2, mv, lo, hi,
                span=None) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def kernel_consts(self) -> Tuple[float, float, float]:
        """The three rule constants the CUDA kernels take as floats."""
        return (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class PSORule(UpdateRule):
    """Canonical inertia-weight PSO — the default rule."""

    def advance(self, r1, r2, pos, vel, pbp, gp, *, w, c1, c2, mv, lo, hi,
                span=None):
        vel = (w * vel + c1 * r1 * (pbp - pos) + c2 * r2 * (gp - pos))
        vel = torch.clamp(vel, -mv, mv)
        pos = torch.clamp(pos + vel, lo, hi)
        return pos, vel


@dataclasses.dataclass(frozen=True)
class SSORule(UpdateRule):
    """Simplified Swarm Optimization (arXiv 2110.01470): copy from gbest
    (``r1 < cg``), pbest (``< cg+cp``), keep (``< cg+cp+cw``), or resample
    uniformly in the box from ``r2``. Velocity passes through. ``span``,
    where given, is the box width ``hi - lo`` as the caller's arithmetic
    takes it (the kernels' plain versions in bfloat16)."""

    cg: float = 0.4
    cp: float = 0.3
    cw: float = 0.2

    def advance(self, r1, r2, pos, vel, pbp, gp, *, w, c1, c2, mv, lo, hi,
                span=None):
        fresh = lo + (hi - lo if span is None else span) * r2
        pos = torch.where(
            r1 < self.cg, gp,
            torch.where(r1 < self.cg + self.cp, pbp,
                        torch.where(r1 < self.cg + self.cp + self.cw, pos,
                                    fresh)))
        pos = torch.clamp(pos, lo, hi)
        return pos, vel

    def kernel_consts(self):
        # The thresholds are summed in Python (double), as the reference's
        # weak-typed constants are, and rounded to float32 by the caller.
        return (self.cg, self.cg + self.cp, self.cg + self.cp + self.cw)


@dataclasses.dataclass(frozen=True)
class LowCostRule(UpdateRule):
    """Low-complexity PSO (arXiv 1401.0546): Bernoulli-selected difference
    terms, no stochastic multiplies."""

    def advance(self, r1, r2, pos, vel, pbp, gp, *, w, c1, c2, mv, lo, hi,
                span=None):
        zero = torch.zeros_like(pos)
        vel = (vel + torch.where(r1 < 0.5, pbp - pos, zero)
               + torch.where(r2 < 0.5, gp - pos, zero))
        vel = torch.clamp(vel, -mv, mv)
        pos = torch.clamp(pos + vel, lo, hi)
        return pos, vel


UPDATE_RULES: Dict[str, UpdateRule] = {
    "pso": PSORule("pso"),
    "sso": SSORule("sso"),
    "lowcost": LowCostRule("lowcost"),
}

#: Stable integer ids for kernel-side selection (the CUDA template index).
RULE_IDS: Dict[str, int] = {"pso": 0, "sso": 1, "lowcost": 2}

#: block-neighborhood topologies of the async variant ("gbest" is the star)
TOPOLOGIES: Tuple[str, ...] = ("gbest", "ring", "vonneumann")


def kernel_carries(rule) -> bool:
    """Whether the CUDA kernels carry a rule (name or instance): a
    kernel-eligible rule of ``RULE_IDS``. A Python ``advance`` cannot run
    inside a CUDA kernel."""
    r = resolve_rule(rule)
    return r.kernel_eligible and r.name in RULE_IDS


def kernel_rule_id(rule) -> int:
    """The CUDA template index of a rule; ``ValueError`` for a rule the
    kernels do not carry."""
    if not kernel_carries(rule):
        raise ValueError(
            f"update rule {resolve_rule(rule).name!r} has no CUDA kernel; "
            f"the kernel backend carries the rules {tuple(RULE_IDS)} — use "
            f"backend='eager'")
    return RULE_IDS[resolve_rule(rule).name]


def rule_names() -> Tuple[str, ...]:
    return tuple(sorted(UPDATE_RULES))


def resolve_rule(rule) -> UpdateRule:
    """Name or instance -> :class:`UpdateRule`."""
    if isinstance(rule, UpdateRule):
        return rule
    got = UPDATE_RULES.get(rule)
    if got is None:
        raise ValueError(
            f"unknown update rule {rule!r}; one of {rule_names()}")
    return got
