"""Gradient-free PSO as an optimizer over model parameters, the port of
``repro.optim.pso_optimizer``: the paper's algorithm with the ergonomics of
Adam/SGD.

Each particle is a full parameter vector; fitness = −loss on the current
batch. Viable for small parameter counts (probes, heads, adapters,
neuroevolution demos): population × parameters memory makes it no
replacement for gradient training of the large archs.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.func import vmap

from ..core import rng as crng
from ..core.pso import (STEP_FNS, STREAM_R1, STREAM_R2, PSOConfig,
                        init_swarm)
from .optimizers import tree_leaves, tree_unflatten


class PSOOptimizer:
    """Flattens a parameter tree into the swarm's position space (leaves in
    ``jax.tree.leaves``'s order, so each parameter takes the reference's
    coordinates and random draws) and runs the queue-variant PSO steps
    against a user loss, on the template's device (the card unless the
    template's tensors lie on the CPU).

    The loss is evaluated over the whole population at once with
    ``torch.func.vmap``, the counterpart of ``jax.vmap``: it must be
    written in torch ops on its argument. Like ``jax.vmap`` with a host
    call, ``vmap`` raises (a ``RuntimeError``) on ``.item()``, ``float()``
    or data-dependent Python control flow, and on in-place writes into
    its argument; nothing falls back to a loop over particles.
    """

    def __init__(self, params_template: Any, particles: int = 32,
                 span: float = 1.0, w: float = 0.72, c1: float = 1.49,
                 c2: float = 1.49, variant: str = "queue", seed: int = 0):
        leaves = tree_leaves(params_template)
        self.template = params_template
        self.shapes = [tuple(l.shape) for l in leaves]
        self.sizes = [l.numel() for l in leaves]
        self.dtypes = [l.dtype for l in leaves]
        device = leaves[0].device
        self.cfg = PSOConfig(dim=sum(self.sizes), particle_cnt=particles,
                             w=w, c1=c1, c2=c2, fitness="sphere",
                             min_pos=-span, max_pos=span,
                             max_v=0.25 * span).resolved()
        self.step_fn = STEP_FNS[variant]
        s = init_swarm(self.cfg, seed, device=device)
        # center the swarm on the provided template
        center = self._flatten(params_template)
        self.state = s._replace(pos=s.pos * 0.1 + center[None, :],
                                pbest_pos=s.pbest_pos * 0.1 + center[None, :],
                                gbest_pos=center)

    def _flatten(self, params) -> torch.Tensor:
        return torch.cat([l.float().reshape(-1)
                          for l in tree_leaves(params)])

    def unflatten(self, vec: torch.Tensor) -> Any:
        leaves, off = [], 0
        for shape, size, dt in zip(self.shapes, self.sizes, self.dtypes):
            leaves.append(vec[off:off + size].reshape(shape).to(dt))
            off += size
        return tree_unflatten(self.template, leaves)

    def step(self, loss_fn: Callable[[Any], torch.Tensor]) -> float:
        """Evaluate the population, update the swarm. Returns best loss.

        The user loss is evaluated, the pbest/gbest updates applied with
        the queue predicate, and positions advanced WITHOUT re-evaluating
        any internal fitness (Alg. 1 step 2 only)."""
        fits = -vmap(lambda v: loss_fn(self.unflatten(v)))(self.state.pos)
        s = self.state._replace(fit=fits)
        improved = fits > s.pbest_fit
        pbest_fit = torch.where(improved, fits, s.pbest_fit)
        pbest_pos = torch.where(improved[:, None], s.pos, s.pbest_pos)
        if bool(torch.any(fits > s.gbest_fit)):     # queue predicate (§4.1)
            best = torch.argmax(pbest_fit)
            s = s._replace(gbest_fit=pbest_fit[best],
                           gbest_pos=pbest_pos[best])
        s = s._replace(pbest_fit=pbest_fit, pbest_pos=pbest_pos)
        cfg = self.cfg
        n, d = s.pos.shape
        it = s.iteration + 1
        idx = torch.arange(n * d, device=s.pos.device).reshape(n, d)
        r1 = crng.uniform(s.seed, it, STREAM_R1, idx, dtype=s.pos.dtype)
        r2 = crng.uniform(s.seed, it, STREAM_R2, idx, dtype=s.pos.dtype)
        vel = (cfg.w * s.vel + cfg.c1 * r1 * (s.pbest_pos - s.pos)
               + cfg.c2 * r2 * (s.gbest_pos[None] - s.pos))
        vel = torch.clamp(vel, -cfg.max_v, cfg.max_v)
        pos = torch.clamp(s.pos + vel, cfg.min_pos, cfg.max_pos)
        self.state = s._replace(pos=pos, vel=vel, iteration=it)
        return float(-self.state.gbest_fit)

    @property
    def best_params(self):
        return self.unflatten(self.state.gbest_pos)
