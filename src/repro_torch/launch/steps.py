"""Train and serve step builders of the LM substrate (the port of
``repro.launch.steps``).

The prefill and serve steps run without autograd, so the GLA engine of
``models/ssm.py`` takes the CUDA kernel path on the card. The train step
records autograd, so the SSD and mLSTM heads take the plain chunked
engine, differentiated by autograd, as the reference trains through
``gla_chunked``'s autodiff (its GLA kernel is forward only)."""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..configs.base import ArchConfig
from ..models import zoo
from ..optim import get_optimizer
from ..optim.optimizers import _pieces, tree_leaves, tree_map, \
    tree_unflatten
from ..optim.schedules import cosine_schedule


def make_train_step(cfg: ArchConfig, base_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10000
                    ) -> Tuple[Callable, Callable]:
    """Returns (train_step, opt_init). train_step: (params, opt_state,
    batch) -> (params, opt_state, {"loss", "grad_norm"}), both float32
    0-d tensors. The batch holds tensors on the parameters' device; the
    parameters and the optimizer state are updated in place and returned
    (``optim.optimizers``). The grad norm sums each leaf's squares a
    leading slice at a time (``optimizers._pieces``), so a stacked leaf of
    a full-width model makes no float32 copy of its whole size; a leaf of
    at most ``_PIECE`` elements is one sum, as before."""
    opt_init, opt_update = get_optimizer(cfg.optimizer)

    def train_step(params, opt_state, batch):
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss = zoo.loss_fn(cfg, live, batch)
            grads = torch.autograd.grad(loss, tree_leaves(live),
                                        allow_unused=True,
                                        materialize_grads=True)
        grads = tree_unflatten(params, grads)
        lr = cosine_schedule(opt_state.step, base_lr, warmup, total_steps)
        params, opt_state = opt_update(params, grads, opt_state, lr)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(x.float()))
                               for g in tree_leaves(grads)
                               for (x,) in _pieces(g)))
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step, opt_init


def make_prefill_step(cfg: ArchConfig) -> Callable:
    """Forward-only loss evaluation at prefill shapes (the throughput proxy
    for inference prefill; cache write-back excluded):
    (params, batch) -> loss."""
    def prefill_step(params, batch):
        with torch.no_grad():
            return zoo.loss_fn(cfg, params, batch)

    return prefill_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    """One-token decode: (params, cache, cache_len, token) -> (logits,
    cache), the cache written in place."""
    def serve_step(params, cache, cache_len, token):
        with torch.no_grad():
            return zoo.decode_fn(cfg, params, cache, cache_len, token)

    return serve_step
