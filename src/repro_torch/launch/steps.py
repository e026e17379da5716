"""Serve step builders of the LM substrate (the port of
``repro.launch.steps``). The steps run without autograd, so the GLA
engine of ``models/ssm.py`` takes the CUDA kernel path on the card."""
from __future__ import annotations

from typing import Callable

import torch

from ..configs.base import ArchConfig
from ..models import transformer, zoo


def make_train_step(cfg: ArchConfig, *args, **kwargs):
    """Not ported yet: it needs the optimizers and schedules."""
    raise NotImplementedError(
        f"{cfg.name}: make_train_step is not ported yet: "
        + transformer.NOT_PORTED.format(
            what="optim/, launch/train.py, make_train_step"))


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
