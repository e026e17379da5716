"""Uniform model API over the ported families. The port of
``repro.models.zoo``:

  init_params(cfg, generator, device)   -> params tree
  loss_fn(cfg, params, batch)           -> scalar loss
  decode_fn(cfg, params, cache, n, tok) -> (logits, cache)
  init_cache(cfg, batch, max_len)       -> cache tree
  input_specs(cfg, shape_name)          -> dict of TensorSpec
  make_batch(cfg, shape_name, b, s, g)  -> a random batch

The enc-dec family (whisper) belongs to the training part of the LM
substrate and raises.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..configs.base import SHAPES, ArchConfig
from . import transformer

Params = Dict[str, Any]


def _no_encdec(cfg: ArchConfig) -> None:
    if cfg.encdec:
        raise NotImplementedError(
            f"{cfg.name}: the enc-dec family is not ported yet: "
            + transformer.NOT_PORTED.format(what="models/encdec.py"))


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> Params:
    _no_encdec(cfg)
    return transformer.init_params(cfg, generator, device)


def loss_fn(cfg: ArchConfig, params: Params, batch):
    _no_encdec(cfg)
    return transformer.loss_fn(cfg, params, batch)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    _no_encdec(cfg)
    return transformer.init_cache(cfg, batch, max_len, device)


def decode_fn(cfg: ArchConfig, params: Params, cache, cache_len, token):
    _no_encdec(cfg)
    return transformer.decode_step(cfg, params, cache, cache_len, token)


class TensorSpec(NamedTuple):
    """A model input's shape and dtype (never allocated)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ArchConfig, shape_name: str,
                override_batch: int = 0) -> Dict[str, TensorSpec]:
    """Model inputs for one shape cell, as the reference's
    ``ShapeDtypeStruct`` stand-ins (int32 tokens)."""
    cell = SHAPES[shape_name]
    b = override_batch or cell.global_batch
    s = cell.seq_len
    i32 = torch.int32
    dt = getattr(torch, cfg.param_dtype)
    if cell.kind in ("train", "prefill"):
        if cfg.encdec:
            return {"frames": TensorSpec((b, s, cfg.d_model), dt),
                    "tokens": TensorSpec((b, s), i32),
                    "labels": TensorSpec((b, s), i32)}
        if cfg.vision_prefix:
            st = s - cfg.vision_prefix
            return {"vision_embeds": TensorSpec(
                        (b, cfg.vision_prefix, cfg.d_model), dt),
                    "tokens": TensorSpec((b, st), i32),
                    "labels": TensorSpec((b, st), i32)}
        return {"tokens": TensorSpec((b, s), i32),
                "labels": TensorSpec((b, s), i32)}
    # decode: one new token against a cache of length s
    return {"token": TensorSpec((b, 1), i32),
            "cache_len": TensorSpec((), i32)}


def make_batch(cfg: ArchConfig, shape_name: str, batch: int, seq: int,
               generator: torch.Generator, device=None) -> Dict[str, Any]:
    """A random batch for smoke runs (reduced sizes), drawn with
    ``generator`` on ``device`` (the generator's own by default)."""
    _no_encdec(cfg)
    cell = SHAPES[shape_name]
    device = device if device is not None else generator.device
    dt = getattr(torch, cfg.param_dtype)

    def ints(*shape):
        return torch.randint(0, cfg.vocab, shape, generator=generator,
                             device=device)

    if cell.kind in ("train", "prefill"):
        if cfg.vision_prefix:
            st = max(seq - cfg.vision_prefix, 8)
            tokens = ints(batch, st)
            return {"vision_embeds": torch.randn(
                        (batch, cfg.vision_prefix, cfg.d_model),
                        generator=generator, device=device).to(dt),
                    "tokens": tokens, "labels": ints(batch, st)}
        return {"tokens": ints(batch, seq), "labels": ints(batch, seq)}
    return {"token": ints(batch, 1), "cache_len": seq - 1}
