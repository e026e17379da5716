"""Uniform model API over the ported families. The port of
``repro.models.zoo``:

  init_params(cfg, generator, device)   -> params tree
  loss_fn(cfg, params, batch)           -> scalar loss
  decode_fn(cfg, params, cache, n, tok) -> (logits, cache)
  init_cache(cfg, batch, max_len)       -> cache tree
  input_specs(cfg, shape_name)          -> dict of TensorSpec
  abstract_params(cfg)                  -> params tree on the meta device
  abstract_cache(cfg, shape_name)       -> cache tree on the meta device
  make_batch(cfg, shape_name, b, s, g)  -> a random batch

Every entry point that makes tensors puts them on ``device``, the card when
it is ``None``. The two ``abstract_*`` trees (the reference's
``jax.eval_shape`` stand-ins) are meta tensors: shapes and dtypes, no
storage, at any size.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .. import _device
from ..configs.base import SHAPES, ArchConfig
from . import encdec, transformer

Params = Dict[str, Any]

#: The encoder context of the enc-dec family's cross cache (the stub
#: frontend's 1500 frames, whisper's 30 s window).
ENC_LEN = 1500


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator],
                device=None) -> Params:
    if cfg.encdec:
        return encdec.init_params(cfg, generator, device)
    return transformer.init_params(cfg, generator, device)


def abstract_params(cfg: ArchConfig) -> Params:
    """Shape-only params for the dry run (no allocation)."""
    return init_params(cfg, None, device="meta")


def loss_fn(cfg: ArchConfig, params: Params, batch):
    if cfg.encdec:
        return encdec.loss_fn(cfg, params, batch)
    return transformer.loss_fn(cfg, params, batch)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    if cfg.encdec:
        return encdec.init_cache(cfg, batch, max_len, ENC_LEN, device)
    return transformer.init_cache(cfg, batch, max_len, device)


def decode_fn(cfg: ArchConfig, params: Params, cache, cache_len, token):
    if cfg.encdec:
        return encdec.decode_step(cfg, params, cache, cache_len, token)
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


def abstract_cache(cfg: ArchConfig, shape_name: str) -> Params:
    """Shape-only decode cache of one shape cell (no allocation)."""
    cell = SHAPES[shape_name]
    return init_cache(cfg, cell.global_batch, cell.seq_len, device="meta")


def make_batch(cfg: ArchConfig, shape_name: str, batch: int, seq: int,
               generator: torch.Generator, device=None) -> Dict[str, Any]:
    """A random batch for smoke runs (reduced sizes), drawn with
    ``generator`` on ``device`` (``None``: the card; ``generator`` must
    draw there)."""
    cell = SHAPES[shape_name]
    device = _device.resolve_for(generator, device)
    dt = getattr(torch, cfg.param_dtype)

    def ints(*shape):                      # int32, as the reference's
        return torch.randint(0, cfg.vocab, shape, generator=generator,
                             device=device, dtype=torch.int32)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device).to(dt)

    if cell.kind in ("train", "prefill"):
        if cfg.encdec:
            return {"frames": normal(batch, seq, cfg.d_model),
                    "tokens": ints(batch, seq), "labels": ints(batch, seq)}
        if cfg.vision_prefix:
            st = max(seq - cfg.vision_prefix, 8)
            tokens = ints(batch, st)
            return {"vision_embeds": normal(batch, cfg.vision_prefix,
                                            cfg.d_model),
                    "tokens": tokens, "labels": ints(batch, st)}
        return {"tokens": ints(batch, seq), "labels": ints(batch, seq)}
    return {"token": ints(batch, 1), "cache_len": seq - 1}
