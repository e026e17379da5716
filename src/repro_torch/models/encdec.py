"""Encoder-decoder backbone (whisper-small), the port of
``repro.models.encdec``. The conv audio frontend is a stub, as in the
reference: the encoder consumes precomputed frame embeddings [B, S_enc, d]
(``zoo.input_specs``). Encoder: bidirectional self-attention with RoPE.
Decoder: causal self-attention plus cross-attention to the encoder output;
decode keeps a self KV cache and a cross KV cache (``xk``/``xv``), both
written in place. Layers run under ``transformer._remat``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch

from .. import _device
from ..configs.base import ArchConfig
from . import attention as attn
from .layers import (apply_rope, chunked_xent, dense_init, embed_init,
                     init_mlp, mlp, rmsnorm, rmsnorm_init)
from .transformer import _dtype, _remat, _take

Params = Dict[str, Any]
Tensor = torch.Tensor


def _init_enc_layer(cfg: ArchConfig, gen, lead, device) -> Params:
    dt = _dtype(cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    kw = dict(lead=lead, device=device)
    return {"ln1": rmsnorm_init(d, dt, **kw),
            "attn": attn.init_gqa(gen, d, cfg.n_heads, cfg.n_kv_heads, hd,
                                  False, dt, **kw),
            "ln2": rmsnorm_init(d, dt, **kw),
            "mlp": init_mlp(gen, d, cfg.d_ff, cfg.act, dt, **kw)}


def _init_dec_layer(cfg: ArchConfig, gen, lead, device) -> Params:
    dt = _dtype(cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    kw = dict(lead=lead, device=device)
    return {"ln1": rmsnorm_init(d, dt, **kw),
            "self_attn": attn.init_gqa(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                       hd, False, dt, **kw),
            "ln_x": rmsnorm_init(d, dt, **kw),
            "cross_attn": attn.init_gqa(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                        hd, False, dt, **kw),
            "ln2": rmsnorm_init(d, dt, **kw),
            "mlp": init_mlp(gen, d, cfg.d_ff, cfg.act, dt, **kw)}


def init_params(cfg: ArchConfig, gen: Optional[torch.Generator],
                device=None) -> Params:
    """The reference's tree, leaf for leaf, drawn with ``gen`` on
    ``device`` (``None``: the card; as ``transformer.init_params``)."""
    device = _device.resolve_for(gen, device)
    dt = _dtype(cfg)
    return {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, dt, device),
        "enc_layers": _init_enc_layer(cfg, gen, (cfg.enc_layers,), device),
        "dec_layers": _init_dec_layer(cfg, gen, (cfg.n_layers,), device),
        "enc_norm": rmsnorm_init(cfg.d_model, dt, device=device),
        "final_norm": rmsnorm_init(cfg.d_model, dt, device=device),
        "unembed": dense_init(gen, cfg.d_model, cfg.vocab, dt, device=device),
    }


def _kw(cfg: ArchConfig):
    return dict(h=cfg.n_heads, kh=cfg.n_kv_heads, hd=cfg.resolved_head_dim,
                theta=cfg.rope_theta)


def _positions(b: int, s: int, device) -> Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def _enc_layer(cfg: ArchConfig, lp: Params, x, positions):
    b, s, _ = x.shape
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.gqa_project(lp["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                               cfg.resolved_head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    a = attn.flash_attention(q, k, v, causal=False, q_block=cfg.attn_q_block,
                             kv_block=cfg.attn_kv_block)
    x = x + a.reshape(b, s, -1) @ lp["attn"]["wo"]
    return x + mlp(lp["mlp"], rmsnorm(lp["ln2"], x, cfg.norm_eps), cfg.act)


def encode(cfg: ArchConfig, params: Params, frames: Tensor) -> Tensor:
    """frames: [B, S_enc, d] (stub embeddings). Bidirectional encoder."""
    b, s, _ = frames.shape
    positions = _positions(b, s, frames.device)
    x = frames.to(_dtype(cfg))
    layer = _remat(functools.partial(_enc_layer, cfg), cfg.remat)
    for i in range(cfg.enc_layers):
        x = layer(_take(params["enc_layers"], i), x, positions)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _cross_attend(cfg: ArchConfig, lp: Params, x, enc_kv):
    """x: [B, St, d]; enc_kv: (k, v) [B, Se, K, hd]."""
    b, st, _ = x.shape
    h = rmsnorm(lp["ln_x"], x, cfg.norm_eps)
    q = (h @ lp["cross_attn"]["wq"]).reshape(
        b, st, cfg.n_heads, cfg.resolved_head_dim)
    out = attn.flash_attention(q, enc_kv[0], enc_kv[1], causal=False,
                               q_block=cfg.attn_q_block,
                               kv_block=cfg.attn_kv_block)
    return out.reshape(b, st, -1) @ lp["cross_attn"]["wo"]


def _enc_kv(cfg: ArchConfig, lp: Params, enc_out):
    """One decoder layer's cross keys and values [B, Se, K, hd]."""
    b, se, _ = enc_out.shape
    shape = (b, se, cfg.n_kv_heads, cfg.resolved_head_dim)
    return ((enc_out @ lp["cross_attn"]["wk"]).reshape(shape),
            (enc_out @ lp["cross_attn"]["wv"]).reshape(shape))


def _dec_layer(cfg: ArchConfig, lp: Params, x, positions, enc_out):
    a = attn.gqa_forward(lp["self_attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps),
                         positions, **_kw(cfg), q_block=cfg.attn_q_block,
                         kv_block=cfg.attn_kv_block)
    x = x + a
    x = x + _cross_attend(cfg, lp, x, _enc_kv(cfg, lp, enc_out))
    return x + mlp(lp["mlp"], rmsnorm(lp["ln2"], x, cfg.norm_eps), cfg.act)


def decode_train(cfg: ArchConfig, params: Params, tokens: Tensor,
                 enc_out: Tensor) -> Tensor:
    """Teacher-forced decoder forward. Returns final hidden [B, St, d]."""
    b, st = tokens.shape
    x = params["embed"][tokens]
    positions = _positions(b, st, x.device)
    layer = _remat(functools.partial(_dec_layer, cfg), cfg.remat)
    for i in range(cfg.n_layers):
        x = layer(_take(params["dec_layers"], i), x, positions, enc_out)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def loss_fn(cfg: ArchConfig, params: Params, batch) -> Tensor:
    enc = encode(cfg, params, batch["frames"])
    h = decode_train(cfg, params, batch["tokens"], enc)
    return chunked_xent(h, params["unembed"], batch["labels"],
                        cfg.loss_chunk, pad_vocab=cfg.pad_vocab)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, enc_len: int,
               device=None) -> Params:
    """Self and cross KV caches, on ``device`` (``None``: the card)."""
    device = _device.resolve(device)
    dt = _dtype(cfg)
    hd = cfg.resolved_head_dim
    L = cfg.n_layers

    def zeros(s):
        return torch.zeros((L, batch, s, cfg.n_kv_heads, hd), dtype=dt,
                           device=device)

    return {"k": zeros(max_len), "v": zeros(max_len),
            "xk": zeros(enc_len), "xv": zeros(enc_len)}


def decode_step(cfg: ArchConfig, params: Params, cache: Params, cache_len,
                token: Tensor):
    """One decoder token; the cross KV already lives in the cache. Returns
    (logits [B, V] float32, cache), the self cache written in place."""
    cache_len = int(cache_len)
    x = params["embed"][token]                        # [B, 1, d]
    b = x.shape[0]
    for i in range(cfg.n_layers):
        lp, cl = _take(params["dec_layers"], i), _take(cache, i)
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        a, _ = attn.gqa_decode(lp["self_attn"], h, cl, cache_len, **_kw(cfg))
        x = x + a
        hx = rmsnorm(lp["ln_x"], x, cfg.norm_eps)
        q = (hx @ lp["cross_attn"]["wq"]).reshape(
            b, 1, cfg.n_heads, cfg.resolved_head_dim)
        xa = attn.decode_attention(q, cl["xk"], cl["xv"], cl["xk"].shape[1])
        x = x + xa.reshape(b, 1, -1) @ lp["cross_attn"]["wo"]
        x = x + mlp(lp["mlp"], rmsnorm(lp["ln2"], x, cfg.norm_eps), cfg.act)
    return (x[:, 0] @ params["unembed"]).float(), cache
