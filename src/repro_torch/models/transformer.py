"""Decoder-only LM assembly for all non-enc-dec families. The port of
``repro.models.transformer``.

Parameters keep the reference's layout, leaf for leaf: per-layer tensors
are stacked on a leading [L, ...] axis (hymba: ``layers/global`` and
``layers/swa``; xLSTM: ``layers/m`` [groups, group - 1, ...] and
``layers/s`` [groups, ...]). The reference scans over those stacks; here
the forward loops over the layers in order, taking each layer's slice.
Structure:

  * hymba    — SWA layers in runs around the global-attention layers
               (exact interleave, ``_hymba_segments``), 128 meta tokens
               prepended;
  * xlstm    — groups of (slstm_group-1 mLSTM + 1 sLSTM);
  * moe      — every layer a top-k MoE FFN (``models/moe.py``), arctic's
               with a parallel dense FFN (``dense_residual``).

Remat (``cfg.remat``), where autograd records: "full" runs each layer
under ``torch.utils.checkpoint`` (non-reentrant, so the layer's recompute
runs with autograd on, like its first forward, and the GLA engine takes
the same plain route both times); "dots" saves the matmul outputs and
recomputes the rest (``jax.checkpoint_policies.checkpoint_dots``);
"nothing" runs plain. The reference leaves hymba's three unrolled global
layers outside ``jax.checkpoint``; here every layer is checkpointed, which
changes memory, not values. Without autograd (prefill) layers run plain.

Decode writes its caches in place (``init_cache``'s tensors) and returns
them.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import _device
from ..configs.base import ArchConfig
from . import attention as attn
from . import moe as moe_mod
from . import ssm
from .layers import (chunked_xent, dense_init, embed_init, init_mlp, mlp,
                     normal, rmsnorm, rmsnorm_init)

Params = Dict[str, Any]
Tensor = torch.Tensor


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, mode: str):
    """``fn`` under the remat policy ``mode`` (module docstring)."""
    if mode == "nothing":
        return fn
    context = {}
    if mode == "dots":
        context["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **context)

    return run


# ---------------------------------------------------------------------------
# Per-layer init / apply
# ---------------------------------------------------------------------------

def _init_layer(cfg: ArchConfig, gen, kind: str, lead, device) -> Params:
    """kind: dense | moe | hybrid | mlstm | slstm, stacked on ``lead``."""
    dt = _dtype(cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    kw = dict(lead=lead, device=device)
    if kind == "mlstm":
        return {"ln": rmsnorm_init(d, dt, **kw),
                "mlstm": ssm.init_mlstm(gen, d, cfg.n_heads, dt, **kw)}
    if kind == "slstm":
        return {"ln": rmsnorm_init(d, dt, **kw),
                "slstm": ssm.init_slstm(gen, d, dt, **kw)}
    p: Params = {"ln1": rmsnorm_init(d, dt, **kw),
                 "ln2": rmsnorm_init(d, dt, **kw)}
    if cfg.mla:
        p["attn"] = attn.init_mla(
            gen, d, cfg.n_heads, q_rank=cfg.q_rank, kv_rank=cfg.kv_rank,
            rope_hd=cfg.rope_head_dim, nope_hd=cfg.nope_head_dim,
            v_hd=cfg.v_head_dim, dtype=dt, **kw)
    else:
        p["attn"] = attn.init_gqa(gen, d, cfg.n_heads, cfg.n_kv_heads, hd,
                                  cfg.qkv_bias, dt, **kw)
    if kind == "hybrid":
        p["ssd"] = ssm.init_ssd(gen, d, cfg.ssm_heads, cfg.ssm_state,
                                cfg.ssm_expand, dt, **kw)
    if kind == "moe":
        p["moe"] = moe_mod.init_moe(gen, d, cfg.d_ff, cfg.n_experts, cfg.act,
                                    dt, **kw)
        if cfg.dense_residual:
            p["dense_mlp"] = init_mlp(gen, d, cfg.dense_residual_ff, cfg.act,
                                      dt, **kw)
    elif cfg.d_ff:
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.act, dt, **kw)
    return p


def _attn_kwargs(cfg: ArchConfig, window: int):
    return dict(h=cfg.n_heads, kh=cfg.n_kv_heads, hd=cfg.resolved_head_dim,
                theta=cfg.rope_theta, window=window,
                prefix_len=cfg.meta_tokens)


def _mla_kwargs(cfg: ArchConfig):
    return dict(h=cfg.n_heads, q_rank=cfg.q_rank, kv_rank=cfg.kv_rank,
                rope_hd=cfg.rope_head_dim, nope_hd=cfg.nope_head_dim,
                v_hd=cfg.v_head_dim, theta=cfg.rope_theta, eps=cfg.norm_eps)


def _moe_ffn(cfg: ArchConfig, lp: Params, h2, group_tokens: int):
    """The MoE FFN (plus arctic's dense residual): (out, aux)."""
    m, aux = moe_mod.moe_apply(lp["moe"], h2, n_experts=cfg.n_experts,
                               top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor,
                               act=cfg.act, group_tokens=group_tokens,
                               expert_sharding=cfg.moe_expert_sharding)
    if cfg.dense_residual:
        m = m + mlp(lp["dense_mlp"], h2, cfg.act)
    return m, aux


def _apply_layer(cfg: ArchConfig, lp: Params, x, positions, kind: str,
                 window: int):
    """Training/prefill forward of one layer: (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "mlstm":
        return x + ssm.mlstm_forward(lp["mlstm"],
                                     rmsnorm(lp["ln"], x, cfg.norm_eps),
                                     heads=cfg.n_heads,
                                     chunk=cfg.ssm_chunk), aux
    if kind == "slstm":
        return x + ssm.slstm_forward(lp["slstm"],
                                     rmsnorm(lp["ln"], x, cfg.norm_eps)), aux
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    blocks = dict(q_block=cfg.attn_q_block, kv_block=cfg.attn_kv_block)
    if cfg.mla:
        a = attn.mla_forward(lp["attn"], h, positions, **_mla_kwargs(cfg),
                             **blocks)
    else:
        a = attn.gqa_forward(lp["attn"], h, positions,
                             **_attn_kwargs(cfg, window), **blocks,
                             use_custom_vjp=cfg.flash_custom_vjp)
    if kind == "hybrid":
        s = ssm.ssd_forward(lp["ssd"], h, heads=cfg.ssm_heads,
                            state=cfg.ssm_state, expand=cfg.ssm_expand,
                            chunk=cfg.ssm_chunk)
        a = 0.5 * (a + s)                    # hymba: parallel heads, fused
    x = x + a
    h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if kind == "moe":
        m, aux = _moe_ffn(cfg, lp, h2, cfg.moe_group_tokens)
        x = x + m
    elif cfg.d_ff:
        x = x + mlp(lp["mlp"], h2, cfg.act)
    return x, aux


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------

def _layer_plan(cfg: ArchConfig):
    """Structural plan of the layer stack."""
    if cfg.xlstm:
        g = cfg.slstm_group
        return ("xlstm", cfg.n_layers // g, g)
    if cfg.hybrid_ssm:
        return ("hymba",)
    return ("uniform", "moe" if cfg.moe else "dense")


def init_params(cfg: ArchConfig, gen: Optional[torch.Generator],
                device=None) -> Params:
    """The reference's parameter tree, leaf for leaf (shapes and dtypes),
    drawn from the same distributions with ``gen`` on ``device`` (``None``:
    the card; ``gen`` must draw there, and ``gen`` None draws from torch's
    default generator; on the meta device nothing is drawn)."""
    device = _device.resolve_for(gen, device)
    dt = _dtype(cfg)
    p: Params = {"embed": embed_init(gen, cfg.vocab, cfg.d_model, dt, device),
                 "final_norm": rmsnorm_init(cfg.d_model, dt, device=device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab, dt,
                                  device=device)
    if cfg.meta_tokens:
        p["meta"] = normal(gen, (cfg.meta_tokens, cfg.d_model), 0.02, dt,
                           device)
    plan = _layer_plan(cfg)
    if plan[0] == "xlstm":
        _, n_groups, g = plan
        p["layers"] = {
            "m": _init_layer(cfg, gen, "mlstm", (n_groups, g - 1), device),
            "s": _init_layer(cfg, gen, "slstm", (n_groups,), device)}
    elif plan[0] == "hymba":
        n_global = len(cfg.global_attn_layers)
        p["layers"] = {
            "global": _init_layer(cfg, gen, "hybrid", (n_global,), device),
            "swa": _init_layer(cfg, gen, "hybrid",
                               (cfg.n_layers - n_global,), device)}
    else:
        p["layers"] = _init_layer(cfg, gen, plan[1], (cfg.n_layers,), device)
    return p


def _take(tree, i):
    """Layer ``i`` of a stacked parameter (or cache) tree of dicts."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Forward (prefill), a loop over layers
# ---------------------------------------------------------------------------

def _hymba_segments(cfg: ArchConfig):
    """('global', idx) and ('swa', start, count) in layer order."""
    gl = sorted(cfg.global_attn_layers)
    segs = []
    prev = 0
    swa_seen = 0
    for gi, g in enumerate(gl):
        if g > prev:
            segs.append(("swa", swa_seen, g - prev))
            swa_seen += g - prev
        segs.append(("global", gi))
        prev = g + 1
    if prev < cfg.n_layers:
        segs.append(("swa", swa_seen, cfg.n_layers - prev))
    return segs


def _hymba_layers(cfg: ArchConfig):
    """(stack, index, window) of each hymba layer in order."""
    for seg in _hymba_segments(cfg):
        if seg[0] == "global":
            yield "global", seg[1], 0
        else:
            for i in range(seg[1], seg[1] + seg[2]):
                yield "swa", i, cfg.swa_window


def forward(cfg: ArchConfig, params: Params, tokens: Tensor,
            extra_embeds: Optional[Tensor] = None):
    """tokens: [B, S_text]; extra_embeds (vlm patches): [B, P, d].
    Returns (hidden [B, S_total, d], aux_loss, n_prefix) where n_prefix =
    meta + extra positions that carry no loss."""
    x = params["embed"][tokens]
    n_prefix = 0
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], 1)
        n_prefix += extra_embeds.shape[1]
    if cfg.meta_tokens:
        meta = params["meta"][None].expand(x.shape[0], cfg.meta_tokens,
                                           cfg.d_model)
        x = torch.cat([meta.to(x.dtype), x], 1)
        n_prefix += cfg.meta_tokens
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    plan = _layer_plan(cfg)
    layers = params["layers"]
    if plan[0] == "xlstm":
        order = []
        for gi in range(plan[1]):
            order += [(_take(_take(layers["m"], gi), i), "mlstm", 0)
                      for i in range(plan[2] - 1)]
            order.append((_take(layers["s"], gi), "slstm", 0))
    elif plan[0] == "hymba":
        order = [(_take(layers[stack], i), "hybrid", window)
                 for stack, i, window in _hymba_layers(cfg)]
    else:
        order = [(_take(layers, i), plan[1], 0) for i in range(cfg.n_layers)]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, kind, window in order:
        layer = _remat(functools.partial(_apply_layer, cfg, kind=kind,
                                         window=window), cfg.remat)
        x, a = layer(lp, x, positions)
        aux = aux + a
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux, n_prefix


def unembed_matrix(cfg: ArchConfig, params: Params) -> Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def loss_fn(cfg: ArchConfig, params: Params, batch: Dict[str, Tensor]):
    """batch: tokens [B,S], labels [B,S] (-1 = masked), optional
    vision_embeds. Returns the scalar loss (fp32): the mean NLL plus 0.01
    times the MoE auxiliary loss (0 without MoE layers)."""
    h, aux, n_prefix = forward(cfg, params, batch["tokens"],
                               batch.get("vision_embeds"))
    h = h[:, n_prefix:]                       # loss only over text positions
    nll = chunked_xent(h, unembed_matrix(cfg, params), batch["labels"],
                       cfg.loss_chunk, pad_vocab=cfg.pad_vocab)
    return nll + 0.01 * aux


# ---------------------------------------------------------------------------
# Decode (serve_step) with caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> Params:
    """Cache tree for one-token decode (the reference's shapes), on
    ``device`` (``None``: the card)."""
    device = _device.resolve(device)
    dt = _dtype(cfg)
    hd = cfg.resolved_head_dim
    L = cfg.n_layers

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.xlstm:
        g = cfg.slstm_group
        ng = L // g
        return {
            "m": zeros(ng, g - 1, *ssm.mlstm_state_shape(
                batch, cfg.d_model, cfg.n_heads), dtype=torch.float32),
            "s": [zeros(ng, batch, cfg.d_model,
                        dtype=torch.float32 if i else dt) for i in range(3)],
        }
    total = max_len + cfg.meta_tokens
    if cfg.mla:
        return {"c_kv": zeros(L, batch, total, cfg.kv_rank),
                "k_rope": zeros(L, batch, total, cfg.rope_head_dim)}
    if cfg.hybrid_ssm:
        d_in = cfg.ssm_expand * cfg.d_model

        def sub(n):
            return {"k": zeros(n, batch, total, cfg.n_kv_heads, hd),
                    "v": zeros(n, batch, total, cfg.n_kv_heads, hd),
                    "ssm": zeros(n, batch, cfg.ssm_heads, cfg.ssm_state,
                                 d_in // cfg.ssm_heads, dtype=torch.float32)}

        ng = len(cfg.global_attn_layers)
        return {"global": sub(ng), "swa": sub(L - ng)}
    return {"k": zeros(L, batch, total, cfg.n_kv_heads, hd),
            "v": zeros(L, batch, total, cfg.n_kv_heads, hd)}


def _decode_layer(cfg: ArchConfig, lp, cache_l, x, cache_len: int, kind,
                  window):
    """One layer's decode; its cache slice ``cache_l`` is written in
    place."""
    if kind == "mlstm":
        out, st = ssm.mlstm_decode(lp["mlstm"],
                                   rmsnorm(lp["ln"], x, cfg.norm_eps),
                                   cache_l, heads=cfg.n_heads)
        cache_l.copy_(st)
        return x + out
    if kind == "slstm":
        out, st = ssm.slstm_decode(lp["slstm"],
                                   rmsnorm(lp["ln"], x, cfg.norm_eps),
                                   tuple(cache_l))
        for c, new in zip(cache_l, st):
            c.copy_(new)
        return x + out
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    if cfg.mla:
        a, _ = attn.mla_decode(lp["attn"], h, cache_l, cache_len,
                               **_mla_kwargs(cfg))
    else:
        a, _ = attn.gqa_decode(lp["attn"], h, cache_l, cache_len,
                               window_only_reads=cfg.swa_window_decode,
                               **_attn_kwargs(cfg, window))
    if kind == "hybrid":
        s_out, ssm_state = ssm.ssd_decode(
            lp["ssd"], h, cache_l["ssm"], heads=cfg.ssm_heads,
            state=cfg.ssm_state, expand=cfg.ssm_expand)
        cache_l["ssm"].copy_(ssm_state)
        a = 0.5 * (a + s_out)
    x = x + a
    h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if kind == "moe":
        x = x + _moe_ffn(cfg, lp, h2, x.shape[0])[0]
    elif cfg.d_ff:
        x = x + mlp(lp["mlp"], h2, cfg.act)
    return x


def decode_step(cfg: ArchConfig, params: Params, cache: Params, cache_len,
                token: Tensor):
    """One-token decode. token: [B, 1] int; cache_len: int (or a 0-d
    tensor) — positions already in the cache (incl. meta tokens). Returns
    (logits [B, V] float32, cache), the cache written in place."""
    cache_len = int(cache_len)
    x = params["embed"][token]
    plan = _layer_plan(cfg)
    layers = params["layers"]
    if plan[0] == "xlstm":
        for gi in range(plan[1]):
            for i in range(plan[2] - 1):
                x = _decode_layer(cfg, _take(_take(layers["m"], gi), i),
                                  cache["m"][gi, i], x, cache_len, "mlstm", 0)
            x = _decode_layer(cfg, _take(layers["s"], gi),
                              [c[gi] for c in cache["s"]], x, cache_len,
                              "slstm", 0)
    elif plan[0] == "hymba":
        for stack, i, window in _hymba_layers(cfg):
            x = _decode_layer(cfg, _take(layers[stack], i),
                              _take(cache[stack], i), x, cache_len, "hybrid",
                              window)
    else:
        for i in range(cfg.n_layers):
            x = _decode_layer(cfg, _take(layers, i), _take(cache, i), x,
                              cache_len, plan[1], 0)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return (x[:, 0] @ unembed_matrix(cfg, params)).float(), cache
