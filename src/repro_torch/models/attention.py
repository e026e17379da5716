"""Attention: GQA (+bias, RoPE, sliding window), MLA (latent KV), and a
memory-efficient blockwise "flash" attention in plain torch. The port of
``repro.models.attention`` (which computes attention in jnp, outside any
Pallas kernel).

The flash path never materializes [S, S] scores: a loop over query blocks
wraps a loop over exactly the key/value blocks inside the causal/window
horizon, carrying online-softmax statistics (~S²/2 work for causal, ~S·W
for a sliding window).

Decode paths take a cache dict and an int ``cache_len`` and write the new
token's keys and values into the cache's tensors in place; MLA decode uses
the absorbed-weight formulation so attention runs entirely in the latent
space (cache = [S, kv_rank + rope] per token). Scores and the value
products take the operands in float32, as the reference's
``preferred_element_type=float32`` products do.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .layers import apply_rope, dense_init, rmsnorm

Params = Dict[str, Any]
Tensor = torch.Tensor
NEG_INF = -1e30


def _pad_to(x: Tensor, mult: int, dim: int):
    s = x.shape[dim]
    pad = (-s) % mult
    if pad == 0:
        return x, s
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim), s


# ---------------------------------------------------------------------------
# Blockwise flash attention (training / prefill)
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, q_block: int = 1024,
                    kv_block: int = 1024, scale: Optional[float] = None,
                    prefix_len: int = 0) -> Tensor:
    """q: [B, Sq, H, hd_qk]; k: [B, Sk, K, hd_qk]; v: [B, Sk, K, hd_v].

    GQA by grouping (H = K * G). ``q_offset``: absolute position of q[0]
    (prefill continuation). ``window``: 0 = unlimited; else each query
    attends to keys in (q_pos - window, q_pos]. ``prefix_len``: the first
    `prefix_len` keys (meta tokens / vision prefix) are always visible.
    Returns [B, Sq, H, hd_v].
    """
    b, sq, h, hdq = q.shape
    _, sk, kh, hdv = v.shape
    g = h // kh
    scale = scale or (hdq ** -0.5)
    q_block = min(q_block, max(sq, 16))
    kv_block = min(kv_block, max(sk, 16))
    dev = q.device

    q, sq_real = _pad_to(q, q_block, 1)
    k, sk_real = _pad_to(k, kv_block, 1)
    v, _ = _pad_to(v, kv_block, 1)
    sqp, skp = q.shape[1], k.shape[1]
    nq, nk = sqp // q_block, skp // kv_block

    qg = q.reshape(b, sqp, kh, g, hdq)
    outs = []
    for i in range(nq):
        q_i = (qg[:, i * q_block:(i + 1) * q_block] * scale).to(q.dtype)
        qpos = q_offset + i * q_block + torch.arange(q_block, device=dev)
        if causal:
            hi_pos = q_offset + (i + 1) * q_block            # exclusive
            k_hi = min(nk, -(-min(hi_pos, sk_real) // kv_block))
        else:
            k_hi = nk
        if window and causal:
            k_lo = max(0, (q_offset + i * q_block - window) // kv_block)
        else:
            k_lo = 0
        n_steps = max(k_hi - k_lo, 1)
        m = torch.full((b, kh, g, q_block), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kh, g, q_block), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kh, g, q_block, hdv), dtype=torch.float32,
                          device=dev)
        qf = q_i.float()
        for blk in range(k_lo, k_lo + n_steps):
            sl = slice(blk * kv_block, (blk + 1) * kv_block)
            k_j, v_j = k[:, sl], v[:, sl]
            kpos = blk * kv_block + torch.arange(kv_block, device=dev)
            s_ij = torch.einsum("bqkgh,bskh->bkgqs", qf, k_j.float())
            mask = (kpos[None, :] < sk_real).expand(q_block, kv_block)
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
                if window:
                    win = qpos[:, None] - kpos[None, :] < window
                    if prefix_len:
                        win = win | (kpos[None, :] < prefix_len)
                    mask = mask & win
            s_ij = torch.where(mask, s_ij, torch.full_like(s_ij, NEG_INF))
            m_new = torch.maximum(m, s_ij.amax(dim=-1))
            p = torch.exp(s_ij - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p.to(v.dtype).float(), v_j.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]     # [B,K,G,qb,hdv]
        outs.append(out.permute(0, 3, 1, 2, 4))              # [B,qb,K,G,hdv]
    out = torch.cat(outs, dim=1)[:, :sq_real]
    return out.reshape(b, sq_real, h, hdv).to(q.dtype)


def _softmax_attend(qg, k_r, v_r, mask, out_dtype):
    """Scores of grouped queries ``qg`` [B, K, G, hd] against ``k_r``
    [B, S, K, hd] where ``mask`` [B or 1, S] holds, softmax, and the value
    sum: [B, K, G, hd_v] in ``out_dtype``."""
    scores = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_r.float())
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p.to(v_r.dtype).float(), v_r.float())
    return out.to(out_dtype)


def decode_attention(q, k_cache, v_cache, cache_len: int, *, window: int = 0,
                     scale: Optional[float] = None,
                     prefix_len: int = 0) -> Tensor:
    """Single-token attention. q: [B, 1, H, hd]; caches: [B, S, K, hd]."""
    b, _, h, hdq = q.shape
    _, s, kh, hdv = v_cache.shape
    g = h // kh
    scale = scale or (hdq ** -0.5)
    qg = (q.reshape(b, kh, g, hdq) * scale).to(q.dtype)
    kpos = torch.arange(s, device=q.device)
    mask = kpos[None, :] < cache_len
    if window:
        win = (cache_len - 1 - kpos[None, :]) < window
        if prefix_len:
            win = win | (kpos[None, :] < prefix_len)
        mask = mask & win
    out = _softmax_attend(qg, k_cache, v_cache, mask, q.dtype)
    return out.reshape(b, 1, h, hdv)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

def init_gqa(gen, d: int, h: int, kh: int, hd: int, bias: bool, dtype,
             lead: Tuple[int, ...] = (), device=None) -> Params:
    p = {"wq": dense_init(gen, d, h * hd, dtype, lead=lead, device=device),
         "wk": dense_init(gen, d, kh * hd, dtype, lead=lead, device=device),
         "wv": dense_init(gen, d, kh * hd, dtype, lead=lead, device=device),
         "wo": dense_init(gen, h * hd, d, dtype, lead=lead, device=device)}
    if bias:
        for name, width in (("bq", h * hd), ("bk", kh * hd),
                            ("bv", kh * hd)):
            p[name] = torch.zeros((*lead, width), dtype=dtype, device=device)
    return p


def gqa_project(p: Params, x, h: int, kh: int, hd: int):
    b, s, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, s, h, hd), k.reshape(b, s, kh, hd),
            v.reshape(b, s, kh, hd))


def gqa_forward(p: Params, x, positions, *, h, kh, hd, theta, window=0,
                prefix_len=0, q_block=1024, kv_block=1024,
                use_custom_vjp: bool = False, return_kv: bool = False):
    """Training / prefill self-attention. x: [B, S, d]. ``use_custom_vjp``
    takes ``flash_vjp.flash_attention_vjp`` (the blockwise backward)."""
    q, k, v = gqa_project(p, x, h, kh, hd)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    if use_custom_vjp:
        from .flash_vjp import flash_attention_vjp
        out = flash_attention_vjp(q, k, v, True, window, 0, q_block,
                                  kv_block, None, prefix_len)
    else:
        out = flash_attention(q, k, v, causal=True, window=window,
                              prefix_len=prefix_len, q_block=q_block,
                              kv_block=kv_block)
    out = out.reshape(*x.shape[:2], h * hd) @ p["wo"]
    return (out, (k, v)) if return_kv else out


def gqa_decode(p: Params, x, cache: Params, cache_len: int, *, h, kh, hd,
               theta, window=0, prefix_len=0,
               window_only_reads: bool = False):
    """x: [B, 1, d]; cache: {"k","v": [B, Smax, K, hd]}, written in place at
    ``cache_len``. Returns (out, cache).

    window_only_reads: for sliding-window layers, read only the
    ``prefix_len`` always-visible rows plus the last ``window`` rows of
    the cache instead of all Smax rows.
    """
    q, k, v = gqa_project(p, x, h, kh, hd)
    pos = torch.full((x.shape[0], 1), cache_len, dtype=torch.int64,
                     device=x.device)
    q = apply_rope(q, pos, theta)
    k = apply_rope(k, pos, theta)
    k_cache, v_cache = cache["k"], cache["v"]
    k_cache[:, cache_len] = k[:, 0].to(k_cache.dtype)
    v_cache[:, cache_len] = v[:, 0].to(v_cache.dtype)
    smax = k_cache.shape[1]
    b = x.shape[0]
    if window_only_reads and window and window + prefix_len < smax:
        start = min(max(cache_len + 1 - window, prefix_len), smax - window)
        rows = torch.cat([torch.arange(prefix_len),
                          start + torch.arange(window)]).to(x.device)
        g = h // kh
        qg = (q.reshape(b, kh, g, hd) * hd ** -0.5).to(q.dtype)
        mask = (rows <= cache_len)[None, :]
        out = _softmax_attend(qg, k_cache[:, rows], v_cache[:, rows], mask,
                              q.dtype).reshape(b, 1, h * hd)
    else:
        out = decode_attention(q, k_cache, v_cache, cache_len + 1,
                               window=window, prefix_len=prefix_len)
        out = out.reshape(b, 1, h * hd)
    return out @ p["wo"], cache


# ---------------------------------------------------------------------------
# MLA (Multi-head Latent Attention) — minicpm3
# ---------------------------------------------------------------------------

def init_mla(gen, d: int, h: int, *, q_rank, kv_rank, rope_hd, nope_hd,
             v_hd, dtype, lead: Tuple[int, ...] = (), device=None) -> Params:
    def dense(d_in, d_out):
        return dense_init(gen, d_in, d_out, dtype, lead=lead, device=device)

    def ones(n):
        return torch.ones((*lead, n), dtype=dtype, device=device)

    return {
        "wq_a": dense(d, q_rank), "q_norm": ones(q_rank),
        "wq_b": dense(q_rank, h * (nope_hd + rope_hd)),
        "wkv_a": dense(d, kv_rank + rope_hd), "kv_norm": ones(kv_rank),
        "w_uk": dense(kv_rank, h * nope_hd), "w_uv": dense(kv_rank, h * v_hd),
        "wo": dense(h * v_hd, d),
    }


def _mla_q(p, x, positions, h, nope_hd, rope_hd, theta, eps):
    b, s, _ = x.shape
    ql = rmsnorm(p["q_norm"], x @ p["wq_a"], eps)
    q = (ql @ p["wq_b"]).reshape(b, s, h, nope_hd + rope_hd)
    q_nope, q_rope = q[..., :nope_hd], q[..., nope_hd:]
    return q_nope, apply_rope(q_rope, positions, theta)


def _mla_latent(p, x, positions, kv_rank, rope_hd, theta, eps):
    kv = x @ p["wkv_a"]                                   # [B,S,kvr+rope]
    c_kv = rmsnorm(p["kv_norm"], kv[..., :kv_rank], eps)
    k_rope = apply_rope(kv[..., None, kv_rank:], positions, theta)
    return c_kv, k_rope[..., 0, :]


def mla_forward(p: Params, x, positions, *, h, q_rank, kv_rank, rope_hd,
                nope_hd, v_hd, theta, eps, q_block=1024, kv_block=1024):
    """Prefill: expand the latent to per-head K/V, run flash."""
    b, s, _ = x.shape
    q_nope, q_rope = _mla_q(p, x, positions, h, nope_hd, rope_hd, theta, eps)
    c_kv, k_rope = _mla_latent(p, x, positions, kv_rank, rope_hd, theta, eps)
    k_nope = (c_kv @ p["w_uk"]).reshape(b, s, h, nope_hd)
    v = (c_kv @ p["w_uv"]).reshape(b, s, h, v_hd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h, rope_hd)],
                  dim=-1)
    scale = (nope_hd + rope_hd) ** -0.5
    out = flash_attention(q, k, v, causal=True, scale=scale,
                          q_block=q_block, kv_block=kv_block)
    return out.reshape(b, s, h * v_hd) @ p["wo"]


def mla_decode(p: Params, x, cache: Params, cache_len: int, *, h, q_rank,
               kv_rank, rope_hd, nope_hd, v_hd, theta, eps):
    """Absorbed-weight decode over the latent cache {"c_kv": [B, Smax,
    kv_rank], "k_rope": [B, Smax, rope_hd]}, written in place."""
    b = x.shape[0]
    pos = torch.full((b, 1), cache_len, dtype=torch.int64, device=x.device)
    q_nope, q_rope = _mla_q(p, x, pos, h, nope_hd, rope_hd, theta, eps)
    c_new, r_new = _mla_latent(p, x, pos, kv_rank, rope_hd, theta, eps)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    c_kv[:, cache_len] = c_new[:, 0].to(c_kv.dtype)
    k_rope[:, cache_len] = r_new[:, 0].to(k_rope.dtype)
    # Absorb W_uk into q: score in latent space.
    w_uk = p["w_uk"].reshape(kv_rank, h, nope_hd)
    q_lat = torch.einsum("bqhn,khn->bhk", q_nope, w_uk)  # [B,H,kv_rank]
    s_lat = torch.einsum("bhk,bsk->bhs", q_lat.float(), c_kv.float())
    s_rope = torch.einsum("bqhr,bsr->bhs", q_rope.float(), k_rope.float())
    scores = (s_lat + s_rope) * (nope_hd + rope_hd) ** -0.5
    mask = torch.arange(c_kv.shape[1], device=x.device) < cache_len + 1
    scores = torch.where(mask[None, None], scores,
                         torch.full_like(scores, NEG_INF))
    pattn = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("bhs,bsk->bhk", pattn.to(c_kv.dtype).float(),
                           c_kv.float())                    # [B,H,kvr]
    w_uv = p["w_uv"].reshape(kv_rank, h, v_hd)
    out = torch.einsum("bhk,khv->bhv", ctx_lat.to(x.dtype), w_uv)
    return out.reshape(b, 1, h * v_hd) @ p["wo"], cache
