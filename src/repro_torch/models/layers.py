"""Shared model building blocks: norms, embeddings, RoPE, MLPs, parameter
initializers. The port of ``repro.models.layers``.

Params are plain dicts of tensors. ``init_*`` functions take an explicit
``torch.Generator`` and device; ``lead`` prepends a stack axis (the
reference's ``vmap``-ed layer stacks), each entry drawn from the same
distribution. Forward logic is free functions on tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]
Tensor = torch.Tensor


#: Elements of the largest float32 draw ``normal`` makes at once (4 GiB).
#: A larger leaf (a full-width stacked MLP or expert weight: 8.8 G elements
#: for llava-next-34b's, 35 GiB in float32) is drawn a run of leading rows
#: at a time into its own dtype, so the float32 transient of its draw fits
#: beside the parameters already made. Leaves up to this size are one draw.
DRAW_ELEMENTS = 1 << 30


def normal(gen: torch.Generator, shape, scale: float, dtype,
           device=None) -> Tensor:
    """N(0, 1) * scale drawn in float32 on ``gen``'s device, then cast
    (a leaf of more than ``DRAW_ELEMENTS`` a run of leading rows at a
    time, in row order)."""
    shape, device = tuple(shape), device or gen.device
    n = 1
    for k in shape:
        n *= k
    if n <= DRAW_ELEMENTS or torch.device(device).type == "meta":
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (x * scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    _draw_rows(gen, out, scale)
    return out


def _draw_rows(gen: torch.Generator, out: Tensor, scale: float) -> None:
    """``out`` filled with N(0, 1) * scale, runs of at most
    ``DRAW_ELEMENTS`` elements of leading rows drawn in float32 one after
    the other (a row larger than that is split in turn)."""
    row = out.numel() // out.shape[0]
    if row > DRAW_ELEMENTS:
        for i in range(out.shape[0]):
            _draw_rows(gen, out[i], scale)
        return
    rows = max(1, DRAW_ELEMENTS // row)
    for i in range(0, out.shape[0], rows):
        piece = out[i:i + rows]
        piece.copy_(torch.randn(piece.shape, generator=gen,
                                dtype=torch.float32,
                                device=out.device).mul_(scale))


def dense_init(gen, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None, lead: Tuple[int, ...] = (),
               device=None) -> Tensor:
    scale = (d_in ** -0.5) if scale is None else scale
    return normal(gen, (*lead, d_in, d_out), scale, dtype, device)


def embed_init(gen, vocab: int, d: int, dtype, device=None) -> Tensor:
    return normal(gen, (vocab, d), 0.02, dtype, device)


def rmsnorm_init(d: int, dtype, lead: Tuple[int, ...] = (),
                 device=None) -> Tensor:
    return torch.ones((*lead, d), dtype=dtype, device=device)


def rmsnorm(w: Tensor, x: Tensor, eps: float = 1e-5) -> Tensor:
    # Norm statistics in fp32 regardless of activation dtype.
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def act_fn(name: str):
    # jax.nn.gelu is the tanh approximation by default
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: [..., S, H, hd]; positions: [..., S] int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # [hd/2]
    ang = positions[..., None].float() * freqs               # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]                    # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / plain)
# ---------------------------------------------------------------------------

def init_mlp(gen, d: int, ff: int, act: str, dtype,
             lead: Tuple[int, ...] = (), device=None) -> Params:
    p = {"w_in": dense_init(gen, d, ff, dtype, lead=lead, device=device),
         "w_out": dense_init(gen, ff, d, dtype, lead=lead, device=device)}
    if act == "silu":                                    # gated (SwiGLU)
        p["w_gate"] = dense_init(gen, d, ff, dtype, lead=lead, device=device)
    return p


def mlp(p: Params, x: Tensor, act: str) -> Tensor:
    h = x @ p["w_in"]
    if "w_gate" in p:
        h = act_fn(act)(x @ p["w_gate"]) * h
    else:
        h = act_fn(act)(h)
    return h @ p["w_out"]


# ---------------------------------------------------------------------------
# Cross-entropy with sequence chunking (vocab can be 152k: never materialize
# the full [B, S, V] logits — loop over S chunks and reduce).
# ---------------------------------------------------------------------------

def chunked_xent(h: Tensor, w_unembed: Tensor, labels: Tensor, chunk: int,
                 pad_vocab: bool = False) -> Tensor:
    """h: [B, S, d] final hidden; w_unembed: [d, V]; labels: [B, S] int.
    Returns mean NLL (fp32). Positions with label < 0 are masked out.

    pad_vocab: pad V up to a multiple of 128, the padded columns masked to
    -inf before the logsumexp (the reference pads so that the logits shard
    over its model axis; on one device it changes nothing but the shape).
    """
    b, s, _ = h.shape
    v_real = w_unembed.shape[-1]
    if pad_vocab and v_real % 128:
        w_unembed = F.pad(w_unembed, (0, (-v_real) % 128))
    chunk = min(chunk, s)
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        hc, lc = h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        logits = (hc @ w_unembed).float()                    # [B, c, V]
        if logits.shape[-1] != v_real:
            col = torch.arange(logits.shape[-1], device=h.device)
            logits = torch.where(col < v_real, logits,
                                 torch.full_like(logits, -1e30))
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, lc.clamp(min=0)[..., None].long()
                           )[..., 0]
        mask = (lc >= 0).float()
        nll = nll + ((lse - tgt) * mask).sum()
        cnt = cnt + mask.sum()
    return nll / torch.clamp(cnt, min=1.0)
