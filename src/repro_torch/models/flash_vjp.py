"""Flash attention with a hand-written backward, the port of
``repro.models.flash_vjp`` (a ``jax.custom_vjp``) as a
``torch.autograd.Function``.

Autograd through the online-softmax loop of ``attention.flash_attention``
saves every probability tile, O(S²) bytes a layer. This backward saves only
(q, k, v, out, lse), O(S·d), and recomputes each tile blockwise:

    D_i  = rowsum(do_i ∘ o_i)
    p_ij = exp(q_i k_jᵀ·scale − lse_i)
    dv_j += p_ijᵀ do_i
    ds_ij = p_ij ∘ (do_i v_jᵀ − D_i)
    dq_i += ds_ij k_j · scale ;  dk_j += ds_ijᵀ q_i · scale

with dk and dv accumulated in full-size float32 buffers. As in the
reference, the forward folds ``scale`` into ``q_i`` and the backward applies
it to the scores and to ``ds``; the per-q-block KV ranges (causal, window,
``prefix_len`` keys always visible) are the forward's. Every product takes
its operands in float32.
"""
from __future__ import annotations

from typing import Optional

import torch

from .attention import _pad_to

NEG_INF = -1e30


def _ranges(sq, sk, q_block, kv_block, q_offset, causal, window, sk_real):
    """Static per-q-block KV block ranges (mirrors the forward)."""
    nq, nk = sq // q_block, sk // kv_block
    out = []
    for i in range(nq):
        if causal:
            hi_pos = q_offset + (i + 1) * q_block
            k_hi = min(nk, -(-min(hi_pos, sk_real) // kv_block))
        else:
            k_hi = nk
        if window and causal:
            k_lo = max(0, (q_offset + i * q_block - window) // kv_block)
        else:
            k_lo = 0
        out.append((k_lo, max(k_hi - k_lo, 1)))
    return out


def _mask_for(qpos, kpos, causal, window, prefix_len, sk_real):
    m = (kpos[None, :] < sk_real).expand(qpos.shape[0], kpos.shape[0])
    if causal:
        m = m & (kpos[None, :] <= qpos[:, None])
        if window:
            w = qpos[:, None] - kpos[None, :] < window
            if prefix_len:
                w = w | (kpos[None, :] < prefix_len)
            m = m & w
    return m


def _blocks(q, k, q_block, kv_block):
    sq, sk = q.shape[1], k.shape[1]
    return min(q_block, max(sq, 16)), min(kv_block, max(sk, 16))


def _flash_fwd(q, k, v, causal, window, q_offset, q_block, kv_block, scale,
               prefix_len):
    """(out [B, Sq, H, hdv] in q's dtype, lse [nq, B, K, G, q_block])."""
    b, sq, h, hdq = q.shape
    _, sk, kh, hdv = v.shape
    g = h // kh
    scale = scale or (hdq ** -0.5)
    q_block, kv_block = _blocks(q, k, q_block, kv_block)
    dev = q.device
    q, sq_real = _pad_to(q, q_block, 1)
    k, sk_real = _pad_to(k, kv_block, 1)
    v, _ = _pad_to(v, kv_block, 1)
    sqp, skp = q.shape[1], k.shape[1]
    qg = q.reshape(b, sqp, kh, g, hdq)
    ranges = _ranges(sqp, skp, q_block, kv_block, q_offset, causal, window,
                     sk_real)
    outs, lses = [], []
    for i, (k_lo, n_steps) in enumerate(ranges):
        q_i = (qg[:, i * q_block:(i + 1) * q_block] * scale).to(q.dtype)
        qf = q_i.float()
        qpos = q_offset + i * q_block + torch.arange(q_block, device=dev)
        m = torch.full((b, kh, g, q_block), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kh, g, q_block), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kh, g, q_block, hdv), dtype=torch.float32,
                          device=dev)
        for blk in range(k_lo, k_lo + n_steps):
            sl = slice(blk * kv_block, (blk + 1) * kv_block)
            kpos = blk * kv_block + torch.arange(kv_block, device=dev)
            s_ij = torch.einsum("bqkgh,bskh->bkgqs", qf, k[:, sl].float())
            msk = _mask_for(qpos, kpos, causal, window, prefix_len, sk_real)
            s_ij = torch.where(msk, s_ij, NEG_INF)
            m_new = torch.maximum(m, s_ij.amax(-1))
            p = torch.exp(s_ij - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p.to(v.dtype).float(), v[:, sl].float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))               # [B,qb,K,G,hdv]
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))  # [B,K,G,qb]
    out = torch.cat(outs, 1)[:, :sq_real]
    return (out.reshape(b, sq_real, h, hdv).to(q.dtype),
            torch.stack(lses, 0))


def _flash_bwd(q, k, v, out, lse, dout, causal, window, q_offset, q_block,
               kv_block, scale, prefix_len):
    """(dq, dk, dv) in the dtypes of q, k and v."""
    b, sq, h, hdq = q.shape
    _, sk, kh, hdv = v.shape
    g = h // kh
    scale_v = scale or (hdq ** -0.5)
    q_blk, kv_blk = _blocks(q, k, q_block, kv_block)
    dev = q.device
    qp, sq_real = _pad_to(q, q_blk, 1)
    kp, sk_real = _pad_to(k, kv_blk, 1)
    vp, _ = _pad_to(v, kv_blk, 1)
    dop, _ = _pad_to(dout, q_blk, 1)
    op, _ = _pad_to(out, q_blk, 1)
    sqp, skp = qp.shape[1], kp.shape[1]
    qg = qp.reshape(b, sqp, kh, g, hdq)
    dog = dop.reshape(b, sqp, kh, g, hdv)
    og = op.reshape(b, sqp, kh, g, hdv)
    ranges = _ranges(sqp, skp, q_blk, kv_blk, q_offset, causal, window,
                     sk_real)
    dq_blocks = []
    dk = torch.zeros((b, skp, kh, hdq), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, skp, kh, hdv), dtype=torch.float32, device=dev)
    for i, (k_lo, n_steps) in enumerate(ranges):
        sl = slice(i * q_blk, (i + 1) * q_blk)
        q_i, do_i = qg[:, sl].float(), dog[:, sl].float()
        d_i = (do_i * og[:, sl].float()).sum(-1)                # [B,qb,K,G]
        d_i = d_i.permute(0, 2, 3, 1)                           # [B,K,G,qb]
        qpos = q_offset + i * q_blk + torch.arange(q_blk, device=dev)
        dq_i = torch.zeros((b, q_blk, kh, g, hdq), dtype=torch.float32,
                           device=dev)
        for blk in range(k_lo, k_lo + n_steps):
            ks = slice(blk * kv_blk, (blk + 1) * kv_blk)
            k_j, v_j = kp[:, ks].float(), vp[:, ks].float()
            kpos = blk * kv_blk + torch.arange(kv_blk, device=dev)
            s_ij = torch.einsum("bqkgh,bskh->bkgqs", q_i, k_j) * scale_v
            msk = _mask_for(qpos, kpos, causal, window, prefix_len, sk_real)
            s_ij = torch.where(msk, s_ij, NEG_INF)
            p = torch.exp(s_ij - lse[i][..., None])             # [B,K,G,qb,kb]
            dv[:, ks] += torch.einsum("bkgqs,bqkgh->bskh", p, do_i)
            dp = torch.einsum("bqkgh,bskh->bkgqs", do_i, v_j)
            ds = p * (dp - d_i[..., None])
            dq_i += torch.einsum("bkgqs,bskh->bqkgh", ds, k_j) * scale_v
            dk[:, ks] += torch.einsum("bkgqs,bqkgh->bskh", ds, q_i) * scale_v
        dq_blocks.append(dq_i)
    dq = torch.cat(dq_blocks, 1)[:, :sq_real].reshape(b, sq_real, h, hdq)
    return (dq.to(q.dtype), dk[:, :sk].to(k.dtype), dv[:, :sk].to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, q_block, kv_block,
                scale, prefix_len):
        out, lse = _flash_fwd(q, k, v, causal, window, q_offset, q_block,
                              kv_block, scale, prefix_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.static = (causal, window, q_offset, q_block, kv_block, scale,
                      prefix_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, *ctx.static)
        return (dq, dk, dv) + (None,) * 7


def flash_attention_vjp(q, k, v, causal: bool = True, window: int = 0,
                        q_offset: int = 0, q_block: int = 1024,
                        kv_block: int = 1024,
                        scale: Optional[float] = None,
                        prefix_len: int = 0) -> torch.Tensor:
    """``attention.flash_attention``'s arguments, positionally as the
    reference's, and output; its backward is the blockwise one above."""
    return _FlashAttention.apply(q, k, v, causal, window, q_offset, q_block,
                                 kv_block, scale, prefix_len)
