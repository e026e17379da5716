"""State-space & recurrent blocks: mamba-2-style SSD (hymba's parallel SSM
heads), and xLSTM's mLSTM / sLSTM. The port of ``repro.models.ssm``.

One chunked *gated linear attention* engine serves both SSD and mLSTM:

    H_t = exp(log_decay_t) · H_{t-1} + inc_t · k_t ⊗ v_t
    y_t = q_t · H_t

computed chunk-parallel (intra-chunk masked matmul in log-decay space +
inter-chunk recurrence over [N, P] states); decode is a single O(N·P) state
update. mLSTM's normalizer is folded in by augmenting v with a ones-column.

Where the chunked engine runs: ``ssd_forward`` and ``mlstm_forward`` call
the hand-written CUDA kernel path, ``kernels.gla.gla_forward``, when the
operands are CUDA tensors, no initial state is given, the final state is
not asked for and autograd records nothing; it rounds as the reference's
Pallas kernel does. Otherwise they call ``gla_chunked``, this module's
plain engine (the CPU, a carried state, training). A kernel that fails to
build or launch raises; nothing falls back.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import gla as gla_kernel
from ..kernels.gla import CLAMP as _CLAMP  # log-space clamp for the gates
from ..kernels.gla import clipped_exp as _clipped_exp
from ..kernels.gla import rounded as _as
from .layers import dense_init

Params = Dict[str, Any]
Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Chunked gated linear attention engine
# ---------------------------------------------------------------------------

def _intra_chunks(q, k, v, ld, li, tri, dt):
    """Each chunk's own work, batched over the chunks (float32 operands
    [B, C, L, H, .]): (y_intra [B,C,L,H,P], cum [B,C,L,H], the state each
    chunk adds [B,C,H,N,P])."""
    cum = torch.cumsum(ld, 2)                                  # [B,C,L,H]
    logw = cum[:, :, :, None] - cum[:, :, None, :] + li[:, :, None, :]
    w = _as(_clipped_exp(torch.where(tri, logw, -torch.inf)), dt)
    qk = _as(torch.einsum("bclhn,bcmhn->bclmh", q, k), dt)
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", _as(qk * w, dt), v)
    wj = _clipped_exp(cum[:, :, -1:] - cum + li)
    dstate = torch.einsum("bclhn,bclhp->bchnp", k * wj[..., None], v)
    return y_intra, cum, dstate


def gla_chunked(q, k, v, log_decay, log_inc, chunk: int = 128,
                h0: Optional[Tensor] = None, chunk_remat: bool = True
                ) -> Tuple[Tensor, Tensor]:
    """q,k: [B,S,H,N]; v: [B,S,H,P]; log_decay/log_inc: [B,S,H].
    Returns (y [B,S,H,P] in v's dtype, h_final [B,H,N,P] float32).

    Rounds where the reference's jnp engine rounds: the intra-chunk weights
    and ``q k^T`` in v's dtype, their product in v's dtype, the carried
    state in q's dtype where it meets q; every product accumulates in
    float32.

    The reference scans over the chunks; here each chunk's own work (its
    [B,L,L,H] weights, its output and the state it adds) runs batched over
    all chunks, and only the inter-chunk recurrence of the [B,H,N,P]
    states loops, so a sequence of C chunks issues a few dozen kernels and
    2·C small ones instead of ~25·C (the same sums, grouped by chunk).

    chunk_remat: where autograd records, the batched intra-chunk work runs
    under a (non-reentrant) checkpoint, so the backward keeps only the
    operands and the carried states and recomputes the [B,C,L,L,H] tiles,
    as the reference's ``jax.checkpoint`` of its chunk step does."""
    b, s, h, n = q.shape
    p = v.shape[-1]
    dt = v.dtype
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        def zpad(a, value=0.0):
            tail = a.new_full((b, pad, *a.shape[2:]), value)
            return torch.cat([a, tail], 1)
        q, k, v = zpad(q), zpad(k), zpad(v)
        log_decay = zpad(log_decay)
        log_inc = zpad(log_inc, -_CLAMP * 2)
    sp = s + pad
    nc = sp // chunk

    def fold(a):
        return a.float().reshape(b, nc, chunk, *a.shape[2:])

    qc, kc, vc, ldc, lic = map(fold, (q, k, v, log_decay, log_inc))
    idx = torch.arange(chunk, device=q.device)
    tri = (idx[:, None] >= idx[None, :])[None, None, :, :, None]  # j <= i
    args = (qc, kc, vc, ldc, lic, tri, dt)
    if chunk_remat and torch.is_grad_enabled():
        y_intra, cum, dstate = checkpoint(_intra_chunks, *args,
                                          use_reentrant=False)
    else:
        y_intra, cum, dstate = _intra_chunks(*args)
    decay = _clipped_exp(cum[:, :, -1])                        # [B,C,H]
    hprev = (torch.zeros((b, h, n, p), dtype=torch.float32, device=q.device)
             if h0 is None else h0.float())
    h_in = []                                 # the state entering each chunk
    for c in range(nc):
        h_in.append(hprev)
        hprev = hprev * decay[:, c, :, None, None] + dstate[:, c]
    y_inter = torch.einsum("bclhn,bchnp->bclhp",
                           qc * _clipped_exp(cum)[..., None],
                           _as(torch.stack(h_in, 1), q.dtype))
    y = (y_intra + y_inter).to(dt).reshape(b, sp, h, p)
    return y[:, :s], hprev


def gla_step(hprev, q, k, v, log_decay, log_inc) -> Tuple[Tensor, Tensor]:
    """Single decode step. q,k: [B,H,N]; v: [B,H,P]; gates: [B,H].
    Returns (y [B,H,P] in v's dtype, h_new float32)."""
    d = _clipped_exp(log_decay.float())[..., None, None]
    i = _clipped_exp(log_inc.float())[..., None, None]
    hnew = hprev * d + i * torch.einsum("bhn,bhp->bhnp", k.float(),
                                        v.float())
    y = torch.einsum("bhn,bhnp->bhp", q.float(), _as(hnew, q.dtype))
    return y.to(v.dtype), hnew


def _engine(q, k, v, log_decay, log_inc, chunk, h0, return_state):
    """``gla_chunked``, or the CUDA kernel path where the module docstring
    says: (y, final state or None)."""
    if q.is_cuda and h0 is None and not return_state and not (
            torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v, log_decay, log_inc))):
        return gla_kernel.gla_forward(q, k, v, log_decay, log_inc,
                                      chunk=chunk, device=q.device), None
    return gla_chunked(q, k, v, log_decay, log_inc, chunk=chunk, h0=h0)


# ---------------------------------------------------------------------------
# SSD (mamba-2 scalar-A) branch — hymba's parallel SSM heads
# ---------------------------------------------------------------------------

def init_ssd(gen, d: int, heads: int, state: int, expand: int, dtype,
             lead: Tuple[int, ...] = (), device=None) -> Params:
    d_in = expand * d

    def dense(d_out, scale=None):
        return dense_init(gen, d, d_out, dtype, scale, lead, device)

    p = {"w_x": dense(d_in), "w_z": dense(d_in), "w_B": dense(heads * state),
         "w_C": dense(heads * state), "w_dt": dense(heads, 0.02)}
    p.update({
        "dt_bias": torch.zeros((*lead, heads), dtype=dtype, device=device),
        "a_log": torch.zeros((*lead, heads), dtype=torch.float32,
                             device=device),                 # A = -exp(a_log)
        "d_skip": torch.ones((*lead, heads), dtype=dtype, device=device),
        "w_out": dense_init(gen, d_in, d, dtype, lead=lead, device=device),
    })
    return p


def _ssd_gates(p, x, heads):
    dt = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"].float())  # [B,S,H]
    a = -torch.exp(p["a_log"])                                        # [H]
    log_decay = dt * a                                                # <= 0
    log_inc = torch.log(dt + 1e-9)
    return log_decay, log_inc


def _ssd_proj(p, x, heads, state, expand):
    b, s, d = x.shape
    hd = expand * d // heads
    return ((x @ p["w_x"]).reshape(b, s, heads, hd),
            (x @ p["w_z"]).reshape(b, s, heads, hd),
            (x @ p["w_B"]).reshape(b, s, heads, state),
            (x @ p["w_C"]).reshape(b, s, heads, state))


def ssd_forward(p: Params, x, *, heads: int, state: int, expand: int,
                chunk: int = 128, h0=None, return_state: bool = False):
    """x: [B,S,d] -> [B,S,d] (+ final state)."""
    b, s, d = x.shape
    xs, z, bb, cc = _ssd_proj(p, x, heads, state, expand)
    log_decay, log_inc = _ssd_gates(p, x, heads)
    y, hf = _engine(cc, bb, xs, log_decay, log_inc, chunk, h0, return_state)
    y = y + xs * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y * F.silu(z)
    out = y.reshape(b, s, expand * d) @ p["w_out"]
    return (out, hf) if return_state else out


def ssd_decode(p: Params, x, h, *, heads: int, state: int, expand: int):
    """x: [B,1,d]; h: [B,H,N,hd] recurrent state. Returns (out, h_new)."""
    b, _, d = x.shape
    xs, z, bb, cc = (a[:, 0] for a in _ssd_proj(p, x, heads, state, expand))
    ld, li = _ssd_gates(p, x, heads)
    y, hnew = gla_step(h, cc, bb, xs, ld[:, 0], li[:, 0])
    y = y + xs * p["d_skip"].to(x.dtype)[None, :, None]
    y = y * F.silu(z)
    return y.reshape(b, 1, expand * d) @ p["w_out"], hnew


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM)
# ---------------------------------------------------------------------------

def init_mlstm(gen, d: int, heads: int, dtype, lead: Tuple[int, ...] = (),
               device=None) -> Params:
    def dense(d_out, scale=None):
        return dense_init(gen, d, d_out, dtype, scale, lead, device)

    p = {"w_q": dense(d), "w_k": dense(d), "w_v": dense(d),
         "w_i": dense(heads, 0.02), "w_f": dense(heads, 0.02)}
    p["f_bias"] = torch.full((*lead, heads), 3.0, dtype=dtype,
                             device=device)                # open forget gates
    p["w_o"] = dense(d)
    p["w_out"] = dense(d)
    return p


def _mlstm_qkv_gates(p, x, heads):
    b, s, d = x.shape
    hd = d // heads
    q = (x @ p["w_q"]).reshape(b, s, heads, hd) * (hd ** -0.5)
    k = (x @ p["w_k"]).reshape(b, s, heads, hd) * (hd ** -0.5)
    v = (x @ p["w_v"]).reshape(b, s, heads, hd)
    log_f = F.logsigmoid((x @ p["w_f"]).float() + p["f_bias"].float())
    log_i = torch.clamp((x @ p["w_i"]).float(), -_CLAMP, _CLAMP)
    return q, k, v, log_f, log_i


def _mlstm_out(p, x, y_aug, heads, shape):
    hd = x.shape[-1] // heads
    num, den = y_aug[..., :hd], y_aug[..., hd:]
    y = num / torch.clamp(den.abs(), min=1.0)
    o = torch.sigmoid(x @ p["w_o"]).reshape(shape)
    return (y * o).reshape(*x.shape) @ p["w_out"]


def mlstm_forward(p: Params, x, *, heads: int, chunk: int = 128, h0=None,
                  return_state: bool = False):
    b, s, d = x.shape
    q, k, v, log_f, log_i = _mlstm_qkv_gates(p, x, heads)
    # ones-column fold-in: engine yields numerator and normalizer together
    v_aug = torch.cat([v, v.new_ones((b, s, heads, 1))], -1)
    y_aug, hf = _engine(q, k, v_aug, log_f, log_i, chunk, h0, return_state)
    out = _mlstm_out(p, x, y_aug, heads, (b, s, heads, d // heads))
    return (out, hf) if return_state else out


def mlstm_decode(p: Params, x, h, *, heads: int):
    b, _, d = x.shape
    q, k, v, log_f, log_i = _mlstm_qkv_gates(p, x, heads)
    v_aug = torch.cat([v, v.new_ones((b, 1, heads, 1))], -1)
    y_aug, hnew = gla_step(h, q[:, 0], k[:, 0], v_aug[:, 0], log_f[:, 0],
                           log_i[:, 0])
    return _mlstm_out(p, x, y_aug, heads, (b, heads, d // heads)), hnew


def mlstm_state_shape(batch: int, d: int, heads: int):
    hd = d // heads
    return (batch, heads, hd, hd + 1)


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM) — true sequential recurrence
# ---------------------------------------------------------------------------

def init_slstm(gen, d: int, dtype, lead: Tuple[int, ...] = (),
               device=None) -> Params:
    return {
        "w_gates": dense_init(gen, d, 4 * d, dtype, lead=lead,
                              device=device),              # i, f, z, o from x
        "r_gates": dense_init(gen, d, 4 * d, dtype, 0.02, lead,
                              device),                     # from h
        "b_gates": torch.zeros((*lead, 4 * d), dtype=dtype, device=device),
        "w_out": dense_init(gen, d, d, dtype, lead=lead, device=device),
    }


def _slstm_cell(p, x_t, carry):
    """x_t: [B, 4d] pre-projected gates; carry: (h, c, n) each [B, d]."""
    h, c, n = carry
    gates = x_t + h @ p["r_gates"] + p["b_gates"]
    i_pre, f_pre, z_pre, o_pre = torch.chunk(gates.float(), 4, -1)
    i = torch.exp(torch.clamp(i_pre, -_CLAMP, _CLAMP))
    f = torch.sigmoid(f_pre)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    c = f * c + i * z
    n = f * n + i
    h_new = (o * c / torch.clamp(n.abs(), min=1.0)).to(x_t.dtype)
    return h_new, c, n


def slstm_forward(p: Params, x, carry=None, return_state: bool = False):
    b, s, d = x.shape
    if carry is None:
        carry = (x.new_zeros((b, d)),
                 torch.zeros((b, d), dtype=torch.float32, device=x.device),
                 torch.zeros((b, d), dtype=torch.float32, device=x.device))
    xg = x @ p["w_gates"]                                 # hoisted matmul
    hs = []
    for t in range(s):
        carry = _slstm_cell(p, xg[:, t], carry)
        hs.append(carry[0])
    out = torch.stack(hs, 1) @ p["w_out"]
    return (out, carry) if return_state else out


def slstm_decode(p: Params, x, carry):
    xg = x[:, 0] @ p["w_gates"]
    new = _slstm_cell(p, xg, carry)
    return (new[0] @ p["w_out"])[:, None], new


def slstm_state_shape(batch: int, d: int):
    return [(batch, d)] * 3
