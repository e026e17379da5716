"""Chunked gated linear attention (GLA), forward only: the port of
``repro.kernels.gla``.

    H_t = exp(log_decay_t) H_{t-1} + exp(log_inc_t) k_t (x) v_t
    y_t = q_t . H_t

``gla_forward`` replaces ``repro.kernels.gla.gla_forward`` and its Pallas
TPU kernel ``gla_forward_call``: it pads S to a multiple of the chunk
(``log_inc`` with -40, ``log_decay`` with 0), folds ``[B, S, H, .]`` into
``[B*H, S, .]``, runs the hand-written CUDA kernel ``csrc/gla.cu`` on CUDA
tensors (its plain version, ``gla_folded_plain``, on CPU tensors), then
unfolds and crops. ``gla_forward_plain`` is the forward math of
``repro.models.ssm.gla_chunked`` in torch, on ``[B, S, H, .]``.

float32 only. The reference's kernel also takes bf16, but its tests run
float32 only; bf16 waits for the LM substrate.
"""
from __future__ import annotations

import functools

import torch

from .. import _device

Tensor = torch.Tensor

CLAMP = 20.0          # log-space clamp: exponents are clipped to [-80, 20]
MAX_CHUNK = 128       # the longest chunk the CUDA kernel takes
_BF16_ITEM = ("ROADMAP.md, port order item 8 (the LM substrate, with bf16 "
              "GLA)")


def _clipped_exp(x: Tensor) -> Tensor:
    return torch.exp(torch.clamp(x, -4 * CLAMP, CLAMP))


def _chunks(q, k, v, log_decay, log_inc, chunk: int) -> Tensor:
    """``gla_chunked``'s chunk loop on ``[B, S, H, .]`` with S a multiple
    of ``chunk`` and a zero initial state: y ``[B, S, H, P]``. Masked
    entries are exp(-80), as in the reference."""
    b, sp, h, n = q.shape
    p = v.shape[-1]
    idx = torch.arange(chunk, device=q.device)
    tri = (idx[:, None] >= idx[None, :])[None, :, :, None]
    hprev = torch.zeros(b, h, n, p, dtype=torch.float32, device=q.device)
    ys = []
    for c0 in range(0, sp, chunk):
        sl = slice(c0, c0 + chunk)
        qi, ki, vi, li = q[:, sl], k[:, sl], v[:, sl], log_inc[:, sl]
        cum = torch.cumsum(log_decay[:, sl], 1)                 # [B, L, H]
        logw = cum[:, :, None] - cum[:, None, :] + li[:, None, :]
        w = _clipped_exp(torch.where(tri, logw, -torch.inf))   # [B, L, L, H]
        qk = torch.einsum("blhn,bmhn->blmh", qi, ki)
        y_intra = torch.einsum("blmh,bmhp->blhp", qk * w, vi)
        ei = _clipped_exp(cum)
        y_inter = torch.einsum("blhn,bhnp->blhp", qi * ei[..., None], hprev)
        tot = cum[:, -1:, :]
        wj = _clipped_exp(tot - cum + li)
        dstate = torch.einsum("blhn,blhp->bhnp", ki * wj[..., None], vi)
        hprev = hprev * _clipped_exp(tot[:, 0])[:, :, None, None] + dstate
        ys.append(y_intra + y_inter)
    return torch.cat(ys, 1)


def _pad(q, k, v, log_decay, log_inc, chunk: int):
    """Pad S up to a multiple of ``chunk``: zeros, and -2*CLAMP for
    ``log_inc`` (a padded step adds nothing to the state)."""
    pad = (-q.shape[1]) % chunk
    if not pad:
        return q, k, v, log_decay, log_inc

    def cat(a, value=0.0):
        tail = a.new_full((a.shape[0], pad) + tuple(a.shape[2:]), value)
        return torch.cat((a, tail), 1)

    return (cat(q), cat(k), cat(v), cat(log_decay),
            cat(log_inc, -2 * CLAMP))


def gla_forward_plain(q, k, v, log_decay, log_inc,
                      chunk: int = 128) -> Tensor:
    """The forward math of ``repro.models.ssm.gla_chunked`` (y only, zero
    initial state): q, k ``[B, S, H, N]``, v ``[B, S, H, P]``, gates
    ``[B, S, H]`` -> y ``[B, S, H, P]``, on any device."""
    s = q.shape[1]
    chunk = min(chunk, s)
    return _chunks(*_pad(q, k, v, log_decay, log_inc, chunk), chunk)[:, :s]


def gla_folded_plain(q, k, v, log_decay, log_inc, chunk: int) -> Tensor:
    """The plain version of the CUDA kernel, on its operands: q, k
    ``[BH, S, N]``, v ``[BH, S, P]``, gates ``[BH, S]``, S a multiple of
    ``chunk`` -> y ``[BH, S, P]``."""
    return _chunks(q[:, :, None], k[:, :, None], v[:, :, None],
                   log_decay[:, :, None], log_inc[:, :, None], chunk)[:, :, 0]


def gla_forward(q, k, v, log_decay, log_inc, chunk: int = 128,
                device=None) -> Tensor:
    """Forward-only chunked GLA, the port of
    ``repro.kernels.gla.gla_forward``: q, k ``[B, S, H, N]``, v
    ``[B, S, H, P]``, gates ``[B, S, H]`` -> y ``[B, S, H, P]`` float32.
    Runs on ``device`` (the CUDA card unless ``"cpu"`` is named; the
    inputs are moved there): ONE launch of the CUDA kernel on the card,
    its plain version on the CPU. The chunk defines the result (the clamps
    act on sums within a chunk), so it is the caller's: S is padded to a
    multiple of it, and the kernel takes chunks up to ``MAX_CHUNK``."""
    dev = _device.resolve(device)
    args = [torch.as_tensor(x).to(dev) for x in (q, k, v, log_decay,
                                                 log_inc)]
    for x in args:
        if x.dtype == torch.bfloat16:
            raise NotImplementedError(
                f"bf16 GLA is not ported yet: {_BF16_ITEM}")
        if x.dtype != torch.float32:
            raise ValueError(f"GLA takes float32 inputs, not {x.dtype}")
    q, k, v, log_decay, log_inc = args
    b, s, h, n = q.shape
    p = v.shape[-1]
    shapes = [tuple(x.shape) for x in args]
    if shapes != [(b, s, h, n)] * 2 + [(b, s, h, p)] + [(b, s, h)] * 2:
        raise ValueError(f"GLA operand shapes {shapes}: want q, k "
                         f"[B,S,H,N], v [B,S,H,P], gates [B,S,H]")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    padded = _pad(q, k, v, log_decay, log_inc, chunk)
    sp = padded[0].shape[1]

    def fold(a):
        return a.transpose(1, 2).reshape(b * h, sp, *a.shape[3:]).contiguous()

    folded = [fold(a) for a in padded]
    length = min(chunk, sp)
    if dev.type == "cpu":
        y = gla_folded_plain(*folded, length)
    else:
        y = _launch(*folded, length)
    return y.reshape(b, h, sp, p).transpose(1, 2)[:, :s]


gla_forward.launches = 0


@functools.lru_cache(maxsize=None)
def _lib():
    import ctypes as c

    from . import _build
    lib = _build.load("gla")
    lib.gla_forward_launch.argtypes = [c.c_void_p] * 6 + [c.c_int] * 5 + [
        c.c_void_p]
    lib.gla_forward_launch.restype = c.c_int
    return lib


def _launch(q, k, v, log_decay, log_inc, chunk: int) -> Tensor:
    """The kernel path of ``gla_forward`` on folded operands."""
    if chunk > MAX_CHUNK:
        raise ValueError(f"the GLA kernel takes chunks of at most "
                         f"{MAX_CHUNK}, not {chunk}")
    for t in (q, k, v, log_decay, log_inc):
        if t.device != q.device or t.device.type != "cuda" \
                or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("GLA kernel operands must be contiguous float32 "
                             f"tensors on one CUDA device; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    bh, sp, n = q.shape
    p = v.shape[-1]
    y = torch.empty(bh, sp, p, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = _lib().gla_forward_launch(
            *(t.data_ptr() for t in (q, k, v, log_decay, log_inc, y)),
            bh, sp, n, p, chunk, stream)
    if status:
        raise RuntimeError(
            f"GLA kernel launch failed: CUDA error {status} (BH={bh}, "
            f"S={sp}, N={n}, P={p}, chunk={chunk}; the kernel keeps "
            f"64*N + chunk*(chunk+135) floats in shared memory, at most "
            f"227 KB)")
    gla_forward.launches += 1
    return y
