"""Chunked gated linear attention (GLA), forward only: the port of
``repro.kernels.gla``.

    H_t = exp(log_decay_t) H_{t-1} + exp(log_inc_t) k_t (x) v_t
    y_t = q_t . H_t

``gla_forward`` replaces ``repro.kernels.gla.gla_forward`` and its Pallas
TPU kernel ``gla_forward_call``: it pads S to a multiple of the chunk
(``log_inc`` with -40, ``log_decay`` with 0), folds ``[B, S, H, .]`` into
``[B*H, S, .]``, runs the hand-written CUDA kernel ``csrc/gla.cu`` on CUDA
tensors (its plain version, ``gla_folded_plain``, on CPU tensors), then
unfolds and crops. ``gla_forward_plain`` is its plain version on
``[B, S, H, .]`` (at float32 also the forward math of
``repro.models.ssm.gla_chunked``).

The kernel path is three kernels, each with its plain version on folded
operands; their composition is ``gla_folded_plain``:

1. ``chunk_states`` (``gla_chunk_states_plain``): every chunk's own state
   ``S_c = (k o exp(clip(tot - cum + li)))^T v`` and its total decay
   ``tot_c``, all chunks at once;
2. ``state_pass`` (``gla_state_pass_plain``): the recurrence over chunks,
   ``H_in(0) = 0``, ``H_in(c+1) = H_in(c) exp(clip(tot_c)) + S_c``;
3. ``chunk_output`` (``gla_chunk_output_plain``): every chunk's output
   ``y = (q k^T o W) v + diag(exp(clip(cum))) q H_in(c)``, all at once.

q, k and v are float32 or bfloat16 (one dtype), the gates are read as
float32, the state stays float32 and y comes back in v's dtype. bfloat16
rounds where the reference's kernel rounds: ``q k^T`` from the bfloat16
operands in float32, ``q k^T o W`` rounded to bfloat16 before it meets v,
the inter-chunk term and the state update in float32 (``(q o e)`` and
``(k o wj)`` are float32), y rounded once at the end. The model's
``gla_chunked`` rounds elsewhere (``models/ssm.py``).
"""
from __future__ import annotations

import functools

import torch

from .. import _device

Tensor = torch.Tensor

CLAMP = 20.0          # log-space clamp: exponents are clipped to [-80, 20]
MAX_CHUNK = 128       # the longest chunk the CUDA kernels take
DTYPES = (torch.float32, torch.bfloat16)   # q, k and v; the gates as float32


def clipped_exp(x: Tensor) -> Tensor:
    """exp(clip(x, -80, 20)), the reference's gate and weight exponent."""
    return torch.exp(torch.clamp(x, -4 * CLAMP, CLAMP))


def rounded(x: Tensor, dtype) -> Tensor:
    """x (float32) rounded to ``dtype`` and widened back: the reference
    kernel's ``(q k^T o W).astype(v.dtype)``."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _chunks(q, k, v, log_decay, log_inc, chunk: int) -> Tensor:
    """The kernel's chunk loop on ``[B, S, H, .]`` with S a multiple of
    ``chunk`` and a zero initial state: y ``[B, S, H, P]`` in v's dtype.
    Masked entries are exp(-80), as in the reference."""
    dtype = v.dtype
    q, k, v = q.float(), k.float(), v.float()
    log_decay, log_inc = log_decay.float(), log_inc.float()
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
        w = clipped_exp(torch.where(tri, logw, -torch.inf))   # [B, L, L, H]
        qk = torch.einsum("blhn,bmhn->blmh", qi, ki)
        y_intra = torch.einsum("blmh,bmhp->blhp", rounded(qk * w, dtype),
                               vi)
        ei = clipped_exp(cum)
        y_inter = torch.einsum("blhn,bhnp->blhp", qi * ei[..., None], hprev)
        tot = cum[:, -1:, :]
        wj = clipped_exp(tot - cum + li)
        dstate = torch.einsum("blhn,blhp->bhnp", ki * wj[..., None], vi)
        hprev = hprev * clipped_exp(tot[:, 0])[:, :, None, None] + dstate
        ys.append(y_intra + y_inter)
    return torch.cat(ys, 1).to(dtype)


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
    """The plain version of ``gla_forward``, with the reference kernel's
    rounding points (at float32 the forward math of
    ``repro.models.ssm.gla_chunked``: y only, zero initial state): q, k
    ``[B, S, H, N]``, v ``[B, S, H, P]``, gates ``[B, S, H]`` -> y
    ``[B, S, H, P]`` in v's dtype, on any device."""
    s = q.shape[1]
    chunk = min(chunk, s)
    return _chunks(*_pad(q, k, v, log_decay, log_inc, chunk), chunk)[:, :s]


def gla_folded_plain(q, k, v, log_decay, log_inc, chunk: int) -> Tensor:
    """The plain version of the CUDA kernel, on its operands: q, k
    ``[BH, S, N]``, v ``[BH, S, P]``, gates ``[BH, S]``, S a multiple of
    ``chunk`` -> y ``[BH, S, P]``."""
    return _chunks(q[:, :, None], k[:, :, None], v[:, :, None],
                   log_decay[:, :, None], log_inc[:, :, None], chunk)[:, :, 0]


def _chunked(a: Tensor, chunk: int) -> Tensor:
    """[BH, S, ...] -> [BH, S / chunk, chunk, ...]."""
    return a.reshape(a.shape[0], a.shape[1] // chunk, chunk, *a.shape[2:])


def gla_chunk_states_plain(k, v, log_decay, log_inc, chunk: int):
    """Stage 1 on folded operands (S a multiple of ``chunk``): each chunk's
    own state ``[BH, nc, N, P]`` (the last chunk's is never read and is
    0 here) and its total log decay ``tot`` ``[BH, nc]``, both float32."""
    cum = torch.cumsum(_chunked(log_decay.float(), chunk), -1)  # [BH, nc, L]
    tot = cum[..., -1].contiguous()
    wj = clipped_exp(tot[..., None] - cum + _chunked(log_inc.float(), chunk))
    states = torch.einsum("bcln,bclp->bcnp",
                          _chunked(k.float(), chunk) * wj[..., None],
                          _chunked(v.float(), chunk))
    states[:, -1] = 0.0
    return states, tot


def gla_state_pass_plain(states, tot) -> Tensor:
    """Stage 2: the state entering each chunk, ``H_in(0) = 0`` and
    ``H_in(c+1) = H_in(c) * exp(clip(tot_c)) + S_c`` (the reference's
    ``h * e_tot + dstate``): ``[BH, nc, N, P]``."""
    h_in = torch.empty_like(states)
    h = torch.zeros_like(states[:, 0])
    for c in range(states.shape[1]):
        h_in[:, c] = h
        h = h * clipped_exp(tot[:, c])[:, None, None] + states[:, c]
    return h_in


def gla_chunk_output_plain(q, k, v, log_decay, log_inc, h_in,
                           chunk: int) -> Tensor:
    """Stage 3: y ``[BH, S, P]`` in v's dtype from each chunk's operands
    and the state entering it. Masked entries are exp(-80), as in the
    reference."""
    dtype = v.dtype
    q, k, v = q.float(), k.float(), v.float()
    log_decay, log_inc = log_decay.float(), log_inc.float()
    cum = torch.cumsum(_chunked(log_decay, chunk), -1)      # [BH, nc, L]
    idx = torch.arange(chunk, device=q.device)
    tri = idx[:, None] >= idx[None, :]
    logw = cum[..., :, None] - cum[..., None, :] + \
        _chunked(log_inc, chunk)[..., None, :]
    w = clipped_exp(torch.where(tri, logw, -torch.inf))   # [BH, nc, L, L]
    qc, kc, vc = (_chunked(a, chunk) for a in (q, k, v))
    qk = torch.einsum("bcin,bcjn->bcij", qc, kc)
    y = torch.einsum("bcij,bcjp->bcip", rounded(qk * w, dtype), vc) + \
        torch.einsum("bcin,bcnp->bcip", qc * clipped_exp(cum)[..., None],
                     h_in)
    return y.reshape(v.shape).to(dtype)


def gla_forward(q, k, v, log_decay, log_inc, chunk: int = 128,
                device=None) -> Tensor:
    """Forward-only chunked GLA, the port of
    ``repro.kernels.gla.gla_forward``: q, k ``[B, S, H, N]``, v
    ``[B, S, H, P]`` float32 or bfloat16, gates ``[B, S, H]`` (read as
    float32) -> y ``[B, S, H, P]`` in v's dtype. Runs on ``device`` (the
    CUDA card unless ``"cpu"`` is named; the inputs are moved there): the
    three CUDA kernels on the card (one call of the kernel path, counted
    once in ``gla_forward.launches``, and a bfloat16 one also in
    ``gla_forward.bf16_launches``), their plain version on the CPU. The
    chunk defines the result (the clamps act on sums within a chunk), so
    it is the caller's: S is padded to a multiple of it, and the kernel
    takes chunks up to ``MAX_CHUNK``."""
    dev = _device.resolve(device)
    args = [torch.as_tensor(x).to(dev) for x in (q, k, v, log_decay,
                                                 log_inc)]
    dtypes = [x.dtype for x in args]
    if dtypes[0] not in DTYPES or dtypes[1:3] != dtypes[:1] * 2 \
            or any(t not in DTYPES for t in dtypes[3:]):
        raise ValueError(f"GLA takes q, k, v of one dtype, float32 or "
                         f"bfloat16, and float32 or bfloat16 gates, not "
                         f"{dtypes}")
    q, k, v = args[:3]
    log_decay, log_inc = (x.float() for x in args[3:])
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
gla_forward.bf16_launches = 0


@functools.lru_cache(maxsize=None)
def _lib():
    import ctypes as c

    from . import _build
    lib = _build.load("gla")
    ptr, i = c.c_void_p, c.c_int
    for name, args in (
            ("gla_forward_launch", [ptr] * 8 + [i] * 5),
            ("gla_chunk_state_launch", [ptr] * 6 + [i] * 5),
            ("gla_state_pass_launch", [ptr] * 2 + [i] * 3),
            ("gla_chunk_output_launch", [ptr] * 7 + [i] * 5)):
        for suffix in ("", "_bf16"):
            if name == "gla_state_pass_launch" and suffix:
                continue                  # the states are float32 alike
            fn = getattr(lib, name.replace("_launch", suffix + "_launch"))
            fn.argtypes = args + [ptr]
            fn.restype = c.c_int
    return lib


def _check_operands(inputs, floats=()) -> str:
    """Checks the kernel operands: ``inputs`` of one dtype in ``DTYPES``,
    ``floats`` (gates, states) float32, all contiguous on one CUDA device.
    Returns the launch functions' suffix for the inputs' dtype."""
    dev = (*inputs, *floats)[0].device
    for t in (*inputs, *floats):
        want = inputs[0].dtype if any(t is x for x in inputs) \
            else torch.float32
        if t.device != dev or t.device.type != "cuda" or t.dtype != want \
                or want not in DTYPES or not t.is_contiguous():
            raise ValueError("GLA kernel operands must be contiguous tensors "
                             "on one CUDA device, q, k and v float32 or "
                             "bfloat16, gates and states float32; got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return "_bf16" if inputs and inputs[0].dtype == torch.bfloat16 else ""


def _call(name: str, tensors, ints, what: str) -> None:
    """One C launch function on the current stream; raises on its status
    (a refused launch never runs, so it is reported here)."""
    dev = tensors[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = getattr(_lib(), name)(*(t.data_ptr() for t in tensors),
                                       *ints, stream)
    if status:
        raise RuntimeError(f"{name} failed: CUDA error {status} ({what})")


def _chunk_count(s: int, chunk: int) -> int:
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"the GLA kernels take chunks of 1 to {MAX_CHUNK} "
                         f"dividing S, not {chunk} for S={s}")
    return s // chunk


def _launch(q, k, v, log_decay, log_inc, chunk: int) -> Tensor:
    """The kernel path of ``gla_forward`` on folded operands: the three
    kernels, one after the other on the current stream, through a state
    buffer ``[BH, nc, N, P]`` and the chunks' total decays ``[BH, nc]``."""
    suffix = _check_operands((q, k, v), (log_decay, log_inc))
    bh, sp, n = q.shape
    p = v.shape[-1]
    nc = _chunk_count(sp, chunk)
    y = torch.empty(bh, sp, p, dtype=v.dtype, device=q.device)
    states = torch.empty(bh, nc, n, p, dtype=torch.float32, device=q.device)
    tot = torch.empty(bh, nc, dtype=torch.float32, device=q.device)
    _call(f"gla_forward{suffix}_launch",
          (q, k, v, log_decay, log_inc, y, states, tot),
          (bh, sp, n, p, chunk),
          f"{v.dtype}, BH={bh}, S={sp}, N={n}, P={p}, chunk={chunk}")
    gla_forward.launches += 1
    if suffix:
        gla_forward.bf16_launches += 1
    return y


def chunk_states(k, v, log_decay, log_inc, chunk: int):
    """Stage 1 alone: ``(states, tot)`` as ``gla_chunk_states_plain``
    gives them, from the ``gla_chunk_state`` kernel on CUDA tensors (the
    last chunk's state and tot are never read, and it leaves them
    unwritten) and from the plain version on CPU tensors."""
    if k.device.type == "cpu":
        return gla_chunk_states_plain(k, v, log_decay, log_inc, chunk)
    suffix = _check_operands((k, v), (log_decay, log_inc))
    bh, sp, n = k.shape
    p = v.shape[-1]
    nc = _chunk_count(sp, chunk)
    states = torch.empty(bh, nc, n, p, dtype=torch.float32, device=k.device)
    tot = torch.empty(bh, nc, dtype=torch.float32, device=k.device)
    _call(f"gla_chunk_state{suffix}_launch",
          (k, v, log_decay, log_inc, states, tot),
          (bh, sp, n, p, chunk), f"{v.dtype}, BH={bh}, S={sp}, N={n}, P={p}")
    return states, tot


def state_pass(states, tot) -> Tensor:
    """Stage 2 alone: ``H_in`` as ``gla_state_pass_plain`` gives it. The
    ``gla_state_pass`` kernel turns ``states`` into ``H_in`` in place on
    CUDA tensors; the plain version returns a new tensor on CPU ones."""
    if states.device.type == "cpu":
        return gla_state_pass_plain(states, tot)
    _check_operands((), (states, tot))
    bh, nc, n, p = states.shape
    _call("gla_state_pass_launch", (states, tot), (bh, nc, n * p),
          f"BH={bh}, nc={nc}, N*P={n * p}")
    return states


def chunk_output(q, k, v, log_decay, log_inc, h_in, chunk: int) -> Tensor:
    """Stage 3 alone: y as ``gla_chunk_output_plain`` gives it, from the
    ``gla_chunk_output`` kernel on CUDA tensors."""
    if q.device.type == "cpu":
        return gla_chunk_output_plain(q, k, v, log_decay, log_inc, h_in,
                                      chunk)
    suffix = _check_operands((q, k, v), (log_decay, log_inc, h_in))
    bh, sp, n = q.shape
    p = v.shape[-1]
    _chunk_count(sp, chunk)
    y = torch.empty(bh, sp, p, dtype=v.dtype, device=q.device)
    _call(f"gla_chunk_output{suffix}_launch",
          (q, k, v, log_decay, log_inc, h_in, y),
          (bh, sp, n, p, chunk), f"{v.dtype}, BH={bh}, S={sp}, N={n}, P={p}")
    return y
