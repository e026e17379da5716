"""Counter-based stateless RNG, bit-exact with ``repro.core.rng``.

A 32-bit mixing hash of ``(seed, iteration, stream, element index)``: two
rounds of the murmur3 fmix32 finalizer over a Weyl-summed counter. The CUDA
kernels compute it with native ``uint32_t``; PyTorch has no uint32
arithmetic, so this plain version holds each uint32 value in int64 and
masks with ``& 0xFFFFFFFF`` after every multiply and add. A product of two
32-bit values may wrap in int64, but its low 32 bits stay right; shifts are
applied only to masked (non-negative) values.

Arguments may be Python ints or int64 tensors; ints fold on the host.
"""
from __future__ import annotations

import torch

from .. import _device

_M = 0xFFFFFFFF

# Weyl constants (odd, high-entropy) for combining counter components.
_W0 = 0x9E3779B9  # golden-ratio
_W1 = 0x85EBCA6B
_W2 = 0xC2B2AE35
_W3 = 0x27D4EB2F


def _u32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M
    return int(x) & _M


def _mix(x):
    """murmur3 fmix32 finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = (x * _W1) & _M
    x = x ^ (x >> 13)
    x = (x * _W2) & _M
    x = x ^ (x >> 16)
    return x


def hash_u32(seed, iteration, stream, index):
    """uint32 hash (as int64 in [0, 2**32)) of the 4-component counter."""
    seed, iteration, stream, index = map(_u32,
                                         (seed, iteration, stream, index))
    h = ((seed * _W0) & _M) + ((iteration * _W1) & _M) + ((stream * _W2) & _M)
    h = (h + ((index * _W3) & _M)) & _M
    h = _mix(h)
    # Second round decorrelates consecutive indices fully.
    h = _mix(h ^ ((((index * _W0) & _M) + ((iteration * _W2) & _M)) & _M))
    return h


def uniform(seed, iteration, stream, index,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Uniform in [0, 1) with 24 bits of mantissa entropy."""
    bits = hash_u32(seed, iteration, stream, index)
    return (bits >> 8).to(dtype) * (1.0 / (1 << 24))


def uniform_grid(seed, iteration, stream, n, d,
                 dtype: torch.dtype = torch.float32, device=None
                 ) -> torch.Tensor:
    """Uniform [n, d] grid keyed by flat element index, the common PSO
    shape, on ``device`` (``None``: the card). The indices are int64 (the
    reference's are uint32): torch on the CPU has no uint32 ``arange``."""
    idx = torch.arange(n * d, dtype=torch.int64,
                       device=_device.resolve(device)).reshape(n, d)
    return uniform(seed, iteration, stream, idx, dtype=dtype)
