"""Device resolution: the port runs on the card unless asked otherwise."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without a card raises
    ``RuntimeError``: the CPU is used only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def host(t) -> np.ndarray:
    """A copy of a tensor's values as a numpy array on the host, which
    later in-place updates of the tensor leave alone. numpy has no
    bfloat16: a bfloat16 tensor comes back as float32, which holds every
    bfloat16 value exactly."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return np.array(t.numpy())
    return np.asarray(t)


def resolve_for(generator: Optional[torch.Generator],
                device: Optional[Union[str, torch.device]] = None
                ) -> torch.device:
    """``resolve(device)``, where ``generator`` (if any) must draw on that
    device: a generator on another device raises ``ValueError`` instead of
    moving the draws there."""
    dev = resolve(device)
    if generator is not None and generator.device.type != dev.type:
        raise ValueError(
            f"the generator draws on {generator.device} and the device asked "
            f"for is {dev}; pass a torch.Generator(device={dev.type!r})")
    return dev
