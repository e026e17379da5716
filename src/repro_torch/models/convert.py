"""Carries the reference's weights across: ``params_from_jax`` turns
``repro.models.zoo.init_params``'s tree, as numpy arrays
(``jax.tree.map(np.asarray, tree)``), into the port's parameters, so that
both packages compute the same thing. The trees have the same layout leaf
for leaf (stacked layers included); bfloat16 leaves (numpy's ``ml_dtypes``
bfloat16) become ``torch.bfloat16`` bit for bit."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..configs.base import ArchConfig
from . import transformer, zoo


def tree_from_numpy(tree: Any, device=None) -> Any:
    """A tree (dicts, lists and tuples) of numpy arrays as the same tree of
    tensors, each of the same dtype and values, on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_numpy(v, device) for v in tree)
    a = np.array(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_jax(cfg: ArchConfig, tree: Any, device=None) -> Any:
    """The port's parameters from the reference's numpy tree, on ``device``
    (the CPU by default). A family the port cannot run yet (MoE, enc-dec)
    raises."""
    zoo._no_encdec(cfg)
    transformer._no_moe(cfg)
    return tree_from_numpy(tree, device)
