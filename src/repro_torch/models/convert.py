"""Carries the reference's weights across: ``params_from_jax`` turns
``repro.models.zoo.init_params``'s tree, as numpy arrays
(``jax.tree.map(np.asarray, tree)``), into the port's parameters, so that
both packages compute the same thing. The trees have the same layout leaf
for leaf (stacked layers included; MoE routers and stacked experts,
arctic's dense residual, the enc-dec encoder and decoder stacks); bfloat16
leaves (numpy's ``ml_dtypes`` bfloat16) become ``torch.bfloat16`` bit for
bit."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .. import _device
from ..configs.base import ArchConfig
from . import zoo


def tree_from_numpy(tree: Any, device=None) -> Any:
    """A tree (dicts, lists and tuples) of numpy arrays as the same tree of
    tensors, each of the same dtype and values, on ``device`` (``None``:
    the card)."""
    return _from_numpy(tree, _device.resolve(device))


def _from_numpy(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_from_numpy(v, device) for v in tree)
    a = np.array(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _layout(tree: Any, path: str = ""):
    """(path, shape, dtype name) of every leaf, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _layout(tree[k],
                                                         f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _layout(v, f"{path}/{i}")]
    return [(path, tuple(tree.shape), str(tree.dtype).split(".")[-1])]


def params_from_jax(cfg: ArchConfig, tree: Any, device=None) -> Any:
    """The port's parameters for ``cfg`` from the reference's numpy tree,
    on ``device`` (``None``: the card). A tree whose leaves, shapes or
    dtypes differ from ``cfg``'s parameters raises ``ValueError``."""
    params = tree_from_numpy(tree, device)
    want = _layout(zoo.init_params(cfg, None, "meta"))
    got = _layout(params)
    if got != want:
        diff = next((g, w) for g, w in zip(got + [None], want + [None])
                    if g != w)
        raise ValueError(f"{cfg.name}: the tree is not this config's "
                         f"parameters (got {diff[0]}, expected {diff[1]})")
    return params
