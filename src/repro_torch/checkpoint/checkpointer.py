"""Checkpointing: atomic and elastic, the port of ``repro.checkpoint``.

Layout: ``<dir>/step_<k:08d>/shard_0.npz`` plus ``manifest.json``, written
to a tmp dir and ``os.rename``d (atomic on POSIX), so a crash mid-write
never corrupts the latest checkpoint; ``latest_step`` counts complete
manifests only.

A tree is flattened as ``jax.tree_util`` flattens it: dict keys sorted,
``None`` dropping out (a synchronous ``SwarmState``'s ``lbest_*``), every
leaf named by its ``keystr`` path (``['w']``, ``.pos``, ``[0]``; a
NamedTuple's fields are keyed from ``_fields``). bfloat16 is stored as a
``uint16`` view and named ``"bfloat16"`` in the manifest's ``dtypes``. So a
file written by either package restores in the other. Leaves may be
tensors or Python numbers (the port's ``SwarmState`` keeps
``iteration`` and ``seed`` as ints, stored as int64; restore casts to the
template's dtype, so a reference file's int32/uint32 counters and a seed
above 2**31 come back as the same ints).

Elasticity: arrays are the swarm's global arrays, so a checkpoint of an
island run restores at any island count (``core.distributed`` re-splits by
global particle index). One process writes ``shard_0.npz``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import _device


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A restore template's stand-in for a tensor: its shape and torch
    dtype (``jax.ShapeDtypeStruct``'s part)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map(tree, fn: Callable[[str, Any], Any], path: str = ""):
    """``tree`` rebuilt with every leaf replaced by ``fn(keystr, leaf)``, in
    jax's flattening order; ``None`` stays ``None`` and is never a leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _map(tree[k], fn, f"{path}[{k!r}]") for k in sorted(tree)}
        return type(tree)((k, out[k]) for k in tree)
    if _is_namedtuple(tree):
        return type(tree)(*(_map(getattr(tree, f), fn, f"{path}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(x, fn, f"{path}[{i}]")
                          for i, x in enumerate(tree))
    return fn(path, tree)


def _leaves(tree):
    out = []
    _map(tree, lambda name, leaf: out.append((name, leaf)))
    return out


def stand_ins(tree):
    """``tree`` with every tensor replaced by its ``ShapeDtype`` (numbers
    kept): a restore template that holds no data."""
    return _map(tree, lambda _, x: ShapeDtype(tuple(x.shape), x.dtype)
                if isinstance(x, torch.Tensor) else x)


def _key(name: str) -> str:
    return name.replace("/", "_")       # npz keys may not contain '/'


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the array stored in the npz and its dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:     # npz cannot encode bf16
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree: Any, *,
         extra_meta: Optional[Dict] = None) -> str:
    """Atomic checkpoint write. Returns the final directory path."""
    flat = _leaves(tree)
    if any(isinstance(x, torch.Tensor) and x.is_cuda for _, x in flat):
        torch.cuda.synchronize()
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=f".tmp_step_{step}_", dir=ckpt_dir)
    try:
        arrays = {}
        meta = {"step": step, "dtypes": {}, "treedef": None,
                "extra": extra_meta or {}}
        for name, leaf in flat:
            arrays[_key(name)], meta["dtypes"][_key(name)] = _to_numpy(leaf)
        np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)
        meta["paths"] = [name for name, _ in flat]
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and os.path.exists(
                      os.path.join(ckpt_dir, d, "manifest.json")))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, template: Any, device=None) -> Any:
    """Restore into the structure of ``template``: a tree of tensors,
    ``ShapeDtype`` stand-ins or Python numbers. Each tensor leaf is cast to
    its template's dtype and placed on ``device``; with ``device=None`` on
    its template tensor's device, and a stand-in on the card. A number
    leaf comes back as a number of its type. A shape that differs from the
    template's raises ``ValueError``."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    dev = None if device is None else _device.resolve(device)
    with np.load(os.path.join(path, "shard_0.npz")) as data:

        def leaf(name, tmpl):
            key = _key(name)
            arr = data[key]
            shape = (tuple(tmpl.shape) if isinstance(
                tmpl, (torch.Tensor, ShapeDtype)) else ())
            if tuple(arr.shape) != shape:
                raise ValueError(
                    f"checkpoint/template shape mismatch at {name}: "
                    f"{arr.shape} vs {shape}")
            if manifest["dtypes"].get(key) == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))
            if isinstance(tmpl, torch.Tensor):
                return t.to(device=dev or tmpl.device, dtype=tmpl.dtype)
            if isinstance(tmpl, ShapeDtype):
                return t.to(device=dev or _device.resolve(None),
                            dtype=tmpl.dtype)
            return type(tmpl)(arr.item())

        return _map(template, leaf)


def restore_latest(ckpt_dir: str, template: Any, device=None):
    """(step, tree) of the newest complete checkpoint, or (None, None)."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    return step, restore(ckpt_dir, step, template, device)


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` complete checkpoints."""
    for s in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
