"""Device meshes, the port of ``repro.launch.mesh``.

A ``Mesh`` here is a descriptor: axis names and their sizes, the two
things the sharding rules read (``mesh.shape[axis]``,
``mesh.axis_names``), as a ``jax.sharding.Mesh`` offers them. It creates
no process group and touches no device, so the reference's production
meshes can be described (and their specs computed) on any host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @property
    def name(self) -> str:
        return "x".join(str(s) for s in self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes: (16, 16) over (data, model), or
    (2, 16, 16) over (pod, data, model)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh(model: int = 1) -> Mesh:
    """The visible cards as (data, model) = (n // model, model); a host
    with no card counts as one device."""
    n = max(torch.cuda.device_count(), 1)
    if n % model:
        raise ValueError(f"{n} devices do not split into model axes of "
                         f"{model}")
    return Mesh(("data", "model"), (n // model, model))


def data_axes(mesh) -> tuple:
    """Axes that shard the batch/particles."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
