"""Meshes: named device axes, as `jax.sharding.Mesh` names them.

The port's `Mesh` is a plain record: the axis names, their sizes
(`shape`, read like `jax.sharding.Mesh.shape`) and the devices behind
them: this process's one device, or under `torch.distributed` one device
a rank (`world_size` of them).  The sharding rules (`dist/sharding.py`)
resolve logical axes against it.  Functions, not module constants, so
importing touches no device.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.kernels.common import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    #: the devices behind the mesh (empty: a mesh described, not placed)
    devices: Tuple[torch.device, ...] = ()

    @property
    def shape(self) -> Dict[str, int]:
        return collections.OrderedDict(zip(self.axis_names, self.sizes))

    @property
    def local_device(self) -> torch.device:
        """This process's device: its rank's under torch.distributed."""
        if not self.devices:
            raise ValueError(f"mesh {dict(self.shape)} has no devices here")
        rank = (torch.distributed.get_rank()
                if torch.distributed.is_available()
                and torch.distributed.is_initialized() else 0)
        return self.devices[rank % len(self.devices)]


def make_mesh(sizes: Sequence[int], axis_names: Sequence[str],
              devices: Sequence[torch.device] = ()) -> Mesh:
    if len(sizes) != len(axis_names):
        raise ValueError(f"{len(sizes)} sizes for axes {tuple(axis_names)}")
    return Mesh(tuple(axis_names), tuple(int(s) for s in sizes),
                tuple(devices))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (16, 16) = 256 devices ("data", "model").
    Multi-pod:  (2, 16, 16) = 512 devices ("pod", "data", "model").
    Described only: no process here holds its devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(model_axis: int = 1, device=None) -> Mesh:
    """("data", "model") over what this process runs on: the world's
    ranks under torch.distributed (one device each), else the one
    resolved device (None: CUDA, raising without a card), however many
    cards the host shows: a single-device trainer splits no axis."""
    dev = resolve_device(device)
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        n = torch.distributed.get_world_size()
    else:
        n = 1
    if n % model_axis:
        raise ValueError(f"{n} devices do not split into model={model_axis}")
    return make_mesh((n // model_axis, model_axis), ("data", "model"),
                     [dev] * n)
