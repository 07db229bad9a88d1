"""Port of ``src/repro/launch/mesh.py``: mesh construction.

In place of ``jax.make_mesh`` a mesh here is a small record (axis names,
shape, this rank's device and, over more than one rank, the
``DeviceMesh``). With no process group up, ``make_mesh`` makes a mesh of
one device, a plain record. Inside a group (torchrun, or
``repro_torch._dist.init``) it builds the ``DeviceMesh`` over the whole
group, whose size must be the mesh's device count: one rank per device,
NCCL on the card, gloo on the CPU. The production meshes (256 and 512
devices) are abstract: ``make_production_mesh`` places them on ``meta``,
where nothing computes a value, for the dry run (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import _dist
from repro_torch._device import resolve_device
from repro_torch.configs.base import (MULTI_POD_MESH, SINGLE_POD_MESH,
                                      SMOKE_MESH, MeshConfig)


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    shape: tuple
    device: torch.device  # this rank's device
    # the DeviceMesh over the group; whether a mesh places tensors is
    # sharding.rules.placing's to say
    device_mesh: Optional[object] = None


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The target deployment mesh on ``meta``: 16x16 (256 devices) or
    2x16x16 (two pods, 512 devices, the 'pod' axis across pods)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape, torch.device("meta"))


def make_mesh(cfg: MeshConfig, device=None) -> Mesh:
    """``cfg``'s mesh on ``device`` (the card unless another is named):
    with no process group, a one-device record; inside one, the
    ``DeviceMesh`` over the group in ``cfg``'s axis order, each rank on
    its own device. Raises if the group's size is not ``cfg``'s device
    count or its backend is not the device's."""
    names, shape = tuple(cfg.axis_names), tuple(cfg.shape)
    if not _dist.is_initialized() and cfg.num_devices == 1:
        return Mesh(names, shape, resolve_device(device))
    dm = _dist.device_mesh(shape, names, device)
    return Mesh(names, shape, _dist.rank_device(device), dm)


def make_smoke_mesh(device=None) -> Mesh:
    """1x1 mesh over one device (smoke tests / examples)."""
    return make_mesh(SMOKE_MESH, device)


def mesh_config_for(mesh) -> MeshConfig:
    names = tuple(mesh.axis_names)
    if names == ("pod", "data", "model"):
        return MULTI_POD_MESH
    if names == ("data", "model"):
        if tuple(mesh.shape) == (16, 16):
            return SINGLE_POD_MESH
        return MeshConfig(shape=tuple(mesh.shape), axis_names=names)
    return MeshConfig(shape=tuple(mesh.shape), axis_names=names)
