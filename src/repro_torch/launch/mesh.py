"""Port of ``src/repro/launch/mesh.py``: mesh construction.

In place of ``jax.make_mesh`` a mesh here is a small record (axis names,
shape, device). The port runs on one device, so ``make_mesh`` makes only a
mesh of one device. The production meshes (256 and 512 devices) are
abstract: ``make_production_mesh`` places them on ``meta``, where nothing
computes a value, for the dry run (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import (MULTI_POD_MESH, SINGLE_POD_MESH,
                                      SMOKE_MESH, MeshConfig)


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    shape: tuple
    device: torch.device


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The target deployment mesh on ``meta``: 16x16 (256 devices) or
    2x16x16 (two pods, 512 devices, the 'pod' axis across pods)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape, torch.device("meta"))


def make_mesh(cfg: MeshConfig, device=None) -> Mesh:
    """``cfg``'s mesh on ``device`` (the card unless another is named);
    only a one-device config can be made."""
    if cfg.num_devices != 1:
        raise NotImplementedError(
            f"mesh {cfg.shape} over {cfg.axis_names} needs "
            f"{cfg.num_devices} devices; the port runs on one "
            "(ROADMAP A, item 16)")
    return Mesh(tuple(cfg.axis_names), tuple(cfg.shape),
                resolve_device(device))


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
