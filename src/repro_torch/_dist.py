"""The port's process group: join or start it, pick its backend from the
device, map a rank to its device, build a ``DeviceMesh`` over it, tear it
down.

One rank runs on one device: ``cuda:{LOCAL_RANK}`` over NCCL, or the CPU
over gloo when the caller names the CPU (the tests' ranks). A group is
joined from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or, for spawned workers
and tests, from an explicit rank, world size and init file, which no two
concurrent groups share (no fixed port to collide on). Nothing here falls
back: a world size that differs from the mesh's device count, or a CUDA
mesh on a gloo group, raises.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device) -> str:
    """The collective backend of ``device``'s type: NCCL for CUDA, gloo
    for the CPU."""
    kind = torch.device("cuda" if device is None else device).type
    if kind not in BACKENDS:
        raise ValueError(f"no process-group backend for device type {kind!r}")
    return BACKENDS[kind]


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The group's size; 1 with no group."""
    return dist.get_world_size() if is_initialized() else 1


def launched_world_size() -> int:
    """The world size a launcher asked for: the group's, or torchrun's
    ``WORLD_SIZE`` before the group is joined; 1 for a lone process."""
    if is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _check_backend(device) -> None:
    want, got = backend_for(device), dist.get_backend()
    if got != want:
        raise RuntimeError(
            f"the process group runs {got}, and a {torch.device(device).type}"
            f" mesh needs {want}: start the group for the mesh's device")


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:{local rank}`` (the device ``init`` made
    current) or the CPU."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(kind)


def init(device=None, *, rank: int = None, world_size: int = None,
         init_file: str = None) -> torch.device:
    """Join the process group for ``device`` (the card unless another is
    named) and -> this rank's device.

    With ``rank`` None the group comes from torchrun's environment;
    otherwise this process is ``rank`` of ``world_size``, meeting the
    others through ``init_file`` (a path no other group uses). A CUDA
    rank takes card ``LOCAL_RANK`` (its rank when unset). A CPU rank runs torch on one thread: several ranks share the
    host's cores. If the group is already up, only its backend is
    checked."""
    backend = backend_for(device)
    kind = torch.device("cuda" if device is None else device).type
    if is_initialized():
        _check_backend(kind)
        return rank_device(kind)
    if rank is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        init_method = "env://"
    else:
        if world_size is None or init_file is None:
            raise ValueError("an explicit rank needs world_size and init_file")
        init_method = "file://" + os.path.abspath(init_file)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    kw = {}
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA rank needs a CUDA device and none is "
                               "available; pass device='cpu'")
        torch.cuda.set_device(local_rank)
        kw["device_id"] = torch.device("cuda", local_rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    return rank_device(kind)


def device_mesh(shape: tuple, axis_names: tuple, device=None):
    """A ``DeviceMesh`` of ``shape`` over the whole group, its dims named
    ``axis_names`` in that order (rank-major: the last axis varies
    fastest, as ``jax.make_mesh`` lays devices out)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not is_initialized():
        raise RuntimeError(
            f"a mesh of {shape} over {axis_names} needs a process group of "
            f"that many ranks: launch with torchrun or call "
            f"repro_torch._dist.init")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(
            f"mesh {tuple(shape)} over {tuple(axis_names)} needs {n} ranks; "
            f"the process group has {dist.get_world_size()}")
    _check_backend(device)
    kind = torch.device("cuda" if device is None else device).type
    return init_device_mesh(kind, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def shutdown() -> None:
    """Leave the process group, if one is up."""
    if is_initialized():
        dist.destroy_process_group()
