"""Port of ``src/repro/checkpoint/ckpt.py``: checkpointing in the
reference's on-disk format (manifest + per-leaf npz, integrity checksums,
an async writer thread, keep-last-k GC), so a checkpoint written by
either package loads in the other.

Layout:
    <dir>/step_000123/
        manifest.json   # step, leaf index, shapes/dtypes, crc32s, meta
        arrays.npz      # flattened key -> host ndarray

Leaf names are the reference's (``_flatten_with_names``, from jax's key
paths): a dict key, a sequence index, and for a ``NamedTuple`` field
``.field``, joined by ``/`` (``0/embed/embedding``, ``1/.count``,
``1/.m/embed/embedding`` for a ``(params, OptState)`` tree). A bfloat16
leaf, which npz cannot hold, is stored as its raw bytes in ``uint8``, as
the reference stores its ``ml_dtypes`` leaves; it is read back through a
tensor view, so no ``ml_dtypes`` is needed.

A tree of DTensors (laid out over a process group) is saved as its full
leaves: every rank takes part in gathering each leaf, rank 0 writes, and
the others wait for the publish, so the files are byte for byte those of
the one-device save. Restoring takes ``device=``, or ``shardings=`` as
the reference does: each leaf laid out by its ``sharding/rules.Sharding``,
whatever mesh saved it (an elastic restart).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import _tree
from repro_torch.sharding.rules import gather, place

# numpy has no bfloat16: such leaves travel as raw bytes
_RAW = {"bfloat16": torch.bfloat16}


def _flatten_with_names(tree):
    """-> {name: leaf} in ``jax.tree.flatten`` order, named as the
    reference names them."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, tuple) and hasattr(type(node), "_fields"):
            for f, c in zip(node._fields, node):
                walk(c, path + (f".{f}",))
        elif isinstance(node, (list, tuple)):
            for i, c in enumerate(node):
                walk(c, path + (str(i),))
        else:
            out["/".join(path)] = node

    walk(tree, ())
    return out


def _crc32s(arrays) -> list:
    """The crc32 of each array's bytes, read in place, on a few threads
    (zlib lets go of the GIL over a large buffer)."""
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(lambda v: zlib.crc32(np.ascontiguousarray(v)),
                             arrays))


def _host(leaf) -> np.ndarray:
    """A leaf as a host array of its own bytes (a copy, so later in-place
    steps cannot reach a pending write); bf16 as its raw ``uint8``
    bytes, with the shape numpy's ``view(np.uint8)`` gives."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf, copy=True)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def save_checkpoint(directory: str, step: int, tree, *,
                    meta: Optional[dict] = None, blocking: bool = True):
    """Leaves are copied to the host, then written (npz + manifest); with
    ``blocking=False`` the write runs on a thread, which is returned. A
    tree with DTensor leaves is gathered (every rank must call) and
    written by rank 0 while the others wait; such a save blocks."""
    named = _flatten_with_names(tree)
    if any(isinstance(v, DTensor) for v in named.values()):
        return _save_gathered(directory, step, tree, meta)
    tmp = os.path.join(directory, f"step_{step:09d}.tmp")
    final = os.path.join(directory, f"step_{step:09d}")
    os.makedirs(tmp, exist_ok=True)
    host = {k: (_host(v), _dtype_name(v), tuple(v.shape))
            for k, v in named.items()}

    def _write():
        manifest = {"step": step, "meta": meta or {}, "leaves": {}}
        savable = {}
        crcs = _crc32s([v for v, _, _ in host.values()])
        for (k, (v, dtype, shape)), crc in zip(host.items(), crcs):
            manifest["leaves"][k] = {"shape": list(shape), "dtype": dtype,
                                     "crc32": crc}
            savable[k] = v
        np.savez(os.path.join(tmp, "arrays.npz"), **savable)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _save_gathered(directory, step, tree, meta):
    """Every rank gathers each leaf; rank 0 copies it to the host and
    writes the one-device save of the full tree; all wait for it."""
    leaves, treedef = _tree.flatten(tree)
    full = []
    for v in leaves:
        g = gather(v)
        full.append(g.detach().to("cpu", copy=True)
                    if dist.get_rank() == 0 else None)
        del g
    if dist.get_rank() == 0:
        save_checkpoint(directory, step, _tree.unflatten(treedef, full),
                        meta=meta, blocking=True)
    dist.barrier()
    return None


def list_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            steps.append(int(name.split("_")[1]))
    return sorted(steps)


def _tensor(v: np.ndarray, info: dict) -> torch.Tensor:
    want = info["dtype"]
    if want in _RAW and v.dtype == np.uint8:  # raw bytes: reinterpret
        return torch.from_numpy(np.ascontiguousarray(v)).view(
            _RAW[want]).reshape(info["shape"])
    if want in _RAW:
        raise ValueError(f"{want} leaf stored as {v.dtype}, not raw bytes")
    if str(v.dtype) != want:
        raise ValueError(f"leaf stored as {v.dtype}, manifest says {want}")
    return torch.from_numpy(v)  # a fresh array read from the npz


def load_checkpoint(directory: str, template, *, step: Optional[int] = None,
                    device=None, shardings=None, verify: bool = True):
    """Restore into ``template``'s structure (tensors, ``meta`` ones and
    DTensors too), each leaf cast to its template's dtype, on ``device``
    (default: the template leaf's device, the host for a ``meta`` one).
    ``shardings``: a tree of the same structure whose leaves are
    ``Sharding``s (or None); each leaf is then laid out by its own on its
    mesh's devices, whatever mesh saved it (every rank reads the file
    and keeps its shard). Returns (tree, step, meta)."""
    steps = list_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    step = steps[-1] if step is None else step
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = np.load(os.path.join(path, "arrays.npz"))
    named_t = _flatten_with_names(template)
    missing = [k for k in named_t if k not in manifest["leaves"]]
    if missing:
        raise KeyError(f"checkpoint missing leaf {missing[0]}")
    stored = {k: arrays[k] for k in named_t}
    if verify:
        for k, crc in zip(stored, _crc32s(list(stored.values()))):
            if crc != manifest["leaves"][k]["crc32"]:
                raise IOError(f"checksum mismatch for {k}")
    shs = [None] * len(named_t) if shardings is None else \
        _tree.leaves(shardings)
    if len(shs) != len(named_t):
        raise ValueError("load_checkpoint: shardings and template differ in "
                         "leaves")
    out = []
    for (k, tmpl), sh in zip(named_t.items(), shs):
        v, info = stored.pop(k), manifest["leaves"][k]
        t = _tensor(v, info)
        if tuple(t.shape) != tuple(tmpl.shape):
            raise ValueError(
                f"shape mismatch for {k}: ckpt {tuple(t.shape)} vs template "
                f"{tuple(tmpl.shape)}")
        dev = device
        if sh is not None:
            dev = sh.mesh.device
        elif dev is None:
            dev = _device_of(tmpl)
        out.append(place(t.to(dev, tmpl.dtype), sh))
    return (_tree.unflatten(_tree.flatten(template)[1], out), step,
            manifest["meta"])


def _device_of(tmpl) -> torch.device:
    """Where a template leaf's restored value goes: its device (this
    rank's, for a DTensor), the host for a ``meta`` one."""
    dev = (tmpl.to_local() if isinstance(tmpl, DTensor) else tmpl).device
    return dev if dev.type != "meta" else torch.device("cpu")


class CheckpointManager:
    """Async checkpointing with keep-last-k GC and crash-safe publish."""

    def __init__(self, directory: str, keep: int = 3,
                 async_writes: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_writes = async_writes
        self._pending: list = []
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree, meta: Optional[dict] = None):
        t = save_checkpoint(self.directory, step, tree, meta=meta,
                            blocking=not self.async_writes)
        if t is not None:
            self._pending.append(t)
        self._gc()

    def wait(self):
        for t in self._pending:
            t.join()
        self._pending.clear()

    def restore(self, template, *, step=None, device=None, shardings=None):
        self.wait()
        return load_checkpoint(self.directory, template, step=step,
                               device=device, shardings=shardings)

    def latest_step(self) -> Optional[int]:
        steps = list_steps(self.directory)
        return steps[-1] if steps else None

    def _gc(self):
        self.wait()
        steps = list_steps(self.directory)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)
