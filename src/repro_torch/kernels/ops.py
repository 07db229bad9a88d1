"""Port of ``src/repro/kernels/ops.py``: tree-level wrappers over the
kernels, with flattening handled here.

This slice ports the sync FedAvg path, ``flatten_pytree`` and
``fedavg_aggregate``; the quantize / top-k / accumulate wrappers arrive
with their kernels.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.kernels import fedavg_reduce as fr


def flatten_pytree(tree):
    """-> (flat f32 vector, unflatten_fn), leaves in ``jax.tree.flatten``
    order. Leaves may be tensors or host arrays; the vector lies on the
    first leaf's device. Dtype-preserving on unflatten."""
    leaves, treedef = _tree.flatten(tree)
    leaves = [torch.as_tensor(l) for l in leaves]
    sizes = [l.numel() for l in leaves]
    shapes = [l.shape for l in leaves]
    dtypes = [l.dtype for l in leaves]
    flat = torch.cat([l.float().reshape(-1) for l in leaves]) \
        if leaves else torch.zeros((0,), dtype=torch.float32)

    def unflatten(vec):
        out, off = [], 0
        for size, shape, dt in zip(sizes, shapes, dtypes):
            out.append(vec[off:off + size].reshape(shape).to(dt))
            off += size
        return _tree.unflatten(treedef, out)

    return flat, unflatten


def fedavg_aggregate(updates: Sequence, weights):
    """Weighted average of N trees through the ``fedavg_reduce`` kernel.
    Weights are normalised in f32 on the host, as the reference does.
    Returns a tree like updates[0]."""
    w = np.asarray(weights, np.float32)
    w = w / np.sum(w, dtype=np.float32)
    flats, unflatten = zip(*[flatten_pytree(u) for u in updates])
    stacked = torch.stack(flats)  # (N, T); the kernel masks T's tail
    agg = fr.fedavg_reduce(stacked, torch.from_numpy(w).to(stacked.device))
    return unflatten[0](agg)
