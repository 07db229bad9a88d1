"""Bridge from the JAX reference's parameters to the port's trees.

``jax.random`` streams cannot be reproduced with ``torch.Generator``, so
a parity check starts both packages from the reference's initialised
parameters, handed over as numpy arrays (``np.asarray`` of each JAX
leaf) and turned into the port's tree here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import _tree


def params_from_jax(tree_of_numpy, device, like=None):
    """Reference params (a nested dict/list of numpy arrays) -> the port's
    tree of tensors on ``device``, with the same keys, shapes and dtypes.

    With ``like`` (e.g. the port model's own ``init`` output) the result
    must match it key for key, shape for shape and dtype for dtype, and a
    mismatch raises ``ValueError`` naming the first leaf that differs."""
    leaves, treedef = _tree.flatten(tree_of_numpy)
    out = [torch.from_numpy(np.array(l, copy=True)).to(device)
           for l in leaves]
    if like is not None:
        like_leaves, like_def = _tree.flatten(like)
        if like_def != treedef:
            raise ValueError(f"params_from_jax: tree structure differs:\n"
                             f"  reference {treedef}\n  port      {like_def}")
        for i, (a, b) in enumerate(zip(out, like_leaves)):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise ValueError(
                    f"params_from_jax: leaf {i} is {tuple(a.shape)} "
                    f"{a.dtype} in the reference but {tuple(b.shape)} "
                    f"{b.dtype} in the port")
    return _tree.unflatten(treedef, out)
