"""Device resolution for the port's entry points.

Entry points run on the card unless the caller names another device:
``None`` means ``"cuda"``, and asking for CUDA on a machine without a
card raises instead of quietly running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def synchronize(tree_leaf) -> None:
    """Wait for the device that holds ``tree_leaf`` (no-op off CUDA), so a
    host clock read after it measures finished work."""
    if isinstance(tree_leaf, torch.Tensor) and tree_leaf.is_cuda:
        torch.cuda.synchronize(tree_leaf.device)
