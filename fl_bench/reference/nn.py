"""Plain PyTorch building blocks of the vision references, in NCHW.

The parameter trees keep the layout the deployment ships on its wires:
convolution weights HWIO, images NHWC on the silos. Everything else is
the textbook operation: "SAME" padding as XLA pads, batch statistics
over N, H and W with the population variance, hard swish as
``x * relu6(x + 3) / 6``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def same_pad(size: int, k: int, stride: int):
    """(low, high) "SAME" padding of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, stride: int = 1, groups: int = 1):
    """x: (N, C_in, H, W); w: (kh, kw, C_in / groups, C_out)."""
    ph = same_pad(x.shape[2], w.shape[0], stride)
    pw = same_pad(x.shape[3], w.shape[1], stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride, groups=groups)


def norm(p, x, eps: float = 1e-5):
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    x = (x - mean) / torch.sqrt(var + eps)
    return x * p["scale"][None, :, None, None] + p["bias"][None, :, None, None]


def hard_swish(x):
    return x * F.relu6(x + 3.0) / 6.0


def cross_entropy(logits, labels):
    """Mean cross-entropy, in float32 whatever the logits' type."""
    return F.cross_entropy(logits.float(), labels.long())


# leaf specs: how each leaf of a fresh tree is drawn
def he(k: int, c_in: int, c_out: int, groups: int = 1):
    """A conv weight, N(0, 2 / fan_in)."""
    fan_in = k * k * c_in // groups
    return ("normal", (k, k, c_in // groups, c_out), math.sqrt(2.0 / fan_in))


def normal(shape, std: float):
    return ("normal", tuple(shape), std)


def zeros(shape):
    return ("zeros", tuple(shape))


def bn(c: int):
    return {"scale": ("ones", (c,)), "bias": ("zeros", (c,))}
