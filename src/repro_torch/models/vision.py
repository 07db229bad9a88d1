"""Port of ``src/repro/models/vision.py``, limited to the Small tier's
ResNet56; MobileNetV3 and ViT arrive with later slices.

Parameters are a plain nested dict/list of tensors that mirrors the JAX
tree key for key and shape for shape, so wire bytes and the flat FedAvg
vector match the reference. Layouts follow the reference at the public
functions: conv weights are HWIO in the tree and activations are NHWC;
``conv`` permutes to PyTorch's NCHW/OIHW internally (for an NHWC
contiguous tensor that permute is PyTorch's channels-last format, so no
copy is made).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch import _tree
from repro_torch._device import resolve_device
from repro_torch.models import layers as L


def conv_init(generator, k, c_in, c_out, dtype=torch.float32, groups=1):
    fan_in = k * k * c_in // groups
    std = math.sqrt(2.0 / fan_in)
    w = torch.randn((k, k, c_in // groups, c_out), generator=generator,
                    dtype=torch.float32) * std
    return w.to(dtype)


def _same_pad(size: int, k: int, stride: int):
    """JAX/XLA "SAME" padding for one spatial dim: (low, high). At stride
    2 with k=3 on an even size this is (0, 1), not torch's (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, stride=1, groups=1):
    """x: (N, H, W, C_in) NHWC; w: (kh, kw, C_in/groups, C_out) HWIO ->
    NHWC, with "SAME" padding as ``jax.lax.conv_general_dilated``."""
    kh, kw = w.shape[0], w.shape[1]
    ph = _same_pad(x.shape[1], kh, stride)
    pw = _same_pad(x.shape[2], kw, stride)
    xc = x.permute(0, 3, 1, 2)
    if any(ph) or any(pw):
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def bn_init(c, dtype=torch.float32):
    # inference-style affine norm (FL payloads include scale/bias)
    return {"scale": torch.ones((c,), dtype=dtype),
            "bias": torch.zeros((c,), dtype=dtype)}


def norm_apply(p, x, eps=1e-5):
    """Batch statistics over N, H, W with the population variance
    (``jnp.var``, ddof 0)."""
    mean = torch.mean(x, dim=(0, 1, 2), keepdim=True)
    var = torch.var(x, dim=(0, 1, 2), keepdim=True, unbiased=False)
    x = (x - mean) * torch.rsqrt(var + eps)
    return x * p["scale"] + p["bias"]


# ---------------------------------------------------------------------------
# ResNet-56 (CIFAR-style: 3 stages x 9 basic blocks, widths 16/32/64)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet56"
    widths: Sequence[int] = (16, 32, 64)
    blocks_per_stage: int = 9
    num_classes: int = 203  # GLD-23k-ish label space (paper uses GLD-23K)
    image_size: int = 32


class ResNet:
    def __init__(self, cfg: ResNetConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator):
        """Random params drawn on the host from ``generator`` (a CPU
        ``torch.Generator``), then moved to the model's device."""
        cfg = self.cfg
        g = generator
        p = {"stem": {"w": conv_init(g, 3, 3, cfg.widths[0]),
                      "bn": bn_init(cfg.widths[0])}}
        c_in = cfg.widths[0]
        for si, width in enumerate(cfg.widths):
            stage = []
            for bi in range(cfg.blocks_per_stage):
                stride = 2 if (si > 0 and bi == 0) else 1
                blk = {"c1": conv_init(g, 3, c_in, width),
                       "bn1": bn_init(width),
                       "c2": conv_init(g, 3, width, width),
                       "bn2": bn_init(width)}
                if stride != 1 or c_in != width:
                    blk["proj"] = conv_init(g, 1, c_in, width)
                stage.append(blk)
                c_in = width
            p[f"stage{si}"] = stage
        p["head"] = {
            "w": torch.randn((c_in, cfg.num_classes), generator=g) * 0.01,
            "b": torch.zeros((cfg.num_classes,), dtype=torch.float32)}
        return _tree.map(lambda a: a.to(self.device), p)

    def forward(self, p, images):
        cfg = self.cfg
        x = norm_apply(p["stem"]["bn"], conv(images, p["stem"]["w"]))
        x = torch.relu(x)
        for si in range(len(cfg.widths)):
            for bi, blk in enumerate(p[f"stage{si}"]):
                stride = 2 if (si > 0 and bi == 0) else 1
                h = torch.relu(norm_apply(blk["bn1"],
                                          conv(x, blk["c1"], stride)))
                h = norm_apply(blk["bn2"], conv(h, blk["c2"]))
                sc = conv(x, blk["proj"], stride) if "proj" in blk else x
                x = torch.relu(h + sc)
        x = torch.mean(x, dim=(1, 2))
        return x @ p["head"]["w"] + p["head"]["b"]

    def loss(self, p, batch):
        logits = self.forward(p, batch["images"])
        return L.cross_entropy(logits[:, None, :], batch["labels"][:, None],
                               z_loss=0.0), {}

