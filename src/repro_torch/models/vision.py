"""Port of ``src/repro/models/vision.py``: the Small tier's ResNet56, the
Medium tier's MobileNetV3 and the Large tier's ViT-Large.

Parameters are a plain nested dict/list of tensors that mirrors the JAX
tree key for key and shape for shape, so wire bytes and the flat FedAvg
vector match the reference. Layouts follow the reference at the public
functions: conv weights are HWIO in the tree and activations are NHWC;
``conv`` permutes to PyTorch's NCHW/OIHW internally (for an NHWC
contiguous tensor that permute is PyTorch's channels-last format, so no
copy is made, but for the depthwise convs, which take an NCHW-contiguous
copy).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch import _tree
from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import TransformerLM


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
    if groups > 1:
        # depthwise: NCHW-contiguous in and out, which sets the order the
        # next norm's statistics sum in (PERF.md: MobileNetV3's f32
        # gradients on the CPU)
        xc = xc.contiguous()
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


def hard_swish(x):
    """``jax.nn.hard_swish``: x * hard_sigmoid(x), hard_sigmoid(x) =
    relu6(x + 3) / 6, rounded in that order."""
    return x * (F.relu6(x + 3.0) / 6.0)


# ---------------------------------------------------------------------------
# MobileNetV3-style (inverted residuals + SE), Medium tier
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MobileNetConfig:
    name: str = "mobilenetv3"
    # (expand, out_channels, stride, use_se) per block
    blocks: tuple = ((1, 16, 1, False), (4, 24, 2, False), (3, 24, 1, False),
                     (3, 40, 2, True), (3, 40, 1, True), (3, 40, 1, True),
                     (6, 80, 2, False), (2.5, 80, 1, False), (2.3, 80, 1, False),
                     (6, 112, 1, True), (6, 112, 1, True),
                     (6, 160, 2, True), (6, 160, 1, True), (6, 160, 1, True))
    stem: int = 16
    head: int = 960
    classifier: int = 1280
    num_classes: int = 203
    image_size: int = 64


class MobileNetV3:
    def __init__(self, cfg: MobileNetConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator):
        """Random params drawn on the host from ``generator`` (a CPU
        ``torch.Generator``), then moved to the model's device. The tree is
        the reference's key for key: ``se_down``/``se_up`` only in SE
        blocks, depthwise weights HWIO (3, 3, 1, c_mid)."""
        cfg = self.cfg
        g = generator
        p = {"stem": {"w": conv_init(g, 3, 3, cfg.stem),
                      "bn": bn_init(cfg.stem)}}
        c_in = cfg.stem
        blocks = []
        for (exp, out, stride, se) in cfg.blocks:
            c_mid = int(c_in * exp + 0.5)
            blk = {"expand": conv_init(g, 1, c_in, c_mid),
                   "bn_e": bn_init(c_mid),
                   "dw": conv_init(g, 3, c_mid, c_mid, groups=c_mid),
                   "bn_d": bn_init(c_mid),
                   "project": conv_init(g, 1, c_mid, out),
                   "bn_p": bn_init(out)}
            if se:
                c_se = max(c_mid // 4, 8)
                blk["se_down"] = conv_init(g, 1, c_mid, c_se)
                blk["se_up"] = conv_init(g, 1, c_se, c_mid)
            blocks.append(blk)
            c_in = out
        p["blocks"] = blocks
        p["head"] = {
            "w": conv_init(g, 1, c_in, cfg.head),
            "bn": bn_init(cfg.head),
            "fc1": torch.randn((cfg.head, cfg.classifier), generator=g) * 0.01,
            "fc2": torch.randn((cfg.classifier, cfg.num_classes),
                               generator=g) * 0.01,
            "b": torch.zeros((cfg.num_classes,), dtype=torch.float32)}
        return _tree.map(lambda a: a.to(self.device), p)

    def forward(self, p, images):
        x = hard_swish(norm_apply(p["stem"]["bn"],
                                  conv(images, p["stem"]["w"], 2)))
        for (_, _, stride, _), blk in zip(self.cfg.blocks, p["blocks"]):
            h = hard_swish(norm_apply(blk["bn_e"], conv(x, blk["expand"])))
            c_mid = h.shape[-1]
            # depthwise: HWIO (3, 3, 1, c_mid) -> OIHW (c_mid, 1, 3, 3)
            h = hard_swish(norm_apply(
                blk["bn_d"], conv(h, blk["dw"], stride, groups=c_mid)))
            if "se_down" in blk:
                s = torch.mean(h, dim=(1, 2), keepdim=True)
                s = torch.relu(conv(s, blk["se_down"]))
                s = torch.sigmoid(conv(s, blk["se_up"]))
                h = h * s
            h = norm_apply(blk["bn_p"], conv(h, blk["project"]))
            if stride == 1 and h.shape[-1] == x.shape[-1]:
                h = h + x
            x = h
        x = hard_swish(norm_apply(p["head"]["bn"], conv(x, p["head"]["w"])))
        x = torch.mean(x, dim=(1, 2))
        x = hard_swish(x @ p["head"]["fc1"])
        return x @ p["head"]["fc2"] + p["head"]["b"]

    def loss(self, p, batch):
        logits = self.forward(p, batch["images"])
        return L.cross_entropy(logits[:, None, :], batch["labels"][:, None],
                               z_loss=0.0), {}


# ---------------------------------------------------------------------------
# ViT-Large (Large tier: 303,236,096 params; the paper's 307M)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ViTConfig:
    name: str = "vit-large"
    num_layers: int = 24
    d_model: int = 1024
    num_heads: int = 16
    d_ff: int = 4096
    patch: int = 16
    image_size: int = 224
    num_classes: int = 203


class ViT:
    """Encoder-only transformer over patch embeddings (classification).

    The reference's quirks are kept: RoPE on top of the learned ``pos``
    (``ModelConfig.rope_theta`` defaults to 10,000), logits averaged over
    positions, and ``pos`` sized for ``image_size`` whatever the images
    are. On the silos' 16x16 images with ``patch`` 16 there is one patch,
    and ``+ pos`` broadcasts it to all 196 positions: the Large tier's
    live round runs at sequence length 196."""

    def __init__(self, cfg: ViTConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lm_cfg = ModelConfig(
            name=cfg.name, family="audio", num_layers=cfg.num_layers,
            d_model=cfg.d_model, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_heads, d_ff=cfg.d_ff,
            vocab_size=cfg.num_classes, causal=False,
            external_embeddings=True, dtype="float32",
            param_dtype="float32", remat="none", attn_chunk=256,
            mlp_gelu=True)
        self.tf = TransformerLM(self.lm_cfg, device=self.device)

    def init(self, generator: torch.Generator):
        """Random params drawn on the host from ``generator`` (a CPU
        ``torch.Generator``), then moved to the model's device; on the
        ``meta`` device, shapes and dtypes only."""
        cfg = self.cfg
        init = L.Init(generator, self.device)
        n_patches = (cfg.image_size // cfg.patch) ** 2
        return {"tf": self.tf.init(generator),
                "patch_w": init.normal((cfg.patch * cfg.patch * 3,
                                        cfg.d_model), 0.02),
                "patch_b": init.zeros((cfg.d_model,)),
                "pos": init.normal((n_patches, cfg.d_model), 0.02)}

    def _patchify(self, images):
        cfg = self.cfg
        b, h, w, c = images.shape
        ph = h // cfg.patch
        x = images.reshape(b, ph, cfg.patch, ph, cfg.patch, c)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(b, ph * ph, -1)

    def forward(self, p, images):
        x = self._patchify(images) @ p["patch_w"] + p["patch_b"] + p["pos"]
        logits, _ = self.tf.forward(p["tf"], {"embeds": x})
        return torch.mean(logits, dim=1)  # mean-pool classification

    def loss(self, p, batch):
        logits = self.forward(p, batch["images"])
        return L.cross_entropy(logits[:, None, :], batch["labels"][:, None],
                               z_loss=0.0), {}
