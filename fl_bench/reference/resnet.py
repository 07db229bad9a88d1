"""Plain ResNet for CIFAR-sized inputs (He et al., arXiv:1512.03385 §4.2):
6n + 2 layers, three stages of n basic blocks at ``widths``, a 1x1
projection where a block changes shape, global mean pool, linear head."""
from __future__ import annotations

import torch

from fl_bench.reference.nn import bn, conv, he, norm, normal, zeros


def param_specs(cfg: dict):
    widths, n = cfg["widths"], cfg["blocks_per_stage"]
    p = {"stem": {"w": he(3, 3, widths[0]), "bn": bn(widths[0])}}
    c_in = widths[0]
    for si, width in enumerate(widths):
        stage = []
        for bi in range(n):
            stride = 2 if si > 0 and bi == 0 else 1
            blk = {"c1": he(3, c_in, width), "bn1": bn(width),
                   "c2": he(3, width, width), "bn2": bn(width)}
            if stride != 1 or c_in != width:
                blk["proj"] = he(1, c_in, width)
            stage.append(blk)
            c_in = width
        p[f"stage{si}"] = stage
    p["head"] = {"w": normal((c_in, cfg["num_classes"]), 0.01),
                 "b": zeros((cfg["num_classes"],))}
    return p


def forward(p, images, cfg: dict):
    """images: (N, H, W, 3) -> logits (N, classes)."""
    x = images.permute(0, 3, 1, 2)
    x = torch.relu(norm(p["stem"]["bn"], conv(x, p["stem"]["w"])))
    for si in range(len(cfg["widths"])):
        for bi, blk in enumerate(p[f"stage{si}"]):
            stride = 2 if si > 0 and bi == 0 else 1
            h = torch.relu(norm(blk["bn1"], conv(x, blk["c1"], stride)))
            h = norm(blk["bn2"], conv(h, blk["c2"]))
            sc = conv(x, blk["proj"], stride) if "proj" in blk else x
            x = torch.relu(h + sc)
    x = x.mean(dim=(2, 3))
    return x @ p["head"]["w"] + p["head"]["b"]
