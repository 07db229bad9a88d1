"""Plain MobileNetV3-style network (Howard et al., arXiv:1905.02244):
inverted residual blocks (1x1 expand, 3x3 depthwise, optional
squeeze-and-excite, 1x1 project), hard swish, a 1x1 head conv, global
mean pool and a two-layer classifier. ``blocks`` lists (expansion,
out channels, stride, SE) per block."""
from __future__ import annotations

import torch

from fl_bench.reference.nn import bn, conv, hard_swish, he, norm, normal, zeros


def param_specs(cfg: dict):
    p = {"stem": {"w": he(3, 3, cfg["stem"]), "bn": bn(cfg["stem"])}}
    c_in = cfg["stem"]
    blocks = []
    for exp, out, _stride, se in cfg["blocks"]:
        c_mid = int(c_in * exp + 0.5)
        blk = {"expand": he(1, c_in, c_mid), "bn_e": bn(c_mid),
               "dw": he(3, c_mid, c_mid, groups=c_mid), "bn_d": bn(c_mid),
               "project": he(1, c_mid, out), "bn_p": bn(out)}
        if se:
            c_se = max(c_mid // 4, 8)
            blk["se_down"] = he(1, c_mid, c_se)
            blk["se_up"] = he(1, c_se, c_mid)
        blocks.append(blk)
        c_in = out
    p["blocks"] = blocks
    p["head"] = {"w": he(1, c_in, cfg["head"]), "bn": bn(cfg["head"]),
                 "fc1": normal((cfg["head"], cfg["classifier"]), 0.01),
                 "fc2": normal((cfg["classifier"], cfg["num_classes"]), 0.01),
                 "b": zeros((cfg["num_classes"],))}
    return p


def forward(p, images, cfg: dict):
    """images: (N, H, W, 3) -> logits (N, classes)."""
    x = images.permute(0, 3, 1, 2)
    x = hard_swish(norm(p["stem"]["bn"], conv(x, p["stem"]["w"], 2)))
    for (_, _, stride, _), blk in zip(cfg["blocks"], p["blocks"]):
        h = hard_swish(norm(blk["bn_e"], conv(x, blk["expand"])))
        c_mid = h.shape[1]
        h = hard_swish(norm(blk["bn_d"],
                            conv(h, blk["dw"], stride, groups=c_mid)))
        if "se_down" in blk:
            s = h.mean(dim=(2, 3), keepdim=True)
            s = torch.relu(conv(s, blk["se_down"]))
            h = h * torch.sigmoid(conv(s, blk["se_up"]))
        h = norm(blk["bn_p"], conv(h, blk["project"]))
        if stride == 1 and h.shape[1] == x.shape[1]:
            h = h + x
        x = h
    x = hard_swish(norm(p["head"]["bn"], conv(x, p["head"]["w"])))
    x = x.mean(dim=(2, 3))
    x = hard_swish(x @ p["head"]["fc1"])
    return x @ p["head"]["fc2"] + p["head"]["b"]
