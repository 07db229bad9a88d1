"""Plain ViT classifier, as the port's ``ViT`` computes it: ViT-L/16
(Dosovitskiy et al., arXiv:2010.11929, Table 1) at its widths, with the
port's departures from the paper:

- no CLS token: the head is applied at every position and the logits are
  averaged over the positions;
- RMSNorm with the learned scale stored as an offset from 1 (zero at
  init) in place of LayerNorm;
- no biases in attention or the MLP;
- rotary position embeddings (theta 10,000, the two halves of each head
  rotated) on queries and keys, on top of the learned ``pos``;
- the patch embedding a matmul on flattened patches (row, column,
  channel), not a convolution.

Attention is plain softmax attention over every position; the MLP's
GELU is the tanh approximation. The tree keeps the port's keys, the
layers stacked on a leading axis."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from fl_bench.reference.nn import normal, zeros

NORM_EPS = 1e-5
ROPE_THETA = 10_000.0


def param_specs(cfg: dict):
    d, f, n = cfg["d_model"], cfg["d_ff"], cfg["num_layers"]
    p = cfg["patch"]
    positions = (cfg["image_size"] // p) ** 2

    def dense(*shape):  # 1 / sqrt(fan-in), as the port draws it
        return normal(shape, 1.0 / math.sqrt(shape[-2]))
    block = {"ln1": zeros((n, d)), "ln2": zeros((n, d)),
             "attn": {w: dense(n, d, d) for w in ("wq", "wk", "wv", "wo")},
             "mlp": {"w_up": dense(n, d, f), "w_down": dense(n, f, d)}}
    return {"patch_w": normal((p * p * 3, d), 0.02),
            "patch_b": zeros((d,)),
            "pos": normal((positions, d), 0.02),
            "tf": {"embed": {"final_norm": zeros((d,)),
                             "lm_head": dense(d, cfg["num_classes"])},
                   "seg0": {"b0_self": block}}}


def rms_norm(x, scale):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + NORM_EPS) * (1.0 + scale)


def rope(x):
    """x: (b, s, heads, hd); the two halves of hd rotated by position."""
    s, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / ROPE_THETA ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                              device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos = torch.cos(ang)[:, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(h, wq, wk, wv, wo, heads: int):
    b, s, d = h.shape
    hd = d // heads
    q, k, v = ((h @ w).reshape(b, s, heads, hd) for w in (wq, wk, wv))
    q, k = rope(q), rope(k)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
    return o.reshape(b, s, d) @ wo


def forward(p, images, cfg: dict):
    """images: (N, H, W, 3) -> logits (N, classes)."""
    b, h, w, c = images.shape
    n = cfg["patch"]
    x = images.reshape(b, h // n, n, w // n, n, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, (h // n) * (w // n), n * n * c)
    x = x @ p["patch_w"] + p["patch_b"] + p["pos"]
    blk = p["tf"]["seg0"]["b0_self"]
    att, mlp = blk["attn"], blk["mlp"]
    for i in range(cfg["num_layers"]):
        x = x + attention(rms_norm(x, blk["ln1"][i]), att["wq"][i],
                          att["wk"][i], att["wv"][i], att["wo"][i],
                          cfg["num_heads"])
        u = rms_norm(x, blk["ln2"][i]) @ mlp["w_up"][i]
        x = x + F.gelu(u, approximate="tanh") @ mlp["w_down"][i]
    x = rms_norm(x, p["tf"]["embed"]["final_norm"])
    return (x @ p["tf"]["embed"]["lm_head"]).mean(dim=1)
