"""Port of ``src/repro/models/bert.py``: DistilBERT, the paper's Big tier
(66,362,880 base params / 253.19 MB).

The reference's structure: learned positional embeddings, post-LN blocks
with biases (eps 1e-12), a 2-matrix MLP with ``jax.nn.gelu``'s tanh
approximation, and ``flash_attention`` in chunks of 256. The
classification head (20 Newsgroups) is a separate tree, so the
communicated payload is the tier's. Layers are a list of per-layer
dicts, as in the reference (not stacked).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class BertConfig:
    name: str = "distilbert"
    num_layers: int = 6
    d_model: int = 768
    num_heads: int = 12
    d_ff: int = 3072
    vocab_size: int = 30522
    max_pos: int = 512
    num_classes: int = 20  # 20 Newsgroups


def _linear(init: L.Init, d_in: int, d_out: int):
    return {"w": init.normal((d_in, d_out), d_in ** -0.5),
            "b": init.zeros((d_out,))}


def _apply_linear(p, x):
    return x @ p["w"] + p["b"]


def _ln_init(init: L.Init, d: int):
    return {"scale": init.ones((d,)), "bias": init.zeros((d,))}


def _ln(p, x, eps=1e-12):
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


class DistilBert:
    def __init__(self, cfg: BertConfig = BertConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator):
        """Random params drawn on the host from ``generator`` (a CPU
        ``torch.Generator``), then moved to the model's device; on the
        ``meta`` device, shapes and dtypes only."""
        cfg = self.cfg
        init = L.Init(generator, self.device)
        d = cfg.d_model
        return {
            "word_emb": init.normal((cfg.vocab_size, d), 0.02),
            "pos_emb": init.normal((cfg.max_pos, d), 0.02),
            "emb_ln": _ln_init(init, d),
            "layers": [{"q": _linear(init, d, d), "k": _linear(init, d, d),
                        "v": _linear(init, d, d), "o": _linear(init, d, d),
                        "ln1": _ln_init(init, d),
                        "ff1": _linear(init, d, cfg.d_ff),
                        "ff2": _linear(init, cfg.d_ff, d),
                        "ln2": _ln_init(init, d)}
                       for _ in range(cfg.num_layers)],
        }

    def init_head(self, generator: torch.Generator):
        return _linear(L.Init(generator, self.device), self.cfg.d_model,
                       self.cfg.num_classes)

    def forward(self, p, tokens):
        cfg = self.cfg
        b, s = tokens.shape
        x = p["word_emb"][tokens.long()] + p["pos_emb"][:s][None]
        x = _ln(p["emb_ln"], x)
        hd = cfg.d_model // cfg.num_heads
        for blk in p["layers"]:
            q = _apply_linear(blk["q"], x).reshape(b, s, cfg.num_heads, hd)
            k = _apply_linear(blk["k"], x).reshape(b, s, cfg.num_heads, hd)
            v = _apply_linear(blk["v"], x).reshape(b, s, cfg.num_heads, hd)
            o = L.flash_attention(q, k, v, causal=False, q_chunk=256,
                                  kv_chunk=256)
            o = _apply_linear(blk["o"], o.reshape(b, s, cfg.d_model))
            x = _ln(blk["ln1"], x + o)
            h = F.gelu(_apply_linear(blk["ff1"], x), approximate="tanh")
            x = _ln(blk["ln2"], x + _apply_linear(blk["ff2"], h))
        return x

    def loss(self, p, head, batch):
        x = self.forward(p, batch["tokens"])
        logits = _apply_linear(head, x[:, 0])
        return L.cross_entropy(logits[:, None, :], batch["labels"][:, None],
                               z_loss=0.0), {}
