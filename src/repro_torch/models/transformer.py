"""Port of ``src/repro/models/transformer.py``: the dense ``TransformerLM``
(decoder-only or encoder-only, GQA), one segment of ``self`` blocks.

Layers keep the reference's stacked layout: each parameter of a segment
is one leaf with the layers on its leading axis (``seg0.b0_self.*``), so
the wire, the codecs and FedAvg see the reference's leaves in its order.
The reference's ``jax.lax.scan`` over the stacked leaves is a Python loop
here over the per-layer slices. MoE and cross-attention segments, the
``dots``/``full`` rematerialisation policies and the decode path wait
for ROADMAP item 15; there is no sharding.
"""
from __future__ import annotations

import torch

from repro_torch import _tree
from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

_LATER = "ROADMAP item 15 (the rest of the LM stack)"


class TransformerLM:
    """Decoder-only (or encoder-only) transformer with GQA."""

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.num_experts or cfg.cross_attn_every:
            raise NotImplementedError(
                f"{cfg.name}: MoE and cross-attention layers are not ported "
                f"to repro_torch yet ({_LATER})")
        if cfg.remat != "none":
            raise NotImplementedError(
                f"{cfg.name}: remat='{cfg.remat}' is not ported to "
                f"repro_torch yet ({_LATER}); only 'none' is")
        self.cfg = cfg
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator):
        """Random params drawn on the host from ``generator`` (a CPU
        ``torch.Generator``), then moved to the model's device; on the
        ``meta`` device, shapes and dtypes only. The reference's ``init``
        also returns the logical axes; the port has none."""
        cfg = self.cfg
        init = L.Init(generator, self.device)
        embed = L.embed_init(init, cfg)
        layers = init.stacked(cfg.num_layers)
        dt = L.dtype_of(cfg.param_dtype)
        block = {"ln1": layers.zeros((cfg.d_model,), dt),
                 "ln2": layers.zeros((cfg.d_model,), dt),
                 "attn": L.attn_init(layers, cfg),
                 "mlp": L.mlp_init(layers, cfg, cfg.d_ff_dense or cfg.d_ff)}
        return {"embed": embed, "seg0": {"b0_self": block}}

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _block_apply(self, p, x, *, positions):
        cfg = self.cfg
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + L.attn_apply(p["attn"], h, cfg, positions=positions)
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + L.mlp_apply(p["mlp"], h)

    def forward(self, params, batch):
        """-> (logits (b, s, vocab), aux loss); aux is 0 without MoE."""
        cfg = self.cfg
        dtype = L.dtype_of(cfg.dtype)
        if cfg.external_embeddings:
            x = batch["embeds"].to(dtype)
        else:
            x = L.embed_lookup(params["embed"], batch["tokens"], cfg, dtype)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        leaves, treedef = _tree.flatten(params["seg0"]["b0_self"])
        # one unbind per stacked leaf: its backward stacks the layers'
        # gradients once, where indexing would add a zero-filled stacked
        # gradient per layer
        for layer in zip(*(l.unbind(0) for l in leaves)):
            x = self._block_apply(_tree.unflatten(treedef, list(layer)), x,
                                  positions=positions)
        logits = L.lm_logits(params["embed"], x, cfg)
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)

    def loss(self, params, batch):
        logits, aux = self.forward(params, batch)
        ce = L.cross_entropy(logits, batch["targets"])
        loss = ce + 0.01 * aux
        return loss, {"ce": ce, "aux": aux}
