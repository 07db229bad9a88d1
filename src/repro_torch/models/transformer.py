"""Port of ``src/repro/models/transformer.py``: ``TransformerLM``, one
substrate for the dense / moe / audio / vlm families.

Layer stacks are organised into *segments*: a segment is a fixed sequence
of block kinds repeated N times. Block kinds: ``self`` (attn+mlp),
``moe`` (attn+moe-ffn), ``cross`` (gated cross-attn + mlp,
llama-3.2-vision style).

Layers keep the reference's stacked layout: each parameter of a segment
is one leaf with the repeats on its leading axis (``seg0.b0_self.*``), so
the wire, the codecs and FedAvg see the reference's leaves in its order.
The reference's ``jax.lax.scan`` over the stacked leaves is a Python loop
here over the per-repeat slices. ``decode_step`` writes its cache in
place and returns it.

``forward``, ``loss`` and ``decode_step`` take an optional ``tp``, the
``model`` group of a mesh (``sharding/tensor_parallel.py``), and the
parameters as this rank's shards over it (``models/layers.py``);
``tp_whole`` says which leaves run whole there (rule 1: heads are never
cut mid-head, the router is whole).
"""
from __future__ import annotations

import torch

from repro_torch import _tree
from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import layers as L


def unstacked(tree):
    """The per-layer slices of a tree whose leaves stack the layers on
    their leading axis, as views. One ``unbind`` per stacked leaf: its
    backward stacks the layers' gradients once, where indexing would add
    a zero-filled stacked gradient per layer."""
    leaves, treedef = _tree.flatten(tree)
    return [_tree.unflatten(treedef, list(layer))
            for layer in zip(*(l.unbind(0) for l in leaves))]


class TransformerLM:
    """Decoder-only (or encoder-only) transformer with GQA."""

    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.segments = self._plan_segments()

    # ------------------------------------------------------------------
    def _plan_segments(self):
        cfg = self.cfg
        Ln = cfg.num_layers
        if cfg.family == "vlm" and cfg.cross_attn_every:
            k = cfg.cross_attn_every
            assert Ln % k == 0
            kinds = tuple(["cross"] + ["self"] * (k - 1))
            return [(kinds, Ln // k)]
        if cfg.num_experts and cfg.moe_interleave > 1:
            k = cfg.moe_interleave
            assert Ln % k == 0
            kinds = tuple(["self"] * (k - 1) + ["moe"])
            return [(kinds, Ln // k)]
        if cfg.num_experts:
            return [(("moe",), Ln)]
        return [(("self",), Ln)]

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------
    def _block_init(self, init: L.Init, kind: str):
        cfg = self.cfg
        dt = L.dtype_of(cfg.param_dtype)
        p = {"ln1": init.zeros((cfg.d_model,), dt, axes=("norm",)),
             "ln2": init.zeros((cfg.d_model,), dt, axes=("norm",))}
        if kind == "cross":
            p["xattn"] = L.attn_init(init, cfg)
            p["xgate"] = init.zeros((), dt, axes=())
            p["mlp"] = L.mlp_init(init, cfg, cfg.d_ff_dense or cfg.d_ff)
        else:
            p["attn"] = L.attn_init(init, cfg)
            if kind == "moe":
                p["moe"] = L.moe_init(init, cfg)
            else:
                p["mlp"] = L.mlp_init(init, cfg, cfg.d_ff_dense or cfg.d_ff)
        return p

    def init(self, generator: torch.Generator):
        """Random params drawn from ``generator`` (on its own device), then
        moved to the model's device; on the ``meta`` device, shapes and
        dtypes only. The reference's ``init`` also returns the logical
        axes; here ``param_axes`` gives them."""
        return self._init(L.Init(generator, self.device))

    def param_axes(self):
        """The reference's logical axes tree, key for key."""
        return self._init(L.Init.axes())

    def param_shapes(self):
        """The parameter tree as ``meta`` tensors."""
        return self._init(L.Init(None, "meta"))

    def _init(self, init: L.Init):
        params = {"embed": L.embed_init(init, self.cfg)}
        for si, (kinds, repeat) in enumerate(self.segments):
            layers = init.stacked(repeat)
            params[f"seg{si}"] = {f"b{bi}_{kind}": self._block_init(layers,
                                                                    kind)
                                  for bi, kind in enumerate(kinds)}
        return params

    def tp_whole(self, size: int):
        """Rule 1 over a ``model`` group of ``size`` ranks, as a tree like
        the parameters: True for a leaf that runs whole (the step layer
        gathers it over ``model`` where the plan splits it). Heads are
        never cut mid-head: every leaf of an attention block whose
        ``num_heads`` does not divide over the group, and ``wk``/``wv``
        where ``num_kv_heads`` does not (each rank then takes the kv heads
        its q heads read); the MoE router, so that every rank routes
        alike. The rest runs as the plan lays it out."""
        cfg = self.cfg
        heads = cfg.num_heads % size != 0
        kv = cfg.num_kv_heads % size != 0

        def walk(tree, path):
            if isinstance(tree, dict):
                return {k: walk(v, path + (k,)) for k, v in tree.items()}
            block, name = path[-2], path[-1]
            if block in ("attn", "xattn"):
                return heads or (kv and name in ("wk", "wv"))
            return block == "moe" and name == "router"

        return walk(self.param_axes(), ())

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _block_apply(self, kind, p, x, *, positions, image_embeds=None,
                     tp=None):
        """-> (x, aux loss); aux is 0 outside a ``moe`` block."""
        cfg = self.cfg
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if kind == "cross":
            a = L.cross_attn_apply(p["xattn"], h, image_embeds, cfg, tp)
            x = x + torch.tanh(p["xgate"].to(a.dtype)) * a
        else:
            a = L.attn_apply(p["attn"], h, cfg, positions=positions,
                             block_causal=cfg.block_causal, tp=tp)
            x = x + a
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        if kind == "moe":
            y, aux = L.moe_apply(p["moe"], h, cfg,
                                 group_size=cfg.moe_group_size,
                                 capacity_factor=cfg.capacity_factor, tp=tp)
        else:
            y = L.mlp_apply(p["mlp"], h, tp, cfg.d_ff_dense or cfg.d_ff)
        return x + y, aux

    def _stack_apply(self, params, x, *, positions, image_embeds=None,
                     tp=None):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for si, (kinds, _) in enumerate(self.segments):

            def body(layer_p, x, aux, _kinds=kinds):
                for bi, kind in enumerate(_kinds):
                    x, a = self._block_apply(
                        kind, layer_p[f"b{bi}_{kind}"], x,
                        positions=positions, image_embeds=image_embeds,
                        tp=tp)
                    aux = aux + a
                return x, aux

            body = L.remat(body, self.cfg.remat)
            for layer_p in unstacked(params[f"seg{si}"]):
                x, aux = body(layer_p, x, aux)
        return x, aux

    def forward(self, params, batch, tp=None):
        """-> (logits (b, s, vocab), aux loss); with ``tp``, the logits of
        this rank's vocabulary columns where the vocabulary splits."""
        cfg = self.cfg
        dtype = L.dtype_of(cfg.dtype)
        if cfg.external_embeddings:
            x = batch["embeds"].to(dtype)
        else:
            x = L.embed_lookup(params["embed"], batch["tokens"], cfg, dtype,
                               tp)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        img = batch.get("image_embeds")
        if img is not None:
            img = img.to(x.dtype)
        x, aux = self._stack_apply(params, x, positions=positions,
                                   image_embeds=img, tp=tp)
        return L.lm_logits(params["embed"], x, cfg, tp), aux

    def loss(self, params, batch, tp=None):
        logits, aux = self.forward(params, batch, tp)
        ce = L.cross_entropy(logits, batch["targets"], tp=tp,
                             vocab_size=self.cfg.vocab_size)
        loss = ce + 0.01 * aux
        return loss, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------------
    # decode path
    # ------------------------------------------------------------------
    def cache_spec(self, batch_size: int, max_seq: int):
        """The decode cache's shapes and dtypes, as ``meta`` tensors (the
        reference's ShapeDtypeStructs; it also returns axes)."""
        cfg = self.cfg
        dt = L.dtype_of(cfg.dtype)

        def spec(*shape):
            return torch.empty(shape, dtype=dt, device="meta")

        cache = {}
        for si, (kinds, repeat) in enumerate(self.segments):
            seg = {}
            for bi, kind in enumerate(kinds):
                if kind == "cross":
                    xshape = (repeat, batch_size, cfg.num_image_tokens,
                              cfg.num_kv_heads, cfg.head_dim)
                    seg[f"b{bi}_{kind}"] = {"xk": spec(*xshape),
                                            "xv": spec(*xshape)}
                else:
                    shape = (repeat, batch_size, max_seq, cfg.num_kv_heads,
                             cfg.head_dim)
                    seg[f"b{bi}_{kind}"] = {"k": spec(*shape),
                                            "v": spec(*shape)}
            cache[f"seg{si}"] = seg
        return cache

    def cache_axes(self):
        """The logical axes of ``cache_spec``'s leaves (the second half of
        the reference's ``cache_spec``)."""
        kv = ("layers", "batch", "seq_kv", None, None)
        xkv = ("layers", "batch", None, None, None)
        return {f"seg{si}": {
            f"b{bi}_{kind}": ({"xk": xkv, "xv": xkv} if kind == "cross"
                              else {"k": kv, "v": kv})
            for bi, kind in enumerate(kinds)}
            for si, (kinds, _) in enumerate(self.segments)}

    def init_cache(self, batch_size: int, max_seq: int):
        return _tree.map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                               device=self.device),
                         self.cache_spec(batch_size, max_seq))

    def decode_step(self, params, cache, batch, tp=None):
        """One token: batch = {tokens: (b,1), pos: int, image_embeds?}.
        Returns (logits, cache): the cache is updated in place (the
        reference returns a new one), so the step consumes it. With
        ``tp``, the cache holds this rank's positions where
        ``tp.cache_split`` says so."""
        cfg = self.cfg
        pos = int(batch["pos"])
        dtype = L.dtype_of(cfg.dtype)
        if cfg.external_embeddings:
            x = batch["embeds"].to(dtype)
        else:
            x = L.embed_lookup(params["embed"], batch["tokens"], cfg, dtype,
                               tp)
        for si, (kinds, _) in enumerate(self.segments):
            for layer_p, layer_c in zip(unstacked(params[f"seg{si}"]),
                                        unstacked(cache[f"seg{si}"])):
                for bi, kind in enumerate(kinds):
                    key = f"b{bi}_{kind}"
                    p = layer_p[key]
                    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
                    if kind == "cross":
                        # static image kv: attend, no cache update
                        o = _cross_decode(p["xattn"], h, layer_c[key], cfg,
                                          tp)
                        x = x + torch.tanh(p["xgate"].to(o.dtype)) * o
                    else:
                        o, _ = L.attn_decode(p["attn"], h, layer_c[key], cfg,
                                             pos=pos, tp=tp)
                        x = x + o
                    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
                    if kind == "moe":
                        y, _ = L.moe_apply(p["moe"], h, cfg,
                                           group_size=cfg.moe_group_size,
                                           capacity_factor=cfg.capacity_factor,
                                           tp=tp)
                    else:
                        y = L.mlp_apply(p["mlp"], h, tp,
                                        cfg.d_ff_dense or cfg.d_ff)
                    x = x + y
        return L.lm_logits(params["embed"], x, cfg, tp), cache

    def input_specs(self, shape: ShapeConfig):
        return input_specs(self.cfg, shape)


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """``meta`` tensors standing in for every model input (the reference's
    ShapeDtypeStructs) and their logical axes, for any family: the
    recurrent families read tokens only, as their own ``input_specs`` in
    the reference do."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    dt = L.dtype_of(cfg.dtype)

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    specs, axes = {}, {}
    if shape.kind in ("train", "prefill"):
        if cfg.external_embeddings:
            specs["embeds"] = spec((b, s, cfg.d_model), dt)
            axes["embeds"] = ("batch", "seq", None)
        else:
            specs["tokens"] = spec((b, s), i32)
            axes["tokens"] = ("batch", "seq")
        if cfg.family == "vlm":
            specs["image_embeds"] = spec((b, cfg.num_image_tokens,
                                          cfg.d_model), dt)
            axes["image_embeds"] = ("batch", None, None)
        if shape.kind == "train":
            specs["targets"] = spec((b, s), i32)
            axes["targets"] = ("batch", "seq")
    else:  # decode
        specs["tokens"] = spec((b, 1), i32)
        axes["tokens"] = ("batch", None)
        specs["pos"] = spec((), i32)
        axes["pos"] = None
    return specs, axes


def _cross_decode(p, x, xcache, cfg: ModelConfig, tp=None):
    """Cross-attention for a single token against static image kv. With
    ``tp`` and the block split, this rank's q heads attend to the kv heads
    they read (the image cache is whole on every rank), then the
    row-parallel ``wo``."""
    b, _, _ = x.shape
    hd = cfg.head_dim
    tp = L._attn_tp(p, cfg, tp)
    q = (x @ p["wq"].to(x.dtype)).reshape(b, 1, -1, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
    k, v = xcache["xk"], xcache["xv"]
    if tp is not None:
        heads = L._kv_heads(cfg, tp, tp.splits(p["wk"].shape[-1],
                                               cfg.num_kv_heads * hd))
        k, v = k[:, :, heads], v[:, :, heads]
    o = L.decode_attention(q, k, v, k.shape[1])
    return L._out_proj(p, o, x, tp)
