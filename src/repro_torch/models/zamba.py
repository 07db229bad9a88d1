"""Port of ``src/repro/models/zamba.py``: the Zamba2-style hybrid, a Mamba2
(SSD) backbone + a shared attention block applied every ``attn_every``
mamba blocks with per-application LoRA (arXiv:2411.15242).

Training uses the chunked SSD scan; decode keeps O(1) SSM state per block
plus a KV cache only for the shared-attention applications. ``ssd_chunked``
is plain jnp in the reference, so here it is plain torch (a loop over
chunks for its scan). ``decode_step`` writes its cache in place.

``forward``, ``loss`` and ``decode_step`` take an optional ``tp``, the
``model`` group of a mesh (``sharding/tensor_parallel.py``), and the
parameters as this rank's shards over it: the Mamba blocks split by SSM
heads (``mamba_block_apply``), the shared block, the embedding, head and
loss as the transformer's. ``tp_whole`` says which leaves run whole.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import _tree
from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import input_specs, unstacked
from repro_torch.models.xlstm import causal_conv
from repro_torch.sharding.tensor_parallel import (columns, copy_to,
                                                  gather_from, reduce_from,
                                                  share, split_over, splits,
                                                  take, whole_columns)

# ---------------------------------------------------------------------------
# Mamba2 SSD core
# ---------------------------------------------------------------------------


def ssd_chunked(x, dt, A, B, C, D, chunk: int):
    """Chunked SSD scan (Mamba2).

    x: (b,T,H,dh); dt: (b,T,H) (post-softplus); A: (H,) negative;
    B,C: (b,T,N); D: (H,). Returns y: (b,T,H,dh).
    """
    b, T, H, dh = x.shape
    N = B.shape[-1]
    c = min(chunk, T)
    if T % c:
        c = T
    n_chunks = T // c

    xf = x.float()
    dtf = dt.float()
    Bf, Cf = B.float(), C.float()
    a = dtf * A.float()  # (b,T,H) decay log-coefficients (<=0)
    steps = torch.arange(c, device=x.device)
    mask = (steps[:, None] >= steps[None, :])[None, :, :, None]

    S = torch.zeros((b, H, N, dh), dtype=torch.float32, device=x.device)
    ys = []
    for ci in range(n_chunks):
        sl = slice(ci * c, (ci + 1) * c)
        xk, dtk, Bk, Ck, ak = xf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl], \
            a[:, sl]
        cum = torch.cumsum(ak, dim=1)  # (b,c,H) inclusive
        total = cum[:, -1]  # (b,H)
        # intra-chunk: L_ij = exp(cum_i - cum_j) for j<=i. Masked before
        # the exp: for j > i the exponent is positive and can overflow, and
        # where(mask, exp(diff), 0)'s gradient is then 0 * inf = NaN (the
        # reference's form, models/zamba.py:54); the values are the same
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # (b,i,j,H)
        Lm = torch.exp(torch.where(mask, diff, -math.inf))
        CB = torch.einsum("bin,bjn->bij", Ck, Bk)  # (b,i,j)
        W = CB[..., None] * Lm * dtk[:, None, :, :]  # (b,i,j,H)
        y_intra = torch.einsum("bijh,bjhd->bihd", W, xk)
        # inter-chunk: y_i += C_i . S * exp(cum_i)
        y_inter = torch.einsum("bin,bhnd->bihd", Ck, S) \
            * torch.exp(cum)[..., None]
        # state update: S' = exp(total) S + sum_j exp(total - cum_j) dt_j B_j x_j
        wj = torch.exp(total[:, None, :] - cum) * dtk  # (b,c,H)
        S = S * torch.exp(total)[:, :, None, None] + torch.einsum(
            "bjn,bjh,bjhd->bhnd", Bk, wj, xk)
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    y = y + xf * D.float()[None, None, :, None]
    return y.to(x.dtype)


def ssd_step(S, x, dt, A, B, C, D):
    """Recurrent SSD step. S: (b,H,N,dh); x: (b,H,dh); dt: (b,H);
    B,C: (b,N). Returns (S', y)."""
    dtf = dt.float()
    decay = torch.exp(dtf * A.float())  # (b,H)
    xf = x.float()
    S = S * decay[:, :, None, None] + torch.einsum(
        "bn,bh,bhd->bhnd", B.float(), dtf, xf)
    y = torch.einsum("bn,bhnd->bhd", C.float(), S)
    y = y + xf * D.float()[None, :, None]
    return S, y.to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def mamba_block_init(init: L.Init, cfg: ModelConfig):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    N = cfg.ssm_state
    H = di // cfg.ssm_head_dim
    dt = L.dtype_of(cfg.param_dtype)
    f32 = np.float32
    return {"ln": init.zeros((d,), dt, axes=("norm",)),
            # in_proj -> [z (di), x (di), B (N), C (N), dt (H)]
            "w_in": init.dense((d, 2 * di + 2 * N + H), dt,
                               axes=("embed", "ssm_inner")),
            "conv": init.dense((4, di + 2 * N), dt,
                               axes=(None, "ssm_inner")),
            "A_log": init.const(np.log(np.linspace(1.0, 16.0, H,
                                                   dtype=f32)),
                                axes=("norm",)),
            "D": init.ones((H,), axes=("norm",)),
            "dt_bias": init.const(np.log(np.expm1(np.full((H,), 0.01,
                                                          f32))),
                                  axes=("norm",)),
            "out_norm": init.zeros((di,), dt, axes=("norm",)),
            "w_out": init.dense((di, d), dt, axes=("ssm_inner", "embed"))}


def mamba_block_apply(p, x, cfg: ModelConfig, state=None, tp=None):
    """state None for training (chunked); for a decode step, the dict of
    S and conv, updated in place. Returns (x, state).

    With ``tp``, split by SSM heads where ``w_out``'s rows are this rank's
    (its heads' inner channels; else the block runs whole): the rank
    multiplies its heads' columns of z, x and dt and all of B and C
    (``columns`` re-cuts the packed ``w_in`` and ``conv``), runs the scan
    on its heads with their entries of ``A_log``, ``D`` and ``dt_bias``
    (whole leaves, read through ``copy_to``), normalises with the mean of
    squares all-reduced over the group, and ends in the row-parallel
    ``w_out``. In decode the conv state is the
    plan's contiguous cut of [x B C]: the new token's x is gathered, the
    rank convolves its state's channels, and the outputs are gathered, so
    no state crosses the group."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    N = cfg.ssm_state
    H = di // cfg.ssm_head_dim
    dh = cfg.ssm_head_dim
    bsz, T, _ = x.shape
    group, tp = tp, split_over(tp, p["w_out"].shape[-2], di)
    hs, cs = share(tp, H), share(tp, di)  # this rank's heads, channels
    nh, nc = hs[1] - hs[0], cs[1] - cs[0]
    xbc = (cs, (di, di + 2 * N))  # its channels of [x B C]
    h = copy_to(L.rms_norm(x, p["ln"], cfg.norm_eps), tp)
    w_in = columns(p["w_in"], tp, 2 * di + 2 * N + H, (
        cs, (di + cs[0], di + cs[1]), (2 * di, 2 * di + 2 * N),
        (2 * di + 2 * N + hs[0], 2 * di + 2 * N + hs[1])))
    proj = h @ w_in.to(h.dtype)
    z, xin, Bv, Cv, dt_raw = torch.split(proj, [nc, nc, N, N, nh], dim=-1)
    if state is None:
        conv_in = torch.cat([xin, Bv, Cv], dim=-1)
        conv_out, new_conv = causal_conv(
            conv_in, columns(p["conv"], tp, di + 2 * N, xbc), None)
    else:
        # the state's channels (cut as the plan cuts them, whether or not
        # the block runs split), then every rank's outputs
        conv_in = torch.cat([gather_from(xin, tp, -1), Bv, Cv], dim=-1)
        ctp = split_over(group, state["conv"].shape[-1], di + 2 * N)
        ch = (share(ctp, di + 2 * N),)
        conv_w = p["conv"] if splits(ctp, p["conv"].shape[-1], di + 2 * N) \
            else take(p["conv"], -1, ch)
        conv_out, new_conv = causal_conv(take(conv_in, -1, ch), conv_w,
                                         state["conv"])
        conv_out = take(gather_from(conv_out, ctp, -1), -1, xbc)
    conv_out = F.silu(conv_out)
    xin, Bv, Cv = torch.split(conv_out, [nc, N, N], dim=-1)
    dtv = F.softplus(dt_raw.float()
                     + whole_columns(p["dt_bias"], tp, (hs,))[None, None, :])
    A = -torch.exp(whole_columns(p["A_log"], tp, (hs,)))
    D = whole_columns(p["D"], tp, (hs,))
    xh = xin.reshape(bsz, T, nh, dh)
    if state is None:
        y = ssd_chunked(xh, dtv, A, Bv, Cv, D, cfg.ssm_chunk)
    else:
        S, y1 = ssd_step(state["S"], xh[:, 0], dtv[:, 0], A, Bv[:, 0],
                         Cv[:, 0], D)
        y = y1[:, None]
        state["S"].copy_(S)
        state["conv"].copy_(new_conv)
    y = y.reshape(bsz, T, nc)
    y = L.rms_norm(y, whole_columns(p["out_norm"], tp, (cs,)), cfg.norm_eps,
                   tp) * F.silu(z)
    out = reduce_from(y @ p["w_out"].to(y.dtype), tp)
    return x + out, state


# ---------------------------------------------------------------------------
# shared attention block (Zamba2): input = concat(x, x0) -> d
# ---------------------------------------------------------------------------

def shared_attn_init(init: L.Init, cfg: ModelConfig):
    """The shared block's own ``attn.w*_lora_a/_b`` are made, as the
    reference makes them, and never read: ``shared_attn_apply`` merges the
    per-application LoRA instead."""
    d = cfg.d_model
    dt = L.dtype_of(cfg.param_dtype)
    return {"ln": init.zeros((2 * d,), dt, axes=("norm",)),
            "w_in": init.dense((2 * d, d), dt, axes=("embed", None)),
            "attn": L.attn_init(init, cfg,
                                lora_rank=cfg.shared_attn_lora_rank),
            "ln2": init.zeros((d,), dt, axes=("norm",)),
            "mlp": L.mlp_init(init, cfg, cfg.d_ff)}


def shared_lora_init(init: L.Init, cfg: ModelConfig):
    """Per-application LoRA deltas for the shared block's qkv."""
    if not cfg.shared_attn_lora_rank:
        return {}
    d, r = cfg.d_model, cfg.shared_attn_lora_rank
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = L.dtype_of(cfg.param_dtype)
    p = {}
    for nm, out in (("wq", hq * hd), ("wk", hkv * hd), ("wv", hkv * hd)):
        p[f"{nm}_a"] = init.dense((d, r), dt, axes=("embed", None))
        p[f"{nm}_b"] = init.zeros((r, out), dt, axes=(None, "heads"))
    return p


def _lora_adjusted(attn_p, lora_p, cfg: ModelConfig, tp=None):
    """Merge per-application lora into attention weights view. With
    ``tp``, a ``w*_b`` cut over the group with its weight (by heads) gives
    this rank's columns of the merged weight, and the whole ``w*_a`` it
    multiplies enters through ``copy_to``."""
    if not lora_p:
        return attn_p
    p = dict(attn_p)
    hd = cfg.head_dim
    for nm, heads in (("wq", cfg.num_heads), ("wk", cfg.num_kv_heads),
                      ("wv", cfg.num_kv_heads)):
        a, b = lora_p[f"{nm}_a"], lora_p[f"{nm}_b"]
        if splits(tp, b.shape[-1], heads * hd):
            a = copy_to(a, tp)
        p[nm] = attn_p[nm] + (a @ b).to(attn_p[nm].dtype)
    return p


def shared_attn_apply(p, lora_p, x, x0, cfg: ModelConfig, *, positions,
                      tp=None):
    """With ``tp``, the attention and the MLP split as the transformer's
    (``models/layers.py``)."""
    h = L.rms_norm(torch.cat([x, x0], dim=-1), p["ln"], cfg.norm_eps)
    h = h @ p["w_in"].to(h.dtype)
    ap = _lora_adjusted(p["attn"], lora_p, cfg, tp)
    a = L.attn_apply(ap, h, cfg, positions=positions,
                     block_causal=cfg.block_causal, tp=tp)
    x = x + a
    h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h2, tp, cfg.d_ff)


def shared_attn_decode(p, lora_p, x, x0, kv_cache, cfg: ModelConfig, *, pos,
                       tp=None):
    h = L.rms_norm(torch.cat([x, x0], dim=-1), p["ln"], cfg.norm_eps)
    h = h @ p["w_in"].to(h.dtype)
    ap = _lora_adjusted(p["attn"], lora_p, cfg, tp)
    o, kv_cache = L.attn_decode(ap, h, kv_cache, cfg, pos=pos, tp=tp)
    x = x + o
    h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h2, tp, cfg.d_ff), kv_cache


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class ZambaModel:
    """``n_apps`` groups of [shared-attn + attn_every mamba] + trailing
    mamba blocks; one set of shared attention weights + per-app LoRA."""

    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        k = cfg.attn_every
        self.n_apps = cfg.num_layers // k
        self.per_group = k
        self.trailing = cfg.num_layers - self.n_apps * k

    def init(self, generator: torch.Generator):
        """Random params drawn from ``generator`` (on its own device), then
        moved to the model's device; on ``meta``, shapes and dtypes only.
        Mamba leaves are (n_apps, per_group, ...), as the reference
        stacks them."""
        return self._init(L.Init(generator, self.device))

    def param_axes(self):
        """The reference's logical axes tree, key for key."""
        return self._init(L.Init.axes())

    def param_shapes(self):
        """The parameter tree as ``meta`` tensors."""
        return self._init(L.Init(None, "meta"))

    def _init(self, init: L.Init):
        cfg = self.cfg
        params = {"embed": L.embed_init(init, cfg),
                  "mamba": mamba_block_init(
                      init.stacked(self.n_apps).stacked(self.per_group), cfg),
                  "shared": shared_attn_init(init, cfg),
                  "lora": shared_lora_init(init.stacked(self.n_apps), cfg)}
        if self.trailing:
            params["tail"] = mamba_block_init(init.stacked(self.trailing),
                                              cfg)
        return params

    def tp_whole(self, size: int):
        """Rule 1 over a ``model`` group of ``size`` ranks, as a tree like
        the parameters: True for a leaf that runs whole (the step layer
        gathers it over ``model`` where the plan splits it). Every leaf of
        the Mamba blocks where the SSM heads do not divide over the group
        (heads are never cut mid-head); the shared attention and its LoRA
        ``w*_b`` by the transformer's rule (``TransformerLM.tp_whole``).
        The rest runs as the plan lays it out."""
        cfg = self.cfg
        ssm = (cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim) % size != 0
        heads = cfg.num_heads % size != 0
        kv = cfg.num_kv_heads % size != 0

        def walk(tree, path):
            if isinstance(tree, dict):
                return {k: walk(v, path + (k,)) for k, v in tree.items()}
            if path[0] in ("mamba", "tail"):
                return ssm
            if path[0] == "lora" or path[:2] == ("shared", "attn"):
                return heads or (kv and path[-1][:2] in ("wk", "wv"))
            return False

        return walk(self.param_axes(), ())

    def _groups(self, params):
        """(mamba group, that application's LoRA) per application."""
        lora = unstacked(params["lora"]) if params["lora"] \
            else [{}] * self.n_apps
        return zip(unstacked(params["mamba"]), lora)

    # -- forward --------------------------------------------------------
    def forward(self, params, batch, tp=None):
        """-> (logits, aux 0); with ``tp`` (the parameters this rank's
        shards over it), the logits of this rank's vocabulary columns
        where the vocabulary splits."""
        cfg = self.cfg
        x = L.embed_lookup(params["embed"], batch["tokens"], cfg,
                           L.dtype_of(cfg.dtype), tp)
        x0 = x
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        shared = params["shared"]
        mode = "none" if cfg.remat == "none" else "full"

        def group_body(mp, lp, x):
            x = shared_attn_apply(shared, lp, x, x0, cfg, positions=positions,
                                  tp=tp)
            for layer_p in unstacked(mp):
                x, _ = mamba_block_apply(layer_p, x, cfg, tp=tp)
            return x

        def t_body(layer_p, x):
            return mamba_block_apply(layer_p, x, cfg, tp=tp)[0]

        body = L.remat(group_body, mode)
        for mp, lp in self._groups(params):
            x = body(mp, lp, x)
        if self.trailing:
            t_body = L.remat(t_body, mode)
            for layer_p in unstacked(params["tail"]):
                x = t_body(layer_p, x)
        logits = L.lm_logits(params["embed"], x, cfg, tp)
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)

    def loss(self, params, batch, tp=None):
        logits, _ = self.forward(params, batch, tp)
        ce = L.cross_entropy(logits, batch["targets"], tp=tp,
                             vocab_size=self.cfg.vocab_size)
        return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                                 device=ce.device)}

    # -- decode ---------------------------------------------------------
    def cache_spec(self, batch_size: int, max_seq: int):
        """The decode state's shapes and dtypes, as ``meta`` tensors."""
        cfg = self.cfg
        di = cfg.ssm_expand * cfg.d_model
        N = cfg.ssm_state
        H = di // cfg.ssm_head_dim
        dh = cfg.ssm_head_dim
        f32, dtc = torch.float32, L.dtype_of(cfg.dtype)
        A, G, b = self.n_apps, self.per_group, batch_size

        def spec(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        kv = (A, b, max_seq, cfg.num_kv_heads, cfg.head_dim)
        cache = {"mamba": {"S": spec((A, G, b, H, N, dh), f32),
                           "conv": spec((A, G, b, 3, di + 2 * N), dtc)},
                 "attn_kv": {"k": spec(kv, dtc), "v": spec(kv, dtc)}}
        if self.trailing:
            cache["tail"] = {
                "S": spec((self.trailing, b, H, N, dh), f32),
                "conv": spec((self.trailing, b, 3, di + 2 * N), dtc)}
        return cache

    def cache_axes(self):
        """The logical axes of ``cache_spec``'s leaves (the second half of
        the reference's ``cache_spec``)."""
        state = {"S": ("layers", "batch", "ssm_inner", None, None),
                 "conv": ("layers", "batch", None, "ssm_inner")}
        kv = ("layers", "batch", "seq_kv", None, None)
        ax = {"mamba": {k: ("layers",) + a for k, a in state.items()},
              "attn_kv": {"k": kv, "v": kv}}
        if self.trailing:
            ax["tail"] = state
        return ax

    def input_specs(self, shape):
        """``meta`` stand-ins and logical axes for tokens (and targets)."""
        return input_specs(self.cfg, shape)

    def init_cache(self, batch_size: int, max_seq: int):
        return _tree.map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                               device=self.device),
                         self.cache_spec(batch_size, max_seq))

    def decode_step(self, params, cache, batch, tp=None):
        """One token: batch = {tokens: (b,1), pos: int}. Returns (logits,
        cache): the cache is updated in place, so the step consumes it.
        With ``tp``, the cache holds this rank's shards of the state
        (``cache_axes``) and of the attention cache's positions where
        ``tp.cache_split`` says so."""
        cfg = self.cfg
        pos = int(batch["pos"])
        x = L.embed_lookup(params["embed"], batch["tokens"], cfg,
                           L.dtype_of(cfg.dtype), tp)
        x0 = x
        shared = params["shared"]
        for (mp, lp), mc, kvc in zip(self._groups(params),
                                     unstacked(cache["mamba"]),
                                     unstacked(cache["attn_kv"])):
            x, _ = shared_attn_decode(shared, lp, x, x0, kvc, cfg, pos=pos,
                                      tp=tp)
            for layer_p, layer_c in zip(unstacked(mp), unstacked(mc)):
                x, _ = mamba_block_apply(layer_p, x, cfg, state=layer_c,
                                         tp=tp)
        if self.trailing:
            for layer_p, layer_c in zip(unstacked(params["tail"]),
                                        unstacked(cache["tail"])):
                x, _ = mamba_block_apply(layer_p, x, cfg, state=layer_c,
                                         tp=tp)
        return L.lm_logits(params["embed"], x, cfg, tp), cache
