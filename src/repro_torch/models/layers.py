"""Port of ``src/repro/models/layers.py``: the LM zoo's building blocks
(parameter init, RMS norm, RoPE, the blockwise ``flash_attention``,
attention with optional LoRA, its prefill and decode forms against a
preallocated cache, cross-attention, the MLP, the GShard-style MoE,
embeddings) and the loss.

Parameters are nested dicts of tensors with the reference's keys, shapes
and dtypes. Each draw also names the reference's logical axes (for the
sharding rules, ``repro_torch.sharding``): an ``Init.axes()`` builder
returns those tuples in the place of tensors, so a model's ``init`` run
on it gives the axes tree. ``flash_attention`` is plain jnp in the
reference, not a Pallas kernel, so here it is plain torch with the same
chunking, mask value and merge. Decode writes its cache in place (``attn_decode``),
where the reference returns an updated copy.

Each apply function takes an optional ``tp``, the ``model`` group of a
mesh (``sharding/tensor_parallel.py``); without one it is the one-device
code. With one, its leaves are this rank's shards over ``model`` where the
plan splits them (whole elsewhere, gathered by the step layer), and it
computes what GSPMD partitions in the reference: q/k/v and the MLP's
first matrices column-parallel, ``wo`` and ``w_down`` row-parallel, the
MoE's experts over ``expert``, the embedding, the head and the loss over
``vocab``, and decode over the cache's ``seq_kv`` (flash-decode). Heads
are never cut mid-head: an attention block whose q heads do not divide
over the group runs whole. ``rms_norm`` normalises over a dim split over
the group (the recurrent blocks' gated norm).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.sharding.tensor_parallel import (copy_to, gather_from,
                                                  reduce_from, split_over,
                                                  splits, sum_over,
                                                  vocab_logsumexp)


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype name ("float32", "bfloat16") as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype '{name}'")
    return dt


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

class Init:
    """Draws a model's parameters from a ``torch.Generator`` on the
    generator's own device (the host for a CPU generator, the card for a
    CUDA one) and moves each to ``device``; on the ``meta`` device it
    makes shapes and dtypes only and draws nothing (the reference's
    ``abstract_init``).

    ``stacked(n)`` gives an ``Init`` whose every leaf has ``n`` prepended
    to its shape (the reference's ``stack_init``: one leaf per parameter,
    its layers on the leading axis). ``jax.random`` streams cannot be
    reproduced here, so only shapes, dtypes and the scale of each draw
    match the reference.

    Every draw takes ``axes``, the leaf's logical axes as the reference's
    ``Builder`` records them. On the builder that ``Init.axes()`` returns,
    a draw gives those axes, with one ``"layers"`` per stacking prepended
    (the reference's ``stack_init``), instead of a tensor."""

    def __init__(self, generator: Optional[torch.Generator], device,
                 lead: tuple = (), *, axes_only: bool = False):
        self.generator = generator
        self.device = torch.device(device)
        self.lead = tuple(lead)
        self.axes_only = axes_only

    @classmethod
    def axes(cls) -> "Init":
        return cls(None, "meta", axes_only=True)

    def stacked(self, n: int) -> "Init":
        return Init(self.generator, self.device, self.lead + (n,),
                    axes_only=self.axes_only)

    def _draw(self, shape, dtype, fill, axes):
        if self.axes_only:
            if axes is None:
                raise ValueError("Init.axes(): this draw names no axes")
            return ("layers",) * len(self.lead) + tuple(axes)
        shape = self.lead + tuple(shape)
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype, device="meta")
        at = self.generator.device if self.generator is not None else "cpu"
        return fill(torch.empty(shape, dtype=torch.float32,
                                device=at)).to(self.device, dtype)

    def dense(self, shape, dtype=torch.float32, scale: float = None, *,
              axes=None):
        """Truncated normal in [-2, 2] times ``scale`` (default 1 /
        sqrt(fan-in), the reference's ``dense_init``)."""
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        return self._draw(shape, dtype, lambda t: torch.nn.init.trunc_normal_(
            t, 0.0, 1.0, -2.0, 2.0, generator=self.generator).mul_(std), axes)

    def normal(self, shape, std: float, dtype=torch.float32, *, axes=None):
        return self._draw(shape, dtype, lambda t: t.normal_(
            0.0, 1.0, generator=self.generator).mul_(std), axes)

    def zeros(self, shape, dtype=torch.float32, *, axes=None):
        return self._draw(shape, dtype, torch.zero_, axes)

    def ones(self, shape, dtype=torch.float32, *, axes=None):
        return self._draw(shape, dtype, lambda t: t.fill_(1.0), axes)

    def const(self, values, dtype=torch.float32, *, axes=None):
        """A fixed 1-D ``values`` (host numpy, f32), the same in every
        stacked layer, cast to ``dtype`` as the reference casts it."""
        v = torch.from_numpy(np.asarray(values, dtype=np.float32))
        return self._draw(v.shape, dtype, lambda t: t.copy_(v), axes)


# ---------------------------------------------------------------------------
# normalisation / rope
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-5, tp=None):
    """In f32; the learned scale is stored as an offset from 1. With
    ``tp``, ``x``'s last dim is this rank's equal slice of the normalised
    dim (and ``scale`` its slice of the scale): the mean of squares is the
    mean over the group of each rank's ``torch.mean``, all-reduced in f32
    both ways (``sum_over``), so over one rank it is ``torch.mean``'s."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    if tp is not None:
        var = sum_over(var, tp) / tp.size
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    # copied to the device once: a copy from pageable host memory waits
    # for the device's queue to empty, and apply_rope runs twice a layer
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq). Rotates the
    two halves of head_dim (not interleaved pairs)."""
    freqs = _rope_freqs_on(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (flash-style chunked, plain torch: memory O(seq * chunk))
# ---------------------------------------------------------------------------

def _attn_block(q, k, v, mask, scale):
    """q: (b,cq,hkv,g,d)  k/v: (b,ck,hkv,d) -> (max, sum, partial out),
    scores and products in f32."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
    s = s * scale
    if mask is not None:
        s = torch.where(mask, s, -1e30)
    m = torch.amax(s, dim=-1)  # (b,h,g,q)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return m, l, o


def _merge(m1, l1, o1, m2, l2, o2):
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    l = l1 * a1 + l2 * a2
    # o partials are (b,q,h,g,d); stats (b,h,g,q) -> move the q axis
    s1 = torch.movedim(a1, -1, 1)[..., None]
    s2 = torch.movedim(a2, -1, 1)[..., None]
    return m, l, o1 * s1 + o2 * s2


def flash_attention(q, k, v, *, causal: bool, q_chunk: int = 1024,
                    kv_chunk: int = 1024, kv_valid_len=None,
                    block_causal: bool = True):
    """Chunked (flash-style) attention with GQA, O(seq*chunk) live memory.

    q: (b, sq, hq, d); k,v: (b, skv, hkv, d). hq = g * hkv.
    ``block_causal=True`` skips fully-masked KV blocks for causal attention
    (a lower-triangular schedule: ~2x fewer attention FLOPs).
    ``kv_valid_len``: optional scalar; masks kv positions >= it.
    A chunk that does not divide its sequence falls back to one block.
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    q = q.reshape(b, sq, hkv, g, d)

    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    nq = max(sq // q_chunk, 1)
    nk = max(skv // kv_chunk, 1)
    if sq % q_chunk:
        nq, q_chunk = 1, sq
    if skv % kv_chunk:
        nk, kv_chunk = 1, skv

    kb = k.reshape(b, nk, kv_chunk, hkv, d)
    vb = v.reshape(b, nk, kv_chunk, hkv, d)
    kv_pos = torch.arange(skv, device=q.device).reshape(nk, kv_chunk)

    outs = []
    for qi in range(nq):
        qc = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
        m = torch.full((b, hkv, g, q_chunk), -1e30, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hkv, g, q_chunk), dtype=torch.float32,
                        device=q.device)
        o = torch.zeros((b, q_chunk, hkv, g, d), dtype=torch.float32,
                        device=q.device)
        # blocks [0, qi] alone can contribute under the causal schedule
        hi = qi + 1 if causal and block_causal and nq == nk and sq == skv \
            else nk
        for ki in range(hi):
            kpos = kv_pos[ki]
            mask = None
            if causal:
                mask = q_pos[:, None] >= kpos[None, :]
            if kv_valid_len is not None:
                vm = kpos < kv_valid_len
                mask = vm[None, :] if mask is None else (mask & vm[None, :])
            if mask is not None:
                mask = mask[None, None, None]  # (1,1,1,q,k) vs (b,h,g,q,k)
            m2, l2, o2 = _attn_block(qc, kb[:, ki], vb[:, ki], mask, scale)
            m, l, o = _merge(m, l, o, m2, l2, o2)
        l = torch.movedim(l, -1, 1)[..., None]  # (b,q,h,g,1)
        outs.append((o / torch.clamp(l, min=1e-30)).to(v.dtype))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out.reshape(b, sq, hq, d)


def decode_attention(q, k_cache, v_cache, cache_len, tp=None):
    """Single-token attention against a preallocated cache.

    q: (b, 1, hq, d); caches: (b, smax, hkv, d); cache_len: int (number
    of valid positions, including the token just written). Scores and
    products in f32, as the reference's ``preferred_element_type``.

    With ``tp`` whose ``cache_split`` is set, the caches hold this rank's
    ``smax`` positions of the whole ``smax * tp.size`` (flash-decode): the
    rank attends over them for every head, and the partials (max, sum of
    exps, output) of every rank are all-gathered and merged in rank order
    (``_merge_ranks``). Over one rank that is the one-device code.
    """
    b, _, hq, d = q.shape
    _, smax, hkv, _ = k_cache.shape
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qh = q.reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qh.float(), k_cache.float()) * scale
    split = tp is not None and tp.cache_split
    at = torch.arange(smax, device=q.device)
    if split:
        at = at + tp.rank * smax  # this rank's positions
    mask = at[None, None, None, :] < cache_len
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    if split:
        m = torch.amax(s, dim=-1)
        l = torch.sum(torch.exp(s - m[..., None]), dim=-1)
        part = torch.cat([m[..., None], l[..., None], o], dim=-1)
        parts = gather_from(part[None], tp, 0)
        o = _merge_ranks([(x[..., 0], x[..., 1], x[..., 2:]) for x in parts])
    return o.reshape(b, 1, hq, d).to(v_cache.dtype)


def _merge_ranks(parts):
    """One output from per-rank partials ``(m, l, o)`` in rank order: m, l
    (b, h, g) the max and the sum of exps of a rank's scores, o (b, h, g,
    d) its output normalised by l. Merged with ``_merge`` on the
    unnormalised outputs, then normalised once; one partial is returned
    as it is."""
    m, l, o = parts[0]
    if len(parts) == 1:
        return o

    def merge_form(m, l, o):  # _merge's (b,h,g,q) stats, (b,q,h,g,d) outs
        return m[..., None], l[..., None], (o * l[..., None])[:, None]

    M, L, O = merge_form(m, l, o)
    for part in parts[1:]:
        M, L, O = _merge(M, L, O, *merge_form(*part))
    return O[:, 0] / L


# ---------------------------------------------------------------------------
# attention module (params + apply)
# ---------------------------------------------------------------------------

def attn_init(init: Init, cfg, lora_rank: int = 0):
    d = cfg.d_model
    hd, hq, hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    dt = dtype_of(cfg.param_dtype)
    p = {"wq": init.dense((d, hq * hd), dt, axes=("embed", "heads")),
         "wk": init.dense((d, hkv * hd), dt, axes=("embed", "kv_heads")),
         "wv": init.dense((d, hkv * hd), dt, axes=("embed", "kv_heads")),
         "wo": init.dense((hq * hd, d), dt, axes=("heads", "embed"))}
    if cfg.qk_norm:
        p["q_norm"] = init.zeros((hd,), dt, axes=("norm",))
        p["k_norm"] = init.zeros((hd,), dt, axes=("norm",))
    if lora_rank:
        for nm in ("wq", "wk", "wv"):
            out = hq * hd if nm == "wq" else hkv * hd
            p[f"{nm}_lora_a"] = init.dense((d, lora_rank), dt,
                                           axes=("embed", "norm"))
            p[f"{nm}_lora_b"] = init.zeros((lora_rank, out), dt,
                                           axes=("norm", "heads"))
    return p


def _proj_qkv(p, x, cfg, lora_scope=None, tp=None, *, kv_x=None,
              every_kv=False):
    """q, k, v (b, s, heads, hd); with ``lora_scope`` (a function of a LoRA
    leaf, e.g. one application's slice) each projection adds x @ a @ b.
    ``kv_x``: the context k and v are taken from (cross-attention; ``x``
    itself otherwise).

    With ``tp`` (a block that runs split over it), column-parallel: q of
    this rank's heads, and k, v of its kv heads where they split over the
    group. ``wk``/``wv`` whole (their heads do not divide over it) are cut
    to the columns of the kv heads this rank's q heads read, or kept whole
    with ``every_kv``. The inputs, and whole weights and ``qk_norm`` scales
    applied to this rank's heads, enter through ``copy_to``."""
    hd = cfg.head_dim
    x = copy_to(x, tp)
    kv_x = x if kv_x is None else copy_to(kv_x, tp)
    w = {n: p[n] for n in ("wq", "wk", "wv")}
    if (tp is not None and not every_kv
            and not splits(tp, w["wk"].shape[-1], cfg.num_kv_heads * hd)):
        cols = _columns(_kv_heads(cfg, tp, False), hd)
        for n in ("wk", "wv"):
            w[n] = copy_to(w[n], tp)[..., cols]

    def mm(inp, name):
        y = inp @ w[name].to(x.dtype)
        if lora_scope is not None and f"{name}_lora_a" in p:
            a = lora_scope(p[f"{name}_lora_a"]).to(x.dtype)
            bb = lora_scope(p[f"{name}_lora_b"]).to(x.dtype)
            y = y + (inp @ a) @ bb
        return y

    q = mm(x, "wq").reshape(*x.shape[:2], -1, hd)
    k = mm(kv_x, "wk").reshape(*kv_x.shape[:2], -1, hd)
    v = mm(kv_x, "wv").reshape(*kv_x.shape[:2], -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, copy_to(p["q_norm"], tp), cfg.norm_eps)
        k = rms_norm(k, copy_to(p["k_norm"], tp), cfg.norm_eps)
    return q, k, v


def _attn_tp(p, cfg, tp):
    """The group an attention block runs split over: ``tp`` where its q
    heads are cut by whole heads, else None. The step layer gathers a
    block whose ``num_heads`` does not divide over the group, which then
    runs whole."""
    return split_over(tp, p["wq"].shape[-1], cfg.num_heads * cfg.head_dim)


def _kv_heads(cfg, tp, kv_split: bool):
    """The kv heads this rank's q heads read, as indices into the whole kv
    heads: this rank's own when they split over the group; otherwise
    (``num_kv_heads`` does not divide over it) a slice, when each head it
    reads serves as many of its q heads, else one kv head per q head."""
    if kv_split:
        n = cfg.num_kv_heads // tp.size
        return slice(tp.rank * n, (tp.rank + 1) * n)
    hq = cfg.num_heads // tp.size
    g = cfg.num_heads // cfg.num_kv_heads
    idx = [(tp.rank * hq + j) // g for j in range(hq)]
    heads = sorted(set(idx))
    if idx == [h for h in heads for _ in range(hq // len(heads))]:
        return slice(heads[0], heads[-1] + 1)
    return idx


def _columns(heads, hd: int):
    """The projection columns of ``heads`` (a slice or index list)."""
    if isinstance(heads, slice):
        return slice(heads.start * hd, heads.stop * hd)
    return torch.tensor([c for h in heads for c in range(h * hd,
                                                          (h + 1) * hd)])


def _out_proj(p, o, x, tp):
    """``wo`` of the heads' outputs ``o`` (b, s, heads, hd); with ``tp``
    (the block runs split) row-parallel, its partial sums reduced."""
    b, s = o.shape[:2]
    return reduce_from(o.reshape(b, s, -1) @ p["wo"].to(x.dtype), tp)


def attn_apply(p, x, cfg, *, positions, causal=None, block_causal=True,
               lora_scope=None, tp=None):
    causal = cfg.causal if causal is None else causal
    tp = _attn_tp(p, cfg, tp)
    q, k, v = _proj_qkv(p, x, cfg, lora_scope, tp)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=causal, q_chunk=cfg.attn_chunk,
                        kv_chunk=cfg.attn_chunk, block_causal=block_causal)
    return _out_proj(p, o, x, tp)


def attn_prefill(p, x, cfg, *, positions, smax, lora_scope=None):
    """Forward + return kv to seed a decode cache padded to smax."""
    q, k, v = _proj_qkv(p, x, cfg, lora_scope)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=cfg.causal, q_chunk=cfg.attn_chunk,
                        kv_chunk=cfg.attn_chunk)
    b, s, _, _ = o.shape
    pad = (0, 0, 0, 0, 0, smax - s)  # the seq axis, from the last axis back
    k_cache = F.pad(k, pad)
    v_cache = F.pad(v, pad)
    o = o.reshape(b, s, cfg.num_heads * cfg.head_dim)
    return o @ p["wo"].to(x.dtype), (k_cache, v_cache)


def attn_decode(p, x, cache, cfg, *, pos, lora_scope=None, tp=None):
    """x: (b,1,d); cache: dict(k,v) of (b,smax,hkv,hd); pos: int index.

    Writes this token's k and v into ``cache`` at ``pos`` in place and
    returns (out, cache). The reference's ``dynamic_update_slice`` clamps
    a write past smax to the last slot; here it raises ``IndexError``.

    With ``tp``: where the block runs split, q, k, v of this rank's heads,
    the q heads and the new token's kv heads all-gathered (one token, one
    call), and this rank's heads through the row-parallel ``wo``. Where
    the cache's positions are split over the group too
    (``tp.cache_split``), the rank whose positions hold ``pos`` alone
    writes them, and the attention is flash-decoded over every rank's
    positions (``decode_attention``); otherwise every rank writes them."""
    pos = int(pos)
    btp = _attn_tp(p, cfg, tp)
    q, k, v = _proj_qkv(p, x, cfg, lora_scope, btp, every_kv=True)
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q, k, v = _gather_heads(q, k, v, btp, splits(
        btp, p["wk"].shape[-1], cfg.num_kv_heads * cfg.head_dim))
    smax = cache["k"].shape[1]
    ranks, rank = ((tp.size, tp.rank) if tp is not None and tp.cache_split
                   else (1, 0))
    owner, at = divmod(pos, smax)
    if owner >= ranks:
        raise IndexError(f"decode position {pos} is past the cache's "
                         f"{smax * ranks} positions")
    if owner == rank:
        cache["k"][:, at] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, at] = v[:, 0].to(cache["v"].dtype)
    o = decode_attention(q, cache["k"], cache["v"], pos + 1, tp)
    if btp is not None:
        n = cfg.num_heads // btp.size
        o = o[:, :, btp.rank * n:(btp.rank + 1) * n]
    return _out_proj(p, o, x, btp), cache


def _gather_heads(q, k, v, tp, kv_split: bool):
    """One token's q (and k, v with ``kv_split``) (b, 1, heads, hd), this
    rank's heads over ``tp``, all-gathered along the heads in one call,
    each in rank order; as they are with no group."""
    if tp is None:
        return q, k, v
    parts = [q, k, v] if kv_split else [q]
    sizes = [t.shape[2] for t in parts]
    every = gather_from(torch.cat(parts, dim=2)[None], tp, 0)
    out = [t.movedim(0, 2).flatten(2, 3)
           for t in every.split(sizes, dim=3)]  # (p,b,1,n,hd) -> (b,1,pn,hd)
    return tuple(out) if kv_split else (out[0], k, v)


def cross_attn_apply(p, x, kv_embeds, cfg, tp=None):
    """Cross attention onto (b, n_img, d) context (no rope); with ``tp``
    split as ``attn_apply`` is."""
    tp = _attn_tp(p, cfg, tp)
    q, k, v = _proj_qkv(p, x, cfg, tp=tp, kv_x=kv_embeds)
    o = flash_attention(q, k, v, causal=False, q_chunk=cfg.attn_chunk,
                        kv_chunk=cfg.attn_chunk)
    return _out_proj(p, o, x, tp)


# ---------------------------------------------------------------------------
# MLP / MoE
# ---------------------------------------------------------------------------

def mlp_init(init: Init, cfg, d_ff: int):
    d = cfg.d_model
    dt = dtype_of(cfg.param_dtype)
    p = {}
    if not cfg.mlp_gelu:
        p["w_gate"] = init.dense((d, d_ff), dt, axes=("embed", "mlp"))
    p["w_up"] = init.dense((d, d_ff), dt, axes=("embed", "mlp"))
    p["w_down"] = init.dense((d_ff, d), dt, axes=("mlp", "embed"))
    return p


def mlp_apply(p, x, tp=None, d_ff: int = None):
    """SwiGLU with ``w_gate``, else a 2-matrix MLP with ``jax.nn.gelu``'s
    default, the tanh approximation. With ``tp``, an MLP whose hidden
    dim ``d_ff`` runs split: ``w_gate``/``w_up`` column-parallel, ``w_down``
    row-parallel."""
    tp = split_over(tp, p["w_up"].shape[-1], d_ff)
    x = copy_to(x, tp)
    u = x @ p["w_up"].to(x.dtype)
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * u
    else:
        h = F.gelu(u, approximate="tanh")
    return reduce_from(h @ p["w_down"].to(x.dtype), tp)


def moe_init(init: Init, cfg):
    E, ff, d = cfg.num_experts, cfg.d_ff, cfg.d_model
    dt = dtype_of(cfg.param_dtype)
    p = {"router": init.dense((d, E), dt, scale=0.02,
                              axes=("embed", "expert")),
         "w_gate": init.dense((E, d, ff), dt,
                              axes=("expert", "expert_in", "mlp")),
         "w_up": init.dense((E, d, ff), dt,
                            axes=("expert", "expert_in", "mlp")),
         "w_down": init.dense((E, ff, d), dt,
                              axes=("expert", "mlp", "expert_in"))}
    if cfg.num_shared_experts:
        p["shared"] = mlp_init(init, cfg, ff * cfg.num_shared_experts)
    return p


def moe_apply(p, x, cfg, *, group_size: int = 2048,
              capacity_factor: float = 1.25, tp=None):
    """GShard-style grouped top-k dispatch through one-hot einsums.

    Tokens are split into groups; each group dispatches into per-expert
    capacity slots. Over-capacity tokens are dropped (their residual
    passes through): which ones follows a cumsum over the flattened
    (token, choice) order. Top-k breaks ties toward the lower expert, as
    ``jax.lax.top_k`` does (a stable descending sort). Every expert runs
    over its capacity slots, as in the reference, so the sums run in its
    order. -> (y, the Switch-style load-balancing aux loss).

    With ``tp`` the router is whole on every rank, so routing, capacities
    and drops are the one-device ones, and so is the aux loss (from the
    full ``probs``). Each rank runs its experts (``expert`` split over
    the group; or every expert's share of a split ``mlp`` dim) over their
    capacity slots; its share of the combine is reduced over the group.
    """
    b, s, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    tokens = x.reshape(-1, d)
    T = tokens.shape[0]
    g = min(group_size, T)
    if T % g:
        g = T  # single group fallback
    n_groups = T // g
    cap = max(int(g * k * capacity_factor / E), 1)

    xt = tokens.reshape(n_groups, g, d)
    logits = xt @ p["router"].to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)

    # top-k gating
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[..., :k], gate_idx[..., :k]  # (n,g,k)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)

    # position of each (token, choice) within its expert queue
    experts = torch.arange(E, device=x.device)
    onehot = (gate_idx[..., None] == experts).float()  # (n,g,k,E)
    flat = onehot.reshape(n_groups, g * k, E)
    pos_in_e = (torch.cumsum(flat, dim=1) - flat).reshape(n_groups, g, k, E)
    pos = torch.sum(pos_in_e * onehot, dim=-1)  # (n,g,k)
    keep = pos < cap
    gate_vals = gate_vals * keep

    # dispatch/combine one-hots: (n, g, k, E, cap) reduced over k
    slots = torch.arange(cap, device=x.device)
    cap_oh = (pos[..., None] == slots).float() * keep[..., None]
    dispatch = torch.einsum("ngke,ngkc->ngec", onehot, cap_oh)
    combine = torch.einsum("ngke,ngkc,ngk->ngec", onehot, cap_oh, gate_vals)

    E_here = p["w_gate"].shape[0]
    by_expert = splits(tp, E_here, E)
    split = by_expert or splits(tp, p["w_gate"].shape[-1], cfg.d_ff)
    xe_in = xt
    if split:
        first = tp.rank * E_here if by_expert else 0
        dispatch = dispatch[:, :, first:first + E_here]
        combine = copy_to(combine, tp)[:, :, first:first + E_here]
        xe_in = copy_to(xt, tp)
    xe = torch.einsum("ngec,ngd->necd", dispatch.to(x.dtype), xe_in)
    xe = xe.permute(1, 0, 2, 3).reshape(E_here, n_groups * cap, d)
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, p["w_gate"].to(x.dtype)))
    h = h * torch.einsum("ecd,edf->ecf", xe, p["w_up"].to(x.dtype))
    ye = torch.einsum("ecf,efd->ecd", h, p["w_down"].to(x.dtype))
    ye = ye.reshape(E_here, n_groups, cap, d).permute(1, 0, 2, 3)
    y = torch.einsum("ngec,necd->ngd", combine.to(x.dtype), ye)
    if split:
        y = reduce_from(y, tp)
    y = y.reshape(b, s, d)

    # load-balancing auxiliary loss (Switch-style)
    me = torch.mean(flat, dim=1) * E  # fraction routed per expert * E
    pe = torch.mean(probs, dim=1) * E
    aux = torch.mean(torch.sum(me * pe, dim=-1)) / E

    if cfg.num_shared_experts and "shared" in p:
        y = y + mlp_apply(p["shared"], x, tp,
                          cfg.d_ff * cfg.num_shared_experts)
    return y, aux


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------

def embed_init(init: Init, cfg):
    dt = dtype_of(cfg.param_dtype)
    p = {}
    if not cfg.external_embeddings:
        p["embedding"] = init.dense((cfg.vocab_size, cfg.d_model), dt,
                                    scale=1.0, axes=("vocab", "embed"))
    if not cfg.tie_embeddings:
        p["lm_head"] = init.dense((cfg.d_model, cfg.vocab_size), dt,
                                  axes=("embed", "vocab"))
    p["final_norm"] = init.zeros((cfg.d_model,), dt, axes=("norm",))
    return p


def _vocab_rows(ids, n: int, tp):
    """Token ids as rows of this rank's ``n`` vocabulary rows: -> (row
    indices, 0 where the id lies outside them; the mask of those inside)."""
    t = ids.long() - tp.rank * n
    inside = (t >= 0) & (t < n)
    return torch.where(inside, t, 0), inside


def embed_lookup(p, tokens, cfg, compute_dtype, tp=None):
    """With ``tp`` and the vocabulary split over it, each rank reads its
    rows (zero outside them) and the rows are summed over the group."""
    w = p["embedding"]
    if splits(tp, w.shape[0], cfg.vocab_size):
        rows, inside = _vocab_rows(tokens, w.shape[0], tp)
        emb = reduce_from(torch.where(inside[..., None], w[rows], 0), tp)
    else:
        emb = w[tokens.long()]
    emb = emb.to(compute_dtype)
    return emb * math.sqrt(cfg.d_model) if cfg.tie_embeddings else emb


def lm_logits(p, x, cfg, tp=None):
    """With ``tp`` and the vocabulary split over it, column-parallel: the
    logits of this rank's vocabulary columns."""
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    w = p["embedding"].T if cfg.tie_embeddings else p["lm_head"]
    if splits(tp, w.shape[-1], cfg.vocab_size):
        x = copy_to(x, tp)
    return x @ w.to(x.dtype)


def cross_entropy(logits, targets, *, z_loss: float = 1e-4, tp=None,
                  vocab_size: int = None):
    """Mean token cross-entropy in fp32 with z-loss regulariser. With
    ``tp`` and logits of ``vocab_size`` split over it (this rank's
    columns), vocab-parallel: the max, the sum of exps and the target
    logit are each all-reduced over the group, in f32."""
    logits = logits.float()
    if splits(tp, logits.shape[-1], vocab_size):
        lse = vocab_logsumexp(logits, tp)
        cols, inside = _vocab_rows(targets, logits.shape[-1], tp)
        ll = torch.gather(logits, -1, cols[..., None])[..., 0]
        ll = reduce_from(torch.where(inside, ll, 0.0), tp)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    loss = torch.mean(lse - ll)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss


# ---------------------------------------------------------------------------
# rematerialisation
# ---------------------------------------------------------------------------

# the matmuls with no batch dimension: a weight times activations
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn, mode: str):
    """The reference's remat policies for a layer body. ``"full"`` saves
    the body's inputs alone and recomputes the rest in the backward pass
    (``jax.checkpoint``); ``"dots"`` also saves the outputs of the
    matmuls with no batch dimension (``checkpoint_dots_with_no_batch_dims``).
    Memory changes, values do not; without grad, ``fn`` runs as is."""
    if mode == "none":
        return fn

    def context():
        return create_selective_checkpoint_contexts(_save_dots)

    kw = {"context_fn": context} if mode == "dots" else {}

    @functools.wraps(fn)
    def run(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        return checkpoint(fn, *args, use_reentrant=False, **kw, **kwargs)

    return run
