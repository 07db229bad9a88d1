"""Port of ``src/repro/models/xlstm.py``: xLSTM (arXiv:2405.04517), mLSTM
(matrix-memory, chunkwise-parallel) and sLSTM (scalar-memory,
sequential) blocks.

Layout for xlstm-1.3b: 48 blocks = 6 segments of [7 mLSTM + 1 sLSTM]
(``slstm_every=8``). ``d_ff=0`` in the assigned config means there is no
separate FFN: mLSTM blocks are pre-up-projection (pf=2), the sLSTM block
carries a pf=4/3 gated FFN, per the paper.

Training uses the stabilised chunkwise-parallel mLSTM form; decode uses
the O(1)-state recurrent form. ``mlstm_chunkwise`` is plain jnp in the
reference, so here it is plain torch (a loop over chunks for its scan).
The decode state is updated in place: at full width one mLSTM block's
matrix memory is 8 requests x 4 heads x 1024^2 f32 (134 MB), 5.6 GB over
the 42 blocks, which the reference rebuilds on every token.

``forward``, ``loss`` and ``decode_step`` take an optional ``tp``, the
``model`` group of a mesh (``sharding/tensor_parallel.py``), and the
parameters as this rank's shards over it: the mLSTM blocks split over
their inner channels, their cell by heads in training (where the heads
divide) and by the key dim in decode; the sLSTM blocks by heads; the
embedding, head and loss as the transformer's. ``tp_whole`` says which
leaves run whole.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import _tree
from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import input_specs, unstacked
from repro_torch.sharding.tensor_parallel import (columns, copy_to,
                                                  gather_from, reduce_from,
                                                  share, split_over, sum_over,
                                                  take, whole_columns)

# ---------------------------------------------------------------------------
# mLSTM cell: chunkwise parallel (training) and recurrent (decode)
# ---------------------------------------------------------------------------


def mlstm_chunkwise(q, k, v, i_logit, f_logit, chunk: int):
    """Stabilised chunkwise mLSTM.

    q,k,v: (b, T, H, dh); i_logit,f_logit: (b, T, H). Returns h: (b,T,H,dh).
    """
    b, T, H, dh = q.shape
    c = min(chunk, T)
    if T % c:
        c = T
    n_chunks = T // c
    scale = 1.0 / math.sqrt(dh)

    qa = (q * scale).float()
    ka, va = k.float(), v.float()
    logf = F.logsigmoid(f_logit.float())
    logi = i_logit.float()
    steps = torch.arange(c, device=q.device)
    mask = (steps[:, None] >= steps[None, :])[None, :, :, None]

    C = torch.zeros((b, H, dh, dh), dtype=torch.float32, device=q.device)
    n = torch.zeros((b, H, dh), dtype=torch.float32, device=q.device)
    m = torch.full((b, H), -1e30, dtype=torch.float32, device=q.device)
    hs = []
    for ci in range(n_chunks):
        sl = slice(ci * c, (ci + 1) * c)
        qs, ks, vs, lf, li = qa[:, sl], ka[:, sl], va[:, sl], logf[:, sl], \
            logi[:, sl]
        a = torch.cumsum(lf, dim=1)  # inclusive decay from chunk start
        total = a[:, -1]  # (b,H)
        g = li - a  # (b,c,H)

        # row-stabiliser: m_i = max(intra running max, state path)
        m_loc = torch.cummax(g, dim=1).values + a  # (b,c,H)
        m_inter = m[:, None, :] + a
        m_i = torch.maximum(m_loc, m_inter)  # (b,c,H)

        # intra-chunk (j <= i): w_ij = exp(a_i - a_j + li_j - m_i)
        wa = a[:, :, None, :] - a[:, None, :, :] + li[:, None, :, :] \
            - m_i[:, :, None, :]  # (b, i, j, H)
        # masked before the exp: for j > i the exponent can overflow, and
        # where(mask, exp(wa), 0)'s gradient is then 0 * inf = NaN (the
        # reference's form, models/xlstm.py:64); the values are the same
        w = torch.exp(torch.where(mask, wa, -math.inf))
        s = torch.einsum("bihd,bjhd->bijh", qs, ks)
        sw = s * w
        num_intra = torch.einsum("bijh,bjhd->bihd", sw, vs)
        den_intra = torch.sum(sw, dim=2)  # (b,i,H)

        # inter-chunk: state contribution, scaled exp(a_i + m - m_i)
        wi = torch.exp(a + m[:, None, :] - m_i)  # (b,c,H)
        num_inter = torch.einsum("bihd,bhde->bihe", qs, C) * wi[..., None]
        den_inter = torch.einsum("bihd,bhd->bih", qs, n) * wi

        denom = torch.maximum(torch.abs(den_intra + den_inter),
                              torch.exp(-m_i))
        hs.append((num_intra + num_inter) / denom[..., None])

        # state update to chunk end
        m_new = torch.maximum(m + total, torch.amax(
            li + total[:, None, :] - a, dim=1))
        wk = torch.exp(li + total[:, None, :] - a - m_new[:, None, :])
        C = C * torch.exp(m + total - m_new)[..., None, None] + torch.einsum(
            "bjhd,bjhe,bjh->bhde", ks, vs, wk)
        n = n * torch.exp(m + total - m_new)[..., None] + torch.einsum(
            "bjhd,bjh->bhd", ks, wk)
        m = m_new
    h = torch.cat(hs, dim=1) if len(hs) > 1 else hs[0]
    return h.to(v.dtype)


def mlstm_step(state, q, k, v, i_logit, f_logit, tp=None):
    """Recurrent mLSTM step. state=(C,n,m): (b,H,dh,dh),(b,H,dh),(b,H) f32,
    updated in place; q,k,v: (b,H,dh); i,f: (b,H). Returns (state, h).
    Each rounding step is the reference's: C * fw + iw * (k v^T).

    With ``tp``, q, k, C and n hold this rank's slice of the key dim (C's
    rows, as the plan stores them): the sums over it, ``q C`` and ``q n``,
    are all-reduced over the group (one call); ``m`` and h are whole."""
    C, n, m = state
    dh = v.shape[-1]
    qf = q.float() / math.sqrt(dh)
    kf, vf = k.float(), v.float()
    lf = F.logsigmoid(f_logit.float())
    li = i_logit.float()
    m_new = torch.maximum(lf + m, li)
    fw = torch.exp(lf + m - m_new)
    iw = torch.exp(li - m_new)
    kv = kf[..., :, None] * vf[..., None, :]
    C.mul_(fw[..., None, None]).add_(kv.mul_(iw[..., None, None]))
    n.mul_(fw[..., None]).add_(iw[..., None] * kf)
    m.copy_(m_new)
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    qn = torch.einsum("bhd,bhd->bh", qf, n)
    if tp is not None:
        both = reduce_from(torch.cat([num, qn[..., None]], dim=-1), tp)
        num, qn = both[..., :-1], both[..., -1]
    den = torch.maximum(torch.abs(qn), torch.exp(-m_new))
    h = num / den[..., None]
    return (C, n, m), h.to(v.dtype)


# ---------------------------------------------------------------------------
# causal conv (kernel 4) used by both block types
# ---------------------------------------------------------------------------

def causal_conv(x, w, state=None):
    """x: (b,T,D), w: (K,D) depthwise. state: (b,K-1,D) or None.
    Returns (y, new_state)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(K))
    return y, xp[:, -(K - 1):]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _block_diag_apply(x, w):
    """x: (b,t,H,dh) ; w: (H,dh,dh) -> per-head projection."""
    return torch.einsum("bthd,hde->bthe", x, w.to(x.dtype))


def mlstm_block_init(init: L.Init, cfg: ModelConfig):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    H = cfg.num_heads
    dh = di // H
    dt = L.dtype_of(cfg.param_dtype)
    return {"ln": init.zeros((d,), dt, axes=("norm",)),
            "w_up": init.dense((d, 2 * di), dt, axes=("embed", "ssm_inner")),
            "conv": init.dense((4, di), dt, axes=(None, "ssm_inner")),
            "wq": init.dense((H, dh, dh), dt, axes=(None, None, None)),
            "wk": init.dense((H, dh, dh), dt, axes=(None, None, None)),
            "w_if": init.dense((di, 2 * H), dt, scale=0.02,
                               axes=("ssm_inner", None)),
            "b_if": init.const([0.0] * H + [3.0] * H, dt, axes=("norm",)),
            "out_norm": init.zeros((di,), dt, axes=("norm",)),
            "w_down": init.dense((di, d), dt, axes=("ssm_inner", "embed"))}


def mlstm_block_apply(p, x, cfg: ModelConfig, state=None, tp=None):
    """state None for training (chunkwise); for a decode step, the dict of
    C, n, m, conv, updated in place. Returns (x, state).

    With ``tp``, split over the inner channels where ``w_down``'s rows are
    this rank's (else the block runs whole): the rank multiplies its
    channels' columns of u and z (``columns`` re-cuts the packed
    ``w_up``), convolves them, sums its rows' part of the gates (``w_if``
    row-parallel, all-reduced) and ends in the row-parallel ``w_down``.
    The cell: in training and prefill, where the heads divide over the
    group, each rank's channels are its heads: the chunkwise form runs on
    them and the gated norm's mean of squares is all-reduced; where they
    do not, u and the conv's output are gathered and every rank runs the
    whole cell. In decode the cell splits along the key dim, where the
    plan stores C and n (``mlstm_step``): u and the conv's output are
    gathered (one token), and each rank updates its rows of C and n."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    H = cfg.num_heads
    dh = di // H
    bsz, T, _ = x.shape
    tp = split_over(tp, p["w_down"].shape[-2], di)
    cs = share(tp, di)  # this rank's inner channels
    heads = state is None and (tp is None or H % tp.size == 0)
    h = copy_to(L.rms_norm(x, p["ln"], cfg.norm_eps), tp)
    up = h @ columns(p["w_up"], tp, 2 * di,
                     (cs, (di + cs[0], di + cs[1]))).to(h.dtype)
    u, z = up.chunk(2, dim=-1)
    conv_state = None if state is None else state["conv"]
    # conv's channels and w_if's rows are cut as w_down's rows: the rank's
    uc, new_conv = causal_conv(u, p["conv"], conv_state)
    uc = F.silu(uc)
    gates = uc @ p["w_if"].to(uc.dtype)
    if heads:
        gates = sum_over(gates, tp) + copy_to(p["b_if"], tp).to(uc.dtype)
        hs = share(tp, H)  # this rank's heads' gates, (b,T,nh) each
        i_logit, f_logit = (take(t, -1, (hs,)) for t in gates.chunk(2, -1))
        wq, wk = (whole_columns(p[n], tp, (hs,), dim=0)
                  for n in ("wq", "wk"))
        nh = hs[1] - hs[0]
    else:  # the cell whole: every channel's u and conv output
        gates = reduce_from(gates, tp) + p["b_if"].to(uc.dtype)
        i_logit, f_logit = gates.chunk(2, dim=-1)
        if tp is not None:
            u, uc = gather_from(torch.stack([u, uc]), tp, -1).unbind(0)
        wq, wk, nh = p["wq"], p["wk"], H
    uh = uc.reshape(bsz, T, nh, dh)
    v = u.reshape(bsz, T, nh, dh)
    if state is None:
        q = _block_diag_apply(uh, wq)
        k = _block_diag_apply(uh, wk)
        hm = mlstm_chunkwise(q, k, v, i_logit, f_logit, cfg.mlstm_chunk)
    else:
        ktp = split_over(tp, state["C"].shape[-2], dh)
        dk = share(ktp, dh)  # this rank's rows of C
        q = _block_diag_apply(uh, take(wq, -1, (dk,)))
        k = _block_diag_apply(uh, take(wk, -1, (dk,)))
        _, hm = mlstm_step((state["C"], state["n"], state["m"]), q[:, 0],
                           k[:, 0], v[:, 0], i_logit[:, 0], f_logit[:, 0],
                           ktp)
        hm = hm[:, None]
        state["conv"].copy_(new_conv)
    if heads:
        hm = L.rms_norm(hm.reshape(bsz, T, cs[1] - cs[0]),
                        whole_columns(p["out_norm"], tp, (cs,)), cfg.norm_eps,
                        tp)
    else:  # whole on every rank, then this rank's channels
        hm = L.rms_norm(hm.reshape(bsz, T, di), p["out_norm"], cfg.norm_eps)
        hm = take(copy_to(hm, tp), -1, (cs,))
    hm = hm * F.silu(z)
    out = reduce_from(hm @ p["w_down"].to(hm.dtype), tp)
    return x + out, state


def slstm_block_init(init: L.Init, cfg: ModelConfig):
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    dt = L.dtype_of(cfg.param_dtype)
    ffd = _ffn_width(d)
    return {"ln": init.zeros((d,), dt, axes=("norm",)),
            "conv": init.dense((4, d), dt, axes=(None, "embed")),
            "w_gates": init.dense((d, 4 * d), dt,
                                  axes=("embed", "ssm_inner")),
            "r_gates": init.dense((4, H, dh, dh), dt,
                                  scale=1.0 / math.sqrt(dh),
                                  axes=(None, None, None, None)),
            "b_gates": init.const([0.0] * (2 * d) + [3.0] * d + [0.0] * d,
                                  dt, axes=("norm",)),
            "out_norm": init.zeros((d,), dt, axes=("norm",)),
            "ffn": L.mlp_init(init, cfg, ffd),
            "ln_ffn": init.zeros((d,), dt, axes=("norm",))}


def slstm_block_apply(p, x, cfg: ModelConfig, state=None, tp=None):
    """Sequential sLSTM. state None -> the whole sequence (training);
    else one decode step, the dict of c, n, m, h, conv updated in place.

    With ``tp``, split by heads where ``w_gates``' columns are cut over the
    group (else the cell runs whole): the rank multiplies its heads'
    columns of the four gates (``columns`` re-cuts the packed leaf) and
    runs the recurrence on its heads (``r_gates`` is block-diagonal), with
    no collective inside the time loop; its part of the outputs is
    gathered once after it, and in decode its part of the new state,
    which is whole on every rank. The ffn splits as ``mlp_apply``'s."""
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    bsz, T, _ = x.shape
    stp = split_over(tp, p["w_gates"].shape[-1], 4 * d)
    hs, cs = share(stp, H), share(stp, d)  # this rank's heads, channels
    nh, nc = hs[1] - hs[0], cs[1] - cs[0]
    gcols = [(g * d + cs[0], g * d + cs[1]) for g in range(4)]
    h0 = L.rms_norm(x, p["ln"], cfg.norm_eps)
    conv_state = None if state is None else state["conv"]
    hc, new_conv = causal_conv(h0, p["conv"], conv_state)
    hc = copy_to(F.silu(hc), stp)
    wx = hc @ columns(p["w_gates"], stp, 4 * d, gcols).to(hc.dtype) \
        + whole_columns(p["b_gates"], stp, gcols).to(hc.dtype)  # (b,T,4nc)

    r = whole_columns(p["r_gates"], stp, (hs,), dim=1)

    def step(carry, wx_t):
        c, n, m, hprev = carry  # (b,H,dh) x3 ... m: (b,H)
        rh = torch.einsum("bhd,ghde->bghe", hprev, r.to(hprev.dtype))
        rh = rh.reshape(bsz, 4 * nc)
        gates = (wx_t.float() + rh.float()).reshape(bsz, 4, nh, dh)
        z_t = torch.tanh(gates[:, 0])
        i_l = gates[:, 1]
        f_l = gates[:, 2]
        o_t = torch.sigmoid(gates[:, 3])
        lf = F.logsigmoid(f_l)
        # per-head stabiliser (shared scale across the head's cells keeps
        # the c/n pair consistent across steps)
        m_new = torch.amax(torch.maximum(lf + m[..., None], i_l), dim=-1)
        fw = torch.exp(lf + m[..., None] - m_new[..., None])
        iw = torch.exp(i_l - m_new[..., None])
        c_new = fw * c + iw * z_t
        n_new = fw * n + iw
        h_new = o_t * c_new / torch.clamp(n_new, min=1.0)
        return (c_new, n_new, m_new, h_new.to(hprev.dtype)), h_new

    if state is None:
        c0 = torch.zeros((bsz, nh, dh), dtype=torch.float32, device=x.device)
        carry = (c0, c0, torch.full((bsz, nh), -1e30, dtype=torch.float32,
                                    device=x.device),
                 torch.zeros((bsz, nh, dh), dtype=L.dtype_of(cfg.dtype),
                             device=x.device))
        hs_t = []
        for t in range(T):
            carry, h_t = step(carry, wx[:, t])
            hs_t.append(h_t)
        hseq = torch.stack(hs_t, dim=1).reshape(bsz, T, nc).to(x.dtype)
        hseq = gather_from(hseq, stp, -1)
    else:
        carry, h_t = step(tuple(take(state[k], 1, (hs,))
                                for k in ("c", "n", "m", "h")), wx[:, 0])
        c, n, m, _ = carry
        if stp is not None:  # every rank's heads, in one call
            every = gather_from(torch.cat(
                [c, n, h_t, m[..., None]], dim=-1), stp, 1)
            c, n, h_t, m = every.split([dh, dh, dh, 1], dim=-1)
            m = m[..., 0]
        for key, new in zip(("c", "n", "m", "h"), (c, n, m, h_t)):
            state[key].copy_(new.to(state[key].dtype))
        hseq = h_t[:, None].reshape(bsz, 1, d).to(x.dtype)
        state["conv"].copy_(new_conv)
    hseq = L.rms_norm(hseq, p["out_norm"], cfg.norm_eps)
    x = x + hseq
    hf = L.rms_norm(x, p["ln_ffn"], cfg.norm_eps)
    x = x + L.mlp_apply(p["ffn"], hf, tp, _ffn_width(d))
    return x, state


def _ffn_width(d: int) -> int:
    """The sLSTM block's gated FFN width (pf = 4/3, a multiple of 64)."""
    return int(d * 4 / 3 // 64 * 64)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class XLSTMModel:
    """48 blocks = segments of [slstm_every-1 mLSTM + 1 sLSTM]."""

    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        k = cfg.slstm_every or cfg.num_layers
        assert cfg.num_layers % k == 0
        self.n_segments = cfg.num_layers // k
        self.mlstm_per_seg = k - 1
        self.has_slstm = cfg.slstm_every > 0

    # -- params ---------------------------------------------------------
    def init(self, generator: torch.Generator):
        """Random params drawn from ``generator`` (on its own device), then
        moved to the model's device; on ``meta``, shapes and dtypes only.
        mLSTM leaves are (segments, per segment, ...), sLSTM leaves
        (segments, ...), as the reference stacks them."""
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
                  "mlstm": mlstm_block_init(
                      init.stacked(self.n_segments).stacked(
                          self.mlstm_per_seg), cfg)}
        if self.has_slstm:
            params["slstm"] = slstm_block_init(init.stacked(self.n_segments),
                                               cfg)
        return params

    def tp_whole(self, size: int):
        """Rule 1 over a ``model`` group of ``size`` ranks, as a tree like
        the parameters: True for a leaf that runs whole (the step layer
        gathers it over ``model`` where the plan splits it). The sLSTM
        block's leaves but its ffn where the heads do not divide over the
        group (heads are never cut mid-head). The mLSTM blocks always run
        split over their inner channels (``mlstm_block_apply``), and the
        rest as the plan lays it out."""
        heads = self.cfg.num_heads % size != 0

        def walk(tree, path):
            if isinstance(tree, dict):
                return {k: walk(v, path + (k,)) for k, v in tree.items()}
            return heads and path[0] == "slstm" and path[1] != "ffn"

        return walk(self.param_axes(), ())

    # -- forward --------------------------------------------------------
    def forward(self, params, batch, tp=None):
        """-> (logits, aux 0); with ``tp`` (the parameters this rank's
        shards over it), the logits of this rank's vocabulary columns
        where the vocabulary splits."""
        cfg = self.cfg
        x = L.embed_lookup(params["embed"], batch["tokens"], cfg,
                           L.dtype_of(cfg.dtype), tp)

        def seg_body(mp, sp, x):
            for layer_p in unstacked(mp):
                x, _ = mlstm_block_apply(layer_p, x, cfg, tp=tp)
            if self.has_slstm:
                x, _ = slstm_block_apply(sp, x, cfg, tp=tp)
            return x

        body = L.remat(seg_body, "none" if cfg.remat == "none" else "full")
        slstm = unstacked(params["slstm"]) if self.has_slstm \
            else [None] * self.n_segments
        for mp, sp in zip(unstacked(params["mlstm"]), slstm):
            x = body(mp, sp, x)
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
        H = cfg.num_heads
        dh = di // H
        dhs = cfg.d_model // H
        f32, dt = torch.float32, L.dtype_of(cfg.dtype)
        S, M, b = self.n_segments, self.mlstm_per_seg, batch_size

        def spec(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        cache = {"mlstm": {"C": spec((S, M, b, H, dh, dh), f32),
                           "n": spec((S, M, b, H, dh), f32),
                           "m": spec((S, M, b, H), f32),
                           "conv": spec((S, M, b, 3, di), dt)}}
        if self.has_slstm:
            cache["slstm"] = {"c": spec((S, b, H, dhs), f32),
                              "n": spec((S, b, H, dhs), f32),
                              "m": spec((S, b, H), f32),
                              "h": spec((S, b, H, dhs), dt),
                              "conv": spec((S, b, 3, cfg.d_model), dt)}
        return cache

    def cache_axes(self):
        """The logical axes of ``cache_spec``'s leaves (the second half of
        the reference's ``cache_spec``)."""
        lead = ("layers", "layers", "batch")
        ax = {"mlstm": {"C": lead + (None, "ssm_inner", None),
                        "n": lead + (None, "ssm_inner"),
                        "m": lead + (None,),
                        "conv": lead + (None, "ssm_inner")}}
        if self.has_slstm:
            ax["slstm"] = {"c": ("layers", "batch", None, None),
                           "n": ("layers", "batch", None, None),
                           "m": ("layers", "batch", None),
                           "h": ("layers", "batch", None, None),
                           "conv": ("layers", "batch", None, "embed")}
        return ax

    def input_specs(self, shape):
        """``meta`` stand-ins and logical axes for tokens (and targets)."""
        return input_specs(self.cfg, shape)

    def init_cache(self, batch_size: int, max_seq: int):
        cache = _tree.map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                                device=self.device),
                          self.cache_spec(batch_size, max_seq))
        cache["mlstm"]["m"].fill_(-1e30)
        if self.has_slstm:
            cache["slstm"]["m"].fill_(-1e30)
        return cache

    def decode_step(self, params, cache, batch, tp=None):
        """One token: batch = {tokens: (b,1), pos}. Returns (logits,
        cache): the state is updated in place, so the step consumes it.
        With ``tp``, the cache holds this rank's shards of the state
        (``cache_axes``: the mLSTM's C and n by the key dim)."""
        cfg = self.cfg
        x = L.embed_lookup(params["embed"], batch["tokens"], cfg,
                           L.dtype_of(cfg.dtype), tp)
        slstm = zip(unstacked(params["slstm"]), unstacked(cache["slstm"])) \
            if self.has_slstm else [(None, None)] * self.n_segments
        for mp, mc, (sp, sc) in zip(unstacked(params["mlstm"]),
                                    unstacked(cache["mlstm"]), slstm):
            for lp, lc in zip(unstacked(mp), unstacked(mc)):
                x, _ = mlstm_block_apply(lp, x, cfg, state=lc, tp=tp)
            if self.has_slstm:
                x, _ = slstm_block_apply(sp, x, cfg, state=sc, tp=tp)
        return L.lm_logits(params["embed"], x, cfg, tp), cache
