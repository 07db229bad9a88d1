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


def mlstm_step(state, q, k, v, i_logit, f_logit):
    """Recurrent mLSTM step. state=(C,n,m): (b,H,dh,dh),(b,H,dh),(b,H) f32,
    updated in place; q,k,v: (b,H,dh); i,f: (b,H). Returns (state, h).
    Each rounding step is the reference's: C * fw + iw * (k v^T)."""
    C, n, m = state
    dh = q.shape[-1]
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
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qf, n)),
                        torch.exp(-m_new))
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


def mlstm_block_apply(p, x, cfg: ModelConfig, state=None):
    """state None for training (chunkwise); for a decode step, the dict of
    C, n, m, conv, updated in place. Returns (x, state)."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    H = cfg.num_heads
    dh = di // H
    bsz, T, _ = x.shape
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    up = h @ p["w_up"].to(h.dtype)
    u, z = up.chunk(2, dim=-1)
    conv_state = None if state is None else state["conv"]
    uc, new_conv = causal_conv(u, p["conv"], conv_state)
    uc = F.silu(uc)
    uh = uc.reshape(bsz, T, H, dh)
    q = _block_diag_apply(uh, p["wq"])
    k = _block_diag_apply(uh, p["wk"])
    v = u.reshape(bsz, T, H, dh)
    gates = uc @ p["w_if"].to(uc.dtype) + p["b_if"].to(uc.dtype)
    i_logit, f_logit = gates.chunk(2, dim=-1)  # (b,T,H) each
    if state is None:
        hm = mlstm_chunkwise(q, k, v, i_logit, f_logit, cfg.mlstm_chunk)
    else:
        _, hm = mlstm_step((state["C"], state["n"], state["m"]), q[:, 0],
                           k[:, 0], v[:, 0], i_logit[:, 0], f_logit[:, 0])
        hm = hm[:, None]
        state["conv"].copy_(new_conv)
    hm = hm.reshape(bsz, T, di)
    hm = L.rms_norm(hm, p["out_norm"], cfg.norm_eps) * F.silu(z)
    out = hm @ p["w_down"].to(hm.dtype)
    return x + out, state


def slstm_block_init(init: L.Init, cfg: ModelConfig):
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    dt = L.dtype_of(cfg.param_dtype)
    ffd = int(d * 4 / 3 // 64 * 64)
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


def slstm_block_apply(p, x, cfg: ModelConfig, state=None):
    """Sequential sLSTM. state None -> the whole sequence (training);
    else one decode step, the dict of c, n, m, h, conv updated in place."""
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    bsz, T, _ = x.shape
    h0 = L.rms_norm(x, p["ln"], cfg.norm_eps)
    conv_state = None if state is None else state["conv"]
    hc, new_conv = causal_conv(h0, p["conv"], conv_state)
    hc = F.silu(hc)
    wx = hc @ p["w_gates"].to(hc.dtype) + p["b_gates"].to(hc.dtype)  # (b,T,4d)

    r = p["r_gates"]

    def step(carry, wx_t):
        c, n, m, hprev = carry  # (b,H,dh) x3 ... m: (b,H)
        rh = torch.einsum("bhd,ghde->bghe", hprev, r.to(hprev.dtype))
        rh = rh.reshape(bsz, 4 * d)
        gates = (wx_t.float() + rh.float()).reshape(bsz, 4, H, dh)
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
        c0 = torch.zeros((bsz, H, dh), dtype=torch.float32, device=x.device)
        carry = (c0, c0, torch.full((bsz, H), -1e30, dtype=torch.float32,
                                    device=x.device),
                 torch.zeros((bsz, H, dh), dtype=L.dtype_of(cfg.dtype),
                             device=x.device))
        hs = []
        for t in range(T):
            carry, h_t = step(carry, wx[:, t])
            hs.append(h_t)
        hseq = torch.stack(hs, dim=1).reshape(bsz, T, d).to(x.dtype)
    else:
        carry, h_t = step((state["c"], state["n"], state["m"], state["h"]),
                          wx[:, 0])
        hseq = h_t[:, None].reshape(bsz, 1, d).to(x.dtype)
        for key, new in zip(("c", "n", "m", "h"), carry):
            state[key].copy_(new)
        state["conv"].copy_(new_conv)
    hseq = L.rms_norm(hseq, p["out_norm"], cfg.norm_eps)
    x = x + hseq
    hf = L.rms_norm(x, p["ln_ffn"], cfg.norm_eps)
    x = x + L.mlp_apply(p["ffn"], hf)
    return x, state


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

    # -- forward --------------------------------------------------------
    def forward(self, params, batch):
        cfg = self.cfg
        x = L.embed_lookup(params["embed"], batch["tokens"], cfg,
                           L.dtype_of(cfg.dtype))

        def seg_body(mp, sp, x):
            for layer_p in unstacked(mp):
                x, _ = mlstm_block_apply(layer_p, x, cfg)
            if self.has_slstm:
                x, _ = slstm_block_apply(sp, x, cfg)
            return x

        body = L.remat(seg_body, "none" if cfg.remat == "none" else "full")
        slstm = unstacked(params["slstm"]) if self.has_slstm \
            else [None] * self.n_segments
        for mp, sp in zip(unstacked(params["mlstm"]), slstm):
            x = body(mp, sp, x)
        logits = L.lm_logits(params["embed"], x, cfg)
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)

    def loss(self, params, batch):
        logits, _ = self.forward(params, batch)
        ce = L.cross_entropy(logits, batch["targets"])
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

    def decode_step(self, params, cache, batch):
        """One token: batch = {tokens: (b,1), pos}. Returns (logits,
        cache): the state is updated in place, so the step consumes it."""
        cfg = self.cfg
        x = L.embed_lookup(params["embed"], batch["tokens"], cfg,
                           L.dtype_of(cfg.dtype))
        slstm = zip(unstacked(params["slstm"]), unstacked(cache["slstm"])) \
            if self.has_slstm else [(None, None)] * self.n_segments
        for mp, mc, (sp, sc) in zip(unstacked(params["mlstm"]),
                                    unstacked(cache["mlstm"]), slstm):
            for lp, lc in zip(unstacked(mp), unstacked(mc)):
                x, _ = mlstm_block_apply(lp, x, cfg, state=lc)
            if self.has_slstm:
                x, _ = slstm_block_apply(sp, x, cfg, state=sc)
        return L.lm_logits(params["embed"], x, cfg), cache
