"""The LM zoo's recurrent families, xLSTM (ssm) and Zamba2 (hybrid), port
against the JAX reference on the CPU: the chunkwise and recurrent cells,
the causal conv, the models' loss and gradients, their decode state, the
serve loop; and the reference's own check that the recurrent decode form
matches the parallel forward (``tests/test_models_smoke.py:70``).

Both packages start from the reference's initialised parameters and take
the same seeded numpy inputs (``_torch_zoo``, which states the bars).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import _torch_zoo as Z  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro.models import zamba as JZ  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402
from repro_torch.models import zamba as ZB  # noqa: E402

RECURRENT = ["xlstm-1.3b", "zamba2-1.2b"]
# leaves whose gradient is exactly zero: Zamba's per-application
# lora.*_b start at 0, so lora.*_a get none; the shared block's own
# attn.w*_lora_a/_b are never read
ZERO_GRADS = {"zamba2-1.2b": ("['lora']['wq_a']", "['lora']['wk_a']",
                              "['lora']['wv_a']", "_lora_a']", "_lora_b']")}


def _np(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a)
                                              for a in arrays]


# -- the cells ----------------------------------------------------------------

# (T, chunk): four chunks of 8 (the carried state and its stabiliser), and
# 12 positions on chunks of 8 (no division: one chunk)
CHUNKS = {"4 chunks": (32, 8), "one-chunk fallback": (12, 8)}


@pytest.mark.parametrize("T,chunk", list(CHUNKS.values()), ids=list(CHUNKS))
def test_mlstm_chunkwise_matches(T, chunk, rng):
    q, k, v = (rng.normal(size=(2, T, 3, 8)).astype(np.float32)
               for _ in range(3))
    i_l = rng.normal(size=(2, T, 3)).astype(np.float32) * 2
    f_l = rng.normal(size=(2, T, 3)).astype(np.float32) * 2 + 2
    (jq, jk, jv, ji, jf), (tq, tk, tv, ti, tf) = _np(q, k, v, i_l, f_l)
    want = JX.mlstm_chunkwise(jq, jk, jv, ji, jf, chunk)
    got = X.mlstm_chunkwise(tq, tk, tv, ti, tf, chunk)
    Z.close(got, want, Z.LAYER_RTOL)


def test_mlstm_step_matches(rng):
    """Three steps from the -1e30 stabiliser fill; the port's state is
    updated in place."""
    b, H, dh = 2, 3, 8
    jstate = (jnp.zeros((b, H, dh, dh)), jnp.zeros((b, H, dh)),
              jnp.full((b, H), -1e30))
    tstate = (torch.zeros((b, H, dh, dh)), torch.zeros((b, H, dh)),
              torch.full((b, H), -1e30))
    for _ in range(3):
        q, k, v = (rng.normal(size=(b, H, dh)).astype(np.float32)
                   for _ in range(3))
        i_l, f_l = (rng.normal(size=(b, H)).astype(np.float32) * 2
                    for _ in range(2))
        (jq, jk, jv, ji, jf), (tq, tk, tv, ti, tf) = _np(q, k, v, i_l, f_l)
        jstate, want = JX.mlstm_step(jstate, jq, jk, jv, ji, jf)
        got_state, got = X.mlstm_step(tstate, tq, tk, tv, ti, tf)
        assert all(g is t for g, t in zip(got_state, tstate))
        Z.close(got, want, Z.LAYER_RTOL)
        for g, w in zip(tstate, jstate):
            Z.close(g, w, Z.LAYER_RTOL)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero history", "carried state"])
def test_causal_conv_matches(with_state, rng):
    x = rng.normal(size=(2, 5, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    state = rng.normal(size=(2, 3, 6)).astype(np.float32)
    (jx, jw, js), (tx, tw, ts) = _np(x, w, state)
    want, wnew = JX.causal_conv(jx, jw, js if with_state else None)
    got, gnew = X.causal_conv(tx, tw, ts if with_state else None)
    Z.close(got, want, Z.LAYER_RTOL)
    np.testing.assert_array_equal(gnew.numpy(), np.asarray(wnew))


def _ssd_inputs(rng, T):
    b, H, dh, N = 2, 3, 4, 5
    x = rng.normal(size=(b, T, H, dh)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, T, H)))).astype(np.float32)
    A = -np.exp(rng.normal(size=H)).astype(np.float32)
    B, C = (rng.normal(size=(b, T, N)).astype(np.float32) for _ in range(2))
    D = rng.normal(size=H).astype(np.float32)
    return x, dt, A, B, C, D


@pytest.mark.parametrize("T,chunk", list(CHUNKS.values()), ids=list(CHUNKS))
def test_ssd_chunked_matches(T, chunk, rng):
    (jx, jdt, jA, jB, jC, jD), (tx, tdt, tA, tB, tC, tD) = _np(
        *_ssd_inputs(rng, T))
    want = JZ.ssd_chunked(jx, jdt, jA, jB, jC, jD, chunk)
    got = ZB.ssd_chunked(tx, tdt, tA, tB, tC, tD, chunk)
    Z.close(got, want, Z.LAYER_RTOL)


def test_ssd_step_matches(rng):
    x, dt, A, B, C, D = _ssd_inputs(rng, 1)
    S = rng.normal(size=(2, 3, 5, 4)).astype(np.float32)
    (jS, jx, jdt, jA, jB, jC, jD), (tS, tx, tdt, tA, tB, tC, tD) = _np(
        S, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D)
    wS, want = JZ.ssd_step(jS, jx, jdt, jA, jB, jC, jD)
    gS, got = ZB.ssd_step(tS, tx, tdt, tA, tB, tC, tD)
    Z.close(got, want, Z.LAYER_RTOL)
    Z.close(gS, wS, Z.LAYER_RTOL)


def _grads_j(fn, args, w):
    return jax.grad(lambda *a: jnp.sum(fn(*a) * w),
                    argnums=tuple(range(len(args))))(*args)


def _grads_t(fn, args, w):
    args = [a.clone().requires_grad_(True) for a in args]
    return torch.autograd.grad(torch.sum(fn(*args) * w), args)


# Decays steep enough that exp(cum_i - cum_j) over the masked j > i
# overflows f32 (exponents of 128 and more). The reference's
# where(mask, exp(.), 0) then has a gradient of 0 * inf = NaN everywhere
# (it trained zamba2-1.2b to NaN at full width in 5 steps on the H100);
# the port masks before the exp, the same values, finite gradients. The
# gradients are held against the reference's with chunk 1, where no masked
# entry exists, at rtol 1e-4; a gradient the reference gives as exactly 0
# (log f = -100: XLA flushes the subnormal products there, ROADMAP C) is
# held to zero against the largest gradient entry.
def _steep_ssd(rng, T):
    x, dt, A, B, C, D = _ssd_inputs(rng, T)
    return x, np.full_like(dt, 8.0), np.full_like(A, -16.0), B, C, D


def _steep_mlstm(rng, T):
    q, k, v = (rng.normal(size=(2, T, 3, 8)).astype(np.float32)
               for _ in range(3))
    i_l = rng.normal(size=(2, T, 3)).astype(np.float32) * 2
    f_l = np.full((2, T, 3), -100.0, np.float32)  # log f = -100 a step
    return q, k, v, i_l, f_l


@pytest.mark.parametrize("cell", ["ssd_chunked", "mlstm_chunkwise"])
def test_chunked_scan_gradients_finite_at_steep_decay(cell, rng):
    T, chunk = 16, 8
    if cell == "ssd_chunked":
        args, jfn, tfn = _steep_ssd(rng, T), JZ.ssd_chunked, ZB.ssd_chunked
    else:
        args, jfn, tfn = (_steep_mlstm(rng, T), JX.mlstm_chunkwise,
                          X.mlstm_chunkwise)
    jargs, targs = _np(*args)
    w = rng.normal(size=jfn(*jargs, chunk).shape).astype(np.float32)
    Z.close(tfn(*targs, chunk), jfn(*jargs, chunk), Z.LAYER_RTOL)
    ref = _grads_j(lambda *a: jfn(*a, chunk), jargs, jnp.asarray(w))
    assert not all(np.isfinite(np.asarray(g)).all() for g in ref)
    got = _grads_t(lambda *a: tfn(*a, chunk), targs, torch.from_numpy(w))
    want = _grads_j(lambda *a: jfn(*a, 1), jargs, jnp.asarray(w))
    top = max(float(np.abs(np.asarray(wt)).max()) for wt in want)
    for g, wt in zip(got, want):
        assert torch.isfinite(g).all()
        if not np.abs(np.asarray(wt)).max():
            assert float(g.abs().max()) <= Z.ZERO_BAR * top
            continue
        Z.close(g, wt, Z.MODEL_RTOL)


# -- the models ---------------------------------------------------------------

@pytest.mark.parametrize("arch", RECURRENT)
def test_smoke_loss_and_grads_match(arch):
    """f32 smoke config, batch 2 x 16 (two mLSTM / SSD chunks of 8):
    logits, loss and every gradient leaf."""
    jm, jp, tm, tp = Z.pair(arch)
    b = Z.batch(tm.cfg, 1)
    jb, tb = Z.to_jax(b), Z.to_torch(b)
    jlog, _ = jax.jit(jm.forward)(jax.tree.map(jnp.asarray, jp), jb)
    with torch.no_grad():
        tlog, _ = tm.forward(tp, tb)
    Z.close(tlog, jlog, Z.MODEL_RTOL)
    Z.loss_and_grads_match(lambda p: jm.loss(p, jb)[0], jp,
                           lambda p: tm.loss(p, tb)[0], tp,
                           zero=ZERO_GRADS.get(arch, ()))


@pytest.mark.parametrize("arch", RECURRENT)
def test_remat_gradients_equal_none(arch):
    """remat="full" re-runs each segment or group in the backward pass:
    the gradients equal remat="none" bit for bit."""
    _, _, tm, tp = Z.pair(arch)
    b = Z.to_torch(Z.batch(tm.cfg, 6))
    out = []
    for mode in ("none", "full"):
        model = build_model(dataclasses.replace(tm.cfg, remat=mode),
                            device="cpu")
        leaves, treedef = _tree.flatten(tp)
        leaves = [l.clone().requires_grad_(True) for l in leaves]
        loss = model.loss(_tree.unflatten(treedef, leaves), b)[0]
        out.append(torch.autograd.grad(loss, leaves, allow_unused=True,
                                       materialize_grads=True))
    for a, c in zip(*out):
        assert torch.equal(a, c)


@pytest.mark.parametrize("arch", RECURRENT)
def test_bf16_logits_within_bar(arch):
    """The default bf16 smoke config, parameters carried bit for bit:
    forward logits within 5e-2 of the largest |logit|, and 8 decode
    steps' logits too (never greedy tokens: Zamba's argmax disagrees at 6 %
    of positions between bf16 and f32 in the reference alone), and every
    state leaf in the reference's dtype."""
    jm, jp, tm, tp = Z.pair(arch, "bf16")
    b = Z.batch(tm.cfg, 2)
    jlog, _ = jax.jit(jm.forward)(jax.tree.map(jnp.asarray, jp),
                                  Z.to_jax(b))
    with torch.no_grad():
        tlog, _ = tm.forward(tp, Z.to_torch(b))
    Z.within(tlog, jlog, Z.BF16_BAR)
    steps, jcache, tcache = Z.decode_pair(jm, jp, tm, tp, b["tokens"][:, :8],
                                          8)
    for want, got in steps:
        Z.within(got, want, Z.BF16_BAR)
    Z.cache_dtypes_match(jcache, tcache)


# xlstm-1.3b cut to 8 layers (its seven mLSTM blocks and one sLSTM block in
# 8) and d_model 512 (4 heads of 256)
XLSTM_AT_DEPTH = dict(num_layers=8, d_model=512, vocab_size=1024)


def test_xlstm_bf16_decode_at_depth():
    """xlstm-1.3b's default bf16 at 8 layers, 2 requests of 32 tokens (one
    mLSTM chunk, as serving's prompt): forward and the decode logits at
    every position against the reference's from the same parameters,
    within 5e-2 of the largest |logit|, and every decode state leaf in the
    reference's dtype."""
    jc = dataclasses.replace(jget("xlstm-1.3b"), **XLSTM_AT_DEPTH)
    tc = dataclasses.replace(get_config("xlstm-1.3b"), **XLSTM_AT_DEPTH)
    jm, jp, tm, tp = Z.pair_of(jc, tc)
    tokens = np.random.default_rng(7).integers(
        0, tc.vocab_size, (2, 32)).astype(np.int32)
    jlog, _ = jax.jit(jm.forward)(jax.tree.map(jnp.asarray, jp),
                                  {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tlog, _ = tm.forward(tp, {"tokens": torch.from_numpy(tokens)})
    Z.within(tlog, jlog, Z.BF16_BAR)
    steps, jcache, tcache = Z.decode_pair(jm, jp, tm, tp, tokens, 32)
    Z.within(torch.stack([got for _, got in steps], dim=1),
             np.stack([want for want, _ in steps], axis=1), Z.BF16_BAR)
    Z.cache_dtypes_match(jcache, tcache)


@pytest.mark.parametrize("arch", RECURRENT)
def test_decode_steps_match(arch):
    """8 decode steps from fresh state (smax 12), f32: every step's logits
    and the final state (mLSTM C/n/m, sLSTM c/n/m/h, the conv windows,
    the SSM state, the shared attention's KV cache)."""
    jm, jp, tm, tp = Z.pair(arch)
    tokens = np.random.default_rng(4).integers(
        0, tm.cfg.vocab_size, (2, 8)).astype(np.int32)
    steps, jcache, tcache = Z.decode_pair(jm, jp, tm, tp, tokens, 12)
    for want, got in steps:
        Z.close(got, want, Z.MODEL_RTOL)
    Z.caches_match(jcache, tcache, Z.MODEL_RTOL)


@pytest.mark.parametrize("arch", RECURRENT)
def test_serve_tokens_identical(arch):
    """The serve loop in f32, from the same parameters and prompts (4
    requests, prompt 8, gen 8): the same greedy tokens."""
    jm, jp, tm, tp = Z.pair(arch)
    prompts = np.random.default_rng(5).integers(
        0, tm.cfg.vocab_size, (4, 8)).astype(np.int32)
    want = Z.reference_serve(jm, jp, prompts, 8)
    got = serve.generate(tm, tp, torch.from_numpy(prompts), 8)
    np.testing.assert_array_equal(got.tokens.numpy(), want)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_decode_matches_parallel_forward(arch):
    """The port alone, from its own bf16 init: the chunkwise-parallel
    training form equals the recurrent decode form at the reference's bar
    (rtol 0.15, atol 0.15: bf16 noise), and in f32 at 1e-4 of the largest
    logit."""
    for precision, check in (("bf16", lambda g, w: np.testing.assert_allclose(
            Z.as_f32(g), Z.as_f32(w), rtol=0.15, atol=0.15)),
            ("f32", lambda g, w: Z.within(g, w, Z.MODEL_RTOL))):
        cfg = smoke_config(arch)
        if precision == "f32":
            cfg = Z.f32(cfg)
        model = build_model(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(2))
        tokens = torch.randint(0, cfg.vocab_size, (1, 8),
                               generator=torch.Generator().manual_seed(2))
        with torch.no_grad():
            full, _ = model.forward(params, {"tokens": tokens})
        cache = model.init_cache(1, 8)
        outs = []
        with torch.inference_mode():
            for pos in range(8):
                logits, cache = model.decode_step(
                    params, cache, {"tokens": tokens[:, pos:pos + 1],
                                    "pos": pos})
                outs.append(logits.reshape(1, -1))
        check(torch.stack(outs, dim=1), full)
