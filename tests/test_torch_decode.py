"""The LM zoo's transformer families (dense, MoE, audio, VLM), their decode
caches, the registry and the serve loop, port against the JAX reference on
the CPU.

Both packages start from the reference's initialised parameters and take
the same seeded numpy inputs (``_torch_zoo``, which states the bars).
The reference's own checks from ``tests/test_models_smoke.py`` are held
on the port too: causality, the block-causal schedule against the full
mask, and the applicability matrix.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import _torch_zoo as Z  # noqa: E402
from repro.configs import ARCH_ORDER as JARCH_ORDER  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.models import active_param_count as jactive  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import param_count as jcount  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.configs import (ARCH_ORDER, SHAPES, applicability,  # noqa: E402
                                 get_config, smoke_config)
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (active_param_count, build_model,  # noqa: E402
                                model_flops_per_token, param_count)
from repro_torch.models import layers as L  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TRANSFORMERS = [a for a in ARCH_ORDER
                if get_config(a).family in ("dense", "moe", "audio", "vlm")]
CAUSAL = [a for a in TRANSFORMERS if get_config(a).causal]
# leaves whose gradient is exactly zero: the VLM's xgate starts at 0, so
# no gradient reaches the cross-attention's weights
ZERO_GRADS = {"llama-3.2-vision-11b": ("['xattn']",)}


def _cfg(cls, **kw):
    base = dict(name="tiny", family="dense", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=32, vocab_size=97,
                head_dim=16, qk_norm=True, dtype="float32",
                param_dtype="float32", remat="none", attn_chunk=16)
    return cls(**{**base, **kw})


def _attn_params(rng, cfg, lora_rank=0):
    d, hd = cfg.d_model, cfg.head_dim
    p = {"wq": rng.normal(size=(d, cfg.num_heads * hd)) / 8,
         "wk": rng.normal(size=(d, cfg.num_kv_heads * hd)) / 8,
         "wv": rng.normal(size=(d, cfg.num_kv_heads * hd)) / 8,
         "wo": rng.normal(size=(cfg.num_heads * hd, d)) / 8,
         "q_norm": rng.normal(size=hd) / 10,
         "k_norm": rng.normal(size=hd) / 10}
    for nm in ("wq", "wk", "wv") if lora_rank else ():
        p[f"{nm}_lora_a"] = rng.normal(size=(d, lora_rank)) / 8
        p[f"{nm}_lora_b"] = rng.normal(
            size=(lora_rank, p[nm].shape[1])) / 8
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


# -- the layer functions ----------------------------------------------------

@pytest.mark.parametrize("cache_len", [1, 5, 12])
def test_decode_attention_matches(cache_len, rng):
    """GQA g = 2 against a 12-slot cache; slots at and past cache_len hold
    values the mask must hide."""
    q = rng.normal(size=(2, 1, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 12, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 12, 2, 8)).astype(np.float32)
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), cache_len)
    got = L.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), cache_len)
    Z.close(got, want, Z.LAYER_RTOL)


@pytest.mark.parametrize("pos", [0, 6, 11])
def test_attn_decode_writes_cache_at_pos(pos, rng):
    cfg, jcfg = _cfg(ModelConfig), _cfg(JModelConfig)
    jp, tp = _both(_attn_params(rng, cfg))
    x = rng.normal(size=(2, 1, 64)).astype(np.float32)
    cache = {n: rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
             for n in ("k", "v")}
    want, wcache = JL.attn_decode(jp, jnp.asarray(x),
                                  {n: jnp.asarray(c) for n, c in cache.items()},
                                  jcfg, pos=jnp.int32(pos))
    tcache = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
    got, gcache = L.attn_decode(tp, torch.from_numpy(x), tcache, cfg,
                                pos=pos)
    assert gcache is tcache  # written in place
    Z.close(got, want, Z.LAYER_RTOL)
    for n in ("k", "v"):
        Z.close(gcache[n], wcache[n], Z.LAYER_RTOL)
        rest = np.delete(np.arange(12), pos)
        np.testing.assert_array_equal(gcache[n].numpy()[:, rest],
                                      cache[n][:, rest])


@pytest.mark.parametrize("lora", [False, True], ids=["plain", "lora"])
def test_attn_prefill_matches(lora, rng):
    """Causal chunks of 16 over 32 positions, the kv padded to 40 slots;
    with LoRA through a scope that takes one application's slice."""
    cfg, jcfg = _cfg(ModelConfig), _cfg(JModelConfig)
    p = _attn_params(rng, cfg, lora_rank=4 if lora else 0)
    p = {k: (np.stack([v, 2 * v]) if "lora" in k else v)
         for k, v in p.items()}
    jp, tp = _both(p)
    x = rng.normal(size=(2, 32, 64)).astype(np.float32)
    pos = np.arange(32, dtype=np.int32)
    scope = (lambda a: a[1]) if lora else None
    want, (wk, wv) = JL.attn_prefill(jp, jnp.asarray(x), jcfg,
                                     positions=jnp.asarray(pos), smax=40,
                                     lora_scope=scope)
    got, (gk, gv) = L.attn_prefill(tp, torch.from_numpy(x), cfg,
                                   positions=torch.from_numpy(pos), smax=40,
                                   lora_scope=scope)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        Z.close(g, w, Z.LAYER_RTOL)


def test_lora_proj_qkv_matches(rng):
    cfg, jcfg = _cfg(ModelConfig), _cfg(JModelConfig)
    jp, tp = _both(_attn_params(rng, cfg, lora_rank=4))
    x = rng.normal(size=(2, 8, 64)).astype(np.float32)
    want = JL._proj_qkv(jp, jnp.asarray(x), jcfg, lambda a: a * 1.5)
    got = L._proj_qkv(tp, torch.from_numpy(x), cfg, lambda a: a * 1.5)
    plain = L._proj_qkv(tp, torch.from_numpy(x), cfg)
    for g, w, p in zip(got, want, plain):
        Z.close(g, w, Z.LAYER_RTOL)
        assert not torch.allclose(g, p)  # the LoRA term is there


@pytest.mark.parametrize("n_img", [8, 40])
def test_cross_attn_apply_matches(n_img, rng):
    """Onto 8 image tokens (one block) and 40 (no chunk of 16 divides it:
    the one-block fallback)."""
    cfg, jcfg = _cfg(ModelConfig), _cfg(JModelConfig)
    jp, tp = _both(_attn_params(rng, cfg))
    x = rng.normal(size=(2, 32, 64)).astype(np.float32)
    img = rng.normal(size=(2, n_img, 64)).astype(np.float32)
    want = JL.cross_attn_apply(jp, jnp.asarray(x), jnp.asarray(img), jcfg)
    got = L.cross_attn_apply(tp, torch.from_numpy(x), torch.from_numpy(img),
                             cfg)
    Z.close(got, want, Z.LAYER_RTOL)


# (tokens b x s, group size, experts, k, shared experts): the decode
# shape at smoke size (T = 2, cap 1: tokens dropped), two groups, and the
# llama4-style single expert with a shared one
MOE_CASES = {"decode, cap 1": ((2, 1), 64, 4, 2, 0),
             "two groups of 16": ((4, 8), 16, 4, 2, 0),
             "top-1 + shared expert": ((2, 16), 64, 8, 1, 1)}


@pytest.mark.parametrize("bs,group,E,k,shared", list(MOE_CASES.values()),
                         ids=list(MOE_CASES))
def test_moe_apply_matches(bs, group, E, k, shared, rng):
    kw = dict(num_experts=E, experts_per_token=k, num_shared_experts=shared,
              family="moe")
    cfg, jcfg = _cfg(ModelConfig, **kw), _cfg(JModelConfig, **kw)
    d, ff = 64, 32
    p = {"router": rng.normal(size=(d, E)),
         "w_gate": rng.normal(size=(E, d, ff)) / 8,
         "w_up": rng.normal(size=(E, d, ff)) / 8,
         "w_down": rng.normal(size=(E, ff, d)) / 6}
    p = {n: v.astype(np.float32) for n, v in p.items()}
    if shared:
        p["shared"] = {n: (rng.normal(size=s) / 8).astype(np.float32)
                       for n, s in (("w_gate", (d, ff)), ("w_up", (d, ff)),
                                    ("w_down", (ff, d)))}
    x = rng.normal(size=bs + (d,)).astype(np.float32)
    want, waux = JL.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              jcfg, group_size=group)
    got, gaux = L.moe_apply(_tree.map(torch.from_numpy, p),
                            torch.from_numpy(x), cfg, group_size=group)
    Z.close(got, want, Z.LAYER_RTOL)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=Z.LAYER_RTOL)


def test_moe_top_k_ties_go_to_the_lower_expert():
    """Equal router logits: ``jax.lax.top_k`` picks the lower experts, and
    with cap 1 which token keeps a slot follows the reference's cumsum."""
    kw = dict(num_experts=4, experts_per_token=2, family="moe")
    cfg, jcfg = _cfg(ModelConfig, **kw), _cfg(JModelConfig, **kw)
    d = 64
    rng = np.random.default_rng(3)
    p = {"router": np.zeros((d, 4), np.float32),
         "w_gate": rng.normal(size=(4, d, 32)).astype(np.float32) / 8,
         "w_up": rng.normal(size=(4, d, 32)).astype(np.float32) / 8,
         "w_down": rng.normal(size=(4, 32, d)).astype(np.float32) / 6}
    x = rng.normal(size=(3, 1, d)).astype(np.float32)
    want, _ = JL.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           jcfg)
    got, _ = L.moe_apply(_tree.map(torch.from_numpy, p),
                         torch.from_numpy(x), cfg)
    Z.close(got, want, Z.LAYER_RTOL)
    # token 0 takes experts 0 and 1; cap = max(int(3 * 2 * 1.25 / 4), 1) = 1,
    # so tokens 1 and 2 are dropped: only the first row is non-zero
    assert np.abs(np.asarray(want)[1:]).max() == 0.0
    assert np.abs(np.asarray(want)[0]).max() > 0.0


# -- the models: forward, loss and gradients -------------------------------

@pytest.mark.parametrize("arch", TRANSFORMERS)
def test_smoke_loss_and_grads_match(arch):
    """f32 smoke config, batch 2 x 16: loss (with the MoE aux), logits and
    every gradient leaf."""
    jm, jp, tm, tp = Z.pair(arch)
    b = Z.batch(tm.cfg, 1)
    jb, tb = Z.to_jax(b), Z.to_torch(b)
    (jlog, jaux) = jax.jit(jm.forward)(jax.tree.map(jnp.asarray, jp), jb)
    with torch.no_grad():
        tlog, taux = tm.forward(tp, tb)
    assert tuple(tlog.shape) == (2, 16, tm.cfg.vocab_size)
    Z.close(tlog, jlog, Z.MODEL_RTOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=Z.MODEL_RTOL,
                               atol=1e-7)
    if tm.cfg.num_experts:
        assert float(taux) > 0
    Z.loss_and_grads_match(lambda p: jm.loss(p, jb)[0], jp,
                           lambda p: tm.loss(p, tb)[0], tp,
                           zero=ZERO_GRADS.get(arch, ()))


@pytest.mark.parametrize("arch", TRANSFORMERS)
def test_bf16_logits_within_bar(arch):
    """The default bf16 smoke config, parameters carried bit for bit:
    forward logits, and for a causal arch 4 decode steps' logits, within
    5e-2 of the largest |logit| (never greedy tokens: in bf16 an argmax
    can flip), and the caches' leaves in the reference's dtypes."""
    jm, jp, tm, tp = Z.pair(arch, "bf16")
    assert all(l.dtype == torch.bfloat16 for l in _tree.leaves(tp))
    b = Z.batch(tm.cfg, 2)
    jlog, _ = jax.jit(jm.forward)(jax.tree.map(jnp.asarray, jp),
                                  Z.to_jax(b))
    with torch.no_grad():
        tlog, _ = tm.forward(tp, Z.to_torch(b))
    assert tlog.dtype == torch.bfloat16
    Z.within(tlog, jlog, Z.BF16_BAR)
    if tm.cfg.causal:  # and 4 decode steps' logits and the caches' dtypes
        steps, jcache, tcache = Z.decode_pair(jm, jp, tm, tp,
                                              b["tokens"][:, :4], 8)
        for want, got in steps:
            Z.within(got, want, Z.BF16_BAR)
        Z.cache_dtypes_match(jcache, tcache)


@pytest.mark.parametrize("arch", CAUSAL)
def test_decode_steps_match(arch):
    """8 decode steps from fresh caches (smax 12), f32: every step's logits
    and the final caches, the KV cache written at each position."""
    jm, jp, tm, tp = Z.pair(arch)
    tokens = np.random.default_rng(4).integers(
        0, tm.cfg.vocab_size, (2, 8)).astype(np.int32)
    steps, jcache, tcache = Z.decode_pair(jm, jp, tm, tp, tokens, 12)
    for want, got in steps:
        assert tuple(got.shape) == want.shape
        Z.close(got, want, Z.MODEL_RTOL)
    Z.caches_match(jcache, tcache, Z.MODEL_RTOL)


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-moe-1b-a400m"])
def test_serve_tokens_identical(arch):
    """The serve loop in f32, from the same parameters and prompts (4
    requests, prompt 8, gen 8): the same greedy tokens."""
    jm, jp, tm, tp = Z.pair(arch)
    prompts = np.random.default_rng(5).integers(
        0, tm.cfg.vocab_size, (4, 8)).astype(np.int32)
    want = Z.reference_serve(jm, jp, prompts, 8)
    got = serve.generate(tm, tp, torch.from_numpy(prompts), 8)
    np.testing.assert_array_equal(got.tokens.numpy(), want)
    assert got.prompt_logits.shape == (4, 8, tm.cfg.vocab_size)


# -- options ----------------------------------------------------------------

@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_changes_no_value(remat):
    """remat re-runs the layer bodies in the backward pass: loss and
    gradients equal remat="none" bit for bit (MoE, so both ``mm`` and
    ``bmm`` outputs are met)."""
    _, _, tm, tp = Z.pair("granite-moe-1b-a400m")
    b = Z.to_torch(Z.batch(tm.cfg, 6))
    out = []
    for mode in ("none", remat):
        model = build_model(dataclasses.replace(tm.cfg, remat=mode),
                            device="cpu")
        leaves, treedef = _tree.flatten(tp)
        leaves = [l.clone().requires_grad_(True) for l in leaves]
        loss = model.loss(_tree.unflatten(treedef, leaves), b)[0]
        out.append([loss] + list(torch.autograd.grad(loss, leaves)))
    for a, c in zip(*out):
        assert torch.equal(a, c)


# -- the reference's own model checks, on the port --------------------------

def test_causal_attention_is_causal():
    cfg = smoke_config("qwen3-8b")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(3))
    t1 = torch.randint(0, cfg.vocab_size, (1, 16),
                       generator=torch.Generator().manual_seed(3))
    t2 = t1.clone()
    t2[:, -1] = (t1[:, -1] + 5) % cfg.vocab_size
    with torch.no_grad():
        l1, _ = model.forward(params, {"tokens": t1})
        l2, _ = model.forward(params, {"tokens": t2})
    # changing the last token must not change logits at earlier positions
    np.testing.assert_allclose(l1[:, :-1].float().numpy(),
                               l2[:, :-1].float().numpy(), rtol=1e-2,
                               atol=1e-2)
    assert not torch.equal(l1[:, -1], l2[:, -1])


def test_block_causal_matches_full_mask():
    cfg = smoke_config("qwen3-8b")
    m1 = build_model(dataclasses.replace(cfg, block_causal=True), device="cpu")
    m2 = build_model(dataclasses.replace(cfg, block_causal=False),
                     device="cpu")
    params = m1.init(torch.Generator().manual_seed(4))
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        l1, _ = m1.forward(params, {"tokens": tokens})
        l2, _ = m2.forward(params, {"tokens": tokens})
    np.testing.assert_allclose(l1.float().numpy(), l2.float().numpy(),
                               rtol=2e-2, atol=2e-2)


def test_applicability_matrix_counts():
    runnable = skipped = 0
    for arch in ARCH_ORDER:
        for s in SHAPES.values():
            ok, reason = applicability(get_config(arch), s)
            runnable += ok
            skipped += not ok
            if not ok:
                assert reason
    assert (runnable, skipped) == (31, 9)


# -- registry ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_ORDER)
def test_configs_are_the_reference_s(arch):
    """The arch list, and every field of each full and smoke config, as
    the reference writes them."""
    assert ARCH_ORDER == JARCH_ORDER
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget(arch))
    assert dataclasses.asdict(smoke_config(arch)) == \
        dataclasses.asdict(jsmoke(arch))


@pytest.mark.parametrize("arch", ARCH_ORDER)
def test_param_counts_match_reference(arch):
    """Port on ``meta``, reference through ``eval_shape``: the full
    configs' parameter and active-parameter counts, nothing allocated."""
    cfg, jcfg = get_config(arch), jget(arch)
    assert param_count(cfg) == jcount(jcfg) == cfg.param_count()
    assert active_param_count(cfg) == jactive(jcfg)
    assert model_flops_per_token(cfg) == 6.0 * jactive(jcfg)


def test_build_model_runs_on_the_card_by_default():
    """With no device named the models go to the card; without one they
    raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for arch in ("qwen3-8b", "xlstm-1.3b", "zamba2-1.2b"):
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(smoke_config(arch))


# -- launch/serve.py --------------------------------------------------------

def _serve(*args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)


def test_serve_cli_on_cpu():
    run = _serve("--arch", "qwen3-8b", "--device", "cpu")
    assert run.returncode == 0, run.stderr
    assert "[serve] 8 reqs: prefill(32 tok)" in run.stdout
    assert "decode 16 tok" in run.stdout


def test_serve_cli_encoder_only_returns_early(capsys):
    assert serve.main(["--arch", "hubert-xlarge"]) == 0
    assert "encoder-only; no decode loop" in capsys.readouterr().out


def test_serve_cli_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    run = _serve("--arch", "qwen3-8b")
    assert run.returncode != 0
    assert "RuntimeError" in run.stderr and "CUDA" in run.stderr
