"""The port's dense transformer core, ViT and DistilBERT against the JAX
reference, on the CPU.

Both packages start from the reference's own initial parameters
(``jax.random`` streams cannot be reproduced in torch), carried into the
port's trees by ``params_from_jax(like=...)``, and take the same seeded
numpy inputs. Bars: the layer functions at rtol 1e-5; the models' loss
and every gradient leaf at rtol 1e-4 (ROADMAP "Parity bars"), each leaf
with an atol of 1e-4 of its largest entry, where two f32 matmuls summed
in another order differ in the last bits near zero. The full-width trees
are compared by structure only: the reference's through
``jax.eval_shape``, the port's on the ``meta`` device, so neither
allocates 1.2 GB.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.compression.stages import QsgdCodec as JQsgdCodec  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.core.message import TensorPayload as JPayload  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.bert import BertConfig as JBertConfig  # noqa: E402
from repro.models.bert import DistilBert as JDistilBert  # noqa: E402
from repro.models.transformer import TransformerLM as JTransformerLM  # noqa: E402
from repro.models.vision import ViT as JViT  # noqa: E402
from repro.models.vision import ViTConfig as JViTConfig  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.compression.stages import QsgdCodec  # noqa: E402
from repro_torch.configs.base import FLConfig, ModelConfig  # noqa: E402
from repro_torch.configs.paper_tiers import build_tier_model  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.message import TensorPayload  # noqa: E402
from repro_torch.data import make_silo_datasets  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import fl_train  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.bert import BertConfig, DistilBert  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.models.vision import ViT, ViTConfig  # noqa: E402

LAYER_RTOL = 1e-5
MODEL_RTOL = 1e-4


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


# -- the layer functions ----------------------------------------------------

def test_rms_norm_matches(rng):
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32) * 3
    scale = rng.normal(size=16).astype(np.float32) * 0.1
    want = JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)
    got = L.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    _close(got.numpy(), want, LAYER_RTOL)


@pytest.mark.parametrize("theta", [10_000.0, 500.0])
def test_apply_rope_matches(theta, rng):
    """Rotates the two halves of head_dim, at positions 0..63 and at
    per-example positions."""
    x = rng.normal(size=(2, 64, 4, 16)).astype(np.float32)
    for pos in (np.arange(64, dtype=np.int32),
                rng.integers(0, 4096, size=(2, 64)).astype(np.int32)):
        want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        _close(got.numpy(), want, LAYER_RTOL)


# (causal, block_causal, kv_valid_len, seq): chunks of 16 on 64 positions
# run 4 x 4 blocks and their merges; 60 does not divide by 16 and falls
# back to one block
FLASH_CASES = {"causal, block schedule": (True, True, None, 64),
               "causal, every block": (True, False, None, 64),
               "bidirectional": (False, True, None, 64),
               "kv_valid_len": (False, True, 40, 64),
               "causal + kv_valid_len": (True, False, 40, 64),
               "one-block fallback": (True, True, None, 60)}


@pytest.mark.parametrize("causal,block_causal,kv_valid_len,seq",
                         list(FLASH_CASES.values()), ids=list(FLASH_CASES))
def test_flash_attention_matches(causal, block_causal, kv_valid_len, seq,
                                 rng):
    """GQA with g = 2 (4 query heads over 2 kv heads)."""
    q = rng.normal(size=(2, seq, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, seq, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, seq, 2, 8)).astype(np.float32)
    kw = dict(causal=causal, q_chunk=16, kv_chunk=16,
              kv_valid_len=kv_valid_len, block_causal=block_causal)
    want = JL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              **kw)
    got = L.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), **kw)
    assert tuple(got.shape) == want.shape
    _close(got.numpy(), want, LAYER_RTOL)


# -- the models: loss and gradients ------------------------------------------

def _loss_and_grads_match(jloss, jparams, tloss, tparams, zero=()):
    """Loss and every gradient leaf, reference against port, from the same
    parameters (``tparams`` converted from ``jparams``). The leaves whose
    path ends in one of ``zero`` have a gradient of exactly zero, and f32
    gives rounding noise there: both packages' are held to zero, within
    1e-6 of the model's largest gradient entry."""
    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, jparams))
    leaves, treedef = _tree.flatten(tparams)
    leaves = [l.clone().requires_grad_(True) for l in leaves]
    tl = tloss(_tree.unflatten(treedef, leaves))
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=MODEL_RTOL)
    paths = [jax.tree_util.keystr(path) for path, _ in
             jax.tree_util.tree_flatten_with_path(jg)[0]]
    jleaves = [np.asarray(w) for w in jax.tree.leaves(jg)]
    assert len(jleaves) == len(tg) == len(paths)
    top = max(float(np.abs(w).max()) for w in jleaves)
    for path, g, w in zip(paths, tg, jleaves):
        if path.endswith(tuple(zero)):
            assert float(np.abs(w).max()) <= 1e-6 * top, path
            assert float(g.abs().max()) <= 1e-6 * top, path
            continue
        _close(g.numpy(), w, MODEL_RTOL)


def _lm_config(cls, tied: bool):
    return cls(name="tiny-dense", family="dense", num_layers=2, d_model=64,
               num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=97,
               qk_norm=True, dtype="float32", param_dtype="float32",
               remat="none", attn_chunk=16, tie_embeddings=tied)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_dense_transformer_loss_and_grads_match(tied, rng):
    """2 layers, d 64, 4 heads over 2 kv heads, qk_norm, causal, chunks of
    16 on 32 positions (the block schedule and its merges)."""
    jm = JTransformerLM(_lm_config(JModelConfig, tied))
    tm = TransformerLM(_lm_config(ModelConfig, tied), device="cpu")
    jp, _ = jm.init(jax.random.key(11))
    jp = jax.tree.map(np.array, jp)
    tp = params_from_jax(jp, "cpu",
                         like=tm.init(torch.Generator().manual_seed(0)))
    assert ("lm_head" in tp["embed"]) is not tied
    tokens = rng.integers(0, 97, size=(2, 32)).astype(np.int32)
    targets = rng.integers(0, 97, size=(2, 32)).astype(np.int32)

    def jloss(p):
        return jm.loss(p, {"tokens": jnp.asarray(tokens),
                           "targets": jnp.asarray(targets)})[0]

    def tloss(p):
        return tm.loss(p, {"tokens": torch.from_numpy(tokens),
                           "targets": torch.from_numpy(targets)})[0]

    _loss_and_grads_match(jloss, jp, tloss, tp)


# (ViTConfig overrides, image size): on the silos' 16x16 images with patch
# 16 there is one patch, broadcast by ``+ pos`` to image_size's positions
VIT_CASES = {"one patch broadcast to 16 positions": (dict(patch=16,
                                                          image_size=64), 16),
             "16 patches": (dict(patch=4, image_size=16), 16)}


def _vit_config(cls, overrides):
    return cls(num_layers=2, d_model=64, num_heads=4, d_ff=128,
               num_classes=8, **overrides)


def _silo_batch(n, size):
    silo = make_silo_datasets(1, examples_per_silo=64, num_classes=8,
                              image_size=size, seed=5)[0]
    return next(silo.batches(n, seed=1))


@pytest.mark.parametrize("overrides,size", list(VIT_CASES.values()),
                         ids=list(VIT_CASES))
def test_vit_loss_and_grads_match(overrides, size):
    jm = JViT(_vit_config(JViTConfig, overrides))
    tm = ViT(_vit_config(ViTConfig, overrides), device="cpu")
    jp = jax.tree.map(np.array, jm.init(jax.random.key(12)))
    tp = params_from_jax(jp, "cpu",
                         like=tm.init(torch.Generator().manual_seed(0)))
    b = _silo_batch(4, size)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    assert tm._patchify(tb["images"]).shape[1] == \
        (size // overrides["patch"]) ** 2
    _loss_and_grads_match(lambda p: jm.loss(p, jb)[0], jp,
                          lambda p: tm.loss(p, tb)[0], tp)


def _bert_config(cls):
    return cls(num_layers=2, d_model=64, num_heads=4, d_ff=128,
               vocab_size=101, max_pos=512, num_classes=5)


def test_distilbert_loss_and_grads_match(rng):
    """Batch 2 at sequence 512: ``flash_attention``'s chunks of 256 run
    2 x 2 blocks and their merge. The head is its own tree, carried and
    differentiated beside the body. The key projections' biases add, per
    query, one constant to every score, which the softmax removes: their
    gradient is zero."""
    jm = JDistilBert(_bert_config(JBertConfig))
    tm = DistilBert(_bert_config(BertConfig), device="cpu")
    jp = jax.tree.map(np.array, jm.init(jax.random.key(13)))
    jh = jax.tree.map(np.array, jm.init_head(jax.random.key(14)))
    g = torch.Generator().manual_seed(0)
    tp = params_from_jax(jp, "cpu", like=tm.init(g))
    th = params_from_jax(jh, "cpu", like=tm.init_head(g))
    tokens = rng.integers(0, 101, size=(2, 512)).astype(np.int32)
    labels = rng.integers(0, 5, size=2).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens),
          "labels": torch.from_numpy(labels)}
    _loss_and_grads_match(lambda ph: jm.loss(ph[0], ph[1], jb)[0], (jp, jh),
                          lambda ph: tm.loss(ph[0], ph[1], tb)[0], (tp, th),
                          zero=("['k']['b']",))


# -- the Large tier's update path on a reduced ViT ----------------------------

@functools.lru_cache(maxsize=None)
def _reduced_vit_trees(n=3):
    """n reference ViT trees (seeded inits), as numpy arrays."""
    jm = JViT(_vit_config(JViTConfig, VIT_CASES[next(iter(VIT_CASES))][0]))
    return [jax.tree.map(np.array, jm.init(jax.random.key(20 + i)))
            for i in range(n)]


def test_vit_trees_fedavg_like_the_reference():
    """FedAvg of stacked-layer trees (``seg0.b0_self.*``) through the
    port's tree form, against the reference's Pallas reduction (interpret
    mode) at its bars."""
    trees = _reduced_vit_trees()
    weights = [64.0, 16.0, 48.0]
    got = ops.fedavg_aggregate([params_from_jax(t, "cpu") for t in trees],
                               weights)
    want = jops.fedavg_aggregate([jax.tree.map(jnp.asarray, t)
                                  for t in trees], weights, interpret=True)
    for g, w in zip(_tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_vit_update_qsgd_wire_like_the_reference():
    """One ViT update through the qsgd codec (block 256): the int8 rows
    byte for byte and the scales within 1 ULP of the reference's."""
    tree = _reduced_vit_trees()[0]
    (jp, _, jinfo), = JQsgdCodec(256).encode_batch(
        [JPayload(jax.tree.map(jnp.asarray, tree))], [None])
    (tp, _, tinfo), = QsgdCodec(256).encode_batch(
        [TensorPayload(params_from_jax(tree, "cpu"))], [None])
    assert tinfo["orig_nbytes"] == jinfo["orig_nbytes"]
    assert np.asarray(tp.packed["q"]).tobytes() == \
        np.asarray(jp.packed["q"]).tobytes()
    np.testing.assert_array_max_ulp(np.asarray(tp.packed["scales"]),
                                    np.asarray(jp.packed["scales"]), 1)


# -- full width: structure and counts -----------------------------------------

def _paths(tree, prefix=""):
    """[(path, shape, dtype name)] in ``jax.tree.flatten`` order, paths
    written as ``jax.tree_util.keystr`` writes them."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [p for i, c in enumerate(tree)
                for p in _paths(c, f"{prefix}[{i}]")]
    return [(prefix, tuple(tree.shape), str(tree.dtype).replace("torch.",
                                                                ""))]


def _ref_paths(shapes):
    return [(jax.tree_util.keystr(path), tuple(s.shape), str(s.dtype))
            for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]]


# tier -> (reference model, port model, parameters, leaves)
FULL = {"large": (lambda: JViT(JViTConfig()),
                  lambda: ViT(ViTConfig(), device="meta"),
                  303_236_096, 13),
        "big": (lambda: JDistilBert(JBertConfig()),
                lambda: DistilBert(BertConfig(), device="meta"),
                66_362_880, 100)}


@pytest.mark.parametrize("tier", list(FULL))
def test_full_width_tree_matches_reference(tier):
    """ViT-Large: 303,236,096 parameters in 13 stacked leaves; DistilBERT:
    66,362,880 in 100 (its 20-class head apart). Same paths, shapes and
    dtypes, in the same order, as the reference's; nothing allocated."""
    make_ref, make_port, count, n_leaves = FULL[tier]
    ref = _ref_paths(jax.eval_shape(make_ref().init, jax.random.key(0)))
    model = make_port()
    tree = model.init(None)
    assert all(l.is_meta for l in _tree.leaves(tree))
    assert _paths(tree) == ref
    assert len(ref) == n_leaves
    assert sum(int(np.prod(s)) for _, s, _ in ref) == count
    if tier == "big":
        jhead = jax.eval_shape(make_ref().init_head, jax.random.key(0))
        assert _paths(model.init_head(None)) == _ref_paths(jhead)
    else:
        assert tree["tf"]["seg0"]["b0_self"]["mlp"]["w_up"].shape == \
            (24, 1024, 4096)


@pytest.mark.parametrize("tier", ["big", "large"])
def test_tier_model_on_meta_is_the_tiers_model(tier):
    model, init = build_tier_model(tier, device="meta")
    want = {"big": (DistilBert, BertConfig()), "large": (ViT, ViTConfig())}
    assert isinstance(model, want[tier][0]) and model.cfg == want[tier][1]
    assert len(_tree.leaves(init(None))) == FULL[tier][3]


def test_live_large_deployment_builds_full_width_vit():
    """``build_deployment(tier="large", reduced=False)`` deploys the
    full-width ViT-Large, as the reference's live path does (on ``meta``
    here: nothing is drawn)."""
    server, params, _, _ = fl_train.build_deployment(
        FLConfig(num_clients=2), tier="large", reduced=False,
        local_steps=1, device="meta")
    assert isinstance(server.model, ViT) and server.model.cfg == ViTConfig()
    assert sum(l.numel() for l in _tree.leaves(params)) == 303_236_096


def test_live_big_deployment_raises():
    """The reference's live path cannot train DistilBERT (its loss takes
    a head the training step never passes; the silos hold images), so the
    port refuses it by name; the CLI builds the reduced model, as the
    reference's does."""
    with pytest.raises(NotImplementedError, match="head"):
        fl_train.build_deployment(FLConfig(num_clients=2), tier="big",
                                  reduced=False, local_steps=1,
                                  device="cpu")


@pytest.mark.parametrize("cfg", [dict(num_experts=4, experts_per_token=2),
                                 dict(family="vlm", cross_attn_every=2,
                                      num_image_tokens=8),
                                 dict(remat="full")],
                         ids=["moe", "cross-attention", "remat"])
def test_unported_transformer_options_raise(cfg, rng):
    """MoE, cross-attention and remat, the options the port once refused,
    now each held against the reference: loss (with MoE's aux) and every
    gradient leaf at rtol 1e-4 (the VLM's cross-attention weights, behind
    an xgate of 0, get exactly zero gradient), and remat's gradients equal
    to remat="none" bit for bit."""
    base = dict(name="x", family="dense", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=97,
                remat="none", dtype="float32", param_dtype="float32",
                attn_chunk=16)
    jm = JTransformerLM(JModelConfig(**{**base, **cfg}))
    tm = TransformerLM(ModelConfig(**{**base, **cfg}), device="cpu")
    jp = jax.tree.map(np.array, jm.init(jax.random.key(15))[0])
    tp = params_from_jax(jp, "cpu",
                         like=TransformerLM(tm.cfg, device="meta").init(None))
    b = {"tokens": rng.integers(0, 97, size=(2, 32)).astype(np.int32),
         "targets": rng.integers(0, 97, size=(2, 32)).astype(np.int32)}
    if "cross_attn_every" in cfg:
        b["image_embeds"] = rng.normal(size=(2, 8, 64)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    zero = tuple(f"['xattn']['{w}']" for w in ("wq", "wk", "wv", "wo")) \
        if "cross_attn_every" in cfg else ()
    _loss_and_grads_match(lambda p: jm.loss(p, jb)[0], jp,
                          lambda p: tm.loss(p, tb)[0], tp, zero=zero)
    if cfg.get("num_experts"):
        assert float(tm.loss(tp, tb)[1]["aux"]) > 0
    if "remat" in cfg:
        plain = TransformerLM(ModelConfig(**base), device="cpu")
        grads = []
        for model in (tm, plain):
            leaves, treedef = _tree.flatten(tp)
            leaves = [l.clone().requires_grad_(True) for l in leaves]
            loss = model.loss(_tree.unflatten(treedef, leaves), tb)[0]
            grads.append(torch.autograd.grad(loss, leaves))
        assert all(torch.equal(a, c) for a, c in zip(*grads))
