"""The port's ResNet and MobileNetV3 against the JAX reference, from the
reference's own initial parameters (``jax.random`` streams cannot be reproduced in
torch, so both start from them through ``params_from_jax``).

Bar: rtol 1e-4 (ROADMAP "Parity bars"). Both sides compute in f32 on the
CPU; the atol floors below cover entries near zero, where two f32
convolutions summed in different orders differ in the last bits.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models.vision import MobileNetConfig as JMobileNetConfig  # noqa: E402
from repro.models.vision import MobileNetV3 as JMobileNetV3  # noqa: E402
from repro.models.vision import ResNet as JResNet  # noqa: E402
from repro.models.vision import ResNetConfig as JResNetConfig  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import make_silo_datasets  # noqa: E402
from repro_torch.configs.paper_tiers import build_tier_model  # noqa: E402
from repro_torch.models.vision import (MobileNetConfig, MobileNetV3,  # noqa: E402
                                       ResNet, ResNetConfig, conv)

REDUCED = dict(blocks_per_stage=2, num_classes=8, image_size=16)
# every block kind of the full config: stride 1 and 2, SE or not, the
# residual, and the 2.5 / 2.3 expansions that round c_mid
MOBILENET_REDUCED = dict(
    blocks=((1, 16, 1, False), (4, 24, 2, False), (3, 24, 1, True),
            (2.5, 40, 2, True), (2.3, 40, 1, False)),
    head=96, classifier=128, num_classes=8, image_size=16)


@functools.lru_cache(maxsize=None)
def _models(reduced: bool):
    kw = REDUCED if reduced else {}
    jm = JResNet(JResNetConfig(**kw))
    tm = ResNet(ResNetConfig(**kw), device="cpu")
    jp = jax.tree.map(np.array, jm.init(jax.random.key(3)))
    tp = params_from_jax(jp, "cpu",
                         like=tm.init(torch.Generator().manual_seed(0)))
    return jm, tm, jp, tp


def _batch(n, size):
    silo = make_silo_datasets(1, examples_per_silo=64, num_classes=8,
                              image_size=size, seed=5)[0]
    return next(silo.batches(n, seed=1))


def test_reduced_loss_and_grads_match():
    jm, tm, jp, tp = _models(True)
    b = _batch(16, 16)

    def jloss(p):
        return jm.loss(p, {k: jnp.asarray(v) for k, v in b.items()})[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, jp))
    leaves, treedef = _tree.flatten(tp)
    leaves = [l.clone().requires_grad_(True) for l in leaves]
    tl, _ = tm.loss(_tree.unflatten(treedef, leaves),
                    {k: torch.from_numpy(v) for k, v in b.items()})
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for g, w in zip(tg, jleaves):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))


def test_full_width_forward_matches():
    """ResNetConfig() defaults (ResNet56, 203 classes) at batch 2."""
    jm, tm, jp, tp = _models(False)
    images = _batch(2, 32)["images"]
    jlogits = np.asarray(jm.forward(jax.tree.map(jnp.asarray, jp),
                                    jnp.asarray(images)))
    with torch.no_grad():
        tlogits = tm.forward(tp, torch.from_numpy(images)).numpy()
    assert tlogits.shape == (2, 203)
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4,
                               atol=1e-4 * float(np.abs(jlogits).max()))


CONV_CASES = {"3-1-8": (3, 1, 8, 1), "3-2-8": (3, 2, 8, 1),
              "3-2-7": (3, 2, 7, 1), "1-2-8": (1, 2, 8, 1),
              "1-1-5": (1, 1, 5, 1),
              # depthwise (MobileNetV3): HWIO (3, 3, 1, C), groups=C
              "dw-3-2-8": (3, 2, 8, 6), "dw-3-2-1": (3, 2, 1, 6)}


@pytest.mark.parametrize("k,stride,size,groups", list(CONV_CASES.values()),
                         ids=list(CONV_CASES))
def test_conv_same_padding_matches(k, stride, size, groups, rng):
    """JAX "SAME" pads (0, 1) at stride 2, k=3 on even sizes, grouped or
    not."""
    c_in = 3 if groups == 1 else groups
    c_out = 4 if groups == 1 else groups
    x = rng.normal(size=(2, size, size, c_in)).astype(np.float32)
    w = rng.normal(size=(k, k, c_in // groups, c_out)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups)
    got = conv(torch.from_numpy(x), torch.from_numpy(w), stride,
               groups=groups)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@functools.lru_cache(maxsize=None)
def _mobilenets(reduced: bool):
    kw = MOBILENET_REDUCED if reduced else {}
    jm = JMobileNetV3(JMobileNetConfig(**kw))
    tm = MobileNetV3(MobileNetConfig(**kw), device="cpu")
    jp = jax.tree.map(np.array, jm.init(jax.random.key(4)))
    tp = params_from_jax(jp, "cpu",
                         like=tm.init(torch.Generator().manual_seed(0)))
    return jm, tm, jp, tp


def test_mobilenet_tree_converts_at_full_width():
    """The Medium tier's tree, key for key: 4,375,723 parameters in 151
    leaves, with ``se_down``/``se_up`` only in the SE blocks."""
    _, tm, jp, tp = _mobilenets(False)
    leaves = _tree.leaves(tp)
    assert len(leaves) == len(jax.tree.leaves(jp)) == 151
    assert sum(l.numel() for l in leaves) == 4_375_723
    assert [("se_down" in b) for b in tp["blocks"]] == \
        [se for *_, se in MobileNetConfig().blocks]
    tier, init = build_tier_model("medium", device="cpu")
    assert isinstance(tier, MobileNetV3) and tier.cfg == MobileNetConfig()
    own = init(torch.Generator().manual_seed(1))
    assert [tuple(l.shape) for l in _tree.leaves(own)] == \
        [tuple(l.shape) for l in leaves]


def test_mobilenet_reduced_loss_and_grads_match():
    """Each leaf at rtol 1e-4 with an atol of 1e-4 of its largest entry,
    but for the ``bn_p`` biases: each feeds, through a linear 1x1 conv,
    the next normalisation, which removes any per-channel constant, so
    their gradient is zero and both packages give rounding noise there
    (~1e-9 of the model's largest gradient). Those are held to zero:
    within 1e-6 of the model's largest gradient entry, on both sides."""
    jm, tm, jp, tp = _mobilenets(True)
    b = _batch(16, 16)

    def jloss(p):
        return jm.loss(p, {k: jnp.asarray(v) for k, v in b.items()})[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, jp))
    leaves, treedef = _tree.flatten(tp)
    leaves = [l.clone().requires_grad_(True) for l in leaves]
    tl, _ = tm.loss(_tree.unflatten(treedef, leaves),
                    {k: torch.from_numpy(v) for k, v in b.items()})
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    paths = [jax.tree_util.keystr(path) for path, _ in
             jax.tree_util.tree_flatten_with_path(jg)[0]]
    jleaves = [np.asarray(w) for w in jax.tree.leaves(jg)]
    assert len(jleaves) == len(tg) == len(paths)
    top = max(float(np.abs(w).max()) for w in jleaves)
    zero = [i for i, path in enumerate(paths)
            if path.endswith("['bn_p']['bias']")]
    assert len(zero) == len(MOBILENET_REDUCED["blocks"])
    for i, (g, w) in enumerate(zip(tg, jleaves)):
        if i in zero:
            assert float(np.abs(w).max()) <= 1e-6 * top
            assert float(g.abs().max()) <= 1e-6 * top
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))


def test_mobilenet_full_width_forward_matches():
    """MobileNetConfig() defaults (203 classes) on the silos' 16x16 images
    at batch 2: every stride-2 stage on an even size, down to 1x1.

    In f64 the two packages compute the same function to rounding (rtol
    1e-10). In f32 the last stages run at 1x1, where batch statistics
    span 2 values per channel and amplify rounding: the reference's own
    f32 logits sit 4.6e-5 of the largest logit from its f64 logits, the
    port's 1.2e-4. The f32 bar is 2e-4 of the largest logit, from the
    reference's f64 logits, for both packages."""
    jm, tm, jp, tp = _mobilenets(False)
    images = _batch(2, 16)["images"]
    with jax.enable_x64(True):
        j64 = np.asarray(jm.forward(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jp),
            jnp.asarray(images, jnp.float64)))
    j32 = np.asarray(jm.forward(jax.tree.map(jnp.asarray, jp),
                                jnp.asarray(images)))
    with torch.no_grad():
        t64 = tm.forward(_tree.map(lambda a: a.double(), tp),
                         torch.from_numpy(images).double()).numpy()
        t32 = tm.forward(tp, torch.from_numpy(images)).numpy()
    assert t32.shape == t64.shape == (2, 203) and t32.dtype == np.float32
    np.testing.assert_allclose(t64, j64, rtol=1e-10, atol=0)
    bar = 2e-4 * float(np.abs(j64).max())
    np.testing.assert_allclose(j32, j64, rtol=0, atol=bar)
    np.testing.assert_allclose(t32, j64, rtol=0, atol=bar)


@functools.lru_cache(maxsize=None)
def _mobilenet_seed8():
    """Full-width MobileNetV3 from the port's own init (seed 8), handed to
    both packages as numpy, and the silos' 16x16 batch of 16: the
    configuration of ``chip_smoke.py``'s MobileNetV3 check. Returns the
    port's parameters, the batch, the reference's f64 gradients and their
    tree paths."""
    tm = MobileNetV3(MobileNetConfig(), device="cpu")
    params = tm.init(torch.Generator().manual_seed(8))
    silo = make_silo_datasets(1, kind="image", examples_per_silo=64,
                              num_classes=8, image_size=16, seed=8)[0]
    b = next(silo.batches(16, seed=1))
    jm = JMobileNetV3(JMobileNetConfig())
    with jax.enable_x64(True):
        jp = _tree.map(lambda a: jnp.asarray(a.numpy(), jnp.float64), params)
        jb = {k: jnp.asarray(v, jnp.float64 if v.dtype.kind == "f" else None)
              for k, v in b.items()}
        jg = jax.grad(lambda p: jm.loss(p, jb)[0])(jp)
        paths = [jax.tree_util.keystr(path) for path, _ in
                 jax.tree_util.tree_flatten_with_path(jg)[0]]
        j64 = [np.asarray(w) for w in jax.tree.leaves(jg)]
    return tm, params, b, j64, paths


def test_mobilenet_full_width_f32_grads_match_f64():
    """The port's CPU f32 gradients at full MobileNetV3 width against the
    reference's f64 gradients, at 2e-4 of each leaf's largest entry; the
    reference's own f32 gradients read 7.871e-5 there. The ``bn_p``
    biases (zero gradient, see above) are held to zero within 1e-6 of the
    largest gradient entry, on both sides.

    On this input one normalised value of ``blocks[12].bn_d`` sits 6.2e-6
    below hard_swish's kink at 3, where the derivative steps from 1.5 to 1:
    an f32 run that rounds it across the kink moves that block's
    gradients by up to 0.13 of a leaf's largest entry. Which side a run
    lands on is set by the order its reductions sum in (PERF.md)."""
    tm, params, b, j64, paths = _mobilenet_seed8()
    leaves, treedef = _tree.flatten(params)
    leaves = [l.clone().requires_grad_(True) for l in leaves]
    tl, _ = tm.loss(_tree.unflatten(treedef, leaves),
                    {k: torch.from_numpy(v) for k, v in b.items()})
    tg = torch.autograd.grad(tl, leaves)
    assert len(tg) == len(j64) == len(paths) == 151
    top = max(float(np.abs(w).max()) for w in j64)
    zero = [i for i, path in enumerate(paths)
            if path.endswith("['bn_p']['bias']")]
    assert len(zero) == len(MobileNetConfig().blocks)
    for i, (g, w) in enumerate(zip(tg, j64)):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        if i in zero:
            assert float(np.abs(w).max()) <= 1e-6 * top
            assert float(g.abs().max()) <= 1e-6 * top
            continue
        rel = float(np.abs(g.numpy().astype(np.float64) - w).max()) \
            / float(np.abs(w).max())
        assert rel <= 2e-4, (paths[i], rel)
