"""The port's ResNet against the JAX reference, from the reference's own
initial parameters (``jax.random`` streams cannot be reproduced in
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

from repro.models.vision import ResNet as JResNet  # noqa: E402
from repro.models.vision import ResNetConfig as JResNetConfig  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import make_silo_datasets  # noqa: E402
from repro_torch.models.vision import ResNet, ResNetConfig, conv  # noqa: E402

REDUCED = dict(blocks_per_stage=2, num_classes=8, image_size=16)


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


@pytest.mark.parametrize("k,stride,size", [(3, 1, 8), (3, 2, 8), (3, 2, 7),
                                           (1, 2, 8), (1, 1, 5)])
def test_conv_same_padding_matches(k, stride, size, rng):
    """JAX "SAME" pads (0, 1) at stride 2, k=3 on even sizes."""
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 4)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = conv(torch.from_numpy(x), torch.from_numpy(w), stride)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
