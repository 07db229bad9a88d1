"""Leaf order of the port's trees against ``jax.tree.flatten``.

Wire buffer lists and the flat FedAvg vector are built in leaf order, so
it must be JAX's order (dict keys sorted) exactly, also for trees built
in a non-sorted insertion order such as the ResNet's."""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.models.vision import ResNet as JResNet  # noqa: E402
from repro.models.vision import ResNetConfig as JResNetConfig  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.vision import ResNet, ResNetConfig  # noqa: E402

REDUCED = dict(blocks_per_stage=2, num_classes=8, image_size=16)


def _nested(rng):
    a = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"z": a(3), "a": [a(2, 2), {"m": a(4), "b": a(1)}],
            "c": (a(5), a(2, 3)), "k": {"y": a(6), "x": {"q": a(2)}}}


@functools.lru_cache(maxsize=None)
def _resnet_np(reduced: bool):
    cfg = JResNetConfig(**REDUCED) if reduced else JResNetConfig()
    return jax.tree.map(np.array, JResNet(cfg).init(jax.random.key(0)))


@pytest.mark.parametrize("which", ["nested", "resnet_reduced",
                                   "resnet_full"])
def test_flatten_order_matches_jax(which, rng):
    tree = (_nested(rng) if which == "nested" else
            _resnet_np(which == "resnet_reduced"))
    want, _ = jax.tree.flatten(tree)
    got, treedef = _tree.flatten(tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g is w  # the very same leaf objects, in the same order
    back = _tree.unflatten(treedef, got)
    assert jax.tree.structure(back) == jax.tree.structure(tree)


@pytest.mark.parametrize("which", ["nested", "resnet_reduced"])
def test_flatten_pytree_vector_matches_reference(which, rng):
    tree = _nested(rng) if which == "nested" else _resnet_np(True)
    jflat, junflat = jops.flatten_pytree(jax.tree.map(jax.numpy.asarray,
                                                      tree))
    tflat, tunflat = ops.flatten_pytree(
        _tree.map(lambda a: torch.from_numpy(a.copy()), tree))
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    back = tunflat(tflat)
    for g, w in zip(_tree.leaves(back), jax.tree.leaves(junflat(jflat))):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_resnet_tree_mirrors_reference():
    """The port's own init has the reference's keys, shapes and dtypes
    (ResNetConfig() defaults: 868,123 params in 169 leaves)."""
    ref = _resnet_np(False)
    port = ResNet(ResNetConfig(), device="cpu").init(
        torch.Generator().manual_seed(0))
    conv = params_from_jax(ref, "cpu", like=port)
    leaves = _tree.leaves(conv)
    assert len(leaves) == 169
    assert sum(l.numel() for l in leaves) == 868_123
    with pytest.raises(ValueError):
        params_from_jax(_resnet_np(True), "cpu", like=port)


def test_map_and_unflatten_check_structure():
    with pytest.raises(ValueError):
        _tree.map(lambda a, b: a, {"a": 1}, {"b": 1})
    _, treedef = _tree.flatten({"a": [1, 2]})
    with pytest.raises(ValueError):
        _tree.unflatten(treedef, [1])
    with pytest.raises(ValueError):
        _tree.unflatten(treedef, [1, 2, 3])
