"""The tree form of the port's ``fedavg_reduce``, on the CPU.

``fedavg_reduce_leaves`` reads N client trees in place on the card,
through a table of leaf pointers and a cached table of tiles. Here, with
no card, its CPU dispatch (the plain version) is held against the
flatten-and-stack path and the JAX reference, and the tables the host
builds for the kernel are checked by walking them as the kernel does:
every tile's elements are read through the raw pointers of the table and
summed in client order with the module's flushes, which must reproduce
the plain version bit for bit. Inputs are seeded numpy arrays.
"""
import ctypes

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.kernels import fedavg_reduce as fr  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.vision import (MobileNetConfig, MobileNetV3,  # noqa: E402
                                       ResNet, ResNetConfig)

FMIN = np.float32(np.finfo(np.float32).tiny)
TINY = float(FMIN) * (1 - 2.0 ** -25)  # XLA's flush: rounded below FMIN
RESNET_REDUCED = dict(blocks_per_stage=2, num_classes=8, image_size=16)
MOBILENET_REDUCED = dict(
    blocks=((1, 16, 1, False), (4, 24, 2, False), (3, 24, 1, True),
            (2.5, 40, 2, True), (2.3, 40, 1, False)),
    head=96, classifier=128, num_classes=8, image_size=16)


def _flush(x):
    return np.where(np.abs(x) < FMIN, np.copysign(np.float32(0), x),
                    x).astype(np.float32)


def _mul(a, b):
    """The kernel's mul.rn.ftz.f32: flushed inputs, the exact product
    flushed where it rounds (24 bits, exponent unbounded) below FMIN."""
    exact = _flush(a).astype(np.float64) * _flush(b)
    r = exact.astype(np.float32)
    return np.where(np.abs(exact) < TINY, np.copysign(np.float32(0), r),
                    r).astype(np.float32)


def _read(ptr: int, count: int, bf16: bool) -> np.ndarray:
    """``count`` elements at a raw address, widened to f32."""
    if bf16:
        raw = np.frombuffer((ctypes.c_uint16 * count).from_address(ptr),
                            np.uint16)
        return (raw.astype(np.uint32) << 16).view(np.float32)
    return np.frombuffer((ctypes.c_float * count).from_address(ptr),
                         np.float32).copy()


def _walk(call) -> np.ndarray:
    """The kernel's arithmetic over a host-built call: tile by tile,
    through the table's pointers. Padding between slots stays NaN."""
    plan, table, n = call
    tab = table.numpy()
    nl = len(plan.sig)
    ptrs = tab[:nl * n].reshape(nl, n)
    w = tab[nl * n:].view(np.float32)[:n]
    out = np.full(plan.numel, np.nan, np.float32)
    for out_off, start, meta in plan.tiles.numpy().reshape(-1, 3):
        leaf, bf16, count = meta >> 32, (meta >> 31) & 1, meta & 0x7fffffff
        assert 0 < count <= fr.TILE
        acc = np.zeros(count, np.float32)
        for i in range(n):
            x = _read(int(ptrs[leaf, i]) + int(start) * (2 if bf16 else 4),
                      int(count), bool(bf16))
            acc = _flush(acc + _mul(w[i], x))
        assert np.isnan(out[out_off:out_off + count]).all()  # written once
        out[out_off:out_off + count] = acc
    return out


def _bits(t) -> np.ndarray:
    return t.detach().float().numpy().view(np.uint32)


def _trees(rng, n, shapes, dtypes=None, layout="separate"):
    """n trees {"l<j>": leaf j}, leaves as separate tensors or, with
    layout "views", views of one flat buffer at odd offsets."""
    dtypes = dtypes or [torch.float32] * len(shapes)
    trees = []
    for _ in range(n):
        vals = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
                .to(dt) for s, dt in zip(shapes, dtypes)]
        if layout == "views":
            assert all(dt == torch.float32 for dt in dtypes)
            flat = torch.zeros(sum(v.numel() + 1 for v in vals) + 1)
            off, views = 1, []
            for v in vals:
                flat[off:off + v.numel()] = v.reshape(-1)
                views.append(flat[off:off + v.numel()].view(v.shape))
                off += v.numel() + 1
            vals = views
        trees.append({f"l{j}": v for j, v in enumerate(vals)})
    return trees


def _leaves(trees):
    return [_tree.leaves(t) for t in trees]


def _weights(rng, n):
    return ops._normalised(rng.integers(1, 100, size=n).astype(np.float32))


SHAPES = [(16,), (3, 3, 4, 8), (1025,), (7,), (), (2048,), (3, 5)]
CASES = {
    "f32": (SHAPES, None, "separate"),
    "mixed f32/bf16": (SHAPES, [torch.float32, torch.bfloat16] * 3
                       + [torch.float32], "separate"),
    "views at odd offsets": (SHAPES, None, "views"),
    "one leaf": ([(3001,)], None, "separate"),
    "one scalar leaf": ([()], None, "separate"),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("n", [1, 3, 25])
def test_table_walk_matches_plain(case, n, rng):
    """The host's tables drive the kernel's arithmetic to the plain
    version's result, bit for bit, leaves read where they lie."""
    shapes, dtypes, layout = CASES[case]
    trees = _trees(rng, n, shapes, dtypes, layout)
    w = _weights(rng, n)
    call = fr.leaf_call(_leaves(trees), w)
    got = fr.leaf_views(call.plan, torch.from_numpy(_walk(call)))
    want = fr.fedavg_reduce_leaves(_leaves(trees), w)  # CPU: plain
    assert len(got) == len(want) == len(shapes)
    for g, v, s in zip(got, want, shapes):
        assert tuple(g.shape) == tuple(v.shape) == s
        assert g.dtype == v.dtype == torch.float32
        np.testing.assert_array_equal(_bits(g), _bits(v))


def test_plan_tiles_never_cross_a_leaf():
    first = [torch.zeros(s) for s in [(0,), (1,), (3,), (1024,), (1025,),
                                      (2, 1029)]]
    first[2] = first[2].to(torch.bfloat16)
    plan = fr.leaf_plan(first, "cpu")
    assert fr.leaf_plan(first, "cpu") is plan  # cached per structure
    tiles = plan.tiles.numpy().reshape(-1, 3)
    assert plan.n_tiles == len(tiles) == 0 + 1 + 1 + 1 + 2 + 3
    covered = {}
    for out_off, start, meta in tiles:
        leaf, bf16, count = meta >> 32, (meta >> 31) & 1, meta & 0x7fffffff
        shape, stride, slot = plan.views[leaf]
        size = int(np.prod(shape))
        assert bf16 == (leaf == 2)
        assert start % fr.TILE == 0 and 0 < count <= fr.TILE
        assert start + count <= size and out_off == slot + start
        covered[leaf] = covered.get(leaf, 0) + count
    assert covered == {1: 1, 2: 3, 3: 1024, 4: 1025, 5: 2058}
    slots = [v[2] for v in plan.views]
    assert all(s % fr.SLOT == 0 for s in slots)  # 16-byte aligned slots
    sizes = [int(np.prod(v[0])) for v in plan.views]
    assert all(a + n <= b for a, n, b in zip(slots, sizes, slots[1:]))
    assert plan.numel == slots[-1] + -(-sizes[-1] // fr.SLOT) * fr.SLOT


@pytest.mark.parametrize("model", ["resnet56", "mobilenetv3"])
def test_tree_form_matches_flatten_and_stack(model, rng):
    """Reduced-width model trees: the tree form equals the flatten, stack
    and (N, T) path bit for bit, and the JAX reference at its bars."""
    if model == "resnet56":
        m = ResNet(ResNetConfig(**RESNET_REDUCED), device="cpu")
    else:
        m = MobileNetV3(MobileNetConfig(**MOBILENET_REDUCED), device="cpu")
    trees = [m.init(torch.Generator().manual_seed(s)) for s in range(5)]
    weights = [float(v) for v in rng.integers(1, 100, size=5)]
    w = ops._normalised(weights)
    leaves = _leaves(trees)
    got = fr.fedavg_reduce_leaves(leaves, w)
    flats, unflatten = zip(*[ops.flatten_pytree(t) for t in trees])
    stacked = fr.fedavg_reduce(torch.stack(flats), torch.from_numpy(w))
    for g, v in zip(got, _tree.leaves(unflatten[0](stacked))):
        np.testing.assert_array_equal(_bits(g), _bits(v))
    walked = fr.leaf_views(fr.leaf_plan(leaves[0], "cpu"), torch.from_numpy(
        _walk(fr.leaf_call(leaves, w))))
    for g, v in zip(walked, got):
        np.testing.assert_array_equal(_bits(g), _bits(v))
    agg = ops.fedavg_aggregate(trees, weights)
    want = jops.fedavg_aggregate([_tree.map(lambda a: jnp.asarray(a.numpy()),
                                            t) for t in trees], weights,
                                 interpret=True)
    for g, a, v in zip(got, _tree.leaves(agg), jax.tree.leaves(want)):
        np.testing.assert_array_equal(_bits(g), _bits(a))
        np.testing.assert_allclose(g.numpy(), np.asarray(v), rtol=1e-4,
                                   atol=1e-5)


def test_mixed_dtype_trees_match_reference(rng):
    """f32 and bf16 leaves: each widened exactly, summed in f32; the
    aggregate keeps updates[0]'s dtypes, as the reference's does."""
    shapes, dtypes, _ = CASES["mixed f32/bf16"]
    trees = _trees(rng, 4, shapes, dtypes)
    weights = [3.0, 1.0, 4.0, 1.0]
    got = fr.fedavg_reduce_leaves(_leaves(trees), ops._normalised(weights))
    agg = ops.fedavg_aggregate(trees, weights)
    want = jops.fedavg_aggregate(
        [{k: jnp.asarray(v.float().numpy()).astype(
            jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32)
          for k, v in t.items()} for t in trees], weights, interpret=True)
    for k, g, dt in zip(sorted(agg), got, dtypes):
        assert agg[k].dtype == dt
        np.testing.assert_array_equal(_bits(g.to(dt)), _bits(agg[k]))
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k], np.float32),
                                   rtol=1e-2 if dt == torch.bfloat16
                                   else 1e-4, atol=1e-2 if dt ==
                                   torch.bfloat16 else 1e-5)


def test_views_at_odd_offsets_equal_contiguous_copies(rng):
    trees = _trees(rng, 3, SHAPES, layout="views")
    w = _weights(rng, 3)
    got = fr.fedavg_reduce_leaves(_leaves(trees), w)
    copies = [[l.clone() for l in ls] for ls in _leaves(trees)]
    assert any(l.data_ptr() % 16 for l in _leaves(trees)[0])
    for g, v in zip(got, fr.fedavg_reduce_leaves(copies, w)):
        np.testing.assert_array_equal(_bits(g), _bits(v))


def test_aggregate_on_cpu_launches_nothing(rng):
    trees = _trees(rng, 3, SHAPES)
    before = fr.LAUNCHES
    ops.fedavg_aggregate(trees, [1.0, 2.0, 3.0])
    fr.fedavg_reduce_leaves(_leaves(trees), _weights(rng, 3))
    assert fr.LAUNCHES == before


def test_leaf_call_rejects_what_the_kernel_cannot_take(rng):
    trees = _leaves(_trees(rng, 2, [(4, 6), (5,)]))
    w = [0.5, 0.5]
    # the same shape, column-major: not contiguous
    bad = [trees[0], [trees[1][0].t().contiguous().t(), trees[1][1]]]
    with pytest.raises(ValueError, match="non-contiguous"):
        fr.leaf_call(bad, w)
    with pytest.raises(ValueError, match="differ"):  # another shape
        fr.leaf_call([trees[0], [trees[1][0].reshape(6, 4), trees[1][1]]], w)
    with pytest.raises(ValueError, match="differ"):  # another dtype
        fr.leaf_call([trees[0], [trees[1][0].double(), trees[1][1]]], w)
    with pytest.raises(ValueError, match="differ"):  # a missing leaf
        fr.leaf_call([trees[0], trees[1][:1]], w)
    with pytest.raises(TypeError):
        fr.leaf_call([[l.half() for l in t] for t in trees], w)
    with pytest.raises(ValueError, match="weights"):
        fr.leaf_call(trees, [1.0])
    with pytest.raises(ValueError):
        fr.leaf_call([], [])
    with pytest.raises(ValueError):
        fr.leaf_call([trees[0]] * (fr.MAX_CLIENTS + 1),
                     np.ones(fr.MAX_CLIENTS + 1))
    with pytest.raises(ValueError):  # the kernel runs only on a card
        fr.launch_leaves(fr.leaf_call(trees, w))
