"""The local SGD step of ``launch/fl_train.make_train_fn`` and its CUDA
graph (``launch/train_graph.py``). This file imports no JAX: its card
tests run on the machine with the card, which has none.

    python -m pytest -q -m cuda tests/test_torch_train_graph.py

On the CPU: the flat layout round-trips the ResNet56 and MobileNetV3
trees in contiguous views at aligned offsets; the wire sees a tree of such
views as it sees separate tensors; ``train_fn`` runs the eager step, bit
for bit the step as it was written before the graph, with no graph
counted; the graph's own loads, body and result, run eagerly, give the
same bits; the signature moves with the batch and the kernel flags.

On the card (skipped without one): 4 graphed steps against 4 eager steps
at the two configurations' widths, at a small batch, within TF32 noise:
each leaf within 1e-3 of its largest entry (twice TF32's unit roundoff,
2^-11), the loss within 1e-3 of itself; the two sides run the same
kernels, so what differs is the order of cuDNN's sums. A returned tree is
not overwritten by the next replay; a halved batch captures a second
graph; after n steps of one shape the counters read 1 capture and n - 1
replays.
"""
import pickle

import numpy as np
import pytest
import torch

from repro_torch import _tree, obs
from repro_torch.core import TensorPayload
from repro_torch.core import serialization
from repro_torch.core.message import tree_nbytes
from repro_torch.launch import fl_train, train_graph
from repro_torch.models.vision import (MobileNetConfig, MobileNetV3, ResNet,
                                       ResNetConfig, ViT, ViTConfig)

LR = fl_train.LEARNING_RATE
# the two benchmark configurations' widths (fl_bench/configs/): ResNet56,
# and MobileNetV3 with Table 1's 15 blocks
MNV3_BLOCKS = ((1, 16, 1, False), (4, 24, 2, False), (3, 24, 1, False),
               (3, 40, 2, True), (3, 40, 1, True), (3, 40, 1, True),
               (6, 80, 2, False), (2.5, 80, 1, False), (2.3, 80, 1, False),
               (2.3, 80, 1, False), (6, 112, 1, True), (6, 112, 1, True),
               (6, 160, 2, True), (6, 160, 1, True), (6, 160, 1, True))
MODELS = {
    "resnet56-small": lambda dev: ResNet(ResNetConfig(), device=dev),
    "mobilenetv3-medium": lambda dev: MobileNetV3(
        MobileNetConfig(blocks=MNV3_BLOCKS), device=dev),
}
SMALL = {  # reduced models for the CPU step tests
    "resnet": lambda: ResNet(ResNetConfig(blocks_per_stage=1, num_classes=8,
                                          image_size=16), device="cpu"),
    "mobilenet": lambda: MobileNetV3(
        MobileNetConfig(blocks=MNV3_BLOCKS[:4], head=64, classifier=32,
                        num_classes=8), device="cpu"),
}


def eager_step(model):
    """The step as ``make_train_fn`` wrote it before the graph."""
    def train_fn(params, batch):
        leaves, treedef = _tree.flatten(params)
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        loss, _ = model.loss(_tree.unflatten(treedef, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            new = [p - LR * g for p, g in zip(leaves, grads)]
        return _tree.unflatten(treedef, new), loss.detach()
    return train_fn


def make_batch(n, size, classes, seed, device):
    g = np.random.default_rng(seed)
    return {"images": torch.tensor(g.normal(size=(n, size, size, 3))
                                   .astype(np.float32), device=device),
            "labels": torch.tensor(g.integers(0, classes, n)
                                   .astype(np.int32), device=device)}


def bits(t):
    if isinstance(t, np.ndarray):  # a leaf the wire decoded (read-only)
        t = torch.from_numpy(t.copy())
    return t.detach().cpu().contiguous().view(torch.int32)


def assert_bitwise(a, b):
    la, lb = _tree.leaves(a), _tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and torch.equal(bits(x), bits(y))


# -- the flat layout --------------------------------------------------------
@pytest.mark.parametrize("name", MODELS)
def test_flat_round_trips_the_tree(name):
    params = MODELS[name]("cpu").init(torch.Generator().manual_seed(3))
    leaves, treedef = _tree.flatten(params)
    flat = train_graph.Flat(leaves)
    assert flat.numel >= sum(l.numel() for l in leaves)
    assert all(o * 4 % train_graph.ALIGN_BYTES == 0 for o in flat.offsets)
    buf = flat.empty("cpu")
    views = flat.views(buf)
    torch._foreach_copy_(views, leaves)
    back = flat.views(buf)
    for v, l in zip(back, leaves):
        assert v.shape == l.shape and v.is_contiguous() and v._base is buf
        assert torch.equal(bits(v), bits(l))
    assert flat.views_of(back, buf)
    assert not flat.views_of([l.clone() for l in back], buf)
    assert not flat.views_of(back, buf.clone())
    swapped = list(back)
    i, j = next((i, j) for i in range(len(back)) for j in range(i)
                if back[i].shape == back[j].shape)
    swapped[i], swapped[j] = swapped[j], swapped[i]
    assert not flat.views_of(swapped, buf)
    # the tree of views carries the same bytes as the tree
    assert_bitwise(_tree.unflatten(treedef, back), params)


def test_flat_takes_one_dtype():
    with pytest.raises(ValueError, match="one dtype"):
        train_graph.Flat([torch.zeros(3), torch.zeros(2, dtype=torch.int32)])


@pytest.mark.parametrize("ser", sorted(serialization.SERIALIZERS))
def test_wire_sees_views_as_tensors(ser):
    params = MODELS["resnet56-small"]("cpu").init(
        torch.Generator().manual_seed(5))
    leaves, treedef = _tree.flatten(params)
    flat = train_graph.Flat(leaves)
    buf = flat.empty("cpu")
    torch._foreach_copy_(flat.views(buf), leaves)
    views = _tree.unflatten(treedef, flat.views(buf))
    separate = _tree.map(lambda l: l.clone(), params)
    assert tree_nbytes(views) == tree_nbytes(separate) \
        == sum(l.numel() * 4 for l in leaves)
    s = serialization.SERIALIZERS[ser]
    a, b = s.serialize(TensorPayload(views)), s.serialize(TensorPayload(
        separate))
    assert a.nbytes == b.nbytes and a.codec == b.codec
    assert len(a.buffers) == len(b.buffers)
    for x, y in zip(a.buffers, b.buffers):
        xb = x if isinstance(x, bytes) else np.ascontiguousarray(x).tobytes()
        yb = y if isinstance(y, bytes) else np.ascontiguousarray(y).tobytes()
        assert xb == yb
    assert serialization.checksum(a) == serialization.checksum(b)
    assert pickle.dumps(a.obj) == pickle.dumps(b.obj)
    assert_bitwise(s.deserialize(a).tree, separate)


# -- the step on the CPU ----------------------------------------------------
@pytest.mark.parametrize("name", SMALL)
def test_cpu_step_is_the_eager_step(name):
    model = SMALL[name]()
    params = model.init(torch.Generator().manual_seed(7))
    step, want = fl_train.make_train_fn(model), eager_step(model)
    got_p = want_p = params
    obs.enable()
    try:
        for i in range(3):
            batch = make_batch(6, 16, 8, i, "cpu")
            got_p, got_l = step(got_p, batch)
            want_p, want_l = want(want_p, batch)
            assert torch.equal(bits(got_l), bits(want_l))
            assert_bitwise(got_p, want_p)
        snap = obs.snapshot()
    finally:
        obs.disable()
    assert snap["counters"].get("client.step.graphed", 0) == 0
    assert snap["counters"].get("client.step.captures", 0) == 0
    assert "client.step.capture" not in snap["spans"]
    for span in ("forward", "backward", "update"):
        assert snap["spans"][f"client.step.{span}"]["n"] == 3


def test_graph_body_run_eagerly_gives_the_same_bits():
    """``GraphedStep``'s loads, body and result, which a replay runs
    around the captured body, on the CPU without a graph: the tree of
    separate tensors (``_foreach_copy_``) and the tree it returned (one
    ``copy_`` of the whole buffer) both give the eager step's bits."""
    model = SMALL["resnet"]()
    params = model.init(torch.Generator().manual_seed(11))
    leaves, treedef = _tree.flatten(params)
    want = eager_step(model)
    batch = make_batch(6, 16, 8, 0, "cpu")

    def step(ls, b):
        new, loss = want(_tree.unflatten(treedef, ls), b)
        return _tree.leaves(new), loss

    g = train_graph.GraphedStep(step, leaves, batch)
    want_p = params
    for i in range(3):
        batch = make_batch(6, 16, 8, i, "cpu")
        g._load(leaves, batch)
        if i:  # the previous call's views: the whole buffer in one copy
            assert g.flat.views_of(leaves, g._last())
        leaves, loss = g._result(g._body())
        want_p, want_l = want(want_p, batch)
        assert torch.equal(bits(loss), bits(want_l))
        assert_bitwise(_tree.unflatten(treedef, leaves), want_p)


def test_signature_moves_with_batch_and_flags():
    leaves = [torch.zeros(3, 4), torch.zeros(5)]
    treedef = _tree.flatten({"a": leaves[0], "b": leaves[1]})[1]
    batch = make_batch(4, 8, 3, 0, "cpu")
    base = train_graph.signature(treedef, leaves, batch)
    assert train_graph.signature(treedef, leaves, dict(batch)) == base
    half = {k: v[:2] for k, v in batch.items()}
    assert train_graph.signature(treedef, leaves, half) != base
    as64 = dict(batch, images=batch["images"].double())
    assert train_graph.signature(treedef, leaves, as64) != base
    assert train_graph.signature(
        treedef, [l.double() for l in leaves], batch) != base
    flags = [(torch.backends.cuda.matmul, "allow_tf32"),
             (torch.backends.cudnn, "allow_tf32"),
             (torch.backends.cudnn, "deterministic")]
    for owner, name in flags:
        was = getattr(owner, name)
        try:
            setattr(owner, name, not was)
            assert train_graph.signature(treedef, leaves, batch) != base
        finally:
            setattr(owner, name, was)
        assert train_graph.signature(treedef, leaves, batch) == base


# -- on the card ------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def card_case(name, device):
    model = MODELS[name](device)
    params = model.init(torch.Generator().manual_seed(13))
    size = 32 if name.startswith("resnet") else 64
    batches = [make_batch(8, size, 203, 100 + i, device) for i in range(4)]
    return model, params, batches


def near(got, want, share=1e-3):
    for g, w in zip(_tree.leaves(got), _tree.leaves(want)):
        top = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= share * top, (err, top, tuple(w.shape))


@pytest.mark.cuda
@pytest.mark.parametrize("name", MODELS)
def test_graphed_steps_match_eager_steps(cuda, name):
    model, params, batches = card_case(name, cuda)
    step, want = fl_train.make_train_fn(model), eager_step(model)
    got_p = want_p = params
    obs.enable()
    try:
        for i, batch in enumerate(batches):
            if i == 2:  # a tree of separate tensors, as from the wire
                got_p = _tree.map(lambda l: l.clone(), got_p)
            got_p, got_l = step(got_p, batch)
            want_p, want_l = want(want_p, batch)
            assert abs(float(got_l) - float(want_l)) <= 1e-3 * abs(
                float(want_l))
            near(got_p, want_p)
        snap = obs.snapshot()
    finally:
        obs.disable()
    assert snap["counters"]["client.step.captures"] == 1
    assert snap["counters"]["client.step.graphed"] == len(batches) - 1
    assert snap["spans"]["client.step.capture"]["n"] == 1


@pytest.mark.cuda
def test_vit_step_captures(cuda):
    """The third family on the path: ViT-Large's widths at 2 layers
    (``chip_smoke.py`` times the step at 24), on the silos' 16x16 images;
    its matmuls run in full f32, so the bound is the same."""
    model = ViT(ViTConfig(num_layers=2), device=cuda)
    params = model.init(torch.Generator().manual_seed(17))
    step, want = fl_train.make_train_fn(model), eager_step(model)
    got_p = want_p = params
    obs.enable()
    try:
        for i in range(3):
            batch = make_batch(4, 16, 203, 200 + i, cuda)
            got_p, got_l = step(got_p, batch)
            want_p, want_l = want(want_p, batch)
            assert abs(float(got_l) - float(want_l)) <= 1e-3 * abs(
                float(want_l))
            near(got_p, want_p)
        snap = obs.snapshot()
    finally:
        obs.disable()
    assert snap["counters"]["client.step.captures"] == 1
    assert snap["counters"]["client.step.graphed"] == 2


@pytest.mark.cuda
def test_returned_tree_survives_the_next_replay(cuda):
    model, params, batches = card_case("resnet56-small", cuda)
    step = fl_train.make_train_fn(model)
    first, _ = step(params, batches[0])
    second, _ = step(first, batches[1])
    kept = _tree.map(lambda l: l.clone(), second)
    third, _ = step(second, batches[2])
    torch.cuda.synchronize()
    assert_bitwise(second, kept)
    assert not any(torch.equal(a, b) for a, b in
                   zip(_tree.leaves(third), _tree.leaves(second))
                   if a.dim() > 1)
    bases = {l._base.data_ptr() for t in (first, second, third)
             for l in _tree.leaves(t)}
    assert len(bases) == 3  # one fresh buffer a call


@pytest.mark.cuda
def test_halved_batch_captures_a_second_graph(cuda):
    model, params, batches = card_case("resnet56-small", cuda)
    step, want = fl_train.make_train_fn(model), eager_step(model)
    obs.enable()
    try:
        p, _ = step(params, batches[0])
        half = {k: v[: len(v) // 2] for k, v in batches[1].items()}
        got, got_l = step(p, half)
        again, _ = step(p, half)
        snap = obs.snapshot()
    finally:
        obs.disable()
    assert snap["counters"]["client.step.captures"] == 2
    assert snap["counters"]["client.step.graphed"] == 1
    want_p, want_l = want(p, half)
    assert abs(float(got_l) - float(want_l)) <= 1e-3 * abs(float(want_l))
    near(got, want_p)
    near(again, want_p)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 5])
def test_counters_after_n_steps(cuda, n):
    model, params, batches = card_case("resnet56-small", cuda)
    step = fl_train.make_train_fn(model)
    obs.enable()
    try:
        for i in range(n):
            params, _ = step(params, batches[i % len(batches)])
        snap = obs.snapshot()
    finally:
        obs.disable()
    assert snap["counters"]["client.step.captures"] == 1
    assert snap["counters"].get("client.step.graphed", 0) == n - 1


class HostRead:
    """A model whose loss reads a value on the host, which no graph can
    hold: its capture fails."""

    def __init__(self, inner):
        self.inner = inner

    def loss(self, p, batch):
        loss, aux = self.inner.loss(p, batch)
        if not float(loss.detach()) >= 0:
            raise AssertionError("a cross-entropy is not negative")
        return loss, aux


@pytest.mark.cuda
def test_failed_capture_warns_once_and_runs_eagerly(cuda):
    inner = ResNet(ResNetConfig(blocks_per_stage=1, num_classes=8,
                                image_size=16), device=cuda)
    model = HostRead(inner)
    params = inner.init(torch.Generator().manual_seed(19))
    step, want = fl_train.make_train_fn(model), eager_step(inner)
    got_p = want_p = params
    obs.enable()
    try:
        with pytest.warns(RuntimeWarning, match="runs eagerly") as caught:
            for i in range(3):
                batch = make_batch(6, 16, 8, 300 + i, cuda)
                got_p, got_l = step(got_p, batch)
                want_p, want_l = want(want_p, batch)
                assert abs(float(got_l) - float(want_l)) <= 1e-3 * abs(
                    float(want_l))
                near(got_p, want_p)
        snap = obs.snapshot()
    finally:
        obs.disable()
    assert len([w for w in caught if "runs eagerly" in str(w.message)]) == 1
    assert snap["counters"]["client.step.captures"] == 1
    assert "client.step.graphed" not in snap["counters"]
    # the card still captures a graph after the failed one
    ok = fl_train.make_train_fn(inner)
    p, _ = ok(params, batch)
    p, _ = ok(p, batch)
    torch.cuda.synchronize()
