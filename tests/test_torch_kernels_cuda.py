"""The hand-written Hopper kernels against their plain PyTorch versions,
on the card. This file imports no JAX: the machine with the card has
none. On a machine without a card every test skips.

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances:
* ``fedavg_reduce`` (the (N, T) form and the tree form, which reads client
  trees in place): bit-exact, f32 and bf16, aligned and misaligned
  leaves, subnormal rows included: the kernel and the plain version sum
  the clients in order with the same rounded operations and flushes;
* ``quantize_blocks``: the kernel and the plain version take the same IEEE
  operations on the same card, with the same subnormal flushes, so int8
  and scales are bit-exact, on both of the kernel's paths;
* ``dequantize_blocks``: rtol 1e-6 (one rounded product each);
* ``fedavg_accumulate``: bit-exact, ragged and misaligned inputs included
  (both round the product and then the sum, on the same card);
* ``topk_rows``: idx equal and vals equal bit for bit (compared as int32
  views: ``torch.equal`` calls -0.0 equal to +0.0), ties and signed zeros
  included;
* ``fedavg_reduce_q8``: bit-exact on both of its paths (the path is
  asserted), for the same reason as ``fedavg_reduce``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fedavg_reduce as fr
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as qz
from repro_torch.kernels import topk as tk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# (5, 868_123): the main path's FedAvg, quorum 0.7 of 7 ResNet56 silos
@pytest.mark.parametrize("n,t", [(5, 868_123), (7, 868_123), (2, 1024),
                                 (3, 3007), (16, 4096), (1, 1), (5, 255)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, n, t, dtype):
    g = torch.Generator(device="cpu").manual_seed(n * 100_003 + t)
    x = torch.randn((n, t), generator=g).to(cuda, dtype)
    w = torch.rand((n,), generator=g).to(cuda)
    w = w / w.sum()
    before = fr.LAUNCHES
    out = fr.fedavg_reduce(x, w)
    torch.cuda.synchronize()
    assert fr.LAUNCHES == before + 1
    assert out.dtype == torch.float32 and out.shape == (t,)
    want = fr.fedavg_reduce_plain(x, w)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


def test_kernel_is_deterministic(cuda):
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn((7, 100_003), generator=g).to(cuda)
    w = torch.full((7,), 1 / 7, device=cuda)
    a, b = fr.fedavg_reduce(x, w), fr.fedavg_reduce(x, w)
    assert torch.equal(a, b)


def test_aggregate_on_card_matches_cpu(cuda):
    g = torch.Generator(device="cpu").manual_seed(1)
    trees = [{"w": torch.randn((37, 5), generator=g),
              "b": [torch.randn((9,), generator=g)]} for _ in range(3)]
    want = ops.fedavg_aggregate(trees, [1, 2, 3])
    got = ops.fedavg_aggregate(
        [{"w": t["w"].to(cuda), "b": [t["b"][0].to(cuda)]} for t in trees],
        [1, 2, 3])
    assert got["w"].is_cuda
    # the same IEEE operations in the same order on both devices
    for g, v in ((got["w"], want["w"]), (got["b"][0], want["b"][0])):
        assert torch.equal(g.cpu().view(torch.int32), v.view(torch.int32))


def test_kernel_rejects_wrong_dtype(cuda):
    with pytest.raises(TypeError):
        fr.fedavg_reduce(torch.zeros((2, 8), dtype=torch.float16,
                                     device=cuda),
                         torch.ones(2, device=cuda))


FMIN = torch.finfo(torch.float32).tiny  # 2**-126
BELOW = float(np.nextafter(np.float32(FMIN), np.float32(0)))


def _fast(block, dtype, aligned):
    """The kernels' fast-path rule (csrc/quantize.cu): the row spans 512,
    1024, 2048 or 4096 bytes of its float side, pointers 16-byte aligned."""
    return aligned and block * torch.finfo(dtype).bits // 8 in (512, 1024,
                                                                2048, 4096)


def _on_card(x, dtype, cuda, aligned):
    """``x`` on the card as a contiguous ``dtype`` tensor; off 16-byte
    alignment (a view one element into a buffer) unless ``aligned``."""
    if aligned:
        return x.to(cuda, dtype)
    buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
    buf[1:] = x.reshape(-1).to(cuda, dtype)
    return buf[1:].reshape(x.shape)


def _quantize_input(rows, block, kind, g):
    """(rows, block) f32: "randn" and "misaligned" (an all-zero row),
    "ties" (x * inv exactly k + 0.5 at scales 1 and 2) or "subnormal" (row
    r takes the r % 7-th rule of kernels/quantize.py's flush)."""
    x = torch.randn((rows, block), generator=g) * 3
    if kind == "ties":
        f = (1.0 + torch.arange(rows) % 2)[:, None]  # scale 1 or 2
        x = (torch.randint(-126, 126, (rows, block), generator=g) + 0.5) * f
        x[:, 0] = 127 * f[:, 0]
    elif kind == "subnormal":
        r = torch.arange(rows) % 7
        sub = torch.randn((rows, block), generator=g)
        x[r == 0] = torch.linspace(-1e-36, 1e-36, block)  # scale -> 0
        x[r == 1] = sub[r == 1] * 1e-38  # subnormal and normal entries
        x[r == 1, 0] = 1.5e-36
        x[r == 2] = torch.tensor([FMIN, -FMIN, BELOW, -BELOW,
                                  0.0])[torch.arange(block) % 5]
        x[r == 2, 0] = 127 * FMIN  # scale exactly FMIN
        # scale < 2**-128: 1 / scale would be inf, 0 * inf NaN
        x[r == 3] = sub[r == 3].clamp(-3, 3) * 1e-37
        x[r == 3, ::7] = 0.0
        x[r == 4] = sub[r == 4] * 1e-40  # subnormals only
        x[r == 5, ::5] *= 1e-39  # a normal row with subnormal entries
        x[r == 6] = -0.0
    else:
        x[rows // 2] = 0  # an all-zero row: scale 0, q 0
    return x


# (3392, 256): one ResNet56 update (868,123 parameters) padded to whole
# (8, 256) row tiles, the main path's qsgd shape; 3 x 3392 rows take more
# than one wave of warps
@pytest.mark.parametrize("rows,block,kind", [
    (3392, 256, "randn"), (8, 256, "randn"), (24, 128, "randn"),
    (8, 512, "randn"), (8, 1024, "randn"), (4, 2048, "randn"),
    (5, 100, "randn"), (16, 64, "randn"), (1, 1, "randn"),
    (3 * 3392, 256, "randn"), (3392, 256, "misaligned"),
    (24, 128, "misaligned"), (64, 256, "ties"), (64, 100, "ties"),
    (70, 256, "subnormal"), (70, 128, "subnormal"), (70, 100, "subnormal")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_matches_plain(cuda, rows, block, kind, dtype):
    g = torch.Generator(device="cpu").manual_seed(rows * 7 + block)
    aligned = kind != "misaligned"
    x = _on_card(_quantize_input(rows, block, kind, g), dtype, cuda, aligned)
    assert qz.fast_path(x, dtype) == _fast(block, dtype, aligned)
    before = qz.QUANTIZE_LAUNCHES
    q, s = qz.quantize_blocks(x)
    torch.cuda.synchronize()
    assert qz.QUANTIZE_LAUNCHES == before + 1
    pq, ps = qz.quantize_blocks_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    if kind in ("randn", "misaligned"):
        assert not q[rows // 2].any() and float(s[rows // 2]) == 0.0


@pytest.mark.parametrize("rows,block,kind", [
    (3392, 256, "rand"), (24, 128, "rand"), (5, 100, "rand"),
    (8, 512, "rand"), (8, 1024, "rand"), (4, 2048, "rand"),
    (16, 64, "rand"), (1, 1, "rand"), (3 * 3392, 256, "rand"),
    (3392, 256, "misaligned"), (24, 128, "misaligned"),
    (70, 256, "subnormal"), (70, 100, "subnormal")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequantize_matches_plain(cuda, rows, block, kind, dtype):
    g = torch.Generator(device="cpu").manual_seed(rows + block)
    aligned = kind != "misaligned"
    q = _on_card(torch.randint(-127, 128, (rows, block), generator=g,
                               dtype=torch.int8), torch.int8, cuda, aligned)
    s = torch.rand((rows, 1), generator=g)
    if kind == "subnormal":  # every 2nd scale subnormal, +-FMIN, +-0.0
        s[::2, 0] = torch.tensor([1e-40, FMIN, BELOW, -1e-40, 0.0, -0.0,
                                  2e-38, -FMIN, 1e-45])[
            torch.arange(0, rows, 2) % 9]
    s = s.to(cuda)
    assert qz.fast_path(q, dtype) == _fast(block, dtype, aligned)
    before = qz.DEQUANTIZE_LAUNCHES
    out = qz.dequantize_blocks(q, s, out_dtype=dtype)
    torch.cuda.synchronize()
    assert qz.DEQUANTIZE_LAUNCHES == before + 1 and out.dtype == dtype
    np.testing.assert_allclose(
        out.float().cpu().numpy(),
        qz.dequantize_blocks_plain(q, s, dtype).float().cpu().numpy(),
        rtol=1e-6)


# T < 4 (the tail alone), T % 4 != 0, and views offset by one element
# (not 16-byte aligned: the kernel's scalar loop)
@pytest.mark.parametrize("t,acc_off,x_off", [
    (868_123, 0, 0), (1, 0, 0), (255, 0, 0), (4097, 0, 0), (2, 0, 0),
    (3, 0, 0), (8, 0, 0), (1001, 0, 0), (868_123, 1, 1), (868_123, 0, 1),
    (1001, 1, 0), (3, 1, 1)])
def test_accumulate_matches_plain(cuda, t, acc_off, x_off):
    g = torch.Generator(device="cpu").manual_seed(t + 7 * acc_off + x_off)
    acc = torch.randn(t + acc_off, generator=g).to(cuda)[acc_off:]
    x = torch.randn(t + x_off, generator=g).to(cuda)[x_off:]
    before = fr.ACCUMULATE_LAUNCHES
    out = fr.fedavg_accumulate(acc, x, 0.37)
    torch.cuda.synchronize()
    assert fr.ACCUMULATE_LAUNCHES == before + 1
    want = fr.fedavg_accumulate_plain(acc, x, 0.37)
    assert out.shape == want.shape == (t,)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


def test_qsgd_flat_batch_on_card_matches_cpu(cuda):
    """The flat wrappers on the card give the CPU's wire bytes."""
    g = torch.Generator(device="cpu").manual_seed(3)
    flats = [torch.randn(n, generator=g) for n in (100, 2048, 6161)]
    want = ops.quantize_flat_batch(flats)
    got = ops.quantize_flat_batch([f.to(cuda) for f in flats])
    for a, b in zip(got, want):
        assert a["q"].tobytes() == b["q"].tobytes()
        assert a["scales"].tobytes() == b["scales"].tobytes()
    back = ops.dequantize_flat_batch(got, device=cuda)
    assert all(x.is_cuda for x in back)


def _topk_rows(b, t, dtype, seed):
    """(b, t) rows with |value| ties of both signs, +-0.0 and, for b > 1,
    an all-zero row (signed zeros only)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((b, t), generator=g)
    if t >= 8:
        x[:, 1] = -x[:, 0]
        x[:, 3] = x[:, 2]
        x[:, t // 2] = x[:, 0]
        x[:, -1] = -0.0
        x[:, -2] = 0.0
    if t >= 64:  # a run of equal magnitudes, both signs
        x[:, 8:40] = 0.125
        x[:, 20:30] *= -1
    if b > 1:
        x[1] = 0.0
        x[1, ::3] = -0.0
    return x.to(dtype)


def _same_topk(got, want):
    (gi, gv), (wi, wv) = got, want
    assert gi.dtype == torch.int32 and gv.dtype == torch.float32
    assert torch.equal(gi, wi)
    assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))


# (1, 4_375_723), k = 218_786: one Medium-tier (MobileNetV3) update at
# topk:0.05; (1, 868_123), k = 43_406: one Small-tier (ResNet56) update
@pytest.mark.parametrize("b,t,frac", [
    (1, 4_375_723, 0.05), (1, 868_123, 0.05), (3, 868_123, 0.05),
    (1, 1, 0.05), (3, 8, 0.05), (3, 1000, 0.05), (1, 4099, 0.05),
    (3, 65_537, 0.05), (3, 65_537, 1.0), (1, 1000, 1.0), (3, 4099, 0.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_matches_plain(cuda, b, t, frac, dtype):
    k = max(1, int(t * frac))
    x = _topk_rows(b, t, dtype, seed=b * 31 + t).to(cuda)
    before = tk.LAUNCHES
    got = tk.topk_rows(x, k)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == before + 1
    _same_topk(got, tk.topk_rows_plain(x, k))


def test_topk_all_equal_row(cuda):
    """Every key equal: the first k indices, in order."""
    x = torch.full((2, 10_000), -3.0, device=cuda)
    idx, vals = tk.topk_rows(x, 777)
    assert torch.equal(idx[0].long().cpu(), torch.arange(777))
    assert bool((vals == -3.0).all())


def _topk_sort_case(case, dtype):
    """Inputs that drive the multi-tile sort of the survivors: (x, k)."""
    g = torch.Generator(device="cpu").manual_seed(len(case))
    if case == "many-tiles":  # k not a multiple of the sort's tile
        x, k = torch.randn((1, 200_003), generator=g), 30_001
    elif case == "k=T":
        x, k = torch.randn((1, 65_537), generator=g), 65_537
    elif case.startswith("all-equal"):  # ties across every tile boundary
        x = torch.full((1, 1_000_000), 0.75)
        x[0, 1::2] = -0.75
        k = 1_000_000 if case.endswith("k=T") else 300_001
    elif case == "signed-zeros":  # the threshold is 0: +-0.0 tie
        x = torch.zeros((1, 50_000))
        x[0, 1::2] = -0.0
        x[0, ::97] = torch.randn(516, generator=g)
        k = 20_000
    else:  # "3-rows": three rows with different thresholds
        x = torch.randn((3, 100_000), generator=g)
        x[1] = (x[1] * 1e-3 * 64).round() / 64  # many ties
        x[2, ::2] = 0.0
        x[2, 1::4] = -0.0
        k = 40_000
    return x.to(dtype), k


@pytest.mark.parametrize("case", ["many-tiles", "k=T", "all-equal",
                                  "all-equal k=T", "signed-zeros", "3-rows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_sort_cases(cuda, case, dtype):
    x, k = _topk_sort_case(case, dtype)
    x = x.to(cuda)
    before = tk.LAUNCHES
    got = tk.topk_rows(x, k)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == before + 1
    _same_topk(got, tk.topk_rows_plain(x, k))


def test_topk_flat_batch_on_card_matches_cpu(cuda):
    """The codec's grouping on the card gives the CPU's payloads."""
    g = torch.Generator(device="cpu").manual_seed(5)
    flats = [torch.randn(n, generator=g) for n in (100, 5000, 5000, 64)]
    want = ops.topk_flat_batch(flats, k_frac=0.05)
    got = ops.topk_flat_batch([f.to(cuda) for f in flats], k_frac=0.05)
    for a, b in zip(got, want):
        assert a["n"] == b["n"] and a["idx"].is_cuda
        assert torch.equal(a["idx"].cpu(), b["idx"])
        assert torch.equal(a["vals"].cpu().view(torch.int32),
                           b["vals"].view(torch.int32))


def test_topk_rejects_wrong_dtype(cuda):
    with pytest.raises(TypeError):
        tk.topk_rows(torch.zeros((2, 8), dtype=torch.float16, device=cuda), 2)


# (5, 868_352), block 256: five ResNet56 updates, each 868,123 parameters
# padded to whole (8, 256) tiles by the qsgd wire
@pytest.mark.parametrize("n,t,block", [(5, 868_352, 256), (1, 256, 256),
                                       (3, 2048 + 256, 256), (5, 256, 128),
                                       (3, 2048 + 256, 128),
                                       (1, 868_352, 128)])
def test_q8_matches_plain(cuda, n, t, block):
    g = torch.Generator(device="cpu").manual_seed(n * 7 + t + block)
    q = torch.randint(-127, 128, (n, t), generator=g,
                      dtype=torch.int8).to(cuda)
    s = (torch.rand((n, t // block), generator=g) * 1e-2).to(cuda)
    w = torch.rand((n,), generator=g).to(cuda)
    w = w / w.sum()
    assert fr.q8_fast_path(q, block)  # block % 16 == 0, q aligned
    before = fr.Q8_LAUNCHES
    out = fr.fedavg_reduce_q8(q, s, w, block)
    torch.cuda.synchronize()
    assert fr.Q8_LAUNCHES == before + 1
    assert out.dtype == torch.float32 and out.shape == (t,)
    want = fr.fedavg_reduce_q8_plain(q, s, w, block)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


def test_fedavg_quantized_on_card_matches_cpu(cuda):
    from repro_torch.fl.aggregator import fedavg_quantized
    g = torch.Generator(device="cpu").manual_seed(6)
    trees = [{"w": torch.randn((37, 50), generator=g),
              "b": torch.randn((900,), generator=g)} for _ in range(3)]
    flats = [ops.flatten_pytree(t)[0] for t in trees]
    packed = ops.quantize_flat_batch(flats)
    _, unflatten = ops.flatten_pytree(trees[0])
    want, _ = fedavg_quantized(packed, [1, 2, 3], unflatten, device="cpu")
    _, cuda_unflatten = ops.flatten_pytree(
        {k: v.to(cuda) for k, v in trees[0].items()})
    got, _ = fedavg_quantized(packed, [1, 2, 3], cuda_unflatten)
    for k in want:
        assert got[k].is_cuda
        assert torch.equal(got[k].cpu().view(torch.int32),
                           want[k].view(torch.int32))


# -- the tree form of fedavg_reduce, and the flushes -----------------------

def _tiny(g, shape, device):
    """Both signs, magnitudes spanning 1e-46-1e-33, a few normal values."""
    mag = 10.0 ** (torch.rand(shape, generator=g) * 13 - 46)
    x = (mag * torch.randn(shape, generator=g).sign()).float()
    x.view(-1)[::97] = torch.randn(x.view(-1)[::97].shape, generator=g)
    return x.to(device)


def _model_leaves(model: str, device):
    """One full-width template tree's leaves (ResNet56: 169, MobileNetV3:
    151)."""
    from repro_torch import _tree
    from repro_torch.models.vision import (MobileNetConfig, MobileNetV3,
                                           ResNet, ResNetConfig)
    m = (ResNet(ResNetConfig(), device=device) if model == "resnet56"
         else MobileNetV3(MobileNetConfig(), device=device))
    return _tree.leaves(m.init(torch.Generator().manual_seed(0)))


def _clients(template, n, dtype, layout, kind, g, device):
    """n clients' leaves shaped like ``template``: separate tensors, or
    (layout "views") views of one flat vector at the leaves' running
    offsets, as the codecs decode them; random normal or (kind
    "subnormal") magnitudes across the subnormal range."""
    out = []
    for _ in range(n):
        sizes = [l.numel() for l in template]
        flat = (torch.randn(sum(sizes), generator=g) if kind == "randn"
                else _tiny(g, (sum(sizes),), "cpu")).to(device, dtype)
        if layout == "separate":
            out.append([p.clone().view(l.shape) for p, l in
                        zip(flat.split(sizes), template)])
        else:
            out.append([p.view(l.shape) for p, l in
                        zip(flat.split(sizes), template)])
    return out


def _hold_leaves(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("model", ["resnet56", "mobilenetv3"])
@pytest.mark.parametrize("n", [1, 5, 25])
@pytest.mark.parametrize("layout", ["separate", "views"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tree_kernel_matches_plain(cuda, model, n, layout, dtype):
    g = torch.Generator(device="cpu").manual_seed(n + len(model))
    template = _model_leaves(model, cuda)
    leaves = _clients(template, n, dtype, layout, "randn", g, cuda)
    if layout == "views":  # most leaves off 16-byte alignment
        assert any(l.data_ptr() % 16 for l in leaves[0])
    w = torch.rand((n,), generator=g) + 0.5
    w = (w / w.sum()).numpy()
    before = fr.LAUNCHES
    got = fr.fedavg_reduce_leaves(leaves, w)
    torch.cuda.synchronize()
    assert fr.LAUNCHES == before + 1
    _hold_leaves(got, fr.fedavg_reduce_leaves_plain(leaves, w))


@pytest.mark.parametrize("layout", ["separate", "views"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tree_kernel_flushes_subnormals(cuda, layout, dtype):
    g = torch.Generator(device="cpu").manual_seed(9)
    template = _model_leaves("resnet56", cuda)
    leaves = _clients(template, 5, dtype, layout, "subnormal", g, cuda)
    w = np.asarray([0.1, 0.2, 0.3, 0.15, 0.25], np.float32)
    got = fr.fedavg_reduce_leaves(leaves, w)
    _hold_leaves(got, fr.fedavg_reduce_leaves_plain(leaves, w))
    flat = torch.cat([a.reshape(-1) for a in got]).abs()
    assert not ((flat > 0) & (flat < FMIN)).any()
    assert (flat > 0).any()


def test_tree_kernel_c1_rows_and_partial_sums(cuda):
    """C1's rows give exact zeros; a subnormal partial sum is flushed
    before the next client's term, in client order."""
    x = torch.zeros((4, 1029))
    x[0], x[1] = 1e-30, 1e-39
    x[1:, 7] = torch.tensor([1.5 * FMIN, -FMIN, FMIN])
    leaves = [[r[:5].clone().to(cuda), r[5:].clone().to(cuda)] for r in x]
    w = np.asarray([2e-9, 1.0, 1.0, 1.0], np.float32)
    got = fr.fedavg_reduce_leaves(leaves, w)
    _hold_leaves(got, fr.fedavg_reduce_leaves_plain(leaves, w))
    assert float(got[1][2]) == FMIN
    assert not got[0].any() and int((got[1] != 0).sum()) == 1


def test_tree_kernel_is_deterministic(cuda):
    g = torch.Generator(device="cpu").manual_seed(3)
    template = _model_leaves("resnet56", cuda)
    leaves = _clients(template, 7, torch.float32, "views", "randn", g, cuda)
    w = np.full(7, 1 / 7, np.float32)
    _hold_leaves(fr.fedavg_reduce_leaves(leaves, w),
                 fr.fedavg_reduce_leaves(leaves, w))


def test_aggregate_on_card_takes_the_tree_form(cuda):
    """One launch per call, no stack: the result's leaves are views of one
    buffer on the card, in updates[0]'s dtypes."""
    g = torch.Generator(device="cpu").manual_seed(4)
    trees = [{"a": torch.randn((33, 7), generator=g),
              "b": torch.randn((5,), generator=g).to(torch.bfloat16)}
             for _ in range(4)]
    want = ops.fedavg_aggregate(trees, [1, 2, 3, 4])
    before = fr.LAUNCHES
    got = ops.fedavg_aggregate([{k: v.to(cuda) for k, v in t.items()}
                                for t in trees], [1, 2, 3, 4])
    torch.cuda.synchronize()
    assert fr.LAUNCHES == before + 1
    for k in want:
        assert got[k].is_cuda and got[k].dtype == want[k].dtype
        assert torch.equal(got[k].cpu().float().view(torch.int32),
                           want[k].float().view(torch.int32))


def test_tree_kernel_rejects_what_it_cannot_take(cuda):
    a = [torch.randn((4, 6), device=cuda), torch.randn(5, device=cuda)]
    b = [torch.randn((4, 6), device=cuda), torch.randn(5)]  # one on the host
    with pytest.raises(ValueError):
        fr.fedavg_reduce_leaves([a, b], [0.5, 0.5])
    c = [a[0].t().contiguous().t(), a[1]]  # not contiguous
    with pytest.raises(ValueError):
        fr.fedavg_reduce_leaves([a, c], [0.5, 0.5])
    with pytest.raises(TypeError):
        fr.fedavg_reduce_leaves([[l.half() for l in a]] * 2, [0.5, 0.5])


# block % 4 != 0, or q off 4-byte alignment: the general path
@pytest.mark.parametrize("n,t,block,offset", [
    (5, 868_352, 256, 0), (5, 868_352, 256, 1), (3, 2048 + 256, 128, 0),
    (3, 2000, 100, 0), (2, 63, 7, 0), (3, 2002, 2, 0), (1, 256, 16, 0),
    (4, 4096, 256, 2), (4, 4096, 256, 4)])
def test_q8_paths_match_plain(cuda, n, t, block, offset):
    g = torch.Generator(device="cpu").manual_seed(n + t + block + offset)
    buf = torch.randint(-127, 128, (n * t + offset,), generator=g,
                        dtype=torch.int8).to(cuda)
    q = buf[offset:].view(n, t)
    s = _tiny(g, (n, t // block), "cpu").abs().mul(1e4).to(cuda)
    s[:, ::3] = torch.rand(s[:, ::3].shape, generator=g).to(cuda) * 1e-2
    s[0, 0] = FMIN  # times w < 1: a subnormal product
    w = torch.rand((n,), generator=g).to(cuda)
    w = w / w.sum()
    fast = block % 4 == 0 and t % 4 == 0 and offset % 4 == 0
    assert fr.q8_fast_path(q, block) == fast
    out = fr.fedavg_reduce_q8(q, s, w, block)
    want = fr.fedavg_reduce_q8_plain(q, s, w, block)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    flat = out.abs()
    assert not ((flat > 0) & (flat < FMIN)).any()


def test_accumulate_flushes_subnormals(cuda):
    g = torch.Generator(device="cpu").manual_seed(11)
    for t, off in ((868_123, 0), (4097, 1)):
        acc = _tiny(g, (t + off,), cuda)[off:]
        x = _tiny(g, (t + off,), cuda)[off:]
        for w in (0.37, 1e-39, 1.0):
            out = fr.fedavg_accumulate(acc, x, w)
            want = fr.fedavg_accumulate_plain(acc, x, w)
            assert torch.equal(out.view(torch.int32), want.view(torch.int32))
            flat = out.abs()
            assert not ((flat > 0) & (flat < FMIN)).any()


def _window(n, w, g):
    """(n,) f32 whose products with the f32 ``w`` lie within 2**-21 of
    FLT_MIN, some in the window just below it that IEEE rounds up to
    FLT_MIN and XLA's flush (and the kernels' mul.rn.ftz.f32) makes 0."""
    target = FMIN * (1 + (torch.rand(n, generator=g, dtype=torch.float64)
                          * 2 - 1) * 2.0 ** -21)
    sign = torch.randint(0, 2, (n,), generator=g) * 2 - 1
    return (target / float(w) * sign).float()


def test_kernels_flush_in_the_rounding_window(cuda):
    """Products just below FLT_MIN: every kernel agrees with its plain
    version (``quantize.mul_ftz``'s rule) bit for bit."""
    g = torch.Generator(device="cpu").manual_seed(12)
    w = np.asarray([0.75, 0.25], np.float32)
    x = torch.stack([_window(4099, wi, g) for wi in w])
    leaves = [[r[:3].clone().to(cuda), r[3:].clone().to(cuda)] for r in x]
    got = fr.fedavg_reduce_leaves(leaves, w)
    want = fr.fedavg_reduce_leaves_plain(leaves, w)
    _hold_leaves(got, want)
    # products IEEE rounds up to FLT_MIN and the rule flushes
    assert ((x[0] * 0.75).abs().eq(FMIN)
            & qz.mul_ftz(x[0], 0.75).eq(0)).any()
    wd = torch.from_numpy(w).to(cuda)
    xs = x.to(cuda)
    out = fr.fedavg_reduce(xs, wd)
    assert torch.equal(out.view(torch.int32),
                       fr.fedavg_reduce_plain(xs, wd).view(torch.int32))
    acc = torch.zeros(4099, device=cuda)
    out = fr.fedavg_accumulate(acc, xs[0], 0.75)
    assert torch.equal(out.view(torch.int32), fr.fedavg_accumulate_plain(
        acc, xs[0], 0.75).view(torch.int32))
    q = torch.ones((2, 4096), dtype=torch.int8, device=cuda)
    s = torch.stack([_window(16, wi, g).abs() for wi in w]).to(cuda)
    for qq in (q, q.view(-1)[:8190].view(2, 4095)):  # both paths
        block = 256 if qq.shape[1] == 4096 else 273
        ss = s[:, :qq.shape[1] // block].contiguous()
        out = fr.fedavg_reduce_q8(qq.contiguous(), ss, wd, block)
        want = fr.fedavg_reduce_q8_plain(qq.contiguous(), ss, wd, block)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))


# Offsets past 2^31 bytes (the Large tier's stacked (5, 303,236,096) f32
# FedAvg input holds 6.1e9 bytes): each kernel path at a shape whose last
# element lies beyond a 32-bit index, bit for bit (dequantize at rtol 1e-6)
BIG = {"(N, T) rows": (3, 2 ** 28 + 5, 0),
       "tree form, one leaf": (2, 2 ** 29 + 3, 0),
       "q8 fast path": (3, 2 ** 30 + 8, 8),
       "q8 general path": (3, 3 * 357_913_944, 3),
       "quantize general path": (2 ** 31 // 1020 + 1, 255, 0),
       "dequantize general path": (2 ** 31 // 255 + 1, 255, 0)}


@pytest.mark.parametrize("case", list(BIG), ids=list(BIG))
def test_kernels_past_2_31_bytes(cuda, case):
    a, b, block = BIG[case]
    g = torch.Generator(device=cuda).manual_seed(a % 1000)
    if case == "(N, T) rows":
        x = torch.randn((a, b), generator=g, device=cuda)
        w = torch.tensor([0.5, 0.25, 0.25], device=cuda)
        got, want = fr.fedavg_reduce(x, w), fr.fedavg_reduce_plain(x, w)
    elif case == "tree form, one leaf":
        leaves = [[torch.randn(b, generator=g, device=cuda)]
                  for _ in range(a)]
        w = np.asarray([0.75, 0.25], np.float32)
        (got,), (want,) = (fr.fedavg_reduce_leaves(leaves, w),
                           fr.fedavg_reduce_leaves_plain(leaves, w))
    elif case.startswith("q8"):
        q = torch.randint(-127, 128, (a, b), generator=g, device=cuda,
                          dtype=torch.int8)
        s = torch.rand((a, b // block), generator=g, device=cuda)
        w = torch.full((a,), 1.0 / a, device=cuda)
        assert fr.q8_fast_path(q, block) == (case == "q8 fast path")
        got = fr.fedavg_reduce_q8(q, s, w, block)
        want = fr.fedavg_reduce_q8_plain(q, s, w, block)
    elif case == "quantize general path":
        x = torch.randn((a, b), generator=g, device=cuda)
        assert not qz.fast_path(x, torch.float32)
        got, want = qz.quantize_blocks(x), qz.quantize_blocks_plain(x)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        return
    else:
        q = torch.randint(-127, 128, (a, b), generator=g, device=cuda,
                          dtype=torch.int8)
        s = torch.rand((a, 1), generator=g, device=cuda)
        assert q.numel() >= 2 ** 31 and not qz.fast_path(q, torch.float32)
        got = qz.dequantize_blocks(q, s)
        want = qz.dequantize_blocks_plain(q, s)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
        return
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# The vertical path's messages (ROADMAP item 14), batch 16 of 16x16
# images: a ResNet56 activation after unit 1 or 2 is (16, 16, 16, 16) f32
# (after a ReLU) and its gradient the same shape, each quantised by
# ``qsgd:256`` as (256, 256); a MobileNetV3 activation after unit 2 is
# (16, 4, 4, 24), one row of 6,144 through ``topk_rows`` with k = 307
# (``topk:0.05``).
@pytest.mark.parametrize("message", ["activation", "gradient"])
def test_quantize_pair_at_activation_shapes(cuda, message):
    g = torch.Generator(device=cuda).manual_seed(18)
    x = torch.randn((16, 16, 16, 16), generator=g, device=cuda)
    x = torch.relu(x) if message == "activation" else x * 1e-4
    x = x.reshape(256, 256)
    assert qz.fast_path(x, torch.float32)
    before = (qz.QUANTIZE_LAUNCHES, qz.DEQUANTIZE_LAUNCHES)
    q, s = qz.quantize_blocks(x)
    out = qz.dequantize_blocks(q, s)
    assert (qz.QUANTIZE_LAUNCHES, qz.DEQUANTIZE_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    pq, ps = qz.quantize_blocks_plain(x)
    want = qz.dequantize_blocks_plain(q, s)
    torch.cuda.synchronize()
    assert torch.equal(q, pq) and torch.equal(s, ps)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_at_activation_shape(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(19)
    acts = torch.randn((16, 4, 4, 24), generator=g, device=cuda)
    x = acts.to(dtype).reshape(1, -1)
    k = max(1, int(x.shape[1] * 0.05))
    assert (x.shape[1], k) == (6_144, 307)
    before = tk.LAUNCHES
    idx, vals = tk.topk_rows(x, k)
    assert tk.LAUNCHES == before + 1
    pi, pv = tk.topk_rows_plain(x, k)
    torch.cuda.synchronize()
    assert torch.equal(idx, pi)
    assert torch.equal(vals.view(torch.int32), pv.view(torch.int32))
