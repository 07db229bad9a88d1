"""The hand-written Hopper kernels against their plain PyTorch versions,
on the card. This file imports no JAX: the machine with the card has
none. On a machine without a card every test skips.

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances:
* ``fedavg_reduce``: both sides accumulate in f32 over the same products,
  in a different order, so the reference bar (rtol 1e-4 / atol 1e-5)
  holds for f32 and bf16 inputs alike;
* ``quantize_blocks``: the kernel and the plain version take the same IEEE
  operations on the same card, so int8 and scales are bit-exact;
* ``dequantize_blocks``: rtol 1e-6 (one rounded product each);
* ``fedavg_accumulate``: atol 1e-6 (the reference's bar; both round the
  product and then the sum).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fedavg_reduce as fr
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as qz

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
    np.testing.assert_allclose(out.cpu().numpy(),
                               fr.fedavg_reduce_plain(x, w).cpu().numpy(),
                               rtol=1e-4, atol=1e-5)


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
    np.testing.assert_allclose(got["w"].cpu().numpy(), want["w"].numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["b"][0].cpu().numpy(),
                               want["b"][0].numpy(), rtol=1e-4, atol=1e-5)


def test_kernel_rejects_wrong_dtype(cuda):
    with pytest.raises(TypeError):
        fr.fedavg_reduce(torch.zeros((2, 8), dtype=torch.float16,
                                     device=cuda),
                         torch.ones(2, device=cuda))


# (3392, 256): one ResNet56 update (868,123 parameters) padded to whole
# (8, 256) row tiles, the main path's qsgd shape
@pytest.mark.parametrize("rows,block", [(3392, 256), (8, 256), (24, 128),
                                        (5, 100), (1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_matches_plain(cuda, rows, block, dtype):
    g = torch.Generator(device="cpu").manual_seed(rows * 7 + block)
    x = (torch.randn((rows, block), generator=g) * 3).to(cuda, dtype)
    x[rows // 2] = 0  # an all-zero row: scale 0, q 0
    before = qz.QUANTIZE_LAUNCHES
    q, s = qz.quantize_blocks(x)
    torch.cuda.synchronize()
    assert qz.QUANTIZE_LAUNCHES == before + 1
    pq, ps = qz.quantize_blocks_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    assert not q[rows // 2].any() and float(s[rows // 2]) == 0.0


@pytest.mark.parametrize("rows,block", [(3392, 256), (24, 128), (5, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequantize_matches_plain(cuda, rows, block, dtype):
    g = torch.Generator(device="cpu").manual_seed(rows + block)
    q = torch.randint(-127, 128, (rows, block), generator=g,
                      dtype=torch.int8).to(cuda)
    s = torch.rand((rows, 1), generator=g).to(cuda)
    before = qz.DEQUANTIZE_LAUNCHES
    out = qz.dequantize_blocks(q, s, out_dtype=dtype)
    torch.cuda.synchronize()
    assert qz.DEQUANTIZE_LAUNCHES == before + 1 and out.dtype == dtype
    np.testing.assert_allclose(
        out.float().cpu().numpy(),
        qz.dequantize_blocks_plain(q, s, dtype).float().cpu().numpy(),
        rtol=1e-6)


@pytest.mark.parametrize("t", [868_123, 1, 255, 4097])
def test_accumulate_matches_plain(cuda, t):
    g = torch.Generator(device="cpu").manual_seed(t)
    acc = torch.randn(t, generator=g).to(cuda)
    x = torch.randn(t, generator=g).to(cuda)
    before = fr.ACCUMULATE_LAUNCHES
    out = fr.fedavg_accumulate(acc, x, 0.37)
    torch.cuda.synchronize()
    assert fr.ACCUMULATE_LAUNCHES == before + 1
    np.testing.assert_allclose(
        out.cpu().numpy(),
        fr.fedavg_accumulate_plain(acc, x, 0.37).cpu().numpy(), atol=1e-6)


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
