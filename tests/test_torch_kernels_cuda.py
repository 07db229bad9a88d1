"""The hand-written Hopper ``fedavg_reduce`` against its plain PyTorch
version, on the card. This file imports no JAX: the machine with the
card has none. On a machine without a card every test skips.

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerance: both sides accumulate in f32 over the same products, in a
different order, so the reference bar (rtol 1e-4 / atol 1e-5) holds for
f32 and bf16 inputs alike.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fedavg_reduce as fr
from repro_torch.kernels import ops

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
