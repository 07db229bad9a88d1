"""The port's quantize / dequantize / accumulate paths against the JAX
reference, on the CPU.

The same numpy inputs go through the Pallas kernels (interpret mode, as
tests/test_kernels.py runs them), the jnp oracles and the port's plain
versions and flat wrappers. Bars are the reference's own
(tests/test_batched_codec.py, tests/test_kernels.py:21,
tests/test_fleet_scale.py:416): int8 bit-exact and scales within 1 ULP
(XLA turns the division ``amax / 127`` into a reciprocal multiply, the
port divides as the NumPy twin does), bf16 input within one int8 level,
dequantize rtol 1e-6, accumulate atol 1e-6.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import fedavg_reduce as jfr  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import quantize as jqz  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import fedavg_reduce as fr  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize as qz  # noqa: E402


def _rows(rng, rows, block, zero_row=True):
    x = (rng.normal(size=(rows, block)) * 3).astype(np.float32)
    if zero_row:
        x[rows // 2] = 0.0  # scale 0, q 0
    return x


@pytest.mark.parametrize("rows,block", [(8, 256), (16, 128), (64, 256),
                                        (24, 64)])
def test_quantize_plain_matches_reference(rows, block, rng):
    x = _rows(rng, rows, block)
    before = qz.QUANTIZE_LAUNCHES
    q, s = qz.quantize_blocks(torch.from_numpy(x))  # CPU: the plain version
    assert qz.QUANTIZE_LAUNCHES == before
    assert q.dtype == torch.int8 and tuple(q.shape) == (rows, block)
    assert s.dtype == torch.float32 and tuple(s.shape) == (rows, 1)
    for jq, js in (jqz.quantize_blocks(jnp.asarray(x), interpret=True),
                   jref.quantize_blocks_ref(jnp.asarray(x))):
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_almost_equal_nulp(s.numpy(), np.asarray(js),
                                                  nulp=1)
    qn, sn = jref.quantize_blocks_np(x)  # the same IEEE operations
    np.testing.assert_array_equal(q.numpy(), qn)
    np.testing.assert_array_equal(s.numpy(), sn)
    assert not q[rows // 2].any() and float(s[rows // 2]) == 0.0


def test_quantize_plain_bf16_within_one_level(rng):
    x = _rows(rng, 16, 256)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    q, s = qz.quantize_blocks_plain(xb)
    # both frameworks round f32 -> bf16 to nearest-even: identical inputs
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jq, js = jqz.quantize_blocks(jx, interpret=True)
    assert np.max(np.abs(q.numpy().astype(np.int32)
                         - np.asarray(jq).astype(np.int32))) <= 1
    np.testing.assert_array_almost_equal_nulp(s.numpy(), np.asarray(js),
                                              nulp=1)


@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_dequantize_plain_matches_reference(out, rng):
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[out]
    q = rng.integers(-127, 128, size=(16, 256)).astype(np.int8)
    s = np.abs(rng.normal(size=(16, 1))).astype(np.float32)
    before = qz.DEQUANTIZE_LAUNCHES
    got = qz.dequantize_blocks(torch.from_numpy(q), torch.from_numpy(s),
                               out_dtype=tdt)
    assert qz.DEQUANTIZE_LAUNCHES == before and got.dtype == tdt
    want = jqz.dequantize_blocks(jnp.asarray(q), jnp.asarray(s),
                                 out_dtype=jdt, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-6)


@pytest.mark.parametrize("block", [256, 128])
def test_quantize_flat_batch_matches_reference(block, rng):
    """Same padded lengths, row counts and orig_len as the reference: they
    are on the wire. int8 bit-exact, scales within 1 ULP, and the fused
    batch equals quantising item by item."""
    lengths = (100, 2048, 2048 * 3 + 17, 1)
    flats = [(rng.normal(size=n) * 3).astype(np.float32) for n in lengths]
    got = ops.quantize_flat_batch([torch.from_numpy(f) for f in flats],
                                  block=block)
    want = jops.quantize_flat_batch([jnp.asarray(f) for f in flats],
                                    block=block)
    for g, w, f in zip(got, want, flats):
        assert isinstance(g["q"], np.ndarray)  # the wire form is host data
        assert g["q"].shape == np.asarray(w["q"]).shape
        assert g["scales"].shape == np.asarray(w["scales"]).shape
        assert g["q"].size % (block * qz.ROW_TILE) == 0
        assert g["orig_len"] == w["orig_len"] == f.size
        assert g["block"] == w["block"] == block
        np.testing.assert_array_equal(g["q"], np.asarray(w["q"]))
        np.testing.assert_array_almost_equal_nulp(
            g["scales"], np.asarray(w["scales"]), nulp=1)
        single = ops.quantize_flat(torch.from_numpy(f), block=block)
        np.testing.assert_array_equal(single["q"].numpy(), g["q"])
        np.testing.assert_array_equal(single["scales"].numpy(), g["scales"])

    back = ops.dequantize_flat_batch(got, device="cpu")
    jback = jops.dequantize_flat_batch(want)
    for b, jb, f in zip(back, jback, flats):
        assert isinstance(b, torch.Tensor) and b.shape == (f.size,)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(f).max()))
        assert float(np.max(np.abs(b.numpy() - f))) <= \
            float(np.abs(f).max()) / 127.0  # half a level per row, at most


def test_dequantize_flat_batch_mixed_blocks_and_wire_input(rng):
    """Packed dicts as they come off a wire (numpy, read-only buffers,
    0-d arrays for block/orig_len) and mixed block sizes."""
    f = (rng.normal(size=3000)).astype(np.float32)
    a = ops.quantize_flat_batch([torch.from_numpy(f)], block=256)[0]
    b = ops.quantize_flat_batch([torch.from_numpy(f)], block=128)[0]
    wire = {"q": np.frombuffer(a["q"].tobytes(), np.int8),
            "scales": np.frombuffer(a["scales"].tobytes(), np.float32),
            "block": np.asarray(256), "orig_len": np.asarray(3000)}
    outs = ops.dequantize_flat_batch([wire, b], device="cpu")
    ja = jops.dequantize_flat(jops.quantize_flat(jnp.asarray(f), block=256))
    jb = jops.dequantize_flat(jops.quantize_flat(jnp.asarray(f), block=128))
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(ja), rtol=1e-6)
    np.testing.assert_allclose(outs[1].numpy(), np.asarray(jb), rtol=1e-6)


@pytest.mark.parametrize("t", [1024, 5000, 868_123 // 97])
def test_fedavg_accumulate_flat_matches_reference(t, rng):
    acc = rng.normal(size=t).astype(np.float32)
    x = rng.normal(size=t).astype(np.float32)
    w = 0.37
    before = fr.ACCUMULATE_LAUNCHES
    got = ops.fedavg_accumulate_flat(torch.from_numpy(acc),
                                     torch.from_numpy(x), w)
    assert fr.ACCUMULATE_LAUNCHES == before  # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (t,)
    accp, _ = jops._pad_to(jnp.asarray(acc), jfr.COL_TILE)
    xp, _ = jops._pad_to(jnp.asarray(x), jfr.COL_TILE)
    kern = jfr.fedavg_accumulate(accp, xp, w, interpret=True)[:t]
    for want in (kern, jref.fedavg_accumulate_ref(jnp.asarray(acc),
                                                  jnp.asarray(x), w)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_wrappers_reject_bad_input():
    with pytest.raises(ValueError):
        qz.quantize_blocks(torch.zeros(16))
    with pytest.raises(ValueError):
        qz.dequantize_blocks(torch.zeros((8, 4), dtype=torch.int8),
                             torch.zeros((4, 1)))
    with pytest.raises(ValueError):
        fr.fedavg_accumulate(torch.zeros(8), torch.zeros(9), 1.0)
