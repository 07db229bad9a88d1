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

Subnormals: XLA flushes them on the CPU, the TPU has none, and the port
flushes them by the rule in ``repro_torch/kernels/quantize.py``; on such
inputs the port matches the Pallas kernel and the jnp oracle bit for bit.
The reference's NumPy twin ``ref.quantize_blocks_np`` does not flush (a
reference-side inconsistency), so it is compared only on normal inputs.
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


FMIN = np.finfo(np.float32).tiny  # 2**-126
BELOW = np.nextafter(FMIN, np.float32(0))  # the largest subnormal


def _subnormal_rows(block):
    """(8, block) f32, one row per subnormal rule of the port's quantize."""
    x = np.zeros((8, block), np.float32)
    x[0] = np.linspace(-1e-36, 1e-36, block)  # amax < 127 * FMIN: scale 0
    x[1, :4] = [1.5e-36, 1.1e-38, -1.17e-38, -0.0]  # normal scale
    x[2, :5] = [127 * FMIN, FMIN, -FMIN, BELOW, -BELOW]  # scale == FMIN
    x[3, :3] = [np.nextafter(127 * FMIN, np.float32(0)), FMIN, -FMIN]
    x[4] = np.linspace(-1e-39, 1e-39, block)  # subnormals only
    x[5, :4] = [2e-37, 1e-37, -1e-38, 0.0]  # scale < 2**-128
    x[6, :4] = [1.0, FMIN, BELOW, -1e-40]  # a normal row
    x[7] = -0.0
    return x


def _rows(rng, rows, block, zero_row=True):
    x = (rng.normal(size=(rows, block)) * 3).astype(np.float32)
    if zero_row:
        x[rows // 2] = 0.0  # scale 0, q 0
    return x


@pytest.mark.parametrize("rows,block", [(8, 256), (16, 128), (64, 256),
                                        (24, 64), (8, 512), (8, 1024)])
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
    # the same IEEE operations; the NumPy twin does not flush subnormals
    # as XLA does (a reference-side inconsistency), and these inputs have
    # none
    qn, sn = jref.quantize_blocks_np(x)
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


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_subnormals_match_reference(dtype):
    """Subnormal inputs and scales flush as XLA flushes them: q and scales
    equal the Pallas kernel's and the oracle's bit for bit (the port used
    to give subnormal scales and q up to +-127 on these rows)."""
    x = _subnormal_rows(256)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    if dtype == "bf16":
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    q, s = qz.quantize_blocks(tx)
    for jq, js in (jqz.quantize_blocks(jx, interpret=True),
                   jref.quantize_blocks_ref(jx)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                      np.asarray(js).view(np.uint32))
    assert float(s[2]) == FMIN and not q[[0, 4, 5, 7]].any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_random_rows_across_subnormal_range(dtype, rng):
    """Rows whose magnitudes span 1e-46-1e-33, with signed zeros: q and
    scales equal the oracle's bit for bit; against the Pallas kernel q
    within one level and scales within 1 ULP (its reciprocal multiply, as
    on normal inputs)."""
    mag = 10.0 ** rng.uniform(-46, -33, size=(64, 1))
    x = (rng.normal(size=(64, 128)) * mag
         * 10.0 ** rng.uniform(-6, 0, size=(64, 128))).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = -0.0
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    if dtype == "bf16":
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    q, s = qz.quantize_blocks(tx)
    rq, rs = jref.quantize_blocks_ref(jx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(rs).view(np.uint32))
    kq, ks = jqz.quantize_blocks(jx, interpret=True)
    assert np.max(np.abs(q.numpy().astype(np.int32)
                         - np.asarray(kq).astype(np.int32))) <= 1
    np.testing.assert_array_almost_equal_nulp(s.numpy(), np.asarray(ks),
                                              nulp=1)
    assert (s.numpy() == 0).any() and (s.numpy() >= FMIN).any()


@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_dequantize_subnormal_scales_match_reference(out, rng):
    """A subnormal scale reads as a zero of its sign, as in XLA."""
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[out]
    q = rng.integers(-127, 128, size=(8, 256)).astype(np.int8)
    s = np.array([1e-40, FMIN, BELOW, 1e-45, 0.0, -0.0, -1e-40, 2e-38],
                 np.float32)[:, None]
    got = qz.dequantize_blocks(torch.from_numpy(q), torch.from_numpy(s),
                               out_dtype=tdt).float().numpy()
    for want in (jqz.dequantize_blocks(jnp.asarray(q), jnp.asarray(s),
                                       out_dtype=jdt, interpret=True),
                 jref.dequantize_blocks_ref(jnp.asarray(q), jnp.asarray(s),
                                            out_dtype=jdt)):
        np.testing.assert_array_equal(
            got.view(np.uint32),
            np.asarray(want.astype(jnp.float32)).view(np.uint32))
    assert not got[[0, 2, 3, 6]].any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_half_way_ties_round_to_even(dtype):
    """x * inv exactly k + 0.5 (scale 1 and 2: inv 1 and 0.5) rounds half
    to even, as jnp.round does; int8 and scales bit-exact."""
    k = np.arange(-126, 126, dtype=np.float32)
    x = np.zeros((8, 256), np.float32)
    x[0, :k.size], x[0, -1] = k + 0.5, 127.0  # scale 1
    x[1, :k.size], x[1, -1] = 2 * k + 1, -254.0  # scale 2
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    if dtype == "bf16":
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    q, s = qz.quantize_blocks(tx)
    assert s[0] == 1.0 and s[1] == 2.0
    np.testing.assert_array_equal(q[:2, :k.size].numpy(),
                                  np.stack([np.round(k + 0.5)] * 2))
    for jq, js in (jqz.quantize_blocks(jx, interpret=True),
                   jref.quantize_blocks_ref(jx)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
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


def test_quantize_flat_subnormal_row_wire_matches_reference(rng):
    """A flat vector with a row whose scale is subnormal before the flush:
    q and scales byte-identical to the reference's per-message encoder
    (``quantize_flat``); against its fused one (``quantize_flat_batch``)
    q byte-identical and that row's scale 0 in both, the normal rows'
    scales within 1 ULP (XLA may turn ``amax / 127`` into a reciprocal
    multiply)."""
    x = np.linspace(-1e-36, 1e-36, 256, dtype=np.float32)
    mixed = (rng.normal(size=3 * 2048 + 100) * 3).astype(np.float32)
    mixed[256:512] = x  # one such row among normal ones
    got = ops.quantize_flat_batch([torch.from_numpy(x),
                                   torch.from_numpy(mixed)])
    single = jops.quantize_flat(jnp.asarray(x))
    fused = jops.quantize_flat_batch([jnp.asarray(x), jnp.asarray(mixed)])
    assert got[0]["q"].tobytes() == np.asarray(single["q"]).tobytes()
    assert got[0]["scales"].tobytes() == \
        np.asarray(single["scales"]).tobytes()
    assert got[1]["q"].tobytes() == np.asarray(fused[1]["q"]).tobytes()
    np.testing.assert_array_almost_equal_nulp(
        got[1]["scales"], np.asarray(fused[1]["scales"]), nulp=1)
    assert got[1]["scales"][1] == fused[1]["scales"][1] == 0.0
    assert not got[1]["q"][256:512].any()


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
