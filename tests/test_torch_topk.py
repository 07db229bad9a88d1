"""The port's top-k selection and top-k codec against the JAX reference,
on the CPU. The bar is the reference's own (tests/test_fleet_scale.py:338):
idx and vals bit-exact, |value| ties and signed zeros included.

* ``topk_rows_plain`` (and the ``topk_rows`` wrapper on a CPU tensor)
  against ``kernels/ref.py::topk_rows_ref`` and the Pallas ``topk_rows``
  in interpret mode. One difference is the reference's own: the Pallas
  kernel gathers the value as a masked sum, so a selected -0.0 comes back
  as +0.0, while the oracle and the codec path (which runs the oracle on
  the CPU) keep -0.0. Against the Pallas kernel vals are compared bit for
  bit everywhere else and as values there.
* ``topk_compress_flat_batch`` payloads and two rounds of error-feedback
  residuals, exactly (atol 0);
* ``TopkCodec.encode_batch`` with mixed tensor and virtual payloads, wire
  buffers byte-identical through the membuff and generic serializers;
* a top-k wire decoded on ``device="cpu"`` equals the reference's decode.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.compression import topk as jtopk  # noqa: E402
from repro.compression.qsgd import QuantState as JState  # noqa: E402
from repro.compression.stages import TopkCodec as JTopkCodec  # noqa: E402
from repro.core.channel import make_channel as jmake_channel  # noqa: E402
from repro.core.message import PackedPayload as JPacked  # noqa: E402
from repro.core.message import TensorPayload as JPayload  # noqa: E402
from repro.core.message import VirtualPayload as JVirtual  # noqa: E402
from repro.core.serialization import SERIALIZERS as JSER  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.topk import topk_rows as jax_topk  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.compression import topk  # noqa: E402
from repro_torch.compression.qsgd import QuantState  # noqa: E402
from repro_torch.compression.stages import TopkCodec, make_codec  # noqa: E402
from repro_torch.core.channel import make_channel  # noqa: E402
from repro_torch.core.message import (PackedPayload, TensorPayload,  # noqa: E402
                                      VirtualPayload)
from repro_torch.core.serialization import SERIALIZERS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import topk as tk  # noqa: E402


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _rows(rng, b, t):
    """(b, t) f32 with |value| ties of both signs, +0.0 and -0.0, and (for
    b > 1) an all-zero row."""
    x = rng.normal(size=(b, t)).astype(np.float32)
    x[:, 1] = -x[:, 0]  # tie, opposite sign
    x[:, min(3, t - 1)] = x[:, 2]  # tie, same sign
    x[:, t // 2] = x[:, 0]  # a later tie
    x[:, -1] = -0.0
    x[:, t - 2] = 0.0
    if t > 16:  # a run of equal magnitudes across the k-th place
        x[:, 8:16] = np.float32(0.125)
        x[:, 12:14] *= -1
    if b > 1:
        x[1] = 0.0
        x[1, ::3] = -0.0
    return x


def _ks(t):
    return sorted({1, max(1, int(0.05 * t)), t})


CASES = [(b, t, k) for b in (1, 3) for t in (8, 64, 1000) for k in _ks(t)]


@pytest.mark.parametrize("b,t,k", CASES)
def test_topk_rows_plain_matches_reference(b, t, k):
    x = _rows(np.random.default_rng(b * 1000 + t + k), b, t)
    idx, vals = tk.topk_rows_plain(torch.from_numpy(x), k)
    assert idx.dtype == torch.int32 and vals.dtype == torch.float32
    assert tuple(idx.shape) == tuple(vals.shape) == (b, k)
    ri, rv = jref.topk_rows_ref(jnp.asarray(x), k)
    assert np.array_equal(idx.numpy(), np.asarray(ri))
    assert np.array_equal(_bits(vals.numpy()), _bits(rv))
    pi, pv = jax_topk(jnp.asarray(x), k, interpret=True)
    assert np.array_equal(idx.numpy(), np.asarray(pi))
    pv = np.asarray(pv)
    neg0 = _bits(vals.numpy()) == np.int32(-2 ** 31)
    assert np.array_equal(_bits(vals.numpy())[~neg0], _bits(pv)[~neg0])
    assert np.array_equal(vals.numpy(), pv)  # -0.0 == +0.0 as values


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_topk_rows_wrapper_on_cpu_is_the_plain_version(dtype):
    x = _rows(np.random.default_rng(4), 3, 1000)
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)
    if dtype == "bf16":  # both round f32 -> bf16 to nearest-even
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    before = tk.LAUNCHES
    idx, vals = tk.topk_rows(tx, 50)
    assert tk.LAUNCHES == before  # no kernel launch off the card
    ri, rv = jref.topk_rows_ref(jx, 50)
    assert np.array_equal(idx.numpy(), np.asarray(ri))
    assert np.array_equal(_bits(vals.numpy()), _bits(rv))


@pytest.mark.parametrize("k", [0, 9])
def test_topk_rows_rejects_k_out_of_range(k):
    with pytest.raises(ValueError):
        tk.topk_rows(torch.zeros((2, 8)), k)


def _flats(rng):
    flats = [rng.normal(size=64).astype(np.float32) for _ in range(3)]
    flats.append(np.array([1.0, -1.0, 0.5, 0.5, 2.0, -2.0, -0.0, 0.25],
                          np.float32))
    flats.append(rng.normal(size=1000).astype(np.float32))
    return flats


def test_topk_compress_flat_batch_with_error_feedback_matches_reference(rng):
    """Mixed lengths (three (length, k) groups, one of three rows), two
    chained rounds: the second picks from the first round's residuals."""
    flats = _flats(rng)
    states = [QuantState(torch.zeros(f.size)) for f in flats]
    jstates = [JState(np.zeros(f.size, np.float32)) for f in flats]
    states[0] = jstates[0] = None  # error feedback off for one message
    for _ in range(2):
        got, states = topk.topk_compress_flat_batch(
            [torch.from_numpy(f) for f in flats], states, k_frac=0.2)
        want, jstates = jtopk.topk_compress_flat_batch(
            [jnp.asarray(f) for f in flats], jstates, k_frac=0.2)
        for g, w in zip(got, want):
            assert g["n"] == w["n"]
            assert np.array_equal(g["idx"].numpy(), np.asarray(w["idx"]))
            assert np.array_equal(_bits(g["vals"].numpy()),
                                  _bits(w["vals"]))
        assert states[0] is None and jstates[0] is None
        for s, js in zip(states[1:], jstates[1:]):
            assert isinstance(s.error, torch.Tensor)
            np.testing.assert_allclose(s.error.numpy(), np.asarray(js.error),
                                       atol=0)
            assert np.array_equal(_bits(s.error.numpy()), _bits(js.error))


def test_topk_batch_equals_per_message(rng):
    flats = _flats(rng)
    batch = ops.topk_flat_batch([torch.from_numpy(f) for f in flats],
                                k_frac=0.25)
    for f, p in zip(flats, batch):
        single, _, _ = topk.topk_compress({"x": torch.from_numpy(f)}, 0.25)
        assert torch.equal(p["idx"], single["idx"])
        assert np.array_equal(_bits(p["vals"].numpy()),
                              _bits(single["vals"].numpy()))
        assert topk.payload_nbytes(p) == jtopk.payload_nbytes(
            {k: np.asarray(v) for k, v in p.items() if k != "n"})


def _trees(rng):
    return [{"w": rng.normal(size=(8, 8)).astype(np.float32),
             "b": rng.normal(size=8).astype(np.float32)} for _ in range(3)]


def _wire_bytes(wire):
    return b"".join(
        bytes(b) if isinstance(b, (bytes, bytearray))
        else np.asarray(b).tobytes() for b in (wire.buffers or []))


@pytest.mark.parametrize("serializer", ["membuff", "generic"])
def test_codec_encode_batch_matches_reference(serializer, rng):
    trees = _trees(rng)
    payloads = [TensorPayload(_tree.map(torch.from_numpy, t)) for t in trees]
    payloads.insert(1, VirtualPayload(1 << 20, tag="v"))
    jpayloads = [JPayload(jax.tree.map(jnp.asarray, t)) for t in trees]
    jpayloads.insert(1, JVirtual(1 << 20, tag="v"))
    codec, jcodec = make_codec("topk:0.25"), JTopkCodec(0.25)
    assert codec.signature() == jcodec.signature()
    got = codec.encode_batch(payloads, [None] * len(payloads))
    want = jcodec.encode_batch(jpayloads, [None] * len(jpayloads))
    per_msg = [codec.compress(p, None) for p in payloads]
    for (gp, gs, gi), (wp, ws, wi), (sp, _, si) in zip(got, want, per_msg):
        assert gs is None and ws is None
        assert gp.nbytes == wp.nbytes == sp.nbytes
        if isinstance(gp, VirtualPayload):
            assert gi == wi == si
            continue
        assert isinstance(gp, PackedPayload)
        assert gi["orig_nbytes"] == wi["orig_nbytes"] == si["orig_nbytes"]
        assert gi["tree_meta"] == si["tree_meta"]
        assert gp.packed["n"] == wp.packed["n"]
        tw = SERIALIZERS[serializer].serialize(PackedPayload(dict(gp.packed)))
        jw = JSER[serializer].serialize(JPacked(dict(wp.packed)))
        sw = SERIALIZERS[serializer].serialize(PackedPayload(dict(sp.packed)))
        assert tw.nbytes == jw.nbytes == sw.nbytes
        assert _wire_bytes(tw) == _wire_bytes(jw) == _wire_bytes(sw)


def test_codec_error_feedback_state_stays_on_the_update_device(rng):
    tree = _tree.map(torch.from_numpy, _trees(rng)[0])
    codec = TopkCodec(0.25)
    state = codec.init_state(TensorPayload(tree))
    _, new_state, _ = codec.compress(TensorPayload(tree), state)
    assert isinstance(new_state.error, torch.Tensor)
    assert new_state.error.device.type == "cpu"
    assert codec.state_matches(new_state, TensorPayload(tree))
    # the residual is the update with the selected entries zeroed
    assert int((new_state.error == 0).sum()) >= int(72 * 0.25)


@pytest.mark.parametrize("name", ["membuff", "generic"])
def test_topk_wire_decodes_on_cpu_like_the_reference(name, rng):
    tree = _trees(rng)[0]
    tree["b"][2] = -0.0
    ch = make_channel(name, compression="topk:0.3", device="cpu")
    jch = jmake_channel(name, compression="topk:0.3")
    wire = ch.encode(TensorPayload(_tree.map(torch.from_numpy, tree)),
                     peer="s").wire
    jwire = jch.encode(JPayload(jax.tree.map(jnp.asarray, tree)),
                       peer="s").wire
    assert wire.nbytes == jwire.nbytes
    got, _ = ch.decode(wire)
    want, _ = jch.decode(jwire)
    assert isinstance(got, TensorPayload)
    for k in tree:
        leaf = got.tree[k]
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"
        assert leaf.dtype == torch.float32
        assert np.array_equal(_bits(leaf.numpy()),
                              _bits(np.asarray(want.tree[k])))
    # and the module-level inverse of one payload
    payload, _, unflatten = topk.topk_compress(
        _tree.map(torch.from_numpy, tree), 0.3)
    jpayload, _, junflatten = jtopk.topk_compress(
        jax.tree.map(jnp.asarray, tree), 0.3)
    dense = topk.topk_decompress(payload, unflatten, device="cpu")
    jdense = jtopk.topk_decompress(jpayload, junflatten)
    for k in tree:
        assert np.array_equal(dense[k].numpy(), np.asarray(jdense[k]))
