"""The port's qsgd codec and streaming accumulator against the JAX
reference, on the CPU.

* ``qsgd_compress_flat_batch`` with error feedback, fed the same flats and
  the same residuals: ``q`` byte-identical, scales within 1 ULP (see
  test_torch_quantize.py), new residuals within 1e-6;
* ``QsgdCodec.encode_batch`` equals the per-message loop (wire bytes,
  info, error-feedback state);
* the wires of one ``PackedPayload`` are byte-identical in both packages;
* a qsgd wire decodes on the receiving Channel's device;
* ``StreamingAccumulator.merged`` equals the reference's within 1e-6.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.compression import qsgd as jqsgd  # noqa: E402
from repro.core.channel import make_channel as jmake_channel  # noqa: E402
from repro.core.message import PackedPayload as JPacked  # noqa: E402
from repro.core.message import TensorPayload as JPayload  # noqa: E402
from repro.core.serialization import SERIALIZERS as JSER  # noqa: E402
from repro.fl.aggregator import StreamingAccumulator as JAcc  # noqa: E402
from repro.fl.scheduler import UpdateRecord as JRecord  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.compression import qsgd  # noqa: E402
from repro_torch.compression.stages import QsgdCodec, make_codec  # noqa: E402
from repro_torch.core.channel import make_channel  # noqa: E402
from repro_torch.core.message import (PackedPayload, TensorPayload,  # noqa: E402
                                      VirtualPayload)
from repro_torch.core.serialization import SERIALIZERS  # noqa: E402
from repro_torch.fl.aggregator import StreamingAccumulator  # noqa: E402
from repro_torch.fl.scheduler import UpdateRecord  # noqa: E402


def _trees(rng, n=3):
    return [{"w": rng.normal(size=(16 + i, 64)).astype(np.float32),
             "b": rng.normal(size=16 + i).astype(np.float32)}
            for i in range(n)]


def _torch_tree(tree):
    return _tree.map(lambda a: torch.from_numpy(a.copy()), tree)


def _wire_bytes(wire):
    return b"".join(
        bytes(b) if isinstance(b, (bytes, bytearray))
        else np.asarray(b).tobytes() for b in (wire.buffers or []))


@pytest.mark.parametrize("block", [256, 128])
def test_compress_flat_batch_with_error_feedback_matches_reference(block,
                                                                   rng):
    """Two chained rounds: the first from fresh (and absent) residuals,
    the second from the first round's residuals, fed to both packages as
    the same numpy arrays."""
    lengths = (3000, 2048, 517)
    errors = [None, np.zeros(2048, np.float32),
              (rng.normal(size=517) * 0.01).astype(np.float32)]
    for _ in range(2):
        flats = [rng.normal(size=n).astype(np.float32) for n in lengths]
        got, gstates = qsgd.qsgd_compress_flat_batch(
            [torch.from_numpy(f) for f in flats],
            [None if e is None else qsgd.QuantState(torch.from_numpy(e))
             for e in errors], block=block)
        want, wstates = jqsgd.qsgd_compress_flat_batch(
            [jnp.asarray(f) for f in flats],
            [None if e is None else jqsgd.QuantState(jnp.asarray(e))
             for e in errors], block=block)
        for g, w in zip(got, want):
            assert g["q"].tobytes() == np.asarray(w["q"]).tobytes()
            np.testing.assert_array_almost_equal_nulp(
                g["scales"], np.asarray(w["scales"]), nulp=1)
            assert g["orig_len"] == w["orig_len"]
        assert gstates[0] is None and wstates[0] is None
        for gs, ws in zip(gstates[1:], wstates[1:]):
            assert isinstance(gs.error, torch.Tensor)
            np.testing.assert_allclose(gs.error.numpy(),
                                       np.asarray(ws.error), atol=1e-6)
        errors = [None] + [s.error.numpy().copy() for s in gstates[1:]]


def test_tree_level_compress_and_decompress_match_reference(rng):
    """``qsgd_init``/``qsgd_compress``/``qsgd_decompress`` and
    ``quantize_pytree`` on one tree: the same q, wire size and
    reconstruction as the reference, leaf for leaf."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops

    tree = _trees(rng, 1)[0]
    jtree = jax.tree.map(jnp.asarray, tree)
    state, jstate = qsgd.qsgd_init(_torch_tree(tree)), jqsgd.qsgd_init(jtree)
    assert tuple(state.error.shape) == tuple(jstate.error.shape)
    packed, new_state, unflatten = qsgd.qsgd_compress(_torch_tree(tree),
                                                      state, block=128)
    jpacked, jnew_state, junflatten = jqsgd.qsgd_compress(jtree, jstate,
                                                          block=128)
    assert packed["q"].tobytes() == np.asarray(jpacked["q"]).tobytes()
    assert qsgd.packed_nbytes(packed) == jqsgd.packed_nbytes(jpacked)
    np.testing.assert_allclose(new_state.error.numpy(),
                               np.asarray(jnew_state.error), atol=1e-6)
    got = qsgd.qsgd_decompress(packed, unflatten, device="cpu")
    want = jqsgd.qsgd_decompress(jpacked, junflatten)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)
    pp, _ = ops.quantize_pytree(_torch_tree(tree))
    jpp, _ = jops.quantize_pytree(jtree)
    assert pp["q"].numpy().tobytes() == np.asarray(jpp["q"]).tobytes()


def test_codec_encode_batch_equals_per_message(rng):
    trees = _trees(rng)
    codec = QsgdCodec(block=128)
    payloads = [TensorPayload(_torch_tree(t)) for t in trees]
    states = [None] + [codec.init_state(p) for p in payloads[1:]]
    batch = codec.encode_batch(payloads, states)
    for (bp, bs, binfo), p, s in zip(batch, payloads, states):
        sp, ss, sinfo = codec.compress(p, s)
        assert isinstance(bp, PackedPayload)
        assert bp.nbytes == sp.nbytes
        for k in ("q", "scales"):
            assert bp.packed[k].tobytes() == sp.packed[k].tobytes()
        assert binfo["orig_nbytes"] == sinfo["orig_nbytes"] == p.nbytes
        assert binfo["tree_meta"] == sinfo["tree_meta"]
        if s is None:
            assert bs is None and ss is None
        else:
            assert torch.equal(bs.error, ss.error)
            assert codec.state_matches(bs, p)


@pytest.mark.parametrize("name", ["membuff", "tensor_rpc", "generic"])
def test_packed_wire_byte_identical(name, rng):
    """One PackedPayload, serialized by each package: the same bytes."""
    tree = _trees(rng, 1)[0]
    enc = make_channel("membuff", compression="qsgd").encode(
        TensorPayload(_torch_tree(tree)))
    packed = SERIALIZERS["membuff"].deserialize(enc.wire).packed
    tw = SERIALIZERS[name].serialize(PackedPayload(dict(packed)))
    jw = JSER[name].serialize(JPacked(dict(packed)))
    assert tw.nbytes == jw.nbytes
    assert _wire_bytes(tw) == _wire_bytes(jw)
    # and the reference's own encode of the same tree: same q, same sizes
    jenc = jmake_channel("membuff", compression="qsgd").encode(
        JPayload(jax.tree.map(jnp.asarray, tree)))
    assert enc.wire.nbytes == jenc.wire.nbytes
    assert np.asarray(enc.wire.buffers[0]).tobytes() == \
        np.asarray(jenc.wire.buffers[0]).tobytes()


def test_qsgd_wire_decodes_on_the_channel_device(rng):
    """Decode dequantises on the receiving Channel's device (the CPU
    here: the plain version) and rebuilds the tree's shapes and dtypes;
    a plain tensor wire is copied onto that device too."""
    tree = _trees(rng, 1)[0]
    ch = make_channel("generic", compression=make_codec("qsgd"),
                      device="cpu")
    payload, _ = ch.decode(ch.encode(TensorPayload(_torch_tree(tree)),
                                     peer="s").wire)
    assert isinstance(payload, TensorPayload)
    for k in tree:
        leaf = payload.tree[k]
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"
        assert tuple(leaf.shape) == tree[k].shape
        assert leaf.dtype == torch.float32
        assert float((leaf - torch.from_numpy(tree[k])).abs().max()) <= \
            float(np.abs(tree[k]).max()) / 127.0
    plain = make_channel("generic", device="cpu")
    [(p2, _)] = plain.decode_batch([plain.encode(
        TensorPayload(_torch_tree(tree))).wire])
    assert all(isinstance(l, torch.Tensor) for l in _tree.leaves(p2.tree))
    # no device: the card, resolved at the first real payload; a virtual
    # payload needs none
    card = make_channel("generic", compression=make_codec("qsgd"))
    v, _ = card.decode(card.encode(VirtualPayload(4096, tag="v")).wire)
    assert isinstance(v, VirtualPayload) and card.device is None
    wire = card.encode(TensorPayload(_torch_tree(tree)), peer="s").wire
    if torch.cuda.is_available():
        p3, _ = card.decode(wire)
        assert all(l.is_cuda for l in _tree.leaves(p3.tree))
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            card.decode(wire)


def test_error_feedback_state_lives_on_the_update_device(rng):
    tree = _torch_tree(_trees(rng, 1)[0])
    codec = QsgdCodec()
    state = codec.init_state(TensorPayload(tree))
    assert isinstance(state.error, torch.Tensor) and not state.error.any()
    _, new_state, _ = codec.compress(TensorPayload(tree), state)
    assert new_state.error.device == _tree.leaves(tree)[0].device
    assert codec.state_matches(new_state, TensorPayload(tree))
    assert not codec.state_matches(new_state, TensorPayload({"x": tree["b"]}))


def test_streaming_accumulator_merged_matches_reference(rng):
    shape_tree = _trees(rng, 1)[0]
    trees = [_tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                       shape_tree) for _ in range(4)]
    weights = [64.0, 32.0, 128.0, 16.0]
    alphas = [1.0, 0.5 ** 0.5, 1.0, 1.0 / 3.0]
    acc, jacc = StreamingAccumulator(), JAcc()
    for t, w, a in zip(trees, weights, alphas):
        acc.fold(UpdateRecord(None, TensorPayload(_torch_tree(t)), w, 0, 0,
                              0.0), a)
        jacc.fold(JRecord(None, JPayload(jax.tree.map(jnp.asarray, t)), w,
                          0, 0, 0.0), a)
    assert acc.count == jacc.count == 4
    assert acc.sum_eff == jacc.sum_eff and acc.sum_weight == jacc.sum_weight
    got, _ = acc.merged()
    want, _ = jacc.merged()
    for k in shape_tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6)
    acc.reset()
    assert acc.acc is None and acc.merged() == (None, 0.0)
