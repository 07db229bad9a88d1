"""Port of ``src/repro/compression/stages.py``: payload-level and
wire-level codec adapters for the wire pipeline (core/channel.py).

A codec turns one payload (or wire) into a smaller one and back,
*invertibly*: the forward pass returns an ``info`` dict carrying
everything the receiver needs to reconstruct the original (tree
structure, original byte size), which the Channel records on the wire as
stage provenance. Error-feedback state (the QSGD residual) stays on the
*sender*; the decode side is stateless, so any receiver can decode any
wire.

Payload codecs handle all three payload flavours:

* ``TensorPayload``  -- real compression through the quantize kernels,
  optional error feedback (the residual lives on the update's device);
* ``VirtualPayload`` -- the byte count is scaled by the codec's wire ratio
  (paper-scale runs: identical accounting, no memcpy);
* ``PackedPayload``  -- already compressed: passed through untouched.

The receiver dequantises on its own device (the ``device`` its Channel
carries), through the dequantize kernel on a card. ``qsgd`` is ported;
``topk`` raises ``NotImplementedError`` until its kernel is (slice 3).
The byte-domain ``ZlibCodec`` / ``ZstdCodec`` are lossless and ride every
backend.

Simulated codec throughputs (``enc_bw`` / ``dec_bw``) are the
reference's modelling constants of the simulated clock, kept verbatim so
the clock matches the reference; they are not measurements of any card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.compression.qsgd import (QuantState, qsgd_compress,
                                          qsgd_compress_flat_batch)
from repro_torch.core.message import (PackedPayload, TensorPayload,
                                      VirtualPayload)
from repro_torch.kernels import ops

GB = 1024 ** 3

_LATER = ("the '{}' payload codec is not ported to repro_torch yet: it "
          "arrives with the top-k kernel in slice 3 (ROADMAP.md queue A, "
          "item 9)")


def tree_meta(tree):
    """Picklable structure record: (treedef, shapes, dtypes)."""
    leaves, treedef = _tree.flatten(tree)
    leaves = [torch.as_tensor(l) for l in leaves]
    return (treedef, [tuple(l.shape) for l in leaves],
            [l.dtype for l in leaves])


def unflatten_from_meta(vec, meta):
    """Inverse of ``ops.flatten_pytree`` driven by a ``tree_meta`` record
    (the closure returned by flatten_pytree cannot travel on a wire)."""
    treedef, shapes, dtypes = meta
    vec = torch.as_tensor(vec)
    out, off = [], 0
    for shape, dt in zip(shapes, dtypes):
        size = int(np.prod(shape)) if shape else 1
        out.append(vec[off:off + size].reshape(shape).to(dt))
        off += size
    return _tree.unflatten(treedef, out)


class BaseCodec:
    """compress(payload, state) -> (payload', new_state, info);
    decompress(payload', info) -> payload. ``info`` is wire provenance.

    ``domain`` marks where in the channel the codec acts: ``payload``
    codecs (qsgd/topk) need tensor semantics and run before the
    serializer; ``wire`` codecs (zlib-family) are byte transforms of the
    serialized wire and run after it (channel.WireCompressStage)."""

    name = "codec"
    domain = "payload"
    enc_bw = 2.0 * GB  # simulated compress throughput (bytes/s of input)
    dec_bw = 4.0 * GB  # simulated decompress throughput

    def signature(self) -> str:
        raise NotImplementedError

    def ratio(self) -> float:
        """Wire bytes per input byte (virtual-payload scaling)."""
        raise NotImplementedError

    def enc_time(self, orig_nbytes: int) -> float:
        return orig_nbytes / self.enc_bw

    def dec_time(self, orig_nbytes: int) -> float:
        return orig_nbytes / self.dec_bw

    # -- shared plumbing -------------------------------------------------
    def compress(self, payload, state=None
                 ) -> Tuple[object, object, Optional[dict]]:
        if isinstance(payload, PackedPayload):
            return payload, state, None  # already compressed: skip stage
        if isinstance(payload, VirtualPayload):
            nb = int(round(payload.nbytes * self.ratio()))
            out = VirtualPayload(nb, tag=f"{payload.tag}|{self.name}")
            return out, state, {"codec": self.name, "virtual": True,
                                "orig_nbytes": payload.nbytes,
                                "orig_tag": payload.tag}
        if isinstance(payload, TensorPayload):
            return self._compress_tree(payload, state)
        raise TypeError(f"{self.name}: cannot compress {type(payload)}")

    def decompress(self, payload, info, *, device=None):
        """``device``: where a real payload is reconstructed (the
        receiving Channel's device)."""
        if info is None:
            return payload
        if info.get("virtual"):
            return VirtualPayload(info["orig_nbytes"],
                                  tag=info.get("orig_tag", ""))
        return self._decompress_tree(payload, info, device)

    def init_state(self, payload):
        """Fresh error-feedback state for a tensor payload, on the
        payload's device (None = EF off or payload not a tensor)."""
        if isinstance(payload, TensorPayload):
            flat, _ = ops.flatten_pytree(payload.tree)
            return QuantState(error=torch.zeros_like(flat))
        return None

    def state_matches(self, state, payload) -> bool:
        """Does an existing residual fit this payload? (A peer stream can
        legally carry differently-shaped messages; feedback only composes
        across same-shaped ones.)"""
        if state is None or not isinstance(payload, TensorPayload):
            return False
        elems = sum(int(np.prod(tuple(np.shape(l))))
                    for l in _tree.leaves(payload.tree))
        return int(state.error.numel()) == elems

    # -- batched surface -------------------------------------------------
    def encode_batch(self, payloads, states):
        """[payload_i], [state_i] -> [(payload'_i, new_state_i, info_i)].

        The base implementation is the per-message loop, so every codec
        has the surface and ``compress`` is exactly ``encode_batch`` of
        one: same wire bytes, same info, same state transitions."""
        return [self.compress(p, s) for p, s in zip(payloads, states)]

    def decode_batch(self, payloads, infos, *, device=None):
        """[payload'_i], [info_i] -> [payload_i]; inverse of encode_batch
        (stateless, like ``decompress``)."""
        return [self.decompress(p, i, device=device)
                for p, i in zip(payloads, infos)]


class QsgdCodec(BaseCodec):
    """QSGD int8 block quantisation (Alistarh et al. 2017) behind the
    quantize kernel. Wire = int8 values + one f32 scale per block."""

    name = "qsgd"

    def __init__(self, block: int = 256):
        self.block = int(block)

    def signature(self) -> str:
        return f"qsgd(b{self.block})"

    def ratio(self) -> float:
        # f32 -> int8 (1/4) plus a 4-byte scale per `block` elements
        return 0.25 * (1.0 + 4.0 / self.block)

    def _info(self, payload: TensorPayload) -> dict:
        return {"codec": self.name, "orig_nbytes": payload.nbytes,
                "tree_meta": tree_meta(payload.tree)}

    def _compress_tree(self, payload: TensorPayload, state):
        packed, new_state, _ = qsgd_compress(payload.tree, state,
                                             block=self.block)
        return PackedPayload(packed), new_state, self._info(payload)

    def encode_batch(self, payloads, states):
        """Fused override: every TensorPayload in the batch is flattened
        into one (rows, block) device buffer and quantised by one kernel
        launch (kernels/ops.quantize_rows_batch); per-item wire bytes, info
        and error-feedback transitions are bit-identical to the
        per-message path. Non-tensor payloads fall through to the scalar
        rules in declaration order."""
        tensor_idx = [i for i, p in enumerate(payloads)
                      if isinstance(p, TensorPayload)]
        tensor_set = set(tensor_idx)
        out = [None] * len(payloads)
        for i, (p, s) in enumerate(zip(payloads, states)):
            if i not in tensor_set:
                out[i] = self.compress(p, s)
        if tensor_idx:
            flats = [ops.flatten_pytree(payloads[i].tree)[0]
                     for i in tensor_idx]
            packed, new_states = qsgd_compress_flat_batch(
                flats, [states[i] for i in tensor_idx], block=self.block)
            for i, pk, ns in zip(tensor_idx, packed, new_states):
                out[i] = (PackedPayload(pk), ns, self._info(payloads[i]))
        return out

    def _decompress_tree(self, payload: PackedPayload, info, device):
        return self.decode_batch([payload], [info], device=device)[0]

    def decode_batch(self, payloads, infos, *, device=None):
        """Fused inverse: one dequantize launch, on ``device``, for every
        packed tensor in the batch."""
        packed_idx = [i for i, (p, inf) in enumerate(zip(payloads, infos))
                      if inf is not None and not inf.get("virtual")
                      and isinstance(p, PackedPayload)]
        packed_set = set(packed_idx)
        out = [None] * len(payloads)
        for i, (p, inf) in enumerate(zip(payloads, infos)):
            if i not in packed_set:
                out[i] = self.decompress(p, inf, device=device)
        if packed_idx:
            flats = ops.dequantize_flat_batch(
                [payloads[i].packed for i in packed_idx], device=device)
            for i, flat in zip(packed_idx, flats):
                out[i] = TensorPayload(unflatten_from_meta(
                    flat, infos[i]["tree_meta"]))
        return out


class ZlibCodec(BaseCodec):
    """DEFLATE byte codec in the *wire* domain: compresses the serialized
    wire's actual buffers — payload semantics untouched, losslessly
    invertible from the wire's recorded provenance like every other
    stage. Real wires carry real deflated bytes; virtual (sized-only)
    wires scale by ``WIRE_RATIO``, a modelling constant for DEFLATE on
    fp32 weight streams."""

    name = "zlib"
    domain = "wire"
    enc_bw = 0.35 * GB  # single-stream DEFLATE-class throughputs
    dec_bw = 1.10 * GB
    WIRE_RATIO = 0.85

    def __init__(self, level: int = 6):
        self.level = int(level)
        if not 1 <= self.level <= 9:
            raise KeyError(f"zlib level must be in 1..9, got {self.level}")

    def signature(self) -> str:
        return f"zlib(l{self.level})"

    def ratio(self) -> float:
        return self.WIRE_RATIO

    # -- the byte transform (ZstdCodec overrides) ------------------------
    @property
    def impl(self) -> str:
        """Which byte transform actually runs (recorded as provenance so
        any receiver inverts by what the wire says, not what it has)."""
        return "zlib"

    def _deflate(self, raw: bytes) -> bytes:
        import zlib
        return zlib.compress(raw, self.level)

    @staticmethod
    def _inflate(data: bytes, info: dict) -> bytes:
        impl = info.get("impl", "zlib")
        if impl == "zlib":
            import zlib
            return zlib.decompress(data)
        if impl == "zstd":
            binding = zstd_binding()
            if binding is None:
                raise RuntimeError(
                    "wire records zstd-compressed buffers but neither "
                    "'zstandard' nor 'zstd' is importable here")
            return binding[1](data)
        raise KeyError(f"unknown wire-codec impl '{impl}'")

    # -- wire-domain API (channel.WireCompressStage) ---------------------
    def compress_wire(self, wire):
        """WireData -> (smaller WireData, provenance info)."""
        from repro_torch.core.serialization import WireData
        if wire.buffers is None:
            nb = int(round(wire.nbytes * self.ratio()))
            info = {"stage": "wirecodec", "codec": self.name,
                    "level": self.level, "orig_nbytes": wire.nbytes,
                    "virtual": True}
            return WireData(nbytes=nb, copied=True, obj=wire.obj,
                            codec=wire.codec), info
        bufs, metas = [], []
        for b in wire.buffers:
            if isinstance(b, (bytes, bytearray, memoryview)):
                raw, meta = bytes(b), None
            else:
                arr = np.ascontiguousarray(b)
                raw, meta = arr.tobytes(), (arr.shape, str(arr.dtype))
            bufs.append(self._deflate(raw))
            metas.append(meta)
        out = WireData(nbytes=sum(len(b) for b in bufs), buffers=bufs,
                       copied=True, obj=wire.obj, codec=wire.codec)
        info = {"stage": "wirecodec", "codec": self.name,
                "level": self.level, "impl": self.impl,
                "orig_nbytes": wire.nbytes, "buf_meta": metas}
        return out, info

    def decompress_wire(self, wire, info):
        """Inverse transform: reconstructs the original wire (buffer
        boundaries + array shapes/dtypes + the byte-transform impl ride
        in the provenance)."""
        from repro_torch.core.serialization import WireData
        if info.get("virtual"):
            return WireData(nbytes=info["orig_nbytes"], obj=wire.obj,
                            codec=wire.codec)
        bufs = []
        for b, meta in zip(wire.buffers, info["buf_meta"]):
            raw = self._inflate(b, info)
            if meta is None:
                bufs.append(raw)
            else:
                shape, dtype = meta
                bufs.append(np.frombuffer(raw, dtype=np.dtype(dtype))
                            .reshape(shape))
        return WireData(nbytes=info["orig_nbytes"], buffers=bufs,
                        copied=True, obj=wire.obj, codec=wire.codec)


def zstd_binding():
    """-> (compress(raw, level), decompress(data)) through whichever zstd
    python binding is importable, or None (the ZstdCodec then deflates
    with zlib and says so in provenance)."""
    try:
        import zstandard
        return (lambda raw, lvl: zstandard.ZstdCompressor(
                    level=lvl).compress(raw),
                lambda data: zstandard.ZstdDecompressor().decompress(data))
    except ImportError:
        pass
    try:
        import zstd as _zstd
        return (lambda raw, lvl: _zstd.compress(raw, lvl),
                lambda data: _zstd.decompress(data))
    except ImportError:
        return None


class ZstdCodec(ZlibCodec):
    """Real zstd frames when a binding (``zstandard`` or ``zstd``) is
    importable, else DEFLATE; provenance records which transform ran
    (``impl``), so a receiver with a different environment still inverts
    correctly. Simulated throughputs and the virtual wire ratio are fixed
    zstd-class modelling constants, independent of the binding."""

    name = "zstd"
    enc_bw = 1.5 * GB  # zstd-class single-stream throughputs
    dec_bw = 3.5 * GB
    WIRE_RATIO = 0.82

    def __init__(self, level: int = 3):
        self.level = int(level)
        if not 1 <= self.level <= 19:
            raise KeyError(f"zstd level must be in 1..19, got {self.level}")
        self._binding = zstd_binding()

    def signature(self) -> str:
        return f"zstd(l{self.level})"

    @property
    def impl(self) -> str:
        return "zstd" if self._binding is not None else "zlib"

    def _deflate(self, raw: bytes) -> bytes:
        if self._binding is not None:
            return self._binding[0](raw, self.level)
        import zlib
        return zlib.compress(raw, min(self.level, 9))


def make_codec(spec) -> Optional[BaseCodec]:
    """Parse a compression spec: None/'none' -> None, 'qsgd'/'qsgd:128'
    (block), 'zlib'/'zlib:9' or 'zstd'/'zstd:3' (wire domain, byte-codec
    level), or a BaseCodec instance. 'topk[:frac]' raises
    NotImplementedError until its kernel is ported."""
    if spec is None or isinstance(spec, BaseCodec):
        return spec
    spec = str(spec).strip().lower()
    if spec in ("", "none"):
        return None
    name, _, arg = spec.partition(":")
    if name == "qsgd":
        return QsgdCodec(block=int(arg)) if arg else QsgdCodec()
    if name == "topk":
        raise NotImplementedError(_LATER.format(name))
    if name == "zlib":
        return ZlibCodec(level=int(arg)) if arg else ZlibCodec()
    if name == "zstd":
        return ZstdCodec(level=int(arg)) if arg else ZstdCodec()
    raise KeyError(f"unknown compression spec '{spec}' (use none | "
                   "qsgd[:block] | topk[:frac] | zlib[:level] | "
                   "zstd[:level])")


def split_codecs(compression, wire_codec):
    """Normalise the two channel codec knobs into (payload_codec,
    wire_codec) instances — the ONE place the 'a byte codec named via
    ``compression`` belongs in the wire slot' rule lives (make_channel,
    make_backend and the scenario resolver all route through it).
    Raises ValueError when two *different* wire codecs are named."""
    codec = make_codec(compression)
    wcodec = make_codec(wire_codec)
    if codec is not None and getattr(codec, "domain", "payload") == "wire":
        if wcodec is not None and wcodec.signature() != codec.signature():
            raise ValueError(
                f"two wire codecs requested: compression="
                f"'{codec.signature()}' and wire_codec="
                f"'{wcodec.signature()}'")
        return None, codec
    return codec, wcodec


CODECS = {"qsgd": QsgdCodec, "zlib": ZlibCodec, "zstd": ZstdCodec}


def codec_for(name: str) -> BaseCodec:
    """Default-parameter codec instance for decode-side inversion (all
    decode parameters ride in the wire's stage info, so defaults are
    fine)."""
    if name == "topk":
        raise NotImplementedError(_LATER.format(name))
    return CODECS[name]()
