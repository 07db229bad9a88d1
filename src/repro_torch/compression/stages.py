"""Port of ``src/repro/compression/stages.py``, limited to what the sync
round reaches.

Codec adapters for the wire pipeline (core/channel.py). ``make_backend``
and ``CompressStage`` call ``make_codec`` / ``split_codecs`` on every
backend, and the byte-domain ``ZlibCodec`` / ``ZstdCodec`` are lossless,
so they ride sync rounds (``--compression zlib``). The payload codecs
(``qsgd`` int8 blocks, ``topk`` sparsification) need the quantize and
top-k kernels; naming one raises ``NotImplementedError`` rather than
silently sending uncompressed payloads.

A codec turns one wire into a smaller one and back, *invertibly*: the
forward pass returns an ``info`` dict carrying everything the receiver
needs to reconstruct the original, which the Channel records on the wire
as stage provenance. Decode is stateless, so any receiver can decode any
wire.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import _tree

GB = 1024 ** 3

_LATER = ("the '{}' payload codec is not ported to repro_torch yet: it "
          "arrives with the event-driven runtime and codec slice "
          "(ROADMAP.md queue A, items 8-9)")


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
    """``domain`` marks where in the channel the codec acts: ``payload``
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
    """Parse a compression spec: None/'none' -> None, 'zlib'/'zlib:9' or
    'zstd'/'zstd:3' (wire domain, byte-codec level), or a BaseCodec
    instance. 'qsgd[:block]' and 'topk[:frac]' raise NotImplementedError
    until their kernels are ported."""
    if spec is None or isinstance(spec, BaseCodec):
        return spec
    spec = str(spec).strip().lower()
    if spec in ("", "none"):
        return None
    name, _, arg = spec.partition(":")
    if name in ("qsgd", "topk"):
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


CODECS = {"zlib": ZlibCodec, "zstd": ZstdCodec}


def codec_for(name: str) -> BaseCodec:
    """Default-parameter codec instance for decode-side inversion (all
    decode parameters ride in the wire's stage info, so defaults are
    fine)."""
    if name in ("qsgd", "topk"):
        raise NotImplementedError(_LATER.format(name))
    return CODECS[name]()
