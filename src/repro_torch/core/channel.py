"""Port of ``src/repro/core/channel.py``
(copied; imports re-pointed, and a ``device`` for the receive path
added).

ChannelStack: the composable wire pipeline every backend drives.

A ``Channel`` owns an ordered stack of ``WireStage`` objects and exposes a
single ``encode`` / ``decode`` pair. Backends no longer call serializers
directly — the three formerly copy-pasted serialize paths
(``CommBackend.isend``, ``CommBackend._broadcast_transfers``,
``GrpcS3Backend._upload``) all drive the same stack, which is the
insertion point the repo lacked for gradient compression and chunked
pipelining (paper: compression is orthogonal to backend choice, QSGD /
Alistarh et al. 2017; survey arXiv:2405.20431 frames transport and
compression as separable, composable layers).

Stages and the domains they act on:

* ``CompressStage``   (payload domain) — wraps a ``compression.stages``
  codec (qsgd / topk) with per-peer error-feedback state. Quantisation
  needs tensor semantics (and the EF residual), so it transforms the
  *payload* before serialization. Charges simulated codec time plus the
  materialised compressed buffer's exact bytes.
* ``SerializeStage``  (payload -> wire) — the per-backend serializer
  (copy vs zero-copy view); charges the serializer's calibrated
  throughput on the bytes it actually writes (post-compression).
* ``WireCompressStage`` (wire domain) — a byte codec (zlib-family) over
  the serialized wire itself: lossless, stateless, composable with the
  payload codecs; deflates real buffers for real and scales virtual
  wires by the codec's modelled ratio.
* ``ChunkStage``      (wire domain) — splits large wires into fixed-size
  chunks so encode overlaps the network transfer; the transport delivers
  chunk-granularly (transport.Fabric.deliver_chunked) and backends
  pipeline chunk i's transfer behind chunk i-1's.

The port adds one thing to the reference's stack: a Channel has a
``device``, and decode reconstructs real payloads on it: a qsgd wire is
dequantised there (through the kernel on a card) and a plain tensor wire
is copied there, so what a receiver hands to FedAvg or the streaming
accumulator already lies on the deployment's device. A Channel given no
device uses the card, resolved when the first real payload decodes, so
virtual (sized-only) runs need no card; ``device="cpu"`` is the explicit
way to decode onto the host.

Encode applies payload-domain stages, then the serialize stage, then wire
stages; decode inverts the provenance recorded on ``WireData.stages``
right-to-left, so a receiver decodes by *what the wire says was done to
it*, never by its own configuration (AUTO routing, mixed fleets, and the
object store all stay coherent). With the default ``[SerializeStage]``
stack every byte and every simulated second is identical to the
pre-stack code — regression-tested.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch import _tree
from repro_torch._device import resolve_device
from repro_torch.core.message import PackedPayload, TensorPayload
from repro_torch.core.serialization import (BaseSerializer, SERIALIZERS, WireData,
                                      decode_wire)

MB = 1024 ** 2


@dataclasses.dataclass
class Encoded:
    """Result of one ``Channel.encode``: the final wire plus the stack's
    itemised simulated-time / memory charges."""
    wire: WireData
    cost_s: float  # total sender-side encode time (all stages)
    extra_alloc: int = 0  # stage-materialised bytes beyond the policy's own
    # chunk plan: (chunk_nbytes, encode-complete offset from encode start).
    # None when the wire rides whole.
    chunks: Optional[List[Tuple[int, float]]] = None
    charges: List[Tuple[str, float, int]] = dataclasses.field(
        default_factory=list)  # (stage name, seconds, alloc bytes)


class WireStage:
    """One pipeline stage. ``phase`` orders application on encode:
    payload-domain stages (0) run before the serialize stage (1), wire
    stages (2) after. Decode inverts recorded provenance right-to-left."""

    name = "stage"
    phase = 1

    def signature(self) -> str:
        return self.name


class SerializeStage(WireStage):
    """payload -> WireData through a calibrated serializer."""

    name = "serialize"
    phase = 1

    def __init__(self, serializer: BaseSerializer):
        self.serializer = serializer

    def signature(self) -> str:
        return self.serializer.name


class CompressStage(WireStage):
    """Payload-domain compression with per-peer error feedback.

    The residual state is keyed by the destination peer so concurrent
    streams (one per receiver, or one per relay WAN hop) each keep their
    own unbiased feedback loop; ``peer=None`` uses one shared stream
    (broadcast / object-store uploads, where one wire serves everyone)."""

    name = "compress"
    phase = 0

    def __init__(self, codec, *, error_feedback: bool = True):
        from repro_torch.compression.stages import make_codec
        self.codec = make_codec(codec)
        self.error_feedback = error_feedback
        self._state: dict = {}  # peer -> residual QuantState

    def signature(self) -> str:
        return self.codec.signature()

    def resolve_state(self, payload, peer):
        """The pre-compress state rule, factored so the batched path
        applies exactly it: existing residual if it fits, else fresh."""
        state = self._state.get(peer)
        if self.error_feedback and not self.codec.state_matches(state,
                                                                payload):
            state = self.codec.init_state(payload)  # new/shape-changed
        return state

    def store_state(self, peer, new_state) -> None:
        if self.error_feedback and new_state is not None:
            self._state[peer] = new_state

    def compress(self, payload, peer):
        state = self.resolve_state(payload, peer)
        out, new_state, info = self.codec.compress(payload, state)
        self.store_state(peer, new_state)
        return out, info


class WireCompressStage(CompressStage):
    """Byte-domain sibling of CompressStage: transforms the *serialized
    wire* (phase 2) instead of the payload. Carries a wire-domain codec
    (zlib-family); lossless, so no error-feedback state. Decode follows
    the wire's recorded ``wirecodec`` provenance — receivers inflate by
    what the wire says, never their own configuration."""

    name = "wirecodec"
    phase = 2

    def __init__(self, codec):
        super().__init__(codec, error_feedback=False)
        if getattr(self.codec, "domain", "payload") != "wire":
            raise ValueError(
                f"wire_codec must be a wire-domain codec, got "
                f"'{self.codec.name}' (payload-domain codecs like "
                f"qsgd/topk go in `compression`)")

    def compress(self, wire):
        return self.codec.compress_wire(wire)


class ChunkStage(WireStage):
    """Split wires larger than ``chunk_bytes`` into pipelined chunks."""

    name = "chunk"
    phase = 3

    def __init__(self, chunk_bytes: int):
        self.chunk_bytes = int(chunk_bytes)

    def signature(self) -> str:
        return f"chunk({self.chunk_bytes / MB:g}MB)"

    def split(self, nbytes: int) -> Optional[List[int]]:
        if self.chunk_bytes <= 0 or nbytes <= self.chunk_bytes:
            return None
        sizes = [self.chunk_bytes] * (nbytes // self.chunk_bytes)
        if nbytes % self.chunk_bytes:
            sizes.append(nbytes % self.chunk_bytes)
        return sizes


class Channel:
    """One backend's wire pipeline: an ordered WireStage stack driven
    through a single encode/decode pair."""

    def __init__(self, stages: List[WireStage], device=None):
        assert any(isinstance(s, SerializeStage) for s in stages), \
            "a Channel needs a SerializeStage"
        self.stages = list(stages)
        # where decode reconstructs real payloads (None: the card, resolved
        # at the first real payload)
        self.device = None if device is None else torch.device(device)
        self._order = sorted(self.stages, key=lambda s: s.phase)
        self.serializer = next(s.serializer for s in stages
                               if isinstance(s, SerializeStage))
        # the (at most one) payload-domain compress stage — the part of
        # the stack encode_many can fuse across a batch of encodes
        self.compress_stage: Optional[CompressStage] = next(
            (s for s in self._order if isinstance(s, CompressStage)
             and not isinstance(s, WireCompressStage)), None)

    # ------------------------------------------------------------------
    def signature(self) -> str:
        """Stable stack identity — the object store's content-addressed
        cache keys on (payload fingerprint, this), i.e. the
        post-compression wire."""
        return "|".join(s.signature() for s in self._order)

    # ------------------------------------------------------------------
    def encode(self, payload, peer: Optional[str] = None, *,
               _pre: Optional[Tuple] = None) -> Encoded:
        """Run the stack forward: payload -> wire (+ itemised charges).

        ``_pre`` is a precomputed ``(payload', info)`` for the payload
        compress stage (``encode_many``'s fused dispatch); the charges,
        provenance and wire are identical to computing it here."""
        charges: List[Tuple[str, float, int]] = []
        infos: List[dict] = []
        wire: Optional[WireData] = None
        chunks = None
        for stage in self._order:
            if isinstance(stage, WireCompressStage):
                out, info = stage.compress(wire)
                if info is not None:
                    charges.append((stage.name,
                                    stage.codec.enc_time(info["orig_nbytes"]),
                                    out.nbytes))
                    infos.append(info)
                    wire = out
            elif isinstance(stage, CompressStage):
                orig_nbytes = payload.nbytes
                if _pre is not None:
                    payload, info = _pre
                else:
                    payload, info = stage.compress(payload, peer)
                if info is not None:
                    charges.append((stage.name,
                                    stage.codec.enc_time(orig_nbytes),
                                    payload.nbytes))
                    infos.append(info)
            elif isinstance(stage, SerializeStage):
                wire = stage.serializer.serialize(payload)
                charges.append((stage.name,
                                stage.serializer.ser_time(wire.nbytes), 0))
                infos.append({"stage": "serialize", "codec": wire.codec})
            elif isinstance(stage, ChunkStage):
                sizes = stage.split(wire.nbytes)
                if sizes is not None:
                    chunks = sizes
                    infos.append({"stage": "chunk", "chunks": list(sizes)})
        cost_s = sum(c[1] for c in charges)
        wire.stages = infos
        enc = Encoded(wire=wire, cost_s=cost_s,
                      extra_alloc=sum(c[2] for c in charges),
                      charges=charges)
        if chunks is not None:
            # encode completes proportionally to bytes produced: chunk i
            # is transferable once its share of the encode work is done
            cum, plan = 0, []
            for nb in chunks:
                cum += nb
                plan.append((nb, cost_s * cum / wire.nbytes))
            enc.chunks = plan
        return enc

    # ------------------------------------------------------------------
    @staticmethod
    def _stage_infos(wire: WireData):
        """Recorded provenance; legacy bare wires (none) decode exactly
        as before the stack existed: codec-aware deserialize at the
        receiver's calibrated throughput."""
        return wire.stages or [{"stage": "serialize", "codec": wire.codec}]

    def _device_for(self, *payloads):
        """This channel's device if any of ``payloads`` is real (None when
        all are virtual: they have nothing to place)."""
        if not any(isinstance(p, (TensorPayload, PackedPayload))
                   for p in payloads):
            return None
        if self.device is None:
            self.device = resolve_device()
        return self.device

    def _place(self, payload):
        """A decoded tensor payload on this channel's device."""
        if not isinstance(payload, TensorPayload):
            return payload
        dev = self._device_for(payload)

        def on(leaf):
            if isinstance(leaf, torch.Tensor):
                return leaf.to(dev)
            return torch.tensor(leaf, device=dev)  # wires may be read-only
        return TensorPayload(_tree.map(on, payload.tree))

    def decode(self, wire: WireData):
        """Invert the wire's recorded stages right-to-left. Wire-domain
        steps (wirecodec) transform the wire before the serialize step
        deserializes it; payload-domain steps invert after. Returns
        (payload, cost_s)."""
        from repro_torch.compression.stages import codec_for
        payload, cur, cost = None, wire, 0.0
        for info in reversed(self._stage_infos(wire)):
            kind = info.get("stage", "compress")
            if kind == "chunk":
                continue  # reassembly is the transport's job (free here)
            if kind == "wirecodec":
                codec = codec_for(info["codec"])
                cur = codec.decompress_wire(cur, info)
                cost += codec.dec_time(info["orig_nbytes"])
            elif kind == "serialize":
                payload = decode_wire(cur, self.serializer)
                cost += self.serializer.deser_time(cur.nbytes)
            else:  # payload-domain compress
                codec = codec_for(info["codec"])
                payload = codec.decompress(payload, info,
                                           device=self._device_for(payload))
                cost += codec.dec_time(info["orig_nbytes"])
        return self._place(payload), cost

    def encode_batch(self, items: List[Tuple[object, Optional[str]]]
                     ) -> List[Encoded]:
        """Batched ``encode``: [(payload, peer)] -> [Encoded], with the
        payload-compress work of the whole batch fused into one kernel
        dispatch where the codec supports it. Single-channel shorthand
        for ``encode_many``."""
        return encode_many([(self, p, peer) for p, peer in items])

    def decode_batch(self, wires: List[WireData]
                     ) -> List[Tuple[object, float]]:
        """Batched ``decode``: the per-wire wirecodec + deserialize steps
        run as usual, then every wire's final payload-codec inversion is
        grouped per codec and dispatched through ``codec.decode_batch``
        (one fused dequantize for a round's worth of received updates).
        Charges and payloads are identical to per-wire ``decode``."""
        from repro_torch.compression.stages import codec_for
        results: List[Optional[Tuple[object, float]]] = [None] * len(wires)
        # wire -> payload via the non-payload-codec steps; collect the
        # remaining payload-codec inversions (applied right-to-left)
        tail: dict = {}  # codec name -> [(idx, payload, [info...])]
        for idx, wire in enumerate(wires):
            payload, cur, cost = None, wire, 0.0
            payload_infos = []
            for info in reversed(self._stage_infos(wire)):
                kind = info.get("stage", "compress")
                if kind == "chunk":
                    continue
                if kind == "wirecodec":
                    codec = codec_for(info["codec"])
                    cur = codec.decompress_wire(cur, info)
                    cost += codec.dec_time(info["orig_nbytes"])
                elif kind == "serialize":
                    payload = decode_wire(cur, self.serializer)
                    cost += self.serializer.deser_time(cur.nbytes)
                else:  # payload-domain: defer for the fused dispatch
                    payload_infos.append(info)
                    cost += codec_for(info["codec"]).dec_time(
                        info["orig_nbytes"])
            if payload_infos:
                # group by the outermost deferred codec; a stack rarely
                # nests payload codecs, but apply any extras in order
                tail.setdefault(payload_infos[0]["codec"], []).append(
                    (idx, payload, payload_infos))
            results[idx] = (payload, cost)
        for name, members in tail.items():
            codec = codec_for(name)
            payloads = [p for _, p, _ in members]
            decoded = codec.decode_batch(
                payloads, [infos[0] for _, _, infos in members],
                device=self._device_for(*payloads))
            for (idx, _, infos), payload in zip(members, decoded):
                for info in infos[1:]:
                    payload = codec_for(info["codec"]).decompress(
                        payload, info, device=self._device_for(payload))
                results[idx] = (payload, results[idx][1])
        return [(self._place(p), cost) for p, cost in results]

    def decode_time(self, wire: WireData) -> float:
        """Decode cost without materialising (planners/broadcast)."""
        from repro_torch.compression.stages import codec_for
        cost, nbytes = 0.0, wire.nbytes
        for info in reversed(self._stage_infos(wire)):
            kind = info.get("stage", "compress")
            if kind == "chunk":
                continue
            if kind == "wirecodec":
                cost += codec_for(info["codec"]).dec_time(info["orig_nbytes"])
                nbytes = info["orig_nbytes"]  # deserialize sees inflated bytes
            elif kind == "serialize":
                cost += self.serializer.deser_time(nbytes)
            else:
                cost += codec_for(info["codec"]).dec_time(info["orig_nbytes"])
        return cost


def encode_many(items: List[Tuple[Channel, object, Optional[str]]]
                ) -> List[Encoded]:
    """Encode a batch of (channel, payload, peer) triples — possibly
    across *different* channels — with every payload-compress step that
    shares a codec fused into one kernel dispatch.

    The per-item result (wire bytes, provenance, charges, error-feedback
    transitions) is identical to calling ``channel.encode(payload, peer)``
    item by item, by construction: states are resolved through the same
    ``CompressStage.resolve_state`` rule before the fused dispatch and
    written back through ``store_state`` after it, and the rest of each
    stack runs unchanged via ``encode(..., _pre=...)``. Items whose
    (stage, peer) stream appears more than once in the batch are left on
    the sequential path — their residuals chain, so fusing them would
    reorder the feedback loop."""
    pre: List[Optional[Tuple]] = [None] * len(items)
    # count per-stream occurrences: a stream = one EF residual slot
    streams: dict = {}
    for ch, _, peer in items:
        if ch.compress_stage is not None:
            key = (id(ch.compress_stage), peer)
            streams[key] = streams.get(key, 0) + 1
    groups: dict = {}  # (codec type, signature) -> [(idx, stage, peer)]
    for idx, (ch, payload, peer) in enumerate(items):
        stage = ch.compress_stage
        if stage is None or streams[(id(stage), peer)] > 1:
            continue
        groups.setdefault((type(stage.codec), stage.codec.signature()),
                          []).append((idx, stage, peer))
    for (_, _sig), members in groups.items():
        codec = members[0][1].codec
        payloads = [items[i][1] for i, _, _ in members]
        states = [stage.resolve_state(p, peer)
                  for (_, stage, peer), p in zip(members, payloads)]
        for (i, stage, peer), (out, new_state, info) in zip(
                members, codec.encode_batch(payloads, states)):
            stage.store_state(peer, new_state)
            pre[i] = (out, info)
    return [ch.encode(payload, peer, _pre=pre[idx])
            for idx, (ch, payload, peer) in enumerate(items)]


def make_channel(serializer_name: str, *, compression=None, wire_codec=None,
                 chunk_bytes: int = 0, error_feedback: bool = True,
                 device=None) -> Channel:
    """Standard stack builder:
    [Compress?] -> Serialize -> [WireCompress?] -> [Chunk?].

    A wire-domain codec named via ``compression`` (e.g. the CLI's
    ``--compression zlib:6``) is routed to its rightful slot after the
    serializer; ``wire_codec`` names it explicitly (ChannelSpec), and the
    two compose: qsgd payload quantisation + zlib on the resulting
    wire bytes is a legal stack."""
    from repro_torch.compression.stages import split_codecs
    stages: List[WireStage] = [SerializeStage(SERIALIZERS[serializer_name])]
    codec, wcodec = split_codecs(compression, wire_codec)
    if codec is not None:
        stages.append(CompressStage(codec, error_feedback=error_feedback))
    if wcodec is not None:
        stages.append(WireCompressStage(wcodec))
    if chunk_bytes and chunk_bytes > 0:
        stages.append(ChunkStage(chunk_bytes))
    return Channel(stages, device=device)
