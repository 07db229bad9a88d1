"""Port of ``src/repro/core/serialization.py``.

Serializers — the behavioural split the paper measures (§V):

* ``GenericSerializer``  — serialises/transforms arbitrary objects into a
  fresh byte buffer (MPI_GENERIC's lowercase send, pickle-family). Allocates
  a full copy; throughput ~0.55 GB/s each way.
* ``ProtobufSerializer`` — gRPC's packing: protobuf field encode + HTTP/2
  framing; the slowest path (~0.16 GB/s) and also copies.
* ``BufferSerializer``   — MPI_MEM_BUFF / TensorRPC: zero-copy buffer
  views; near-C speed, but only for buffer-like (contiguous array) objects.

Throughputs are calibration constants from the paper's own measurements
and are charged in *simulated* time. The byte-level behaviour (copy vs
view) is real, so memory accounting is exact.

Wires are host buffers: a CUDA leaf is copied to the host inside
``_serialize`` (the real device->host copy; the modelled PCIe charge
stays in ``fl/client.py``). A CPU tensor is viewed, not copied. The
membuff / tensor_rpc wires are byte-identical to the reference's for
identical arrays; the generic / protobuf wires pickle this package's
treedef in place of JAX's, so their sizes differ by that header.
"""
from __future__ import annotations

import dataclasses
import io
import pickle
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.core.message import (FLMessage, PackedPayload, TensorPayload,
                                      VirtualPayload)

GB = 1024 ** 3


def host_array(leaf) -> np.ndarray:
    """A leaf as a host array: a view of a CPU tensor or host array, a
    device->host copy of a CUDA tensor."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


@dataclasses.dataclass
class WireData:
    """What travels: either real buffers or a virtual size."""
    nbytes: int
    buffers: Optional[list] = None  # list of np arrays / bytes (zero-copy views)
    copied: bool = False  # did serialisation allocate a copy?
    obj: Optional[Any] = None  # structure needed to reconstruct
    codec: str = ""  # which serializer produced this wire (decode with same)
    # stage provenance (core/channel.py): one info dict per WireStage that
    # shaped this wire, in encode-application order. The receiving Channel
    # inverts them right-to-left; an empty list means a legacy bare wire
    # (decode_wire with the receiver's serializer, exactly as before).
    stages: list = dataclasses.field(default_factory=list)


class BaseSerializer:
    name = "base"
    gbps_out = float("inf")  # serialisation throughput (bytes/s), sender
    gbps_in = float("inf")  # deserialisation throughput, receiver
    copies = False

    def serialize(self, payload) -> WireData:
        wire = self._serialize(payload)
        wire.codec = self.name
        return wire

    def _serialize(self, payload) -> WireData:
        raise NotImplementedError

    def deserialize(self, wire: WireData):
        raise NotImplementedError

    def ser_time(self, nbytes: int) -> float:
        return nbytes / self.gbps_out if self.gbps_out != float("inf") else 0.0

    def deser_time(self, nbytes: int) -> float:
        return nbytes / self.gbps_in if self.gbps_in != float("inf") else 0.0


class GenericSerializer(BaseSerializer):
    """Pickle-style: full copy both ways (MPI_GENERIC)."""
    name = "generic"
    gbps_out = 0.55 * GB
    gbps_in = 0.85 * GB
    copies = True

    def _serialize(self, payload) -> WireData:
        if isinstance(payload, VirtualPayload):
            return WireData(nbytes=payload.nbytes, copied=True, obj=payload)
        if isinstance(payload, TensorPayload):
            leaves, treedef = _tree.flatten(payload.tree)
            buf = io.BytesIO()
            arrs = [host_array(l) for l in leaves]
            pickle.dump({"treedef": treedef,
                         "arrs": [a.tobytes() for a in arrs],  # the copy
                         "meta": [(a.shape, str(a.dtype)) for a in arrs]}, buf)
            data = buf.getvalue()
            return WireData(nbytes=len(data), buffers=[data], copied=True)
        if isinstance(payload, PackedPayload):
            buf = io.BytesIO()
            pickle.dump(_tree.map(host_array, payload.packed), buf)
            data = buf.getvalue()
            return WireData(nbytes=len(data), buffers=[data], copied=True)
        raise TypeError(type(payload))

    def deserialize(self, wire: WireData):
        if wire.obj is not None:
            return wire.obj
        obj = pickle.loads(wire.buffers[0])
        if isinstance(obj, dict) and "treedef" in obj:
            arrs = [np.frombuffer(b, dtype=dt).reshape(shape)
                    for b, (shape, dt) in zip(obj["arrs"], obj["meta"])]
            return TensorPayload(_tree.unflatten(obj["treedef"], arrs))
        return PackedPayload(obj)


class ProtobufSerializer(GenericSerializer):
    """gRPC: protobuf packing + HTTP/2 framing (slowest, copies)."""
    name = "protobuf"
    gbps_out = 0.16 * GB
    gbps_in = 0.35 * GB
    copies = True


class BufferSerializer(BaseSerializer):
    """Zero-copy views of contiguous buffers (MPI_MEM_BUFF / TensorRPC).
    Only accepts buffer-like payloads (array trees / packed / virtual)."""
    name = "membuff"
    gbps_out = float("inf")  # only a checksum pass; modelled as free
    gbps_in = float("inf")
    copies = False

    def _serialize(self, payload) -> WireData:
        if isinstance(payload, VirtualPayload):
            return WireData(nbytes=payload.nbytes, obj=payload)
        if isinstance(payload, TensorPayload):
            leaves, treedef = _tree.flatten(payload.tree)
            arrs = [host_array(l) for l in leaves]  # views of host leaves
            return WireData(nbytes=sum(a.nbytes for a in arrs), buffers=arrs,
                            obj=("tree", treedef,
                                 [(a.shape, a.dtype) for a in arrs]))
        if isinstance(payload, PackedPayload):
            if "idx" in payload.packed:  # top-k sparse form
                arrs = [host_array(payload.packed["idx"]),
                        host_array(payload.packed["vals"])]
                return WireData(nbytes=sum(a.nbytes for a in arrs),
                                buffers=arrs,
                                obj=("topk", int(payload.packed["n"])))
            arrs = [host_array(payload.packed["q"]),
                    host_array(payload.packed["scales"])]
            return WireData(nbytes=sum(a.nbytes for a in arrs), buffers=arrs,
                            obj=("packed", payload.packed["block"],
                                 payload.packed["orig_len"]))
        raise TypeError(
            f"{self.name} can only send buffer-like objects, got {type(payload)}")

    def deserialize(self, wire: WireData):
        if wire.buffers is None:
            return wire.obj
        kind = wire.obj[0]
        if kind == "tree":
            _, treedef, _ = wire.obj
            return TensorPayload(_tree.unflatten(treedef, wire.buffers))
        if kind == "topk":
            return PackedPayload({"idx": wire.buffers[0],
                                  "vals": wire.buffers[1], "n": wire.obj[1]})
        _, block, orig = wire.obj
        return PackedPayload({"q": wire.buffers[0], "scales": wire.buffers[1],
                              "block": block, "orig_len": orig})


class TensorRPCSerializer(BufferSerializer):
    """TensorPipe-style: zero-copy tensors + a cheap header pass."""
    name = "tensor_rpc"
    gbps_out = 8.0 * GB  # small per-tensor bookkeeping
    gbps_in = 8.0 * GB


SERIALIZERS = {s.name: s for s in
               (GenericSerializer(), ProtobufSerializer(), BufferSerializer(),
                TensorRPCSerializer())}


def decode_wire(wire: WireData, fallback: BaseSerializer):
    """Deserialize with the codec that produced the wire (backends can
    differ between the send and receive path, e.g. AUTO routing)."""
    ser = SERIALIZERS.get(wire.codec, fallback)
    return ser.deserialize(wire)


def checksum(wire: WireData) -> int:
    if wire.buffers is None:
        return 0
    crc = 0
    for b in wire.buffers:
        crc = zlib.crc32(b if isinstance(b, bytes) else
                         np.ascontiguousarray(b).tobytes(), crc)
    return crc
