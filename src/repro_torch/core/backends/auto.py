"""Port of ``src/repro/core/backends/auto.py``
(copied; imports re-pointed, and a ``device`` for the receive path
added).

AUTO backend — the paper's §VII deployment guideline as code.

Per message: payloads whose *wire* footprint is < 10 MB (or no object
store / LAN) ride plain gRPC; large payloads in untrusted WANs ride
gRPC+S3; trusted LAN prefers MPI_MEM_BUFF for buffer-like payloads.

The 10 MB threshold is about bytes on the wire, so routing sees the
channel's post-stack size estimate: a qsgd-compressed 32 MB update
shrinks to ~8 MB and must ride plain gRPC, while the same update
uncompressed rides gRPC+S3. Batched broadcasts route *per message* —
one small control record in a batch of large models must not drag the
models onto gRPC (or vice versa).
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.backends.base import CommBackend
from repro_torch.core.backends.grpc_s3 import GrpcS3Backend
from repro_torch.core.message import FLMessage, PackedPayload

SMALL_PAYLOAD = 10 * 1024 * 1024  # paper: <10 MB -> pure gRPC


class AutoBackend:
    name = "auto"

    def __init__(self, env, fabric, host_id, store=None, *,
                 compression=None, wire_codec=None, chunk_mb: float = 0.0,
                 job=None, device=None, **kw):
        from repro_torch.core.backends import POLICIES
        self.env = env
        self.fabric = fabric
        self.host_id = host_id
        self.store = store
        self.job = job
        self.job_name = job.name if job is not None else ""
        # every routed backend carries the same wire-stack configuration;
        # decode follows the wire's recorded stages, so mixed routes stay
        # coherent — and the same tenant (one shared namespaced endpoint)
        self.grpc = CommBackend(POLICIES["grpc"], env, fabric, host_id,
                                compression=compression,
                                wire_codec=wire_codec, chunk_mb=chunk_mb,
                                job=job, device=device)
        self.membuff = CommBackend(POLICIES["mpi_mem_buff"], env, fabric,
                                   host_id, compression=compression,
                                   wire_codec=wire_codec, chunk_mb=chunk_mb,
                                   job=job, device=device)
        self.s3 = (GrpcS3Backend(env, fabric, host_id, store,
                                 compression=compression,
                                 wire_codec=wire_codec, job=job,
                                 device=device, **kw)
                   if store is not None and env.name != "lan" else None)
        from repro_torch.compression.stages import split_codecs
        self._codec, self._wire_codec = split_codecs(compression, wire_codec)
        self.endpoint = self.grpc.endpoint
        self.decisions: list = []  # (msg_type, wire nbytes estimate, backend)

    @property
    def device(self):
        """Where received real payloads land (every route shares it)."""
        return self.grpc.device

    # ------------------------------------------------------------------
    def _wire_nbytes(self, nbytes: int, payload=None) -> int:
        """Post-stack wire size estimate: the payload codec's wire ratio
        (already-packed payloads pass the CompressStage untouched, so
        they route on their own size) times the wire codec's byte ratio."""
        est = float(nbytes)
        if self._codec is not None and not isinstance(payload, PackedPayload):
            est *= self._codec.ratio()
        if self._wire_codec is not None:
            est *= self._wire_codec.ratio()
        return int(round(est))

    def _pick(self, wire_nbytes: int):
        if wire_nbytes < SMALL_PAYLOAD or self.s3 is None:
            return self.membuff if (self.env.trusted and
                                    self.env.name == "lan") else self.grpc
        return self.s3

    def resolve(self, msg: FLMessage):
        """The concrete backend this message would ride (no logging) —
        lets orchestrators (FLServer upload phase) plan with the right
        serializer/policy."""
        return self._pick(self._wire_nbytes(msg.payload_nbytes, msg.payload))

    def _route(self, msg: FLMessage):
        wire_nbytes = self._wire_nbytes(msg.payload_nbytes, msg.payload)
        choice = self._pick(wire_nbytes)
        self.decisions.append((msg.msg_type, wire_nbytes, choice.name))
        return choice

    def isend(self, msg, now):
        return self._route(msg).isend(msg, now)

    def send(self, msg, now):
        return self._route(msg).send(msg, now)

    def broadcast(self, msgs: Sequence[FLMessage], now):
        """Per-message routing: each routed subset rides its own
        backend's concurrent dispatch (timing semantics per backend are
        unchanged — grpc's fluid contention, s3's single upload + N
        GETs); arrivals come back in input order.

        The direct subsets' payload encodes are fused into ONE
        cross-channel ``encode_many`` dispatch spanning grpc and membuff
        (their channels share codecs, so one broadcast wave is one
        kernel call); each subset then receives its ready-made encodings
        via ``_encs`` — wire bytes bit-identical to the per-backend
        ``_encode_batch`` path. S3 keeps its own upload-once flow."""
        from repro_torch.core.channel import Encoded, encode_many
        from repro_torch.core.serialization import WireData
        routed: dict = {}
        for i, msg in enumerate(msgs):
            routed.setdefault(id(self._route(msg)), []).append(i)
        backends = {id(b): b for b in (self.grpc, self.membuff, self.s3)
                    if b is not None}
        # one fused dispatch across every direct (non-s3) subset
        direct = [(bid, i) for bid in routed
                  if backends[bid] is not self.s3 for i in routed[bid]]
        payload_items, payload_pos = [], []
        encs: dict = {}  # msg index -> Encoded
        for bid, i in direct:
            m = msgs[i]
            if m.payload is None:
                ser = backends[bid].serializer
                encs[i] = Encoded(wire=WireData(nbytes=256),
                                  cost_s=ser.ser_time(256))
            else:
                payload_items.append((backends[bid].channel, m.payload,
                                      m.receiver))
                payload_pos.append(i)
        for i, enc in zip(payload_pos, encode_many(payload_items)):
            encs[i] = enc
        sender_done = now
        arrives = [0.0] * len(msgs)
        for bid, idxs in routed.items():
            be = backends[bid]
            sub = [msgs[i] for i in idxs]
            if be is self.s3:
                done, arr = be.broadcast(sub, now)
            else:
                done, arr = be.broadcast(sub, now,
                                         _encs=[encs[i] for i in idxs])
            sender_done = max(sender_done, done)
            for i, a in zip(idxs, arr):
                arrives[i] = a
        return sender_done, arrives

    def sequential_broadcast(self, msgs, now):
        """One at a time, each message on its own routed backend (the
        Fig 4b blocking chain crosses backends unchanged: isend, wait,
        next; a fault-failed send resolves at its give-up time)."""
        t = now
        arrives = []
        for msg in msgs:
            h = self._route(msg).isend(msg, t)
            t = h.start if h.failed else h.arrive
            arrives.append(h.arrive)
        return t, arrives

    def recv(self, now):
        # all three share one endpoint; GrpcS3Backend.recv handles both
        # metadata-record and direct-wire deliveries, so route through it
        # when available (it pops the shared inbox exactly once)
        if self.s3 is not None:
            return self.s3.recv(now)
        return self.grpc.recv(now)

    def next_arrival(self, after: float = float("-inf")):
        return self.grpc.next_arrival(after)  # shared endpoint

    def retire(self):
        if self.s3 is not None:
            self.s3.retire()

    def p2p_time(self, nbytes, dst_id):
        return self._pick(self._wire_nbytes(nbytes)).p2p_time(nbytes, dst_id)
