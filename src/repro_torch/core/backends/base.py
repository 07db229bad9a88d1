"""Port of ``src/repro/core/backends/base.py``
(copied; imports re-pointed, and a ``device`` for the receive path
added).

CommBackend: the paper's pluggable communication abstraction.

Each backend implements the same API over the shared fabric + netsim:

* ``isend(msg, now)``         -> SendHandle (non-blocking completion path)
* ``send(msg, now)``          -> (sender_free_t, arrive_t)
* ``broadcast(msgs, now)``    -> (sender_free_t, [arrive_t])   (concurrent)
* ``sequential_broadcast``    -> same but one send at a time (Fig 4b baseline)
* ``recv(now)``               -> [(FLMessage with payload, ready_t)]
* ``next_arrival(after)``     -> earliest pending delivery time (peek)
* ``p2p_time(nbytes)``        -> analytic single-message latency (Fig 4a)

``isend`` is the shared completion path: ``send`` and
``sequential_broadcast`` are thin blocking-semantics wrappers over it, and
the event-driven FL scheduler (fl/scheduler.py) issues bare handles so it
can interleave many in-flight sends. Backends whose serializer cannot run
sends in parallel (``ser_parallel=False``) queue overlapping isends on a
sender-side serializer busy-line; non-overlapping calls — the only pattern
the blocking API ever produced — are bit-for-bit unchanged.

What differs between backends is exactly what the paper measures: the
serializer (copy vs zero-copy), connections per transfer, per-send buffer
behaviour (memory ∝ concurrency or not), fixed per-message overheads, and
whether the LAN path can ride InfiniBand verbs or falls back to TCP.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.channel import Encoded, make_channel
from repro_torch.core.message import FLMessage
from repro_torch.core.netsim import LAN_IB, LAN_TCP, Environment, Link, Region, \
    Transfer, simulate_transfers
from repro_torch.core.serialization import SERIALIZERS, WireData
from repro_torch.core.transport import Fabric

MB = 1024 ** 2


@dataclasses.dataclass(frozen=True)
class BackendPolicy:
    name: str
    serializer: str
    conns_per_transfer: int = 1
    per_send_copy: bool = False  # serialized copy per in-flight send
    staging_bytes: int = 4 << 20  # fixed per-active-send staging
    overhead_rtts: float = 1.0  # request/ack handshakes per message
    ser_parallel: bool = False  # can serialize concurrent sends in parallel
    lan_uses_ib: bool = True  # ib verbs (buffer backends) vs TCP fallback
    lan_concurrency_penalty: float = 0.0  # MPI multithreading overhead/send


@dataclasses.dataclass
class SendHandle:
    """One in-flight non-blocking send (``isend``).

    * ``issued``  — when the send was requested;
    * ``start``   — sender-side busy-until (serialization / upload done);
    * ``inbox_t`` — when the delivery lands in the receiver's inbox
                    (``recv`` called at/after this returns the message);
    * ``arrive``  — payload availability at the receiver, pre-deserialize
                    (for object-store backends this includes the GET leg).
    * ``failed``  — the fault model exhausted the bounded chunk
                    retransmits: nothing was delivered (``arrive`` is
                    inf, ``start`` is the sender's give-up time); the
                    caller decides whether to re-issue.
    """
    msg: FLMessage
    issued: float
    start: float
    inbox_t: float
    arrive: float
    nbytes: int = 0
    failed: bool = False

    def done(self, now: float) -> bool:
        return now + 1e-12 >= self.arrive


class CommBackend:
    def __init__(self, policy: BackendPolicy, env: Environment,
                 fabric: Fabric, host_id: str, store=None, *,
                 compression=None, wire_codec=None, chunk_mb: float = 0.0,
                 error_feedback: bool = True, job=None, device=None):
        """``device``: where this backend's receive path reconstructs real
        payloads (Channel.device); None means the card, resolved at the
        first real payload."""
        self.policy = policy
        self.env = env
        self.fabric = fabric
        self.host_id = host_id
        self.store = store
        # tenancy: a transport.JobHandle namespaces this backend's
        # endpoint, transfer ids and stats; None = the default tenant
        # (plain host_id keys — the exact legacy fabric surface)
        self.job = job
        self.job_name = job.name if job is not None else ""
        self.job_prio = job.priority if job is not None else 0
        self.endpoint = fabric.endpoint_for(host_id, self.job_name) \
            or fabric.register(host_id, job=self.job_name)
        self.serializer = SERIALIZERS[policy.serializer]
        # the wire pipeline every send/recv path drives (core/channel.py);
        # default stack = [SerializeStage] -> pre-stack behaviour, exactly
        self.channel = make_channel(policy.serializer,
                                    compression=compression,
                                    wire_codec=wire_codec,
                                    chunk_bytes=int(chunk_mb * MB),
                                    error_feedback=error_feedback,
                                    device=device)
        self._ser_busy_until = 0.0  # sender serializer busy-line (isend)

    @property
    def device(self):
        """Where received real payloads land (None until resolved)."""
        return self.channel.device

    def _encode(self, msg: FLMessage) -> Encoded:
        """Stack-encode one message's payload (256 B for metadata-only,
        which still occupies the serializer for its header's worth)."""
        if msg.payload is None:
            return Encoded(wire=WireData(nbytes=256),
                           cost_s=self.serializer.ser_time(256))
        return self.channel.encode(msg.payload, peer=msg.receiver)

    def _encode_batch(self, msgs: Sequence[FLMessage]) -> List[Encoded]:
        """Stack-encode a round's worth of messages with the payload
        compression fused into one kernel dispatch (channel.encode_many).
        Per-message wires/charges are identical to ``_encode`` in a loop."""
        from repro_torch.core.channel import encode_many
        encs: List[Optional[Encoded]] = [
            Encoded(wire=WireData(nbytes=256),
                    cost_s=self.serializer.ser_time(256))
            if m.payload is None else None for m in msgs]
        idx = [i for i, m in enumerate(msgs) if m.payload is not None]
        fused = encode_many([(self.channel, msgs[i].payload,
                              msgs[i].receiver) for i in idx])
        for i, enc in zip(idx, fused):
            encs[i] = enc
        return encs

    # ------------------------------------------------------------------
    @property
    def name(self) -> str:
        return self.policy.name

    def _edge(self, dst_id: str) -> Link:
        """The topology-graph edge this host's transmissions to ``dst_id``
        ride (netsim.Environment.link), with LAN-class edges resolved per
        backend policy: buffer backends ride InfiniBand verbs, serializing
        ones fall back to TCP."""
        link = self.env.link(self.host_id, dst_id)
        if link.lan_class:
            return dataclasses.replace(
                link, region=LAN_IB if self.policy.lan_uses_ib else LAN_TCP)
        return link

    def _link_region(self, dst_id: str) -> Region:
        """Capacity triple of the graph edge to ``dst_id``."""
        return self._edge(dst_id).region

    def _overhead(self, region: Region) -> float:
        return self.policy.overhead_rtts * 2 * region.latency

    def _ser_slot(self, now: float, ser_t: float) -> float:
        """Start time for one serialization on the sender. Serializers that
        cannot run in parallel queue overlapping isends; calls at
        non-decreasing, non-overlapping times see ``now`` unchanged."""
        if self.policy.ser_parallel:
            return now
        start = max(now, self._ser_busy_until)
        self._ser_busy_until = start + ser_t
        return start

    def _link_schedule(self, dst_id: str, depart: float, nbytes: float,
                       rate: float, edge: Link, xid: Optional[int],
                       chunk_index: int):
        """Completion of one link transmission under the fabric's fault
        model: the departure is shifted past blackout windows, each lost
        transmission costs the chunk's wire time plus the receiver-driven
        NACK turnaround on ``edge`` before the retransmit. Returns
        ``(finish, give_up_t)`` — ``finish`` is None when the bounded
        retries are exhausted, with ``give_up_t`` the moment the sender
        abandons the transfer. Each transmission rides the fabric's
        shared edge pipe (``link_transmit``) — with ``shared_links`` off
        and no fault model this is exactly ``depart + nbytes/rate``."""
        fab = self.fabric

        def tx_done(t0: float) -> float:
            return fab.link_transmit(self.host_id, dst_id, t0, nbytes, rate,
                                     capacity=edge.region.bw_multi,
                                     job=self.job_name, prio=self.job_prio)

        fm = fab.fault_model
        if fm is None:
            fin = tx_done(depart)
            return fin, fin
        if xid is None:
            xid = fab.next_transfer_id(self.job_name)
        hosts = (self.host_id, dst_id)
        t = fm.delay(hosts, depart)
        n = fm.attempts(self.host_id, dst_id, xid, chunk_index)
        # lost transmissions each pay their wire time + the NACK
        # turnaround; retransmits are the transmissions beyond the original
        lost_tx = (fm.max_retries + 1) if n is None else (n - 1)
        for _ in range(lost_tx):
            t = fm.delay(hosts, tx_done(t) + fm.detect_delay(edge))
        if n is None:
            fab.account(0.0, 0, retransmits=fm.max_retries,
                        transfers_failed=1, job=self.job_name)
            return None, t
        fab.account(0.0, 0, retransmits=lost_tx, job=self.job_name)
        fin = tx_done(t)
        return fin, fin

    # ------------------------------------------------------------------
    def isend(self, msg: FLMessage, now: float) -> SendHandle:
        """Non-blocking send: schedules delivery, returns a completion
        handle immediately. Multiple in-flight isends interleave (subject
        to the serializer busy-line)."""
        enc = self._encode(msg)
        ser_t = enc.cost_s
        mem = self.endpoint.memory
        alloc = (enc.wire.nbytes if (self.policy.per_send_copy and msg.payload
                                     is not None) else 0) \
            + self.policy.staging_bytes + enc.extra_alloc
        ser_start = self._ser_slot(now, ser_t)
        mem.alloc(alloc, ser_start)
        edge = self._edge(msg.receiver)
        region = edge.region
        start = ser_start + ser_t
        rate = region.conn_cap(self.policy.conns_per_transfer)
        base = self._overhead(region) + region.latency
        failed_at = None
        if enc.chunks:
            # pipelined chunks: chunk i's transfer starts once it is
            # encoded AND the link is free (overlaps encode with network)
            xid = self.fabric.next_transfer_id(self.job_name)
            link_free, arrivals = ser_start, []
            for i, (nb, ready_off) in enumerate(enc.chunks):
                dep = max(ser_start + ready_off, link_free)
                fin, give_up = self._link_schedule(msg.receiver, dep, nb,
                                                   rate, edge, xid, i)
                if fin is None:
                    failed_at = give_up
                    break
                link_free = fin
                arrivals.append(base + fin)
            if failed_at is None:
                arrive = self.fabric.deliver_chunked(msg, enc.wire, arrivals,
                                                     xid=xid,
                                                     job=self.job_name)
        else:
            fin, give_up = self._link_schedule(msg.receiver, start,
                                               enc.wire.nbytes, rate, edge,
                                               None, 0)
            if fin is None:
                failed_at = give_up
            else:
                arrive = self.fabric.deliver(msg, enc.wire, start,
                                             base + fin - start,
                                             job=self.job_name)
        if failed_at is not None:
            # bounded retries exhausted: nothing is delivered; the sender
            # frees its buffers when it gives up and surfaces the failure.
            # ``start`` carries the give-up time — the earliest moment a
            # caller can causally know the send failed and re-issue it
            mem.free(alloc, failed_at)
            return SendHandle(msg=msg, issued=now, start=failed_at,
                              inbox_t=float("inf"), arrive=float("inf"),
                              nbytes=enc.wire.nbytes, failed=True)
        mem.free(alloc, arrive)
        return SendHandle(msg=msg, issued=now, start=start, inbox_t=arrive,
                          arrive=arrive, nbytes=enc.wire.nbytes)

    def send(self, msg: FLMessage, now: float) -> Tuple[float, float]:
        """Blocking-semantics wrapper over ``isend`` (legacy API)."""
        h = self.isend(msg, now)
        return h.start, h.arrive

    # ------------------------------------------------------------------
    def _broadcast_transfers(self, msgs, now, _encs=None) -> Tuple[list, list]:
        """Common prep: stack-encode (sequential or parallel), build
        transfers. Returns ([(Encoded, encode_done_t)], transfers).
        ``_encs`` lets a routing backend (AUTO) hand in message encodings
        it already fused across its sub-backends' channels — the wires
        and charges are identical to ``_encode_batch`` here."""
        encs, ser_done = [], now
        for enc in (self._encode_batch(msgs) if _encs is None else _encs):
            if self.policy.ser_parallel:
                enc_done = now + enc.cost_s
                ser_done = max(ser_done, enc_done)
            else:
                enc_done = ser_done + enc.cost_s
                ser_done = enc_done
            encs.append((enc, enc_done))
        transfers = []
        n_active = len(msgs)
        # MPI-style multithreaded progress engines lose efficiency on LAN
        # (paper Fig 4b: concurrent MPI *declines*): the penalty applies to
        # the shared NIC budget, not just per-transfer caps.
        penalty = 1.0 + self.policy.lan_concurrency_penalty * max(
            n_active - 1, 0) if self.env.name == "lan" else 1.0
        src = self.env.host(self.host_id)
        if penalty > 1.0:
            import dataclasses as _dc
            src = _dc.replace(src, uplink=src.uplink / penalty)
        fm = self.fabric.fault_model
        for msg, (enc, enc_done) in zip(msgs, encs):
            region = self._link_region(msg.receiver)
            eff_region = Region(region.name,
                                region.bw_single / penalty,
                                region.bw_multi / penalty, region.latency)
            start = enc_done + self._overhead(region)
            if fm is not None:
                start = fm.delay((self.host_id, msg.receiver), start)
            # chunk pipelining overlaps encode with transfer on the isend
            # path only: the fluid solver moves whole wires with no
            # inter-chunk dependencies, so dispatching a broadcast at
            # first-chunk-ready could finish a transfer before its encode
            # completes — broadcasts keep whole-wire (encode-complete)
            # dispatch
            tr = Transfer(
                start=start,
                src=src,
                dst=self.env.host(msg.receiver),
                nbytes=enc.wire.nbytes,
                conns=self.policy.conns_per_transfer,
                link_region=eff_region, tag=f"msg{msg.msg_id}")
            if self.fabric.spec.shared_links:
                # shared-bottleneck edge: this wave's flows through the
                # (src, dst) pipe split whatever other tenants left free
                tr.edge_key = (self.host_id, msg.receiver)
                tr.edge_cap = self.fabric.link_headroom(
                    self.host_id, msg.receiver, start + eff_region.latency,
                    capacity=eff_region.bw_multi, job=self.job_name,
                    prio=self.job_prio, nbytes=tr.nbytes)
            transfers.append(tr)
        return encs, transfers

    def broadcast(self, msgs: Sequence[FLMessage], now: float, _encs=None):
        """Concurrent dispatch (the FL server's global-model distribution)."""
        encs, transfers = self._broadcast_transfers(msgs, now, _encs)
        mem = self.endpoint.memory
        allocs = []
        for msg, (enc, start) in zip(msgs, encs):
            a = (enc.wire.nbytes if (self.policy.per_send_copy and msg.payload
                                     is not None) else 0) \
                + self.policy.staging_bytes + enc.extra_alloc
            # buffered from *dispatch*: issuing N concurrent sends
            # materialises N request buffers immediately (memory ∝
            # concurrency, Fig 2 bottom / Fig 4c), even while the
            # serializer busy-line is still draining them onto the wire
            mem.alloc(a, now)
            allocs.append(a)
        simulate_transfers(transfers)
        fm = self.fabric.fault_model
        arrives = []
        for msg, (enc, _), tr, a in zip(msgs, encs, transfers, allocs):
            finish = tr.finish
            if fm is not None:
                # the concurrent-broadcast path models a reliable stream:
                # lost chunks are retransmitted serially after the fluid
                # transfer (capped at max_retries, always delivered —
                # bounded-failure semantics live on the isend path)
                xid = self.fabric.next_transfer_id(self.job_name)
                n = fm.attempts(self.host_id, msg.receiver, xid, 0,
                                forced=True)
                if n > 1:
                    edge = self._edge(msg.receiver)
                    rate = edge.conn_cap(self.policy.conns_per_transfer)
                    finish += (n - 1) * (enc.wire.nbytes / rate
                                         + fm.detect_delay(edge))
                    self.fabric.account(0.0, 0, retransmits=n - 1,
                                        job=self.job_name)
            if self.fabric.spec.shared_links:
                # publish this flow's occupancy so later tenants contend
                begin = tr.start + tr.latency()
                if tr.finish > begin:
                    self.fabric.link_reserve(
                        self.host_id, msg.receiver, begin, tr.finish,
                        tr.nbytes / (tr.finish - begin),
                        capacity=self._link_region(msg.receiver).bw_multi,
                        job=self.job_name, prio=self.job_prio)
            self.fabric._ep(msg.receiver, self.job_name).inbox.append(
                _delivery(msg, enc.wire, finish))
            # broadcast bypasses Fabric.deliver (the fluid solver already
            # owns the timing) — keep the wire accounting consistent
            self.fabric.account(enc.wire.nbytes, job=self.job_name)
            mem.free(a, finish)
            arrives.append(finish)
        return max(e[1] for e in encs), arrives

    def sequential_broadcast(self, msgs: Sequence[FLMessage], now: float):
        """One at a time (Fig 4b baseline): each isend waits for the
        previous handle to complete before being issued. A fault-failed
        send resolves at the sender's give-up time — the chain continues
        from there (its inf arrive in the result marks the loss) instead
        of pushing every later send to t=inf."""
        t = now
        arrives = []
        for msg in msgs:
            h = self.isend(msg, t)
            # blocking: wait for completion (or failure detection)
            t = h.start if h.failed else h.arrive
            arrives.append(h.arrive)
        return t, arrives

    # ------------------------------------------------------------------
    def recv(self, now: float) -> List[Tuple[FLMessage, float]]:
        ready_ds = self.endpoint.pop_ready(now)
        # fuse the wires' payload-codec inversions into one kernel
        # dispatch (channel.decode_batch); identical payloads/charges
        dec_idx = [i for i, d in enumerate(ready_ds)
                   if d.wire is not None and d.wire.nbytes > 256]
        decoded = self.channel.decode_batch([ready_ds[i].wire
                                             for i in dec_idx])
        out = []
        by_idx = dict(zip(dec_idx, decoded))
        for i, d in enumerate(ready_ds):
            ready = d.arrive_time
            msg = d.msg
            if i in by_idx:
                # the channel inverts whatever stages the wire records
                # (codec-aware: AUTO/mixed fleets decode correctly)
                payload, dec_s = by_idx[i]
                ready += dec_s
                if msg.payload is None or d.wire.buffers is not None:
                    msg = dataclasses.replace(msg, payload=payload)
            out.append((msg, ready))
        return out

    def next_arrival(self, after: float = float("-inf")) -> Optional[float]:
        """Non-blocking peek: earliest pending message-complete time
        strictly after ``after`` (event-loop hook; returns None when
        idle). Chunked wires count once, at their last chunk."""
        ts = [t for t in self.endpoint.pending_times() if t > after]
        return min(ts) if ts else None

    # ------------------------------------------------------------------
    def p2p_time(self, nbytes: int, dst_id: str) -> float:
        """Analytic one-message CPU-to-CPU latency (Fig 4a)."""
        region = self._link_region(dst_id)
        return (self.serializer.ser_time(nbytes) + self._overhead(region)
                + region.latency
                + nbytes / region.conn_cap(self.policy.conns_per_transfer)
                + self.serializer.deser_time(nbytes))


def _delivery(msg, wire, t):
    from repro_torch.core.transport import Delivery
    return Delivery(msg, wire, t)
