"""Port of ``src/repro/core/transport.py`` (copied; imports re-pointed).

In-process transport fabric + memory accounting.

The fabric really delivers WireData between endpoints (so tests exercise
true byte movement, checksums and reconstruction) while charging *simulated*
time from the netsim model. ``MemoryMeter`` tracks logical sender-side
buffer allocations — exact for real payloads, identical accounting for
virtual ones — reproducing Fig 2 (bottom) and Fig 4c.

Multi-tenancy: the fabric is a shared substrate for N concurrent FL jobs.
``FabricSpec`` declares the admission policy and whether declared edges
are shared contended pipes; ``Fabric.job`` hands out ``JobHandle`` tenant
ids that namespace endpoints, transfer-id allocation and stats. The
default (anonymous) tenant plus ``FabricSpec()`` is bit-identical to the
historical single-job fabric — every legacy call site keeps its exact
keys, ids and timing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import itertools
import math
from collections import OrderedDict, defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.message import FLMessage
from repro_torch.core.netsim import Environment, Transfer, simulate_transfers
from repro_torch.core.serialization import WireData

# Control-plane accounting rule: a metadata-only delivery (no wire)
# still moves a compact record — ~256 B, the same figure the fluid path
# and the backends' meta encodings have always used. Both ``deliver``
# and ``deliver_concurrent`` charge it (historically ``deliver`` charged
# 0 while ``deliver_concurrent`` *timed* 256 but charged 0 — one rule
# now, regression-tested in tests/test_multitenant.py).
CTRL_BYTES = 256

# ``Endpoint.pop_ready`` baseline switch, mirroring
# ``netsim.scalar_transfers``: >0 forces the historical full-inbox scan
# instead of the heap fast path (identical results, O(inbox) per recv).
_LINEAR_INBOX = [0]


@contextlib.contextmanager
def linear_inbox():
    """Force the pre-heap O(inbox) ``pop_ready`` scan — the measurable
    un-vectorized baseline for the fig11 engine-speedup gate."""
    _LINEAR_INBOX[0] += 1
    try:
        yield
    finally:
        _LINEAR_INBOX[0] -= 1


class MemoryMeter:
    """Logical allocation tracker (bytes). alloc/free pairs bracket buffer
    lifetimes; ``peak`` is what Fig 4c reports.

    Events carry *simulated* timestamps that are routinely issued out of
    call order (a backend allocs at a future serialize-start and frees at
    an even-further-future arrival before the next call allocs at an
    earlier time), so ``peak`` is computed from the time-sorted event
    timeline — a call-order running maximum both overstates sequential
    lifetimes that merely *appear* nested in call order and understates
    genuinely overlapping ones."""

    def __init__(self):
        self.current = 0
        self.events: List = []  # (time, +/- delta bytes) in call order

    def alloc(self, nbytes: int, now: float = 0.0):
        self.current += int(nbytes)
        self.events.append((float(now), int(nbytes)))

    def free(self, nbytes: int, now: float = 0.0):
        self.current -= int(nbytes)
        self.events.append((float(now), -int(nbytes)))

    @property
    def peak(self) -> int:
        """Max concurrent bytes over the time-sorted timeline (stable sort:
        same-timestamp events keep call order)."""
        cur = mx = 0
        for _, delta in sorted(self.events, key=lambda e: e[0]):
            cur += delta
            if cur > mx:
                mx = cur
        return mx

    def reset(self):
        self.current = 0
        self.events.clear()


@dataclasses.dataclass
class Delivery:
    msg: FLMessage
    wire: Optional[WireData]
    arrive_time: float
    # chunk-granular deliveries (ChunkStage wires): (index, total,
    # transfer id). Only the last chunk carries the wire; the endpoint
    # reassembles and releases the message when every chunk has landed.
    # The transfer id — not the msg_id — is the grouping key, so
    # retransmitting the same message never wedges two half-sets together.
    chunk: Optional[tuple] = None


class Inbox:
    """Pending deliveries with a (arrive_time, seq) heap over the
    chunk-free entries, so ``pop_ready`` costs O(ready · log n) instead
    of re-scanning the whole inbox on every recv — the scan was the
    scheduler's top hot spot at 1k+ clients (O(fleet²) overall).

    Keeps the historical list surface (append/extend/clear/iter/len;
    iteration yields insertion order) so fault tests can still inject
    and inspect raw deliveries. Chunked deliveries stay in a plain list:
    they need group-wise reassembly anyway and only exist when
    ``chunk_mb`` is set."""

    def __init__(self):
        self._simple: List[tuple] = []  # heap of (arrive_time, seq, d)
        self._chunks: List[tuple] = []  # [(seq, d)] for chunked entries
        self._seq = itertools.count()

    def append(self, d: Delivery):
        if d.chunk is None:
            heapq.heappush(self._simple, (d.arrive_time, next(self._seq), d))
        else:
            self._chunks.append((next(self._seq), d))

    def extend(self, ds):
        for d in ds:
            self.append(d)

    def clear(self):
        self._simple.clear()
        self._chunks.clear()

    def __len__(self):
        return len(self._simple) + len(self._chunks)

    def __iter__(self):
        entries = [(s, d) for _, s, d in self._simple] + self._chunks
        return iter(d for _, d in sorted(entries, key=lambda e: e[0]))


class Endpoint:
    def __init__(self, host_id: str):
        self.host_id = host_id
        self.inbox = Inbox()
        self.memory = MemoryMeter()
        # transfer ids already released to recv: a duplicate chunk or a
        # late retransmit of a completed/superseded transfer is dropped on
        # arrival instead of starting a phantom half-group that would
        # wedge the inbox forever. Bounded LRU — long runs complete
        # millions of transfers, and a straggling retransmit can only be
        # recent (all of a transfer's deliveries are scheduled together)
        self._done_xids: "OrderedDict[int, None]" = OrderedDict()
        self._done_cap = 4096

    def _chunk_groups(self) -> Dict[int, Dict[int, Delivery]]:
        """Live chunk deliveries, deduplicated: transfer id -> {chunk
        index -> earliest copy}. Duplicates (retransmits that crossed the
        original on the wire) and chunks of completed transfers are
        discarded here — they must never double-deliver."""
        groups: Dict[int, Dict[int, Delivery]] = {}
        for _, d in self.inbox._chunks:
            idx, _, xid = d.chunk
            if xid in self._done_xids:
                continue
            got = groups.setdefault(xid, {})
            prev = got.get(idx)
            # prefer the copy that carries the wire (the reassembled
            # message needs it), then the earliest arrival
            if prev is None \
                    or (d.wire is not None and prev.wire is None) \
                    or ((d.wire is None) == (prev.wire is None)
                        and d.arrive_time < prev.arrive_time):
                got[idx] = d
        return groups

    def pop_ready(self, now: float) -> List[Delivery]:
        # chunk-free fast path: pop the (arrive_time, seq) heap — same
        # (time, insertion-order) release order the historical full-inbox
        # scan + stable sort produced, without touching unready entries
        ready = []
        heap = self.inbox._simple
        if _LINEAR_INBOX[0]:
            keep = []
            for t, _, d in sorted(heap, key=lambda e: e[1]):
                (ready if t <= now + 1e-12 else keep).append(d)
            heap.clear()
            for d in keep:
                heapq.heappush(heap, (d.arrive_time,
                                      next(self.inbox._seq), d))
        else:
            while heap and heap[0][0] <= now + 1e-12:
                ready.append(heapq.heappop(heap)[2])
        if self.inbox._chunks:
            keep: List[Delivery] = []
            for xid, got in self._chunk_groups().items():
                ds = list(got.values())
                n_total = ds[0].chunk[1]
                last = max(d.arrive_time for d in ds)
                if len(ds) == n_total and last <= now + 1e-12:
                    wire = next(d.wire for d in ds if d.wire is not None)
                    ready.append(Delivery(ds[0].msg, wire, last))
                    self._done_xids[xid] = None
                    while len(self._done_xids) > self._done_cap:
                        self._done_xids.popitem(last=False)
                else:
                    keep.extend(ds)
            # rebuild with fresh seqs: matches the historical rebuilt-list
            # order (kept chunk groups follow the surviving simples)
            self.inbox._chunks = [(next(self.inbox._seq), d) for d in keep]
        return sorted(ready, key=lambda d: d.arrive_time)

    def pending_times(self) -> List[float]:
        """Message-complete times of everything still in the inbox (a
        chunked transfer counts once, at its last chunk's arrival;
        completed transfers' stray retransmits count never)."""
        times = [t for t, _, _ in self.inbox._simple]
        for got in self._chunk_groups().values():
            times.append(max(d.arrive_time for d in got.values()))
        return times


_POLICIES = ("fifo", "priority", "fair-share")


@dataclasses.dataclass(frozen=True)
class FabricSpec:
    """How a multi-tenant fabric arbitrates its shared substrate.

    ``policy`` decides whose transfers get capacity when a shared edge
    saturates (all three are work-conserving fluid approximations over
    the edge's reservation ledger):

    * ``fifo``       — first-come-first-served: earlier reservations
      hold their rate; later arrivals take what is left.
    * ``priority``   — strict priority: a transfer contends only with
      its own job's traffic and foreign traffic of >= its job's
      priority. Already-granted lower-priority reservations keep their
      promised times (no revocation), so a saturated edge can briefly
      overcommit when a high-priority job bursts in — the documented
      fluid approximation.
    * ``fair-share`` — each job i present on the edge is guaranteed
      ``capacity * w_i / Σw`` over the present jobs' admission weights
      (``JobHandle.weight``; all weights 1.0 reduces to capacity/k,
      bit-identically); spare capacity from idle jobs is usable
      (work-conserving).

    ``shared_links=False`` (the default) disables the pipe ledger
    entirely: every dispatch path computes the exact pre-tenancy
    arithmetic, which is what keeps single-tenant runs bit-identical."""
    policy: str = "fifo"
    shared_links: bool = False

    def __post_init__(self):
        if self.policy not in _POLICIES:
            raise ValueError(f"FabricSpec.policy: unknown policy "
                             f"'{self.policy}'; choose from {_POLICIES}")


@dataclasses.dataclass
class JobHandle:
    """One tenant of a multi-tenant fabric.

    Threading this through a backend namespaces its endpoints, transfer
    ids and stats under ``name``. ``priority`` matters only under the
    ``priority`` admission policy (higher = more important);
    ``weight`` only under ``fair-share`` (a job's guaranteed slice of a
    contended edge is ``capacity * weight / Σweights`` over the jobs
    present on it)."""
    fabric: "Fabric"
    name: str
    priority: int = 0
    weight: float = 1.0

    @property
    def stats(self) -> defaultdict:
        """This job's wire-accounting view (sums across jobs — including
        the default tenant's — equal the fabric's legacy globals)."""
        return self.fabric.stats_for(self.name)


class _EdgePipe:
    """Reservation ledger for one directed shared edge.

    Transfers from *different* fluid calls (different jobs, different
    event times) contend here: each granted transmission appends
    ``(t0, t1, rate, prio, job)`` segments, and later requests walk the
    piecewise-constant residual capacity under the fabric's admission
    policy. This is what makes co-located jobs actually share a
    bottleneck — without it every simulate call rides its own private
    copy of the edge."""

    def __init__(self, capacity: float, policy: str,
                 weight_of: Optional[Callable[[str], float]] = None):
        self.capacity = float(capacity)
        self.policy = policy
        # fair-share admission weights, resolved per job name at query
        # time (the fabric passes its JobHandle table's lookup)
        self.weight_of = weight_of or (lambda job: 1.0)
        self.resv: List[Tuple[float, float, float, int, str]] = []

    # -- queries ---------------------------------------------------------
    def available(self, t: float, prio: int = 0, job: str = "") -> float:
        """Rate grantable to a (prio, job) request at time ``t``."""
        cap = self.capacity
        total = own = visible = 0.0
        others = set()
        for (a, b, r, p, j) in self.resv:
            if a <= t < b:
                total += r
                if j == job:
                    own += r
                else:
                    others.add(j)
                    if p >= prio:
                        visible += r
        if self.policy == "priority":
            return max(cap - visible - own, 0.0)
        if self.policy == "fair-share":
            # weighted fair share over the jobs present on this edge:
            # guaranteed slice = cap * w_own / Σw (all-1.0 weights give
            # exactly cap / k — multiplying by w_own == 1.0 is an IEEE
            # identity, so unweighted runs stay bit-identical)
            w_own = self.weight_of(job)
            w_sum = w_own + sum(self.weight_of(j) for j in others)
            return max(cap - total, cap * w_own / w_sum - own, 0.0)
        return max(cap - total, 0.0)  # fifo

    def _next_boundary(self, t: float) -> float:
        nxt = math.inf
        for (a, b, _, _, _) in self.resv:
            if a > t + 1e-12:
                nxt = min(nxt, a)
            elif b > t + 1e-12:
                nxt = min(nxt, b)
        return nxt

    # -- mutations -------------------------------------------------------
    def reserve(self, t0: float, t1: float, rate: float, prio: int,
                job: str):
        if t1 > t0 and rate > 0.0:
            self.resv.append((float(t0), float(t1), float(rate),
                              int(prio), job))

    def transmit(self, depart: float, nbytes: float, want: float,
                 prio: int, job: str) -> float:
        """Drain ``nbytes`` at up to ``want`` bytes/s starting at
        ``depart``, taking whatever the policy grants per segment;
        returns the finish time and records the granted segments."""
        return self._walk(depart, nbytes, want, prio, job, record=True)

    def drain_rate(self, t: float, nbytes: float, want: float,
                   prio: int, job: str) -> float:
        """Equivalent average rate a queued drain of ``nbytes`` would
        achieve starting at ``t`` — the walk without recording. This is
        what the fluid path hands the solver as the edge's aggregate
        budget: a wave arriving behind another tenant's reservation
        *queues* (finishes when the drain would), it is never starved to
        a zero instantaneous-headroom rate."""
        if nbytes <= 0.0:
            return want
        fin = self._walk(t, nbytes, want, prio, job, record=False)
        return nbytes / max(fin - t, 1e-12)

    def _walk(self, depart: float, nbytes: float, want: float,
              prio: int, job: str, record: bool) -> float:
        t = float(depart)
        remaining = float(nbytes)
        segs: List[Tuple[float, float, float]] = []
        while remaining > 1e-9:
            rate = min(want, self.available(t, prio, job))
            nxt = self._next_boundary(t)
            if rate <= 1e-9:
                if math.isinf(nxt):  # nothing ever frees up: take want
                    rate = want      # (defensive; ledgers are finite)
                else:
                    t = nxt
                    continue
            if math.isinf(nxt) or t + remaining / rate <= nxt + 1e-12:
                dt = remaining / rate
                segs.append((t, t + dt, rate))
                t += dt
                remaining = 0.0
            else:
                segs.append((t, nxt, rate))
                remaining -= rate * (nxt - t)
                t = nxt
        if record:
            for (a, b, r) in segs:
                self.reserve(a, b, r, prio, job)
            # bounded ledger: reservations a sim-hour older than this
            # departure cannot intersect any later walk of consequence
            if len(self.resv) > 512:
                cut = depart - 3600.0
                self.resv = [rv for rv in self.resv if rv[1] > cut]
        return t


class Fabric:
    """Shared in-proc fabric; one per deployment, N tenant jobs."""

    def __init__(self, env: Environment, fault_model=None,
                 spec: Optional[FabricSpec] = None):
        self.env = env
        self.spec = spec or FabricSpec()
        self.endpoints: Dict[str, Endpoint] = {}
        self.clock = 0.0
        self.stats = defaultdict(float)
        self.job_stats: Dict[str, defaultdict] = {}
        self.jobs: Dict[str, JobHandle] = {}
        self._chunk_xfer_ids = itertools.count()
        # per-job transfer-id counters: each tenant's ids start at 0, so
        # a job's counter-based fault draws are identical whether it
        # runs solo or co-scheduled (the "" entry *is* the legacy
        # counter — default-tenant ids are bit-identical)
        self._xids: Dict[str, itertools.count] = {"": self._chunk_xfer_ids}
        self._pipes: Dict[Tuple[str, str], _EdgePipe] = {}
        # optional netsim.LinkFaultModel; None = the exact fault-free
        # timing every benchmark/test has always seen (bit-for-bit)
        self.fault_model = fault_model

    # -- tenancy ------------------------------------------------------------
    def job(self, name: str, priority: int = 0,
            weight: float = 1.0) -> JobHandle:
        """Register (or fetch) a tenant. Job names namespace endpoint
        keys as ``{name}::{host_id}``; the empty name is the implicit
        default tenant every legacy call site already uses."""
        if "::" in name:
            raise ValueError(f"job name {name!r} may not contain '::'")
        if not weight > 0:
            raise ValueError(f"job weight must be > 0 (got {weight})")
        h = self.jobs.get(name)
        if h is None:
            h = self.jobs[name] = JobHandle(self, name, priority, weight)
            self.stats_for(name)  # the per-job stats view exists from birth
        return h

    def _job_weight(self, job: str) -> float:
        """Fair-share admission weight of one tenant (unknown names —
        including the implicit default tenant — weigh 1.0)."""
        h = self.jobs.get(job)
        return h.weight if h is not None else 1.0

    def stats_for(self, job: str = "") -> defaultdict:
        js = self.job_stats.get(job)
        if js is None:
            js = self.job_stats[job] = defaultdict(float)
        return js

    @staticmethod
    def endpoint_key(host_id: str, job: str = "") -> str:
        return host_id if not job else f"{job}::{host_id}"

    def endpoint_for(self, host_id: str, job: str = "") -> Optional[Endpoint]:
        return self.endpoints.get(self.endpoint_key(host_id, job))

    def _ep(self, host_id: str, job: str = "") -> Endpoint:
        """Delivery-side endpoint lookup. The default tenant keeps the
        historical strict ``endpoints[host_id]`` (KeyError on unknown
        hosts); named tenants lazily register — a relay channel spun up
        mid-run by a strategy must not crash its job."""
        if not job:
            return self.endpoints[host_id]
        ep = self.endpoints.get(f"{job}::{host_id}")
        return ep if ep is not None else self.register(host_id, job=job)

    def next_transfer_id(self, job: str = "") -> int:
        """Transfer-id allocator: backends take an id up front so the
        fault model's counter-based draws and the endpoint's reassembly
        groups key on the same identity. Per-job counters — a tenant's
        id stream does not depend on who it is co-scheduled with."""
        c = self._xids.get(job)
        if c is None:
            c = self._xids[job] = itertools.count()
        return next(c)

    def register(self, host_id: str, job: str = "") -> Endpoint:
        ep = Endpoint(host_id)
        self.endpoints[self.endpoint_key(host_id, job)] = ep
        return ep

    def advance_to(self, t: float):
        self.clock = max(self.clock, t)

    # -- shared-bottleneck pipes (FabricSpec.shared_links) -------------------
    def _pipe(self, src_id: str, dst_id: str, capacity: float) -> _EdgePipe:
        key = (src_id, dst_id)
        p = self._pipes.get(key)
        if p is None:
            p = self._pipes[key] = _EdgePipe(capacity, self.spec.policy,
                                             weight_of=self._job_weight)
        return p

    def link_transmit(self, src_id: str, dst_id: str, depart: float,
                      nbytes: float, rate: float, *,
                      capacity: Optional[float] = None, job: str = "",
                      prio: int = 0) -> float:
        """One analytic transmission through the (src, dst) pipe: the
        finish time under whatever other tenants have already reserved.
        With ``shared_links`` off this is exactly ``depart + nbytes /
        rate`` — the pre-tenancy arithmetic, bit for bit."""
        if not self.spec.shared_links:
            return depart + nbytes / rate
        pipe = self._pipe(src_id, dst_id,
                          rate if capacity is None else capacity)
        return pipe.transmit(depart, nbytes, rate, prio, job)

    def link_headroom(self, src_id: str, dst_id: str, t: float, *,
                      capacity: float, job: str = "", prio: int = 0,
                      nbytes: float = 0.0) -> float:
        """Aggregate edge capacity a fluid wave may assume at ``t``
        (full capacity when pipes are off). With ``nbytes`` the answer
        is the *queueing-equivalent* average rate over the drain of that
        many bytes — a flow behind another tenant's reservation waits
        its turn rather than being starved by the instantaneous
        residual; without it, the instantaneous policy headroom."""
        if not self.spec.shared_links:
            return capacity
        pipe = self._pipe(src_id, dst_id, capacity)
        if nbytes > 0.0:
            return min(pipe.drain_rate(t, nbytes, capacity, prio, job),
                       capacity)
        return min(pipe.available(t, prio, job), capacity)

    def link_reserve(self, src_id: str, dst_id: str, t0: float, t1: float,
                     rate: float, *, capacity: float, job: str = "",
                     prio: int = 0) -> None:
        """Publish a fluid-solved transfer's occupancy so later tenants
        see it. No-op when pipes are off."""
        if self.spec.shared_links:
            self._pipe(src_id, dst_id, capacity).reserve(t0, t1, rate,
                                                         prio, job)

    # -- point-to-point -----------------------------------------------------
    def account(self, nbytes: float = 0.0, messages: int = 1, *,
                chunks: int = 0, retransmits: int = 0,
                transfers_failed: int = 0, cross_job_hits: int = 0,
                job: str = "") -> None:
        """Wire accounting — the ONLY place fabric stats are mutated
        (scripts/check_stats_discipline.py enforces this): delivery
        paths, bypassing call sites (concurrent broadcasts, the sync
        server's gather phase, store GET legs) and the backends' fault
        counters all come through here, so per-job views stay an exact
        decomposition of the legacy globals."""
        for target in (self.stats, self.stats_for(job)):
            target["messages"] += messages
            target["bytes"] += nbytes
            if chunks:
                target["chunks"] += chunks
            if retransmits:
                target["retransmits"] += retransmits
            if transfers_failed:
                target["transfers_failed"] += transfers_failed
            if cross_job_hits:
                target["cross_job_hits"] += cross_job_hits

    def deliver(self, msg: FLMessage, wire: Optional[WireData],
                start: float, duration: float, *, job: str = ""):
        """Schedule arrival of a message whose transfer takes ``duration``
        starting at ``start`` (already computed by backend/netsim)."""
        arrive = start + duration
        self._ep(msg.receiver, job).inbox.append(Delivery(msg, wire, arrive))
        self.account(wire.nbytes if wire else CTRL_BYTES, job=job)
        return arrive

    def deliver_chunked(self, msg: FLMessage, wire: WireData,
                        chunk_arrivals: Sequence[float],
                        xid: Optional[int] = None, *, job: str = ""):
        """Chunk-granular delivery of one wire (ChunkStage): each chunk
        lands independently; the receiving endpoint reassembles and
        releases the message at the last chunk's arrival. Returns it."""
        inbox = self._ep(msg.receiver, job).inbox
        n = len(chunk_arrivals)
        if xid is None:
            xid = self.next_transfer_id(job)
        for i, t in enumerate(chunk_arrivals):
            inbox.append(Delivery(msg, wire if i == n - 1 else None, t,
                                  chunk=(i, n, xid)))
        self.account(wire.nbytes, chunks=n, job=job)
        return max(chunk_arrivals)

    # -- batched concurrent transfers (fluid model) ---------------------
    def deliver_concurrent(self, sends, *, job: str = "", prio: int = 0):
        """sends: list of (msg, wire, start, conns). Contention-aware finish
        times via the fluid solver; delivers each on completion. Returns the
        list of finish times. Transfers ride the topology graph's edge for
        each (sender, receiver) pair (LAN-class edges at their declared
        capacity — policy-level IB-vs-TCP resolution lives in the
        backends, which pass explicit ``link_region``s instead). Under
        ``shared_links`` each transfer is clamped to its edge pipe's
        residual capacity and its occupancy is published for later
        tenants."""
        shared = self.spec.shared_links
        transfers = []
        for msg, wire, start, conns in sends:
            src = self.env.host(msg.sender)
            dst = self.env.host(msg.receiver)
            edge = self.env.link(msg.sender, msg.receiver)
            tr = Transfer(start=start, src=src, dst=dst,
                          nbytes=wire.nbytes if wire else CTRL_BYTES,
                          conns=conns, link_region=edge.region,
                          tag=f"msg{msg.msg_id}")
            if shared:
                cap = edge.region.bw_multi
                tr.edge_key = (msg.sender, msg.receiver)
                tr.edge_cap = self.link_headroom(
                    msg.sender, msg.receiver, start + edge.region.latency,
                    capacity=cap, job=job, prio=prio, nbytes=tr.nbytes)
            transfers.append(tr)
        simulate_transfers(transfers)
        finishes = []
        for (msg, wire, start, conns), tr in zip(sends, transfers):
            self._ep(msg.receiver, job).inbox.append(
                Delivery(msg, wire, tr.finish))
            self.account(wire.nbytes if wire else CTRL_BYTES, job=job)
            if shared:
                begin = tr.start + tr.latency()
                span = tr.finish - begin
                if span > 0:
                    self.link_reserve(
                        msg.sender, msg.receiver, begin, tr.finish,
                        tr.nbytes / span,
                        capacity=self.env.link(
                            msg.sender, msg.receiver).region.bw_multi,
                        job=job, prio=prio)
            finishes.append(tr.finish)
        return finishes
