"""Port of ``src/repro/core/netsim.py`` (copied; imports re-pointed).

Discrete-event network model calibrated from the paper's Table I.

Star topology (FL server = hub). Each region carries the paper's measured
(single-connection BW, multi-connection BW, RTT latency) to the hub. A
transfer with ``conns`` connections is rate-capped at
``min(conns * bw_single, bw_multi)``; concurrently active transfers at a
host additionally share the host uplink/downlink via max-min fair
water-filling — this is what reproduces Fig 2 (concurrency recovers
throughput) and Fig 4b (concurrent-vs-sequential speedups saturating below
ideal).

All bandwidths stored in bytes/s, latencies in seconds.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import heapq
import math
import zlib
from typing import Optional, Sequence

import numpy as np

MB = 1024 ** 2
GB = 1024 ** 3


@dataclasses.dataclass(frozen=True)
class Region:
    """Paper Table I row: link characteristics to the hub (N. California)."""
    name: str
    bw_single: float  # bytes/s, one TCP connection
    bw_multi: float  # bytes/s, saturated multi-connection
    latency: float  # seconds, one-way-ish RTT as measured

    def conn_cap(self, conns: int) -> float:
        return min(conns * self.bw_single, self.bw_multi)


# Table I (g4dn.2xlarge, hub = North California)
NCAL = Region("ncal", 592 * MB, 2946 * MB, 0.44e-3)
OREGON = Region("oregon", 133 * MB, 573 * MB, 11e-3)
NVIRGINIA = Region("nvirginia", 39.4 * MB, 557 * MB, 32.3e-3)
HONGKONG = Region("hongkong", 16.3 * MB, 513 * MB, 83.3e-3)
STOCKHOLM = Region("stockholm", 11.4 * MB, 495 * MB, 90.9e-3)
SAOPAULO = Region("saopaulo", 8.27 * MB, 491 * MB, 90.9e-3)
BAHRAIN = Region("bahrain", 6.90 * MB, 444 * MB, 111e-3)

# LAN testbed (§IV-A): InfiniBand 5 GB/s @ 3.17 us; TCP fallback 1 GB/s
# @ 16.8 us (serialising backends ride TCP, buffer backends ride IB verbs).
LAN_IB = Region("lan_ib", 5.0 * GB, 5.0 * GB, 3.17e-6)
LAN_TCP = Region("lan_tcp", 1.0 * GB, 2.5 * GB, 16.8e-6)

GEO_REGIONS = [NCAL, OREGON, NVIRGINIA, HONGKONG, STOCKHOLM, SAOPAULO,
               BAHRAIN]
REGIONS = {r.name: r for r in GEO_REGIONS + [LAN_IB, LAN_TCP]}


@dataclasses.dataclass(frozen=True)
class Host:
    host_id: str
    region: Region
    uplink: float  # bytes/s host NIC budget (shared across transfers)
    downlink: float


@dataclasses.dataclass(frozen=True)
class Link:
    """One directed edge of a deployment's topology graph.

    ``region`` carries the edge's capacity triple (single-connection BW,
    multi-connection saturation BW, latency); per-edge connection caps
    fold into ``bw_multi`` at build time. ``lan_class`` edges resolve to
    IB verbs or the TCP fallback per backend policy (buffer backends ride
    InfiniBand, serializing ones ride TCP) — the same split the implicit
    ``env.name == "lan"`` rule used to encode."""
    src: str
    dst: str
    region: Region
    lan_class: bool = False

    @property
    def latency(self) -> float:
        return self.region.latency

    def conn_cap(self, conns: int) -> float:
        return self.region.conn_cap(conns)


@dataclasses.dataclass(frozen=True)
class Environment:
    """One deployment regime: hosts + an explicit link graph.

    ``links`` maps ordered host-id pairs to graph edges
    (scenario.TopologySpec builds it). ``link()`` falls back to the
    historical implicit star rule for pairs the graph does not name —
    legacy hand-built Environments (links=None) behave exactly as before
    the graph existed."""
    name: str
    server: Host
    clients: tuple  # Host tuple
    has_object_store: bool = True
    trusted: bool = False  # LAN/within-org: MPI/RPC deployable
    links: Optional[dict] = None  # (src_id, dst_id) -> Link

    def host(self, host_id: str) -> Host:
        # lazily built id -> Host index (frozen dataclass, so it lives in
        # __dict__ via object.__setattr__): lookups are on every transfer's
        # hot path and a linear scan is quadratic at fleet scale
        if _LINEAR_LOOKUP[0]:  # pre-index baseline (fig11 speedup gate)
            if host_id == self.server.host_id:
                return self.server
            for c in self.clients:
                if c.host_id == host_id:
                    return c
            raise KeyError(host_id)
        idx = self.__dict__.get("_host_idx")
        if idx is None:
            idx = {c.host_id: c for c in self.clients}
            idx[self.server.host_id] = self.server
            object.__setattr__(self, "_host_idx", idx)
        try:
            return idx[host_id]
        except KeyError:
            raise KeyError(host_id) from None

    def link(self, src_id: str, dst_id: str) -> Link:
        """The graph edge a (src -> dst) transmission rides."""
        if self.links is not None:
            edge = self.links.get((src_id, dst_id))
            if edge is not None:
                return edge
        # implicit legacy rule: LAN links are LAN-class; WAN is a star
        # where the non-hub end dominates
        if self.name == "lan":
            return Link(src_id, dst_id, LAN_TCP, lan_class=True)
        src = self.host(src_id).region
        dst = self.host(dst_id).region
        return Link(src_id, dst_id, dst if dst.name != "ncal" else src)


def lan_env(num_clients: int = 7) -> Environment:
    mk = lambda i: Host(f"client{i}", LAN_TCP, 5.0 * GB, 5.0 * GB)
    return Environment("lan", Host("server", LAN_TCP, 5.0 * GB, 5.0 * GB),
                       tuple(mk(i) for i in range(num_clients)),
                       has_object_store=False, trusted=True)


def geo_proximal_env(num_clients: int = 7) -> Environment:
    mk = lambda i: Host(f"client{i}", NCAL, NCAL.bw_multi, NCAL.bw_multi)
    return Environment("geo_proximal",
                       Host("server", NCAL, NCAL.bw_multi, NCAL.bw_multi),
                       tuple(mk(i) for i in range(num_clients)), trusted=True)


def geo_distributed_env(num_clients: int = 7) -> Environment:
    """Paper's 7-region WAN testbed; >7 clients round-robin over the same
    regions (multi-client silos — the hierarchical-aggregation regime)."""
    regions = (GEO_REGIONS[i % len(GEO_REGIONS)] for i in range(num_clients))
    clients = tuple(Host(f"client{i}", r, r.bw_multi, r.bw_multi)
                    for i, r in enumerate(regions))
    return Environment("geo_distributed",
                       Host("server", NCAL, NCAL.bw_multi, NCAL.bw_multi),
                       clients)


# legacy constructors kept as the bit-for-bit reference the scenario
# presets are regression-tested against (tests/test_scenario.py)
ENVIRONMENTS = {
    "lan": lan_env,
    "geo_proximal": geo_proximal_env,
    "geo_distributed": geo_distributed_env,
}


def make_env(name: str, num_clients: int = 7) -> Environment:
    """Deprecated shim: environments are described by scenario specs now.
    Equivalent to ``TopologySpec.preset(name, num_clients).build()`` —
    which also accepts the graph presets (star/ring/multi_hub) the legacy
    constructors never had. Warns; no longer re-exported from
    ``repro.core``."""
    import warnings
    warnings.warn(
        "make_env is deprecated; use "
        "TopologySpec.preset(name, num_clients=...).build()",
        DeprecationWarning, stacklevel=2)
    from repro_torch.scenario import TopologySpec
    return TopologySpec.preset(name, num_clients=num_clients).build()


# ---------------------------------------------------------------------------
# fluid-flow transfer simulation (max-min fair water-filling)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Transfer:
    start: float
    src: Host
    dst: Host
    nbytes: float
    conns: int = 1
    link_region: Optional[Region] = None  # defaults to the non-hub region
    tag: str = ""
    # aggregate link modeling (multi-tenant fabric): transfers that stamp
    # the same ``edge_key`` share ONE contended pipe of ``edge_cap``
    # bytes/s on top of their per-transfer caps and host NIC budgets —
    # the shared-bottleneck semantics of Marfoq et al.'s capacity model.
    # ``None`` (the default) declares no shared edge and leaves every
    # solver code path bit-identical to the pre-tenancy behaviour.
    edge_key: Optional[tuple] = None
    edge_cap: float = 0.0
    # filled by simulate():
    finish: float = math.inf

    def rate_cap(self) -> float:
        region = self.link_region or (
            self.dst.region if self.dst.region is not NCAL else self.src.region)
        return region.conn_cap(max(self.conns, 1))

    def latency(self) -> float:
        region = self.link_region or (
            self.dst.region if self.dst.region is not NCAL else self.src.region)
        return region.latency


def _fair_rates(active: Sequence[Transfer]) -> dict:
    """Max-min fair allocation under per-transfer caps + host NIC budgets
    + (when declared) per-edge aggregate pipe budgets: transfers stamping
    the same ``edge_key`` progressive-fill against one shared ``edge_cap``
    pool exactly the way they share a host NIC budget. With no edge keys
    in the active set the extra terms never execute — bit-identical to
    the pre-tenancy solver."""
    rates = {id(t): 0.0 for t in active}
    caps = {id(t): t.rate_cap() for t in active}
    up = {}
    down = {}
    edge = {}  # edge_key -> remaining aggregate pipe budget
    for t in active:
        up.setdefault(t.src.host_id, t.src.uplink)
        down.setdefault(t.dst.host_id, t.dst.downlink)
        if t.edge_key is not None:
            edge.setdefault(t.edge_key, t.edge_cap)
    unfrozen = set(rates)
    # progressive filling
    for _ in range(len(active) + 2):
        if not unfrozen:
            break
        # per-host fair share among its unfrozen transfers
        increments = {}
        for t in active:
            if id(t) not in unfrozen:
                continue
            n_up = sum(1 for u in active if id(u) in unfrozen
                       and u.src.host_id == t.src.host_id)
            n_dn = sum(1 for u in active if id(u) in unfrozen
                       and u.dst.host_id == t.dst.host_id)
            share = min(up[t.src.host_id] / n_up, down[t.dst.host_id] / n_dn,
                        caps[id(t)] - rates[id(t)])
            if t.edge_key is not None:
                n_e = sum(1 for u in active if id(u) in unfrozen
                          and u.edge_key == t.edge_key)
                share = min(share, edge[t.edge_key] / n_e)
            increments[id(t)] = max(share, 0.0)
        if not increments:
            break
        inc = min(increments.values())
        newly_frozen = set()
        for t in active:
            if id(t) not in unfrozen:
                continue
            rates[id(t)] += increments[id(t)]
            up[t.src.host_id] -= increments[id(t)]
            down[t.dst.host_id] -= increments[id(t)]
            if t.edge_key is not None:
                edge[t.edge_key] -= increments[id(t)]
            if rates[id(t)] >= caps[id(t)] - 1e-9 or increments[id(t)] <= 1e-9:
                newly_frozen.add(id(t))
        unfrozen -= newly_frozen
        if not newly_frozen:
            break
    return rates


# Fleet-scale dispatch: at and above this many transfers one fluid call
# switches from the per-transfer scalar loop to the NumPy flow solver
# (same max-min water-filling, vectorised + contended edges collapsed
# into weighted flows). Below it — every paper-scale run — the scalar
# path runs unconditionally, so small-fleet traces are bit-identical to
# the pre-vectorisation code by construction.
SIM_VECTORIZE_MIN = 64

_FORCE_SCALAR = [0]


@contextlib.contextmanager
def scalar_transfers():
    """Force the scalar reference solver regardless of transfer count
    (the fig11 legacy baseline and the vec-vs-scalar parity tests)."""
    _FORCE_SCALAR[0] += 1
    try:
        yield
    finally:
        _FORCE_SCALAR[0] -= 1


# ``Environment.host`` baseline switch: >0 forces the pre-index linear
# scan over the client tuple (identical results, O(fleet) per lookup).
_LINEAR_LOOKUP = [0]


@contextlib.contextmanager
def linear_host_lookup():
    """Force the historical O(clients) host scan — with
    ``scalar_transfers`` and ``transport.linear_inbox``, the measurable
    pre-PR hot path for the fig11 engine-speedup gate."""
    _LINEAR_LOOKUP[0] += 1
    try:
        yield
    finally:
        _LINEAR_LOOKUP[0] -= 1


def simulate_transfers(transfers: Sequence[Transfer]) -> Sequence[Transfer]:
    """Event-driven fluid simulation. Sets ``finish`` on each transfer
    (start + latency + contention-aware transmission time).

    Dispatches to the vectorised flow solver for fleet-scale calls
    (``len >= SIM_VECTORIZE_MIN``, matches the scalar path within float
    tolerance); the scalar loop below is the reference semantics."""
    if len(transfers) >= SIM_VECTORIZE_MIN and not _FORCE_SCALAR[0]:
        return _simulate_transfers_np(transfers)
    return _simulate_transfers_scalar(transfers)


def _simulate_transfers_scalar(transfers: Sequence[Transfer]) -> Sequence[Transfer]:
    remaining = {id(t): float(t.nbytes) for t in transfers}
    begin = {id(t): t.start + t.latency() for t in transfers}
    pending = sorted(transfers, key=lambda t: begin[id(t)])
    active: list = []
    now = begin[id(pending[0])] if pending else 0.0
    pi = 0
    while pending[pi:] or active:
        while pi < len(pending) and begin[id(pending[pi])] <= now + 1e-12:
            active.append(pending[pi])
            pi += 1
        if not active:
            now = begin[id(pending[pi])]
            continue
        rates = _fair_rates(active)
        # time to next event: earliest finish or next start
        t_fin = math.inf
        for t in active:
            r = max(rates[id(t)], 1e-9)
            t_fin = min(t_fin, remaining[id(t)] / r)
        t_next = begin[id(pending[pi])] - now if pi < len(pending) else math.inf
        dt = min(t_fin, t_next)
        for t in list(active):
            remaining[id(t)] -= rates[id(t)] * dt
            if remaining[id(t)] <= 1e-6:
                t.finish = now + dt
                active.remove(t)
        now += dt
    return transfers


def _fair_rates_np(caps, src, dst, w, up, dn, ekey=None, ebud=None):
    """Vectorised max-min water-filling over weighted flows.

    Mirrors ``_fair_rates`` exactly: each filling iteration computes
    every unfrozen flow's share from the budgets as they stood at the
    start of the iteration (the scalar loop does the same — it reads
    ``up``/``down`` before applying any increment of the round), then
    applies all increments at once. A flow of weight m stands in for m
    identical scalar transfers: it counts m times in the per-host fair
    split and drains m shares from each budget, which is exactly what
    the m members would have done one by one.

    caps/src/dst/w are per-flow; up/dn are per-host budget arrays
    (mutated). ``ekey``/``ebud`` carry the aggregate-link pools: per-flow
    edge index (-1 = no shared edge) and per-edge budget array (mutated)
    — same progressive-filling treatment as the host budgets, matching
    the scalar solver's ``edge_key`` terms. Returns per-flow member
    rates (not multiplied by w)."""
    m = caps.size
    rates = np.zeros(m)
    unfrozen = np.ones(m, bool)
    nh = up.size
    for _ in range(m + 2):
        act = np.nonzero(unfrozen)[0]
        if act.size == 0:
            break
        wu = np.bincount(src[act], weights=w[act], minlength=nh)
        wd = np.bincount(dst[act], weights=w[act], minlength=nh)
        share = np.minimum(np.minimum(up[src[act]] / wu[src[act]],
                                      dn[dst[act]] / wd[dst[act]]),
                           caps[act] - rates[act])
        if ebud is not None:
            ek = ekey[act]
            on = ek >= 0
            if on.any():
                we = np.bincount(ek[on], weights=w[act][on],
                                 minlength=ebud.size)
                ek0 = np.maximum(ek, 0)
                eshare = np.where(on, ebud[ek0] / np.maximum(we[ek0], 1e-300),
                                  np.inf)
                share = np.minimum(share, eshare)
        share = np.maximum(share, 0.0)
        np.subtract.at(up, src[act], share * w[act])
        np.subtract.at(dn, dst[act], share * w[act])
        if ebud is not None and on.any():
            np.subtract.at(ebud, ek[on], (share * w[act])[on])
        rates[act] += share
        newly = (rates[act] >= caps[act] - 1e-9) | (share <= 1e-9)
        if not newly.any():
            break
        unfrozen[act[newly]] = False
    return rates


def _simulate_transfers_np(transfers: Sequence[Transfer]) -> Sequence[Transfer]:
    """NumPy twin of the scalar fluid loop for fleet-scale fan-in/out.

    Two ideas on top of straight vectorisation:

    * **host factorisation** — per-client Transfer objects reduce to
      integer (src, dst) host indices; the fair split becomes two
      ``bincount``s instead of the scalar loop's O(active^2) host scans.
    * **flow collapsing (aggregate link modeling)** — a broadcast or
      upload wave through one shared bottleneck edge is m transfers that
      differ only in their singleton far end. They are collapsed into
      ONE weighted flow (weight m, synthetic far-end budget m*B), so the
      contended edge is charged once per wave, not once per client. By
      symmetry of max-min fairness the m members always receive equal
      rates and finish together, so the collapse is exact, not an
      approximation.

    Matches ``_simulate_transfers_scalar`` within float tolerance
    (summation order differs); paper-scale calls never route here."""
    n = len(transfers)
    if n == 0:
        return transfers

    host_ix: dict = {}
    up_b: list = []
    dn_b: list = []

    def hid(h):
        i = host_ix.get(h.host_id)
        if i is None:
            i = host_ix[h.host_id] = len(up_b)
            up_b.append(float(h.uplink))
            dn_b.append(float(h.downlink))
        return i

    src = np.fromiter((hid(t.src) for t in transfers), np.int64, n)
    dst = np.fromiter((hid(t.dst) for t in transfers), np.int64, n)
    caps = np.fromiter((t.rate_cap() for t in transfers), float, n)
    begin = np.fromiter((t.start + t.latency() for t in transfers), float, n)
    sizes = np.fromiter((float(t.nbytes) for t in transfers), float, n)

    # aggregate link pools (shared-bottleneck edges): edge_key -> index
    e_ix: dict = {}
    e_bud: list = []

    def eid(t):
        if t.edge_key is None:
            return -1
        i = e_ix.get(t.edge_key)
        if i is None:
            i = e_ix[t.edge_key] = len(e_bud)
            e_bud.append(float(t.edge_cap))
        return i

    ekey = np.fromiter((eid(t) for t in transfers), np.int64, n)

    # ---- collapse singleton-end groups into weighted flows ------------
    # a host is "singleton" when it appears in exactly one transfer: its
    # budget is private to that transfer, so two transfers sharing the
    # OTHER end and all rate-relevant scalars are exchangeable.
    occur = np.bincount(np.concatenate([src, dst]), minlength=len(up_b))
    f_key: dict = {}
    f_members: list = []  # per flow: list of transfer indices
    f_src: list = []
    f_dst: list = []
    f_syn: list = []  # per flow: None | ("up"|"dn", budget B) synthetic end
    for i in range(n):
        si, di = src[i], dst[i]
        if occur[di] == 1:  # fan-out: shared src, private dst
            key = ("out", si, caps[i], begin[i], sizes[i],
                   up_b[di], dn_b[di], ekey[i])
        elif occur[si] == 1:  # fan-in: private src, shared dst
            key = ("in", di, caps[i], begin[i], sizes[i],
                   up_b[si], dn_b[si], ekey[i])
        else:
            key = ("solo", i)
        fi = f_key.get(key)
        if fi is None:
            fi = f_key[key] = len(f_members)
            f_members.append([i])
            f_src.append(si)
            f_dst.append(di)
            f_syn.append(None if key[0] == "solo" else key[0])
        else:
            f_members[fi].append(i)
    nf = len(f_members)

    # synthetic hosts: a collapsed flow's private ends merge into one
    # host with m-times the budget (m members each brought their own B)
    fsrc = np.empty(nf, np.int64)
    fdst = np.empty(nf, np.int64)
    fw = np.empty(nf, float)
    first = np.fromiter((mem[0] for mem in f_members), np.int64, nf)
    for fi, mem in enumerate(f_members):
        m = len(mem)
        fw[fi] = m
        si, di = f_src[fi], f_dst[fi]
        if m > 1:
            if f_syn[fi] == "out":  # private dst hosts merge
                di = len(up_b)
                up_b.append(m * up_b[f_dst[fi]])
                dn_b.append(m * dn_b[f_dst[fi]])
            else:  # "in": private src hosts merge
                si = len(up_b)
                up_b.append(m * up_b[f_src[fi]])
                dn_b.append(m * dn_b[f_src[fi]])
        fsrc[fi] = si
        fdst[fi] = di
    fcaps = caps[first]
    fbegin = begin[first]
    fsizes = sizes[first]
    fekey = ekey[first]
    up0 = np.asarray(up_b, float)
    dn0 = np.asarray(dn_b, float)
    eb0 = np.asarray(e_bud, float) if e_bud else None

    # ---- event loop (same structure as the scalar path) ---------------
    remaining = fsizes.copy()
    finish = np.full(nf, math.inf)
    order = np.argsort(fbegin, kind="stable")
    sb = fbegin[order]
    active = np.zeros(nf, bool)
    now = sb[0]
    pi = 0
    while pi < nf or active.any():
        while pi < nf and sb[pi] <= now + 1e-12:
            active[order[pi]] = True
            pi += 1
        act = np.nonzero(active)[0]
        if act.size == 0:
            now = sb[pi]
            continue
        rates = _fair_rates_np(fcaps[act], fsrc[act], fdst[act], fw[act],
                               up0.copy(), dn0.copy(),
                               fekey[act] if eb0 is not None else None,
                               eb0.copy() if eb0 is not None else None)
        t_fin = np.min(remaining[act] / np.maximum(rates, 1e-9))
        t_next = sb[pi] - now if pi < nf else math.inf
        dt = min(t_fin, t_next)
        remaining[act] -= rates * dt
        done = act[remaining[act] <= 1e-6]
        finish[done] = now + dt
        active[done] = False
        now += dt

    for fi, mem in enumerate(f_members):
        for i in mem:  # collapsed members finish together (symmetry)
            transfers[i].finish = finish[fi]
    return transfers


def transfer_time(nbytes: float, region: Region, conns: int = 1) -> float:
    """Uncontended single-transfer time (latency + bytes / capped bw)."""
    return region.latency + nbytes / region.conn_cap(max(conns, 1))


# ---------------------------------------------------------------------------
# deterministic link fault injection
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    z = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) & _M64


@functools.lru_cache(maxsize=4096)
def _link_hash(src: str, dst: str) -> int:
    return zlib.crc32(f"{src}>{dst}".encode())


@dataclasses.dataclass
class LinkFaultModel:
    """Deterministic per-link fault injector for the transport fabric.

    Two fault classes, both replayable from ``seed`` alone (draws are
    counter-based hashes of (seed, link, transfer id, chunk index,
    attempt) — no mutable RNG state, so concurrent transfers and re-runs
    see identical faults regardless of call order):

    * ``chunk_loss_rate`` — each transmitted chunk (a whole wire counts
      as one chunk when unchunked) is independently lost with this
      probability. Recovery is receiver-driven: the receiver notices the
      sequence gap and NACKs the sender (``detect_delay`` — one RTT of
      the graph edge the transfer rides), which retransmits, up to
      ``max_retries`` times; past that the transfer fails rather than
      retrying forever (backends surface a failed SendHandle; the FL
      scheduler re-issues the send at a higher level).
    * ``blackouts`` — per-host outage windows ``{host_id: [(t0, t1)]}``:
      nothing departs on a link while either end is dark; departures are
      shifted to the window's end (models transient WAN partitions).
    * ``edge_blackouts`` — the per-edge form ``{(src_id, dst_id):
      [(t0, t1)]}``: only the named directed edge goes dark (one flaky
      WAN path, not a whole silo). Declared via
      ``scenario.FaultSpec.blackouts``; with no windows installed the
      ``delay`` path is untouched (bit-for-bit the per-host-only code).
    """

    chunk_loss_rate: float = 0.0
    max_retries: int = 4
    nack_rtts: float = 1.0  # receiver-driven NACK turnaround, in edge RTTs
    blackouts: dict = dataclasses.field(default_factory=dict)
    edge_blackouts: dict = dataclasses.field(default_factory=dict)
    seed: int = 0

    def _uniform(self, src: str, dst: str, transfer_id: int,
                 chunk_index: int, attempt: int) -> float:
        x = (self.seed * 0x9E3779B97F4A7C15) & _M64
        for v in (_link_hash(src, dst), transfer_id, chunk_index, attempt):
            x = _splitmix64(x ^ (int(v) & _M64))
        return x / 2.0 ** 64

    def attempts(self, src: str, dst: str, transfer_id: int,
                 chunk_index: int, *, forced: bool = False) -> Optional[int]:
        """Transmissions until the chunk lands (>= 1). ``None`` when the
        bounded retries are exhausted — the transfer *fails* instead of
        wedging. ``forced=True`` caps at ``max_retries + 1`` but always
        succeeds (reliable-stream paths: concurrent broadcast)."""
        p = self.chunk_loss_rate
        if p <= 0.0:
            return 1
        for a in range(self.max_retries + 1):
            if self._uniform(src, dst, transfer_id, chunk_index, a) >= p:
                return a + 1
        return self.max_retries + 1 if forced else None

    def delay(self, host_ids: Sequence[str], t: float) -> float:
        """Shift a departure time past any blackout window covering it —
        per-host windows on either end of the link, plus per-edge windows
        on the ordered ``(src, dst)`` pair the callers pass."""
        edge_windows = self.edge_blackouts.get(tuple(host_ids), ()) \
            if self.edge_blackouts else ()
        moved = True
        while moved:
            moved = False
            for hid in host_ids:
                for (a, b) in self.blackouts.get(hid, ()):
                    if a <= t < b:
                        t = b
                        moved = True
            for (a, b) in edge_windows:
                if a <= t < b:
                    t = b
                    moved = True
        return t

    def detect_delay(self, edge: Link) -> float:
        """Loss-detection time before a retransmit, derived from the
        graph edge the transfer rides: the receiver notices the sequence
        gap about one edge-latency after the lost chunk should have
        landed and its NACK takes another one-way trip back — one RTT of
        *that edge*, not a fixed multi-RTT constant (receiver-driven
        NACK, vs the old sender-timeout model's ~2 RTTs)."""
        return self.nack_rtts * 2.0 * edge.latency
