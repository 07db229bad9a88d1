"""Port of ``src/repro/scenario/spec.py`` (copied; imports re-pointed).

The Scenario layer: one frozen, declarative description of a deployment.

The paper's central claim is that backend choice is a function of the
*deployment scenario* — model size x network topology x concurrency
(§IV-§VII). Before this layer, that description was scattered across
three hardcoded ``*_env`` constructors, a flag soup in ``fl_train`` and
per-benchmark ad-hoc wiring. A ``Scenario`` gathers the whole experiment
into five frozen sub-specs:

* ``TopologySpec`` — an explicit host/region **link graph** with
  per-edge bandwidth/latency/connection caps. Presets ``lan`` /
  ``geo_proximal`` / ``geo_distributed`` reproduce the legacy
  environments bit-for-bit (regression-tested); ``star`` / ``ring`` /
  ``multi_hub`` are graph-native topologies in the Marfoq & Neglia
  throughput-optimal-topology line (benchmarks/fig9_topology_wan.py).
* ``FleetSpec``    — who trains: tier, local steps.
* ``ChannelSpec``  — what the wire stack looks like: backend, payload
  codec, wire codec, chunking.
* ``FaultSpec``    — what goes wrong: link loss, NACK timing, store
  faults, churn traces.
* ``StrategySpec`` — how aggregation runs: mode + its knobs.

``Scenario.to_dict()`` / ``Scenario.from_dict()`` round-trip exactly
(``from_dict(to_dict(s)) == s``), including through JSON, and
``from_dict`` rejects unknown keys / invalid edges with a readable path
(``topology.edges[2]: unknown key(s) ['bandwith']``). ``fl_train
--scenario file.json`` loads one; individual CLI flags become overrides
on the resolved spec (``with_overrides``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Tuple

from repro_torch.core.netsim import (GB, GEO_REGIONS, LAN_TCP, MB, NCAL, REGIONS,
                               Environment, Host, Link, Region)
from repro_torch.core.transport import FabricSpec

TOPOLOGY_PRESETS = ("lan", "geo_proximal", "geo_distributed",
                    "star", "ring", "multi_hub")
MODES = ("sync", "fedbuff", "semisync", "hier", "vertical")


class ScenarioError(ValueError):
    """Invalid scenario spec — the message carries the offending path."""


# ---------------------------------------------------------------------------
# sub-specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EdgeSpec:
    """One declared link-graph edge (layered onto the preset graph).

    Bandwidths in MB/s and latency in ms — Table I's units. ``max_conns``
    caps the multi-connection saturation at ``max_conns * bw_single``
    (folded into the built edge's ``bw_multi``); ``symmetric`` installs
    the reverse edge too; ``lan_class`` edges resolve IB-vs-TCP per
    backend policy like the LAN testbed links.

    Asymmetric directed-pair shorthand: real WAN links are rarely
    symmetric (a silo's uplink is usually thinner than its downlink), and
    spelling that as two ``symmetric=False`` edges doubles every
    declaration. Setting any ``rev_*`` field turns the edge into a
    one-line directed pair — the forward direction carries the main
    rates, the ``dst -> src`` direction the ``rev_*`` rates, with any
    unset ``rev_*`` component inheriting its forward value. The pair
    installs both directions, so combining ``rev_*`` with
    ``symmetric=False`` is a contradiction and rejected at validation."""
    src: str
    dst: str
    bw_single_mb: float
    bw_multi_mb: float
    latency_ms: float
    max_conns: int = 0
    symmetric: bool = True
    lan_class: bool = False
    # directed-pair shorthand (0 / -1 = "same as forward")
    rev_bw_single_mb: float = 0.0
    rev_bw_multi_mb: float = 0.0
    rev_latency_ms: float = -1.0

    @property
    def asymmetric(self) -> bool:
        return (self.rev_bw_single_mb > 0 or self.rev_bw_multi_mb > 0
                or self.rev_latency_ms >= 0)

    def reverse_rates(self) -> Tuple[float, float, float]:
        """(bw_single_mb, bw_multi_mb, latency_ms) of the reverse leg."""
        return (self.rev_bw_single_mb or self.bw_single_mb,
                self.rev_bw_multi_mb or self.bw_multi_mb,
                self.rev_latency_ms if self.rev_latency_ms >= 0
                else self.latency_ms)


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Host/region link graph, built from a preset + explicit edges."""
    kind: str = "geo_distributed"
    num_clients: int = 7
    # region names cycled over the clients; () = the preset's default
    # (Table I's seven regions for the WAN presets)
    regions: Tuple[str, ...] = ()
    edges: Tuple[EdgeSpec, ...] = ()
    # upload-side reduction-tree depth for hier mode: 1 = region relays
    # ship straight to the hub (the historical shape, bit-for-bit);
    # D > 1 inserts D-1 tiers of super-relays between them and the hub
    relay_depth: int = 1

    @classmethod
    def preset(cls, name: str, num_clients: int = 7) -> "TopologySpec":
        return cls(kind=name, num_clients=num_clients)

    # -- building ----------------------------------------------------------
    def client_regions(self) -> Tuple[Region, ...]:
        if self.kind == "lan":
            names = self.regions or ("lan_tcp",)
        elif self.kind == "geo_proximal":
            names = self.regions or ("ncal",)
        else:
            names = self.regions or tuple(r.name for r in GEO_REGIONS)
        for n in names:
            if n not in REGIONS:
                raise ScenarioError(
                    f"topology.regions: unknown region '{n}'; known: "
                    f"{sorted(REGIONS)}")
        cycle = tuple(REGIONS[names[i % len(names)]]
                      for i in range(self.num_clients))
        return cycle

    def _hosts(self) -> Tuple[Host, Tuple[Host, ...]]:
        if self.kind == "lan":
            server = Host("server", LAN_TCP, 5.0 * GB, 5.0 * GB)
            clients = tuple(Host(f"client{i}", LAN_TCP, 5.0 * GB, 5.0 * GB)
                            for i in range(self.num_clients))
            return server, clients
        server = Host("server", NCAL, NCAL.bw_multi, NCAL.bw_multi)
        clients = tuple(Host(f"client{i}", r, r.bw_multi, r.bw_multi)
                        for i, r in enumerate(self.client_regions()))
        return server, clients

    def check(self) -> None:
        """Full spec validation without materialising the dense edge map
        (Scenario.validate() runs only this; build() runs it and then
        builds — the graph is constructed once per deployment)."""
        if self.kind not in TOPOLOGY_PRESETS:
            raise ScenarioError(
                f"topology.kind: unknown preset '{self.kind}'; choose "
                f"from {list(TOPOLOGY_PRESETS)}")
        if self.num_clients < 1:
            raise ScenarioError("topology.num_clients must be >= 1")
        if self.relay_depth < 1:
            raise ScenarioError("topology.relay_depth must be >= 1")
        self.client_regions()  # validates region names
        known = {"server"} | {f"client{i}" for i in range(self.num_clients)}
        for i, e in enumerate(self.edges):
            for end in (e.src, e.dst):
                if end not in known:
                    raise ScenarioError(
                        f"topology.edges[{i}]: endpoint '{end}' names no "
                        f"host in this topology (hosts: server, client0.."
                        f"client{self.num_clients - 1})")
            if e.bw_single_mb <= 0 or e.bw_multi_mb <= 0:
                raise ScenarioError(
                    f"topology.edges[{i}]: bandwidths must be positive")
            if e.latency_ms < 0:
                raise ScenarioError(
                    f"topology.edges[{i}]: latency_ms must be >= 0")
            # any touched rev_* field counts as directed-pair intent —
            # a lone negative bandwidth must error, not silently read
            # as a symmetric edge
            rev_touched = (e.rev_bw_single_mb != 0 or e.rev_bw_multi_mb != 0
                           or e.rev_latency_ms >= 0)
            if rev_touched:
                if e.rev_bw_single_mb < 0 or e.rev_bw_multi_mb < 0:
                    raise ScenarioError(
                        f"topology.edges[{i}]: rev_* bandwidths must be "
                        f"positive (0 = same as forward)")
                if not e.symmetric:
                    raise ScenarioError(
                        f"topology.edges[{i}]: the rev_* directed-pair "
                        f"shorthand installs both directions; it "
                        f"contradicts symmetric=False (declare two "
                        f"one-way edges instead)")

    # above this fleet size the dense presets switch to a lazy edge map:
    # the O(n^2) pair loop below would materialise 10^8 Link objects at
    # 10k clients, while _RuleLinks generates the identical edge on
    # first lookup (star/ring build O(n) maps and stay dense at any n)
    LAZY_LINKS_MIN = 65

    def build(self) -> Environment:
        """Materialise the full directed edge map (the explicit graph the
        backends consume instead of the old implicit region-pair rule)."""
        self.check()
        server, clients = self._hosts()
        hosts = [server] + list(clients)
        lazy = (self.num_clients >= self.LAZY_LINKS_MIN
                and self.kind not in ("star", "ring"))
        links: Dict[tuple, Link] = _RuleLinks(
            self.kind, {h.host_id: h for h in hosts}) if lazy else {}

        def put(a: Host, b: Host, region: Region, lan_class=False):
            links[(a.host_id, b.host_id)] = Link(a.host_id, b.host_id,
                                                 region, lan_class=lan_class)

        if lazy:
            pass  # the rule map generates the preset edges on demand
        elif self.kind == "lan":
            for a in hosts:
                for b in hosts:
                    if a is not b:
                        put(a, b, LAN_TCP, lan_class=True)
        elif self.kind in ("geo_proximal", "geo_distributed"):
            # the legacy implicit rule, made explicit: the non-hub end of
            # a transfer dominates (hub = NCAL, the paper's Table I frame)
            for a in hosts:
                for b in hosts:
                    if a is not b:
                        put(a, b, b.region if b.region.name != "ncal"
                            else a.region)
        elif self.kind == "star":
            # pure hub-and-spoke: only hub<->client edges exist
            for c in clients:
                put(server, c, c.region)
                put(c, server, c.region)
        elif self.kind == "ring":
            # hub edges (model distribution + the closing hop) plus a
            # client ring; a client-client WAN edge is the bottleneck of
            # the two Table-I hub links, with both one-way legs of delay
            for c in clients:
                put(server, c, c.region)
                put(c, server, c.region)
            n = len(clients)
            for i, c in enumerate(clients):
                d = clients[(i + 1) % n]
                ring = _bottleneck_region(c.region, d.region)
                put(c, d, ring)
                put(d, c, ring)
        elif self.kind == "multi_hub":
            # hierarchical: per-region relay hubs. WAN edges hub<->client
            # carry the region link; clients sharing a region get
            # DC-class intra-region edges (the relay's LAN-side fan-out)
            for c in clients:
                put(server, c, c.region)
                put(c, server, c.region)
            by_region: Dict[str, list] = {}
            for c in clients:
                by_region.setdefault(c.region.name, []).append(c)
            for group in by_region.values():
                for a in group:
                    for b in group:
                        if a is not b:
                            put(a, b, LAN_TCP)

        def edge_region(src, dst, bw_single_mb, bw_multi_mb, latency_ms,
                        max_conns):
            bw_multi = bw_multi_mb * MB
            if max_conns > 0:
                bw_multi = min(bw_multi, max_conns * bw_single_mb * MB)
            return Region(f"edge:{src}>{dst}", bw_single_mb * MB,
                          bw_multi, latency_ms * 1e-3)

        for e in self.edges:
            region = edge_region(e.src, e.dst, e.bw_single_mb,
                                 e.bw_multi_mb, e.latency_ms, e.max_conns)
            links[(e.src, e.dst)] = Link(e.src, e.dst, region,
                                         lan_class=e.lan_class)
            if e.asymmetric:
                # directed-pair shorthand: the reverse leg gets its own
                # rates (unset components inherit the forward values)
                rs, rm, rl = e.reverse_rates()
                rev = edge_region(e.dst, e.src, rs, rm, rl, e.max_conns)
                links[(e.dst, e.src)] = Link(e.dst, e.src, rev,
                                             lan_class=e.lan_class)
            elif e.symmetric:
                links[(e.dst, e.src)] = Link(e.dst, e.src, region,
                                             lan_class=e.lan_class)

        return Environment(
            name=self.kind, server=server, clients=clients,
            has_object_store=self.kind != "lan",
            trusted=self.kind in ("lan", "geo_proximal"),
            links=links)


def _bottleneck_region(a: Region, b: Region) -> Region:
    return Region(f"{a.name}~{b.name}", min(a.bw_single, b.bw_single),
                  min(a.bw_multi, b.bw_multi), a.latency + b.latency)


class _RuleLinks(dict):
    """Lazy edge map for the dense presets at fleet scale.

    ``get`` generates an edge on first lookup by the exact rule the
    dense ``build`` loop applies for the same preset (bit-identical
    Link values), then caches it, so a 10k-client topology never
    materialises its 10^8 host pairs. Explicit EdgeSpec overrides are
    stored eagerly through ``__setitem__`` and shadow the rule. Pairs
    the preset declares no edge for (e.g. cross-region client pairs in
    ``multi_hub``) return ``default`` — the same implicit-rule fallback
    ``Environment.link`` applies to a dense map without that key."""

    def __init__(self, kind: str, hosts: Dict[str, Host]):
        super().__init__()
        self._kind = kind
        self._hosts = hosts

    def __bool__(self):  # an empty cache still answers for every edge
        return True

    def get(self, key, default=None):
        hit = super().get(key)
        if hit is not None:
            return hit
        src_id, dst_id = key
        a = self._hosts.get(src_id)
        b = self._hosts.get(dst_id)
        if a is None or b is None or src_id == dst_id:
            return default
        if self._kind == "lan":
            edge = Link(src_id, dst_id, LAN_TCP, lan_class=True)
        elif self._kind in ("geo_proximal", "geo_distributed"):
            edge = Link(src_id, dst_id,
                        b.region if b.region.name != "ncal" else a.region)
        elif self._kind == "multi_hub":
            if "server" in (src_id, dst_id):
                spoke = b if src_id == "server" else a
                edge = Link(src_id, dst_id, spoke.region)
            elif a.region.name == b.region.name:
                edge = Link(src_id, dst_id, LAN_TCP)
            else:
                return default  # cross-region client pair: no edge
        else:
            return default
        self[key] = edge
        return edge


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Who trains: the model tier + local work per dispatch."""
    tier: str = "small"
    local_steps: int = 4
    # cohort sampling (the cross-device regime at fleet scale): each
    # aggregation round draws a seeded K-of-N client sample; 0 (or
    # K >= N) keeps the whole fleet in play, bit-for-bit today's runs
    cohort_k: int = 0
    # per-dispatch simulated compute seconds; 0.0 = the tier's
    # calibrated train time. A near-zero override turns a job into a
    # traffic generator (checkpoint sync / dataset replication tenants
    # in the multi-job studies: all wire, no training gaps)
    train_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """The wire stack every backend in the deployment drives."""
    backend: str = "grpc+s3"
    compression: str = "none"   # payload codec: qsgd[:block] | topk[:frac]
    wire_codec: str = "none"    # byte codec on the serialized wire: zlib[:lvl]
    chunk_mb: float = 0.0


@dataclasses.dataclass(frozen=True)
class BlackoutSpec:
    """One link outage window: nothing departs on the named edge during
    ``[t0, t1)``; departures shift to the window's end (a transient WAN
    partition). ``dst="*"`` darkens every link touching ``src`` (the
    per-host form — LinkFaultModel's original machinery); a concrete
    ``dst`` darkens only that edge. ``symmetric`` darkens both
    directions of the pair (partitions usually do)."""
    src: str
    dst: str = "*"
    t0: float = 0.0
    t1: float = 0.0
    symmetric: bool = True


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """What goes wrong (all deterministic from the scenario seed)."""
    link_loss: float = 0.0       # per-chunk loss on every graph edge
    max_retries: int = 4
    nack_rtts: float = 1.0       # receiver-driven NACK turnaround (edge RTTs)
    store_fail_rate: float = 0.0
    availability_trace: str = ""  # fl/fault.AvailabilityTrace spec
    trace_horizon_s: float = 3600.0
    blackouts: Tuple[BlackoutSpec, ...] = ()  # per-edge/-host outages
    # JSONL outage replay: one {"src", "dst", "t0", "t1", "symmetric"}
    # object per line, parsed into BlackoutSpecs and appended to the
    # inline list ("" = none). Relative paths resolve against the
    # scenario file's directory at Scenario.load time.
    blackouts_file: str = ""

    def all_blackouts(self) -> Tuple[BlackoutSpec, ...]:
        """Inline blackouts + the parsed trace file (in that order)."""
        if not self.blackouts_file:
            return self.blackouts
        return self.blackouts + load_blackouts_file(self.blackouts_file)


def load_blackouts_file(path: str) -> Tuple[BlackoutSpec, ...]:
    """Parse a JSONL blackout trace into BlackoutSpecs.

    One JSON object per line; blank lines and ``#`` comment lines are
    skipped. Every malformed line is a loud ``ScenarioError`` carrying
    ``path:lineno`` — an outage replay that silently drops windows would
    invalidate the whole study."""
    try:
        f = open(path)
    except OSError as e:
        raise ScenarioError(
            f"faults.blackouts_file: cannot read '{path}' "
            f"({e.strerror or e})") from None
    out = []
    with f:
        for ln, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            try:
                data = json.loads(line)
            except json.JSONDecodeError as e:
                raise ScenarioError(
                    f"{path}:{ln}: not valid JSON ({e.msg})") from None
            out.append(_from_dict(BlackoutSpec, data, f"{path}:{ln}"))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class StrategySpec:
    """How aggregation runs (fl/async_strategies.py + the sync loop)."""
    mode: str = "sync"
    rounds: int = 3
    buffer_k: int = 0
    staleness_exponent: float = 0.5
    max_staleness: int = 0
    staleness_adaptive: bool = False
    quorum_fraction: float = 1.0
    round_deadline_s: float = 0.0
    region_quorum: float = 0.5
    relay_conns: int = 8
    # fold arriving updates into an O(model) streaming accumulator at
    # the hub instead of buffering O(clients) payloads (fedbuff/semisync)
    streaming_hub: bool = False


@dataclasses.dataclass(frozen=True)
class SplitSpec:
    """The vertical/split-FL cut (fl/vertical.py; mode="vertical" only).

    ``cut_layer`` is the boundary index into the model's layer list: the
    feature parties own layers ``[0, cut_layer)`` (the bottom), the label
    party owns ``[cut_layer, L)`` (the top). ``batches_per_round`` is how
    many forward-activation / backward-gradient exchanges each party runs
    per aggregation round; ``activation_codec`` compresses the per-batch
    activation/gradient wires through the same CompressStage machinery as
    model updates ("none" | qsgd[:block] | topk[:frac])."""
    cut_layer: int = 1
    batches_per_round: int = 8
    activation_codec: str = "none"


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One complete, declarative experiment description."""
    name: str = "scenario"
    seed: int = 0
    topology: TopologySpec = TopologySpec()
    fleet: FleetSpec = FleetSpec()
    channel: ChannelSpec = ChannelSpec()
    faults: FaultSpec = FaultSpec()
    strategy: StrategySpec = StrategySpec()
    split: SplitSpec = SplitSpec()

    def __post_init__(self):
        # tolerate dict-form nested specs: Scenario(**sc.to_dict()) with
        # only *some* fields re-specified as dataclasses is an
        # established idiom, and it silently leaves the rest as plain
        # dicts — coerce them through the strict deserializer
        for field in ("topology", "fleet", "channel", "faults",
                      "strategy", "split"):
            v = getattr(self, field)
            if isinstance(v, dict):  # _NESTED is defined below; only
                # reached at call time, never during module import
                object.__setattr__(self, field,
                                   _from_dict(_NESTED[field], v, field))

    # -- validation --------------------------------------------------------
    def validate(self) -> "Scenario":
        from repro_torch.compression.stages import make_codec, split_codecs
        from repro_torch.core.backends import BACKEND_NAMES
        if self.channel.backend not in BACKEND_NAMES:
            raise ScenarioError(
                f"channel.backend: unknown backend "
                f"'{self.channel.backend}'; choose from {BACKEND_NAMES}")
        for field, spec in (("compression", self.channel.compression),
                            ("wire_codec", self.channel.wire_codec)):
            try:
                make_codec(spec)
            except KeyError as e:
                raise ScenarioError(f"channel.{field}: {e.args[0]}") from None
        try:
            split_codecs(self.channel.compression, self.channel.wire_codec)
        except ValueError as e:
            raise ScenarioError(f"channel: {e}") from None
        if self.strategy.mode not in MODES:
            raise ScenarioError(
                f"strategy.mode: unknown mode '{self.strategy.mode}'; "
                f"choose from {list(MODES)}")
        if self.split.cut_layer < 1:
            raise ScenarioError("split.cut_layer must be >= 1")
        if self.split.batches_per_round < 1:
            raise ScenarioError("split.batches_per_round must be >= 1")
        try:
            make_codec(self.split.activation_codec)
        except KeyError as e:
            raise ScenarioError(
                f"split.activation_codec: {e.args[0]}") from None
        if not 0.0 <= self.faults.link_loss < 1.0:
            raise ScenarioError("faults.link_loss must be in [0, 1)")
        if not 0.0 < self.strategy.quorum_fraction <= 1.0:
            raise ScenarioError("strategy.quorum_fraction must be in (0, 1]")
        if self.fleet.cohort_k < 0:
            raise ScenarioError("fleet.cohort_k must be >= 0")
        if self.fleet.train_s < 0:
            raise ScenarioError("fleet.train_s must be >= 0 (0 = tier default)")
        if self.fleet.cohort_k > self.topology.num_clients:
            raise ScenarioError(
                f"fleet.cohort_k ({self.fleet.cohort_k}) exceeds "
                f"topology.num_clients ({self.topology.num_clients})")
        if 0 < self.fleet.cohort_k < self.topology.num_clients and \
                self.strategy.mode not in ("fedbuff", "semisync"):
            raise ScenarioError(
                "fleet.cohort_k: cohort sampling applies to the event-"
                "driven fedbuff/semisync modes only")
        self.topology.check()  # bad preset/regions/edges, without building
        hosts = {"server"} | {f"client{i}"
                              for i in range(self.topology.num_clients)}
        n_inline = len(self.faults.blackouts)
        for i, b in enumerate(self.faults.all_blackouts()):
            # file-sourced windows validate by the same rules; label them
            # by their position in the trace so errors stay actionable
            where = (f"faults.blackouts[{i}]" if i < n_inline else
                     f"faults.blackouts_file entry {i - n_inline + 1} "
                     f"('{self.faults.blackouts_file}')")
            if b.t1 < b.t0 or b.t0 < 0:
                raise ScenarioError(
                    f"{where}: need 0 <= t0 <= t1 "
                    f"(got [{b.t0}, {b.t1}))")
            for end, name in ((b.src, "src"), (b.dst, "dst")):
                if end != "*" and end not in hosts:
                    raise ScenarioError(
                        f"{where}.{name}: '{end}' names no "
                        f"host in this topology (hosts: server, client0.."
                        f"client{self.topology.num_clients - 1}, or '*')")
            if b.src == "*":
                raise ScenarioError(
                    f"{where}.src must name a host "
                    f"(use dst='*' for the per-host form)")
        return self

    # -- (de)serialisation -------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "Scenario":
        return _from_dict(cls, data, "scenario")

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, text: str) -> "Scenario":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path: str) -> "Scenario":
        with open(path) as f:
            sc = cls.from_dict(json.load(f))
        return _anchor_blackouts_file(sc, path)

    @classmethod
    def from_fl_config(cls, cfg, *, tier: str = "small",
                       local_steps: int = 4,
                       store_fail_rate: float = 0.0) -> "Scenario":
        """The inverse bridge: lift a flat FLConfig into the declarative
        spec (legacy entry points — tests, examples — resolve through the
        same scenario runtime as ``--scenario`` files)."""
        return cls(
            name=f"fl:{cfg.mode}", seed=cfg.seed,
            topology=TopologySpec(kind=cfg.environment,
                                  num_clients=cfg.num_clients,
                                  relay_depth=getattr(cfg, "relay_depth",
                                                      1)),
            fleet=FleetSpec(tier=tier, local_steps=local_steps,
                            cohort_k=getattr(cfg, "cohort_k", 0)),
            channel=ChannelSpec(backend=cfg.backend,
                                compression=cfg.compression,
                                wire_codec=getattr(cfg, "wire_codec",
                                                   "none"),
                                chunk_mb=cfg.chunk_mb),
            faults=FaultSpec(link_loss=cfg.link_loss_rate,
                             store_fail_rate=store_fail_rate,
                             availability_trace=cfg.availability_trace),
            strategy=StrategySpec(
                mode=cfg.mode, rounds=cfg.rounds, buffer_k=cfg.buffer_k,
                staleness_exponent=cfg.staleness_exponent,
                max_staleness=cfg.max_staleness,
                staleness_adaptive=cfg.staleness_adaptive,
                quorum_fraction=cfg.quorum_fraction,
                round_deadline_s=cfg.round_deadline_s,
                region_quorum=cfg.region_quorum,
                relay_conns=getattr(cfg, "relay_conns", 8),
                streaming_hub=getattr(cfg, "streaming_hub", False)),
            split=SplitSpec(
                cut_layer=getattr(cfg, "cut_layer", 1),
                batches_per_round=getattr(cfg, "batches_per_round", 8),
                activation_codec=getattr(cfg, "activation_codec", "none")))

    # -- the bridge to the runtime config ----------------------------------
    def fl_config(self):
        """The equivalent flat FLConfig (what the strategies/driver read)."""
        from repro_torch.configs.base import FLConfig
        return FLConfig(
            num_clients=self.topology.num_clients,
            backend=self.channel.backend,
            environment=self.topology.kind,
            rounds=self.strategy.rounds,
            quorum_fraction=self.strategy.quorum_fraction,
            round_deadline_s=self.strategy.round_deadline_s,
            seed=self.seed,
            mode=self.strategy.mode,
            buffer_k=self.strategy.buffer_k,
            staleness_exponent=self.strategy.staleness_exponent,
            max_staleness=self.strategy.max_staleness,
            staleness_adaptive=self.strategy.staleness_adaptive,
            compression=self.channel.compression,
            wire_codec=self.channel.wire_codec,
            chunk_mb=self.channel.chunk_mb,
            availability_trace=self.faults.availability_trace,
            link_loss_rate=self.faults.link_loss,
            region_quorum=self.strategy.region_quorum,
            relay_conns=self.strategy.relay_conns,
            relay_depth=self.topology.relay_depth,
            cohort_k=self.fleet.cohort_k,
            streaming_hub=self.strategy.streaming_hub,
            cut_layer=self.split.cut_layer,
            batches_per_round=self.split.batches_per_round,
            activation_codec=self.split.activation_codec)


# ---------------------------------------------------------------------------
# multi-tenant scenarios: N jobs on one fabric
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One tenant job of a multi-tenant deployment: a full Scenario plus
    its co-scheduling knobs. ``priority`` feeds the fabric's admission
    policy (higher preempts under ``policy="priority"``); ``weight``
    scales the job's fair-share grant (``cap * w_i / sum(w)`` under
    ``policy="fair-share"`` — weight 1.0 everywhere reproduces the
    unweighted ``cap / k`` split exactly); ``start_s`` offsets the job's
    bootstrap on the shared clock; ``rounds`` caps the job's
    aggregations (0 = the scenario's own ``strategy.rounds``)."""
    name: str
    scenario: Scenario = Scenario()
    priority: int = 0
    weight: float = 1.0
    start_s: float = 0.0
    rounds: int = 0

    def cap(self) -> int:
        return self.rounds or self.scenario.strategy.rounds


@dataclasses.dataclass(frozen=True)
class MultiScenario:
    """N co-scheduled jobs sharing one topology, one fabric, one clock.

    Every job must declare the *same* topology — tenants contend for one
    physical network, they don't each get their own. The fabric spec
    defaults to fifo admission over shared links (contention on), since
    a multi-tenant run with isolated links is just N solo runs."""
    name: str = "multi"
    fabric: FabricSpec = FabricSpec(policy="fifo", shared_links=True)
    jobs: Tuple[JobSpec, ...] = ()

    def validate(self) -> "MultiScenario":
        if not self.jobs:
            raise ScenarioError("jobs: a MultiScenario needs >= 1 job")
        names = [j.name for j in self.jobs]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ScenarioError(f"jobs: duplicate job name(s) {dupes}")
        base = self.jobs[0].scenario.topology
        for i, j in enumerate(self.jobs):
            where = f"jobs[{i}] ('{j.name}')"
            if not j.name or "::" in j.name:
                raise ScenarioError(
                    f"{where}: job names must be non-empty and free of "
                    f"'::' (the fabric's tenant separator)")
            if j.cap() < 1:
                raise ScenarioError(
                    f"{where}: needs a positive aggregation cap "
                    f"(rounds= or scenario.strategy.rounds)")
            if not j.weight > 0:
                raise ScenarioError(
                    f"{where}: weight must be > 0 (got {j.weight})")
            if j.scenario.strategy.mode not in ("fedbuff", "semisync"):
                raise ScenarioError(
                    f"{where}: co-scheduling drives the event-driven "
                    f"fedbuff/semisync modes (got "
                    f"'{j.scenario.strategy.mode}')")
            if j.scenario.topology != base:
                raise ScenarioError(
                    f"{where}: topology differs from jobs[0]'s — tenants "
                    f"share ONE physical network; declare the same "
                    f"topology in every job")
            try:
                j.scenario.validate()
            except ScenarioError as e:
                raise ScenarioError(f"{where}: {e}") from None
        return self

    # -- (de)serialisation -------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "MultiScenario":
        return _from_dict(cls, data, "multi")

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, text: str) -> "MultiScenario":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path: str) -> "MultiScenario":
        with open(path) as f:
            ms = cls.from_dict(json.load(f))
        jobs = tuple(dataclasses.replace(
            j, scenario=_anchor_blackouts_file(j.scenario, path))
            for j in ms.jobs)
        return dataclasses.replace(ms, jobs=jobs)


def _anchor_blackouts_file(sc: Scenario, spec_path: str) -> Scenario:
    """Resolve a relative ``faults.blackouts_file`` against the spec
    file's directory, so a scenario pack stays relocatable."""
    bf = sc.faults.blackouts_file
    if not bf or os.path.isabs(bf):
        return sc
    anchored = os.path.join(os.path.dirname(os.path.abspath(spec_path)), bf)
    return dataclasses.replace(
        sc, faults=dataclasses.replace(sc.faults, blackouts_file=anchored))


# ---------------------------------------------------------------------------
# strict recursive deserialisation
# ---------------------------------------------------------------------------

_NESTED = {"topology": TopologySpec, "fleet": FleetSpec,
           "channel": ChannelSpec, "faults": FaultSpec,
           "strategy": StrategySpec, "split": SplitSpec}


def _from_dict(cls, data, path):
    if not isinstance(data, dict):
        raise ScenarioError(
            f"{path}: expected an object, got {type(data).__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = sorted(set(data) - set(fields))
    if unknown:
        raise ScenarioError(
            f"{path}: unknown key(s) {unknown}; valid keys: "
            f"{sorted(fields)}")
    kw = {}
    for k, v in data.items():
        sub = _NESTED.get(k) if cls is Scenario else None
        if sub is not None:
            kw[k] = _from_dict(sub, v, f"{path}.{k}")
        elif cls is TopologySpec and k == "edges":
            if not isinstance(v, (list, tuple)):
                raise ScenarioError(f"{path}.edges: expected a list")
            kw[k] = tuple(_from_dict(EdgeSpec, e, f"{path}.edges[{i}]")
                          for i, e in enumerate(v))
        elif cls is FaultSpec and k == "blackouts":
            if not isinstance(v, (list, tuple)):
                raise ScenarioError(f"{path}.blackouts: expected a list")
            kw[k] = tuple(_from_dict(BlackoutSpec, b,
                                     f"{path}.blackouts[{i}]")
                          for i, b in enumerate(v))
        elif cls is MultiScenario and k == "jobs":
            if not isinstance(v, (list, tuple)):
                raise ScenarioError(f"{path}.jobs: expected a list")
            kw[k] = tuple(_from_dict(JobSpec, j, f"{path}.jobs[{i}]")
                          for i, j in enumerate(v))
        elif cls is MultiScenario and k == "fabric":
            kw[k] = _from_dict(FabricSpec, v, f"{path}.fabric")
        elif cls is JobSpec and k == "scenario":
            kw[k] = _from_dict(Scenario, v, f"{path}.scenario")
        elif isinstance(v, list):
            kw[k] = tuple(v)
        else:
            kw[k] = v
    try:
        return cls(**kw)
    except (TypeError, ValueError) as e:
        raise ScenarioError(f"{path}: {e}") from None


# ---------------------------------------------------------------------------
# CLI override layering
# ---------------------------------------------------------------------------

def with_overrides(scenario: Scenario, overrides: dict) -> Scenario:
    """Layer dotted-path overrides onto a scenario: ``{"channel.backend":
    "grpc"}``. ``None`` values are skipped — exactly the contract
    ``fl_train`` needs, where an unset CLI flag must not clobber the
    loaded spec."""
    for path, value in overrides.items():
        if value is None:
            continue
        parts = path.split(".")
        scenario = _replace_path(scenario, parts, value)
    return scenario


def _replace_path(node, parts, value):
    if len(parts) == 1:
        if not any(f.name == parts[0] for f in dataclasses.fields(node)):
            raise ScenarioError(
                f"override: '{parts[0]}' is not a field of "
                f"{type(node).__name__}")
        return dataclasses.replace(node, **{parts[0]: value})
    child = getattr(node, parts[0])
    return dataclasses.replace(
        node, **{parts[0]: _replace_path(child, parts[1:], value)})
