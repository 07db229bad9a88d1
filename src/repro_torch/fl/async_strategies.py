"""Port of ``src/repro/fl/async_strategies.py`` (copied; imports
re-pointed, and the relay backends built on the server backend's
device).

Aggregation strategies for the event-driven FL scheduler.

Three modes beyond the paper's synchronous loop, selectable from
``FLConfig.mode``:

* ``FedBuffStrategy``     — async buffered aggregation: the server merges a
  staleness-weighted buffer every K arrivals and immediately hands the
  reporting client the newest global model (FedBuff-style; Nguyen et al.).
* ``SemiSyncStrategy``    — quorum + deadline rounds reusing the sync
  straggler policy, but late arrivals are *folded into the next round*
  (with staleness ≥ 1) instead of dropped.
* ``HierarchicalStrategy``— topology-aware per-region relays: clients
  reduce locally over a LAN-class link, then one multi-connection WAN hop
  per region to the hub (Marfoq et al.'s throughput-optimal topology line).
  The hub's FedAvg over weighted relay partials is numerically identical
  to flat FedAvg (tested).

Strategies receive scheduler callbacks (``on_update`` / ``on_timer``) and
use ``sched.dispatch`` / ``sched.aggregate`` / ``sched.timer`` to shape
the event flow.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.message import FLMessage, TensorPayload, VirtualPayload
from repro_torch.core.netsim import (LAN_TCP, Region, Transfer,
                                     simulate_transfers, transfer_time)
from repro_torch.fl.aggregator import (fedavg, simulated_agg_time,
                                       staleness_weight)
from repro_torch.fl.scheduler import FLScheduler, UpdateRecord


class AggregationStrategy:
    """Base: broadcast-once bootstrap + staleness weight and churn hooks."""

    name = "base"
    staleness_exponent = 0.0

    def staleness_weight(self, staleness: float) -> float:
        return staleness_weight(staleness, self.staleness_exponent)

    def start(self, sched: FLScheduler, now: float):
        self.sched = sched
        sched.dispatch_many(sched.clients, now)

    def on_update(self, sched: FLScheduler, rec: UpdateRecord, now: float):
        raise NotImplementedError

    def on_timer(self, sched: FLScheduler, now: float, **data):
        pass

    # -- churn (fl/fault.AvailabilityTrace) -----------------------------
    def on_leave(self, sched: FLScheduler, client, now: float):
        """A client departed. In-flight updates from it are discarded by
        the scheduler's apply guard; strategies with round structure
        override to re-check quorums."""

    def on_join(self, sched: FLScheduler, client, now: float):
        """A client (re)joined: hand it the current model. Over grpc+s3
        this is the S3 late-join re-fetch (cached object, no sender
        re-upload); round-structured strategies may instead fold the
        client in at the next round boundary."""
        sched.rejoin(client, now)


class FedBuffStrategy(AggregationStrategy):
    """Async FedBuff-style: merge every K arrivals, discount stale updates,
    re-dispatch the newest global to each reporter immediately.

    ``staleness_adaptive`` (FedAsync-style; Xie et al. 2019) scales the
    discount exponent by each update's percentile rank among the staleness
    values observed so far: an update staler than most of the fleet is
    discounted harder than the fixed ``(1+s)^-a`` curve, a fresher-than-
    typical one more gently. With adaptivity off the weighting *is* the
    fixed polynomial — tested."""

    name = "fedbuff"

    def __init__(self, *, buffer_k: int = 3, staleness_exponent: float = 0.5,
                 max_staleness: int = 0, staleness_adaptive: bool = False,
                 adaptive_window: int = 64):
        self.buffer_k = max(1, int(buffer_k))
        self.staleness_exponent = staleness_exponent
        self.max_staleness = int(max_staleness)  # 0 = keep everything
        self.staleness_adaptive = bool(staleness_adaptive)
        self.adaptive_window = int(adaptive_window)
        self.observed: List[float] = []  # rolling staleness window
        self.buffer: List[UpdateRecord] = []

    def staleness_weight(self, staleness: float) -> float:
        exponent = self.staleness_exponent
        if self.staleness_adaptive and self.observed:
            # percentile rank in [0, 1]; exponent spans [0.5a, 1.5a]
            rank = np.mean([o <= staleness for o in self.observed])
            exponent = self.staleness_exponent * (0.5 + float(rank))
        return staleness_weight(staleness, exponent)

    def observe(self, staleness: float):
        self.observed.append(float(staleness))
        if len(self.observed) > self.adaptive_window:
            del self.observed[:-self.adaptive_window]

    def on_update(self, sched: FLScheduler, rec: UpdateRecord, now: float):
        t = now
        self.observe(rec.staleness)
        if self.max_staleness and rec.staleness > self.max_staleness:
            sched.discarded += 1
        else:
            self.buffer.append(sched.hub_fold(rec, now))
            if len(self.buffer) >= self.buffer_k:
                recs, self.buffer = self.buffer, []
                t = sched.aggregate(recs, now)
        if rec.client is not None:
            sched.dispatch(rec.client, t)


class SemiSyncStrategy(AggregationStrategy):
    """Quorum + deadline rounds; stragglers are folded into the next round
    (their updates arrive with staleness ≥ 1), never dropped."""

    name = "semisync"

    def __init__(self, *, quorum_fraction: float = 1.0,
                 round_deadline_s: float = 0.0,
                 staleness_exponent: float = 0.0):
        self.quorum_fraction = quorum_fraction
        self.round_deadline_s = round_deadline_s
        self.staleness_exponent = staleness_exponent
        self.round_id = 0
        self.collected: List[UpdateRecord] = []

    def start(self, sched: FLScheduler, now: float):
        super().start(sched, now)
        self._arm(sched, now)

    def _need(self, sched) -> int:
        # clamp like the sync server — against the *eligible* fleet (live
        # cohort members under cohort sampling, the live fleet otherwise):
        # a quorum over departed or unsampled clients would stall forever
        n_live = sched.eligible_count()
        need = int(np.ceil(self.quorum_fraction * max(n_live, 1)))
        return min(max(1, need), max(n_live, 1))

    def _arm(self, sched, now: float):
        if self.round_deadline_s > 0:
            sched.timer(now + self.round_deadline_s,
                        f"deadline#r{self.round_id}", self.on_timer,
                        round_id=self.round_id)

    def on_update(self, sched, rec: UpdateRecord, now: float):
        self.collected.append(sched.hub_fold(rec, now))
        if len(self.collected) >= self._need(sched):
            self._close(sched, now)

    def on_leave(self, sched, client, now: float):
        # a departure shrinks the quorum: the collected set may already
        # satisfy it (mid-round departures must not stall the round)
        if self.collected and len(self.collected) >= self._need(sched):
            self._close(sched, now)

    def on_timer(self, sched, now: float, round_id: int):
        if round_id != self.round_id:
            return  # stale timer from an already-closed round
        if self.collected:
            self._close(sched, now)
        else:
            self._arm(sched, now)  # nothing arrived yet: extend the round

    def _close(self, sched, now: float):
        recs, self.collected = self.collected, []
        done = sched.aggregate(recs, now)
        self.round_id += 1
        sched.dispatch_many([r.client for r in recs if r.client is not None],
                            done)
        self._arm(sched, done)


class HierarchicalStrategy(AggregationStrategy):
    """Per-region relay aggregators (topology-aware synchronous rounds).

    Round shape: hub -> one WAN hop per region relay -> LAN fan-out to the
    region's clients; uploads reduce at the relay over LAN, then a single
    multi-connection WAN hop back to the hub. The relay is colocated with
    the region's first client and multiplexes ``relay_conns`` connections
    on its WAN hop — the paper's own Fig 2 concurrency lesson applied to
    topology. The hub merge of weighted relay partials equals flat FedAvg.

    The relay -> hub hop is a *real backend channel over the topology's
    graph edge* (relay host -> hub), not an analytic formula: each region
    gets its own backend instance — same family as the deployment's —
    whose wire stack carries the WAN compression / wire codec / chunking,
    so the hop is faultable by the fabric's LinkFaultModel (chunk loss,
    NACK retransmits, blackouts), cacheable by the object store, and
    decodes at the hub by recorded provenance like any other wire.
    """

    name = "hier"

    def __init__(self, *, relay_link: Region = LAN_TCP, relay_conns: int = 8,
                 staleness_exponent: float = 0.0, wan_compression=None,
                 wan_wire_codec=None, chunk_mb: float = 0.0,
                 region_quorum: float = 0.5, relay_depth: int = 1):
        self.relay_link = relay_link
        self.relay_conns = relay_conns
        self.staleness_exponent = staleness_exponent
        # reduction-tree depth on the upload side: 1 = every region relay
        # ships straight to the hub (the historical single-tier path,
        # bit-for-bit); D > 1 inserts D-1 tiers of super-relays between
        # the region relays and the hub, each folding its children's
        # partials before one upstream hop. The downlink stays
        # single-tier — the hub's broadcast already fans out through the
        # region relays, and multi-download (S3) makes a nested downlink
        # redundant.
        self.relay_depth = max(1, int(relay_depth))
        # relay-level quorum: a region with fewer than
        # ceil(region_quorum * members) live clients is *skipped* for the
        # round (its relay sends nothing, the hub does not wait) and
        # folded back in at the first round boundary after a rejoin
        self.region_quorum = float(region_quorum)
        self.rounds_with_skips = 0
        self.idle_since: Optional[float] = None
        # gradient compression on the relay -> hub WAN hop *only*: the
        # LAN-local reduce and the model downlink stay exact, so the hub
        # merges dequantised partials and error feedback keeps each
        # region's residual bounded across rounds. The codecs ride the
        # relay backends' own channels — one backend per region, so the
        # EF stream is naturally per-region.
        self.wan_compression = wan_compression
        self.wan_wire_codec = wan_wire_codec
        self.chunk_mb = float(chunk_mb)
        self._relay_be: Dict[str, object] = {}  # region -> relay backend

    # -- setup -------------------------------------------------------------
    def start(self, sched: FLScheduler, now: float):
        self.sched = sched
        env = sched.env
        groups: Dict[str, list] = {}
        for c in sched.clients:
            groups.setdefault(env.host(c.client_id).region.name, []).append(c)
        self.groups = dict(sorted(groups.items()))
        probe = FLMessage("model_sync", sched.backend.host_id, "server",
                          payload=sched.global_payload)
        self._be = sched._resolved(probe)
        self._group_meta: Dict[str, tuple] = {}  # region -> (client, count)
        # per-round relay election: the region's first *live* member
        # (set in _begin_round; fan-out, member uploads and the WAN
        # partial must all agree on the relay host, also under churn)
        self._relay_host: Dict[str, str] = {}
        self._build_tree()
        self._begin_round(sched, now)

    # -- relay tree (relay_depth > 1) --------------------------------------
    def _build_tree(self):
        """Chunk the sorted region list into D-1 tiers of super-relays.

        Tier t groups the previous tier's nodes into chunks of
        ``fan = max(2, ceil(sqrt(len)))``; a tier that collapses to one
        node ends the tree early (more depth would only relabel it).
        ``_parent`` maps every node (region name or tier node id) to its
        parent, 'hub' at the top."""
        self._parent = {g: "hub" for g in self.groups}
        self._children: Dict[str, list] = {}
        self._top = list(self.groups)
        if self.relay_depth <= 1:
            return
        level = list(self.groups)
        for tier in range(1, self.relay_depth):
            if len(level) <= 1:
                break
            fan = max(2, math.ceil(len(level) ** 0.5))
            nxt = []
            for i in range(0, len(level), fan):
                node = f"tier{tier}.{i // fan}"
                kids = level[i:i + fan]
                self._children[node] = kids
                for kd in kids:
                    self._parent[kd] = node
                nxt.append(node)
            level = nxt
        for node in level:
            self._parent[node] = "hub"
        self._top = level

    def _desc_groups(self, node: str) -> list:
        """Descendant region names of ``node`` in region-sorted order."""
        if node in self.groups:
            return [node]
        out = []
        for kd in self._children[node]:
            out.extend(self._desc_groups(kd))
        return out

    def _node_host(self, node: str) -> str:
        """The host a tree node runs on: a region's elected relay, or —
        for a super-relay — the relay of its first round-active
        descendant region (falling back to the first descendant when no
        round is open)."""
        if node in self.groups:
            return self._relay_id(node)
        active = getattr(self, "_round_active", None)
        desc = self._desc_groups(node)
        for g in desc:
            if active is None or g in active:
                return self._relay_id(g)
        return self._relay_id(desc[0])

    def _wan_conns(self) -> int:
        return max(self._be.policy.conns_per_transfer, self.relay_conns)

    def _relay_id(self, group: str) -> str:
        """The host currently acting as ``group``'s relay: elected at
        round begin among live members; static first member as the
        fallback for paths that run with no round open (skip records)."""
        return self._relay_host.get(group, self.groups[group][0].client_id)

    def _relay_backend(self, group: str):
        return self._backend_at(self._relay_id(group))

    def _backend_at(self, host_id: str):
        """A relay's channel: same backend family as the deployment,
        colocated with ``host_id`` (a region's elected relay or a
        super-relay tier node's host), WAN hop multiplexed over
        ``relay_conns`` connections. Cached per host — if churn migrates
        a region's relay, the new host starts a fresh channel (and a
        fresh error-feedback stream, as a real relay would)."""
        be = self._relay_be.get(host_id)
        if be is None:
            import dataclasses as _dc

            from repro_torch.core.backends import make_backend
            from repro_torch.core.backends.grpc_s3 import GrpcS3Backend
            sched = self.sched
            be = make_backend(
                getattr(sched.backend, "name", "grpc"), sched.env,
                sched.backend.fabric, host_id,
                store=getattr(sched.backend, "store", None),
                compression=self.wan_compression,
                wire_codec=self.wan_wire_codec, chunk_mb=self.chunk_mb,
                device=sched.backend.device)
            for sub in (be, getattr(be, "grpc", None),
                        getattr(be, "membuff", None)):
                if sub is None or isinstance(sub, GrpcS3Backend) \
                        or not hasattr(sub, "policy"):
                    continue  # multipart GET *is* grpc+s3's concurrency
                sub.policy = _dc.replace(
                    sub.policy, conns_per_transfer=max(
                        sub.policy.conns_per_transfer, self.relay_conns))
            self._relay_be[host_id] = be
        return be

    def wan_ef_states(self):
        """Per-region error-feedback residuals living on the relay
        channels' CompressStages (fidelity probes: tests, fig7)."""
        from repro_torch.core.channel import (CompressStage,
                                              WireCompressStage)
        states = []
        for be in self._relay_be.values():
            channels = [getattr(sub, "channel", None)
                        for sub in (be, getattr(be, "grpc", None),
                                    getattr(be, "membuff", None),
                                    getattr(be, "s3", None))]
            for ch in channels:
                if ch is None:
                    continue
                for st in ch.stages:
                    if isinstance(st, CompressStage) and \
                            not isinstance(st, WireCompressStage):
                        states.extend(st._state.values())
        return states

    def _lan_link(self, src_id: str, dst_id: str) -> Region:
        """The intra-region leg: the topology's explicit DC-class edge
        when the graph declares one (multi_hub / custom EdgeSpecs), else
        the configured ``relay_link`` class. WAN-rule fallback edges are
        deliberately ignored — colocated silos reduce over the local
        fabric, not through the hub link."""
        links = getattr(self.sched.env, "links", None) or {}
        edge = links.get((src_id, dst_id))
        if edge is not None and (edge.lan_class
                                 or edge.region.name.startswith("lan")):
            return edge.region
        return self.relay_link

    def _lan_hop(self, nbytes: int, src_id: str = "", dst_id: str = "") -> float:
        link = self._lan_link(src_id, dst_id)
        ser = self._be.serializer.ser_time(nbytes)
        deser = self._be.serializer.deser_time(nbytes)
        return ser + transfer_time(nbytes, link) + deser

    # -- round flow --------------------------------------------------------
    def _live_groups(self, sched) -> Dict[str, list]:
        """Regions meeting the relay quorum this round, with their live
        members (insertion order preserved from ``self.groups``)."""
        active: Dict[str, list] = {}
        for g, cs in self.groups.items():
            live = [c for c in cs if sched.is_up(c.client_id)]
            need = max(1, int(np.ceil(self.region_quorum * len(cs))))
            if len(live) >= need:
                active[g] = live
        return active

    def _begin_round(self, sched, now: float):
        active = self._live_groups(sched)
        if not active:
            # every region below quorum: stall until a rejoin restarts us
            # (not counted as a skipping round — no round began)
            self.idle_since = now
            return
        if len(active) < len(self.groups):
            self.rounds_with_skips += 1
        self.idle_since = None
        self.pending = {g: {c.client_id for c in cs}
                        for g, cs in active.items()}
        self.partials: Dict[str, List[UpdateRecord]] = {g: [] for g in active}
        self._round_active = set(active)
        if self.relay_depth > 1:
            # arm the super-relay tiers: each node waits on the children
            # with at least one round-active descendant region; the hub
            # waits on the active top-tier nodes
            self._node_expected: Dict[str, set] = {}
            self._node_partials: Dict[str, List[UpdateRecord]] = {}
            for nd, kids in self._children.items():
                exp = {kd for kd in kids
                       if any(g in self._round_active
                              for g in self._desc_groups(kd))}
                if exp:
                    self._node_expected[nd] = exp
                    self._node_partials[nd] = []
            self.expected = {nd for nd in self._top
                             if any(g in self._round_active
                                    for g in self._desc_groups(nd))}
        else:
            self.expected = set(active)  # groups the hub still waits on
        self.hub_records: List[UpdateRecord] = []
        be, env = self._be, sched.env
        nbytes = sched.global_payload.nbytes
        ser_t = be.serializer.ser_time(nbytes)
        hub = env.host(sched.backend.host_id)
        # hub -> relays: one concurrent multi-connection WAN hop per region
        transfers, order, t_ser = [], [], now
        for g, cs in active.items():
            # elect this round's relay: the region's first live member
            self._relay_host[g] = cs[0].client_id
            relay_host = env.host(cs[0].client_id)
            region = be._link_region(cs[0].client_id)
            if be.policy.ser_parallel:
                start = now + ser_t
            else:
                t_ser += ser_t
                start = t_ser
            transfers.append(Transfer(
                start=start + be._overhead(region), src=hub, dst=relay_host,
                nbytes=nbytes, conns=self._wan_conns(), link_region=region,
                tag=f"hub->{g}"))
            order.append((g, cs))
        simulate_transfers(transfers)
        deser = be.serializer.deser_time(nbytes)
        for (g, cs), tr in zip(order, transfers):
            relay_t = tr.finish + deser
            relay_id = self._relay_host[g]
            # relay fans out to its members over the intra-region leg
            t = relay_t
            for c in cs:
                if be.policy.ser_parallel:
                    ready = relay_t + self._lan_hop(nbytes, relay_id,
                                                    c.client_id)
                else:
                    t += be.serializer.ser_time(nbytes)
                    ready = (t + transfer_time(
                        nbytes, self._lan_link(relay_id, c.client_id))
                        + deser)
                sched.loop.call_at(ready, f"hier-model>{c.client_id}",
                                   self._on_member_model, client=c, group=g)

    # -- churn -----------------------------------------------------------
    def on_leave(self, sched, client, now: float):
        g = sched.env.host(client.client_id).region.name
        self._member_gone(g, client.client_id, now)

    def on_join(self, sched, client, now: float):
        # folded in at the next round boundary (the relay re-counts its
        # live members in _begin_round); if every region had churned below
        # quorum the round loop stalled — the rejoin restarts it
        if self.idle_since is not None and self._live_groups(sched):
            self._begin_round(sched, now)

    def _member_gone(self, group: str, client_id: str, now: float):
        pend = getattr(self, "pending", {}).get(group)
        if pend is None or client_id not in pend:
            return
        pend.discard(client_id)
        if not pend:
            self._finish_group(group, now)

    def _on_member_model(self, now: float, client, group: str):
        sched = self.sched
        if not sched.is_up(client.client_id):
            # departed while the model was in flight: mid-round departure
            self._member_gone(group, client.client_id, now)
            return
        if client.client_id not in self.pending.get(group, set()):
            return  # superseded round (the region closed without us)
        msg = FLMessage("model_sync", f"relay:{group}", client.client_id,
                        round=sched.version, payload=sched.global_payload,
                        metadata={"version": sched.version})
        update, _timing, send_start = client.run_round(
            msg, now, sched.local_steps)
        nb = update.payload.nbytes
        relay_recv = send_start + self._lan_hop(
            nb, client.client_id, self._relay_id(group))
        rec = UpdateRecord(
            client=client, payload=update.payload,
            weight=float(update.metadata.get("num_examples", 1)),
            version=int(msg.metadata["version"]), staleness=0,
            arrive_t=relay_recv)
        sched.loop.call_at(relay_recv, f"hier-relay<{client.client_id}",
                           self._on_relay_update, group=group, rec=rec)

    def _on_relay_update(self, now: float, group: str, rec: UpdateRecord):
        cid = rec.client.client_id
        if cid not in self.pending.get(group, set()):
            return  # departed mid-round / region already closed: dropped
        self.partials[group].append(rec)
        self.pending[group].discard(cid)
        if self.pending[group]:
            return
        self._finish_group(group, now)

    def _finish_group(self, group: str, now: float):
        """Every pending member of ``group`` reported or departed: relay
        reduces and ships its partial over the WAN — or, churned empty,
        notifies the hub with a bare control record so the round closes."""
        sched = self.sched
        recs = self.partials[group]
        be = self._be
        if not recs:
            member = self.groups[group][0]
            region = be._link_region(member.client_id)
            self._notify_skip(group,
                              now + be._overhead(region) + region.latency)
            return
        weight = float(sum(r.weight for r in recs))
        trees = [r.payload.tree for r in recs
                 if isinstance(r.payload, TensorPayload)]
        if len(trees) == len(recs):
            partial, agg_s = fedavg(trees, [r.weight for r in recs])
            payload = TensorPayload(partial)
        else:
            nb = recs[0].payload.nbytes
            agg_s = simulated_agg_time(nb, len(recs))
            # the tag carries the version: each round's partial is a new
            # object (the relay channel's store cache must not re-serve
            # last round's bytes for this round's merge)
            payload = VirtualPayload(
                nb, tag=f"relay:{group}:v{recs[0].version}")
        self._group_meta[group] = (recs[0].client, len(recs))
        self._send_partial(group, payload, weight, recs[0].version,
                           len(recs), now + agg_s, 0)

    def _notify_skip(self, node: str, t: float):
        """Resolve ``node`` as a skip at its parent — the hub for
        single-tier trees (and top-tier nodes), the next super-relay up
        otherwise, so a churned-empty region still closes every tier."""
        parent = self._parent.get(node, "hub")
        if parent == "hub":
            self.sched.loop.call_at(t, f"hier-skip<{node}",
                                    self._on_hub_partial, rec=None,
                                    group=node)
        else:
            self.sched.loop.call_at(t, f"hier-skip<{node}",
                                    self._on_node_skip, node=parent,
                                    child=node)

    def _send_partial(self, group: str, payload, weight: float,
                      version: int, count: int, t: float, attempt: int):
        """Ship one tree node's reduced partial one hop upstream over the
        node's real backend channel (graph edge node-host -> parent
        host, the hub at the top): compression / wire codec / chunking
        ride the channel, the fabric's fault model can lose chunks, and
        a transfer the model fails outright is re-issued with bounded
        retries before the node resolves as a skip — the hub never
        wedges on a dead WAN edge. ``group`` is a region name or a
        ``tierN.M`` super-relay node id."""
        sched = self.sched
        parent = self._parent.get(group, "hub")
        relay = self._backend_at(self._node_host(group))
        dest = sched.backend.host_id if parent == "hub" \
            else self._node_host(parent)
        msg = FLMessage("relay_partial", relay.host_id, dest, round=version,
                        payload=payload,
                        metadata={"group": group, "weight": weight,
                                  "count": count, "version": version})
        h = relay.isend(msg, t)
        if getattr(h, "failed", False):
            sched.transfer_failures += 1
            if attempt < 2:
                sched.loop.call_at(
                    max(t, h.start) + sched.redispatch_backoff_s,
                    f"hier-wan-retry<{group}",
                    lambda now, g=group, p=payload, w=weight, v=version,
                    c=count, a=attempt:
                    self._send_partial(g, p, w, v, c, now, a + 1))
            else:
                self._notify_skip(group, h.start)
            return
        if parent == "hub":
            sched.loop.call_at(h.inbox_t, f"hier-hub<{group}",
                               self._on_hub_arrival)
        else:
            sched.loop.call_at(h.inbox_t, f"hier-tier<{parent}",
                               self._on_tier_arrival, node=parent,
                               be=self._backend_at(dest))

    # -- super-relay tiers (relay_depth > 1) -------------------------------
    def _on_tier_arrival(self, now: float, node: str, be):
        """Drain a super-relay's endpoint: child partials decode by their
        recorded wire stages, then join the node's fold at their
        decode-complete time (the hub-arrival flow, one tier down)."""
        sched = self.sched
        for msg, ready in be.recv(now):
            if msg.msg_type != "relay_partial":
                continue
            rec = UpdateRecord(client=None, payload=msg.payload,
                               weight=float(msg.metadata["weight"]),
                               version=int(msg.metadata["version"]),
                               staleness=0, arrive_t=ready,
                               count=int(msg.metadata["count"]))
            sched.loop.call_at(ready, f"hier-fold<{node}",
                               self._on_node_partial, node=node, rec=rec,
                               child=msg.metadata["group"])

    def _on_node_skip(self, now: float, node: str, child: str):
        self._on_node_partial(now, node=node, rec=None, child=child)

    def _on_node_partial(self, now: float, node: str,
                         rec: Optional[UpdateRecord], child: str):
        """One child of super-relay ``node`` resolved (partial or skip);
        when the last one lands the node folds and ships upstream."""
        exp = self._node_expected.get(node)
        if exp is None or child not in exp:
            return  # superseded round
        exp.discard(child)
        if rec is not None:
            self._node_partials[node].append(rec)
        if exp:
            return
        recs = self._node_partials.pop(node)
        del self._node_expected[node]
        if not recs:  # every child skipped: propagate upward
            self._notify_skip(node, now)
            return
        weight = float(sum(r.weight for r in recs))
        count = int(sum(r.count for r in recs))
        version = recs[0].version
        trees = [r.payload.tree for r in recs
                 if isinstance(r.payload, TensorPayload)]
        if len(trees) == len(recs):
            partial, agg_s = fedavg(trees, [r.weight for r in recs])
            payload = TensorPayload(partial)
        else:
            nb = max(r.payload.nbytes for r in recs)
            agg_s = simulated_agg_time(nb, len(recs))
            payload = VirtualPayload(nb, tag=f"relay:{node}:v{version}")
        self._send_partial(node, payload, weight, version, count,
                           now + agg_s, 0)

    def _on_hub_arrival(self, now: float):
        """Drain the hub's endpoint: the relay partial decodes by its
        recorded wire stages (dequantised / inflated / reassembled), then
        joins the merge at its decode-complete time."""
        sched = self.sched
        for msg, ready in sched.backend.recv(now):
            if msg.msg_type != "relay_partial":
                continue
            g = msg.metadata["group"]
            client, _ = self._group_meta.get(g, (None, 0))
            rec = UpdateRecord(client=client, payload=msg.payload,
                               weight=float(msg.metadata["weight"]),
                               version=int(msg.metadata["version"]),
                               staleness=0, arrive_t=ready,
                               count=int(msg.metadata["count"]))
            sched.loop.call_at(ready, f"hier-merge<{g}",
                               self._on_hub_partial, rec=rec, group=g)

    def _on_hub_partial(self, now: float, rec: Optional[UpdateRecord],
                        group: str):
        sched = self.sched
        self.expected.discard(group)
        if rec is not None:
            self.hub_records.append(rec)
        if self.expected:
            return
        recs, self.hub_records = self.hub_records, []
        # every participating region churned empty -> no merge this round
        done = sched.aggregate(recs, now) if recs else now
        if not sched.loop.stopped:
            self._begin_round(sched, done)


def make_strategy(cfg, num_clients: Optional[int] = None,
                  **overrides) -> AggregationStrategy:
    """Strategy factory from ``FLConfig`` knobs (mode + buffer/staleness)."""
    n = num_clients or cfg.num_clients
    mode = cfg.mode
    compression = getattr(cfg, "compression", "none")
    if mode == "fedbuff":
        k = cfg.buffer_k or max(2, n // 2)
        return FedBuffStrategy(buffer_k=k,
                               staleness_exponent=cfg.staleness_exponent,
                               max_staleness=cfg.max_staleness,
                               staleness_adaptive=getattr(
                                   cfg, "staleness_adaptive", False),
                               **overrides)
    if mode == "semisync":
        return SemiSyncStrategy(quorum_fraction=cfg.quorum_fraction,
                                round_deadline_s=cfg.round_deadline_s,
                                staleness_exponent=cfg.staleness_exponent,
                                **overrides)
    if mode == "hier":
        overrides.setdefault(
            "wan_compression",
            None if compression in ("", "none") else compression)
        wire = getattr(cfg, "wire_codec", "none")
        overrides.setdefault("wan_wire_codec",
                             None if wire in ("", "none") else wire)
        overrides.setdefault("chunk_mb", getattr(cfg, "chunk_mb", 0.0))
        overrides.setdefault("region_quorum",
                             getattr(cfg, "region_quorum", 0.5))
        overrides.setdefault("relay_conns", getattr(cfg, "relay_conns", 8))
        overrides.setdefault("relay_depth", getattr(cfg, "relay_depth", 1))
        return HierarchicalStrategy(
            staleness_exponent=cfg.staleness_exponent, **overrides)
    if mode == "vertical":
        from repro_torch.fl.vertical import VerticalStrategy
        overrides.setdefault("cut_layer", getattr(cfg, "cut_layer", 1))
        overrides.setdefault("batches_per_round",
                             getattr(cfg, "batches_per_round", 8))
        return VerticalStrategy(**overrides)
    raise KeyError(
        f"unknown scheduler mode '{mode}': event-driven modes are "
        f"'fedbuff' | 'semisync' | 'hier' | 'vertical' (sync rounds use "
        f"FLServer.run_round)")
