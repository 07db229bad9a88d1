"""Port of ``src/repro/fl/scheduler.py`` (copied; imports re-pointed).
Received updates land on the device of the server backend's channel
(core/channel.py), so FedAvg and the streaming accumulator run there.

Event-driven FL runtime — clients driven independently, not in lockstep.

The paper's Fig 5 loop (``FLServer.run_round``) models synchronous rounds:
every client trains on the same global version and the server blocks on a
quorum. The interesting scale regime — stragglers, WAN heterogeneity,
throughput-optimal topologies (Marfoq et al.) — is asynchronous. This
module provides that runtime:

* ``EventLoop``    — deterministic discrete-event queue over the simulated
  clock. Events are ordered by ``(time, insertion seq)`` so ties resolve in
  schedule order and replaying the same deployment reproduces the exact
  same trace (tested).
* ``FLScheduler``  — drives each ``FLClient`` through its own
  dispatch -> train -> upload pipeline using the backends' non-blocking
  ``isend`` handles and inbox polling (``recv`` / ``next_arrival``), and
  delegates *when and how to aggregate* to a pluggable strategy
  (fl/async_strategies.py): FedBuff-style buffered async, semi-synchronous
  quorum+deadline, or hierarchical per-region relays.

Payload movement is real whenever payloads are real (TensorPayload trees
travel through the same serializers/fabric as the sync path); time is
simulated-clock seconds from netsim either way.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.message import FLMessage, TensorPayload, VirtualPayload
from repro_torch.fl.aggregator import (fedavg, merge_global,
                                       simulated_agg_time, staleness_weight)
from repro_torch.fl.client import PCIE_BW, FLClient


@dataclasses.dataclass
class UpdateRecord:
    """One client (or relay) update as seen by the aggregation strategy."""
    client: Optional[FLClient]
    payload: Any  # TensorPayload | VirtualPayload | PackedPayload
    weight: float  # num_examples (or summed, for relay partials)
    version: int  # global version the update was trained against
    staleness: int  # server version delta at merge decision time
    arrive_t: float
    count: int = 1  # client updates folded in (relay partials carry many)


@dataclasses.dataclass
class AggregationEvent:
    time: float
    version: int
    n_updates: int
    mean_staleness: float
    effective_weight: float  # sum of staleness discounts alpha(s)
    loss: Optional[float] = None


@dataclasses.dataclass
class AsyncRunReport:
    """What one event-driven run produced (the fig6 results surface)."""
    mode: str
    backend: str
    sim_time: float
    n_aggregations: int
    n_client_updates: int
    effective_updates: float
    mean_staleness: float
    aggregations_per_hour: float
    client_updates_per_hour: float
    time_to_target: Optional[float]
    final_loss: Optional[float]
    n_discarded: int
    n_events: int
    # churn / fault accounting (0 unless an AvailabilityTrace or a
    # LinkFaultModel is installed)
    n_departures: int = 0
    n_rejoins: int = 0
    n_transfer_failures: int = 0
    n_late_refetches: int = 0


class _CalendarQueue:
    """Calendar-queue bucket structure over ``(time, seq, ...)`` entries.

    Events land in fixed-width time slots keyed ``int(t // width)``; a
    small heap of slot keys (lazy-created, dropped once drained) finds
    the next non-empty slot. ``EventLoop.call_at`` clamps times to
    >= now, so no insert can land before the slot currently draining and
    the cursor advances monotonically. A slot's list is heapified once
    when it becomes current; same-slot inserts after that heap-push.

    Pop order is exactly the flat heap's global ``(time, seq)`` order:
    slots partition the time axis and within a slot the heap orders by
    ``(time, seq)`` — so the two queue disciplines produce bit-identical
    traces (tested, and asserted by benchmarks/fig11_scale.py).

    The win over one big heap is batch behaviour at fleet scale: a
    broadcast wave inserts thousands of arrivals into a handful of
    future slots as plain appends (O(1) each, no sift through the events
    of every other slot), and only the slot being drained pays heap
    discipline.
    """

    def __init__(self, width: float = 1.0):
        self.width = float(width)
        self._buckets: dict = {}  # slot key -> event list (heap if current)
        self._keys: list = []  # min-heap of pending slot keys
        self._cur: Optional[int] = None  # slot currently draining
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def push(self, item) -> None:
        key = int(item[0] // self.width)
        bucket = self._buckets.get(key)
        if bucket is None:
            bucket = self._buckets[key] = []
            heapq.heappush(self._keys, key)
        if key == self._cur:
            heapq.heappush(bucket, item)
        else:
            bucket.append(item)
        self._n += 1

    def _front(self):
        """The current slot's heap, advancing past drained slots."""
        while True:
            if self._cur is not None:
                bucket = self._buckets.get(self._cur)
                if bucket and self._keys and self._keys[0] < self._cur:
                    # an earlier slot appeared (a push after a bounded
                    # run(until) clamped to an older now): re-queue the
                    # current slot and re-select the true minimum
                    heapq.heappush(self._keys, self._cur)
                    self._cur = None
                    continue
                if bucket:
                    return bucket
                self._buckets.pop(self._cur, None)
                self._cur = None
            if not self._keys:
                return None
            key = heapq.heappop(self._keys)
            bucket = self._buckets.get(key)
            if not bucket:
                self._buckets.pop(key, None)
                continue
            heapq.heapify(bucket)
            self._cur = key
            return bucket

    def peek(self):
        bucket = self._front()
        return bucket[0] if bucket else None

    def pop(self):
        item = heapq.heappop(self._front())
        self._n -= 1
        return item


class EventLoop:
    """Deterministic discrete-event loop, (time, seq)-ordered.

    ``queue`` selects the event structure: ``"calendar"`` (default) is
    the bucketed calendar queue the fleet-scale engine runs on;
    ``"heap"`` is the original flat ``heapq`` — kept verbatim as the
    un-vectorized baseline fig11 measures against. Both produce
    bit-identical traces (ties resolve by insertion seq either way)."""

    def __init__(self, queue: str = "calendar"):
        if queue not in ("calendar", "heap"):
            raise ValueError(f"unknown event queue '{queue}' "
                             "(use 'calendar' or 'heap')")
        self.queue = queue
        self._q = [] if queue == "heap" else _CalendarQueue()
        self._seq = 0
        self.now = 0.0
        self.stopped = False
        self.trace: List[tuple] = []  # (time, event name) — determinism probe

    def call_at(self, t: float, name: str, fn: Callable, **kw):
        """Schedule ``fn(now, **kw)``; never earlier than the current time."""
        item = (max(float(t), self.now), self._seq, name, fn, kw)
        self._seq += 1
        if self.queue == "heap":
            heapq.heappush(self._q, item)
        else:
            self._q.push(item)

    def call_at_many(self, events: Sequence[tuple]):
        """Batched insertion of ``(t, name, fn, kw)`` tuples — one call
        per broadcast wave instead of one per client (the calendar queue
        turns these into plain appends on future slots)."""
        for t, name, fn, kw in events:
            self.call_at(t, name, fn, **kw)

    def stop(self):
        self.stopped = True

    def run(self, until: float = math.inf) -> float:
        if self.queue == "heap":
            while self._q and not self.stopped:
                t, _, name, fn, kw = self._q[0]
                if t > until:
                    break
                heapq.heappop(self._q)
                self.now = t
                self.trace.append((round(t, 9), name))
                fn(t, **kw)
            return self.now
        while not self.stopped:
            head = self._q.peek()
            if head is None or head[0] > until:
                break
            t, _, name, fn, kw = self._q.pop()
            self.now = t
            self.trace.append((round(t, 9), name))
            fn(t, **kw)
        return self.now


class FLScheduler:
    """Drives an FL deployment through an EventLoop under a strategy."""

    def __init__(self, backend, clients: Sequence[FLClient], strategy, *,
                 local_steps: int = 10, server_lr: float = 1.0,
                 availability=None, redispatch_backoff_s: float = 30.0,
                 event_queue: str = "calendar", cohort_k: int = 0,
                 cohort_seed: int = 0, streaming_hub: bool = False,
                 loop: Optional[EventLoop] = None):
        self.backend = backend  # server-side CommBackend (or AUTO)
        self.clients = list(clients)
        self.strategy = strategy
        self.local_steps = local_steps
        self.server_lr = server_lr
        self.env = backend.env
        # ``loop``: a shared clock injected by the multi-job driver
        # (fl/multijob.MultiScheduler). Standalone schedulers own a
        # private loop and stop it at their cap — the exact legacy path;
        # co-scheduled jobs must NOT stop the shared clock, so they
        # quiesce through ``finished`` instead and notify ``on_finished``
        self.loop = EventLoop(queue=event_queue) if loop is None else loop
        self._shared_loop = loop is not None
        self.finished = False
        self.finished_at: Optional[float] = None
        self.on_finished: Optional[Callable] = None
        self._start_s = 0.0
        self.version = 0
        self.global_payload = None
        self.global_params = None  # real pytree in live mode
        self.n_aggregations = 0
        self.n_updates_applied = 0
        self.effective_updates = 0.0
        self.discarded = 0
        self.time_to_target: Optional[float] = None
        self.agg_log: List[AggregationEvent] = []
        self.update_log: List[tuple] = []  # (arrive_t, client_id, staleness)
        self._agg_busy_until = 0.0  # server merges are serialized
        self._max_agg: Optional[int] = None
        self._target_eff: Optional[float] = None
        # churn (fl/fault.AvailabilityTrace): clients start up; leave/join
        # events toggle membership as first-class loop events
        self.availability = availability
        self.redispatch_backoff_s = redispatch_backoff_s
        self.available = {c.client_id for c in self.clients}
        # dispatch generation per client: bumped on leave, so a model
        # that was in flight across a leave/rejoin blip is dropped on
        # arrival instead of spawning a second permanent train->upload
        # pipeline next to the rejoin dispatch
        self._gen = {c.client_id: 0 for c in self.clients}
        self.departures = 0
        self.rejoins = 0
        self.transfer_failures = 0
        self.late_refetches = 0
        # fleet-scale client table: O(1) id lookup plus flat NumPy arrays
        # for the per-client flags the hot path filters on (a 10k-client
        # dispatch wave is one boolean mask, not 10k attribute walks)
        self._by_id = {c.client_id: c for c in self.clients}
        self._index = {c.client_id: i for i, c in enumerate(self.clients)}
        n = len(self.clients)
        self._up = np.ones(n, dtype=bool)
        self._busy = np.zeros(n, dtype=bool)  # dispatched, not yet resolved
        self._in_cohort = np.ones(n, dtype=bool)
        # cohort sampling (cross-device regime): 0 < K < N samples K
        # clients per aggregation round; K = 0 or K >= N is the full
        # fleet, bit-for-bit today's behaviour (no mask ever consulted)
        self.cohort_k = int(cohort_k)
        self._cohort_rng = np.random.default_rng(cohort_seed)
        # streaming hub: fold arriving updates into an O(model)
        # accumulator instead of buffering O(clients) payloads
        self.streaming_hub = bool(streaming_hub)
        self._acc = None  # fl/aggregator.StreamingAccumulator, lazily
        self._acc_charged = False  # accumulator memory charged once
        self._charged: Dict[int, int] = {}  # id(rec) -> buffered bytes

    # -- plumbing ----------------------------------------------------------
    def _resolved(self, msg: FLMessage):
        be = self.backend
        return be.resolve(msg) if hasattr(be, "resolve") else be

    def is_up(self, client_id: str) -> bool:
        return client_id in self.available

    # -- cohort sampling ---------------------------------------------------
    @property
    def cohort_active(self) -> bool:
        return 0 < self.cohort_k < len(self.clients)

    def _sample_cohort(self):
        """Seeded sample-K-of-N, drawn once before the run starts and
        re-drawn at each aggregation (version bump)."""
        self._in_cohort[:] = False
        picks = self._cohort_rng.choice(len(self.clients),
                                        size=self.cohort_k, replace=False)
        self._in_cohort[picks] = True

    def eligible_count(self) -> int:
        """Live clients a quorum may count on: the sampled cohort's live
        members under cohort sampling, the whole live fleet otherwise."""
        if not self.cohort_active:
            return len(self.available)
        return int(np.count_nonzero(self._up & self._in_cohort))

    def _cohort_blocked(self, client_id: str) -> bool:
        """Outside the current cohort, or its previous dispatch is still
        unresolved (busy pipelines ride across cohort boundaries)."""
        if not self.cohort_active:
            return False
        i = self._index[client_id]
        return bool(not self._in_cohort[i] or self._busy[i])

    def _mark_busy(self, client_id: str, busy: bool):
        i = self._index.get(client_id)
        if i is not None:
            self._busy[i] = busy

    def _cohort_dispatch(self, now: float):
        """Top up the freshly sampled cohort: dispatch its idle members.
        Busy members keep their in-flight pipelines; their reporters
        re-enter through the strategy's own re-dispatch, which
        ``dispatch`` filters against the new cohort."""
        mask = self._in_cohort & self._up & ~self._busy
        self.dispatch_many([self.clients[i] for i in np.nonzero(mask)[0]],
                           now)

    def timer(self, t: float, name: str, fn: Callable, **kw):
        """Schedule a strategy callback ``fn(scheduler, now, **kw)``.
        A finished co-scheduled job stops rescheduling itself — its
        strategy's round timers must not spin the shared clock forever
        (standalone runs never reach here finished: the loop stopped)."""
        if self.finished:
            return
        self.loop.call_at(t, name, lambda now, **k: fn(self, now, **k), **kw)

    def _track(self, h, name: str, fn: Callable, **kw) -> bool:
        """Schedule the completion callback of one send handle. Returns
        False when the fault model failed the transfer (bounded chunk
        retransmits exhausted) — nothing was delivered, the caller picks
        the recovery (re-dispatch / re-upload / give up)."""
        if getattr(h, "failed", False) or math.isinf(h.inbox_t):
            self.transfer_failures += 1
            return False
        self.loop.call_at(h.inbox_t, name, fn, **kw)
        return True

    # -- client pipeline ---------------------------------------------------
    def _model_msg(self, client: FLClient) -> FLMessage:
        return FLMessage("model_sync", self.backend.host_id,
                         client.client_id, round=self.version,
                         payload=self.global_payload,
                         metadata={"version": self.version})

    def dispatch(self, client: FLClient, now: float, _attempt: int = 0):
        """Send the current global model to one client (non-blocking isend;
        concurrent dispatches interleave on the shared completion path).
        Departed clients are skipped; a fault-failed transfer is re-issued
        after a backoff (the model distribution must survive chunk loss),
        bounded so a fully dead link cannot spin the loop forever."""
        if self.finished or not self.is_up(client.client_id):
            return
        if _attempt == 0 and self._cohort_blocked(client.client_id):
            return  # not sampled this round (or its pipeline is live)
        self._mark_busy(client.client_id, True)
        h = self.backend.isend(self._model_msg(client), now)
        if not self._track(h, f"model>{client.client_id}",
                           self._on_client_recv, client=client,
                           gen=self._gen[client.client_id]):
            if _attempt >= 25:
                self._mark_busy(client.client_id, False)
                return  # link is dead: treat the client as unreachable
            # re-issue once the sender has causally *detected* the
            # failure (h.start = give-up time) plus a backoff
            self.loop.call_at(max(now, h.start) + self.redispatch_backoff_s,
                              f"redispatch>{client.client_id}",
                              lambda t, c=client, a=_attempt:
                              self.dispatch(c, t, a + 1))

    def dispatch_many(self, clients: Sequence[FLClient], now: float):
        """Burst dispatch (round start / round close): rides the backend's
        contention-aware concurrent broadcast — the same fluid model the
        sync server charges — instead of independent analytic isends."""
        if self.finished:
            return
        clients = [c for c in clients if self.is_up(c.client_id)]
        if self.cohort_active:
            clients = [c for c in clients
                       if not self._cohort_blocked(c.client_id)]
        if len(clients) <= 1:
            for c in clients:
                self.dispatch(c, now)
            return
        for c in clients:
            self._mark_busy(c.client_id, True)
        msgs = [self._model_msg(c) for c in clients]
        _, arrives = self.backend.broadcast(msgs, now)
        self.loop.call_at_many(
            [(arrive, f"model>{c.client_id}", self._on_client_recv,
              dict(client=c, gen=self._gen[c.client_id]))
             for c, arrive in zip(clients, arrives)])

    def rejoin(self, client: FLClient, now: float):
        """Late-join re-fetch: over grpc+s3 the dispatch rides the
        content-addressed cache — the rejoining client pulls the current
        model straight from the durable store with *no sender re-upload*
        (the paper's single-upload/multi-download story); direct backends
        pay a full re-send. Counted only when the current model really is
        still stored (a cache miss is an ordinary re-upload)."""
        msg = self._model_msg(client)
        be = self._resolved(msg)
        if getattr(be, "has_cached_upload", None) is not None and \
                be.has_cached_upload(msg):
            self.late_refetches += 1
        self.dispatch(client, now)

    def _on_availability(self, now: float, ev):
        client = self._by_id.get(ev.client_id)
        if client is None:
            return
        if ev.kind == "leave" and self.is_up(ev.client_id):
            self.available.discard(ev.client_id)
            self._up[self._index[ev.client_id]] = False
            self._mark_busy(ev.client_id, False)  # pipeline dies with it
            self._gen[ev.client_id] += 1  # invalidate in-flight dispatches
            self.departures += 1
            self.strategy.on_leave(self, client, now)
        elif ev.kind == "join" and not self.is_up(ev.client_id):
            self.available.add(ev.client_id)
            self._up[self._index[ev.client_id]] = True
            self.rejoins += 1
            self.strategy.on_join(self, client, now)

    def _on_client_recv(self, now: float, client: FLClient,
                        gen: Optional[int] = None):
        stale = gen is not None and gen != self._gen[client.client_id]
        for msg, ready in client.backend.recv(now):
            if msg.msg_type != "model_sync":
                continue
            if stale or not self.is_up(client.client_id):
                # the model landed at a departed client, or at one that
                # left and rejoined while it was in flight (the rejoin
                # dispatch owns the client's pipeline now)
                continue
            update, _timing, send_start = client.run_round(
                msg, ready, self.local_steps)
            # stamp the pipeline generation: if the client leaves while
            # this update is (logically) training/in flight, the stamp
            # goes stale and the apply guard drops it even if the client
            # has already rejoined with a fresh pipeline
            update.metadata["_gen"] = self._gen[client.client_id]
            self._isend_update(client, update, send_start, attempt=0)

    def _isend_update(self, client: FLClient, update: FLMessage, t: float,
                      attempt: int):
        """Client-side upload with bounded top-level retries: a transfer
        the fault model failed outright is re-issued, 3 attempts total,
        before the update is abandoned (counted discarded)."""
        uh = client.backend.isend(update, t)
        if self._track(uh, f"update>{client.client_id}",
                       self._on_server_recv):
            return
        if attempt < 2:
            self.loop.call_at(
                max(t, uh.start) + self.redispatch_backoff_s,
                f"reupload>{client.client_id}", self._retry_update,
                client=client, update=update, attempt=attempt + 1)
        else:
            self.discarded += 1
            self._mark_busy(client.client_id, False)

    def _retry_update(self, now: float, client: FLClient,
                      update: FLMessage, attempt: int):
        if not self.is_up(client.client_id):
            self.discarded += 1  # departed before the retry could fire
            self._mark_busy(client.client_id, False)
            return
        self._isend_update(client, update, now, attempt)

    def _on_server_recv(self, now: float):
        for msg, ready in self.backend.recv(now):
            if msg.msg_type != "client_update":
                continue
            self.loop.call_at(ready, f"apply<{msg.sender}", self._on_apply,
                              msg=msg)

    def _on_apply(self, now: float, msg: FLMessage):
        self._mark_busy(msg.sender, False)  # dispatch resolved either way
        gen = msg.metadata.get("_gen")
        if not self.is_up(msg.sender) or (
                gen is not None and gen != self._gen.get(msg.sender)):
            # mid-round departure: the sender left while this update was
            # training/in flight (stale generation), or is still down —
            # dynamic-participation semantics say it is not counted
            self.discarded += 1
            return
        client = self._by_id.get(msg.sender)
        version = int(msg.metadata.get("version", msg.round))
        staleness = self.version - version
        rec = UpdateRecord(client=client, payload=msg.payload,
                           weight=float(msg.metadata.get("num_examples", 1)),
                           version=version, staleness=staleness, arrive_t=now)
        self.update_log.append((now, msg.sender, staleness))
        self.strategy.on_update(self, rec, now)

    # -- aggregation -------------------------------------------------------
    def hub_fold(self, rec: UpdateRecord, now: float) -> UpdateRecord:
        """Admit one update into the hub's merge buffer.

        Dense mode (default): charges the buffered payload against the
        server endpoint's memory meter (freed when the buffer merges)
        and returns the record unchanged — O(clients) hub memory,
        today's math bit-for-bit.

        Streaming mode (``streaming_hub=True``): folds the eff-weighted
        update into an O(model) accumulator on the fedavg_reduce
        streaming-accumulate kernel and strips the record's payload to a
        size-only placeholder, so hub memory stays O(model) at any fleet
        size. Virtual payloads fold as counts only and the merge timing
        is identical to the dense path; the staleness discount is taken
        at fold time (same as merge time for the fixed polynomial —
        adaptive-percentile weighting sees a slightly younger window).
        """
        mem = self.backend.endpoint.memory
        if not self.streaming_hub:
            self._charged[id(rec)] = rec.payload.nbytes
            mem.alloc(rec.payload.nbytes, now)
            return rec
        if self._acc is None:
            from repro_torch.fl.aggregator import StreamingAccumulator
            self._acc = StreamingAccumulator()
        if not self._acc_charged:
            mem.alloc(self.global_payload.nbytes, now)
            self._acc_charged = True
        alpha = self.strategy.staleness_weight(rec.staleness)
        self._acc.fold(rec, alpha)
        if isinstance(rec.payload, TensorPayload):
            rec = dataclasses.replace(
                rec, payload=VirtualPayload(rec.payload.nbytes,
                                            tag="hub-folded"))
        return rec

    def aggregate(self, records: Sequence[UpdateRecord], now: float) -> float:
        """Staleness-weighted buffered aggregate; bumps the global version.
        Returns the simulated completion time."""
        records = list(records)
        if self.finished or not records:
            return now
        alphas = [self.strategy.staleness_weight(r.staleness)
                  for r in records]
        eff = [r.weight * a for r, a in zip(records, alphas)]
        nbytes = self.global_payload.nbytes
        acc = self._acc if self.streaming_hub else None
        trees = [r.payload.tree for r in records
                 if isinstance(r.payload, TensorPayload)]
        if acc is not None and acc.count:
            # streaming hub: the buffer is already folded into the
            # accumulator; merge = one divide + damped server update
            merged, stream_agg_s = acc.merged()
            if merged is not None and acc.sum_eff > 0:
                agg_s = stream_agg_s
                lam = self.server_lr * (acc.sum_eff /
                                        max(acc.sum_weight, 1e-12))
                self.global_params = merge_global(self.global_params,
                                                  merged, lam)
                self.global_payload = TensorPayload(self.global_params)
            else:
                agg_s = simulated_agg_time(nbytes, len(records))
                self.global_payload = VirtualPayload(
                    nbytes, tag=f"model:v{self.version + 1}")
            acc.reset()
        elif len(trees) == len(records) and sum(eff) > 0:
            merged, agg_s = fedavg(trees, eff)
            lam = self.server_lr * (sum(eff) /
                                    max(sum(r.weight for r in records), 1e-12))
            self.global_params = merge_global(self.global_params, merged, lam)
            self.global_payload = TensorPayload(self.global_params)
        else:
            agg_s = simulated_agg_time(nbytes, len(records))
            # a merged model is a *new* payload: refresh the virtual tag so
            # object-store content caching doesn't hand out stale-free sends
            self.global_payload = VirtualPayload(
                nbytes, tag=f"model:v{self.version + 1}")
        mig_s = 2 * nbytes / PCIE_BW
        done = max(now, self._agg_busy_until) + mig_s + agg_s
        self._agg_busy_until = done
        self.version += 1
        mem = self.backend.endpoint.memory
        for r in records:
            nb = self._charged.pop(id(r), None)
            if nb is not None:
                mem.free(nb, done)
        if self.cohort_active:
            # re-draw the cohort for the new version; idle members of the
            # fresh sample get their model at merge completion
            self._sample_cohort()
            self.loop.call_at(done, f"cohort-dispatch#v{self.version}",
                              self._cohort_dispatch)
        self.n_aggregations += 1
        self.n_updates_applied += sum(r.count for r in records)
        self.effective_updates += sum(a * r.count
                                      for a, r in zip(alphas, records))
        losses = [getattr(r.client, "last_loss", None) for r in records
                  if r.client is not None]
        losses = [l for l in losses if l is not None]
        self.agg_log.append(AggregationEvent(
            time=done, version=self.version, n_updates=len(records),
            mean_staleness=float(np.mean([r.staleness for r in records])),
            effective_weight=float(sum(alphas)),
            loss=float(np.mean(losses)) if losses else None))
        if (self._target_eff is not None and self.time_to_target is None
                and self.effective_updates >= self._target_eff):
            self.time_to_target = done
        reached_target = (self._target_eff is not None
                          and self.time_to_target is not None)
        reached_cap = (self._max_agg is not None
                       and self.n_aggregations >= self._max_agg)
        if reached_target or reached_cap:
            self.finished = True
            self.finished_at = done
            if self._shared_loop:
                # co-scheduled job: quiesce (dispatch/timer no-op from
                # here) and tell the driver — the shared clock keeps
                # running for the other tenants
                if self.on_finished is not None:
                    self.on_finished(self, done)
            else:
                self.loop.stop()
        return done

    # -- entry point -------------------------------------------------------
    def prepare(self, global_payload, *,
                max_aggregations: Optional[int] = None,
                target_effective_updates: Optional[float] = None,
                start_s: float = 0.0) -> None:
        """Bootstrap this job onto its loop without running it: install
        the payload and caps, schedule availability churn, draw the
        round-0 cohort and fire ``strategy.start``. ``run`` is exactly
        ``prepare`` + ``loop.run`` + ``report``; the multi-job driver
        calls ``prepare`` once per co-scheduled job (with its ``start_s``
        offset) and then runs the shared loop once."""
        self.global_payload = global_payload
        if isinstance(global_payload, TensorPayload):
            self.global_params = global_payload.tree
        self._max_agg = max_aggregations
        self._target_eff = target_effective_updates
        self._start_s = start_s
        if self.availability is not None:
            for ev in self.availability.events:
                self.loop.call_at(ev.time + start_s,
                                  f"avail-{ev.kind}:{ev.client_id}",
                                  self._on_availability, ev=ev)
        if self.cohort_active:
            self._sample_cohort()  # round-0 cohort, before the bootstrap
        self.strategy.start(self, max(self.loop.now, start_s))

    def run(self, global_payload, *, until: float = math.inf,
            max_aggregations: Optional[int] = None,
            target_effective_updates: Optional[float] = None) -> AsyncRunReport:
        if (math.isinf(until) and max_aggregations is None
                and target_effective_updates is None):
            raise ValueError("unbounded run: pass until=, max_aggregations= "
                             "or target_effective_updates=")
        self.prepare(global_payload, max_aggregations=max_aggregations,
                     target_effective_updates=target_effective_updates)
        self.loop.run(until=until)
        return self.report()

    def report(self) -> AsyncRunReport:
        # the stop() that capped the run fires at the *triggering* event;
        # the final merge still runs to completion on the simulated clock
        span = self.loop.now
        if self._shared_loop:
            # on a shared clock loop.now spans every tenant: this job's
            # span runs from its own start to its own finish (or its
            # last aggregation, for until=-bounded runs)
            end = self.finished_at
            if end is None:
                end = self.agg_log[-1].time if self.agg_log else self.loop.now
            span = end - self._start_s
        if self.agg_log:
            span = max(span, self.agg_log[-1].time - self._start_s)
        stal = [s for (_, _, s) in self.update_log]
        losses = [e.loss for e in self.agg_log if e.loss is not None]
        return AsyncRunReport(
            mode=getattr(self.strategy, "name", "?"),
            backend=getattr(self.backend, "name", "?"),
            sim_time=span,
            n_aggregations=self.n_aggregations,
            n_client_updates=self.n_updates_applied,
            effective_updates=self.effective_updates,
            mean_staleness=float(np.mean(stal)) if stal else 0.0,
            aggregations_per_hour=3600.0 * self.n_aggregations
            / max(span, 1e-9),
            client_updates_per_hour=3600.0 * self.n_updates_applied
            / max(span, 1e-9),
            time_to_target=self.time_to_target,
            final_loss=losses[-1] if losses else None,
            n_discarded=self.discarded,
            n_events=len(self.loop.trace),
            n_departures=self.departures,
            n_rejoins=self.rejoins,
            n_transfer_failures=self.transfer_failures,
            n_late_refetches=self.late_refetches)
