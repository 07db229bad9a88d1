"""Port of ``src/repro/fl/fault.py`` (copied; imports re-pointed).

Failure & straggler injection + recovery policies.

The paper's fault-tolerance claims exercised here:
* gRPC/gRPC+S3: dynamic participation — dropped clients are simply not
  counted (quorum), late clients re-fetch the current model from S3 with no
  sender involvement.
* MPI: static world — a lost rank aborts the round; recovery = restore the
  last checkpoint and re-run the round (cost modelled + measured).

Two injection granularities:
* ``FaultPlan``         — per-round Bernoulli drop/straggler draws for the
  synchronous loop (``FLServer.run_round``). Drop and straggler are
  *independent* draws from split seeded streams, so each marginal rate is
  exactly its knob (a coupled ``elif`` draw would skew the straggler rate
  to ``(1-drop)*straggler`` and correlate the two).
* ``AvailabilityTrace`` — client join/leave/rejoin events at arbitrary
  simulated times, consumed by the event-driven scheduler
  (``fl/scheduler.py``) as first-class events. This is the churn model
  the async strategies are tested against: mid-round departures, relay
  quorum, S3 late-join re-fetch.

Link-level faults (chunk loss, blackouts) live in
``core/netsim.LinkFaultModel`` and are injected by the transport fabric.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np


@dataclasses.dataclass
class FaultPlan:
    drop_rate: float = 0.0  # per client per round
    straggler_rate: float = 0.0  # fraction of clients slowed
    straggler_factor: float = 3.0
    seed: int = 0

    def for_round(self, round_: int, client_ids) -> tuple:
        """(dropped, stragglers) for one round. The two sets come from
        independent split-seeded streams: a client can be both, and each
        marginal rate equals its knob (regression-tested)."""
        rng_drop = np.random.default_rng((self.seed, round_, 0))
        rng_strag = np.random.default_rng((self.seed, round_, 1))
        dropped: Set[str] = set()
        stragglers: Set[str] = set()
        for cid in client_ids:
            if rng_drop.random() < self.drop_rate:
                dropped.add(cid)
            if rng_strag.random() < self.straggler_rate:
                stragglers.add(cid)
        return dropped, stragglers


def apply_stragglers(clients, stragglers, factor: float):
    for c in clients:
        c.straggle_factor = factor if c.client_id in stragglers else 1.0


# ---------------------------------------------------------------------------
# availability traces (event-driven churn)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AvailabilityEvent:
    time: float
    client_id: str
    kind: str  # "leave" | "join"


class AvailabilityTrace:
    """A timeline of client churn events. Every client starts *up*;
    ``leave``/``join`` events toggle it. The scheduler replays the trace
    as loop events; strategies decide what a departure mid-round means
    (fedbuff/semisync discard in-flight updates from departed clients,
    hier re-checks its relay quorum)."""

    def __init__(self, events: Iterable[AvailabilityEvent] = ()):
        self.events: List[AvailabilityEvent] = sorted(
            events, key=lambda e: (e.time, e.client_id, e.kind))

    def __len__(self) -> int:
        return len(self.events)

    def for_client(self, client_id: str) -> List[AvailabilityEvent]:
        return [e for e in self.events if e.client_id == client_id]

    def is_up(self, client_id: str, t: float) -> bool:
        up = True
        for e in self.events:
            if e.time > t:
                break
            if e.client_id == client_id:
                up = e.kind == "join"
        return up

    # -- constructors ----------------------------------------------------
    @classmethod
    def parse(cls, spec: str) -> "AvailabilityTrace":
        """``"client0:leave@120,join@400;client3:leave@50"`` — explicit
        per-client event lists (the ``fl_train --availability-trace``
        format)."""
        events = []
        for part in filter(None, (p.strip() for p in spec.split(";"))):
            cid, _, evs = part.partition(":")
            if not evs:
                raise ValueError(
                    f"availability spec '{part}': want 'client:kind@t,...'")
            for ev in filter(None, (e.strip() for e in evs.split(","))):
                kind, _, t = ev.partition("@")
                if kind not in ("leave", "join") or not t:
                    raise ValueError(
                        f"availability event '{ev}': want leave@T or join@T")
                events.append(AvailabilityEvent(float(t), cid.strip(), kind))
        return cls(events)

    @classmethod
    def generate(cls, client_ids: Sequence[str], horizon_s: float, *,
                 mean_up_s: float, mean_down_s: float,
                 seed: int = 0) -> "AvailabilityTrace":
        """Alternating exponential up/down periods per client, each
        client on its own stream keyed by its *id* (adding or removing a
        client never reshuffles another's trace)."""
        import zlib
        events = []
        for cid in sorted(client_ids):
            rng = np.random.default_rng((seed, 0x5EED,
                                         zlib.crc32(cid.encode())))
            t = rng.exponential(mean_up_s)
            while t < horizon_s:
                events.append(AvailabilityEvent(float(t), cid, "leave"))
                t += rng.exponential(mean_down_s)
                if t >= horizon_s:
                    break
                events.append(AvailabilityEvent(float(t), cid, "join"))
                t += rng.exponential(mean_up_s)
        return cls(events)


def make_availability(spec: str, client_ids: Sequence[str],
                      horizon_s: float,
                      seed: int = 0) -> Optional[AvailabilityTrace]:
    """CLI adapter: '' -> None; 'auto:MEAN_UP/MEAN_DOWN' -> generated
    trace over ``horizon_s``; anything else -> ``AvailabilityTrace.parse``."""
    if not spec:
        return None
    if spec.startswith("auto:"):
        up, _, down = spec[len("auto:"):].partition("/")
        return AvailabilityTrace.generate(
            client_ids, horizon_s, mean_up_s=float(up),
            mean_down_s=float(down) if down else float(up), seed=seed)
    return AvailabilityTrace.parse(spec)


# ---------------------------------------------------------------------------
# recovery cost models
# ---------------------------------------------------------------------------

def mpi_abort_recovery_time(ckpt_restore_s: float, round_time_s: float) -> float:
    """Paper §II-C: MPI failure handling lacks fault isolation — global
    abort, restore, re-run."""
    return ckpt_restore_s + round_time_s


def s3_late_join_time(store, key: str, host, now: float) -> float:
    """A restarted client pulls the current global model directly from the
    object store (single-upload/multi-download durability)."""
    obj, attempts = store.get(key)
    return now + attempts * store.get_time(obj.nbytes, host)
