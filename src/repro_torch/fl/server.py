"""Port of ``src/repro/fl/server.py``: sync rounds (``run_round``) and the
event-driven runtime's entry point (``run_async``). Received updates land
on the device of the server backend's channel (core/channel.py).

FL server: round orchestration over any CommBackend, with concurrent
dispatch, quorum/deadline straggler mitigation, fault handling and the
paper's per-state time accounting (Fig 5: communication / migration /
serialization / waiting / training / aggregation).

All timing below is simulated-clock seconds from netsim; payload movement
is real whenever payloads are real.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.core.backends.base import CommBackend
from repro_torch.core.message import (FLMessage, TensorPayload, VirtualPayload)
from repro_torch.core.netsim import Region, Transfer, simulate_transfers
from repro_torch.fl.aggregator import fedavg, simulated_agg_time
from repro_torch.fl.client import PCIE_BW, ClientTiming, FLClient


@dataclasses.dataclass
class RoundReport:
    round: int
    backend: str
    round_time: float
    server: Dict[str, float]
    clients: Dict[str, float]  # averaged across participating clients
    n_participants: int
    n_dropped: int
    peak_server_memory: int
    aborted: bool = False
    losses: Optional[float] = None


class FLServer:
    def __init__(self, backend, clients: Sequence[FLClient], *,
                 quorum_fraction: float = 1.0, round_deadline_s: float = 0.0,
                 local_steps: int = 10, live: bool = True,
                 checkpoint_mgr=None, server_lr: float = 1.0):
        self.backend = backend
        self.clients = list(clients)
        self.quorum_fraction = quorum_fraction
        self.round_deadline_s = round_deadline_s
        self.local_steps = local_steps
        self.live = live
        self.ckpt = checkpoint_mgr
        self.server_lr = server_lr
        self.now = 0.0
        self.reports: List[RoundReport] = []
        self.global_params = None
        self.round = 0

    # ------------------------------------------------------------------
    def _client_backend(self, client: FLClient, msg=None):
        cb = client.backend
        if msg is not None and hasattr(cb, "resolve"):
            return cb.resolve(msg)  # AUTO: plan with the routed backend
        return cb

    def _upload_phase(self, sends):
        """sends: list of (client, update_msg, start_t). Contention-aware
        upload of all updates; returns dict client_id -> (arrive_t, ser_s)."""
        out = {}
        backend = self.backend
        name = getattr(backend, "name", "grpc")
        # AUTO plans the upload leg with whatever backend it would route
        # the first update onto — resolve() sees the post-compression
        # wire size, so a compressed large update correctly plans gRPC
        use_s3 = name == "grpc+s3" or (
            name == "auto" and sends
            and backend.resolve(sends[0][1]) is backend.s3)
        fm = backend.fabric.fault_model
        if use_s3:
            from repro_torch.core.channel import encode_many
            s3 = backend if name == "grpc+s3" else backend.s3
            cbs = [self._client_backend(client, msg)
                   for client, msg, _ in sends]
            # store exactly what each client's wire stack produces and
            # charge those bytes (a compressing channel stores the
            # smaller wire); virtual paper-scale payloads keep their
            # nominal size. All clients' encodes go through one fused
            # batch — one quantize kernel dispatch for the whole round
            enc_idx = [i for i, (_, msg, _) in enumerate(sends)
                       if isinstance(msg.payload, TensorPayload)]
            fused = encode_many([(cbs[i].channel, sends[i][1].payload, "s3")
                                 for i in enc_idx])
            encs = [None] * len(sends)
            for i, enc in zip(enc_idx, fused):
                encs[i] = enc
            transfers, meta = [], []
            for (client, msg, start), cb, enc in zip(sends, cbs, encs):
                wire = enc.wire if enc is not None else None
                nbytes = wire.nbytes if wire is not None \
                    else msg.payload_nbytes
                ser = (enc.cost_s if enc is not None
                       else cb.serializer.ser_time(msg.payload_nbytes))
                src = cb.env.host(client.client_id)
                put = s3.store.put_time(nbytes, src, s3.parts)
                key = s3.store.content_key(
                    (msg.payload.fingerprint(), cb.channel.signature()),
                    msg.round, client.client_id)
                # BlackoutSpec contract, as on the isend path: the PUT
                # holds while the client host is dark, the meta record
                # while its edge to the hub is (no-op with no windows)
                t_put = start + ser
                if fm is not None:
                    t_put = fm.delay((client.client_id,), t_put)
                t_meta = t_put + put
                if fm is not None:
                    t_meta = fm.delay((client.client_id, "server"), t_meta)
                s3.store.put(key, wire, nbytes, t_put + put)
                region = cb._link_region("server")
                meta_arrive = t_meta + cb._overhead(region) \
                    + region.latency
                dst = s3.env.host("server")
                tr = s3.store.get_transfer(key, dst, meta_arrive, s3.parts)
                transfers.append(tr)
                meta.append((client, msg, ser, key, wire))
            simulate_transfers(transfers)
            for (client, msg, ser, key, wire), tr in zip(meta, transfers):
                deser = (s3.channel.decode_time(wire) if wire is not None
                         else s3.serializer.deser_time(msg.payload_nbytes))
                # the server takes the update in process: no reader comes
                s3.store.settle(key)
                out[client.client_id] = (tr.finish + deser, ser, msg, key)
                s3.fabric.account(tr.nbytes)
            return out
        # direct backends: concurrent client->server transfers
        transfers, meta = [], []
        for client, msg, start in sends:
            cb = self._client_backend(client, msg)
            ser = cb.serializer.ser_time(msg.payload_nbytes)
            region = cb._link_region("server")
            dep = start + ser + cb._overhead(region)
            if fm is not None:
                # blackout-shifted departure, as on the isend path
                # (no-op with no windows installed)
                dep = fm.delay((client.client_id, "server"), dep)
            transfers.append(Transfer(
                start=dep,
                src=cb.env.host(client.client_id),
                dst=cb.env.host("server"),
                nbytes=msg.payload_nbytes,
                conns=cb.policy.conns_per_transfer,
                link_region=region, tag=client.client_id))
            meta.append((client, msg, ser))
        simulate_transfers(transfers)
        for (client, msg, ser), tr in zip(meta, transfers):
            sb = self.backend
            if hasattr(sb, "resolve"):
                sb = sb.resolve(msg)
            deser = sb.serializer.deser_time(msg.payload_nbytes)
            out[client.client_id] = (tr.finish + deser, ser, msg, None)
            sb.fabric.account(tr.nbytes)
        return out

    # ------------------------------------------------------------------
    @obs.spanned("round.sync")
    def run_round(self, global_payload, *, dropped: Optional[set] = None,
                  participants: Optional[Sequence[FLClient]] = None):
        """One FL round. ``global_payload``: TensorPayload | VirtualPayload.
        Returns RoundReport (and updates self.global_params in live mode)."""
        obs.count("round.aggregations")
        dropped = dropped or set()
        clients = list(participants or self.clients)
        t0 = self.now
        self.backend.endpoint.memory.reset()

        # 1) concurrent broadcast of the global model
        msgs = [FLMessage("model_sync", "server", c.client_id,
                          round=self.round, payload=global_payload)
                for c in clients]
        sender_done, _ = self.backend.broadcast(msgs, t0)

        # 2) clients receive, train, stage updates
        sends, timings = [], {}
        for c in clients:
            cb = self._client_backend(c)
            got = cb.recv(t0 + 1e9)  # pop whatever was scheduled
            if not got:
                continue
            msg, ready = got[0]
            if c.client_id in dropped:
                timings[c.client_id] = ClientTiming(
                    communication=ready - t0)
                continue
            update, ct, send_start = c.run_round(msg, ready, self.local_steps)
            ct.communication += ready - t0
            sends.append((c, update, send_start))
            timings[c.client_id] = ct

        aborted = False
        if dropped and _is_mpi(self.backend):
            # MPI's static world: a lost rank aborts the round (paper §II-C);
            # restart costs a checkpoint restore + full re-run marker.
            aborted = True

        # 3) contention-aware concurrent uploads
        arrivals = self._upload_phase(sends)

        # 4) quorum / deadline aggregation
        ready_sorted = sorted((v[0], cid) for cid, v in arrivals.items())
        cutoff_t, counted, late = quorum_cutoff(
            ready_sorted, len(clients), self.quorum_fraction,
            self.round_deadline_s, t0)

        # 5) aggregate
        updates, weights = [], []
        ser_s = 0.0
        for cid in counted:
            at, ser, msg, _ = arrivals[cid]
            ser_s += ser
            if isinstance(msg.payload, TensorPayload):
                updates.append(msg.payload.tree)
                weights.append(msg.metadata.get("num_examples", 1))
        if updates:
            agg, agg_s = fedavg(updates, weights)
            self.global_params = agg
            mig_s = 2 * global_payload.nbytes / PCIE_BW
        else:
            agg_s = simulated_agg_time(global_payload.nbytes, len(counted))
            mig_s = 2 * global_payload.nbytes / PCIE_BW
        agg_done = cutoff_t + mig_s + agg_s
        self.now = agg_done
        self.round += 1

        # 6) per-state report (paper Fig 5)
        cl_avg = _avg_timings([timings[cid] for cid in counted
                               if cid in timings], arrivals, agg_done)
        server_states = {
            "communication": (sender_done - t0) + _server_comm(arrivals,
                                                               counted),
            "migration": mig_s,
            "serialization": ser_s / max(len(counted), 1),
            "waiting": max(cutoff_t - sender_done, 0.0),
            "aggregation": agg_s,
        }
        losses = [getattr(c, "last_loss", None) for c in clients]
        losses = [l for l in losses if l is not None]
        report = RoundReport(
            round=self.round - 1, backend=getattr(self.backend, "name", "?"),
            round_time=agg_done - t0, server=server_states, clients=cl_avg,
            n_participants=len(counted), n_dropped=len(dropped) + len(late),
            peak_server_memory=self.backend.endpoint.memory.peak,
            aborted=aborted,
            losses=float(np.mean(losses)) if losses else None)
        self.reports.append(report)
        if self.ckpt is not None and self.global_params is not None:
            self.ckpt.save(self.round, self.global_params,
                           meta={"sim_time": self.now})
        # every client has received this round's model: the store may
        # release it (a next round's identical model is encoded anew)
        retire = getattr(self.backend, "retire", None)
        if retire is not None:
            retire()
        return report

    # ------------------------------------------------------------------
    def run_async(self, global_payload, strategy, *, availability=None,
                  cohort_k: int = 0, cohort_seed: int = 0,
                  streaming_hub: bool = False, **limits):
        """Event-driven execution of this deployment (fl/scheduler.py):
        same backend + clients, but the strategy decides when to merge.
        ``availability``: optional fl/fault.AvailabilityTrace replayed as
        join/leave loop events; ``cohort_k``/``streaming_hub``: the
        fleet-scale knobs, passed through to the scheduler.
        Returns (AsyncRunReport, FLScheduler)."""
        from repro_torch.fl.scheduler import FLScheduler
        sched = FLScheduler(self.backend, self.clients, strategy,
                            local_steps=self.local_steps,
                            server_lr=self.server_lr,
                            availability=availability,
                            cohort_k=cohort_k, cohort_seed=cohort_seed,
                            streaming_hub=streaming_hub)
        report = sched.run(global_payload, **limits)
        if sched.global_params is not None:
            self.global_params = sched.global_params
        self.now = sched.loop.now
        return report, sched


def quorum_cutoff(ready_sorted, n_expected: int, quorum_fraction: float,
                  round_deadline_s: float, t0: float):
    """Shared quorum/deadline policy: when does a sync(-ish) round close,
    who made it, who is late. ``ready_sorted``: sorted (arrive_t, cid)."""
    ready_sorted = list(ready_sorted)
    need = max(1, int(np.ceil(quorum_fraction * n_expected)))
    need = min(need, len(ready_sorted))
    cutoff_t = ready_sorted[need - 1][0] if ready_sorted else t0
    if round_deadline_s:
        cutoff_t = min(cutoff_t, t0 + round_deadline_s)
    counted = [cid for (at, cid) in ready_sorted if at <= cutoff_t + 1e-9]
    late = [cid for (at, cid) in ready_sorted if at > cutoff_t + 1e-9]
    return cutoff_t, counted, late


def _is_mpi(backend) -> bool:
    return getattr(backend, "name", "").startswith("mpi")


def _server_comm(arrivals, counted) -> float:
    """Server-side receive span (first byte to last counted update)."""
    if not counted:
        return 0.0
    ts = [arrivals[cid][0] for cid in counted]
    return max(ts) - min(ts) if len(ts) > 1 else 0.0


def _avg_timings(timings: List[ClientTiming], arrivals, round_end) -> Dict[str, float]:
    if not timings:
        return {k: 0.0 for k in ("communication", "migration",
                                 "serialization", "waiting", "training")}
    out = {
        "communication": float(np.mean([t.communication for t in timings])),
        "migration": float(np.mean([t.migration for t in timings])),
        "serialization": float(np.mean([t.serialization for t in timings])),
        "training": float(np.mean([t.training for t in timings])),
    }
    waits = []
    for cid, (at, ser, msg, _) in arrivals.items():
        waits.append(max(round_end - at, 0.0))
    out["waiting"] = float(np.mean(waits)) if waits else 0.0
    # fold upload serialization into the client's serialization state
    sers = [arrivals[cid][1] for cid in arrivals]
    out["serialization"] += float(np.mean(sers)) if sers else 0.0
    return out
