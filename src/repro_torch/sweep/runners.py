"""Port of ``src/repro/sweep/runners.py`` (copied; imports re-pointed).

Generic cell runner: one Scenario -> unified metrics, via build_runtime.

The studies under ``benchmarks/`` measure figure-specific quantities and
keep their own ``run_cell``; this module is the *generic* measurement the
sweep CLI (``fl_train --sweep`` / ``python -m repro_torch.sweep``) applies to
every cell: build the scenario's runtime, run its strategy mode end to
end with tier-calibrated simulated training and tier-sized virtual
payloads, and report the unified CellResult block — simulated time,
bytes on the wire, per-stage/state charges, retransmits, round records.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.configs.paper_tiers import TIERS
from repro_torch.core.message import VirtualPayload
from repro_torch.fl.client import FLClient
from repro_torch.fl.scheduler import FLScheduler
from repro_torch.fl.server import FLServer
from repro_torch.scenario import MultiScenario, Runtime, Scenario, build_runtime


def wire_stats(fabric, store=None, job: str = "") -> Dict[str, float]:
    """The fabric's wire-level accounting in CellResult's field names.
    ``job`` selects one tenant's namespaced counters ("" = the global
    view, which every per-job view sums to)."""
    stats = fabric.stats if not job else fabric.stats_for(job)
    out = {"bytes_on_wire": float(stats["bytes"]),
           "retransmits": float(stats["retransmits"]),
           "transfers_failed": float(stats["transfers_failed"]),
           "n_cross_job_hits": float(stats["cross_job_hits"])}
    if store is not None:
        out["s3_retries"] = float(store.stats["retries"])
    return out


def make_clients(rt: Runtime, *, train_s: Optional[float] = None,
                 compression: Optional[str] = None):
    """Tier-calibrated simulated clients over the runtime's backends."""
    tier = TIERS[rt.scenario.fleet.tier]
    if train_s is None:
        train_s = rt.scenario.fleet.train_s \
            or tier.train_s(rt.scenario.topology.kind)
    return [FLClient(h.host_id, rt.make_backend(h.host_id,
                                                compression=compression),
                     sim_train_s=train_s)
            for h in rt.env.clients]


def run_scenario(scenario: Scenario, *,
                 rounds: Optional[int] = None) -> Dict[str, Any]:
    """Run one cell's scenario end to end.

    ``strategy.mode`` picks the loop: ``sync`` runs lockstep
    ``FLServer.run_round`` rounds; the event-driven modes run the
    scheduler under ``make_strategy`` with ``rounds`` aggregations."""
    scenario.validate()
    rt = build_runtime(scenario)
    tier = TIERS[scenario.fleet.tier]
    rounds = scenario.strategy.rounds if rounds is None else rounds
    mode = scenario.strategy.mode

    if mode == "sync":
        clients = make_clients(rt)
        server = FLServer(rt.make_backend("server", compression="none"),
                          clients,
                          quorum_fraction=scenario.strategy.quorum_fraction,
                          round_deadline_s=scenario.strategy.round_deadline_s,
                          local_steps=scenario.fleet.local_steps,
                          live=False)
        reports = []
        for r in range(rounds):
            rep = server.run_round(VirtualPayload(tier.payload_bytes,
                                                  tag=f"sweep-r{r}"))
            reports.append({"round": rep.round,
                            "round_time": rep.round_time,
                            "server": rep.server, "clients": rep.clients,
                            "n_participants": rep.n_participants,
                            "aborted": rep.aborted})
        charges: Dict[str, float] = {}
        for rep in reports:
            for side, states in (("server", rep["server"]),
                                 ("client", rep["clients"])):
                for k, v in states.items():
                    charges[f"{side}.{k}"] = charges.get(f"{side}.{k}", 0.0) \
                        + float(v)
        return {"sim_time_s": server.now, "n_rounds": rounds,
                "round_s": server.now / max(rounds, 1),
                "stage_charges": charges, "round_reports": reports,
                **wire_stats(rt.fabric, rt.store)}

    from repro_torch.fl import make_strategy
    from repro_torch.fl.fault import make_availability
    # the payload codec rides the client update path for the buffered
    # modes; hier compresses its relay WAN hop inside the strategy; the
    # vertical mode compresses BOTH directions — activations up on the
    # clients' channels, activation gradients down on the server's
    strategy_kw: Dict[str, Any] = {}
    if mode == "vertical":
        from repro_torch.fl.vertical import (SIM_BATCH_SIZE, TIER_DEPTH,
                                             bottom_fraction,
                                             sim_activation_nbytes)
        client_comp = scenario.split.activation_codec
        server_comp = scenario.split.activation_codec
        train_s = scenario.fleet.train_s \
            or tier.train_s(scenario.topology.kind)
        depth = TIER_DEPTH.get(scenario.fleet.tier, 8)
        strategy_kw = dict(
            activation_nbytes=sim_activation_nbytes(
                tier.payload_bytes, SIM_BATCH_SIZE,
                scenario.split.cut_layer),
            train_s=train_s,
            bottom_frac=bottom_fraction(scenario.split.cut_layer, depth))
    else:
        client_comp = (scenario.channel.compression
                       if mode in ("fedbuff", "semisync") else "none")
        server_comp = "none"
    clients = make_clients(rt, compression=client_comp)
    strategy = make_strategy(scenario.fl_config(),
                             scenario.topology.num_clients, **strategy_kw)
    availability = make_availability(
        scenario.faults.availability_trace,
        [c.client_id for c in clients],
        horizon_s=scenario.faults.trace_horizon_s, seed=scenario.seed)
    sched = FLScheduler(rt.make_backend("server", compression=server_comp),
                        clients, strategy,
                        local_steps=scenario.fleet.local_steps,
                        availability=availability,
                        cohort_k=scenario.fleet.cohort_k,
                        cohort_seed=scenario.seed,
                        streaming_hub=scenario.strategy.streaming_hub)
    # vertical rounds update parties in place: the "global payload" is an
    # activation-sized bookkeeping record, not a model broadcast
    payload = (VirtualPayload(strategy.activation_nbytes,
                              tag="sweep-vertical")
               if mode == "vertical"
               else VirtualPayload(tier.payload_bytes, tag="sweep"))
    rep = sched.run(payload, max_aggregations=rounds)
    reports = [{"version": e.version, "time": e.time,
                "n_updates": e.n_updates,
                "mean_staleness": e.mean_staleness}
               for e in sched.agg_log]
    out = {"sim_time_s": rep.sim_time, "n_rounds": rep.n_aggregations,
           "round_s": rep.sim_time / max(rep.n_aggregations, 1),
           "aggregations_per_hour": rep.aggregations_per_hour,
           "updates_per_hour": rep.client_updates_per_hour,
           "n_client_updates": rep.n_client_updates,
           "mean_staleness": rep.mean_staleness,
           "n_departures": rep.n_departures,
           "n_rejoins": rep.n_rejoins,
           "n_discarded": rep.n_discarded,
           "round_reports": reports,
           **wire_stats(rt.fabric, rt.store)}
    if scenario.channel.backend == "auto":
        # per-message routing decisions (msg_type -> backend counts), so
        # studies can assert AUTO routes activation traffic by size
        decisions: Dict[str, int] = {}
        for be in [sched.backend] + [c.backend for c in clients]:
            for (mt, _nb, name) in getattr(be, "decisions", []):
                key = f"{mt}:{name}"
                decisions[key] = decisions.get(key, 0) + 1
        out["auto_decisions"] = decisions
    return out


def run_scenario_cell(cell) -> Dict[str, Any]:
    """``Study.cell`` adapter over ``run_scenario`` — module-level so a
    ``--workers`` process pool can pickle the ad-hoc sweep-file study."""
    return run_scenario(cell.scenario)


def run_multi(mspec: MultiScenario, *,
              runtime_out: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Co-schedule every job of a MultiScenario on one shared deployment.

    One topology (jobs[0]'s — validation pins every job to it), ONE
    fabric carrying ``mspec.fabric`` (admission policy + shared links),
    one EventLoop clock. Each job gets its own tenant namespace
    (``fabric.job``), its own tier-calibrated clients and its own
    FLScheduler; all jobs share ONE object store (content-addressed
    dedup works across tenants); tenants otherwise interact only
    through the contended links. The fault model is jobs[0]'s (one physical network
    has one weather system). Returns per-job report blocks plus the
    global wire totals the per-job views sum to. ``runtime_out``, if
    given, is filled with the live fabric + store so callers (the fig12
    admission gates) can inspect granted pipe segments post-run."""
    from repro_torch.core.backends import make_backend
    from repro_torch.core.netsim import NCAL
    from repro_torch.core.objectstore import ObjectStore
    from repro_torch.core.transport import Fabric
    from repro_torch.fl import make_strategy
    from repro_torch.fl.fault import make_availability
    from repro_torch.fl.multijob import MultiScheduler
    from repro_torch.fl.scheduler import EventLoop
    from repro_torch.scenario import fault_model_for

    mspec.validate()
    base = mspec.jobs[0].scenario
    env = base.topology.build()
    fabric = Fabric(env, fault_model=fault_model_for(base),
                    spec=mspec.fabric)
    for h in [env.server] + list(env.clients):
        fabric.register(h.host_id)

    loop = EventLoop()
    multi = MultiScheduler(loop)
    # ONE bucket for the whole deployment: the content-addressed cache is
    # keyed job-blind, so tenants shipping the same wire dedup each
    # other's PUTs (counted as cross_job_hits in the hitter's stats)
    shared_store = ObjectStore(NCAL, fail_rate=base.faults.store_fail_rate)
    stores: Dict[str, ObjectStore] = {}
    for js in mspec.jobs:
        sc = js.scenario
        handle = fabric.job(js.name, priority=js.priority,
                            weight=js.weight)
        store = stores[js.name] = shared_store
        tier = TIERS[sc.fleet.tier]
        ch = sc.channel

        def mk(host_id, compression, *, _sc=sc, _store=store, _h=handle):
            c = _sc.channel
            return make_backend(
                c.backend, env, fabric, host_id, store=_store,
                compression=None if compression in ("", "none")
                else compression,
                wire_codec=c.wire_codec, chunk_mb=c.chunk_mb, job=_h)

        client_comp = ch.compression  # fedbuff/semisync update path
        train_s = sc.fleet.train_s or tier.train_s(sc.topology.kind)
        clients = [FLClient(h.host_id, mk(h.host_id, client_comp),
                            sim_train_s=train_s)
                   for h in env.clients]
        strategy = make_strategy(sc.fl_config(), sc.topology.num_clients)
        availability = make_availability(
            sc.faults.availability_trace, [c.client_id for c in clients],
            horizon_s=sc.faults.trace_horizon_s, seed=sc.seed)
        sched = FLScheduler(mk("server", "none"), clients, strategy,
                            local_steps=sc.fleet.local_steps,
                            availability=availability,
                            cohort_k=sc.fleet.cohort_k,
                            cohort_seed=sc.seed,
                            streaming_hub=sc.strategy.streaming_hub,
                            loop=loop)
        multi.add_job(js.name, sched,
                      VirtualPayload(tier.payload_bytes,
                                     tag=f"multi-{js.name}"),
                      max_aggregations=js.cap(), start_s=js.start_s)

    reports = multi.run()
    if runtime_out is not None:
        runtime_out["fabric"] = fabric
        runtime_out["store"] = shared_store
    jobs_out: Dict[str, Any] = {}
    for name, rep in reports.items():
        jobs_out[name] = {
            "sim_time_s": rep.sim_time, "n_rounds": rep.n_aggregations,
            "round_s": rep.sim_time / max(rep.n_aggregations, 1),
            "n_client_updates": rep.n_client_updates,
            "mean_staleness": rep.mean_staleness,
            **wire_stats(fabric, stores[name], job=name)}
    return {"name": mspec.name,
            "policy": mspec.fabric.policy,
            "shared_links": mspec.fabric.shared_links,
            "jobs": jobs_out,
            **wire_stats(fabric)}
