"""Port of ``src/repro/launch/fl_train.py``: the sync round, the
event-driven runtime (``--mode fedbuff|semisync|hier|vertical``), and the
sweep (``--sweep``) and multi-tenant (``--multi``) runners.

Cross-silo FL driver — the paper's end-to-end system, live.

Server + N silo clients training a real model (default: the paper's Small
tier, ResNet56) over a chosen backend and topology; payloads really move
through the backend; time is simulated-clock seconds. Runs on the CUDA
card unless ``--device`` names another device:

    PYTHONPATH=src python -m repro_torch.launch.fl_train --backend grpc+s3 \\
        --environment geo_distributed --rounds 3 --tier small
    PYTHONPATH=src python -m repro_torch.launch.fl_train \\
        --scenario examples/scenarios/geo_wan_qsgd.json --device cpu

``--mode fedbuff|semisync|hier`` switches to the event-driven runtime
(fl/scheduler.py): clients run independently and ``--rounds`` counts
server aggregations instead of lockstep rounds. ``--mode vertical``
splits the model between the silos (feature parties) and the server
(label party) and exchanges real activations and activation gradients
per batch (fl/vertical.py).

The experiment is one declarative ``Scenario`` (repro_torch/scenario/):
``--scenario FILE`` loads one, and every other flag is an override on
the resolved spec.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import warnings

import torch

from repro_torch import _tree, obs
from repro_torch._device import resolve_device
from repro_torch.configs.base import FLConfig
from repro_torch.configs.paper_tiers import TIERS, build_tier_model
from repro_torch.core import TensorPayload, VirtualPayload
from repro_torch.core.backends import BACKEND_NAMES
from repro_torch.data import make_silo_datasets
from repro_torch.fl import FLClient, FLServer, make_strategy
from repro_torch.fl.fault import (FaultPlan, apply_stragglers,
                                  make_availability)
from repro_torch.launch import train_graph
from repro_torch.scenario import (TOPOLOGY_PRESETS, Scenario, ScenarioError,
                                  build_runtime, with_overrides)

LEARNING_RATE = 0.05
_BIG_LIVE = ("tier 'big' (DistilBERT) cannot train in a live round: the "
             "reference's live path cannot train it either, since "
             "DistilBert.loss takes a classification head that the training "
             "step never passes, and the silos hold images, not tokens")


def make_train_fn(model):
    """One SGD step: autograd over the tree's leaves, then
    ``p - lr * g``. Returns (new_params, loss tensor).

    On a CUDA card each input signature (``train_graph.signature``) is
    captured once into a CUDA graph and replayed after that
    (``train_graph.GraphedStep``); the returned tree is fresh memory each
    call. Elsewhere, or where a signature's capture fails (warned once),
    the step runs eagerly."""
    def step(treedef, leaves, batch):
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        with obs.span("client.step.forward"):
            loss, _ = model.loss(_tree.unflatten(treedef, leaves), batch)
        with obs.span("client.step.backward"):
            grads = torch.autograd.grad(loss, leaves)
        with obs.span("client.step.update"), torch.no_grad():
            new = [p - LEARNING_RATE * g for p, g in zip(leaves, grads)]
        return new, loss.detach()

    graphs = {}  # signature -> GraphedStep, or None where capture failed

    def capture(key, treedef, leaves, batch):
        try:
            graphs[key] = train_graph.GraphedStep(
                functools.partial(step, treedef), leaves, batch)
            return graphs[key].capture(leaves, batch)
        except (RuntimeError, ValueError) as e:
            warnings.warn(f"make_train_fn: this step's CUDA graph capture "
                          f"failed ({e}); it runs eagerly", RuntimeWarning,
                          stacklevel=3)
            graphs[key] = None
            return step(treedef, leaves, batch)

    def train_fn(params, batch):
        leaves, treedef = _tree.flatten(params)
        key = (train_graph.signature(treedef, leaves, batch)
               if leaves[0].is_cuda else None)
        if key is not None and key not in graphs:
            new, loss = capture(key, treedef, leaves, batch)
        elif graphs.get(key) is not None:
            new, loss = graphs[key](leaves, batch)
        else:
            new, loss = step(treedef, leaves, batch)
        return _tree.unflatten(treedef, new), loss
    return train_fn


def build_deployment(fl_cfg: FLConfig, *, tier: str = "small",
                     reduced: bool = True, local_steps: int = 4,
                     fail_rate: float = 0.0, scenario: Scenario = None,
                     device=None):
    """FLConfig/Scenario -> live deployment, through the scenario runtime
    (the same path ``--scenario`` files take). ``device`` defaults to
    CUDA and raises when no card is present.

    Passing *both* ``fl_cfg`` and ``scenario`` is only legal when they
    agree: the scenario's flat projection (``Scenario.fl_config()``)
    must equal ``fl_cfg`` field-for-field, otherwise we raise instead of
    silently preferring one."""
    device = resolve_device(device)
    if scenario is not None:
        back = scenario.fl_config()
        if back != fl_cfg:
            diffs = [f"{f.name}: fl_cfg={getattr(fl_cfg, f.name)!r} "
                     f"scenario={getattr(back, f.name)!r}"
                     for f in dataclasses.fields(FLConfig)
                     if getattr(back, f.name) != getattr(fl_cfg, f.name)]
            raise ValueError(
                "build_deployment got both fl_cfg and scenario but they "
                "disagree (scenario.fl_config() != fl_cfg): "
                + "; ".join(diffs))
        sc = scenario
    else:
        sc = fl_cfg.to_scenario(tier=tier, local_steps=local_steps,
                                store_fail_rate=fail_rate)
    rt = build_runtime(sc)
    env, store = rt.env, rt.store

    if reduced:
        # reduced same-family model so CPU rounds take seconds
        from repro_torch.models.vision import ResNet, ResNetConfig
        model = ResNet(ResNetConfig(blocks_per_stage=2, num_classes=8,
                                    image_size=16), device=device)
    elif tier == "big":
        raise NotImplementedError(_BIG_LIVE)
    else:
        model, _ = build_tier_model(tier, device=device)
    params = model.init(torch.Generator().manual_seed(fl_cfg.seed))

    silos = make_silo_datasets(fl_cfg.num_clients, kind="image",
                               examples_per_silo=64, num_classes=8,
                               image_size=16, seed=fl_cfg.seed)
    train_fn = make_train_fn(model)
    # event-driven modes charge the tier-calibrated training time instead
    # of measured wall seconds ("live compute, simulated clock"): measured
    # seconds must not reorder event arrivals between runs or devices
    sim_train = (0.0 if fl_cfg.mode == "sync"
                 else TIERS[tier].train_s(fl_cfg.environment))
    # the payload codec rides the clients' *update* path (fedbuff /
    # semisync; hier compresses the relay WAN hop inside the strategy
    # instead, and sync rounds aggregate the exact in-process trees). The
    # server's broadcast stays uncompressed. The wire codec and chunked
    # pipelining are lossless and ride every backend (Runtime applies
    # them). Every backend decodes onto the deployment's device.
    if fl_cfg.mode == "vertical":
        # vertical traffic is compressed on BOTH directions: activations
        # up on the clients' channels, gradients down on the server's
        client_compression = server_compression = fl_cfg.activation_codec
    else:
        client_compression = (fl_cfg.compression
                              if fl_cfg.mode in ("fedbuff", "semisync")
                              else "none")
        server_compression = "none"
    clients = []
    for i, host in enumerate(env.clients):
        cb = rt.make_backend(host.host_id, compression=client_compression,
                             device=device)
        clients.append(FLClient(host.host_id, cb, dataset=silos[i],
                                train_fn=train_fn, batch_size=16,
                                sim_train_s=sim_train,
                                seed=fl_cfg.seed + i, device=device))
    server_backend = rt.make_backend("server",
                                     compression=server_compression,
                                     device=device)
    server = FLServer(server_backend, clients,
                      quorum_fraction=fl_cfg.quorum_fraction,
                      round_deadline_s=fl_cfg.round_deadline_s,
                      local_steps=local_steps)
    server.model = model  # the deployed zoo model (vertical mode splits it)
    return server, params, env, store


def _vertical_strategy(fl_cfg: FLConfig, server: FLServer, params,
                       scenario: Scenario):
    """Live VerticalStrategy over the deployment's model: the split
    parties run real SGD and real activation/gradient tensors ride the
    backends' wire stacks (codec + EF per direction, chunking, faults).
    Batches are made on the device that holds ``params``."""
    from repro_torch.fl.vertical import (SIM_BATCH_SIZE, SplitPlan,
                                         VerticalLive, VerticalStrategy,
                                         bottom_fraction,
                                         sim_activation_nbytes)
    plan = SplitPlan(server.model, fl_cfg.cut_layer)
    bottom, top = plan.split_params(params)
    # each feature party starts from the same bottom (they hold disjoint
    # example sets, not disjoint features, in this single-dataset driver)
    bottoms = {c.client_id: bottom for c in server.clients}
    by_id = {c.client_id: c for c in server.clients}
    device = _tree.leaves(params)[0].device

    def batch_fn(cid, round_, batch):
        c = by_id[cid]
        it = c.dataset.batches(c.batch_size,
                               seed=c.seed + 131 * round_ + batch)
        return {k: torch.tensor(v, device=device)
                for k, v in next(it).items()}

    tier = TIERS[scenario.fleet.tier]
    return VerticalStrategy(
        cut_layer=fl_cfg.cut_layer,
        batches_per_round=fl_cfg.batches_per_round,
        activation_nbytes=sim_activation_nbytes(
            tier.payload_bytes, SIM_BATCH_SIZE, fl_cfg.cut_layer),
        train_s=tier.train_s(fl_cfg.environment),
        bottom_frac=bottom_fraction(fl_cfg.cut_layer, plan.n_units),
        live=VerticalLive(plan=plan, bottoms=bottoms, top=top,
                          batch_fn=batch_fn))


def run_event_driven(fl_cfg: FLConfig, server: FLServer, params, store,
                     scenario: Scenario):
    """Async / semi-sync / hierarchical / vertical execution over the
    same deployment. Returns (AsyncRunReport, FLScheduler)."""
    if fl_cfg.mode == "vertical":
        strategy = _vertical_strategy(fl_cfg, server, params, scenario)
        # vertical rounds update the split parties in place — the
        # scheduler's "global payload" is activation-sized bookkeeping,
        # never a model broadcast
        global_payload = VirtualPayload(strategy.activation_nbytes,
                                        tag="vertical-global")
    else:
        strategy = make_strategy(fl_cfg, fl_cfg.num_clients)
        global_payload = TensorPayload(params)
    availability = make_availability(
        fl_cfg.availability_trace,
        [c.client_id for c in server.clients],
        horizon_s=scenario.faults.trace_horizon_s, seed=fl_cfg.seed)
    report, sched = server.run_async(global_payload, strategy,
                                     availability=availability,
                                     cohort_k=fl_cfg.cohort_k,
                                     cohort_seed=fl_cfg.seed,
                                     streaming_hub=fl_cfg.streaming_hub,
                                     max_aggregations=fl_cfg.rounds)
    print(f"[fl:{report.mode}] backend={report.backend} "
          f"sim_time={report.sim_time:.2f}s "
          f"aggregations={report.n_aggregations} "
          f"client_updates={report.n_client_updates} "
          f"(effective {report.effective_updates:.2f}, "
          f"mean staleness {report.mean_staleness:.2f}, "
          f"{report.n_discarded} discarded)")
    if availability is not None or fl_cfg.link_loss_rate > 0:
        fabric = server.backend.fabric
        print(f"[fl:{report.mode}] churn: {report.n_departures} departures, "
              f"{report.n_rejoins} rejoins "
              f"({report.n_late_refetches} S3 late re-fetches); faults: "
              f"{report.n_transfer_failures} failed transfers, "
              f"{fabric.stats['retransmits']:.0f} chunk retransmits")
    for ev in sched.agg_log:
        print(f"    v{ev.version}: t={ev.time:8.2f}s n={ev.n_updates} "
              f"staleness={ev.mean_staleness:.2f} "
              f"loss={ev.loss if ev.loss is not None else float('nan'):.4f}")
    losses = [ev.loss for ev in sched.agg_log if ev.loss is not None]
    ok = len(losses) >= 2 and losses[-1] < losses[0] + 1e-6
    print(f"[fl:{report.mode}] throughput={report.aggregations_per_hour:.1f} "
          f"agg/h, {report.client_updates_per_hour:.1f} updates/h "
          f"({'improving' if ok else 'check'})  s3_stats={store.stats}")
    return report, sched


def _parser() -> argparse.ArgumentParser:
    """Every flag defaults to None: unset flags leave the loaded scenario
    untouched, set ones override it (tests assert this precedence)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default=None,
                    help="scenario JSON (see examples/scenarios/); other "
                         "flags become overrides on the loaded spec")
    ap.add_argument("--sweep", default=None,
                    help="sweep JSON (base scenario + axes, see "
                         "examples/scenarios/sweep_decision_guide.json): "
                         "run every cell through the generic scenario "
                         "runner instead of one training run (equivalent "
                         "to `python -m repro_torch.sweep FILE`)")
    ap.add_argument("--multi", default=None,
                    help="multi-tenant scenario JSON (see examples/"
                         "scenarios/multitenant_pair.json): co-schedule "
                         "every job on one shared fabric + clock under "
                         "the spec's admission policy")
    ap.add_argument("--blackout-trace", default=None,
                    help="JSONL link-outage replay (one {src,dst,t0,t1,"
                         "symmetric} object per line) appended to the "
                         "scenario's inline faults.blackouts")
    ap.add_argument("--sweep-fresh", action="store_true",
                    help="with --sweep: ignore the run store, re-run "
                         "every cell")
    ap.add_argument("--sweep-out-dir", default=None,
                    help="with --sweep: run-store/report root (default: "
                         "./benchmarks_torch/out)")
    ap.add_argument("--backend", default=None, choices=BACKEND_NAMES)
    ap.add_argument("--environment", default=None,
                    choices=list(TOPOLOGY_PRESETS),
                    help="topology preset: the legacy trio or the graph "
                         "presets star | ring | multi_hub")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--clients", type=int, default=None)
    ap.add_argument("--local-steps", type=int, default=None)
    ap.add_argument("--quorum", type=float, default=None)
    ap.add_argument("--drop-rate", type=float, default=0.0,
                    help="sync-mode per-round client drop rate (FaultPlan)")
    ap.add_argument("--tier", default=None)
    ap.add_argument("--mode", default=None,
                    choices=["sync", "fedbuff", "semisync", "hier",
                             "vertical"])
    ap.add_argument("--cut-layer", type=int, default=None,
                    help="vertical mode: unit boundary of the bottom/top "
                         "split (valid cuts: 1..n_units-1 of the deployed "
                         "model)")
    ap.add_argument("--batches-per-round", type=int, default=None,
                    help="vertical mode: forward-activation / "
                         "backward-gradient exchanges per party per round")
    ap.add_argument("--activation-codec", default=None,
                    help="vertical mode: codec on the activation/gradient "
                         "wires, both directions (none | qsgd[:block] | "
                         "topk[:frac])")
    ap.add_argument("--buffer-k", type=int, default=None,
                    help="fedbuff merge buffer (0 = num_clients // 2)")
    ap.add_argument("--staleness-exponent", type=float, default=None)
    ap.add_argument("--max-staleness", type=int, default=None)
    ap.add_argument("--staleness-adaptive", action="store_true",
                    default=None,
                    help="FedAsync-style: scale the staleness exponent by "
                         "each update's observed-staleness percentile")
    ap.add_argument("--deadline", type=float, default=None,
                    help="semisync round deadline, simulated seconds")
    ap.add_argument("--compression", default=None,
                    help="wire-stack compression: none | qsgd[:block] | "
                         "topk[:frac] (payload domain: client updates in "
                         "fedbuff/semisync, relay WAN hop in hier) | "
                         "zlib[:level] (byte domain: every backend "
                         "channel, all modes)")
    ap.add_argument("--chunk-mb", type=float, default=None,
                    help="split wires into pipelined chunks of this size "
                         "(0 = whole-wire sends)")
    ap.add_argument("--availability-trace", default=None,
                    help="client churn for event-driven modes: "
                         "'auto:MEAN_UP/MEAN_DOWN' (generated exponential "
                         "up/down periods) or explicit "
                         "'client0:leave@120,join@400;client3:leave@50'")
    ap.add_argument("--trace-horizon", type=float, default=None,
                    help="horizon (sim s) for generated availability traces")
    ap.add_argument("--link-loss", type=float, default=None,
                    help="per-chunk loss probability on every graph edge "
                         "(deterministic LinkFaultModel; receivers NACK, "
                         "senders retransmit with bounded retries)")
    ap.add_argument("--region-quorum", type=float, default=None,
                    help="hier mode: min live fraction for a region to "
                         "participate in a round (below it the region is "
                         "skipped, folded back in on rejoin)")
    ap.add_argument("--cohort-k", type=int, default=None,
                    help="fedbuff/semisync: seeded K-of-N cohort sampled "
                         "per round (0 = whole fleet; K=N is bit-for-bit "
                         "the full-fleet run)")
    ap.add_argument("--streaming-hub", action="store_true", default=None,
                    help="fold updates into one O(model) accumulator at "
                         "the hub instead of buffering O(clients) records")
    ap.add_argument("--relay-depth", type=int, default=None,
                    help="hier mode: relay-tree levels (1 = the "
                         "single-tier relay)")
    ap.add_argument("--device", default=None,
                    help="torch device to train and aggregate on "
                         "(default: cuda; a missing card is an error)")
    return ap


def resolve_scenario(args, ap: argparse.ArgumentParser) -> Scenario:
    """--scenario file (or the default spec) + flag overrides -> one
    validated Scenario. Precedence: explicit flag > loaded spec > default."""
    try:
        base = (Scenario.load(args.scenario) if args.scenario
                else Scenario(name="fl_train"))
        sc = with_overrides(base, {
            "channel.backend": args.backend,
            "channel.compression": args.compression,
            "channel.chunk_mb": args.chunk_mb,
            "topology.kind": args.environment,
            "topology.num_clients": args.clients,
            "fleet.tier": args.tier,
            "fleet.local_steps": args.local_steps,
            "strategy.mode": args.mode,
            "strategy.rounds": args.rounds,
            "strategy.buffer_k": args.buffer_k,
            "strategy.staleness_exponent": args.staleness_exponent,
            "strategy.max_staleness": args.max_staleness,
            "strategy.staleness_adaptive": args.staleness_adaptive,
            "strategy.quorum_fraction": args.quorum,
            "strategy.round_deadline_s": args.deadline,
            "split.cut_layer": args.cut_layer,
            "split.batches_per_round": args.batches_per_round,
            "split.activation_codec": args.activation_codec,
            "faults.link_loss": args.link_loss,
            "faults.availability_trace": args.availability_trace,
            "faults.trace_horizon_s": args.trace_horizon,
            "faults.blackouts_file": args.blackout_trace,
            "strategy.region_quorum": args.region_quorum,
            "fleet.cohort_k": args.cohort_k,
            "strategy.streaming_hub": args.streaming_hub,
            "topology.relay_depth": args.relay_depth,
        })
        # a byte-domain --compression spec is really the wire codec;
        # split_codecs owns the rule (and rejects two different wire
        # codecs instead of silently clobbering the spec's)
        from repro_torch.compression.stages import split_codecs
        payload_codec, wire = split_codecs(sc.channel.compression,
                                           sc.channel.wire_codec)
        if payload_codec is None and wire is not None \
                and sc.channel.compression not in ("", "none"):
            sc = with_overrides(sc, {
                "channel.wire_codec": sc.channel.compression,
                "channel.compression": "none"})
        return sc.validate()
    except (ScenarioError, KeyError, OSError, ValueError,
            NotImplementedError) as e:
        ap.error(str(e))


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    if args.sweep:
        # a sweep file is a whole grid of scenarios, not one training
        # run: expand + execute through the engine's resumable run store
        from repro_torch.sweep.__main__ import OUT_DIR, run_sweep_file
        try:
            run_sweep_file(args.sweep, out_dir=args.sweep_out_dir or OUT_DIR,
                           fresh=args.sweep_fresh)
        except (ScenarioError, OSError, ValueError) as e:
            ap.error(str(e))
        return 0
    if args.multi:
        # N co-scheduled tenant jobs on one fabric: the generic
        # multi-tenant runner, not one training run
        from repro_torch.scenario import MultiScenario
        from repro_torch.sweep.runners import run_multi
        try:
            res = run_multi(MultiScenario.load(args.multi))
        except (ScenarioError, OSError, ValueError) as e:
            ap.error(str(e))
        print(f"[multi] '{res['name']}': policy={res['policy']} "
              f"shared_links={res['shared_links']} "
              f"jobs={len(res['jobs'])} "
              f"total_bytes={res['bytes_on_wire']:.3e}")
        for name, j in res["jobs"].items():
            print(f"    {name}: {j['n_rounds']} aggregations in "
                  f"{j['sim_time_s']:.2f}s sim "
                  f"({j['round_s']:.2f}s/round, "
                  f"{j['n_client_updates']} client updates, "
                  f"{j['bytes_on_wire']:.3e} B on wire)")
        return 0
    sc = resolve_scenario(args, ap)

    if sc.channel.backend == "grpc+s3" and sc.topology.kind == "lan":
        print("[fl] note: paper omits grpc+s3 on LAN; switching to auto")
        sc = with_overrides(sc, {"channel.backend": "auto"})
    if sc.channel.compression != "none" and sc.strategy.mode == "sync":
        print("[fl] note: payload compression rides the event-driven "
              "update path; sync rounds aggregate exact in-proc trees, "
              "ignoring")
        sc = with_overrides(sc, {"channel.compression": "none"})

    fl_cfg = sc.fl_config()
    print(f"[fl] scenario '{sc.name}': topology={sc.topology.kind} "
          f"x{sc.topology.num_clients} backend={sc.channel.backend} "
          f"mode={sc.strategy.mode} tier={sc.fleet.tier}")
    try:
        server, params, env, store = build_deployment(
            fl_cfg, tier=sc.fleet.tier, local_steps=sc.fleet.local_steps,
            scenario=sc, device=args.device)
    except (RuntimeError, NotImplementedError, KeyError) as e:
        ap.error(str(e))
    if sc.strategy.mode != "sync":
        run_event_driven(fl_cfg, server, params, store, sc)
        return 0
    fault = FaultPlan(drop_rate=args.drop_rate, seed=1)

    losses = []
    for r in range(fl_cfg.rounds):
        dropped, stragglers = fault.for_round(r, [c.client_id for c in
                                                  server.clients])
        apply_stragglers(server.clients, stragglers, fault.straggler_factor)
        report = server.run_round(TensorPayload(params), dropped=dropped)
        if server.global_params is not None:
            params = server.global_params
        losses.append(report.losses)
        print(f"[fl] round {r}: t={report.round_time:8.2f}s sim "
              f"loss={report.losses if report.losses else float('nan'):.4f} "
              f"participants={report.n_participants} "
              f"server_mem={report.peak_server_memory / 2**20:.1f}MB "
              f"{'ABORTED(mpi)' if report.aborted else ''}")
        srv = report.server
        cl = report.clients
        print(f"     server: comm={srv['communication']:.2f} wait={srv['waiting']:.2f} "
              f"agg={srv['aggregation']:.3f} | client: comm={cl['communication']:.2f} "
              f"train={cl['training']:.2f} ser={cl['serialization']:.2f} "
              f"wait={cl['waiting']:.2f}")
    ok = losses[-1] is not None and losses[0] is not None and \
        losses[-1] < losses[0] + 1e-6
    print(f"[fl] losses: {['%.3f' % l if l else 'n/a' for l in losses]} "
          f"({'improving' if ok else 'check'})  s3_stats={store.stats}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
