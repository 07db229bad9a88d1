"""One run of one cell: build the deployment through the port's own
entries, run the checked aggregations and the warm-up in set-up, measure
whole rounds for ``seconds``, then hold the checked aggregations against
the reference.

Set-up: the silo data and initial weights from the seed, the deployment
(``scenario.build_runtime``, ``FLClient``, ``FLServer``, wired as
``launch/fl_train.build_deployment`` wires them, at the cell's batch and
input size), then the first ``check.CHECKED`` aggregations through the
same calls as the window, which also build the kernels and warm every
shape. The window runs aggregations (sync: ``FLServer.run_round``;
event-driven: ``FLServer.run_async`` under the scenario's strategy)
until ``seconds`` have passed, and closes at the first aggregation after
that.
"""
from __future__ import annotations

import copy
import gc
import importlib
import math
import subprocess
import sys
import time

import torch

from fl_bench import check, counts, data, devtrace, weights
from fl_bench.probe import Probe
from fl_bench.reference import fl as ref_fl
from fl_bench.reference.tree import leaves, map_tree

TRACED_AGGREGATIONS = 2  # aggregations of the window the profiler records


def log(msg: str) -> None:
    print(f"[fl_bench] {msg}", file=sys.stderr, flush=True)


def _attr(path: str):
    module, _, name = path.partition(":")
    return getattr(importlib.import_module(module), name)


def port_model(config: dict, device):
    """The port's model class, built from the configuration's sizes."""
    cls = _attr(config["port"]["model"])
    cfg_cls = _attr(config["port"]["config"])
    kw = {}
    for k in cfg_cls.__dataclass_fields__:
        if k in config:
            v = config[k]
            kw[k] = (tuple(tuple(b) for b in v) if k == "blocks"
                     else tuple(v) if isinstance(v, list) else v)
    return cls(cfg_cls(**kw), device=device)


def scenario_for(cell, seed: int):
    from repro_torch.scenario import Scenario
    sc = copy.deepcopy(cell.traffic["scenario"])
    sc["seed"] = seed % 2 ** 31
    sc.setdefault("fleet", {})["tier"] = cell.config["tier"]
    return Scenario.from_dict(sc).validate()


def build(cell, sc, silos, *, seed: int, device):
    """The live deployment, wired as ``build_deployment`` wires it."""
    from repro_torch.configs.paper_tiers import TIERS
    from repro_torch.fl import FLClient, FLServer
    from repro_torch.launch import fl_train
    from repro_torch.scenario import build_runtime
    fl_cfg = sc.fl_config()
    rt = build_runtime(sc)
    model = port_model(cell.config, device)
    train_fn = fl_train.make_train_fn(model)
    mode = fl_cfg.mode
    sim_train = 0.0 if mode == "sync" else \
        TIERS[sc.fleet.tier].train_s(fl_cfg.environment)
    compression = fl_cfg.compression if mode in ("fedbuff", "semisync") \
        else "none"
    clients = [FLClient(host.host_id,
                        rt.make_backend(host.host_id, compression=compression,
                                        device=device),
                        dataset=silos[i], train_fn=train_fn,
                        batch_size=cell.traffic["batch_size"],
                        sim_train_s=sim_train, seed=seed + i, device=device)
               for i, host in enumerate(rt.env.clients)]
    server = FLServer(rt.make_backend("server", compression="none",
                                      device=device),
                      clients, quorum_fraction=fl_cfg.quorum_fraction,
                      round_deadline_s=fl_cfg.round_deadline_s,
                      local_steps=sc.fleet.local_steps)
    server.model = model
    return server, clients, fl_cfg


def agreed(cell, sc, fl_cfg, clients) -> None:
    """The reference's settings, stated in the traffic file, are the
    ones the program runs with."""
    ref = cell.traffic["reference"]
    codec = fl_cfg.compression if fl_cfg.mode in ("fedbuff", "semisync") \
        else "none"
    stage = clients[0].backend.channel.compress_stage
    got = {"codec": codec if stage is not None else "none",
           "error_feedback": bool(stage is not None
                                  and stage.error_feedback),
           "staleness_exponent": fl_cfg.staleness_exponent,
           "server_lr": fl_cfg.server_lr}
    for k, v in got.items():
        if ref[k] != v:
            raise ValueError(f"traffic '{cell.name}': the reference takes "
                             f"{k}={ref[k]!r}, the program runs {v!r}")


def host_copy(tree):
    return map_tree(lambda t: t.detach().to("cpu", copy=True), tree)


def p95(xs):
    """Nearest-rank 95th percentile."""
    s = sorted(xs)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


class Window:
    """Round boundaries, the profiler, and when the window closes."""

    def __init__(self, probe: Probe, seconds: float, trace: bool, t0: float):
        self.probe, self.seconds, self.trace = probe, seconds, trace
        self.t0 = t0
        self.checked = []  # host copies of the global after each checked agg
        self.aggs = 0
        self.rounds = 0
        self.t_start = self.t_end = None
        self.prof = None
        self.note = None
        self.t_rest = None
        self.discarded0 = 0

    def after(self, global_params, sched=None) -> bool:
        """Called at each aggregation's end; True once the window closed."""
        self.aggs += 1
        self.probe.versions[self.aggs] = self.probe.norms(global_params)
        if self.aggs <= check.CHECKED:
            self.checked.append(host_copy(global_params))
            log(f"checked aggregation {self.aggs} done at "
                f"{time.perf_counter() - self.t0} s")
        if self.aggs == check.CHECKED:
            self.open(sched)
            return False
        if self.t_start is None or self.t_end is not None:
            return self.t_end is not None
        self.rounds += 1
        self.probe.counts["aggregations"] += 1
        if self.prof is not None and self.rounds == TRACED_AGGREGATIONS:
            self.stop_profile()
        self.probe.sync()
        # a traced run measures its spans for ``seconds`` after the
        # traced part, which the profiler slows
        since = self.t_rest if self.trace else self.t_start
        if since is not None and time.perf_counter() - since >= self.seconds:
            self.close(sched)
        return self.t_end is not None

    def open(self, sched) -> None:
        self.probe.sync()
        if sched is not None:
            self.discarded0 = sched.discarded
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.probe.cuda:
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            self.probe.profiling = True
            self.note = torch.profiler.record_function(devtrace.TRACED)
            self.note.__enter__()
        self.probe.in_window = True
        self.probe.window_opened = True
        self.t_start = time.perf_counter()

    def stop_profile(self) -> None:
        """End the traced part. The host spans and counters restart here,
        so the per-layer metrics read the rest of the window, which the
        profiler does not slow."""
        self.probe.sync()
        self.note.__exit__(None, None, None)
        self.probe.profiling = False
        self.prof.stop()
        self.probe.spans.clear()
        self.probe.counts.clear()
        self.probe.sync()
        self.t_rest = time.perf_counter()

    def close(self, sched) -> None:
        self.probe.sync()
        self.t_end = time.perf_counter()
        self.probe.in_window = False
        if self.prof is not None and self.probe.profiling:
            self.stop_profile()
        if sched is not None:
            self.discarded = sched.discarded - self.discarded0
            sched.finished = True
            sched.loop.stop()


def codec_bytes(codec: str, n: int) -> int:
    """Logical bytes of one update through the payload codec's device ops."""
    name, _, arg = (codec or "none").partition(":")
    if name == "topk":
        k = max(1, int(n * (float(arg) if arg else 0.05)))
        return 4 * n + 8 * k
    if name == "qsgd":  # quantize, then dequantize
        blocks = math.ceil(n / (int(arg) if arg else 256))
        return 2 * (4 * n + n + 4 * blocks)
    return 0


class RunView:
    """What a per-layer metric's reader reads."""

    def __init__(self, probe, window, reduced, flops, card):
        self.spans = dict(probe.spans)
        self.counts = dict(probe.counts)
        self.range_bytes = dict(probe.range_bytes)
        # the untraced rest of the window (all of it in an untraced run)
        self.window_s = window.t_end - (window.t_rest or window.t_start)
        # updates begun in it: one in flight across the traced part carries
        # the profiler's cost
        self.update_ms = [ms for t, ms in zip(probe.update_began,
                                              probe.update_ms)
                          if window.t_rest is None or t >= window.t_rest]
        self.flops_per_step = flops
        self.trace = reduced  # None when untraced
        self.card = card  # None off the card


def run_event_driven(server, fl_cfg, sc, params0, probe, window) -> None:
    """``FLServer.run_async`` under the scenario's strategy, as
    ``launch/fl_train.run_event_driven`` drives it."""
    from repro_torch.core.message import TensorPayload
    from repro_torch.fl import make_strategy
    from repro_torch.fl.fault import make_availability
    if fl_cfg.streaming_hub:
        raise NotImplementedError("the reference replays the dense hub only")
    strategy = make_strategy(fl_cfg, fl_cfg.num_clients)
    availability = make_availability(
        fl_cfg.availability_trace, [c.client_id for c in server.clients],
        horizon_s=sc.faults.trace_horizon_s, seed=fl_cfg.seed)
    probe.after_aggregation = lambda sched: window.after(
        sched.global_params, sched)
    server.run_async(TensorPayload(params0), strategy,
                     availability=availability, cohort_k=fl_cfg.cohort_k,
                     cohort_seed=fl_cfg.seed,
                     streaming_hub=fl_cfg.streaming_hub,
                     max_aggregations=10 ** 9)


def program(cell, sc, silos, params0, *, seed, seconds, trace, device, flops,
            t0=None):
    """The program's part of a run; its state dies when this returns."""
    server, clients, fl_cfg = build(cell, sc, silos, seed=seed, device=device)
    agreed(cell, sc, fl_cfg, clients)
    ids = [c.client_id for c in clients]
    probe = Probe(mode=fl_cfg.mode, trace=trace, cuda=device.type == "cuda")
    probe.install(clients, silos)
    probe.versions[0] = probe.norms(params0)
    window = Window(probe, seconds, trace,
                    time.perf_counter() if t0 is None else t0)
    try:
        if fl_cfg.mode == "sync":
            from repro_torch.core.message import TensorPayload
            params = params0
            while True:
                server.run_round(TensorPayload(params))
                params = server.global_params
                if window.after(params):
                    break
        else:
            run_event_driven(server, fl_cfg, sc, params0, probe, window)
        if window.t_end is None:
            raise RuntimeError(
                f"the run stopped after {window.aggs} aggregations, before "
                "its window closed")
    finally:
        probe.uninstall()
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    served = check.served_gap(
        {v: n.tolist() for v, n in probe.versions.items()},
        [(v, n.tolist()) for v, n in probe.served])
    reduced = devtrace.reduce(window.prof) if trace else None
    card = torch.cuda.get_device_name(device) if cuda else None
    return {"fl_cfg": fl_cfg, "ids": ids, "window": window, "peak": peak,
            "view": RunView(probe, window, reduced, flops, card),
            "schedule": probe.schedule[:check.CHECKED],
            "losses": {(ids.index(c), v): l
                       for (c, v), l in probe.losses.items()},
            "first_losses": {(ids.index(c), v): l
                             for (c, v), l in probe.first_losses.items()},
            "update_ms": list(probe.update_ms),
            "served_model_gap": served,
            "failed": getattr(window, "discarded", 0)}


def replay(cell, sc, prog, seed, p0, silos, device, dtype=torch.float32):
    """The reference's replay of the checked aggregations (TF32 off), the
    model computing in ``dtype``. -> (host globals, {(client, version):
    mean local loss})."""
    ref = cell.traffic["reference"]
    if ref["error_feedback"]:
        raise NotImplementedError("the reference replays codecs without "
                                  "error feedback only")
    ids = prog["ids"]
    schedule = [[{"client": ids.index(r["client"]), "version": r["version"]}
                 for r in agg] for agg in prog["schedule"]]
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        want, losses, first = ref_fl.replay(
            cell.config["family"], cell.config,
            map_tree(lambda t: t.to(device), p0), silos, schedule,
            client_seeds=[seed + i for i in range(len(ids))],
            batch_size=cell.traffic["batch_size"],
            local_steps=sc.fleet.local_steps, codec=ref["codec"],
            mode=prog["fl_cfg"].mode,
            staleness_exponent=ref["staleness_exponent"],
            server_lr=ref["server_lr"], device=device, dtype=dtype)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    return [host_copy(t) for t in want], losses, first


def prepare(cell, seed: int, device):
    """Set-up before the program: scenario, silo data, initial weights,
    the FLOP count. -> dict."""
    cfg, traffic = cell.config, cell.traffic
    family = ref_fl.model_module(cfg["family"])
    specs = family.param_specs(cfg)
    sc = scenario_for(cell, seed)
    silos = data.silo_datasets(sc.topology.num_clients,
                               examples=traffic["examples_per_silo"],
                               num_classes=cfg["num_classes"],
                               image_size=traffic["image_size"], seed=seed)
    params0 = weights.init_params(specs, seed, device)
    flops = counts.step_flops(family, cfg, specs, traffic["batch_size"],
                              traffic["image_size"])
    return {"specs": specs, "sc": sc, "silos": silos, "params0": params0,
            "p0": host_copy(params0), "flops": flops}


def readings(cell, seed: int, device, *, control: bool = False) -> dict:
    """The compared numbers of one seed with no measured window: the
    program against the reference, or (``control``) the reference in
    bfloat16 put in the program's place."""
    device = torch.device(device)
    pre = prepare(cell, seed, device)
    prog = program(cell, pre["sc"], pre["silos"], pre.pop("params0"),
                   seed=seed, seconds=0.0, trace=False, device=device,
                   flops=pre["flops"])
    gc.collect()
    want = replay(cell, pre["sc"], prog, seed, pre["p0"], pre["silos"],
                  device)
    got = (prog["window"].checked, prog["losses"], prog["first_losses"]) \
        if not control else replay(cell, pre["sc"], prog, seed, pre["p0"],
                                   pre["silos"], device, dtype=torch.bfloat16)
    return check.readings(pre["p0"], got, want, prog["served_model_gap"])


def run(cell, *, seed: int, seconds: float, trace: bool, device, t0: float):
    """-> the result's fields: correct, attempted, failed, metrics, device,
    breakdown (traced runs), checks (last)."""
    log(f"set-up starts at {time.perf_counter() - t0} s (imports done)")
    device = torch.device(device)
    cuda = device.type == "cuda"
    cfg, traffic = cell.config, cell.traffic
    pre = prepare(cell, seed, device)
    specs, sc, silos, p0, flops = (pre[k] for k in
                                   ("specs", "sc", "silos", "p0", "flops"))
    params0 = pre.pop("params0")
    n_params = sum(math.prod(s[1]) for s in leaves(specs))
    log(f"{cell.name}: {cfg['name']}, {len(leaves(specs))} leaves, "
        f"{n_params} parameters; model FLOPs of one local step (forward "
        f"and backward of {traffic['batch_size']} images of "
        f"{traffic['image_size']}x{traffic['image_size']}, "
        f"FlopCounterMode): {flops}")
    codec = traffic["reference"]["codec"]
    log(f"logical bytes: FedAvg of N updates (N + 1) x {4 * n_params}; "
        f"payload codec '{codec}', one update there and back: "
        f"{codec_bytes(codec, n_params)}")

    log(f"data, weights and counts ready at {time.perf_counter() - t0} s")
    prog = program(cell, sc, silos, params0, seed=seed, seconds=seconds,
                   trace=trace, device=device, flops=flops, t0=t0)
    del params0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    window = prog["window"]
    setup_s = window.t_start - t0
    window_s = window.t_end - window.t_start
    update_ms = prog["update_ms"]
    log(f"window {window_s} s: {window.rounds} aggregations, "
        f"{len(update_ms)} updates; set-up {setup_s} s")

    want = replay(cell, sc, prog, seed, p0, silos, device)
    values = check.readings(
        p0, (window.checked, prog["losses"], prog["first_losses"]), want,
        prog["served_model_gap"])
    correct, checks = check.verdict(values, cell.limits)

    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]](prog["view"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"setup_s": setup_s, "round_s": window_s / window.rounds,
               "update_p95_ms": p95(update_ms) if update_ms else None}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if e2e.get(m["name"]) is not None}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": prog["peak"]}
    if cuda:
        dev["card_and_power_limit"] = power_limit()
    out = {"correct": bool(correct),
           "attempted": len(update_ms) + prog["failed"],
           "failed": prog["failed"], "metrics": metrics, "device": dev}
    if trace:
        reduced = prog["view"].trace
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["traced_s"]
        out["breakdown"] = {"device_ops": reduced["device_ops"],
                            "idle_gaps": reduced["idle_gaps"]}
    out["checks"] = checks
    return out
