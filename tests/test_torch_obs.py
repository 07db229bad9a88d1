"""The port's own spans and counters (``repro_torch/obs.py``) on the CPU:
off by default; exclusive time per thread, through errors and the
``spanned`` decorator; on, a reduced sync round and a FedBuff run with
qsgd count what their schedules say, leave the global model bit for bit
as it is with the tracer off, and, under ``torch.profiler``, put every
span on the trace as a ``repro_torch.*`` annotation nested as its stack,
which leaves ``fl_bench/devtrace.py``'s reduction as it is."""
import functools
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import _tree, obs
from repro_torch.compression import stages
from repro_torch.configs.base import FLConfig
from repro_torch.core import TensorPayload
from repro_torch.core import channel as channel_mod
from repro_torch.core import serialization
from repro_torch.fl import make_strategy
from repro_torch.fl import scheduler as sched_mod
from repro_torch.fl import server as server_mod
from repro_torch.launch import fl_train

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

LOCAL_STEPS = 2
AGGREGATIONS = 2
CASES = {
    "sync": dict(mode="sync", backend="grpc"),
    "fedbuff-qsgd": dict(mode="fedbuff", backend="grpc+s3",
                         compression="qsgd", buffer_k=2),
}
# each span's parent in the sync round's stack
SYNC_PARENT = {
    "wire.encode": "round.sync", "wire.serialize": "wire.encode",
    "wire.decode": "round.sync", "wire.deserialize": "wire.decode",
    "wire.place": "wire.decode", "client.local_train": "round.sync",
    "client.input.draw": "client.local_train",
    "client.input.h2d": "client.local_train",
    "client.step": "client.local_train",
    "client.step.forward": "client.step",
    "client.step.backward": "client.step",
    "client.step.update": "client.step",
    "client.loss_read": "client.local_train",
    "round.aggregate": "round.sync", "round.sync": None,
}


def _counting(fn, counter, key, n=lambda *a: 1):
    def wrapped(*args, **kw):
        counter[key] = counter.get(key, 0) + n(*args)
        return fn(*args, **kw)
    return wrapped


def _deploy(case, held):
    """A reduced CPU deployment whose measured seconds are pinned (the
    simulated clock then holds no wall time, so the schedule is the same
    with the tracer on and off); ``held`` counts the train steps and the
    wires deserialized, apart from the tracer."""
    cfg = FLConfig(num_clients=3, rounds=AGGREGATIONS, seed=0,
                   **CASES[case])
    server, params, _, _ = fl_train.build_deployment(
        cfg, local_steps=LOCAL_STEPS, device="cpu")
    for c in server.clients:
        c.sim_train_s = c.sim_train_s or 1.0
        c.train_fn = _counting(c.train_fn, held, "steps")
    return cfg, server, params


@functools.lru_cache(maxsize=None)
def _run(case, traced):
    held = {}
    cfg, server, params = _deploy(case, held)
    Q = stages.QsgdCodec
    S = serialization.BaseSerializer
    saved = (server_mod.fedavg, sched_mod.fedavg, channel_mod.decode_wire,
             Q._compress_tree, Q._compress_flats, S.serialize)

    def fedavg(trees, weights):
        return saved[0](trees, weights)[0], 0.0

    def serialize(ser, payload):
        wire = saved[5](ser, payload)
        held["wire_bytes"] = held.get("wire_bytes", 0) + wire.nbytes
        return wire
    server_mod.fedavg = sched_mod.fedavg = fedavg
    S.serialize = serialize
    channel_mod.decode_wire = _counting(
        _counting(saved[2], held, "decoded"), held, "wire_bytes",
        lambda wire, fallback: wire.nbytes)
    Q._compress_tree = _counting(saved[3], held, "compressed")
    Q._compress_flats = _counting(saved[4], held, "compressed",
                                  lambda codec, flats, states: len(flats))
    if traced:
        obs.enable()
    try:
        if cfg.mode == "sync":
            for _ in range(AGGREGATIONS):
                server.run_round(TensorPayload(params))
                params = server.global_params
            held["aggregations"] = len(server.reports)
            held["events"] = 0
        else:
            report, sched = server.run_async(
                TensorPayload(params), make_strategy(cfg, cfg.num_clients),
                max_aggregations=AGGREGATIONS)
            held["aggregations"] = report.n_aggregations
            held["events"] = len(sched.loop.trace)
        snap = obs.snapshot() if traced else None
    finally:
        obs.disable()
        (server_mod.fedavg, sched_mod.fedavg, channel_mod.decode_wire,
         Q._compress_tree, Q._compress_flats, S.serialize) = saved
    model = [l.numpy().tobytes() for l in _tree.leaves(server.global_params)]
    return snap, held, model


def test_off_by_default():
    """In a fresh process: off, one shared no-op, nothing recorded."""
    code = ("from repro_torch import obs\n"
            "a, b = obs.span('a'), obs.span('b')\n"
            "with a:\n"
            "    obs.count('c')\n"
            "print(obs.enabled(), a is b, obs.snapshot())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "False True {'spans': {}, 'counters': {}}"


@pytest.mark.parametrize("case", CASES)
def test_counts_match_the_schedule(case):
    snap, held, _ = _run(case, True)
    spans, counters = snap["spans"], snap["counters"]
    steps = held["steps"]
    assert steps == spans["client.local_train"]["n"] * LOCAL_STEPS > 0
    for name in ("client.step", "client.step.forward",
                 "client.step.backward", "client.step.update",
                 "client.loss_read", "client.input.draw",
                 "client.input.h2d"):
        assert spans[name]["n"] == steps, name
    assert counters["round.aggregations"] == held["aggregations"] \
        == AGGREGATIONS
    # the wire's bytes, both ways; the object store's only on gRPC+S3
    assert counters["wire.bytes"] == held["wire_bytes"] > 0
    store = {"store.bytes_put", "store.bytes_released",
             "store.objects_released"}
    assert set(counters) == {"round.aggregations", "wire.bytes"} | (
        store if CASES[case]["backend"] == "grpc+s3" else set())
    assert spans["wire.deserialize"]["n"] == held["decoded"] > 0
    assert spans["wire.decode"]["n"] >= spans["wire.place"]["n"] > 0
    for name, s in spans.items():
        assert 0 <= s["excl_s"] <= s["incl_s"], name
    if case == "sync":
        assert spans["round.sync"]["n"] == AGGREGATIONS
        assert "runtime.event" not in spans and "codec.compress" not in spans
    else:
        assert spans["runtime.event"]["n"] == held["events"]
        assert "round.sync" not in spans
        # each compress span compresses one update or a batch of them
        assert 0 < spans["codec.compress"]["n"] <= held["compressed"]
        assert spans["codec.decompress"]["n"] > 0


@pytest.mark.parametrize("case", CASES)
def test_tracing_leaves_the_model_bit_for_bit(case):
    _, held_off, off = _run(case, False)
    _, held_on, on = _run(case, True)
    assert held_off == held_on
    assert off == on


@obs.spanned("decorated")
def _decorated(x, *, y=1):
    """Its own docstring."""
    with obs.span("decorated.inner"):
        time.sleep(0.002)
    return x + y


@pytest.mark.parametrize("on", [False, True])
def test_spanned_keeps_the_function(on):
    obs.enable() if on else obs.reset()
    try:
        assert _decorated(2, y=3) == 5
        snap = obs.snapshot()
    finally:
        obs.disable()
    assert _decorated.__name__ == "_decorated"
    assert _decorated.__doc__ == "Its own docstring."
    if not on:
        assert snap == {"spans": {}, "counters": {}}
        return
    outer, inner = snap["spans"]["decorated"], snap["spans"]["decorated.inner"]
    assert outer["n"] == inner["n"] == 1
    # the nested span's time is the outer one's less its exclusive time
    assert outer["incl_s"] - outer["excl_s"] == \
        pytest.approx(inner["incl_s"], abs=1e-9)
    assert inner["excl_s"] == inner["incl_s"] >= 0.002


def _raise_in_span():
    with obs.span("failing"):
        raise ValueError("inside")


@obs.spanned("failing")
def _raise_in_spanned():
    raise ValueError("inside")


@pytest.mark.parametrize("fail", [_raise_in_span, _raise_in_spanned])
def test_a_span_closes_on_error(fail):
    obs.enable()
    try:
        with obs.span("outer"):
            with pytest.raises(ValueError, match="inside"):
                fail()
            # the failed span left the stack: this one nests in ``outer``
            with obs.span("after"):
                pass
        snap = obs.snapshot()
    finally:
        obs.disable()
    spans = snap["spans"]
    assert spans["failing"]["n"] == spans["after"]["n"] == 1
    nested = spans["failing"]["incl_s"] + spans["after"]["incl_s"]
    assert spans["outer"]["incl_s"] - spans["outer"]["excl_s"] == \
        pytest.approx(nested, abs=1e-9)


def test_threads_keep_their_own_stacks():
    """A span on another thread, open while this thread's span is, does
    not count as nested in it."""
    started, release = threading.Event(), threading.Event()

    def other():
        with obs.span("other"):
            started.set()
            release.wait(5)

    obs.enable()
    try:
        worker = threading.Thread(target=other)
        with obs.span("main"):
            worker.start()
            started.wait(5)
            time.sleep(0.002)
            release.set()
            worker.join(5)
        snap = obs.snapshot()
    finally:
        obs.disable()
    main, other_ = snap["spans"]["main"], snap["spans"]["other"]
    assert main["excl_s"] == main["incl_s"] >= 0.002
    assert other_["excl_s"] == other_["incl_s"] > 0


@pytest.mark.parametrize("batched", [False, True])
def test_an_encode_is_one_wire_span(batched):
    """``Channel.encode`` of one update and ``encode_batch`` of three
    each open one ``wire.encode`` span, with a serialize span an update
    (the batch compresses in one fused call), and the wires are the
    same bytes with the tracer on and off."""
    import numpy as np
    import torch
    rng = np.random.default_rng(3)
    trees = [{"w": torch.from_numpy(rng.standard_normal((64, 32),
                                                       dtype=np.float32)),
              "b": torch.from_numpy(rng.standard_normal(32,
                                                        dtype=np.float32))}
             for _ in range(3 if batched else 1)]

    def encode():
        ch = channel_mod.make_channel("membuff", compression="qsgd",
                                      device="cpu")
        items = [(TensorPayload(t), f"silo{i}") for i, t in enumerate(trees)]
        encs = (ch.encode_batch(items) if batched
                else [ch.encode(*items[0])])
        return [b"".join(np.asarray(b).tobytes() for b in e.wire.buffers)
                for e in encs]
    off = encode()
    obs.enable()
    try:
        on = encode()
        spans = obs.snapshot()["spans"]
    finally:
        obs.disable()
    assert on == off
    assert spans["wire.encode"]["n"] == 1
    assert spans["wire.serialize"]["n"] == len(trees)
    assert spans["codec.compress"]["n"] == 1


def test_reset_restarts_open_spans():
    obs.enable()
    try:
        with obs.span("outer"):
            with obs.span("inner"):
                pass
            obs.reset()
            obs.count("after")
        snap = obs.snapshot()
    finally:
        obs.disable()
    assert set(snap["spans"]) == {"outer"} and snap["spans"]["outer"]["n"] == 1
    assert snap["counters"]["after"] == 1


def _profiled_sync_round(traced):
    from fl_bench import devtrace, progtrace
    _, server, params = _deploy("sync", {})
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        with record_function(devtrace.TRACED):
            if traced:
                obs.enable()
            try:
                server.run_round(TensorPayload(params))
                snap = obs.snapshot()
            finally:
                obs.disable()
    finally:
        prof.stop()
    return devtrace.reduce(prof), progtrace.events_of(prof), snap


def test_profiler_annotations_nest_and_leave_devtrace_alone():
    from fl_bench import progtrace
    reduced, events, snap = _profiled_sync_round(True)
    plain, plain_events, _ = _profiled_sync_round(False)
    notes = sorted((e.start_ns, -e.end_ns, e.name[len(obs.PREFIX):])
                   for e in events if e.name.startswith(obs.PREFIX))
    assert not any(e.name.startswith(obs.PREFIX) for e in plain_events)
    assert {n for _, _, n in notes} == set(snap["spans"]) \
        == set(SYNC_PARENT)
    for name, s in snap["spans"].items():
        assert sum(n == name for _, _, n in notes) == s["n"], name
    # each annotation's innermost enclosing one is its span's parent
    for i, (s, e, name) in enumerate(notes):
        outer = [o for o in notes[:i] if -o[1] >= -e]
        assert (outer[-1][2] if outer else None) == SYNC_PARENT[name], name
    assert reduced["busy_s"] == plain["busy_s"] == 0
    assert reduced["device_ops"] == plain["device_ops"] == []
    assert [k for k, _ in reduced["idle_gaps"]] == \
        [k for k, _ in plain["idle_gaps"]]
    assert set(reduced["range_device_s"]) == set(plain["range_device_s"])
    steps = progtrace.reduce_events(events)["steps"]
    assert steps == snap["spans"]["client.step"]["n"]
