"""``fl_bench/progtrace.py`` on a hand-made trace, the three program
metrics' readers, and the metrics read through ``scripts/obs_cell.py``'s
hooks around the harness on the CPU."""
import importlib.util
import os
import sys
import types

import pytest

from conftest import REPO, run_cell
from fl_bench.devtrace import TRACED
from fl_bench.progtrace import Event, reduce_events


def ev(name, start, end, corr=0, device=False, annotation=False):
    return Event(name, start, end, corr, device, annotation)


TRACE = [
    ev(TRACED, 0, 1000),
    ev("repro_torch.client.local_train", 100, 900),
    # the batch's copy, issued inside client.input.h2d
    ev("repro_torch.client.input.h2d", 110, 150),
    ev("cudaMemcpyAsync", 120, 130, corr=1),
    ev("Memcpy HtoD (Pageable -> Device)", 140, 170, corr=1, device=True),
    # a step: two launches and a synchronisation, which puts no work on
    # the card
    ev("repro_torch.client.step", 200, 400),
    ev("repro_torch.client.step.forward", 210, 300),
    ev("cudaLaunchKernel", 220, 225, corr=2),
    ev("kernel_a", 230, 260, corr=2, device=True),
    ev("cudaLaunchKernel", 310, 315, corr=3),
    ev("kernel_b", 320, 330, corr=3, device=True),
    ev("cudaDeviceSynchronize", 350, 390, corr=4),
    # a launch between the steps
    ev("cudaLaunchKernel", 500, 505, corr=5),
    ev("kernel_c", 510, 520, corr=5, device=True),
    # the second step, and its annotation's projection on the card
    ev("repro_torch.client.step", 600, 700),
    ev("repro_torch.client.step", 600, 700, device=True, annotation=True),
    ev("cuLaunchKernel", 610, 612, corr=6),
    ev("kernel_d", 620, 640, corr=6, device=True),
    # the received model's copy, in the wire's placement
    ev("repro_torch.wire.decode", 800, 940),
    ev("repro_torch.wire.place", 810, 930),
    ev("cudaMemcpyAsync", 815, 818, corr=8),
    ev("Memcpy HtoD (Pageable -> Device)", 820, 840, corr=8, device=True),
    # a copy outside every program span
    ev("cudaMemcpyAsync", 950, 955, corr=7),
    ev("Memcpy HtoD (Pinned -> Device)", 960, 965, corr=7, device=True),
]


def test_reduce_by_program_span():
    r = reduce_events(TRACE)
    assert r["steps"] == 2 and r["launches"] == 3  # kernels a, b and d
    assert r["h2d_s"] == {"client.input.h2d": 30e-9, "wire.place": 20e-9,
                          "outside": 5e-9}
    # gaps, by the span open at their middle: [0, 140] and [965, 1000]
    # outside; [170, 230] the step; [260, 320] its forward; [330, 510],
    # [520, 620] and [640, 820] local_train, with no step open; [840,
    # 960] the placement
    assert dict(r["idle_gaps"]) == pytest.approx({
        "outside": 175e-9, "client.step": 60e-9,
        "client.step.forward": 60e-9, "client.local_train": 460e-9,
        "wire.place": 120e-9}, rel=1e-9, abs=0)
    assert r["traced_s"] == 1e-6


def test_reduce_needs_the_traced_span():
    with pytest.raises(RuntimeError, match="no traced span"):
        reduce_events(TRACE[1:])


def obs_cell():
    spec = importlib.util.spec_from_file_location(
        "obs_cell", REPO / "scripts" / "obs_cell.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "fl_bench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


SNAPSHOT = {"spans": {"round.sync": {"n": 2, "incl_s": 9.0, "excl_s": 0.03},
                      "runtime.event": {"n": 5, "incl_s": 1.0,
                                        "excl_s": 0.05},
                      "client.step": {"n": 8, "incl_s": 0.4,
                                      "excl_s": 0.4}},
            "counters": {"round.aggregations": 4}}


@pytest.mark.parametrize("name, value", [
    ("launches_per_step", 1.5),  # 3 launches over 2 steps
    ("h2d_ms", 30e-9 / 2 * 1e3),  # the batch's copy alone
    ("runtime_ms", 0.08 / 4 * 1e3),  # exclusive s per aggregation
])
def test_program_metric_readers(name, value):
    """Each reader's value on the hand-made trace and snapshot, and
    nothing where what it reads is missing: off the card for the two
    device metrics, and with the tracer off."""
    read = reader(name)
    run = types.SimpleNamespace(program=SNAPSHOT, card={"name": "H100"},
                                program_trace=reduce_events(TRACE))
    assert read(run) == pytest.approx(value, rel=1e-12)
    off = types.SimpleNamespace(program=None, card=None, program_trace=None)
    assert read(off) is None
    off_card = types.SimpleNamespace(program=SNAPSHOT, card=None,
                                     program_trace=reduce_events(TRACE))
    assert (read(off_card) is None) == (name != "runtime_ms")


@pytest.mark.parametrize("trace", [True, False])
def test_program_metrics_through_the_hooks(bench_root, trace, monkeypatch):
    """Traced, the run reads ``runtime_ms`` and leaves the two device
    metrics out off the card; untraced, the tracer is never enabled and
    the result's metrics are the harness's own."""
    import time

    from fl_bench import cell, harness
    from repro_torch import obs
    if not trace:
        monkeypatch.setattr(obs, "enable", lambda: pytest.fail("enabled"))
    mod = obs_cell()
    c = mod.with_metrics(cell.resolve(bench_root, "tiny.fedbuff"))
    with mod.hooks() as views:
        out = harness.run(c, seed=2 ** 31 + 11, seconds=0.5, trace=trace,
                          device="cpu", t0=time.perf_counter())
    assert out["correct"] and not obs.enabled()
    assert harness.Window.open.__name__ == "open"  # the hooks are gone
    if trace:
        assert out["metrics"]["runtime_ms"]["value"] > 0
        assert not {"launches_per_step", "h2d_ms"} & set(out["metrics"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert views[-1].program["spans"]["runtime.event"]["excl_s"] > 0
        assert views[-1].program_trace["idle_gaps"]
    else:
        assert views[-1].program is None
        assert set(out["metrics"]) == set(run_cell(bench_root,
                                                   "tiny.fedbuff")["metrics"])


def test_obs_cell_runs_the_benchmarks_main(monkeypatch, capsys):
    """``main`` is ``fl_bench/run.py``'s: without a card it resolves the
    cell, with the three metrics and inside the hooks, says so and exits
    3; then the harness and the resolver are as they were."""
    import torch

    from fl_bench import cell, harness
    for var in ("OMP_NUM_THREADS", "TORCH_EXTENSIONS_DIR",
                "TRITON_CACHE_DIR"):
        monkeypatch.setenv(var, os.environ.get(var, ""))
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    threads = torch.get_num_threads()
    resolve, window_open = cell.resolve, harness.Window.open
    mod = obs_cell()
    seen = {}

    def with_metrics(c):
        seen["hooked"] = harness.Window.open is not window_open
        seen["cell"] = mod_with_metrics(c)
        return seen["cell"]
    mod_with_metrics, mod.with_metrics = mod.with_metrics, with_metrics
    try:
        rc = mod.main(["--workload", "resnet56.sync.geo7", "--seed", "7",
                       "--seconds", "1", "--trace", "1"])
    finally:
        torch.set_num_threads(threads)
    assert rc == 3 and "needs 1 CUDA card" in capsys.readouterr().err
    assert seen["hooked"]
    assert {"launches_per_step", "h2d_ms", "runtime_ms"} <= \
        set(seen["cell"].readers)
    assert cell.resolve is resolve and harness.Window.open is window_open
