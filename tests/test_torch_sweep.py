"""The port's sweep layer and multi-tenant runner against the JAX
reference, on the CPU.

* ``run_scenario``: a sync, a fedbuff and a vertical scenario,
  ``examples/scenarios/vertical_geo.json`` as written, and the twin of
  ``test_chunk_loss_retransmit_completes_every_batch``
  (``tests/test_vertical.py``) give the reference's output dict exactly
  (virtual payloads: no device, no measured time);
* ``Sweep`` expands the repo's sweep file, and a seeded random search, to
  the reference's cells and fingerprints;
* ``Engine`` / ``RunStore``: a re-run replays every cell from the store,
  and the two packages read each other's stores;
* ``run_multi(multitenant_pair.json)`` gives the reference's output
  exactly;
* ``python -m repro_torch.sweep``, ``fl_train --sweep`` and
  ``fl_train --multi`` on small files.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

import repro.scenario as jscn  # noqa: E402
import repro.sweep as jsweep  # noqa: E402
from repro.sweep.runners import run_multi as jrun_multi  # noqa: E402
from repro.sweep.runners import run_scenario as jrun_scenario  # noqa: E402
import repro_torch.scenario as tscn  # noqa: E402
import repro_torch.sweep as tsweep  # noqa: E402
from repro_torch.launch import fl_train  # noqa: E402
from repro_torch.sweep.__main__ import main as sweep_main  # noqa: E402
from repro_torch.sweep.runners import run_multi, run_scenario  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCENARIOS = ROOT / "examples" / "scenarios"

CASES = {
    "sync": {"name": "sync", "topology": {"kind": "geo_distributed",
                                          "num_clients": 3},
             "channel": {"backend": "grpc+s3"},
             "strategy": {"mode": "sync", "rounds": 2}},
    "fedbuff": {"name": "fedbuff", "topology": {"kind": "geo_distributed",
                                                "num_clients": 4},
                "fleet": {"tier": "medium"},
                "channel": {"backend": "grpc", "compression": "qsgd"},
                "faults": {"availability_trace": "client2:leave@40,join@90"},
                "strategy": {"mode": "fedbuff", "rounds": 3,
                             "buffer_k": 2}},
    "vertical": {"name": "vertical", "topology": {"kind": "geo_proximal",
                                                  "num_clients": 3},
                 "channel": {"backend": "auto"},
                 "strategy": {"mode": "vertical", "rounds": 2},
                 "split": {"cut_layer": 2, "batches_per_round": 3,
                           "activation_codec": "topk:0.1"}},
    # tests/test_vertical.py::test_chunk_loss_retransmit_completes_every_batch
    "vertical chunk loss": {"name": "vert-loss",
                            "topology": {"kind": "geo_distributed",
                                         "num_clients": 3},
                            "fleet": {"tier": "small"},
                            "channel": {"backend": "grpc", "chunk_mb": 0.05},
                            "faults": {"link_loss": 0.05},
                            "strategy": {"mode": "vertical", "rounds": 2},
                            "split": {"cut_layer": 1,
                                      "batches_per_round": 4}},
    "vertical_geo.json": str(SCENARIOS / "vertical_geo.json"),
}


def _scenario(pkg, spec):
    if isinstance(spec, str):
        return pkg.Scenario.load(spec)
    return pkg.Scenario.from_dict(spec)


@pytest.mark.parametrize("case", list(CASES))
def test_run_scenario_matches_reference(case):
    sc = _scenario(tscn, CASES[case])
    got = run_scenario(sc)
    want = jrun_scenario(_scenario(jscn, CASES[case]))
    assert got == want
    assert got["n_rounds"] == sc.strategy.rounds
    if case == "vertical chunk loss":
        # lossy chunked activation wires retransmitted, and every batch
        # of every round still completed
        assert got["retransmits"] > 0
        assert got["n_discarded"] == 0
        assert [r["n_updates"] for r in got["round_reports"]] == [3, 3]
    if case == "vertical_geo.json":
        assert got["retransmits"] > 0 and got["n_discarded"] == 0
        # every activation and gradient routes below AUTO's 10 MB knee
        assert got["auto_decisions"] and all(
            k.endswith(":grpc") for k in got["auto_decisions"]
            if k.split(":")[0] in ("activation", "grad"))


@pytest.mark.parametrize("source", ["sweep_decision_guide.json",
                                    "random search"])
def test_sweep_expands_like_reference(source):
    if source == "random search":
        spec = {"name": "rs", "base": {"name": "rs"},
                "axes": [{"field": "channel.backend",
                          "values": ["grpc", "grpc+s3", "auto"]},
                         {"field": "channel.chunk_mb", "lo": 0, "hi": 8,
                          "steps": 5},
                         {"field": "params.n", "values": [1, 2, 3]}],
                "samples": 7, "seed": 3}
        tsw, jsw = (pkg.Sweep.from_dict(spec) for pkg in (tsweep, jsweep))
    else:
        path = str(SCENARIOS / source)
        tsw, jsw = tsweep.Sweep.load(path), jsweep.Sweep.load(path)
    assert tsw.to_json() == jsw.to_json()
    tcells, jcells = tsw.expand(), jsw.expand()
    assert len(tcells) == len(jcells) == (12 if "json" in source else 7)
    for t, j in zip(tcells, jcells):
        assert (t.index, t.label(), t.overrides, t.params) == \
            (j.index, j.label(), j.overrides, j.params)
        assert t.scenario.to_dict() == j.scenario.to_dict()
        assert tsweep.fingerprint(tsw.name, 1, t) == \
            jsweep.fingerprint(jsw.name, 1, j)


def test_engine_and_run_store_round_trip(tmp_path):
    sw = tsweep.Sweep(name="t", axes=(
        tsweep.Axis("params.n", values=(1, 2, 3)),))
    calls = []

    def cell(c):
        calls.append(c.index)
        return {"sim_time_s": float(c.index), "v": c.index,
                "trace": ((0.5, "ev"),)}
    study = tsweep.Study(name="t", sweeps=lambda quick: (sw,), cell=cell)
    eng = tsweep.Engine(str(tmp_path))
    rows = eng.run_study(study, verbose=False)
    assert len(calls) == 3 and eng.last_stats.n_ran == 3
    assert eng.run_study(study, verbose=False) == rows
    assert len(calls) == 3 and eng.last_stats.n_cached == 3
    # the store replays equal records, and the reference reads it
    path = tmp_path / "runstore" / "t.jsonl"
    store, jstore = tsweep.RunStore(str(path)), jsweep.RunStore(str(path))
    assert len(store) == len(jstore) == 3
    for c in sw.expand():
        fp = tsweep.fingerprint("t", 1, c)
        assert store.get(fp).to_dict() == jstore.get(fp).to_dict()
        assert store.get(fp).metrics["trace"] == [[0.5, "ev"]]


def test_run_multi_matches_reference():
    path = str(SCENARIOS / "multitenant_pair.json")
    got = run_multi(tscn.MultiScenario.load(path))
    want = jrun_multi(jscn.MultiScenario.load(path))
    assert got == want
    assert set(got["jobs"]) == {"prod", "experimental"}
    assert all(j["n_rounds"] == 5 for j in got["jobs"].values())


def _small_sweep(tmp_path):
    sweep = tsweep.Sweep(
        name="cli", base=tscn.Scenario(
            name="tiny", topology=tscn.TopologySpec(kind="lan",
                                                    num_clients=2),
            strategy=tscn.StrategySpec(mode="sync", rounds=1)),
        axes=(tsweep.Axis("channel.backend",
                          values=("grpc", "mpi_mem_buff")),))
    path = tmp_path / "sweep.json"
    path.write_text(sweep.to_json())
    return path


def test_sweep_cli_runs_file_and_caches(tmp_path, capsys):
    path = _small_sweep(tmp_path)
    report = tmp_path / "report.json"
    assert sweep_main([str(path), "--out-dir", str(tmp_path / "out"),
                       "--report", str(report)]) == 0
    assert [r["study"] for r in json.loads(report.read_text())] == \
        ["cli", "cli"]
    # the module entry point, in its own interpreter: replays the store
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.sweep", str(path),
         "--out-dir", str(tmp_path / "out")],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                       "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "2 cached" in proc.stdout
    assert sweep_main([str(tmp_path / "missing.json")]) == 2


def test_fl_train_sweep_and_multi_flags(tmp_path, capsys):
    path = _small_sweep(tmp_path)
    assert fl_train.main(["--sweep", str(path), "--sweep-out-dir",
                          str(tmp_path / "out")]) == 0
    assert "cli" in capsys.readouterr().out
    assert (tmp_path / "out" / "runstore" / "cli.jsonl").exists()
    assert fl_train.main(["--multi", str(SCENARIOS
                                         / "multitenant_pair.json")]) == 0
    out = capsys.readouterr().out
    assert "[multi] 'multitenant-pair': policy=priority" in out
    assert "prod: 5 aggregations" in out
