"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""
import json
import re
import pytest

from conftest import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["fl_bench"]
    assert SPEC["command"] == ["python3", "fl_bench/run.py"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_and_units():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in SPEC[key]]
    assert all(NAME.match(n) for n in names), names
    for key in ("configs", "workloads"):
        assert len({x["name"] for x in SPEC[key]}) == len(SPEC[key])
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert {"setup_s", "round_s", "update_p95_ms"} <= set(e2e)
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


def test_per_layer_metrics_move_round_s():
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] == "round_s"
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m["workloads"]) <= cells
        assert (REPO / "fl_bench" / "metrics" / f"{m['name']}.py").is_file()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs_are_used_and_hold_their_sizes():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("fl_bench/configs/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and c["reduced"] == []


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_workload_resolves_by_name(workload):
    from fl_bench import cell
    c = cell.resolve(REPO, workload)
    assert c.chips == 1
    from fl_bench.check import NUMBERS
    assert {"first_loss_gap", "loss_gap", "served_model_gap"} <= \
        set(c.limits) <= set(NUMBERS)
    for name, lim in c.limits.items():
        assert lim["lower"] < lim["limit"] < lim["upper"], name
    assert {m["name"] for m in c.per_layer} == set(c.readers)
    tail = [] if "fedbuff" in workload else ["update_p95_ms"]
    assert [m["name"] for m in c.end_to_end] == ["round_s", *tail, "setup_s"]
    assert c.traffic["batch_size"] > 0 and c.config["family"] in (
        "resnet", "mobilenetv3")
