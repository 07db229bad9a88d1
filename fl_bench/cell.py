"""One cell of ``BENCHMARK.json`` and the files it names, found by name:
``configs/<config>.json`` (through the declaration's ``file``),
``traffic/<traffic>.json``, ``limits/<workload>.json`` and
``metrics/<metric>.py`` for each per-layer metric the cell reports. A
new cell, configuration, traffic mix or metric is new files and new
entries; no file here changes."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    readers: dict


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_reader(path: Path):
    """``read(run) -> float | None`` from a metric's own file."""
    spec = importlib.util.spec_from_file_location(
        "fl_bench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def resolve(root: Path, workload: str) -> Cell:
    bench_dir = root / "fl_bench"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload '{workload}' in BENCHMARK.json "
                       f"(there are: {', '.join(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    per_layer = [m for m in spec["per_layer"] if applies(m, workload)]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads(
            (bench_dir / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads(
            (bench_dir / "limits" / f"{workload}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if applies(m, workload)],
        per_layer=per_layer,
        readers={m["name"]: load_reader(bench_dir / "metrics"
                                        / f"{m['name']}.py")
                 for m in per_layer})
