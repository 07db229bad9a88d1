"""Helpers of the benchmark's CPU tests: a copy of the benchmark in a
temporary checkout, with small configurations and traffic mixes added as
new files and new entries, the way a later change adds a cell."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

# small sizes: every width cut, so a CPU round takes a fraction of a second
TINY_CONFIGS = {
    "resnet-tiny": ("resnet56-small.json",
                    dict(widths=[8, 16, 16], blocks_per_stage=1,
                         num_classes=10)),
    "mnv3-tiny": ("mobilenetv3-medium.json",
                  dict(blocks=[[1, 8, 1, False], [2, 8, 2, True],
                               [2, 8, 1, True]], stem=8, head=16,
                       classifier=16, num_classes=10)),
}
# name -> (config, traffic the mix starts from, its overrides)
TINY_CELLS = {
    "tiny.sync": ("resnet-tiny", "sync.geo7.32px.b128", dict(num_clients=4)),
    "tiny.fedbuff": ("resnet-tiny", "fedbuff.geo14-qsgd.32px.b128",
                     dict(num_clients=4, buffer_k=2)),
    "tiny.mnv3": ("mnv3-tiny", "sync.geo7.224px.b64", dict(num_clients=4)),
}
# Limits at these sizes, from CPU readings: the program reads 5e-8 to
# 2.1e-7 in the losses and up to 4.4e-5 in a leaf gap (f32 on both
# sides), the bfloat16 control 3.1e-7 to 3.1e-5 in the first loss, 1.3e-5
# to 7.3e-4 in the mean loss and 3.0e-3 to 9.4e-2 in a leaf gap (3 seeds
# of each cell); the served model reads 0, a stale one 1.1e-2 to 1.5e-2.
TINY_LIMITS = {"first_loss_gap": 2e-6, "loss_gap": 2e-6,
               "step1_leaf_gap": 1e-3, "step3_leaf_gap": 1e-3,
               "served_model_gap": 1e-5}


def add_cell(root: Path, name: str, config: str, traffic_from: str,
             overrides: dict) -> None:
    """Add one cell to the checkout at ``root`` as new files and a new
    entry of its BENCHMARK.json."""
    bench = root / "fl_bench"
    src_file, sizes = TINY_CONFIGS[config]
    cfg_path = bench / "configs" / f"{config}.json"
    if not cfg_path.exists():
        cfg = json.loads((bench / "configs" / src_file).read_text())
        cfg.update(name=config, **sizes)
        cfg_path.write_text(json.dumps(cfg))
    t = json.loads((bench / "traffic" / f"{traffic_from}.json").read_text())
    t.update(batch_size=16, image_size=32, examples_per_silo=48)
    t["scenario"]["topology"]["num_clients"] = overrides["num_clients"]
    t["scenario"]["fleet"]["local_steps"] = 2
    if "buffer_k" in overrides:
        t["scenario"]["strategy"]["buffer_k"] = overrides["buffer_k"]
    (bench / "traffic" / f"{name}.json").write_text(json.dumps(t))
    (bench / "limits" / f"{name}.json").write_text(json.dumps(
        {k: {"limit": v} for k, v in TINY_LIMITS.items()}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    if config not in {c["name"] for c in spec["configs"]}:
        spec["configs"].append({"name": config, "source": "test",
                                "file": f"fl_bench/configs/{config}.json",
                                "reduced": [], "why": "test"})
    spec["workloads"].append({"name": name, "config": config,
                              "traffic": name, "chips": 1, "why": "test"})
    # the small cell reports what the cells of the traffic it starts from
    # report
    kin = {w["name"] for w in spec["workloads"]
           if w["traffic"] == traffic_from}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and kin & set(m["workloads"]):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))


@pytest.fixture
def bench_root(tmp_path):
    """A checkout holding BENCHMARK.json and a copy of ``fl_bench/``, with
    the small cells added."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "fl_bench", tmp_path / "fl_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, (config, traffic, over) in TINY_CELLS.items():
        add_cell(tmp_path, name, config, traffic, over)
    return tmp_path


def run_cell(root: Path, name: str, seed: int = 2 ** 31 + 11, *,
             trace: bool = False, seconds: float = 0.5):
    import time

    import torch

    from fl_bench import cell, harness
    torch.set_num_threads(2)
    c = cell.resolve(root, name)
    return harness.run(c, seed=seed, seconds=seconds, trace=trace,
                       device="cpu", t0=time.perf_counter())
