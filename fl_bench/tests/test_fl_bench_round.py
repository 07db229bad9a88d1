"""The harness on the CPU at small sizes: the reference agrees with the
port on a round, a cell added as new files and entries runs, the traced
run reads its per-layer metrics, and the control and each planted fault
come out not correct."""
import hashlib
import json
import math
from pathlib import Path

import pytest
import torch

from conftest import REPO, run_cell


@pytest.mark.parametrize("name", ["tiny.sync", "tiny.fedbuff", "tiny.mnv3"])
def test_reference_agrees_with_the_port(bench_root, name):
    out = run_cell(bench_root, name)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    # the buffered async cell reports its update tail per layer
    tail = set() if name == "tiny.fedbuff" else {"update_p95_ms"}
    assert set(out["metrics"]) == {"setup_s", "round_s"} | tail
    assert out["attempted"] > 0 and out["failed"] == 0


def test_traced_run_reads_per_layer_metrics(bench_root):
    out = run_cell(bench_root, "tiny.fedbuff", trace=True)
    assert out["correct"]
    # host spans; the device metrics are left out off the card
    assert {"train_step_ms", "input_ms", "aggregate_ms", "wire_ms",
            "codec_ms", "update_p95_ms.fedbuff"} <= set(out["metrics"])
    assert not {"roofline.fedavg", "mfu.round", "device_idle"} & set(
        out["metrics"])
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_and_metric_as_new_files(bench_root):
    """A configuration, a traffic mix, a per-layer metric and a cell added
    as new files and new entries run, and no file that was there
    changed."""
    from conftest import add_cell
    before = digest(REPO / "fl_bench")
    add_cell(bench_root, "tiny.sync.b2", "resnet-tiny",
             "sync.geo7.32px.b128", dict(num_clients=3))
    (bench_root / "fl_bench" / "metrics" / "steps_per_round.py").write_text(
        "def read(run):\n"
        "    n = run.counts.get('aggregations', 0)\n"
        "    return run.counts.get('train_steps', 0) / n if n else None\n")
    spec = json.loads((bench_root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "steps_per_round", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "client", "moves": "round_s",
                              "workloads": ["tiny.sync.b2"]})
    (bench_root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = run_cell(bench_root, "tiny.sync.b2", trace=True)
    assert out["correct"]
    # 3 silos, quorum 0.7 of 3 = 3 updates, 2 local steps each
    assert out["metrics"]["steps_per_round"]["value"] == 6
    assert digest(REPO / "fl_bench") == before


def test_p95_is_nearest_rank():
    from fl_bench.harness import p95
    xs = list(range(1, 201))
    assert p95(xs) == 190 and p95([5.0]) == 5.0


@pytest.mark.parametrize("name", ["tiny.sync", "tiny.fedbuff", "tiny.mnv3"])
def test_control_is_not_correct(bench_root, name):
    """The reference in bfloat16 in the program's place fails a limit."""
    from fl_bench import cell, check, harness
    torch.set_num_threads(2)
    c = cell.resolve(bench_root, name)
    values = harness.readings(c, 2 ** 31 + 11, "cpu", control=True)
    assert not check.verdict(values, c.limits)[0], values


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered",
                                   "norms_frozen", "stale"])
@pytest.mark.parametrize("name", ["tiny.sync", "tiny.fedbuff"])
def test_planted_fault_is_not_correct(bench_root, name, fault):
    from fl_bench import faults
    with faults.FAULTS[fault]():
        out = run_cell(bench_root, name)
    assert not out["correct"], out["checks"]


def test_flop_count_counts_depthwise_gradients_once():
    """A depthwise conv's input and weight gradients each cost its
    forward, 2 x outputs x the weight's elements."""
    from fl_bench import counts
    from torch.utils.flop_counter import FlopCounterMode
    w = torch.empty((96, 1, 3, 3), device="meta", requires_grad=True)
    x = torch.empty((2, 96, 16, 16), device="meta", requires_grad=True)
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: counts.conv_backward_flops})
    with counter:
        torch.nn.functional.conv2d(x, w, groups=96, padding=1).sum() \
            .backward()
    fwd = 2 * 2 * 16 * 16 * 96 * 9
    assert counter.get_total_flops() == 3 * fwd


@pytest.mark.parametrize("config,flops", [("resnet56-small", 96470581248),
                                          ("mobilenetv3-medium", 81034309632)])
def test_step_flops_of_the_configurations(config, flops):
    from fl_bench import counts
    from fl_bench.reference import fl
    cfg = json.loads((REPO / "fl_bench" / "configs" / f"{config}.json")
                     .read_text())
    fam = fl.model_module(cfg["family"])
    batch, size = (128, 32) if config.startswith("resnet") else (64, 224)
    assert counts.step_flops(fam, cfg, fam.param_specs(cfg), batch,
                             size) == flops


@pytest.mark.parametrize("config", ["resnet56-small", "mobilenetv3-medium"])
def test_reference_tree_is_the_ports(config):
    """The weights the benchmark draws fit the port's model leaf for leaf,
    at the published widths."""
    from fl_bench import harness
    from fl_bench.reference import fl, tree
    from repro_torch import _tree
    cfg = json.loads((REPO / "fl_bench" / "configs" / f"{config}.json")
                     .read_text())
    specs = fl.model_module(cfg["family"]).param_specs(cfg)
    port = harness.port_model(cfg, "cpu").init(torch.Generator()
                                               .manual_seed(0))
    assert [tuple(l.shape) for l in _tree.leaves(port)] == \
        [tuple(s[1]) for s in tree.leaves(specs)]
    assert sum(math.prod(s[1]) for s in tree.leaves(specs)) == \
        cfg["parameters"]


def test_codec_bytes():
    from fl_bench import counts
    q = torch.zeros((8, 256), dtype=torch.int8)
    assert counts.dequantize_bytes((q, None, [(0, 8, 2000)]), None) == \
        2000 + 4 * 8 + 4 * 2000
    assert counts.quantize_bytes(([torch.zeros(2000)], 256), None) == \
        4 * 2000 + 2000 + 4 * 8
    out = [{"idx": torch.zeros(100, dtype=torch.int32),
            "vals": torch.zeros(100)}]
    assert counts.topk_bytes(([torch.zeros(2000)],), out) == 8000 + 800


@pytest.mark.cuda
def test_control_fails_at_the_cells_size():
    """On the card, at each cell's own size and limits: the bfloat16
    control fails one of the cell's numbers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from fl_bench import cell, check, harness
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        c = cell.resolve(REPO, w["name"])
        values = harness.readings(c, 2 ** 31 + 17, "cuda", control=True)
        assert not check.verdict(values, c.limits)[0], (w["name"], values)
