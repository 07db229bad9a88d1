"""ViT-Large and the hospitals scenario in the benchmark, on the CPU at
small sizes: each new cell, added as new files and entries, agrees with
the reference through the harness, and the bfloat16 control and the
planted faults come out not correct; the reference's ViT-Large tree is
the port's, leaf for leaf; the model FLOPs of a ViT-Large step; the new
cells resolve by name; the wire's rate reader."""
import json
import math
import shutil
import types

import pytest
import torch

import conftest
from conftest import REPO, add_cell, run_cell

# a ViT at a small width: 2 layers, d_model 64, 4 heads, patch 8 at 32x32
conftest.TINY_CONFIGS.setdefault("vit-tiny", (
    "vit-large.json", dict(num_layers=2, d_model=64, num_heads=4, d_ff=128,
                           patch=8, image_size=32, num_classes=10)))
CELLS = {
    "tiny.vit": ("vit-tiny", "sync.geo3.224px.b32", dict(num_clients=3)),
    "tiny.semisync": ("mnv3-tiny", "semisync.hospitals3.224px.b64",
                      dict(num_clients=3)),
}
NEW_CELLS = ("vitl.sync.geo3", "mnv3.semisync.hospitals3")
SEED = 2 ** 31 + 11


@pytest.fixture
def vit_root(tmp_path):
    """A checkout holding BENCHMARK.json and a copy of ``fl_bench/``, with
    the two small cells added."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "fl_bench", tmp_path / "fl_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, (config, traffic, over) in CELLS.items():
        add_cell(tmp_path, name, config, traffic, over)
    return tmp_path


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_agrees_with_the_reference(vit_root, name):
    out = run_cell(vit_root, name, SEED)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"setup_s", "round_s"}
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_is_not_correct(vit_root, name):
    """The reference in bfloat16 in the program's place fails a limit."""
    from fl_bench import cell, check, harness
    torch.set_num_threads(2)
    c = cell.resolve(vit_root, name)
    values = harness.readings(c, SEED, "cpu", control=True)
    assert not check.verdict(values, c.limits)[0], values


def norm_scales_frozen():
    """Every local step leaves the norms' scales as it got them, stacked
    over layers or not (``norms_frozen`` reaches one-dimensional leaves
    only: in the ViT ``patch_b`` and the final norm, not the blocks'
    ``ln1`` and ``ln2``)."""
    from fl_bench import faults
    from fl_bench.reference.tree import items
    from repro_torch import _tree
    from repro_torch.launch import fl_train
    names = ("ln1", "ln2", "final_norm", "scale")

    def make(orig):
        def make_train_fn(model):
            step = orig(model)

            def train_fn(params, batch):
                new, loss = step(params, batch)
                old = [(p.rsplit("/", 1)[-1], l) for p, l in items(params)]
                out, treedef = _tree.flatten(new)
                kept = [o.clone() if name in names else n
                        for (name, o), n in zip(old, out)]
                return _tree.unflatten(treedef, kept), loss
            return train_fn
        return make_train_fn
    return faults._patched(fl_train, "make_train_fn", make)


# ``altered`` scales an update's largest leaf, which top-k at 5 % of the
# small MobileNetV3's 2,538 parameters drops whole: nothing it changes
# travels, so that pair is left to the cell's own size (PERF.md)
FAULT_CASES = [(name, fault) for name in sorted(CELLS)
               for fault in ("unchanged", "half_batch", "altered",
                             "norms_frozen", "stale", "norm_scales_frozen")
               if (name, fault) != ("tiny.semisync", "altered")]


@pytest.mark.parametrize("name, fault", FAULT_CASES)
def test_planted_fault_is_not_correct(vit_root, name, fault):
    """``norms_frozen`` freezes the one-dimensional leaves: in the ViT
    ``patch_b`` and the final norm's scale (the blocks' norm scales are
    stacked, two-dimensional), which ``norm_scales_frozen`` reaches."""
    from fl_bench import faults
    plant = norm_scales_frozen if fault == "norm_scales_frozen" \
        else faults.FAULTS[fault]
    with plant():
        out = run_cell(vit_root, name, SEED)
    assert not out["correct"], out["checks"]


def test_vit_large_tree_is_the_ports():
    """The weights the benchmark draws fit the port's ViT leaf for leaf,
    key for key, at the published widths (on the ``meta`` device)."""
    from fl_bench import harness
    from fl_bench.reference import fl, tree
    cfg = json.loads((REPO / "fl_bench" / "configs" / "vit-large.json")
                     .read_text())
    specs = fl.model_module(cfg["family"]).param_specs(cfg)
    port = harness.port_model(cfg, "meta").init(None)
    assert [(p, tuple(l.shape)) for p, l in tree.items(port)] == \
        [(p, tuple(s[1])) for p, s in tree.items(specs)]
    n = sum(math.prod(s[1]) for s in tree.leaves(specs))
    assert n == cfg["parameters"] == 303_236_096


def test_vit_large_step_flops():
    """Forward and backward of 32 images of 224x224: the matmuls of 196
    positions through 24 layers, attention's two products and the
    patch embedding."""
    from fl_bench import counts
    from fl_bench.reference import fl
    cfg = json.loads((REPO / "fl_bench" / "configs" / "vit-large.json")
                     .read_text())
    fam = fl.model_module(cfg["family"])
    assert counts.step_flops(fam, cfg, fam.param_specs(cfg), 32, 224) == \
        11_754_574_970_880


@pytest.mark.parametrize("workload", NEW_CELLS)
def test_new_cell_resolves_by_name(workload):
    from fl_bench import cell
    from fl_bench.check import NUMBERS
    c = cell.resolve(REPO, workload)
    assert c.chips == 1
    assert {"first_loss_gap", "loss_gap", "served_model_gap"} <= \
        set(c.limits) <= set(NUMBERS)
    for name, lim in c.limits.items():
        assert lim["lower"] < lim["limit"] < lim["upper"], name
        assert lim["lower_from"] and lim["upper_from"], name
    assert {m["name"] for m in c.per_layer} == set(c.readers)
    assert [m["name"] for m in c.end_to_end] == ["round_s", "setup_s"]
    assert c.config["family"] in ("vit", "mobilenetv3")


def test_wire_gbps_reader():
    """Bytes through the wire over the exclusive seconds of its serialize,
    deserialize and placement; nothing without the program's snapshot."""
    from fl_bench.cell import load_reader
    read = load_reader(REPO / "fl_bench" / "metrics" / "wire_gbps.py")
    snap = {"spans": {"wire.serialize": {"n": 2, "incl_s": 3.0,
                                         "excl_s": 1.0},
                      "wire.deserialize": {"n": 2, "incl_s": 1.5,
                                           "excl_s": 0.5},
                      "wire.place": {"n": 2, "incl_s": 0.5, "excl_s": 0.5},
                      "wire.decode": {"n": 2, "incl_s": 9.0,
                                      "excl_s": 7.0}},
            "counters": {"wire.bytes": 4e9}}
    assert read(types.SimpleNamespace(program=snap)) == \
        pytest.approx(2.0, rel=1e-12)
    assert read(types.SimpleNamespace(program=None)) is None
    assert read(types.SimpleNamespace(
        program={"spans": {}, "counters": {}})) is None
