"""The dry run (``launch/dryrun.py``, ``roofline/``), port against the JAX
reference on the CPU.

The reference's ``run_cell`` compiles each cell with XLA on 512
placeholder host devices. Under jax 0.9.0 it runs only on meshes whose
axes are ``AxisType.Auto`` (ROADMAP C), so one subprocess runs it that
way on seven cells and returns their records. The port's records are held
against them:

- the same ``status`` and ``reason`` (a skipped cell's reason verbatim);
- ``model_flops`` at rel 1e-12;
- per-device argument and output bytes to the byte, from the sharding
  plan (``roofline/cost.memory_bytes``);
- the int8 FL round's DCN bytes to the byte;
- the per-device FLOPs that ``FlopCounterMode`` counts on ``meta``
  tensors within FLOP_BAND of XLA's count, on the decode cells, the ones
  traced here (a training cell takes ~100 s to trace on this CPU; PERF.md
  records every cell's ratio), but xLSTM's (IN_BAND).

Beside them: the copied ``hlo_cost`` helpers against the reference's, the
production meshes, ``Sharder`` on them, and the CLI's record rendered by
``scripts/render_tables.py``.

Run as a script, it prints PERF.md's sweep table: for every record under
a port dry run's output directory, the reference's ``run_cell`` on the
same cell, each side's status, per-device argument bytes ("=" when the
argument and output bytes both equal the reference's), the port's FLOPs
over XLA's, the DCN bytes and the port's seconds (``--fl-int8`` adds
qwen3-8b's int8 FL round, which the CLI cannot ask for):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out D
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod --out D
    PYTHONPATH=src python tests/test_torch_dryrun.py D [--fl-int8]
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

if __name__ == "__main__":  # the sweep table: 512 host devices, before jax
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs.base import MULTI_POD_MESH as JMULTI  # noqa: E402
from repro.configs.base import SINGLE_POD_MESH as JSINGLE  # noqa: E402
from repro.roofline import hlo_cost as jcost  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import (MULTI_POD_MESH,  # noqa: E402
                                      SINGLE_POD_MESH, ShapeConfig,
                                      TrainConfig)
from repro_torch.configs.shapes import SHAPES, applicability  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_production_mesh,  # noqa: E402
                                     mesh_config_for)
from repro_torch.launch.step_builders import bundle_for  # noqa: E402
from repro_torch.roofline import cost  # noqa: E402
from repro_torch.roofline import hlo_cost as tcost  # noqa: E402
from repro_torch.roofline.analysis import model_flops_for  # noqa: E402
from repro_torch.sharding import MeshPlan, Sharder  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the port's per-device FLOPs over XLA's: FlopCounterMode counts matmuls,
# convolutions and attention, XLA every operation (PERF.md's sweep)
FLOP_BAND = (0.95, 1.0)
# (arch, shape, multi_pod, fl, fl_compress)
CELLS = [("granite-moe-1b-a400m", "decode_32k", False, False, ""),
         ("qwen3-8b", "train_4k", False, False, ""),
         ("qwen3-8b", "train_4k", True, True, "int8"),
         ("qwen3-8b", "long_500k", False, False, ""),
         # XLA drops the arguments these steps never read: xLSTM's decode
         # position, Zamba2's shared-block LoRA, the VLM's cross-attention
         # weights (its decode reads the cross cache)
         ("xlstm-1.3b", "decode_32k", False, False, ""),
         ("zamba2-1.2b", "decode_32k", True, False, ""),
         ("llama-3.2-vision-11b", "decode_32k", False, False, "")]
TRACED = {("granite-moe-1b-a400m", "decode_32k"), ("xlstm-1.3b", "decode_32k"),
          ("zamba2-1.2b", "decode_32k"),
          ("llama-3.2-vision-11b", "decode_32k")}
# FlopCounterMode counts matmul-class operations only: xLSTM's decode
# step is mostly elementwise state updates (0.729 of XLA's count, PERF.md)
IN_BAND = TRACED - {("xlstm-1.3b", "decode_32k")}
REF_SCRIPT = """
import json, sys
import jax
from jax.sharding import AxisType
from repro.configs.base import MULTI_POD_MESH, SINGLE_POD_MESH
from repro.launch import dryrun
out = []
for arch, shape, multi, fl, comp in json.loads(sys.argv[1]):
    mc = MULTI_POD_MESH if multi else SINGLE_POD_MESH
    mesh = jax.make_mesh(mc.shape, mc.axis_names,
                         axis_types=(AxisType.Auto,) * len(mc.shape))
    out.append(dryrun.run_cell(arch, shape, multi_pod=multi, fl=fl,
                               fl_compress=comp, mesh=mesh, mesh_cfg=mc,
                               out_dir=sys.argv[2], verbose=False))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_records(tmp_path_factory):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=str(ROOT / "src"))
    out = tmp_path_factory.mktemp("ref_dryrun")
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, json.dumps(CELLS), str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    recs = json.loads(proc.stdout.strip().splitlines()[-1])
    return {(r["arch"], r["shape"], r["fl"]): r for r in recs}


def port_record(cell, out_dir):
    """The port's record of ``cell``; the bytes alone (no trace) on the
    cells outside TRACED."""
    arch, shape_name, multi, fl, comp = cell
    cfg, shape = get_config(arch), SHAPES[shape_name]
    if (arch, shape_name) in TRACED or not applicability(cfg, shape)[0]:
        return dryrun.run_cell(arch, shape_name, multi_pod=multi, fl=fl,
                               fl_compress=comp, out_dir=str(out_dir),
                               verbose=False)
    mesh_cfg = MULTI_POD_MESH if multi else SINGLE_POD_MESH
    tkw = dict(dryrun.TRAIN_OVERRIDES[arch])
    if comp:
        tkw["crosspod_compression"] = comp
    tcfg = TrainConfig(**tkw)
    kind = "fl_round" if fl else shape.kind
    bundle = bundle_for(kind, cfg, shape, make_production_mesh(
        multi_pod=multi), mesh_cfg, tcfg, **({"local_steps": 2} if fl else {}))
    return {"status": "ok", "kind": kind,
            "memory_analysis": cost.memory_bytes(bundle, kind, cfg, shape,
                                                 mesh_cfg),
            "roofline": dict(cost.collective_bytes(
                bundle, kind, mesh_cfg, local_steps=2,
                compression=tcfg.crosspod_compression),
                model_flops=model_flops_for(cfg, shape) * (2 if fl else 1))}


@pytest.mark.parametrize("cell", CELLS, ids=["__".join(map(str, c[:2]))
                                              + ("__fl" if c[3] else "")
                                              for c in CELLS])
def test_record_matches_reference(cell, ref_records, tmp_path):
    arch, shape_name, multi, fl, comp = cell
    want = ref_records[(arch, shape_name, fl)]
    got = port_record(cell, tmp_path)
    assert got["status"] == want["status"]
    if want["status"] == "skipped":
        assert got["reason"] == want["reason"]
        return
    assert got["kind"] == want["kind"]
    rl, wrl = got["roofline"], want["roofline"]
    assert rl["model_flops"] == pytest.approx(wrl["model_flops"], rel=1e-12)
    for k in ("argument_bytes", "output_bytes"):
        assert got["memory_analysis"][k] == want["memory_analysis"][k], k
    if fl:
        assert rl["coll_dcn_bytes"] == wrl["coll_dcn_bytes"] == 32_302_140
    if (arch, shape_name) in IN_BAND:
        ratio = rl["flops"] / wrl["hlo_flops"]
        assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], ratio


# -- the copied hlo_cost helpers ---------------------------------------------

@pytest.mark.parametrize("op", ["all-reduce", "all-gather", "reduce-scatter",
                                "all-to-all", "collective-permute",
                                "all-reduce-start", "dot"])
@pytest.mark.parametrize("group", [1, 2, 4, 16])
def test_collective_formulas_match_reference(op, group):
    for result, operand in ((1000, 1000), (1600, 400), (400, 1600)):
        assert tcost.collective_effective_bytes(op, result, operand, group) \
            == jcost.collective_effective_bytes(op, result, operand, group)


@pytest.mark.parametrize("attrs", [
    "replica_groups={{0,1},{2,3}}",
    "replica_groups=[4,2]<=[2,4]T(1,0), attr=1",
    "replica_groups=[2,256]<=[512]",
    "replica_groups=[32,16]<=[2,16,16]T(0,2,1)",
    "replica_groups=[8,2]",
    "channel_id=3"])
def test_replica_groups_match_reference(attrs):
    got, want = (m.parse_replica_groups(attrs) for m in (tcost, jcost))
    assert got == want
    for pod in (2, 4, 256):
        assert tcost.crosses_pod(got[1], pod) == jcost.crosses_pod(want[1], pod)


@pytest.mark.parametrize("flops,hbm", [(0.0, 0.0), (1e9, 1e6), (3e8, 1e6),
                                       (2.5e8, 1e6), (1.0, 1e9)])
def test_intensity_matches_reference(flops, hbm):
    got = tcost.Cost(flops=flops, hbm_bytes=hbm)
    want = jcost.Cost(flops=flops, hbm_bytes=hbm)
    assert tcost.arithmetic_intensity(got) == jcost.arithmetic_intensity(want)
    for balance in (100.0, 295.0, 1000.0):
        assert tcost.is_bandwidth_bound(got, balance=balance) == \
            jcost.is_bandwidth_bound(want, balance=balance)
    # the H100 SXM's balance (989.4 TFLOP/s over 3.35 TB/s)
    assert tcost.MACHINE_BALANCE_FLOPS_PER_BYTE == pytest.approx(295.34,
                                                                 rel=1e-4)
    assert (got + got).flops == (want + want).flops
    assert got.scale(3).hbm_bytes == want.scale(3).hbm_bytes


# -- the production meshes -----------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh(multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    want = JMULTI if multi_pod else JSINGLE
    assert mesh.shape == tuple(want.shape)
    assert mesh.axis_names == tuple(want.axis_names)
    assert mesh.device == torch.device("meta")
    assert mesh_config_for(mesh) == (MULTI_POD_MESH if multi_pod
                                     else SINGLE_POD_MESH)
    # abstract: the sharder is the identity there, and a bundle builds
    x = torch.empty(4, 8, device="meta")
    cfg = MULTI_POD_MESH if multi_pod else SINGLE_POD_MESH
    assert Sharder(MeshPlan(cfg), mesh)(x, ("batch", None)) is x
    b = bundle_for("train", get_config("qwen3-8b"), SHAPES["train_4k"], mesh,
                   cfg)
    assert all(l.device.type == "meta" for l in
               jax.tree.leaves(b.in_specs, is_leaf=torch.is_tensor))
    # a real device of that size, with no DeviceMesh over ranks, raises
    real = Mesh(mesh.axis_names, mesh.shape, torch.device("cpu"))
    with pytest.raises(ValueError, match="no DeviceMesh"):
        Sharder(MeshPlan(cfg), real)(torch.ones(4, 8), ("batch", None))


# -- the CLI and the renderer ------------------------------------------------

def test_cli_record_renders(tmp_path, monkeypatch, capsys):
    out = tmp_path / "artifacts" / "dryrun"
    for arch, shape in (("granite-moe-1b-a400m", "decode_32k"),
                        ("qwen3-8b", "long_500k")):
        assert dryrun.main(["--arch", arch, "--shape", shape, "--out",
                            str(out)]) == 0
    assert "1 ok, 0 skipped" in capsys.readouterr().out
    rec = json.loads((out / "pod16x16" /
                      "granite-moe-1b-a400m__decode_32k.json").read_text())
    assert rec["memory_analysis"]["temp_bytes_source"].startswith("estimate")
    spec = importlib.util.spec_from_file_location(
        "render_tables", ROOT / "scripts" / "render_tables.py")
    render = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(render)
    monkeypatch.chdir(tmp_path)
    assert len(render.load("pod16x16")) == 2
    dry = render.dryrun_table("pod16x16")
    assert "| granite-moe-1b-a400m | decode_32k | ok | decode | 0.77 |" in dry
    assert "| qwen3-8b | long_500k | SKIP |" in dry
    roof = render.roofline_table("pod16x16")
    assert "| granite-moe-1b-a400m | decode_32k |" in roof
    assert rec["roofline"]["dominant"] in roof


def test_cli_needs_a_cell():
    with pytest.raises(SystemExit):
        dryrun.main([])


def test_decode_step_takes_a_host_position():
    """The decode cells' ``pos`` spec is a ``meta`` scalar, which the
    models read with ``int``; the dry run passes ``seq_len - 1``."""
    cfg, shape = get_config("zamba2-1.2b"), ShapeConfig("d", 64, 8, "decode")
    b = bundle_for("decode", cfg, shape, make_production_mesh(),
                   SINGLE_POD_MESH)
    with pytest.raises(RuntimeError, match="meta"):
        b.fn(*b.in_specs)
    assert cost.step_args(b, "decode", shape)[2]["pos"] == 63
    assert cost.count_flops(b, "decode", shape, 256)["flops"] > 0


# -- the sweep table (run as a script) -----------------------------------------

def sweep_row(rec, out_dir):
    """One markdown row: the port's record against the reference's
    ``run_cell`` on the same cell, on an Auto mesh."""
    from jax.sharding import AxisType
    from repro.configs.base import MULTI_POD_MESH as JMULTI_MESH
    from repro.configs.base import SINGLE_POD_MESH as JSINGLE_MESH
    from repro.launch import dryrun as jdryrun
    multi = rec["mesh"] == "pod2x16x16"
    mc = JMULTI_MESH if multi else JSINGLE_MESH
    mesh = jax.make_mesh(mc.shape, mc.axis_names,
                         axis_types=(AxisType.Auto,) * len(mc.shape))
    ref = jdryrun.run_cell(rec["arch"], rec["shape"], multi_pod=multi,
                           fl=rec["fl"], fl_compress=rec["fl_compress"],
                           mesh=mesh, mesh_cfg=mc, out_dir=out_dir,
                           verbose=False)
    jax.clear_caches()
    cell = (f"{rec['arch']} {rec['shape']}"
            f"{' fl ' + (rec['fl_compress'] or 'f32') if rec['fl'] else ''}")
    if rec["status"] != "ok" or ref["status"] != "ok":
        reason = "=" if rec.get("reason") == ref.get("reason") else "≠"
        return (f"| {cell} | {rec['mesh']} | {rec['status']} / "
                f"{ref['status']} (reason {reason}) | — | — | — | — |")
    rl, jrl = rec["roofline"], ref["roofline"]
    mem, jmem = rec["memory_analysis"], ref["memory_analysis"]
    same = "=" if all(mem[k] == jmem[k] for k in
                      ("argument_bytes", "output_bytes")) else "≠"
    return (f"| {cell} | {rec['mesh']} | ok / ok | {mem['argument_bytes']:,} "
            f"{same} {jmem['argument_bytes']:,} | "
            f"{rl['flops'] / jrl['hlo_flops']:.4f} | "
            f"{rl['coll_dcn_bytes']:,.0f} / {jrl['coll_dcn_bytes']:,.0f} | "
            f"{rec['compile_s']} |")


def sweep_table(argv=None):
    import argparse
    import tempfile
    ap = argparse.ArgumentParser()
    ap.add_argument("port_dir")
    ap.add_argument("--fl-int8", action="store_true")
    args = ap.parse_args(argv)
    recs = [json.loads(p.read_text()) for p in
            sorted(Path(args.port_dir).glob("*/*.json"))]
    if args.fl_int8:
        recs.append(dryrun.run_cell("qwen3-8b", "train_4k", multi_pod=True,
                                    fl=True, fl_compress="int8",
                                    out_dir=args.port_dir,
                                    tag_suffix="__int8", verbose=False))
    print("| cell | mesh | status port / ref | argument bytes a device, "
          "port / ref | FLOPs port / ref | DCN bytes a device, port / ref "
          "| port s |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    with tempfile.TemporaryDirectory() as tmp:
        for rec in recs:
            print(sweep_row(rec, tmp), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(sweep_table())
