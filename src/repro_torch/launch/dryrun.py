"""Port of ``src/repro/launch/dryrun.py``: the multi-pod dry run. Every
(arch x shape x mesh) cell's step is built on the production meshes and
its memory, cost and roofline recorded, on H100 targets.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all                # single-pod 16x16
    python -m repro_torch.launch.dryrun --all --multi-pod    # 2x16x16
    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k \\
        --fl --multi-pod                                # cross-pod FL round

Artifacts: artifacts/dryrun_torch/<mesh>/<arch>__<shape>[__fl].json, with
the reference's record keys that ``scripts/render_tables.py`` reads.

The reference lowers and compiles each cell with XLA on 512 placeholder
devices. The port has no compiler to ask: the production meshes are
records on ``meta`` (``launch/mesh.make_production_mesh``), the bundle's
step runs once on ``meta`` tensors under a FLOP counter, and the bytes
come from the sharding plan (``roofline/cost.py``). Nothing runs on a
card. So a record differs from the reference's in these keys:

- ``compile_s`` is the seconds to build the bundle and count it;
- ``memory_analysis.temp_bytes`` is an estimate (autograd's bytes saved
  for backward, over the devices), named so by ``temp_bytes_source``;
  ``generated_code_bytes`` is left out;
- ``xla_cost_analysis`` becomes ``flop_count`` (the counter's global
  FLOPs);
- ``roofline`` has ``flops`` and ``bytes`` in place of ``hlo_flops`` and
  ``hlo_bytes``, and no ``hlo_walk_bytes``.
"""
import argparse
import dataclasses
import gc
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCH_ORDER, get_config
from repro_torch.configs.base import (MULTI_POD_MESH, SINGLE_POD_MESH,
                                      TrainConfig)
from repro_torch.configs.shapes import SHAPES, SHAPE_ORDER, applicability
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.step_builders import bundle_for
from repro_torch.roofline import cost
from repro_torch.roofline.analysis import analyze

OUT_DIR = "artifacts/dryrun_torch"
TEMP_BYTES_SOURCE = ("estimate: bytes autograd saves for backward outside "
                     "the remat regions, over the devices; not XLA's "
                     "temp_size_in_bytes")

# per-arch training knobs, as the reference's (microbatches and bf16
# moments shape each cell's bytes)
TRAIN_OVERRIDES = {
    "deepseek-67b": dict(microbatches=16),
    "llama4-maverick-400b-a17b": dict(microbatches=16,
                                      moment_dtype="bfloat16"),
    "stablelm-12b": dict(microbatches=8),
    "qwen3-8b": dict(microbatches=8),
    "granite-3-8b": dict(microbatches=8),
    "llama-3.2-vision-11b": dict(microbatches=8),
    "hubert-xlarge": dict(microbatches=4),
    "granite-moe-1b-a400m": dict(microbatches=4),
    "xlstm-1.3b": dict(microbatches=4),
    "zamba2-1.2b": dict(microbatches=4),
}


def count(bundle, kind: str, cfg, shape, mesh_cfg, train_cfg,
          fl_local_steps: int = 2) -> dict:
    """The cell's per-device counts: ``memory`` and ``collectives`` from
    the plan, ``flops`` (and the temp-bytes estimate, and the inputs a
    forward-only step never reads, which XLA drops from its arguments)
    from the step traced on ``meta``."""
    chips = mesh_cfg.num_devices
    traced = cost.count_flops(bundle, kind, shape, chips)
    memory = cost.memory_bytes(bundle, kind, cfg, shape, mesh_cfg,
                               traced["unread"])
    memory["temp_bytes"] = traced["temp_bytes_estimate"]
    return {"memory": memory, "flops": traced["flops"] / chips,
            "global_flops": traced["flops"],
            "collectives": cost.collective_bytes(
                bundle, kind, mesh_cfg, local_steps=fl_local_steps,
                compression=train_cfg.crosspod_compression)}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, fl: bool = False,
             out_dir: str = OUT_DIR, mesh=None, overrides=None,
             fl_compress: str = "", tag_suffix: str = "",
             mesh_cfg=None, mesh_label: str = "", train_kw=None,
             fl_local_steps: int = 2, verbose: bool = True):
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    ok, reason = applicability(cfg, shape)
    mesh_name = mesh_label or ("pod2x16x16" if multi_pod else "pod16x16")
    tag = f"{arch}__{shape_name}" + ("__fl" if fl else "") + tag_suffix
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "fl": fl,
              "fl_compress": fl_compress}
    if not ok:
        record.update(status="skipped", reason=reason)
        _persist(out_dir, mesh_name, tag, record, verbose)
        return record

    if mesh_cfg is None:
        mesh_cfg = MULTI_POD_MESH if multi_pod else SINGLE_POD_MESH
    if mesh is None:
        if tuple(mesh_cfg.shape) in ((16, 16), (2, 16, 16)):
            mesh = make_production_mesh(multi_pod=multi_pod)
        else:
            mesh = Mesh(tuple(mesh_cfg.axis_names), tuple(mesh_cfg.shape),
                        torch.device("meta"))
    tkw = dict(TRAIN_OVERRIDES.get(arch, {}))
    if train_kw:
        tkw.update(train_kw)
    if fl and fl_compress:
        tkw["crosspod_compression"] = fl_compress
    train_cfg = TrainConfig(**tkw)
    kind = "fl_round" if fl else (
        "train" if shape.kind == "train" else shape.kind)
    t0 = time.time()
    try:
        kw = {"local_steps": fl_local_steps} if fl else {}
        bundle = bundle_for(kind, cfg, shape, mesh, mesh_cfg, train_cfg, **kw)
        c = count(bundle, kind, cfg, shape, mesh_cfg, train_cfg,
                  fl_local_steps)
        mem = c["memory"]
        rl = analyze(flops=c["flops"], memory=mem,
                     collectives=c["collectives"], arch=arch, shape=shape,
                     kind=kind, mesh_name=mesh_name,
                     chips=mesh_cfg.num_devices, cfg=cfg)
        if fl:
            # an FL round performs local_steps optimizer steps per call
            rl.model_flops *= fl_local_steps
        record.update(
            status="ok", kind=kind,
            compile_s=round(time.time() - t0, 1),
            memory_analysis=dict(mem, temp_bytes_source=TEMP_BYTES_SOURCE),
            flop_count={"flops": c["global_flops"]},
            roofline=rl.to_dict(),
            train_overrides=tkw,
        )
        if verbose:
            print(f"[dryrun] {tag} @{mesh_name}: OK ({record['compile_s']}s)")
            print(f"  memory/device: args="
                  f"{mem['argument_bytes'] / 2**30:.2f}GiB "
                  f"temp(est)={mem['temp_bytes'] / 2**30:.2f}GiB")
            print(f"  roofline: compute={rl.t_compute*1e3:.2f}ms "
                  f"memory={rl.t_memory*1e3:.2f}ms "
                  f"collective={rl.t_collective*1e3:.2f}ms "
                  f"dcn={rl.t_dcn*1e3:.2f}ms -> {rl.dominant}-bound; "
                  f"useful-flops={rl.useful_flops_ratio:.2%} "
                  f"roofline-frac={rl.roofline_fraction:.2%}")
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug report
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:],
                      compile_s=round(time.time() - t0, 1))
        if verbose:
            print(f"[dryrun] {tag} @{mesh_name}: FAILED {record['error']}")
    _persist(out_dir, mesh_name, tag, record, verbose)
    return record


def _persist(out_dir, mesh_name, tag, record, verbose):
    d = os.path.join(out_dir, mesh_name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{tag}.json"), "w") as f:
        json.dump(record, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_ORDER)
    ap.add_argument("--shape", choices=SHAPE_ORDER)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fl", action="store_true",
                    help="count the cross-pod FL round instead of train_step")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    mesh = make_production_mesh(multi_pod=args.multi_pod)
    mesh_name = "pod2x16x16" if args.multi_pod else "pod16x16"
    if args.all:
        cells = [(arch, shape) for arch in ARCH_ORDER for shape in SHAPE_ORDER]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")

    results = []
    for arch, shape in cells:
        tag = f"{arch}__{shape}" + ("__fl" if args.fl else "")
        path = os.path.join(args.out, mesh_name, f"{tag}.json")
        if args.skip_existing and os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
            if rec.get("status") in ("ok", "skipped"):
                print(f"[dryrun] {tag}: cached ({rec['status']})")
                results.append(rec)
                continue
        results.append(run_cell(arch, shape, multi_pod=args.multi_pod,
                                fl=args.fl, out_dir=args.out, mesh=mesh))
        gc.collect()
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
