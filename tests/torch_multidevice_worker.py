"""One rank of ``tests/test_torch_multidevice.py``'s process groups, on
the CPU over gloo. It imports nothing of JAX or the JAX package
(``tests/test_torch_isolation.py`` checks), so a spawned rank starts in
seconds and never starts XLA's thread pool beside its neighbours.

    python tests/torch_multidevice_worker.py SCENARIO RANK WORLD INIT_FILE DIR

``DIR`` holds the inputs the test wrote (``params.pt``, or
``params_{arch}.pt`` for the train scenario: the reference's initialised
smoke parameters in f32, converted; ``batches_{arch}.npz``) and receives
what the ranks found: rank 0 writes the gathered trees, every rank its own
``checks_{rank}.json``.

- ``pods``, 8 ranks on (2, 2, 2): every arch's smoke tree placed by the
  multi-pod plan (local shard shapes); ``Sharder`` and ``constrain`` on
  plain and DTensor leaves; the multipod twin's FL round with one pod a
  ``pod`` coordinate (its halves, each round's states for the reference,
  the exchange against the one-device ``crosspod_mean``, the twin's own
  ``run_rounds`` and ``main``); a checkpoint saved across the ranks and
  restored onto a (4, 2) mesh's placements.
- ``train``, 4 ranks on (2, 2): ``make_train_step``'s 3 steps of qwen3-8b
  (1 and 2 microbatches) and of granite-moe (its routing groups whole on
  each rank); the no-fallback checks.
- ``tp``, 4 ranks (``tests/test_torch_tensor_parallel.py``): the
  tensor-parallel train step on (2, 2) (qwen3-8b, granite-moe,
  llama-3.2-vision) and on (1, 4) (qwen3-8b), with what each rank
  multiplied and gathered on its first step; prefill on (2, 2) (those
  three and hubert-xlarge) and 8 decode steps on (2, 2) (qwen3-8b,
  granite-moe) from the test's cache.
- ``tp1``, 1 rank on (1, 1): the same code over a one-rank group, bit for
  bit the one-device steps (the transformer family and the recurrent
  families).
- ``tpr``, 4 ranks (``tests/test_torch_tensor_parallel_recurrent.py``):
  zamba2's and xLSTM's train steps on (2, 2) and (1, 4) with what each
  rank multiplied, re-cut and gathered on its first step; prefill on
  (2, 2) and the model collectives of prefill at two lengths; 8 decode
  steps on (2, 2) and (1, 4) from the test's state, the first step's
  model payloads noted; each train step again from the reference's
  state before it.
"""
import dataclasses
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import _dist, _tree  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import ARCH_ORDER, smoke_config  # noqa: E402
from repro_torch.configs.base import (MeshConfig, ShapeConfig,  # noqa: E402
                                      TrainConfig)
from repro_torch.launch import step_builders as sb  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_mesh  # noqa: E402
from repro_torch.launch.step_builders import (bundle_for,  # noqa: E402
                                              crosspod_mean, stack_pods)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.optim import adamw_init, sgd_init, sgd_update  # noqa: E402
from repro_torch.optim.optimizers import OptState  # noqa: E402
from repro_torch.sharding import (MeshPlan, Sharder, Sharding,  # noqa: E402
                                  constrain, gather_tree, place, place_tree)
from repro_torch.sharding import tensor_parallel as tpar  # noqa: E402

POD_AXES = ("pod", "data", "model")
ROUNDS = 2
# the train scenario: tests/test_torch_train.py's schedule and shape
TRAIN = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
BATCH, SEQ, STEPS = 4, 16, 3
# an MoE arch at a seq that gives each of the 2 data ranks one whole
# 64-token routing group of the 128-token batch
MOE, MOE_SEQ = "granite-moe-1b-a400m", 32


def f32_smoke(arch):
    """``arch``'s smoke config in f32; ``arch@field=n@...`` also sets those
    fields (a variant of the config)."""
    name, *sets = arch.split("@")
    fields = {k: int(v) for k, v in (x.split("=") for x in sets)}
    return dataclasses.replace(smoke_config(name), dtype="float32",
                               param_dtype="float32", **fields)


def twin():
    spec = importlib.util.spec_from_file_location(
        "multipod_fl_train", ROOT / "examples_torch" / "multipod_fl_train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host(tree):
    """Every leaf gathered (all ranks call) and on the host."""
    return _tree.map(lambda x: x.detach().cpu(), gather_tree(tree))


def local_matches(tree, full_tree) -> bool:
    """Each DTensor leaf's local shard equals its slice of the full tree."""
    ok = True
    for x, f in zip(_tree.leaves(tree), _tree.leaves(full_tree)):
        sl, dm = f, x.device_mesh
        coord = dm.get_coordinate()
        for j, pl in enumerate(x.placements):
            if pl.is_shard():
                sl = sl.chunk(dm.size(j), dim=pl.dim)[coord[j]]
        ok &= torch.equal(x.to_local(), sl)
    return ok


def placed_as(got, want) -> bool:
    """``got`` and ``want`` DTensors of one layout and equal shards."""
    return (tuple(got.placements) == tuple(want.placements)
            and torch.equal(got.to_local(), want.to_local()))


def sharder_checks(mesh, plan) -> dict:
    """``Sharder`` and ``constrain`` on a (2, 2, 2) mesh: a DTensor of
    another layout comes out of each laid out by the plan's spec, every
    shard its slice; so does a plain leaf (the full value, equal on every
    rank) out of ``Sharder``, while ``constrain``, which has no mesh to
    place it on, raises."""
    g = torch.Generator().manual_seed(3)
    full = {"w": torch.randn(8, 12, generator=g),
            "x": torch.randn(8, 3, 4, generator=g)}
    axes = {"w": ("embed", "mlp"), "x": ("batch", None, "heads")}
    want = {k: place(v, Sharding(mesh, plan.spec(axes[k], tuple(v.shape))))
            for k, v in full.items()}
    other = {k: place(v, Sharding(mesh, ("model",)))
             for k, v in full.items()}
    sharder = Sharder(plan, mesh)
    out = {"specs": {k: [list(e) if isinstance(e, tuple) else e
                         for e in plan.spec(axes[k], tuple(v.shape))]
                     for k, v in full.items()}}
    for name, tree in (("plain", full), ("dtensor", other)):
        outs = [{k: sharder(v, axes[k]) for k, v in tree.items()}]
        if name == "dtensor":
            outs.append(constrain(tree, plan, axes))
        out[name] = all(
            placed_as(t[k], want[k]) and local_matches([t[k]], [full[k]])
            for t in outs for k in full)
    try:
        constrain(full, plan, axes)
    except ValueError as e:
        out["constrain_plain_raised"] = str(e)
    return out


def recording_gathers(log: list):
    """Wrap ``torch.distributed.all_gather`` to note each payload's dtype
    and group size; -> the original, to put back."""
    orig = torch.distributed.all_gather

    def all_gather(parts, tensor, group=None, **kw):
        log.append((str(tensor.dtype), len(parts)))
        return orig(parts, tensor, group=group, **kw)

    torch.distributed.all_gather = all_gather
    return orig


def pods_scenario(out: Path, rank: int, checks: dict) -> None:
    mp = twin()
    # -- placements: every arch's smoke tree on the multi-pod plan ---------
    mcfg = MeshConfig((2, 2, 2), POD_AXES)
    mesh = make_mesh(mcfg, "cpu")
    plan = MeshPlan(mcfg)
    shapes = {}
    for arch in ARCH_ORDER:
        model = build_model(smoke_config(arch), device="meta")
        sh = plan.tree_shardings(mesh, model.param_axes(),
                                 model.param_shapes())
        shapes[arch] = [list(place(torch.zeros(l.shape), s).to_local().shape)
                        for l, s in zip(_tree.leaves(model.param_shapes()),
                                        _tree.leaves(sh))]
    checks["shard_shapes"] = shapes
    checks["sharder"] = sharder_checks(mesh, plan)

    # -- the twin's FL round, pods on separate ranks ----------------------
    cfg = f32_smoke("qwen3-8b")
    params = torch.load(out / "params.pt")
    bundle = mp.round_bundle(cfg, "cpu")
    checks["mesh"] = (list(mp.mesh_shape(_dist.world_size()))
                      if bundle.in_placements[0] is not None else None)
    stacked = stack_pods(params, mp.N_PODS)
    opt = stack_pods(adamw_init(params, mp.TRAIN), mp.N_PODS)
    anchor, rng = params, np.random.default_rng(0)
    exchange_exact, shards_ok, gathers = True, True, []
    for rnd in range(ROUNDS):
        batches = mp.round_batches(rng, cfg, "cpu")
        start = (host(stacked), host(opt), host(anchor))
        stacked, opt, loss = bundle.fn.local_steps(stacked, opt, batches,
                                                   rnd * mp.K)
        pre, a0 = host(stacked), host(anchor)
        orig = recording_gathers(gathers)
        try:
            stacked, anchor = bundle.fn.exchange(anchor, stacked)
        finally:
            torch.distributed.all_gather = orig
        got = host(anchor)
        for a, s, g in zip(_tree.leaves(a0), _tree.leaves(pre),
                           _tree.leaves(got)):
            want = (a.float() + crosspod_mean(a, s, "int8")).to(a.dtype)
            exchange_exact &= torch.equal(g, want)
        shards_ok &= local_matches(anchor, got) and local_matches(
            stacked, host(stacked)) and local_matches(opt.m, host(opt.m))
        end_opt = host(opt)
        if rank == 0:
            torch.save({"start": start, "loss": float(loss), "anchor": got,
                        "pre": pre, "opt": end_opt,
                        "batches": {k: v.cpu() for k, v in batches.items()}},
                       out / f"round{rnd}.pt")
    # the f32 exchange of the last round's pods: gathered over pod, bit for
    # bit the one-device mean of the gathered deltas
    f32_exact = True
    for a_full, s_full, sh_a, sh_s in zip(
            _tree.leaves(a0), _tree.leaves(pre),
            _tree.leaves(bundle.in_placements[2]),
            _tree.leaves(bundle.in_placements[0])):
        a_l, s_l = place(a_full, sh_a).to_local(), place(s_full,
                                                         sh_s).to_local()
        got_mean = crosspod_mean(
            a_l, s_l, "none", n_pods=mp.N_PODS,
            pod_group=mesh.device_mesh.get_group("pod"),
            scale_group=torch.distributed.group.WORLD)
        want = place(crosspod_mean(a_full, s_full, "none"), sh_a).to_local()
        f32_exact &= torch.equal(got_mean, want)
    checks["f32_exchange_exact"] = f32_exact
    checks["exchange_exact"] = exchange_exact
    checks["shards_match_gathered"] = shards_ok
    checks["exchange_gathers"] = sorted(set(map(tuple, gathers)))
    halves = host((stacked, opt, anchor))

    # the twin's own run_rounds: the same rounds, as one call each
    losses, s2, o2, a2 = mp.run_rounds(ROUNDS, device="cpu", params=params,
                                       cfg=cfg)
    whole = host((s2, o2, a2))
    checks["run_rounds_equal_halves"] = all(
        torch.equal(a, b) for a, b in zip(_tree.leaves(halves),
                                          _tree.leaves(whole)))
    checks["run_rounds_losses"] = losses

    # -- a checkpoint across the ranks, restored onto other placements ----
    tree = (s2, o2, a2)
    save_checkpoint(str(out / "ckpt"), 1, tree)
    if rank == 0:
        torch.save(whole, out / "ckpt_tree.pt")
    one = load_checkpoint(str(out / "ckpt"), whole, device="cpu")[0]
    checks["restored_on_one_device"] = all(
        torch.equal(a, b) for a, b in zip(_tree.leaves(one),
                                          _tree.leaves(whole)))
    mesh42 = make_mesh(MeshConfig((4, 2), ("data", "model")), "cpu")
    model = build_model(cfg, device="meta")
    new = MeshPlan(MeshConfig((4, 2), ("data", "model"))).tree_shardings(
        mesh42, model.param_axes(), model.param_shapes())
    repl = _tree.map(lambda x: Sharding(mesh42, ()), whole[:2])
    restored = load_checkpoint(str(out / "ckpt"), whole,
                               shardings=repl + (new,))[0]
    checks["restored_placements"] = [
        [str(p) for p in l.placements] for l in _tree.leaves(restored[2])]
    checks["restored_shards_match"] = local_matches(restored[2], whole[2]) \
        and local_matches(restored[1].m, whole[1].m)
    mgr = CheckpointManager(str(out / "managed"), keep=1)
    mgr.save(2, tree)
    again, step, _ = mgr.restore(whole, shardings=repl + (new,))
    checks["manager_restore"] = step == 2 and local_matches(
        again[2], whole[2]) and all(torch.equal(a, b) for a, b in zip(
            _tree.leaves(host(again)), _tree.leaves(whole)))

    # -- the twin as launched: its own prints and asserts ------------------
    checks["twin_main"] = mp.main(["--device", "cpu"])

    # -- an MoE round whose pod batch would split a routing group ----------
    try:
        bundle_for("fl_round", f32_smoke(MOE), ShapeConfig("fl", SEQ, 4,
                                                           "train"),
                   mesh, mcfg, TrainConfig())
    except ValueError as e:
        checks["moe_fl_raised"] = str(e)


def train_steps(out: Path, arch: str, seq: int, mbs: int, mesh, mcfg):
    """``STEPS`` steps of ``arch``'s train step on ``mesh`` from the test's
    parameters and batches -> (bundle, params, opt state, [metrics])."""
    params = torch.load(out / f"params_{arch}.pt")
    batches = np.load(out / f"batches_{arch}.npz")
    tcfg = TrainConfig(microbatches=mbs, **TRAIN)
    bundle = bundle_for("train", f32_smoke(arch),
                        ShapeConfig("t", seq, BATCH, "train"), mesh, mcfg,
                        tcfg)
    p, o = params, adamw_init(params, tcfg)
    metrics = []
    for step in range(STEPS):
        batch = {k[len(f"{step}/"):]: torch.from_numpy(v) for k, v in
                 batches.items() if k.startswith(f"{step}/")}
        p, o, m = bundle.fn(p, o, batch, step)
        metrics.append({k: float(v) for k, v in m.items()})
    return bundle, p, o, metrics


def train_scenario(out: Path, rank: int, checks: dict) -> None:
    cfg = f32_smoke("qwen3-8b")
    params = torch.load(out / "params_qwen3-8b.pt")
    mcfg = MeshConfig((2, 2), ("data", "model"))
    mesh = make_mesh(mcfg, "cpu")
    shards_ok = True
    for name, arch, seq, mbs in (("mb1", "qwen3-8b", SEQ, 1),
                                 ("mb2", "qwen3-8b", SEQ, 2),
                                 ("moe", MOE, MOE_SEQ, 1)):
        bundle, p, o, metrics = train_steps(out, arch, seq, mbs, mesh, mcfg)
        gp, go = host(p), host(o)
        shards_ok &= local_matches(p, gp) and local_matches(o.v, go.v)
        if name == "mb1":
            checks["local_shapes"] = [list(l.to_local().shape)
                                      for l in _tree.leaves(p)]
            qwen = bundle
        if rank == 0:
            torch.save({"params": gp, "opt": go, "metrics": metrics},
                       out / f"train_{name}.pt")
    checks["shards_match_gathered"] = shards_ok
    bundle = qwen

    # -- SGD and the global norm on DTensor leaves ----------------------------
    g = torch.Generator().manual_seed(5)
    grads = _tree.map(lambda x: torch.randn(x.shape, generator=g), params)
    sh = bundle.in_placements[0]
    sgd_cfg = TrainConfig(grad_clip=1e6, **TRAIN)  # a norm, no clipping
    state = sgd_init(params, sgd_cfg)
    state = state._replace(m=_tree.map(lambda x: torch.randn(
        x.shape, generator=g), params))
    lr = torch.tensor(1e-2)
    want_p, want_s, want_n = sgd_update(grads, state, params, lr, sgd_cfg)
    got_p, got_s, got_n = sgd_update(
        place_tree(grads, sh), state._replace(m=place_tree(state.m, sh)),
        place_tree(params, sh), lr, sgd_cfg)
    checks["sgd_exact"] = all(torch.equal(a, b) for a, b in zip(
        _tree.leaves(host((got_p, got_s.m))), _tree.leaves((want_p,
                                                            want_s.m))))
    checks["sgd_count"] = int(got_s.count)
    checks["gnorm"] = [float(got_n), float(want_n)]

    # -- no quiet fallback --------------------------------------------------
    raised = {}

    def expect(name, exc, fn):
        try:
            fn()
        except exc as e:
            raised[name] = str(e)
        else:
            raised[name] = None

    expect("world_size", ValueError,
           lambda: make_mesh(MeshConfig((2, 2, 2), POD_AXES), "cpu"))
    expect("cuda_on_gloo", RuntimeError,
           lambda: make_mesh(mcfg, "cuda"))
    expect("init_cuda_on_gloo", RuntimeError, lambda: _dist.init("cuda"))
    # prefill and decode on the mesh: every arch builds (at a batch whose
    # MoE routing groups a data rank holds whole)
    for arch in ARCH_ORDER:
        for kind, rows in (("prefill", BATCH), ("decode", SERVE_ROWS)):
            expect(f"{arch}/{kind}", NotImplementedError, lambda: bundle_for(
                kind, f32_smoke(arch), ShapeConfig("t", MOE_SEQ, rows, kind),
                mesh, mcfg))
    # MoE routing groups of the whole batch that a rank's shard would cut
    moe = f32_smoke(MOE)
    expect("moe_seq", ValueError, lambda: bundle_for(
        "train", moe, ShapeConfig("t", SEQ, BATCH, "train"), mesh, mcfg,
        TrainConfig(**TRAIN)))
    expect("moe_microbatches", ValueError, lambda: bundle_for(
        "train", moe, ShapeConfig("t", MOE_SEQ, BATCH, "train"), mesh, mcfg,
        TrainConfig(microbatches=2, **TRAIN)))
    checks["raised"] = raised


# -- tensor-parallel compute over model --------------------------------------

VLM = "llama-3.2-vision-11b"
TP_TRAIN = {"qwen3-8b": SEQ, MOE: MOE_SEQ, VLM: SEQ}  # arch -> seq
TP_PREFILL = ("qwen3-8b", MOE, VLM, "hubert-xlarge")
SERVE_ROWS = 128  # decode rows: two whole 64-token MoE groups over data 2
TP_DECODE = {(2, 2): {f"2x2/{a}": (a, MOE_SEQ)  # key -> (arch, cache seq)
                      for a in ("qwen3-8b", MOE, VLM)},
             (1, 4): {"1x4/qwen3-8b": ("qwen3-8b", MOE_SEQ),
                      "1x4-seq30/qwen3-8b": ("qwen3-8b", 30)}}
DECODE_STEPS = 8
MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
           torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


class MatmulOperands(TorchDispatchMode):
    """Notes, per parameter leaf, the element counts of the matmul-class
    operands that are views of the tensor the rank computes with."""

    def __init__(self, owners: dict):
        super().__init__()
        self.owners, self.seen = owners, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in MATMULS:
            for a in args:
                if isinstance(a, torch.Tensor):
                    path = self.owners.get(a.untyped_storage().data_ptr())
                    if path is not None:
                        self.seen.setdefault(path, []).append(a.numel())
        return func(*args, **(kwargs or {}))


def recording_group_calls(group, log: dict, sent: list = None):
    """Count the all_reduce / all_gather / all_gather_into_tensor /
    reduce_scatter_tensor calls made over ``group`` (and note in ``sent``
    the shape of the tensor each one sends); -> the originals, to put
    back."""
    dist = torch.distributed
    orig = {n: getattr(dist, n) for n in ("all_reduce", "all_gather",
                                          "all_gather_into_tensor",
                                          "reduce_scatter_tensor")}

    def wrap(name):
        def call(*args, group=None, **kw):
            if group is not None and group == want:
                log[name] = log.get(name, 0) + 1
                if sent is not None:
                    t = args[0] if name == "all_reduce" else args[1]
                    sent.append([name, list(t.shape)])
            return orig[name](*args, group=group, **kw)
        return call

    want = group
    for n in orig:
        setattr(dist, n, wrap(n))
    return orig


def recording_recuts(owners: dict, log: dict):
    """Wrap ``tensor_parallel._Recut``'s forward: a re-cut leaf's output
    (the columns the rank multiplies) joins ``owners`` under the leaf's
    path, kept alive while the wrapper is, and its shape is noted in
    ``log``; -> the original, to put back."""
    orig, alive = tpar._Recut.forward, []

    def forward(ctx, w, tp, dim, pieces):
        out = orig(ctx, w, tp, dim, pieces)
        path = owners.get(w.untyped_storage().data_ptr())
        if path is not None:
            alive.append(out)  # its storage's address is not reused
            owners[out.untyped_storage().data_ptr()] = path
            log.setdefault(path, []).append(list(out.shape))
        return out

    tpar._Recut.forward = staticmethod(forward)
    return orig


def split_record(bundle, mesh, first_step):
    """Run ``first_step()`` (the bundle's first train step) noting, on this
    rank: the shape and bytes of every parameter as the rank computes with
    it, the matmul operands that are views of them (or of the columns a
    re-cut leaf gave), the re-cut leaves' shapes, the collectives over
    the ``model`` group inside the forward and backward, and the gradient
    the optimizer is given (gathered)."""
    paths = sb._tree_paths(bundle.model.param_axes())
    runs, rec = [], {"calls": {}, "recut": {}}
    orig_cp, orig_vg = sb._Compute.params, sb.value_and_grad
    orig_up, grads = sb.adamw_update, []

    def adamw_update(g, *args, **kw):
        grads.append(host(g))  # every rank gathers
        return orig_up(g, *args, **kw)

    def compute_params(compute, leaves):
        runs.append(orig_cp(compute, leaves))
        return runs[-1]

    def value_and_grad(model, params, batch, **kw):
        owners = {t.untyped_storage().data_ptr(): p
                  for p, t in zip(paths, runs[-1])}
        orig = recording_group_calls(mesh.device_mesh.get_group("model"),
                                     rec["calls"])
        orig_recut = recording_recuts(owners, rec["recut"])
        try:
            with MatmulOperands(owners) as mode:
                out = orig_vg(model, params, batch, **kw)
        finally:
            for n, f in orig.items():
                setattr(torch.distributed, n, f)
            tpar._Recut.forward = staticmethod(orig_recut)
        rec["operands"] = mode.seen
        return out

    sb._Compute.params, sb.value_and_grad = compute_params, value_and_grad
    sb.adamw_update = adamw_update
    try:
        out = first_step()
    finally:
        sb._Compute.params, sb.value_and_grad = orig_cp, orig_vg
        sb.adamw_update = orig_up
    rec["grads"] = grads[0]
    rec["record"] = bundle.tp_record
    rec["run_shapes"] = {p: list(t.shape) for p, t in zip(paths, runs[0])}
    rec["run_bytes"] = sum(t.numel() * t.element_size() for t in runs[0])
    return out, rec


def tp_train(out: Path, arch: str, seq: int, mesh, mcfg, checks, key):
    """3 train steps of ``arch`` on ``mesh`` from the test's parameters and
    batches, the first noted by ``split_record``; rank 0 saves the
    gathered result."""
    params = torch.load(out / f"params_{arch}.pt")
    batches = np.load(out / f"batches_{arch}.npz")
    tcfg = TrainConfig(**TRAIN)
    bundle = bundle_for("train", f32_smoke(arch),
                        ShapeConfig("t", seq, BATCH, "train"), mesh, mcfg,
                        tcfg)
    p, o, metrics = params, adamw_init(params, tcfg), []
    for step in range(STEPS):
        batch = {k[len(f"{step}/"):]: torch.from_numpy(v) for k, v in
                 batches.items() if k.startswith(f"{step}/")}
        run = lambda: bundle.fn(p, o, batch, step)  # noqa: E731
        if step == 0:
            (p, o, m), checks["split"][key] = split_record(bundle, mesh, run)
            grad0 = checks["split"][key].pop("grads")
        else:
            p, o, m = run()
        metrics.append({k: float(v) for k, v in m.items()})
    gp, go = host(p), host(o)
    checks["shards_match_gathered"] &= local_matches(p, gp)
    if torch.distributed.get_rank() == 0:
        torch.save({"params": gp, "opt": go, "metrics": metrics,
                    "grad0": grad0},
                   out / f"tp_train_{key.replace('/', '_')}.pt")


def tp_prefill(out: Path, mesh, mcfg, checks, rank: int,
               archs=TP_PREFILL) -> None:
    """Prefill (``archs``) on ``mesh`` from the test's parameters and
    prompts."""
    for arch in archs:
        params = torch.load(out / f"params_{arch}.pt")
        z = np.load(out / f"prefill_{arch}.npz")
        batch = {k: torch.from_numpy(z[k]) for k in z.files}
        b = bundle_for("prefill", f32_smoke(arch),
                       ShapeConfig("p", MOE_SEQ, BATCH, "prefill"), mesh,
                       mcfg)
        logits = b.fn(params, batch)
        checks["prefill_shapes"][arch] = list(logits.to_local().shape)
        got = host(logits)
        if rank == 0:
            torch.save(got, out / f"tp_prefill_{arch}.pt")


def tp_decode(out: Path, mesh, mcfg, checks, rank: int, runs: dict) -> None:
    """Decode (``runs``: key -> arch, cache positions) on ``mesh`` from the
    test's parameters, cache and tokens."""
    for key, (arch, seq) in runs.items():
        name = key.replace("/", "_")
        params = torch.load(out / f"params_{arch}.pt")
        z = np.load(out / f"decode_{name}.npz")
        model = build_model(f32_smoke(arch), device="cpu")
        spec = model.cache_spec(SERVE_ROWS, seq)
        leaves, treedef = _tree.flatten(spec)
        cache = _tree.unflatten(treedef, [torch.from_numpy(z[f"c{i}"])
                                          for i in range(len(leaves))])
        b = bundle_for("decode", f32_smoke(arch),
                       ShapeConfig("d", seq, SERVE_ROWS, "decode"),
                       mesh, mcfg)
        logits, payloads = [], []
        for i in range(DECODE_STEPS):
            batch = {"tokens": torch.from_numpy(z["tokens"][:, i:i + 1]),
                     "pos": int(z["pos0"]) + i}
            if i == 0:
                orig = recording_group_calls(
                    mesh.device_mesh.get_group("model"), {}, payloads)
                try:
                    lg, cache = b.fn(params, cache, batch)
                finally:
                    for n, f in orig.items():
                        setattr(torch.distributed, n, f)
            else:
                lg, cache = b.fn(params, cache, batch)
            logits.append(host(lg))
        checks.setdefault("decode_payloads", {})[key] = payloads
        checks["decode_shapes"][key] = {
            "logits": list(lg.to_local().shape),
            "cache": [list(l.to_local().shape) for l in _tree.leaves(cache)]}
        got = host(cache)
        if rank == 0:
            torch.save({"logits": logits, "cache": got},
                       out / f"tp_decode_{name}.pt")


def tp_scenario(out: Path, rank: int, checks: dict) -> None:
    checks.update(split={}, prefill_shapes={}, decode_shapes={},
                  shards_match_gathered=True)
    for shape, archs in (((2, 2), list(TP_TRAIN)), ((1, 4), ["qwen3-8b"])):
        mcfg = MeshConfig(shape, ("data", "model"))
        mesh = make_mesh(mcfg, "cpu")
        for arch in archs:
            tp_train(out, arch, TP_TRAIN[arch], mesh, mcfg, checks,
                     f"{shape[0]}x{shape[1]}/{arch}")
        if shape == (2, 2):
            tp_prefill(out, mesh, mcfg, checks, rank)
        tp_decode(out, mesh, mcfg, checks, rank, TP_DECODE[shape])


def tp1_scenario(out: Path, rank: int, checks: dict) -> None:
    """A group of one rank: the train step (qwen3-8b, granite-moe and the
    recurrent families), prefill and decode (qwen3-8b and the recurrent
    families) through the tensor-parallel code (every split whole, every
    collective a one-rank call) against the one-device code from the same
    state: bit for bit."""
    names = ("data", "model")
    mcfg = MeshConfig((1, 1), names)
    mesh, one = make_mesh(mcfg, "cpu"), Mesh(names, (1, 1),
                                             torch.device("cpu"))
    tcfg = TrainConfig(**TRAIN)
    same = {}
    for arch in ("qwen3-8b", MOE) + RECURRENT:
        cfg = f32_smoke(arch)
        shape = ShapeConfig("t", MOE_SEQ, BATCH, "train")
        bundles = [bundle_for("train", cfg, shape, m, mcfg, tcfg)
                   for m in (one, mesh)]
        params = bundles[0].model.init(torch.Generator().manual_seed(1))
        rng = np.random.default_rng(2)
        batches = [{k: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (BATCH, MOE_SEQ)).astype(np.int32))
            for k in ("tokens", "targets")} for _ in range(2)]
        runs = []
        for b in bundles:
            p, o, ms = params, adamw_init(params, tcfg), []
            for step, batch in enumerate(batches):
                p, o, m = b.fn(p, o, batch, step)
                ms.append(m)
            runs.append(_tree.leaves((host(p), host(o), ms)))
        same[f"train/{arch}"] = all(torch.equal(a, b)
                                    for a, b in zip(*runs))
    for arch in ("qwen3-8b",) + RECURRENT:
        cfg = f32_smoke(arch)
        model = build_model(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(3))
        rng = np.random.default_rng(4)
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (BATCH, MOE_SEQ)).astype(np.int32))
        outs = [host(bundle_for("prefill", cfg, ShapeConfig(
            "p", MOE_SEQ, BATCH, "prefill"), m, mcfg).fn(
            params, {"tokens": prompts})) for m in (one, mesh)]
        same[f"prefill/{arch}"] = torch.equal(*outs)
        runs = []
        for m in (one, mesh):
            b = bundle_for("decode", cfg, ShapeConfig("d", MOE_SEQ, BATCH,
                                                      "decode"), m, mcfg)
            cache, logits = model.init_cache(BATCH, MOE_SEQ), []
            for pos in range(DECODE_STEPS):
                lg, cache = b.fn(params, cache, {
                    "tokens": prompts[:, pos:pos + 1], "pos": pos})
                logits.append(host(lg))
            runs.append(logits + _tree.leaves(host(cache)))
        same[f"decode/{arch}"] = all(torch.equal(a, b)
                                     for a, b in zip(*runs))
    checks["same"] = same


# -- the recurrent families over model ---------------------------------------

RECURRENT = ("zamba2-1.2b", "xlstm-1.3b")
# on (1, 4), variants whose heads do not divide over 4 (rule 1): xLSTM
# with 2 heads, zamba2 with 2 SSM heads
RULE_ONE = ("xlstm-1.3b@num_heads=2@num_kv_heads=2",
            "zamba2-1.2b@ssm_head_dim=64")
TPR_TRAIN = {(2, 2): RECURRENT, (1, 4): RECURRENT + RULE_ONE}
TPR_DECODE = {shape: {f"{shape[0]}x{shape[1]}/{a}": (a, MOE_SEQ)
                      for a in archs} for shape, archs in TPR_TRAIN.items()}
LOOP_SEQS = (16, 32)  # prefill lengths whose model collectives are counted


def loop_counts(mesh, mcfg, checks) -> None:
    """Each recurrent arch's prefill at ``LOOP_SEQS`` positions, counting
    the collectives over ``model``: the same count at every length means
    none runs inside a loop over positions (the sLSTM's time loop)."""
    group = mesh.device_mesh.get_group("model")
    for arch in RECURRENT:
        cfg = f32_smoke(arch)
        params = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(6))
        counts = []
        for seq in LOOP_SEQS:
            b = bundle_for("prefill", cfg, ShapeConfig("p", seq, BATCH,
                                                       "prefill"), mesh, mcfg)
            tokens = torch.zeros((BATCH, seq), dtype=torch.int32)
            calls = {}
            orig = recording_group_calls(group, calls)
            try:
                b.fn(params, {"tokens": tokens})
            finally:
                for n, f in orig.items():
                    setattr(torch.distributed, n, f)
            counts.append(calls)
        checks["loop_counts"][arch] = counts


def waited(path: Path, timeout: float = 600.0) -> Path:
    """``path``, once another process has written it."""
    t0 = time.monotonic()
    while not path.exists():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} was not written in {timeout} s")
        time.sleep(0.2)
    return path


def tp_steps_from_reference(out: Path, arch: str, mesh, mcfg, key: str):
    """Each of the train run's STEPS again from the reference's state
    before it (the initial parameters and fresh moments for the first;
    ``ref_state_*``, which the reference writes as its chained run goes,
    for the rest); rank 0 saves each step's gathered result."""
    name = key.replace("/", "_")
    params = torch.load(out / f"params_{arch}.pt")
    batches = np.load(out / f"batches_{arch}.npz")
    treedef = _tree.flatten(params)[1]
    n = len(_tree.leaves(params))
    tcfg = TrainConfig(**TRAIN)
    bundle = bundle_for("train", f32_smoke(arch),
                        ShapeConfig("t", SEQ, BATCH, "train"), mesh, mcfg,
                        tcfg)
    results = []
    for step in range(STEPS):
        if step == 0:
            p, o = params, adamw_init(params, tcfg)
        else:
            z = np.load(waited(out / f"ref_state_{name}_{step}.npz"))

            def tree(t):
                return _tree.unflatten(treedef, [torch.from_numpy(z[f"{t}{i}"])
                                                 for i in range(n)])

            p = tree("p")
            o = OptState(torch.from_numpy(z["count"]), tree("m"), tree("v"))
        batch = {k[len(f"{step}/"):]: torch.from_numpy(v) for k, v in
                 batches.items() if k.startswith(f"{step}/")}
        p2, o2, _ = bundle.fn(p, o, batch, step)
        results.append(host((p2, o2)))
    if torch.distributed.get_rank() == 0:
        torch.save(results, out / f"tp_steps_{name}.pt")


def tpr_scenario(out: Path, rank: int, checks: dict) -> None:
    """The recurrent families over ``model`` (Zamba2's Mamba blocks by SSM
    heads, xLSTM's mLSTM and sLSTM blocks): the train step on (2, 2) and
    (1, 4) (there also the RULE_ONE variants), prefill on (2, 2), decode
    on both, the collectives of prefill at two lengths."""
    checks.update(split={}, prefill_shapes={}, decode_shapes={},
                  loop_counts={}, shards_match_gathered=True)
    for shape in ((2, 2), (1, 4)):
        mcfg = MeshConfig(shape, ("data", "model"))
        mesh = make_mesh(mcfg, "cpu")
        for arch in TPR_TRAIN[shape]:
            tp_train(out, arch, SEQ, mesh, mcfg, checks,
                     f"{shape[0]}x{shape[1]}/{arch}")
        if shape == (2, 2):
            tp_prefill(out, mesh, mcfg, checks, rank, RECURRENT)
            loop_counts(mesh, mcfg, checks)
        tp_decode(out, mesh, mcfg, checks, rank, TPR_DECODE[shape])
        for arch in TPR_TRAIN[shape]:
            tp_steps_from_reference(out, arch, mesh, mcfg,
                                    f"{shape[0]}x{shape[1]}/{arch}")


SCENARIOS = {"pods": pods_scenario, "train": train_scenario,
             "tp": tp_scenario, "tp1": tp1_scenario, "tpr": tpr_scenario}


def main(argv) -> int:
    scenario, rank, world, init_file, out = argv
    rank, world, out = int(rank), int(world), Path(out)
    checks = {"rank": rank, "world": world}
    try:
        _dist.init("cpu", rank=rank, world_size=world, init_file=init_file)
        checks["backend"] = torch.distributed.get_backend()
        SCENARIOS[scenario](out, rank, checks)
        checks["ok"] = True
    except Exception:  # the test reads it; the group is torn down below
        checks["ok"] = False
        checks["error"] = traceback.format_exc()
    finally:
        (out / f"checks_{rank}.json").write_text(json.dumps(checks))
        _dist.shutdown()
    return 0 if checks["ok"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
