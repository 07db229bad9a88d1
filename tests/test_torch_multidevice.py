"""The multi-device path, port against the JAX reference on the CPU: meshes
over gloo ranks (spawned processes, ``tests/torch_multidevice_worker.py``,
which import no JAX), plan-driven placements, the cross-pod int8 FL round
with the pods on separate ranks, the train step over (2, 2) (a dense
arch and an MoE one), checkpoints saved across ranks and restored onto new
placements, and no quiet fallback.

Each scenario spawns one group, shared by the tests that read it: 8 ranks
on (2, 2, 2) (``pods``) and 4 on (2, 2) (``train``), each rank on one
thread, meeting through a file under ``tmp_path`` (no fixed port). The
reference runs in a subprocess with Auto axes (jax 0.9's
``jax.make_mesh`` makes Explicit ones, which its
``with_sharding_constraint`` rejects): on 8 host devices its example's
flow from the port's state at each round, on 4 its jitted train step
from the same parameters and batches as the ranks.

Bars:
- placements: every leaf's local shard shape equals
  ``NamedSharding(mesh, spec).shard_shape`` on the reference's (2, 2, 2);
- the FL round: ``tests/test_torch_examples.py``'s: the anchor within one
  int8 level plus 1e-4 of each leaf's largest entry (``FL_TREE_WIDE`` at
  the tree's largest), moments at 1e-4, the loss at rtol 1e-5;
- the exchange: bit for bit the one-device ``crosspod_mean`` from the same
  deltas (int8 and f32), the int8 one's payloads int8 over groups of the
  pod count; each rank's shard its slice of the gathered tree;
- the train step: ``tests/test_torch_train.py``'s per-leaf 1e-4 (the
  gradient is averaged over ``data`` in another order than one device
  sums it; 2^-8 with 2 microbatches, whose gradients are cast to bf16),
  loss, gnorm and lr at rtol 1e-5, against the reference's jitted step on
  its Auto (2, 2) mesh and against the port's one-device step; SGD on
  the shards bit for bit SGD on the full trees, its norm at rtol 1e-6;
- checkpoints: the manifest's bytes and every npz member's bytes equal
  the one-device save's (the zip headers carry the write time).
"""
import json
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import _torch_zoo as Z  # noqa: E402
from repro.checkpoint.ckpt import load_checkpoint as jload  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.optim.optimizers import adamw_init as jadamw_init  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.configs import ARCH_ORDER  # noqa: E402
from repro_torch.configs.base import (MULTI_POD_MESH, SMOKE_MESH,  # noqa: E402
                                      ShapeConfig, TrainConfig)
from repro_torch.launch.mesh import make_mesh, make_smoke_mesh  # noqa: E402
from repro_torch.launch.step_builders import (bundle_for,  # noqa: E402
                                              crosspod_mean)
from repro_torch.optim import adamw_init  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_multidevice_worker.py"
SPAWN_TIMEOUT = 240
# tests/test_torch_examples.py's: AdamW near its eps at the example's lr
FL_TREE_WIDE = ("['attn']['wk']",)
ROUNDS = 2  # the worker's
TRAIN = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
BATCH, SEQ, STEPS = 4, 16, 3
MOE, MOE_SEQ = "granite-moe-1b-a400m", 32  # the worker's
# the train scenario's runs: name -> (arch, seq, microbatches)
TRAIN_RUNS = {"mb1": ("qwen3-8b", SEQ, 1), "mb2": ("qwen3-8b", SEQ, 2),
              "moe": (MOE, MOE_SEQ, 1)}
METRIC_RTOL = 1e-5
BF16_ULP = 2.0 ** -8

# The reference example's flow (examples/multipod_fl_train.py) on an Auto
# (2, 2, 2) mesh of 8 host devices, one round from each of the port's
# states; and the shard shapes of every arch's smoke tree there.
REFERENCE = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import smoke_config
from repro.configs.base import MeshConfig, ShapeConfig, TrainConfig
from repro.launch.step_builders import make_fl_round_step
from repro.models import build_model
from repro.models.layers import abstract_init
from repro.sharding.rules import MeshPlan

d, arches, rounds = sys.argv[1], json.loads(sys.argv[2]), int(sys.argv[3])
names = ("pod", "data", "model")
mesh = jax.make_mesh((2, 2, 2), names, axis_types=(AxisType.Auto,) * 3)
mcfg = MeshConfig(shape=(2, 2, 2), axis_names=names)
plan = MeshPlan(mcfg)
shard = {}
for arch in arches:
    shapes, axes = abstract_init(build_model(smoke_config(arch)).init)
    specs = jax.tree.leaves(plan.tree_specs(axes, shapes),
                            is_leaf=lambda x: isinstance(x, P))
    shard[arch] = [list(NamedSharding(mesh, s).shard_shape(tuple(l.shape)))
                   for s, l in zip(specs, jax.tree.leaves(shapes))]
with open(os.path.join(d, "ref_shards.json"), "w") as f:
    json.dump(shard, f)

cfg = dataclasses.replace(smoke_config("qwen3-8b"), dtype="float32",
                          param_dtype="float32")
K = 4
shape = ShapeConfig(name="fl", seq_len=32, global_batch=8, kind="train")
tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=64,
                   crosspod_compression="int8")
bundle = make_fl_round_step(cfg, shape, mesh, mcfg, tcfg, local_steps=K)
fl_round = jax.jit(bundle.fn, in_shardings=bundle.in_shardings,
                   out_shardings=bundle.out_shardings)
defs = [jax.tree.structure(t) for t in (bundle.abstract_state["params"],
                                        bundle.abstract_state["opt"])]
adef = jax.tree.structure(abstract_init(bundle.model.init)[0])
for rnd in range(rounds):
    z = np.load(os.path.join(d, f"ref_in{rnd}.npz"))
    take = lambda p, n: [jnp.asarray(z[f"{p}{i}"]) for i in range(n)]
    params = jax.tree.unflatten(defs[0], take("s", defs[0].num_leaves))
    opt = jax.tree.unflatten(defs[1], take("o", defs[1].num_leaves))
    anchor = jax.tree.unflatten(adef, take("a", adef.num_leaves))
    batches = {k: jnp.asarray(z[k]) for k in ("tokens", "targets")}
    with mesh:
        params, opt, anchor, loss = fl_round(params, opt, anchor, batches,
                                             jnp.int32(rnd * K))
    out = {f"a{i}": np.asarray(l) for i, l in enumerate(jax.tree.leaves(anchor))}
    out.update({f"o{i}": np.asarray(l)
                for i, l in enumerate(jax.tree.leaves(opt))})
    np.savez(os.path.join(d, f"ref_out{rnd}.npz"), loss=np.asarray(loss),
             **out)
"""

# The reference's train step (bundle_for("train")), jitted with its
# shardings on an Auto (2, 2) mesh of 4 host devices, for each of the
# train scenario's runs, from the parameters and batches the ranks take.
REFERENCE_TRAIN = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType
from repro.configs import smoke_config
from repro.configs.base import MeshConfig, ShapeConfig, TrainConfig
from repro.launch.step_builders import bundle_for
from repro.optim.optimizers import adamw_init

d, runs, train, batch, steps = (sys.argv[1], json.loads(sys.argv[2]),
                                json.loads(sys.argv[3]), int(sys.argv[4]),
                                int(sys.argv[5]))
names = ("data", "model")
mesh = jax.make_mesh((2, 2), names, axis_types=(AxisType.Auto,) * 2)
mcfg = MeshConfig(shape=(2, 2), axis_names=names)
for name, (arch, seq, mbs) in runs.items():
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                              param_dtype="float32")
    tcfg = TrainConfig(microbatches=mbs, **train)
    b = bundle_for("train", cfg, ShapeConfig("t", seq, batch, "train"), mesh,
                   mcfg, tcfg)
    fn = jax.jit(b.fn, in_shardings=b.in_shardings,
                 out_shardings=b.out_shardings)
    pdef = jax.tree.structure(b.abstract_state["params"])
    z = np.load(os.path.join(d, f"ref_params_{arch}.npz"))
    params = jax.tree.unflatten(pdef, [jnp.asarray(z[f"p{i}"])
                                       for i in range(pdef.num_leaves)])
    opt = adamw_init(params, tcfg)
    bz = np.load(os.path.join(d, f"batches_{arch}.npz"))
    metrics = []
    with mesh:
        for s in range(steps):
            bt = {k.split("/", 1)[1]: jnp.asarray(bz[k]) for k in bz.files
                  if k.startswith(f"{s}/")}
            params, opt, m = fn(params, opt, bt, jnp.int32(s))
            metrics.append({k: float(v) for k, v in m.items()})
    out = {f"{t}{i}": np.asarray(l) for t, tree in
           (("p", params), ("m", opt.m), ("v", opt.v))
           for i, l in enumerate(jax.tree.leaves(tree))}
    np.savez(os.path.join(d, f"ref_{name}.npz"), count=np.asarray(opt.count),
             **out)
    with open(os.path.join(d, f"ref_{name}.json"), "w") as f:
        json.dump(metrics, f)
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This process's torch on one thread, beside XLA's pool and the
    spawned ranks (tests/test_torch_examples.py: ~60x slower otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(path: Path):
    """A tree the ranks saved (their OptState is no plain tensor type)."""
    return torch.load(path, weights_only=False)


def spawn(scenario: str, world: int, out: Path,
          timeout: float = SPAWN_TIMEOUT) -> list:
    """``world`` ranks of ``scenario``, meeting through a file in ``out``;
    -> each rank's checks. Every rank is waited for, or killed at
    ``timeout`` seconds."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore")
    log = open(out / f"{scenario}.log", "w")
    try:
        procs = [subprocess.Popen(
            [sys.executable, str(WORKER), scenario, str(r), str(world),
             str(out / f"{scenario}.init"), str(out)], env=env, stdout=log,
            stderr=subprocess.STDOUT) for r in range(world)]
        try:
            for p in procs:
                p.wait(timeout=timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    finally:
        log.close()
    checks = []
    for r in range(world):
        path = out / f"checks_{r}.json"
        assert path.exists(), (out / f"{scenario}.log").read_text()[-4000:]
        checks.append(json.loads(path.read_text()))
        assert checks[-1]["ok"], checks[-1].get("error")
    return checks


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    """The 8-rank group's findings, and the reference's, in one dir."""
    out = tmp_path_factory.mktemp("pods")
    jm, jp, tm, tp = Z.pair("qwen3-8b")
    torch.save(tp, out / "params.pt")
    checks = spawn("pods", 8, out)
    rounds = [load(out / f"round{r}.pt") for r in range(ROUNDS)]
    for r, rec in enumerate(rounds):
        stacked, opt, anchor = rec["start"]
        arrays = {f"s{i}": l.numpy() for i, l in
                  enumerate(_tree.leaves(stacked))}
        arrays.update({f"o{i}": l.numpy() for i, l in
                       enumerate(_tree.leaves(opt))})
        arrays.update({f"a{i}": l.numpy() for i, l in
                       enumerate(_tree.leaves(anchor))})
        arrays.update({k: v.numpy() for k, v in rec["batches"].items()})
        np.savez(out / f"ref_in{r}.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(out), json.dumps(ARCH_ORDER),
         str(ROUNDS)], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {"out": out, "checks": checks, "rounds": rounds, "jm": jm,
            "jp": jp, "tp": tp}


@pytest.fixture(scope="module")
def train(tmp_path_factory):
    """The 4-rank group's runs and the reference's, from the same
    parameters and batches (the reference's subprocess runs beside the
    ranks)."""
    out = tmp_path_factory.mktemp("train")
    pairs, batches = {}, {}
    for arch, seq in (("qwen3-8b", SEQ), (MOE, MOE_SEQ)):
        jm, jp, tm, tp = pairs[arch] = Z.pair(arch)
        torch.save(tp, out / f"params_{arch}.pt")
        np.savez(out / f"ref_params_{arch}.npz",
                 **{f"p{i}": l for i, l in enumerate(jax.tree.leaves(jp))})
        batches[arch] = [Z.batch(tm.cfg, 40 + s, BATCH, seq)
                         for s in range(STEPS)]
        np.savez(out / f"batches_{arch}.npz",
                 **{f"{s}/{k}": v for s, b in enumerate(batches[arch])
                    for k, v in b.items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_TRAIN, str(out),
         json.dumps(TRAIN_RUNS), json.dumps(TRAIN), str(BATCH), str(STEPS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        checks = spawn("train", 4, out)
        _, err = ref.communicate(timeout=SPAWN_TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-4000:]
    jm, jp, tm, tp = pairs["qwen3-8b"]
    return {"out": out, "checks": checks, "tm": tm, "tp": tp,
            "batches": batches["qwen3-8b"], "pairs": pairs,
            "got": {n: load(out / f"train_{n}.pt") for n in TRAIN_RUNS}}


# -- placements -----------------------------------------------------------------

def test_placements_give_the_reference_shard_shapes(pods):
    want = json.loads((pods["out"] / "ref_shards.json").read_text())
    assert sorted(want) == sorted(ARCH_ORDER)
    for c in pods["checks"]:
        assert c["shard_shapes"] == want, c["rank"]


# -- the cross-pod FL round, pods on separate ranks -------------------------------

def test_fl_round_on_eight_ranks_matches_reference(pods):
    jp = jax.tree.map(jnp.asarray, pods["jp"])
    tcfg = JTrain(learning_rate=3e-3, warmup_steps=2, total_steps=64,
                  crosspod_compression="int8")
    odef = jax.tree.structure(jax.vmap(lambda p: jadamw_init(p, tcfg))(
        jax.tree.map(lambda a: jnp.stack([a, a]), jp)))
    for r, rec in enumerate(pods["rounds"]):
        ref = np.load(pods["out"] / f"ref_out{r}.npz")
        np.testing.assert_allclose(rec["loss"], float(ref["loss"]),
                                   rtol=METRIC_RTOL)
        a0 = _tree.leaves(rec["start"][2])
        wants = [ref[f"a{i}"] for i in range(len(a0))]
        top = max(float(np.abs(w).max()) for w in wants)
        for path, a, pre, got, want in zip(
                Z.ref_paths(jp), a0, _tree.leaves(rec["pre"]),
                _tree.leaves(rec["anchor"]), wants):
            level = float((pre.float() - a.float()[None]).abs().max()) / 127
            scale = top if any(w in path for w in FL_TREE_WIDE) else \
                float(np.abs(want).max())
            err = float(np.abs(got.numpy() - want).max())
            assert err <= level + Z.MODEL_RTOL * scale, (r, path, err)
        jopt = jax.tree.unflatten(odef, [ref[f"o{i}"] for i in
                                         range(odef.num_leaves)])
        Z.trees_match(rec["opt"].m, jopt.m, tree_wide=FL_TREE_WIDE)
        Z.trees_match(rec["opt"].v, jopt.v, tree_wide=FL_TREE_WIDE)
        assert rec["opt"].count.tolist() == np.asarray(
            jopt.count).tolist() == [4 * (r + 1)] * 2


def test_exchange_is_the_one_device_exchange(pods):
    """Bit for bit ``crosspod_mean`` of the gathered deltas (checked on
    every rank, and here again); its only payloads int8 over the pod
    group; each rank's shards its slices of the gathered trees."""
    for c in pods["checks"]:
        assert c["exchange_exact"] and c["shards_match_gathered"], c["rank"]
        assert c["exchange_gathers"] == [["torch.int8", 2]], c["rank"]
    for rec in pods["rounds"]:
        for a, pre, got in zip(_tree.leaves(rec["start"][2]),
                               _tree.leaves(rec["pre"]),
                               _tree.leaves(rec["anchor"])):
            want = (a.float() + crosspod_mean(a, pre, "int8")).to(a.dtype)
            assert torch.equal(got, want)
        for pod, a in zip(_tree.leaves(rec["pre"]),
                          _tree.leaves(rec["anchor"])):
            assert pod.shape[0] == 2 and a.shape == pod.shape[1:]


def test_f32_exchange_is_the_one_device_exchange(pods):
    """The f32 deltas all-gathered over ``pod`` and summed in pod order:
    bit for bit the one-device mean (a sum of two is exact either way)."""
    for c in pods["checks"]:
        assert c["f32_exchange_exact"], c["rank"]


def test_twin_on_eight_ranks_is_the_reference_mesh(pods):
    """The twin launched as 8 ranks takes the (2, 2, 2) mesh, its
    ``run_rounds`` equals the rounds done as their halves, and its
    ``main`` (8 rounds: loss falls, drift 0) passes on every rank."""
    losses = pods["checks"][0]["run_rounds_losses"]
    for c in pods["checks"]:
        assert c["backend"] == "gloo" and c["mesh"] == [2, 2, 2]
        assert c["run_rounds_equal_halves"] and c["twin_main"] == 0
        assert c["run_rounds_losses"] == losses
    assert losses == [rec["loss"] for rec in pods["rounds"]]


# -- checkpoints ------------------------------------------------------------------

def npz_members(path: Path) -> list:
    with zipfile.ZipFile(path) as z:
        return [(n, z.read(n)) for n in z.namelist()]


def test_checkpoint_saved_across_ranks_is_the_one_device_save(pods, tmp_path):
    out = pods["out"]
    whole = load(out / "ckpt_tree.pt")
    save_checkpoint(str(tmp_path), 1, whole)
    got, want = out / "ckpt" / "step_000000001", tmp_path / "step_000000001"
    assert (got / "manifest.json").read_bytes() == \
        (want / "manifest.json").read_bytes()
    assert npz_members(got / "arrays.npz") == npz_members(want / "arrays.npz")
    # the reference reads it
    jp = jax.tree.map(jnp.asarray, pods["jp"])
    stacked = jax.tree.map(lambda a: jnp.stack([a, a]), jp)
    tmpl = (stacked, jax.vmap(lambda p: jadamw_init(p, JTrain()))(stacked),
            jp)
    restored, step, _ = jload(str(out / "ckpt"), tmpl)
    assert step == 1
    for g, w in zip(jax.tree.leaves(restored), _tree.leaves(whole)):
        assert np.array_equal(np.asarray(g), w.numpy())


def test_checkpoint_restores_onto_new_placements(pods):
    """Saved from (2, 2, 2), restored on one device and onto a (4, 2)
    mesh's train plan (``shardings=``), every rank's shards its slices."""
    for c in pods["checks"]:
        assert c["restored_on_one_device"] and c["restored_shards_match"]
        pls = c["restored_placements"]
        assert ["S(0)", "S(1)"] in pls and ["S(1)", "S(0)"] in pls, pls


def test_checkpoint_manager_restores_onto_new_placements(pods):
    """``CheckpointManager`` saves the sharded tree (gathered, rank 0
    writes) and ``restore(shardings=)`` lays it out on the (4, 2) mesh."""
    for c in pods["checks"]:
        assert c["manager_restore"], c["rank"]


# -- the train step over (2, 2) ---------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_on_four_ranks_matches_one_device(train, microbatches):
    """3 steps on (2, 2) against the one-device step; with 2 microbatches
    the step casts its gradients to bf16, so one flipped bf16 ULP can
    show: those runs at 2^-8 (``tests/test_torch_train.py``)."""
    tm, tp = train["tm"], train["tp"]
    bar = Z.MODEL_RTOL if microbatches == 1 else BF16_ULP
    tcfg = TrainConfig(microbatches=microbatches, **TRAIN)
    b = bundle_for("train", tm.cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                   make_smoke_mesh("cpu"), SMOKE_MESH, tcfg)
    p, o, metrics = tp, adamw_init(tp, tcfg), []
    for step, batch in enumerate(train["batches"]):
        p, o, m = b.fn(p, o, Z.to_torch(batch), step)
        metrics.append({k: float(v) for k, v in m.items()})
    got = train["got"][f"mb{microbatches}"]
    for g, w in zip(got["metrics"], metrics):
        for k in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL)
    for g, w in zip(_tree.leaves((got["params"], got["opt"].m,
                                  got["opt"].v)),
                    _tree.leaves((p, o.m, o.v))):
        assert g.dtype == w.dtype
        Z.close(g, w, bar)
    assert int(got["opt"].count) == STEPS
    for c in train["checks"]:
        assert c["shards_match_gathered"]
        assert c["local_shapes"] == train["checks"][0]["local_shapes"]
    # FSDP over data, storage over model: the embedding (vocab, embed)
    # is cut on both, a quarter a rank
    assert [64, 32] in train["checks"][0]["local_shapes"]


@pytest.mark.parametrize("run", sorted(TRAIN_RUNS))
def test_train_step_on_four_ranks_matches_reference(train, run):
    """3 steps on (2, 2) over 4 ranks against the reference's jitted step
    on its Auto (2, 2) mesh, from the same parameters and batches. The
    MoE run's batch gives each data rank one whole routing group of the
    reference's (64 of 128 tokens), so both drop the same tokens."""
    arch, _, microbatches = TRAIN_RUNS[run]
    bar = Z.MODEL_RTOL if microbatches == 1 else BF16_ULP
    jp = jax.tree.map(jnp.asarray, train["pairs"][arch][1])
    tcfg = JTrain(microbatches=microbatches, **TRAIN)
    odef = jax.tree.structure(jadamw_init(jp, tcfg).m)
    ref = np.load(train["out"] / f"ref_{run}.npz")
    want = {t: jax.tree.unflatten(odef, [ref[f"{t}{i}"] for i in
                                         range(odef.num_leaves)])
            for t in "pmv"}
    metrics = json.loads((train["out"] / f"ref_{run}.json").read_text())
    got = train["got"][run]
    for g, w in zip(got["metrics"], metrics):
        for k in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL,
                                       err_msg=k)
    Z.trees_match(got["params"], want["p"], bar)
    Z.trees_match(got["opt"].m, want["m"], bar)
    Z.trees_match(got["opt"].v, want["v"], bar)
    assert int(got["opt"].count) == int(ref["count"]) == STEPS


def test_moe_groups_cut_by_a_shard_raise(train, pods):
    """An MoE batch whose shard on a rank would hold part of one of the
    whole batch's routing groups raises when the step is built (a train
    step at seq 16 or with 2 microbatches over data 2, an FL round's pod
    batch over data 2), where it would route otherwise than one device."""
    for c in train["checks"]:
        for k in ("moe_seq", "moe_microbatches"):
            assert "routing group" in (c["raised"][k] or ""), (k, c["raised"])
    for c in pods["checks"]:
        assert "routing group" in c.get("moe_fl_raised", ""), c["rank"]


def test_sharder_and_constrain_place_by_the_plan(pods):
    """On (2, 2, 2): ``Sharder`` lays a plain leaf and a DTensor of another
    layout out by the plan's spec (``place`` by it, each shard its slice),
    ``constrain`` the DTensor; ``constrain`` of a plain leaf raises."""
    for c in pods["checks"]:
        sh = c["sharder"]
        assert sh["specs"] == {"w": ["data", "model"],
                               "x": [["pod", "data"], None, "model"]}
        assert sh["plain"] and sh["dtensor"], c["rank"]
        assert "place it on a mesh" in sh["constrain_plain_raised"]


def test_optimizers_on_dtensor_leaves(train):
    """SGD on the (2, 2) plan's shards equals SGD on the full trees bit for
    bit (no clipping: the norm's shard sums only reorder the norm, held
    at rtol 1e-6)."""
    for c in train["checks"]:
        assert c["sgd_exact"] and c["sgd_count"] == 1
        got, want = c["gnorm"]
        np.testing.assert_allclose(got, want, rtol=1e-6)


# -- no quiet fallback ------------------------------------------------------------

def test_no_fallback(train):
    """A mesh of the wrong size or backend raises, while every arch's
    prefill and decode build on (2, 2) (``tests/test_torch_tensor_parallel.py``
    and ``tests/test_torch_tensor_parallel_recurrent.py`` run them)."""
    for c in train["checks"]:
        r = c["raised"]
        assert "needs 8 ranks" in r["world_size"], r
        assert "needs nccl" in r["cuda_on_gloo"], r
        assert "needs nccl" in r["init_cuda_on_gloo"], r
        for arch in ARCH_ORDER:
            for kind in ("prefill", "decode"):
                got = r[f"{arch}/{kind}"]
                assert got is None, (arch, kind, got)
    # no group here: a mesh of several devices cannot be made
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(MULTI_POD_MESH, "cpu")
