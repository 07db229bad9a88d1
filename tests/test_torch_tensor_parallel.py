"""Tensor-parallel compute over the ``model`` axis for the transformer
family, port against the JAX reference on the CPU: the train step, prefill
and decode on meshes over gloo ranks (``tests/torch_multidevice_worker.py``
scenarios ``tp`` and ``tp1``, which import no JAX), each rank multiplying
the shards the plan gives it (``sharding/tensor_parallel.py``).

One group of 4 ranks runs every case on (2, 2) and on (1, 4), each rank on
one thread, meeting through a file under ``tmp_path``; the reference runs
beside it in a subprocess, its steps jitted with their shardings on Auto
meshes of 4 host devices (``XLA_FLAGS`` set before jax is imported), from
the same parameters (the reference's smoke initialisation in f32) and
seeded numpy inputs. A group of one rank runs the same code where every
split is whole.

Bars:
- the train step: ``tests/test_torch_multidevice.py``'s, 3 steps, every
  leaf of the parameters and both moments at 1e-4 of its largest entry
  (``_torch_zoo.trees_match``), loss, gnorm and lr at rtol 1e-5, against
  the reference's jitted step on Auto (2, 2) (qwen3-8b, granite-moe,
  llama-3.2-vision) and Auto (1, 4) (qwen3-8b, whose 2 kv heads do not
  divide over 4: ``wk``/``wv`` gathered, rule 1), and (1, 4) against the
  port's one-device step too;
- the split: on every rank, each leaf the plan cuts over ``model`` runs
  split unless rule 1 gathers it (exactly the MoE routers on (2, 2); those
  and every ``wk``/``wv`` on (1, 4)); the parameters a rank computes with
  hold the leaves' bytes over their ``model`` split; every split weight
  reaches a matmul through its shard alone, a gathered ``wk``/``wv`` at the
  columns of the one kv head the rank's q head reads; inside the forward
  and backward no all-gather runs over ``model``, and partial sums are
  all-reduced there;
- prefill on (2, 2) (qwen3-8b, granite-moe, llama-3.2-vision,
  hubert-xlarge): the last position's logits within 1e-4 of the largest
  |logit| of the reference's jitted ``make_prefill_step``, each rank's
  shard of the shape ``NamedSharding(mesh, spec).shard_shape`` gives;
- decode: 8 steps from one cache (positions 10-17), each step's logits
  within 1e-4 of the largest |logit| of the reference's jitted
  ``make_decode_step`` on the Auto mesh of the same shape and of the
  port's one-device decode, the final cache at 1e-4 of each leaf's
  largest entry, and the logits' and cache's shards of the reference's
  shard shapes. On (2, 2) qwen3-8b, granite-moe and llama-3.2-vision (its
  cross blocks against the static image cache, their kv heads picked per
  rank), a cache of 32 positions (``seq_kv`` over ``model``: the steps
  cross the two ranks' halves); on (1, 4) qwen3-8b, whose 2 kv heads do
  not divide over 4 (``wk``/``wv`` gathered: every rank projects every kv
  head of the new token), with 32 positions (8 a rank: the rank that
  holds ``pos`` alone writes) and with 30 (``seq_kv`` does not divide:
  the cache is whole on every rank, and every rank writes);
- over a group of one rank, the train step, prefill and decode bit for bit
  the one-device code.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import _torch_zoo as Z  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.optim.optimizers import adamw_init as jadamw_init  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import (MeshConfig, ShapeConfig,  # noqa: E402
                                      TrainConfig)
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.step_builders import bundle_for  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.launch.step_builders import _tree_paths  # noqa: E402
from repro_torch.sharding import MeshPlan  # noqa: E402
from repro_torch.sharding.rules import is_axes_leaf, spec_axes  # noqa: E402
from repro_torch.sharding.tensor_parallel import TensorParallel  # noqa: E402

from test_torch_multidevice import spawn  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TRAIN = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)  # worker's
BATCH, SEQ, STEPS = 4, 16, 3
MOE, VLM, AUDIO = ("granite-moe-1b-a400m", "llama-3.2-vision-11b",
                   "hubert-xlarge")
TP_TRAIN = {"qwen3-8b": SEQ, MOE: 32, VLM: SEQ}
TRAIN_RUNS = {f"2x2/{a}": ((2, 2), a, s) for a, s in TP_TRAIN.items()}
TRAIN_RUNS["1x4/qwen3-8b"] = ((1, 4), "qwen3-8b", SEQ)
PREFILL = ("qwen3-8b", MOE, VLM, AUDIO)
SERVE_SEQ, SERVE_ROWS, DECODE_STEPS, POS0 = 32, 128, 8, 10
DECODE_RUNS = {f"2x2/{a}": ((2, 2), a, SERVE_SEQ)  # the worker's TP_DECODE
               for a in ("qwen3-8b", MOE, VLM)}
DECODE_RUNS["1x4/qwen3-8b"] = ((1, 4), "qwen3-8b", SERVE_SEQ)
DECODE_RUNS["1x4-seq30/qwen3-8b"] = ((1, 4), "qwen3-8b", 30)
METRIC_RTOL = 1e-5
SERVE_BAR = 1e-4
NAMES = ("data", "model")

# The reference's train, prefill and decode steps (bundle_for), jitted with
# their shardings on Auto meshes of 4 host devices, from the inputs the
# ranks take; and the shard shapes of the serving steps' outputs and cache.
REFERENCE = r"""
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

d, spec = sys.argv[1], json.loads(sys.argv[2])
names = ("data", "model")


def f32(arch):
    name, *sets = arch.split("@")  # arch@field=n: a variant of the config
    fields = {k: int(v) for k, v in (x.split("=") for x in sets)}
    return dataclasses.replace(smoke_config(name), dtype="float32",
                               param_dtype="float32", **fields)


def mesh_of(shape):
    return (jax.make_mesh(tuple(shape), names,
                          axis_types=(AxisType.Auto,) * 2),
            MeshConfig(tuple(shape), names))


def jitted(b):
    return jax.jit(b.fn, in_shardings=b.in_shardings,
                   out_shardings=b.out_shardings)


def params_of(b, arch):
    pdef = jax.tree.structure(b.abstract_state["params"])
    z = np.load(os.path.join(d, f"ref_params_{arch}.npz"))
    return jax.tree.unflatten(pdef, [jnp.asarray(z[f"p{i}"])
                                     for i in range(pdef.num_leaves)])


shapes = {}
for key, (shape, arch, seq) in spec["train"].items():
    mesh, mcfg = mesh_of(shape)
    tcfg = TrainConfig(**spec["tcfg"])
    b = bundle_for("train", f32(arch),
                   ShapeConfig("t", seq, spec["batch"], "train"), mesh, mcfg,
                   tcfg)
    fn, params = jitted(b), params_of(b, arch)
    opt = adamw_init(params, tcfg)
    bz = np.load(os.path.join(d, f"batches_{arch}.npz"))
    metrics = []
    name = key.replace("/", "_")

    def state(params, opt):
        return {f"{t}{i}": np.asarray(l) for t, tree in
                (("p", params), ("m", opt.m), ("v", opt.v))
                for i, l in enumerate(jax.tree.leaves(tree))}

    with mesh:
        for s in range(spec["steps"]):
            bt = {k.split("/", 1)[1]: jnp.asarray(bz[k]) for k in bz.files
                  if k.startswith(f"{s}/")}
            params, opt, m = fn(params, opt, bt, jnp.int32(s))
            metrics.append({k: float(v) for k, v in m.items()})
            if spec.get("states") and s + 1 < spec["steps"]:
                # the state after each step, for steps run again from it
                tmp = os.path.join(d, f"tmp_{name}.npz")
                np.savez(tmp, count=np.asarray(opt.count),
                         **state(params, opt))
                os.replace(tmp, os.path.join(
                    d, f"ref_state_{name}_{s + 1}.npz"))
    out = state(params, opt)
    np.savez(os.path.join(d, f"ref_train_{name}.npz"),
             count=np.asarray(opt.count), **out)
    with open(os.path.join(d, f"ref_train_{name}.json"), "w") as f:
        json.dump(metrics, f)

mesh, mcfg = mesh_of((2, 2))
for arch in spec["prefill"]:
    b = bundle_for("prefill", f32(arch),
                   ShapeConfig("p", spec["seq"], spec["batch"], "prefill"),
                   mesh, mcfg)
    z = np.load(os.path.join(d, f"prefill_{arch}.npz"))
    with mesh:
        out = jitted(b)(params_of(b, arch),
                        {k: jnp.asarray(z[k]) for k in z.files})
    np.save(os.path.join(d, f"ref_prefill_{arch}.npy"), np.asarray(out))
    shapes[f"prefill/{arch}"] = list(b.out_shardings.shard_shape(out.shape))
for key, (shape, arch, seq) in spec["decode"].items():
    mesh, mcfg = mesh_of(shape)
    b = bundle_for("decode", f32(arch),
                   ShapeConfig("d", seq, spec["rows"], "decode"), mesh, mcfg)
    fn, params = jitted(b), params_of(b, arch)
    cdef = jax.tree.structure(b.abstract_state["cache"])
    name = key.replace("/", "_")
    z = np.load(os.path.join(d, f"decode_{name}.npz"))
    cache = jax.tree.unflatten(cdef, [jnp.asarray(z[f"c{i}"])
                                      for i in range(cdef.num_leaves)])
    logits = []
    with mesh:
        for i in range(spec["decode_steps"]):
            lg, cache = fn(params, cache, {
                "tokens": jnp.asarray(z["tokens"][:, i:i + 1]),
                "pos": jnp.int32(int(z["pos0"]) + i)})
            logits.append(np.asarray(lg))
    np.savez(os.path.join(d, f"ref_decode_{name}.npz"),
             logits=np.stack(logits),
             **{f"c{i}": np.asarray(l)
                for i, l in enumerate(jax.tree.leaves(cache))})
    shapes[f"decode/{key}"] = {
        "logits": list(b.out_shardings[0].shard_shape(logits[0].shape)),
        "cache": [list(s.shard_shape(tuple(l.shape))) for s, l in zip(
            jax.tree.leaves(b.in_shardings[1]),
            jax.tree.leaves(b.abstract_state["cache"]))]}
with open(os.path.join(d, "ref_shapes.json"), "w") as f:
    json.dump(shapes, f)
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This process's torch on one thread, beside XLA's pool and the
    spawned ranks (as ``tests/test_torch_multidevice.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def variant(arch):
    """``arch`` and the config fields an ``arch@field=n@...`` name sets (a
    variant of its smoke config)."""
    name, *sets = arch.split("@")
    return name, {k: int(v) for k, v in (x.split("=") for x in sets)}


def f32_smoke(arch):
    name, fields = variant(arch)
    return dataclasses.replace(smoke_config(name), dtype="float32",
                               param_dtype="float32", **fields)


def decode_inputs(cfg, seed, seq):
    """A cache of ``seq`` positions holding random k and v at positions <
    POS0 (zeros past them) and the tokens of the decode steps."""
    rng = np.random.default_rng(seed)
    spec = build_model(cfg, device="meta").cache_spec(SERVE_ROWS, seq)
    leaves = []
    for l in _tree.leaves(spec):
        a = np.zeros(tuple(l.shape), np.float32)
        a[:, :, :POS0] = rng.normal(size=a[:, :, :POS0].shape)
        leaves.append(a)
    tokens = rng.integers(0, cfg.vocab_size, (SERVE_ROWS, DECODE_STEPS))
    return leaves, tokens.astype(np.int32)


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """The 4-rank group's findings and the reference's, from the same
    inputs (the reference's subprocess runs beside the ranks)."""
    out = tmp_path_factory.mktemp("tp")
    pairs = {}
    for arch in dict.fromkeys(list(TP_TRAIN) + list(PREFILL)):
        jm, jp, tm, tparams = pairs[arch] = Z.pair(arch)
        torch.save(tparams, out / f"params_{arch}.pt")
        np.savez(out / f"ref_params_{arch}.npz",
                 **{f"p{i}": l for i, l in enumerate(jax.tree.leaves(jp))})
        if arch in TP_TRAIN:
            np.savez(out / f"batches_{arch}.npz", **{
                f"{s}/{k}": v for s in range(STEPS) for k, v in Z.batch(
                    tm.cfg, 40 + s, BATCH, TP_TRAIN[arch]).items()})
        prompts = Z.batch(tm.cfg, 70, BATCH, SERVE_SEQ)
        del prompts["targets"]
        np.savez(out / f"prefill_{arch}.npz", **prompts)
    for key, (_, arch, seq) in DECODE_RUNS.items():
        leaves, tokens = decode_inputs(pairs[arch][2].cfg, 80, seq)
        np.savez(out / f"decode_{key.replace('/', '_')}.npz", tokens=tokens,
                 pos0=POS0, **{f"c{i}": l for i, l in enumerate(leaves)})
    spec = {"train": TRAIN_RUNS, "prefill": PREFILL, "decode": DECODE_RUNS,
            "tcfg": TRAIN, "batch": BATCH, "steps": STEPS, "seq": SERVE_SEQ,
            "rows": SERVE_ROWS, "decode_steps": DECODE_STEPS}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(out), json.dumps(spec)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        checks = spawn("tp", 4, out)
        _, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-4000:]
    return {"out": out, "checks": checks, "pairs": pairs,
            "shapes": json.loads((out / "ref_shapes.json").read_text())}


def load(path: Path):
    return torch.load(path, weights_only=False)


def reference_train(tp, key, arch=None):
    """The reference's parameters, moments, metrics and step count after
    the train run ``key`` (of ``arch``: by default ``TRAIN_RUNS``')."""
    arch = arch or TRAIN_RUNS[key][1]
    jp = jax.tree.map(jnp.asarray, tp["pairs"][arch][1])
    odef = jax.tree.structure(jadamw_init(jp, JTrain(**TRAIN)).m)
    name = key.replace("/", "_")
    ref = np.load(tp["out"] / f"ref_train_{name}.npz")
    want = {t: jax.tree.unflatten(odef, [ref[f"{t}{i}"] for i in
                                         range(odef.num_leaves)])
            for t in "pmv"}
    metrics = json.loads((tp["out"] / f"ref_train_{name}.json").read_text())
    return want, metrics, int(ref["count"])


# -- (a), (b) the train step --------------------------------------------------

@pytest.mark.parametrize("key", sorted(TRAIN_RUNS))
def test_train_step_matches_reference(tp, key):
    """3 steps over 4 ranks, the matmuls split over ``model``, against the
    reference's jitted step on its Auto mesh of the same shape."""
    want, metrics, count = reference_train(tp, key)
    got = load(tp["out"] / f"tp_train_{key.replace('/', '_')}.pt")
    for g, w in zip(got["metrics"], metrics):
        for k in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL,
                                       err_msg=k)
    Z.trees_match(got["params"], want["p"])
    Z.trees_match(got["opt"].m, want["m"])
    Z.trees_match(got["opt"].v, want["v"])
    assert int(got["opt"].count) == count == STEPS
    for c in tp["checks"]:
        assert c["shards_match_gathered"], c["rank"]


def test_train_step_on_1x4_matches_one_device(tp):
    """qwen3-8b on (1, 4), its kv projections gathered (2 kv heads over 4
    ranks), against the port's one-device step from the same state."""
    jm, jp, tm, tparams = tp["pairs"]["qwen3-8b"]
    tcfg = TrainConfig(**TRAIN)
    one = Mesh(NAMES, (1, 1), torch.device("cpu"))
    b = bundle_for("train", tm.cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                   one, MeshConfig((1, 1), NAMES), tcfg)
    p, o, metrics = tparams, adamw_init(tparams, tcfg), []
    bz = np.load(tp["out"] / "batches_qwen3-8b.npz")
    for step in range(STEPS):
        batch = {k.split("/", 1)[1]: torch.from_numpy(bz[k]) for k in bz.files
                 if k.startswith(f"{step}/")}
        p, o, m = b.fn(p, o, batch, step)
        metrics.append({k: float(v) for k, v in m.items()})
    got = load(tp["out"] / "tp_train_1x4_qwen3-8b.pt")
    for g, w in zip(got["metrics"], metrics):
        for k in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL,
                                       err_msg=k)
    for g, w in zip(_tree.leaves((got["params"], got["opt"].m,
                                  got["opt"].v)),
                    _tree.leaves((p, o.m, o.v))):
        Z.close(g, w, Z.MODEL_RTOL)


# -- (c) the split is real ----------------------------------------------------

def rule_one(paths, cfg, p: int) -> set:
    """The leaves rule 1 runs whole over a ``model`` group of ``p``: every
    leaf of an attention block whose heads do not divide over it,
    ``wk``/``wv`` where the kv heads do not, every MoE router."""
    whole = set()
    for path in paths:
        *_, block, name = path.split("/")
        if block in ("attn", "xattn") and (
                cfg.num_heads % p or (cfg.num_kv_heads % p
                                      and name in ("wk", "wv"))):
            whole.add(path)
        if block == "moe" and name == "router":
            whole.add(path)
    return whole


def plan_cuts(cfg, shape):
    """-> ({path: the dim the plan cuts over ``model``} for every leaf it
    cuts so on ``shape``, {path: full shape} for every leaf)."""
    model = build_model(cfg, device="meta")
    plan = MeshPlan(MeshConfig(shape, NAMES))
    axes = _tree.flatten(model.param_axes(), is_axes_leaf)[0]
    shapes = _tree.leaves(model.param_shapes())
    cuts, full = {}, {}
    for path, a, s in zip(_tree_paths(model.param_axes()), axes, shapes):
        full[path] = list(s.shape)
        dims = [i for i, e in enumerate(plan.spec(a, tuple(s.shape)))
                if "model" in spec_axes(e)]
        if dims:
            cuts[path] = dims[0]
    return cuts, full


SPLIT_RUNS = ("2x2/qwen3-8b", "2x2/" + MOE, "1x4/qwen3-8b")


@pytest.mark.parametrize("key", SPLIT_RUNS)
def test_split_is_real(tp, key):
    shape, arch, _ = TRAIN_RUNS[key]
    cfg = f32_smoke(arch)
    p = shape[1]
    cuts, full = plan_cuts(cfg, shape)
    whole = rule_one(cuts, cfg, p)
    want_bytes = 4 * sum(math.prod(s) // (1 if path in whole or path not in
                                          cuts else p)
                         for path, s in full.items())
    for c in tp["checks"]:
        rec = c["split"][key]
        assert sorted(rec["record"]["gathered"]) == sorted(whole), rec
        assert sorted(rec["record"]["split"]) == sorted(set(cuts) - whole)
        for path, s in full.items():
            s = list(s)
            if path in cuts and path not in whole:
                s[cuts[path]] //= p
            assert rec["run_shapes"][path] == s, (c["rank"], path)
        assert rec["run_bytes"] == want_bytes, c["rank"]
        ops = rec["operands"]
        for path in set(cuts) - whole:
            if path == "embed/embedding" and not cfg.tie_embeddings:
                continue  # a lookup, no matmul
            layer = math.prod(full[path]) // p // (
                full[path][0] if path.startswith("seg") else 1)
            assert ops.get(path), (c["rank"], path, "reaches no matmul")
            assert max(ops[path]) <= layer, (c["rank"], path, ops[path])
        for path in whole - {q for q in whole if q.endswith("router")}:
            # a gathered wk / wv: the columns of the kv head it reads
            assert set(ops[path]) == {cfg.d_model * cfg.head_dim}, (
                c["rank"], path, ops[path])
        calls = rec["calls"]
        assert not any(k.startswith("all_gather") for k in calls), calls
        assert calls.get("all_reduce", 0) > 0, calls


# -- (d) prefill, (e) decode --------------------------------------------------

@pytest.mark.parametrize("arch", PREFILL)
def test_prefill_matches_reference(tp, arch):
    want = np.load(tp["out"] / f"ref_prefill_{arch}.npy")
    got = load(tp["out"] / f"tp_prefill_{arch}.pt")
    Z.within(got, want, SERVE_BAR)
    for c in tp["checks"]:
        assert c["prefill_shapes"][arch] == \
            tp["shapes"][f"prefill/{arch}"], c["rank"]


def one_device_decode(tm, tparams, z, seq):
    """The port's decode on one device from the same cache and tokens."""
    leaves, treedef = _tree.flatten(tm.cache_spec(SERVE_ROWS, seq))
    cache = _tree.unflatten(treedef, [torch.from_numpy(z[f"c{i}"]).clone()
                                      for i in range(len(leaves))])
    b = bundle_for("decode", tm.cfg, ShapeConfig(
        "d", seq, SERVE_ROWS, "decode"), Mesh(
        NAMES, (1, 1), torch.device("cpu")), MeshConfig((1, 1), NAMES))
    logits = []
    for i in range(DECODE_STEPS):
        lg, cache = b.fn(tparams, cache, {
            "tokens": torch.from_numpy(z["tokens"][:, i:i + 1]),
            "pos": POS0 + i})
        logits.append(lg)
    return logits, cache


@pytest.mark.parametrize("key", sorted(DECODE_RUNS))
def test_decode_matches_reference_and_one_device(tp, key):
    (_, p), arch, seq = DECODE_RUNS[key]
    name = key.replace("/", "_")
    z = np.load(tp["out"] / f"decode_{name}.npz")
    ref = np.load(tp["out"] / f"ref_decode_{name}.npz")
    got = load(tp["out"] / f"tp_decode_{name}.pt")
    _, _, tm, tparams = tp["pairs"][arch]
    one, one_cache = one_device_decode(tm, tparams, z, seq)
    for i in range(DECODE_STEPS):
        Z.within(got["logits"][i], ref["logits"][i], SERVE_BAR)
        Z.within(got["logits"][i], one[i], SERVE_BAR)
    for i, (g, o) in enumerate(zip(_tree.leaves(got["cache"]),
                                   _tree.leaves(one_cache))):
        Z.close(g, ref[f"c{i}"], SERVE_BAR)
        Z.close(g, o, SERVE_BAR)
    want = tp["shapes"][f"decode/{key}"]
    for c in tp["checks"]:
        assert c["decode_shapes"][key] == want, c["rank"]
    # the self-attention cache's positions split over model where they
    # divide; the cross blocks' image cache whole
    spec = tm.cache_spec(SERVE_ROWS, seq)
    for path, full, s in zip(_tree_paths(spec), _tree.leaves(spec),
                             want["cache"]):
        n = full.shape[2]
        split = path.rsplit("/", 1)[-1] in ("k", "v") and n % p == 0
        assert s[2] == (n // p if split else n), (path, want)


# -- one rank -----------------------------------------------------------------

def test_one_rank_is_bit_for_bit_one_device(tmp_path):
    """The tensor-parallel code over a group of one rank (every split
    whole, every collective a one-rank call): the train step (qwen3-8b,
    granite-moe, zamba2, xLSTM), prefill and 8 decode steps (qwen3-8b,
    zamba2, xLSTM) bit for bit the one-device code from the same state."""
    (c,) = spawn("tp1", 1, tmp_path)
    recurrent = ("zamba2-1.2b", "xlstm-1.3b")
    want = {f"train/{a}": True for a in ("qwen3-8b", MOE) + recurrent}
    want.update({f"{k}/{a}": True for k in ("prefill", "decode")
                 for a in ("qwen3-8b",) + recurrent})
    assert c["same"] == want, c["same"]


# -- rule 1 at full width, no ranks -------------------------------------------

def test_rule_one_at_full_width():
    """On 16 ``model`` ranks: qwen3-8b's 8 kv heads do not divide (the plan
    still cuts ``wk`` into half heads), so ``wk``/``wv`` run whole;
    llama4-maverick's 40 q heads do not, so its attention runs whole;
    granite-moe's 32 experts split, its router and (8 kv heads) its
    ``wk``/``wv`` run whole; zamba2 runs every block split (64 SSM heads);
    xLSTM's 4 heads do not divide, so its sLSTM cells run whole."""
    def whole_paths(arch):
        model = build_model(get_config(arch), device="meta")
        return {p for p, w in zip(_tree_paths(model.param_axes()),
                                  _tree.leaves(model.tp_whole(16))) if w}

    assert whole_paths("qwen3-8b") == {"seg0/b0_self/attn/wk",
                                       "seg0/b0_self/attn/wv"}
    llama4 = whole_paths("llama4-maverick-400b-a17b")
    assert {p.rsplit("/", 1)[-1] for p in llama4 if "/attn/" in p} == {
        "wq", "wk", "wv", "wo"}
    assert any(p.endswith("moe/router") for p in llama4)
    assert whole_paths(MOE) == {"seg0/b0_moe/moe/router",
                                "seg0/b0_moe/attn/wk", "seg0/b0_moe/attn/wv"}
    cfg = get_config("qwen3-8b")
    plan = MeshPlan(MeshConfig((16, 16), NAMES))
    spec = plan.spec(("layers", "embed", "kv_heads"), (36, 4096, 8 * 128))
    assert spec == (None, "data", "model")  # 64 columns a rank: half a head
    assert cfg.num_kv_heads % 16
    # zamba2: 64 SSM heads, 32 q and kv heads: every block splits, and
    # w_in's plan cut (524 of its 8,384 packed columns a rank) is re-cut
    # to the rank's 4 heads' z, x and dt plus B and C
    assert whole_paths("zamba2-1.2b") == set()
    assert plan.spec(("layers", "layers", "embed", "ssm_inner"),
                     (6, 6, 2048, 8384)) == (None, None, "data", "model")
    # xLSTM: 4 heads do not divide over 16, so the sLSTM blocks but their
    # ffn run whole; the mLSTM blocks split over their channels, their
    # decode state by the key dim (1024 / 16 rows of C a rank)
    xl = whole_paths("xlstm-1.3b")
    assert xl == {f"slstm/{n}" for n in ("ln", "conv", "w_gates", "r_gates",
                                          "b_gates", "out_norm", "ln_ffn")}
    xmodel = build_model(get_config("xlstm-1.3b"), device="meta")
    c_axes = xmodel.cache_axes()["mlstm"]["C"]
    c_shape = tuple(xmodel.cache_spec(8, 64)["mlstm"]["C"].shape)
    assert c_shape[-2:] == (1024, 1024)
    assert plan.spec(c_axes, c_shape)[4] == "model"


@pytest.mark.parametrize("heads,kv,p,rank,want", [
    (32, 8, 16, 5, slice(2, 3)),      # qwen3-8b on 16: 2 q heads, 1 kv head
    (4, 2, 4, 3, slice(1, 2)),        # the smoke config on (1, 4)
    (8, 4, 2, 1, slice(2, 4)),        # kv heads that divide: its own
    (12, 4, 3, 0, [0, 0, 0, 1]),      # 4 q heads over 2 kv heads unevenly
])
def test_kv_heads_a_rank_reads(heads, kv, p, rank, want):
    cfg = dataclasses.replace(smoke_config("qwen3-8b"), num_heads=heads,
                              num_kv_heads=kv)
    tp = TensorParallel(None, rank, p)
    assert L._kv_heads(cfg, tp, kv % p == 0) == want
