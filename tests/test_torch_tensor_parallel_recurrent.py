"""Tensor-parallel compute over the ``model`` axis for the recurrent
families (zamba2, xLSTM), port against the JAX reference on the CPU: the
train step, prefill and decode on meshes over gloo ranks
(``tests/torch_multidevice_worker.py`` scenario ``tpr``, which imports no
JAX), each rank multiplying its heads' or key-dim shards
(``models/zamba.py``, ``models/xlstm.py``,
``sharding/tensor_parallel.py``).

One group of 4 ranks runs every case on (2, 2) and on (1, 4), each rank on
one thread, meeting through a file under ``tmp_path``; the reference runs
beside it in a subprocess (``tests/test_torch_tensor_parallel.py``'s
script), its steps jitted with their shardings on Auto meshes of 4 host
devices, from the same parameters (the reference's smoke initialisation
in f32) and seeded numpy inputs.

Bars:
- the train step, 3 steps on (2, 2) and (1, 4): loss, gnorm and lr at
  rtol 1e-5, the final state at 1e-4 of the tree's largest entry; each
  step again from the reference's state before it, every leaf of the
  parameters and both moments at 1e-4 of its largest entry (rtol 1e-4,
  as ``_torch_zoo.trees_match``), zamba's LoRA leaves (their first
  gradient is zero: AdamW's step there is its eps's) at 1e-4 of the
  tree's largest, and a parameter entry whose f64 gradient lies within
  1e-5 of its leaf's largest of zero within the step's lr (chip_smoke's
  phase 15 rule: on (1, 4) one of xLSTM's ``w_up`` entries has a
  gradient of 1.7e-8 on one device and 5.8e-9 split, of a leaf's 0.134,
  and AdamW's eps turns that into 26 % of a step, which the chained run
  carries into every leaf); the first step's gradient over the ranks,
  every leaf within 1e-5 of its largest entry of the one-device f64
  gradient, as the one-device f32 gradient is;
- the split: on every rank, every leaf the plan cuts over ``model`` runs
  split but those rule 1 gathers (none in the smoke configs, whose heads
  divide over 2 and 4; on (1, 4) two variants whose heads do not: xLSTM
  with 2 heads, its sLSTM cells whole and its mLSTM cell whole from
  gathered activations, and zamba2 with 2 SSM heads, its Mamba blocks
  whole; they run the train step and decode), each held as its shard; the packed leaves (Mamba's ``w_in`` and
  ``conv``, mLSTM's ``w_up``, sLSTM's ``w_gates``) are re-cut to the
  rank's heads' columns (plus Mamba's B and C) and no other leaf is
  gathered over ``model``; every matmul operand of a leaf is at most its
  shard of one layer, or the re-cut columns;
- prefill on (2, 2): the last position's logits within 1e-4 of the
  largest |logit| of the reference's jitted ``make_prefill_step``, each
  rank's shard of the shape ``NamedSharding(mesh, spec).shard_shape``
  gives; the collectives over ``model`` of prefill at 16 and at 32
  positions the same in number (none inside the sLSTM's time loop or any
  other loop over positions);
- decode, 8 steps on (2, 2) and (1, 4) from a state the reference's
  one-device ``decode_step`` built over 10 seeded tokens from
  ``init_cache``: each step's logits within 1e-4 of the largest |logit|
  of the reference's jitted ``make_decode_step`` and of the port's
  one-device decode, the final state at 1e-4 of each leaf's largest
  entry, every state shard of the reference's shard shape, and no tensor
  sent over ``model`` in a step of a layer's state shard's shape.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import _torch_zoo as Z  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.launch.step_builders import (_tree_paths,  # noqa: E402
                                              value_and_grad)
from repro_torch.models import build_model  # noqa: E402

from test_torch_multidevice import spawn  # noqa: E402
from test_torch_tensor_parallel import (BATCH, DECODE_STEPS,  # noqa: E402
                                        METRIC_RTOL, POS0, REFERENCE, ROOT,
                                        SEQ, SERVE_BAR, SERVE_ROWS,
                                        SERVE_SEQ, STEPS, TRAIN, f32_smoke,
                                        load, one_device_decode, plan_cuts,
                                        reference_train, variant)

# the ranks and the reference each take ~2 minutes alone, and twice that
# beside the rest of the suite on its workers
SPAWN_TIMEOUT = 600
ZAMBA, XLSTM = "zamba2-1.2b", "xlstm-1.3b"
ARCHS = (ZAMBA, XLSTM)
# variants whose heads do not divide over 4 (rule 1: xLSTM's 2 heads, its
# sLSTM cells whole, its mLSTM cell whole from gathered activations;
# zamba2's 2 SSM heads, its Mamba blocks whole), run on (1, 4)
RULE_ONE = (f"{XLSTM}@num_heads=2@num_kv_heads=2",
            f"{ZAMBA}@ssm_head_dim=64")
RUNS = {(2, 2): ARCHS, (1, 4): ARCHS + RULE_ONE}  # the worker's TPR_TRAIN
TRAIN_RUNS = {f"{s[0]}x{s[1]}/{a}": (s, a, SEQ) for s, archs in RUNS.items()
              for a in archs}
DECODE_RUNS = {f"{s[0]}x{s[1]}/{a}": (s, a, SERVE_SEQ)
               for s, archs in RUNS.items() for a in archs}
BAR = Z.MODEL_RTOL  # 1e-4
GRAD_BAR = 1e-5
# AdamW's eps trap: zamba's LoRA leaves, whose first gradient is zero
TREE_WIDE = {ZAMBA: ("lora/",)}
# the leaves whose columns a rank multiplies are not its plan cut's
RECUT = {ZAMBA: ("mamba/w_in", "mamba/conv", "tail/w_in", "tail/conv"),
         XLSTM: ("mlstm/w_up", "slstm/w_gates")}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This process's torch on one thread, beside XLA's pool and the
    spawned ranks (as ``tests/test_torch_multidevice.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair(arch):
    """``_torch_zoo.pair`` in f32 for ``arch`` or a variant of it."""
    name, fields = variant(arch)
    return Z.pair_of(dataclasses.replace(Z.f32(jsmoke(name)), **fields),
                     f32_smoke(arch))


def built_state(jm, jp, vocab: int, seq: int, seed: int):
    """A decode state of ``seq`` positions that the reference's one-device
    ``decode_step`` built over POS0 seeded tokens from ``init_cache``
    (its leaves as numpy), and the tokens of the next DECODE_STEPS."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (SERVE_ROWS, POS0 + DECODE_STEPS)
                          ).astype(np.int32)
    step = jax.jit(jm.decode_step)
    params = jax.tree.map(jnp.asarray, jp)
    cache = jm.init_cache(SERVE_ROWS, seq)
    for pos in range(POS0):
        _, cache = step(params, cache, {
            "tokens": jnp.asarray(tokens[:, pos:pos + 1]),
            "pos": jnp.int32(pos)})
    return [np.asarray(l) for l in jax.tree.leaves(cache)], tokens[:, POS0:]


@pytest.fixture(scope="module")
def tpr(tmp_path_factory):
    """The 4-rank group's findings and the reference's, from the same
    inputs (the reference's subprocess runs beside the ranks)."""
    out = tmp_path_factory.mktemp("tpr")
    pairs = {}
    for arch in ARCHS + RULE_ONE:
        jm, jp, tm, tparams = pairs[arch] = pair(arch)
        torch.save(tparams, out / f"params_{arch}.pt")
        np.savez(out / f"ref_params_{arch}.npz",
                 **{f"p{i}": l for i, l in enumerate(jax.tree.leaves(jp))})
        np.savez(out / f"batches_{arch}.npz", **{
            f"{s}/{k}": v for s in range(STEPS)
            for k, v in Z.batch(tm.cfg, 40 + s, BATCH, SEQ).items()})
        prompts = Z.batch(tm.cfg, 70, BATCH, SERVE_SEQ)
        del prompts["targets"]
        np.savez(out / f"prefill_{arch}.npz", **prompts)
    states = {}  # one state an arch and cache length, for either mesh
    for key, (_, arch, seq) in DECODE_RUNS.items():
        jm, jp, tm, _ = pairs[arch]
        if (arch, seq) not in states:
            states[arch, seq] = built_state(jm, jp, tm.cfg.vocab_size, seq,
                                            80)
        leaves, tokens = states[arch, seq]
        np.savez(out / f"decode_{key.replace('/', '_')}.npz", tokens=tokens,
                 pos0=POS0, **{f"c{i}": l for i, l in enumerate(leaves)})
    spec = {"train": TRAIN_RUNS, "prefill": ARCHS, "decode": DECODE_RUNS,
            "tcfg": TRAIN, "batch": BATCH, "steps": STEPS, "seq": SERVE_SEQ,
            "rows": SERVE_ROWS, "decode_steps": DECODE_STEPS, "states": True}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(out), json.dumps(spec)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        checks = spawn("tpr", 4, out, timeout=SPAWN_TIMEOUT)
        _, err = ref.communicate(timeout=SPAWN_TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-4000:]
    return {"out": out, "checks": checks, "pairs": pairs,
            "shapes": json.loads((out / "ref_shapes.json").read_text())}


# -- the train step -----------------------------------------------------------

def f64_gradient(arch, params, batch):
    """The port's one-device gradient of ``arch`` in f64 at ``params``
    (a tree of tensors) on ``batch``."""
    f64 = dataclasses.replace(f32_smoke(arch), dtype="float64",
                              param_dtype="float64")
    return value_and_grad(build_model(f64, device="cpu"),
                          _tree.map(lambda x: x.double(), params), batch)[1]


def train_batch(tpr, arch, step: int) -> dict:
    bz = np.load(tpr["out"] / f"batches_{arch}.npz")
    return {k.split("/", 1)[1]: torch.from_numpy(bz[k]) for k in bz.files
            if k.startswith(f"{step}/")}


def reference_states(tpr, key) -> list:
    """The reference's chained run's state after each step, as flat lists
    of numpy leaves: [{"p": [...], "m": [...], "v": [...]}, ...]."""
    name = key.replace("/", "_")
    files = [tpr["out"] / f"ref_state_{name}_{k}.npz"
             for k in range(1, STEPS)] + [tpr["out"] / f"ref_train_{name}.npz"]
    out = []
    for f in files:
        z = np.load(f)
        n = sum(1 for k in z.files if k.startswith("p"))
        out.append({t: [z[f"{t}{i}"] for i in range(n)] for t in "pmv"})
    return out


def leaves_within(got, want, paths, wide=(), near=None, lr=None):
    """Each leaf at rtol BAR with an atol of BAR times its largest entry
    (a leaf whose path holds one of ``wide``: the tree's largest), as
    ``_torch_zoo.trees_match`` holds them; an entry ``near`` marks is
    held within ``lr`` instead."""
    top = max(float(np.abs(w).max()) for w in want)
    for i, (path, g, w) in enumerate(zip(paths, got, want)):
        g, w = Z.as_f32(g), Z.as_f32(w)
        scale = top if any(t in path for t in wide) else float(
            np.abs(w).max())
        diff = np.abs(g - w)
        if near is not None:
            assert (diff[near[i]] <= lr).all(), (path, "near-zero gradient")
            diff = np.where(near[i], 0.0, diff)
        worst = float((diff - BAR * np.abs(w)).max())
        assert worst <= BAR * scale, (path, worst, BAR * scale)


@pytest.mark.parametrize("key", sorted(TRAIN_RUNS))
def test_train_step_matches_reference(tpr, key):
    """3 steps over 4 ranks, the recurrent blocks split over ``model``,
    against the reference's jitted step on its Auto mesh of the same
    shape: the chained run's loss, gnorm and lr at rtol 1e-5 and its final
    state at BAR of the tree's largest entry; each step again from the
    reference's state before it, every leaf of the parameters and both
    moments at BAR of its largest entry (zamba's LoRA leaves, whose first
    gradient is zero, at the tree's largest), but a parameter entry whose
    f64 gradient there lies within GRAD_BAR of its leaf's largest of zero,
    held within the step's lr: AdamW's eps-sized denominator turns that
    gradient's f32 noise into a share of a step on any two f32 runs, and
    a chained run carries it into every later step."""
    arch = TRAIN_RUNS[key][1]
    want, metrics, count = reference_train(
        {"out": tpr["out"], "pairs": tpr["pairs"]}, key, arch)
    got = load(tpr["out"] / f"tp_train_{key.replace('/', '_')}.pt")
    for g, w in zip(got["metrics"], metrics):
        for k in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL,
                                       err_msg=k)
    for t, tree in (("p", got["params"]), ("m", got["opt"].m),
                    ("v", got["opt"].v)):
        Z.trees_match(tree, want[t], tree_wide=("",))
    assert int(got["opt"].count) == count == STEPS
    for c in tpr["checks"]:
        assert c["shards_match_gathered"], c["rank"]
    _, _, tm, tparams = tpr["pairs"][arch]
    paths = _tree_paths(tm.param_axes())
    treedef = _tree.flatten(tparams)[1]
    steps = load(tpr["out"] / f"tp_steps_{key.replace('/', '_')}.pt")
    before = tparams
    wide = TREE_WIDE.get(variant(arch)[0], ())
    for k, (after, (p2, o2)) in enumerate(zip(reference_states(tpr, key),
                                              steps)):
        g64 = _tree.leaves(f64_gradient(arch, before, train_batch(
            tpr, arch, k)))
        near = [(g.abs() <= GRAD_BAR * float(g.abs().max())).numpy()
                for g in g64]
        leaves_within(_tree.leaves(p2), after["p"], paths, wide, near,
                      metrics[k]["lr"])
        leaves_within(_tree.leaves(o2.m), after["m"], paths, wide)
        leaves_within(_tree.leaves(o2.v), after["v"], paths, wide)
        before = _tree.unflatten(treedef, [torch.from_numpy(x)
                                           for x in after["p"]])


@pytest.mark.parametrize("key", sorted(TRAIN_RUNS))
def test_split_gradient_matches_f64(tpr, key):
    """The first step's gradient over 4 ranks (gathered), every leaf within
    GRAD_BAR of its largest entry of the one-device f64 gradient from the
    same parameters and batch, as the one-device f32 gradient is."""
    arch = TRAIN_RUNS[key][1]
    got = load(tpr["out"] / f"tp_train_{key.replace('/', '_')}.pt")["grad0"]
    _, _, tm, tparams = tpr["pairs"][arch]
    batch = train_batch(tpr, arch, 0)
    want = f64_gradient(arch, tparams, batch)
    _, one = value_and_grad(build_model(f32_smoke(arch), device="cpu"),
                            tparams, batch)
    paths = _tree_paths(tm.param_axes())
    for path, g, o, w in zip(paths, _tree.leaves(got), _tree.leaves(one),
                             _tree.leaves(want)):
        top = float(w.abs().max())
        assert float((g.double() - w).abs().max()) <= GRAD_BAR * top, path
        assert float((o.double() - w).abs().max()) <= GRAD_BAR * top, path


def recut_shapes(cfg, p: int) -> dict:
    """The shape of one layer's columns a rank multiplies, per re-cut leaf:
    its heads' z, x and dt and all of B and C (Mamba's ``w_in``), its
    channels of x and all of B and C (Mamba's ``conv``), its channels of
    u and z (``w_up``), its heads' columns of the four gates
    (``w_gates``)."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    if cfg.family == "hybrid":
        N, H = cfg.ssm_state, di // cfg.ssm_head_dim
        w_in = [d, 2 * di // p + 2 * N + H // p]
        conv = [4, di // p + 2 * N]
        return {"mamba/w_in": w_in, "tail/w_in": w_in, "mamba/conv": conv,
                "tail/conv": conv}
    return {"mlstm/w_up": [d, 2 * di // p], "slstm/w_gates": [d, 4 * d // p]}


@pytest.mark.parametrize("key", sorted(TRAIN_RUNS))
def test_split_is_real(tpr, key):
    """On every rank: rule 1 gathers exactly the cut leaves ``tp_whole``
    names (none where the heads divide); every other cut leaf is held as
    its shard; the packed leaves that run split are re-cut to the rank's
    columns, once a layer (a packed leaf the plan cannot cut, such as
    the zamba2 variant's 274-column ``w_in`` on 4, is whole and read
    through ``copy_to``), and no other leaf is gathered over ``model``;
    every matmul operand of a leaf is at most one layer of its shard, or
    the re-cut columns; the re-cuts' gradients are reduce-scattered."""
    shape, arch, _ = TRAIN_RUNS[key]
    cfg = f32_smoke(arch)
    p = shape[1]
    cuts, full = plan_cuts(cfg, shape)
    model = build_model(cfg, device="meta")
    whole = {path for path, w in zip(_tree_paths(model.param_axes()),
                                     _tree.leaves(model.tp_whole(p)))
             if w and path in cuts}
    recut = {k: v for k, v in recut_shapes(cfg, p).items()
             if k in cuts and k not in whole}
    assert set(recut) == set(RECUT[variant(arch)[0]]) & set(cuts) - whole
    for c in tpr["checks"]:
        rec = c["split"][key]
        assert sorted(rec["record"]["gathered"]) == sorted(whole)
        assert sorted(rec["record"]["split"]) == sorted(set(cuts) - whole)
        for path, s in full.items():
            s = list(s)
            if path in cuts and path not in whole:
                s[cuts[path]] //= p
            assert rec["run_shapes"][path] == s, (c["rank"], path)
        assert set(rec["recut"]) == set(recut), (c["rank"], rec["recut"])
        for path, shapes in rec["recut"].items():
            assert all(s == recut[path] for s in shapes), (path, shapes)
            assert len(shapes) == math.prod(full[path][:-len(recut[path])])
        ops = rec["operands"]
        for path in cuts:
            if path not in ops:
                continue
            layer = (math.prod(recut[path]) if path in recut else
                     math.prod(full[path][-2:]) // (1 if path in whole
                                                    else p))
            assert max(ops[path]) <= layer, (c["rank"], path, ops[path])
        for path in ("mamba/w_out", "mlstm/w_down", "mlstm/w_if"):
            if path in full and path not in whole:
                assert max(ops[path]) == math.prod(full[path][-2:]) // p
        calls = rec["calls"]
        assert calls.get("all_reduce", 0) > 0, calls
        if recut:
            assert calls.get("reduce_scatter_tensor", 0) > 0, calls


# -- prefill, decode ----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(tpr, arch):
    want = np.load(tpr["out"] / f"ref_prefill_{arch}.npy")
    got = load(tpr["out"] / f"tp_prefill_{arch}.pt")
    Z.within(got, want, SERVE_BAR)
    for c in tpr["checks"]:
        assert c["prefill_shapes"][arch] == \
            tpr["shapes"][f"prefill/{arch}"], c["rank"]


@pytest.mark.parametrize("arch", ARCHS)
def test_no_collective_inside_the_time_loop(tpr, arch):
    """Prefill at 16 and at 32 positions makes the same collectives over
    ``model``: none runs once a position (the sLSTM loops over every
    one)."""
    for c in tpr["checks"]:
        short, long_ = c["loop_counts"][arch]
        assert short == long_, (c["rank"], short, long_)
        assert short.get("all_reduce", 0) > 0, short


@pytest.mark.parametrize("key", sorted(DECODE_RUNS))
def test_decode_matches_reference_and_one_device(tpr, key):
    (_, p), arch, seq = DECODE_RUNS[key]
    name = key.replace("/", "_")
    z = np.load(tpr["out"] / f"decode_{name}.npz")
    ref = np.load(tpr["out"] / f"ref_decode_{name}.npz")
    got = load(tpr["out"] / f"tp_decode_{name}.pt")
    _, _, tm, tparams = tpr["pairs"][arch]
    one, one_cache = one_device_decode(tm, tparams, z, seq)
    for i in range(DECODE_STEPS):
        Z.within(got["logits"][i], ref["logits"][i], SERVE_BAR)
        Z.within(got["logits"][i], one[i], SERVE_BAR)
    for i, (g, o) in enumerate(zip(_tree.leaves(got["cache"]),
                                   _tree.leaves(one_cache))):
        Z.close(g, ref[f"c{i}"], SERVE_BAR)
        Z.close(g, o, SERVE_BAR)
    want = tpr["shapes"][f"decode/{key}"]
    for c in tpr["checks"]:
        assert c["decode_shapes"][key] == want, c["rank"]


def layer_state_shapes(arch, cache_shapes) -> set:
    """One layer's shard of each state leaf (the shard shape past its
    stacked layer dims), as tuples."""
    axes = _tree.flatten(build_model(f32_smoke(arch),
                                     device="meta").cache_axes(),
                         lambda x: isinstance(x, tuple))[0]
    return {tuple(s[a.count("layers"):]) for a, s in zip(axes, cache_shapes)}


@pytest.mark.parametrize("key", sorted(DECODE_RUNS))
def test_no_state_crosses_model_in_decode(tpr, key):
    """Every tensor a decode step sends over ``model`` is an activation:
    none has the shape of a layer's state shard (the rank updates its
    shard of each state leaf in place)."""
    arch = DECODE_RUNS[key][1]
    state = layer_state_shapes(arch, tpr["shapes"][f"decode/{key}"]["cache"])
    for c in tpr["checks"]:
        sent = c["decode_payloads"][key]
        assert sent, c["rank"]
        for name, shape in sent:
            shape = tuple(shape)
            assert shape not in state and shape[1:] not in state, (
                c["rank"], name, shape, state)


def test_decode_state_layout_is_the_plan():
    """The state's ``model`` cuts on (1, 4): Mamba's S by its SSM heads,
    its conv state by channels of [x B C]; mLSTM's C and n by the key dim,
    its conv state by channels; the sLSTM's state whole; zamba's
    attention cache by positions."""
    from repro_torch.configs.base import MeshConfig
    from repro_torch.sharding import MeshPlan
    plan = MeshPlan(MeshConfig((1, 4), ("data", "model")))
    got = {}
    for arch in ARCHS:
        model = build_model(f32_smoke(arch), device="meta")
        spec = model.cache_spec(SERVE_ROWS, SERVE_SEQ)
        axes = _tree.flatten(model.cache_axes(),
                             lambda x: isinstance(x, tuple))[0]
        for path, a, s in zip(_tree_paths(spec), axes, _tree.leaves(spec)):
            sp = plan.spec(a, tuple(s.shape))
            got[f"{arch}/{path}"] = [i for i, e in enumerate(sp)
                                     if e == "model"]
    assert got == {
        f"{ZAMBA}/attn_kv/k": [2], f"{ZAMBA}/attn_kv/v": [2],
        f"{ZAMBA}/mamba/S": [3], f"{ZAMBA}/mamba/conv": [4],
        f"{ZAMBA}/tail/S": [2], f"{ZAMBA}/tail/conv": [3],
        f"{XLSTM}/mlstm/C": [4], f"{XLSTM}/mlstm/n": [4],
        f"{XLSTM}/mlstm/m": [], f"{XLSTM}/mlstm/conv": [4],
        f"{XLSTM}/slstm/c": [], f"{XLSTM}/slstm/n": [], f"{XLSTM}/slstm/m": [],
        f"{XLSTM}/slstm/h": [], f"{XLSTM}/slstm/conv": []}
