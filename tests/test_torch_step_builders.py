"""The launch layer's other steps and the training driver, port against
the JAX reference on the CPU: the cross-pod FL round (2 pods, int8 and
f32 exchanges, 2 rounds), prefill's last-position logits and one decode
step, each against the reference's own bundle function jitted with its
shardings on an ``AxisType.Auto`` mesh (``test_torch_train.py`` says
why); and ``launch/train.py``: it learns, checkpoints, and resumes to
the same parameters as an uninterrupted run.

Bars: the FL round's new anchor within one int8 level (that leaf's
``max|delta| / 127``, from the port's own deltas) plus 1e-4 of the leaf's
largest entry, and bit for bit against a plain recomputation from the
port's own deltas; the f32 exchange and the optimizer states at 1e-4 of
each leaf's largest entry; logits and caches at ``_torch_zoo``'s bars.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import _torch_zoo as Z  # noqa: E402
from repro.configs.base import MeshConfig as JMesh  # noqa: E402
from repro.configs.base import SMOKE_MESH as JSMOKE_MESH  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.launch.step_builders import bundle_for as jbundle  # noqa: E402
from repro.optim.optimizers import adamw_init as jadamw_init  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.checkpoint.ckpt import list_steps  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import (SMOKE_MESH, MeshConfig,  # noqa: E402
                                      ShapeConfig, TrainConfig)
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_smoke_mesh  # noqa: E402
from repro_torch.launch.step_builders import (bundle_for,  # noqa: E402
                                              crosspod_mean, stack_pods)
from repro_torch.optim import adamw_init  # noqa: E402

POD_AXES = ("pod", "data", "model")
N_PODS, LOCAL, BATCH, SEQ = 2, 2, 4, 16


# -- the cross-pod FL round ---------------------------------------------------

def _pod_batches(cfg, rnd):
    """Seeded numpy batches, (pods, local steps, batch / pods, ...)."""
    per = [[Z.batch(cfg, 100 * rnd + 10 * i + k, BATCH // N_PODS, SEQ)
            for k in range(LOCAL)] for i in range(N_PODS)]
    return {key: np.stack([np.stack([per[i][k][key] for k in range(LOCAL)])
                           for i in range(N_PODS)]) for key in per[0][0]}


@pytest.mark.parametrize("arch,compression", [
    ("zamba2-1.2b", "int8"), ("granite-moe-1b-a400m", "int8"),
    ("qwen3-8b", "none")])
def test_fl_round_matches_reference(arch, compression):
    train = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                 crosspod_compression=compression)
    jm, jp, tm, tp = Z.pair(arch)
    mesh = Z.auto_mesh((1, 1, 1), POD_AXES)
    jb = jbundle("fl_round", jm.cfg, JShape("t", SEQ, BATCH, "train"), mesh,
                 JMesh((N_PODS, 1, 1), POD_AXES), JTrain(**train),
                 local_steps=LOCAL)
    jfn = jax.jit(jb.fn, in_shardings=jb.in_shardings,
                  out_shardings=jb.out_shardings)
    tb = bundle_for("fl_round", tm.cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                    make_mesh(MeshConfig((1, 1, 1), POD_AXES), "cpu"),
                    MeshConfig((N_PODS, 1, 1), POD_AXES), TrainConfig(**train),
                    local_steps=LOCAL)

    def pods(tree):
        return jax.tree.map(lambda a: jnp.broadcast_to(
            a[None], (N_PODS,) + a.shape), tree)

    janchor = jax.tree.map(jnp.asarray, jp)
    jps, jo = pods(janchor), pods(jadamw_init(janchor, JTrain()))
    tanchor = tp
    tps, to = stack_pods(tp, N_PODS), stack_pods(adamw_init(tp, TrainConfig()),
                                                  N_PODS)
    for rnd in range(2):
        batches = _pod_batches(tm.cfg, rnd)
        with mesh:
            jps, jo, janchor, jloss = jfn(jps, jo, janchor, Z.to_jax(batches),
                                          jnp.int32(rnd))
        tps, to, tloss = tb.fn.local_steps(tps, to, Z.to_torch(batches), rnd)
        pre = [l.clone() for l in _tree.leaves(tps)]
        tps, new_anchor = tb.fn.exchange(tanchor, tps)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        leaves = zip(Z.ref_paths(janchor), _tree.leaves(tanchor), pre,
                     _tree.leaves(new_anchor), jax.tree.leaves(janchor))
        for path, a0, stacked, got, want in leaves:
            # bit for bit against the exchange done again, plainly
            delta = stacked.float() - a0.float()[None]
            if compression == "int8":
                scale = delta.abs().max() / 127.0 + 1e-12
                q = torch.clamp(torch.round(delta / scale), -127, 127)
                mean = q.to(torch.int32).sum(0).float() * scale / N_PODS
                level = float(scale)
            else:
                mean = delta.sum(0) / N_PODS
                level = 0.0
            assert torch.equal(got, (a0.float() + mean).to(a0.dtype)), path
            want = np.asarray(want)
            bar = level + Z.MODEL_RTOL * float(np.abs(want).max())
            assert float(np.abs(got.numpy() - want).max()) <= bar, path
        for l, a in zip(_tree.leaves(tps), _tree.leaves(new_anchor)):
            assert all(torch.equal(l[i], a) for i in range(N_PODS))
            assert l.data_ptr() != a.data_ptr()  # copies, not views
        Z.trees_match(to.m, jo.m)
        Z.trees_match(to.v, jo.v)
        assert to.count.tolist() == np.asarray(jo.count).tolist() \
            == [LOCAL * (rnd + 1)] * N_PODS
        tanchor = new_anchor


def test_fl_round_fn_is_its_two_halves():
    """``fn`` = ``local_steps`` then ``exchange``; it returns the stacked
    trees it was given, stepped and reset."""
    cfg = Z.f32(smoke_config("qwen3-8b"))
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                       crosspod_compression="int8")
    b = bundle_for("fl_round", cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                   make_mesh(MeshConfig((1, 1, 1), POD_AXES), "cpu"),
                   MeshConfig((N_PODS, 1, 1), POD_AXES), tcfg,
                   local_steps=LOCAL)
    params = b.model.init(torch.Generator().manual_seed(0))
    batches = Z.to_torch(_pod_batches(cfg, 0))
    runs = []
    for split in (False, True):
        ps = stack_pods(params, N_PODS)
        os_ = stack_pods(adamw_init(params, tcfg), N_PODS)
        if split:
            p2, o2, loss = b.fn.local_steps(ps, os_, batches, 3)
            reset, anchor = b.fn.exchange(params, p2)
        else:
            reset, o2, anchor, loss = b.fn(ps, os_, params, batches, 3)
        assert reset is ps and o2 is os_
        runs.append((anchor, o2, loss))
    for a, b_ in zip(_tree.leaves(runs[0]), _tree.leaves(runs[1])):
        assert torch.equal(a, b_)
    assert float(runs[0][2]) > 0


def test_crosspod_mean_int8_rounds_half_to_even():
    """One scale over all pods (max 127 -> scale 1 + 1e-12), levels rounded
    half to even, summed in int32 over pods."""
    anchor = torch.zeros(4)
    stacked = torch.tensor([[127.0, 0.5, 1.5, -2.5],
                            [127.0, 0.5, 2.5, -0.5]])
    mean = crosspod_mean(anchor, stacked, "int8")
    scale = torch.tensor(127.0) / 127.0 + 1e-12
    q = torch.tensor([[127, 0, 2, -2], [127, 0, 2, 0]], dtype=torch.int32)
    assert torch.equal(mean, q.sum(0).float() * scale / 2)
    assert torch.equal(crosspod_mean(anchor, stacked, "none"),
                       stacked.sum(0) / 2)


# -- prefill and decode -------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-moe-1b-a400m",
                                  "hubert-xlarge", "zamba2-1.2b"])
def test_prefill_step_matches_reference(arch):
    jm, jp, tm, tp = Z.pair(arch)
    mesh = Z.auto_mesh((1, 1), ("data", "model"))
    jb = jbundle("prefill", jm.cfg, JShape("t", SEQ, BATCH, "prefill"), mesh,
                 JSMOKE_MESH)
    tb = bundle_for("prefill", tm.cfg, ShapeConfig("t", SEQ, BATCH, "prefill"),
                    make_smoke_mesh("cpu"), SMOKE_MESH)
    batch = {k: v for k, v in Z.batch(tm.cfg, 7, BATCH, SEQ).items()
             if k != "targets"}
    with mesh:
        want = jax.jit(jb.fn, in_shardings=jb.in_shardings,
                       out_shardings=jb.out_shardings)(
            jax.tree.map(jnp.asarray, jp), Z.to_jax(batch))
    got = tb.fn(tp, Z.to_torch(batch))
    assert got.shape == (BATCH, tm.cfg.vocab_size)
    Z.close(got, want, Z.MODEL_RTOL)


@pytest.mark.parametrize("arch", ["qwen3-8b", "zamba2-1.2b", "xlstm-1.3b"])
def test_decode_step_matches_reference(arch):
    """One token at position 5 of a seq_len cache whose first 5 slots hold
    a seeded prefix's decode state; the port's step returns the cache
    object it was given, updated."""
    jm, jp, tm, tp = Z.pair(arch)
    mesh = Z.auto_mesh((1, 1), ("data", "model"))
    jb = jbundle("decode", jm.cfg, JShape("t", SEQ, BATCH, "decode"), mesh,
                 JSMOKE_MESH)
    tb = bundle_for("decode", tm.cfg, ShapeConfig("t", SEQ, BATCH, "decode"),
                    make_smoke_mesh("cpu"), SMOKE_MESH)
    tokens = np.random.default_rng(3).integers(
        0, tm.cfg.vocab_size, (BATCH, 6)).astype(np.int32)
    _, jcache, tcache = Z.decode_pair(jm, jp, tm, tp, tokens[:, :5], SEQ)
    step = {"tokens": tokens[:, 5:6]}
    with mesh:
        want, wcache = jax.jit(jb.fn, in_shardings=jb.in_shardings,
                               out_shardings=jb.out_shardings)(
            jax.tree.map(jnp.asarray, jp), jcache,
            {"tokens": jnp.asarray(step["tokens"]), "pos": jnp.int32(5)})
    got, gcache = tb.fn(tp, tcache, {"tokens": torch.from_numpy(
        step["tokens"]), "pos": 5})
    assert gcache is tcache
    Z.close(got, want, Z.MODEL_RTOL)
    Z.caches_match(wcache, gcache, Z.MODEL_RTOL)


# -- launch/train.py ----------------------------------------------------------

def test_train_cli_learns_and_resumes(tmp_path, capsys):
    """The port's counterpart of ``test_trainer_checkpoint_restart``."""
    d = str(tmp_path / "ck")
    argv = ["--arch", "qwen3-8b", "--ckpt-dir", d, "--ckpt-every", "3",
            "--device", "cpu"]
    assert T.main(argv + ["--steps", "6"]) == 0
    assert list_steps(d) == [3, 6]
    assert T.main(argv + ["--steps", "9"]) in (0, 1)
    assert "resumed from step 6" in capsys.readouterr().out
    assert list_steps(d) == [3, 6, 9]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_train_cli_needs_a_card_unless_told():
    with pytest.raises(RuntimeError, match="CUDA"):
        T.main(["--arch", "qwen3-8b", "--steps", "1"])


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "hubert-xlarge",
                                  "llama-3.2-vision-11b"])
def test_train_resume_equals_uninterrupted(tmp_path, arch):
    """6 steps straight, against 3 steps, a checkpoint, and a fresh
    ``train`` call that restores it and runs 3 more: bit for bit (the
    resumed run skips the batches already trained on; hubert's frame
    embeddings are seeded per step)."""
    cfg = smoke_config(arch)
    shape = ShapeConfig("cli", 16, 2, "train")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=6)
    quiet = dict(device="cpu", log=lambda *_: None)
    whole = T.train(cfg, shape, tcfg, 6, **quiet)
    d = str(tmp_path / "ck")
    first = T.train(cfg, shape, tcfg, 3, ckpt_dir=d, ckpt_every=3, **quiet)
    rest = T.train(cfg, shape, tcfg, 6, ckpt_dir=d, ckpt_every=3, **quiet)
    assert rest.start_step == 3 and len(rest.losses) == 3
    assert first.losses + rest.losses == whole.losses
    assert np.isfinite(whole.losses).all()
    for a, b in zip(_tree.leaves((rest.params, rest.opt_state)),
                    _tree.leaves((whole.params, whole.opt_state))):
        assert a.dtype == b.dtype and torch.equal(a, b)
