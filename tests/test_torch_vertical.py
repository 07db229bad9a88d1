"""Vertical (split) FL in the port against the JAX reference, on the CPU.

* Split == unsplit inside the port: ResNet, MobileNetV3 and the dense
  TransformerLM, cut after unit 1 and 2, at the reference's own sizes
  and bar (``tests/test_vertical.py``, TOL 1e-5); split/merge is an exact
  round trip.
* The port's ``bottom_forward``, ``top_loss`` and both halves' gradients
  against the reference's ``jax.vjp`` / ``jax.value_and_grad`` on the
  same parameters (the reference's, converted) and the same numpy batch,
  at rtol 1e-4 with an atol of 1e-4 of each leaf's largest entry.
  MobileNetV3's ``bn_p`` biases feed the next normalisation through a
  linear 1x1 conv, so their gradient is exactly zero and f32 gives noise
  there: they are held to zero within 1e-6 of the largest gradient.
* The refusals: out-of-range cuts, models with no adapter (ViT,
  DistilBERT) and transformer stacks that cannot be cut, with the
  reference's messages.
* A live reduced run (2 parties, 2 rounds x 2 batches, ``torch_rpc``, no
  codec): its wires are byte-identical to the reference's and the clock
  holds no measured time, so the event trace is identical; the losses
  agree at rtol 1e-4, and the final bottoms and top at 1e-4 of each
  leaf's largest entry against the reference's run in f64 (the
  reference's own f32 run is further than that from its f64 run, see
  ``test_live_run_matches_reference``); in f64, both packages agree at
  1e-6.
* qsgd on the activation path: one error-feedback stream per direction,
  and the first activation's wire the reference's on the same input, at
  the quantize pair's bar (ROADMAP "Parity bars"): the int8 levels and
  every other byte identical, the f32 scales within 1 ULP (XLA turns the
  reference's ``amax / 127`` into a reciprocal multiply).
* ``fl_train --mode vertical`` and ``vertical_geo.json`` on the CPU.
"""
import dataclasses
import pickle
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.scenario as jscn  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.core.channel import make_channel as jmake_channel  # noqa: E402
from repro.core.message import TensorPayload as JPayload  # noqa: E402
from repro.core.message import VirtualPayload as JVirtual  # noqa: E402
from repro.fl import vertical as jvert  # noqa: E402
from repro.launch import fl_train as jfl_train  # noqa: E402
from repro.models.transformer import TransformerLM as JTransformerLM  # noqa: E402
from repro.models.vision import (MobileNetConfig as JMobileNetConfig,  # noqa: E402
                                 MobileNetV3 as JMobileNetV3,
                                 ResNet as JResNet,
                                 ResNetConfig as JResNetConfig)
import repro_torch.scenario as tscn  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.channel import make_channel  # noqa: E402
from repro_torch.core.message import TensorPayload, VirtualPayload  # noqa: E402
from repro_torch.fl import make_strategy  # noqa: E402
from repro_torch.fl import vertical as tvert  # noqa: E402
from repro_torch.launch import fl_train  # noqa: E402
from repro_torch.models.bert import BertConfig, DistilBert  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.models.vision import (MobileNetConfig, MobileNetV3,  # noqa: E402
                                       ResNet, ResNetConfig, ViT, ViTConfig)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5  # split == unsplit (tests/test_vertical.py)
RTOL = 1e-4  # port against reference
ZERO = "['bn_p']['bias']"  # leaves whose gradient is exactly zero

RESNET = dict(name="r-test", widths=(8, 16), blocks_per_stage=2,
              num_classes=5, image_size=8)
MOBILENET = dict(name="m-test", blocks=((1, 8, 1, False), (4, 12, 2, True),
                                        (3, 12, 1, False)),
                 stem=8, head=24, classifier=16, num_classes=5, image_size=8)
TRANSFORMER = dict(name="t-test", family="dense", num_layers=4, d_model=16,
                   num_heads=2, num_kv_heads=2, d_ff=32, vocab_size=31,
                   dtype="float32", param_dtype="float32")


def _models(family):
    """-> (reference model, port model, reference params as numpy, port
    params converted from them, numpy batch)."""
    rng = np.random.default_rng({"resnet": 1, "mobilenet": 2,
                                 "transformer": 3}[family])
    if family == "transformer":
        jm = JTransformerLM(JModelConfig(**TRANSFORMER))
        # the port runs only remat "none", which changes no numerics
        tm = TransformerLM(ModelConfig(**TRANSFORMER, remat="none"),
                           device="cpu")
        jp, _ = jm.init(jax.random.PRNGKey(0))
        tok = rng.integers(0, 31, size=(2, 6)).astype(np.int32)
        batch = {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}
    else:
        if family == "resnet":
            jm = JResNet(JResNetConfig(**RESNET))
            tm = ResNet(ResNetConfig(**RESNET), device="cpu")
        else:
            jm = JMobileNetV3(JMobileNetConfig(**MOBILENET))
            tm = MobileNetV3(MobileNetConfig(**MOBILENET), device="cpu")
        jp = jm.init(jax.random.PRNGKey(0))
        batch = {"images": rng.normal(size=(2, 8, 8, 3)).astype(np.float32),
                 "labels": rng.integers(0, 5, size=2).astype(np.int32)}
    jp = jax.tree.map(np.array, jp)
    tp = params_from_jax(jp, "cpu",
                         like=tm.init(torch.Generator().manual_seed(0)))
    return jm, tm, jp, tp, batch


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _grad(fn, *trees):
    """``fn`` at ``trees`` (trees of tensors) and its gradient per tree."""
    flat = [_tree.flatten(t) for t in trees]
    leaves = [[l.detach().clone().requires_grad_(True) for l in ls]
              for ls, _ in flat]
    out = fn(*[_tree.unflatten(d, ls) for ls, (_, d) in zip(leaves, flat)])
    grads = torch.autograd.grad(out, [l for ls in leaves for l in ls])
    split, i = [], 0
    for ls, (_, d) in zip(leaves, flat):
        split.append(_tree.unflatten(d, list(grads[i:i + len(ls)])))
        i += len(ls)
    return out.detach(), split


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _grads_match(tgrad, jgrad, top):
    """Each leaf of a port gradient tree against the reference's, paths
    ending in ``ZERO`` held to zero within 1e-6 of ``top``."""
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jgrad)[0]]
    jleaves = [np.asarray(w) for w in jax.tree.leaves(jgrad)]
    tleaves = _tree.leaves(tgrad)
    assert len(paths) == len(jleaves) == len(tleaves)
    for path, g, w in zip(paths, tleaves, jleaves):
        if path.endswith(ZERO):
            assert float(np.abs(w).max()) <= 1e-6 * top, path
            assert float(g.abs().max()) <= 1e-6 * top, path
            continue
        _close(g.numpy(), w)


# ---------------------------------------------------------------------------
# split == unsplit inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["resnet", "mobilenet", "transformer"])
@pytest.mark.parametrize("cut", [1, 2])
def test_split_parity_forward_backward(family, cut):
    _, model, _, params, batch = _models(family)
    batch = _tbatch(batch)
    plan = tvert.SplitPlan(model, cut_layer=cut)
    assert 1 <= cut <= plan.n_units - 1

    ref_loss, (ref_g,) = _grad(lambda p: model.loss(p, batch)[0], params)
    bottom, top = plan.split_params(params)
    split_loss, (g_b, g_t) = _grad(lambda b, t: plan.loss(b, t, batch)[0],
                                   bottom, top)
    assert abs(float(ref_loss) - float(split_loss)) <= TOL
    merged_g = plan.merge_params(g_b, g_t)
    assert _tree.flatten(merged_g)[1] == _tree.flatten(ref_g)[1]
    for a, b in zip(_tree.leaves(ref_g), _tree.leaves(merged_g)):
        assert float((a - b).abs().max()) <= TOL
    # the parameter split is an exact round trip
    re = plan.merge_params(bottom, top)
    assert _tree.flatten(re)[1] == _tree.flatten(params)[1]
    for a, b in zip(_tree.leaves(params), _tree.leaves(re)):
        assert a is b or torch.equal(a, b)


# ---------------------------------------------------------------------------
# the port's halves against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["resnet", "mobilenet", "transformer"])
@pytest.mark.parametrize("cut", [1, 2])
def test_split_halves_match_reference(family, cut):
    jm, tm, jp, tp, batch = _models(family)
    jplan, tplan = jvert.SplitPlan(jm, cut), tvert.SplitPlan(tm, cut)
    jb, jt = jplan.split_params(jax.tree.map(jnp.asarray, jp))
    tb, tt = tplan.split_params(tp)
    jbatch, tbatch = _jbatch(batch), _tbatch(batch)

    # bottom forward: activations in the reference's layout
    jacts, vjp = jax.vjp(lambda p: jplan.bottom_forward(p, jbatch), jb)
    tacts = tplan.bottom_forward(tb, tbatch)
    assert tuple(tacts.shape) == jacts.shape
    _close(tacts.numpy(), jacts)

    # top: loss and the gradients of its params and of the activations,
    # both packages from the reference's activations
    acts = np.array(jacts)
    jloss, (jg_t, jg_a) = jax.value_and_grad(
        lambda t, a: jplan.top_loss(t, a, jbatch)[0], argnums=(0, 1))(
            jt, jnp.asarray(acts))
    tloss, (tg_t, tg_a) = _grad(lambda t, a: tplan.top_loss(t, a, tbatch)[0],
                                tt, torch.from_numpy(acts))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    _close(tg_a.numpy(), jg_a)

    # bottom backward: both packages pull the reference's activation
    # gradient back, as the live path pulls the one it receives
    cot = np.array(jg_a)
    (jg_b,) = vjp(jnp.asarray(cot))
    _, (tg_b,) = _grad(
        lambda p: torch.sum(tplan.bottom_forward(p, tbatch)
                            * torch.from_numpy(cot)), tb)
    top = max(float(np.abs(np.asarray(w)).max())
              for w in jax.tree.leaves((jg_b, jg_t)))
    _grads_match(tg_b, jg_b, top)
    _grads_match(tg_t, jg_t, top)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["resnet", "mobilenet", "transformer"])
def test_split_plan_rejects_out_of_range_cut(family):
    jm, tm, *_ = _models(family)
    n = tvert.SplitPlan(tm, 1).n_units
    assert n == jvert.SplitPlan(jm, 1).n_units
    for cut in (0, n, 99):
        with pytest.raises(ValueError, match="cut_layer") as got:
            tvert.SplitPlan(tm, cut)
        with pytest.raises(ValueError) as want:
            jvert.SplitPlan(jm, cut)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cls,cfg", [(ViT, ViTConfig), (DistilBert,
                                                       BertConfig)])
def test_no_adapter_for_vit_and_distilbert(cls, cfg):
    """The reference has no adapter for either (``fl/vertical.py:242``):
    splitting ViT's inner TransformerLM would be a feature it lacks."""
    model = cls(cfg(), device="meta")
    with pytest.raises(TypeError, match="no split adapter for "
                                        f"{cls.__name__}"):
        tvert.SplitPlan(model, 1)


@pytest.mark.parametrize("change", [dict(tie_embeddings=True),
                                    dict(external_embeddings=True),
                                    dict(family="moe", num_experts=4,
                                         experts_per_token=2)])
def test_unsplittable_stacks_refused_as_reference(change):
    """The port's TransformerLM refuses MoE at construction, so its
    segment check is reached through a bare instance of the class."""
    jm = JTransformerLM(JModelConfig(**{**TRANSFORMER, **change}))
    cfg = ModelConfig(**{**TRANSFORMER, **change}, remat="none")
    if "num_experts" in change:
        tm = TransformerLM.__new__(TransformerLM)
        tm.cfg = cfg
    else:
        tm = TransformerLM(cfg, device="cpu")
    with pytest.raises(ValueError) as got:
        tvert.SplitPlan(tm, 1)
    with pytest.raises(ValueError) as want:
        jvert.SplitPlan(jm, 1)
    assert str(got.value) == str(want.value)


def test_sizing_helpers_and_strategy_match_reference():
    for cut in (1, 2, 5):
        for depth in (6, 14, 27):
            assert tvert.bottom_fraction(cut, depth) == \
                jvert.bottom_fraction(cut, depth)
        for nb in (1 << 10, 100 << 20, 1_212_944_384):
            assert tvert.sim_activation_nbytes(nb, 32, cut) == \
                jvert.sim_activation_nbytes(nb, 32, cut)
    assert tvert.TIER_DEPTH == jvert.TIER_DEPTH
    assert tvert.SIM_BATCH_SIZE == jvert.SIM_BATCH_SIZE
    cfg = tscn.Scenario.from_dict({"name": "v", "strategy": {
        "mode": "vertical"}, "split": {"cut_layer": 3,
                                       "batches_per_round": 5}}).fl_config()
    strat = make_strategy(cfg, 4, train_s=12.0, bottom_frac=0.25)
    assert isinstance(strat, tvert.VerticalStrategy)
    assert (strat.cut_layer, strat.batches_per_round) == (3, 5)
    assert (strat.bottom_s, strat.top_s) == (12.0 * 0.25 / 5,
                                            12.0 * 0.75 / 5)


# ---------------------------------------------------------------------------
# live runs
# ---------------------------------------------------------------------------

def _scenario(pkg, backend, codec="none", rounds=2, bpr=2, kind="geo"):
    return pkg.Scenario.from_dict({
        "name": "vert-live", "seed": 0,
        "topology": {"kind": "geo_distributed" if kind == "geo" else "lan",
                     "num_clients": 2},
        "fleet": {"tier": "small", "local_steps": 1},
        "channel": {"backend": backend},
        "strategy": {"mode": "vertical", "rounds": rounds},
        "split": {"cut_layer": 1, "batches_per_round": bpr,
                  "activation_codec": codec}}).validate()


def _live(dtype="float32", **kw):
    """The same vertical run in both packages, the port started from the
    reference's parameters, both with parameters and images in ``dtype``
    (the reference under ``jax.enable_x64`` for float64). Returns
    ((report, scheduler, strategy, server) of the reference, then of the
    port)."""
    out = []
    for mod, scn in ((jfl_train, jscn), (fl_train, tscn)):
        sc = _scenario(scn, **kw)
        fl_cfg = sc.fl_config()
        with jax.enable_x64(dtype == "float64"):
            if mod is jfl_train:
                server, params, _, _ = mod.build_deployment(
                    fl_cfg, tier="small", local_steps=1, scenario=sc)
                ref_params = jax.tree.map(np.array, params)
                params = jax.tree.map(lambda a: jnp.asarray(a, dtype),
                                      params)
                vp = JVirtual
            else:
                server, params, _, _ = mod.build_deployment(
                    fl_cfg, tier="small", local_steps=1, scenario=sc,
                    device="cpu")
                params = _tree.map(
                    lambda a: a.to(getattr(torch, dtype)),
                    params_from_jax(ref_params, "cpu", like=params))
                vp = VirtualPayload
            strategy = mod._vertical_strategy(fl_cfg, server, params, sc)
            strategy.live.batch_fn = _cast(strategy.live.batch_fn, dtype)
            report, sched = server.run_async(
                vp(strategy.activation_nbytes, tag="vert-live"), strategy,
                availability=None, cohort_k=0, cohort_seed=0,
                streaming_hub=False, max_aggregations=fl_cfg.rounds)
        out.append((report, sched, strategy, server))
    return out


def _cast(batch_fn, dtype):
    """``batch_fn`` with its floating-point leaves in ``dtype``."""
    def cast(v):
        if isinstance(v, torch.Tensor):
            return v.to(getattr(torch, dtype)) if v.is_floating_point() \
                else v
        return v.astype(dtype) if jnp.issubdtype(v.dtype, jnp.floating) \
            else v
    return lambda *a: {k: cast(v) for k, v in batch_fn(*a).items()}


def _trees_close(got, want, rtol=RTOL):
    for g, w in zip(_tree.leaves(got), jax.tree.leaves(want)):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        _close(g.double().numpy(), np.asarray(w, np.float64), rtol)


def _final_trees_close(tstrat, jstrat, rtol=RTOL):
    for cid, bottom in tstrat.live.bottoms.items():
        _trees_close(bottom, jstrat.live.bottoms[cid], rtol)
    _trees_close(tstrat.live.top, jstrat.live.top, rtol)


def test_live_run_matches_reference():
    """f32 in both packages: the event trace, the report and the wire
    stats are identical, the losses agree at rtol 1e-4. The final
    bottoms and top are held against the reference's f64 run at 1e-4 of
    each leaf's largest entry: against the reference's own f32 run they
    are not, and neither is that run against its f64 run. SGD on biases
    that start at zero sums gradients that nearly cancel, so a leaf's
    largest entry ends far below the gradients' size; the reference's
    f32 bottoms and top read 1.45e-2 of such a leaf's largest entry from
    its f64 run, the port's 9.6e-7."""
    (jrep, jsched, jstrat, jserver), (trep, tsched, tstrat, tserver) = \
        _live(backend="torch_rpc")
    assert trep.n_aggregations == 2
    assert tsched.loop.trace == jsched.loop.trace
    rep_t, rep_j = dataclasses.asdict(trep), dataclasses.asdict(jrep)
    assert rep_t.pop("final_loss") == pytest.approx(rep_j.pop("final_loss"),
                                                    rel=RTOL)
    assert rep_t == rep_j
    assert dict(tserver.backend.fabric.stats) == \
        dict(jserver.backend.fabric.stats)
    assert [e.n_updates for e in tsched.agg_log] == [2, 2]
    for te, je in zip(tsched.agg_log, jsched.agg_log):
        te, je = dataclasses.asdict(te), dataclasses.asdict(je)
        assert te.pop("loss") == pytest.approx(je.pop("loss"), rel=RTOL)
        assert te == je
    # every batch completed, and each graph was released by its backward
    assert trep.n_discarded == 0 and tstrat._vjp == {}
    assert tstrat.completed == {c.client_id: 2 for c in tserver.clients}
    (_, _, jstrat64, _), _ = _live("float64", backend="torch_rpc")
    _final_trees_close(tstrat, jstrat64)
    # the parties trained apart: their bottoms are distinct trees now
    b0, b1 = (_tree.leaves(b) for b in tstrat.live.bottoms.values())
    assert not any(x is y for x, y in zip(b0, b1))


def test_live_run_f64_matches_reference():
    """Both packages in f64: the same trace, and the final bottoms and top
    within 1e-6 of each leaf's largest entry (7.4e-8 measured)."""
    (jrep, jsched, jstrat, _), (trep, tsched, tstrat, _) = _live(
        "float64", backend="torch_rpc")
    assert tsched.loop.trace == jsched.loop.trace
    assert [e.n_updates for e in tsched.agg_log] == [2, 2]
    for te, je in zip(tsched.agg_log, jsched.agg_log):
        assert te.loss == pytest.approx(je.loss, rel=1e-6)
    assert all(l.dtype == torch.float64 for l in _tree.leaves(tstrat.live.top))
    _final_trees_close(tstrat, jstrat, rtol=1e-6)


def test_live_qsgd_activation_error_feedback_per_direction(monkeypatch):
    """The reference's test on the port, and the first activation's qsgd
    wire (generic serializer) against the reference's on the same input:
    the int8 levels bit for bit, the scales within 1 ULP."""
    from repro.core import channel as jchannel
    first = {}
    real = jchannel.CompressStage.compress

    def spy(self, payload, peer):
        out = real(self, payload, peer)
        if peer == "server" and "acts" not in first:
            first["acts"] = np.array(payload.tree["acts"])
        return out
    monkeypatch.setattr(jchannel.CompressStage, "compress", spy)
    (jrep, jsched, _, jserver), (trep, tsched, tstrat, tserver) = _live(
        backend="grpc", codec="qsgd", rounds=1, kind="lan")
    assert trep.n_aggregations == jrep.n_aggregations == 1
    # activations ride UP on each client's channel: one residual stream
    # keyed by the server peer
    for c in tserver.clients:
        state = c.backend.channel.compress_stage._state
        assert set(state) == {"server"}, sorted(state)
    # activation gradients ride DOWN on the server's channel: one
    # residual stream per feature party
    down = tsched.backend.channel.compress_stage._state
    assert set(down) == {c.client_id for c in tserver.clients}
    assert all(ev.loss is not None for ev in tsched.agg_log)
    assert tstrat.completed == {c.client_id: 2 for c in tserver.clients}

    acts = first["acts"]
    assert acts.shape == (16, 16, 16, 16)  # NHWC at the cut
    jw = jmake_channel("generic", compression="qsgd").encode(
        JPayload({"acts": jnp.asarray(acts)}), "server").wire
    tw = make_channel("generic", compression="qsgd", device="cpu").encode(
        TensorPayload({"acts": torch.from_numpy(acts)}), "server").wire
    assert tw.nbytes - len(tw.buffers[0]) == jw.nbytes - len(jw.buffers[0])
    jobj, tobj = pickle.loads(jw.buffers[0]), pickle.loads(tw.buffers[0])
    jleaves, tleaves = jax.tree.leaves(jobj), _tree.leaves(tobj)
    assert len(jleaves) == len(tleaves) > 0
    for t, j in zip(tleaves, jleaves):
        t, j = np.asarray(t), np.asarray(j)
        assert t.dtype == j.dtype and t.shape == j.shape
        if t.dtype == np.float32:  # the scales (ROADMAP "Parity bars")
            np.testing.assert_array_almost_equal_nulp(t, j, nulp=1)
        else:
            assert t.tobytes() == j.tobytes()


class _Capture:
    """Wraps ``fl_train.run_event_driven`` to keep what it returns."""

    def __init__(self):
        self.runs = []
        self.real = fl_train.run_event_driven

    def __call__(self, *args):
        out = self.real(*args)
        self.runs.append(out)
        return out


@pytest.mark.parametrize("argv,parties,bpr", [
    (["--mode", "vertical", "--activation-codec", "qsgd", "--clients", "2",
      "--rounds", "1", "--batches-per-round", "3"], 2, 3),
    (["--scenario", str(ROOT / "examples" / "scenarios"
                        / "vertical_geo.json"), "--rounds", "1"], 4, 8)],
    ids=["flags", "vertical_geo.json"])
def test_cli_vertical_completes_every_batch(argv, parties, bpr, monkeypatch,
                                            capsys):
    """The CLI builds the reduced ResNet whatever the scenario's tier, as
    the reference does."""
    cap = _Capture()
    monkeypatch.setattr(fl_train, "run_event_driven", cap)
    assert fl_train.main(argv + ["--device", "cpu"]) == 0
    (report, sched), = cap.runs
    strat = sched.strategy
    assert isinstance(strat.live.plan.model, ResNet)
    assert report.n_aggregations == 1 and report.n_discarded == 0
    assert strat.completed == {f"client{i}": bpr for i in range(parties)}
    assert all(np.isfinite(e.loss) for e in sched.agg_log)
    assert "[fl:vertical]" in capsys.readouterr().out
