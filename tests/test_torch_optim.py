"""The optimizers and the LR schedule, port against the JAX reference on
the CPU: ``adamw_update``, ``sgd_update``, ``clip_by_global_norm`` and
``cosine_warmup`` on seeded trees of f32 and bf16 leaves, with f32 and
bf16 moments, over 5 steps; and the reference's own checks from
``tests/test_optim_and_data.py`` held on the port.

Bars: f32 states at rtol 1e-6, with an atol of 1e-6 of the tree's
largest entry (the global norm sums each leaf in another order than XLA,
so the clipped gradients can differ in their last bit, and a state that
nearly cancels keeps that absolute error: SGD's momentum on the scalar
leaf reads 5.6e-6 relative, 2.2e-8 absolute); bf16 leaves within one
bf16 ULP; lr and gnorm at rtol 1e-6.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import _torch_zoo as Z  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
from repro.optim import cosine_warmup as jcosine  # noqa: E402
from repro.optim import sgd_init as jsgd_init  # noqa: E402
from repro.optim import sgd_update as jsgd_update  # noqa: E402
from repro.optim.optimizers import clip_by_global_norm as jclip  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.optim import (OptState, adamw_init, adamw_update,  # noqa: E402
                               clip_by_global_norm, cosine_warmup, make_optimizer,
                               sgd_init, sgd_update)
from repro_torch.optim.optimizers import opt_state_axes  # noqa: E402

RTOL = 1e-6
STEPS = 5
SCHEDULE = dict(base_lr=1e-2, warmup_steps=2, total_steps=8)


def _tree_np(rng, param_dtype):
    """A seeded parameter tree: matrices, a vector and a scalar, in
    ``param_dtype`` (numpy f32 values, cast by each package)."""
    return {"a": {"w": rng.normal(size=(8, 16)).astype(np.float32),
                  "b": rng.normal(size=(16,)).astype(np.float32)},
            "c": [rng.normal(size=(4, 3, 2)).astype(np.float32),
                  np.float32(rng.normal())],
            "_dtype": param_dtype}


def _both(tree):
    """-> (jax tree, torch tree) in the tree's dtype, the bf16 ones from
    the same f32 values (both round to nearest even)."""
    dt = tree.pop("_dtype")
    jt = jax.tree.map(lambda x: jnp.asarray(x).astype(dt), tree)
    tt = _tree.map(lambda x: torch.from_numpy(np.asarray(x)).to(
        getattr(torch, dt)), tree)
    return jt, tt


def _grads(seed, param_dtype, scale=1.0):
    g = _tree_np(np.random.default_rng(seed), param_dtype)
    g["a"]["w"] *= scale
    return _both(g)


def assert_leaf(got, want, path="", top=None):
    """f32 at RTOL, with an atol of RTOL x ``top`` (default: the leaf's
    largest entry); bf16 within one bf16 ULP of the reference's value."""
    assert str(got.dtype) == f"torch.{want.dtype}", (path, got.dtype)
    g, w = Z.as_f32(got), Z.as_f32(want)
    if got.dtype == torch.bfloat16:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert np.all(np.abs(g - w) <= ulp), path
    else:
        top = float(np.abs(w).max()) if top is None else top
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * top,
                                   err_msg=path)


def assert_tree(got, want):
    wl = jax.tree.leaves(want)
    top = max(float(np.abs(Z.as_f32(w)).max()) for w in wl)
    for path, g, w in zip(Z.ref_paths(want), _tree.leaves(got), wl):
        assert_leaf(g, w, path, top)


@pytest.mark.parametrize("step", [0, 1, 2, 5, 7, 8, 20])
def test_cosine_warmup_matches_reference(step):
    want = jcosine(jnp.int32(step), **SCHEDULE)
    for s in (step, torch.tensor(step, dtype=torch.int32)):
        got = cosine_warmup(s, **SCHEDULE)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


@pytest.mark.parametrize("max_norm", [0.0, 1.0, 1e6])
def test_clip_by_global_norm_matches_reference(max_norm):
    jg, tg = _grads(0, "float32", scale=10.0)
    jc, jn = jclip(jg, max_norm)
    tc, tn = clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    assert_tree(tc, jc)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(param_dtype, moment_dtype):
    cfg = dict(moment_dtype=moment_dtype, weight_decay=0.1, grad_clip=1.0)
    jcfg, tcfg = JTrain(**cfg), TrainConfig(**cfg)
    jp, tp = _both(_tree_np(np.random.default_rng(1), param_dtype))
    js, ts = jadamw_init(jp, jcfg), adamw_init(tp, tcfg)
    for step in range(STEPS):
        jg, tg = _grads(10 + step, param_dtype)
        jlr = jcosine(jnp.int32(step), **SCHEDULE)
        tlr = cosine_warmup(step, **SCHEDULE)
        np.testing.assert_allclose(float(tlr), float(jlr), rtol=RTOL)
        jp, js, jn = jadamw_update(jg, js, jp, jlr, jcfg)
        tp, ts, tn = adamw_update(tg, ts, tp, tlr, tcfg)
        np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
        assert_tree(tp, jp)
        assert_tree(ts.m, js.m)
        assert_tree(ts.v, js.v)
        assert int(ts.count) == int(js.count) == step + 1


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_inplace_is_the_same_update(param_dtype):
    """``inplace=True`` writes into the trees it is given, with the same
    roundings as the out-of-place update."""
    cfg = TrainConfig(weight_decay=0.1)
    _, p = _both(_tree_np(np.random.default_rng(1), param_dtype))
    s = adamw_init(p, cfg)
    _, g = _grads(3, param_dtype)
    want_p, want_s, want_n = adamw_update(g, s, p, 0.01, cfg)
    got_p, got_s, got_n = adamw_update(g, s, p, 0.01, cfg, inplace=True)
    for got, given in zip(_tree.leaves((got_p, got_s)),
                          _tree.leaves((p, s))):
        assert got is given
    for a, b in zip(_tree.leaves((got_p, got_s, got_n)),
                    _tree.leaves((want_p, want_s, want_n))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_sgd_matches_reference(moment_dtype):
    cfg = dict(moment_dtype=moment_dtype, grad_clip=1.0)
    jcfg, tcfg = JTrain(**cfg), TrainConfig(**cfg)
    jp, tp = _both(_tree_np(np.random.default_rng(2), "float32"))
    js, ts = jsgd_init(jp, jcfg), sgd_init(tp, tcfg)
    assert ts.v == {} and js.v == {}
    for step in range(STEPS):
        jg, tg = _grads(20 + step, "float32")
        jp, js, jn = jsgd_update(jg, js, jp, 0.05, jcfg)
        tp, ts, tn = sgd_update(tg, ts, tp, 0.05, tcfg)
        np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
        assert_tree(tp, jp)
        assert_tree(ts.m, js.m)


def test_make_optimizer_and_state_axes():
    assert make_optimizer(TrainConfig()) == (adamw_init, adamw_update)
    init, update = make_optimizer(TrainConfig(optimizer="sgd"))
    assert init is sgd_init
    with pytest.raises(ValueError):
        make_optimizer(TrainConfig(optimizer="lion"))
    axes = {"w": ("embed", "mlp")}
    assert opt_state_axes(axes, TrainConfig()) == OptState(None, axes, axes)
    assert opt_state_axes(axes, TrainConfig(optimizer="sgd")) == \
        OptState(None, axes, {})


# -- the reference's own checks (tests/test_optim_and_data.py) ---------------

def _quad_problem():
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(1.5)}

    def loss(p):
        return torch.sum(torch.square(p["w"])) + torch.square(p["b"])

    return params, loss


def _grad(loss, params):
    leaves, treedef = _tree.flatten(params)
    leaves = [l.detach().requires_grad_(True) for l in leaves]
    g = torch.autograd.grad(loss(_tree.unflatten(treedef, leaves)), leaves)
    return _tree.unflatten(treedef, list(g))


def test_adamw_converges_on_quadratic():
    cfg = TrainConfig(learning_rate=0.1, weight_decay=0.0, grad_clip=0.0)
    params, loss = _quad_problem()
    state = adamw_init(params, cfg)
    for _ in range(200):
        params, state, _ = adamw_update(_grad(loss, params), state, params,
                                        0.1, cfg)
    assert float(loss(params)) < 1e-3


def test_sgd_momentum_converges():
    cfg = TrainConfig(grad_clip=0.0)
    params, loss = _quad_problem()
    state = sgd_init(params, cfg)
    for _ in range(100):
        params, state, _ = sgd_update(_grad(loss, params), state, params,
                                      0.05, cfg)
    assert float(loss(params)) < 1e-3


def test_bf16_moments_track_f32():
    cfg32 = TrainConfig(moment_dtype="float32", grad_clip=0.0)
    cfg16 = TrainConfig(moment_dtype="bfloat16", grad_clip=0.0)
    params, loss = _quad_problem()
    s32, s16 = adamw_init(params, cfg32), adamw_init(params, cfg16)
    p32 = p16 = params
    for _ in range(50):
        p32, s32, _ = adamw_update(_grad(loss, p32), s32, p32, 0.05, cfg32)
        p16, s16, _ = adamw_update(_grad(loss, p16), s16, p16, 0.05, cfg16)
    assert s16.m["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(p16["w"].numpy(), p32["w"].numpy(), atol=0.05)


def test_grad_clip():
    g = {"a": torch.full((10,), 100.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    cn = float(torch.sqrt(torch.sum(torch.square(clipped["a"]))))
    assert cn == pytest.approx(1.0, rel=1e-3)
    assert float(norm) == pytest.approx(np.sqrt(10) * 100, rel=1e-4)


def test_cosine_warmup_shape():
    lrs = [float(cosine_warmup(s, base_lr=1.0, warmup_steps=10,
                               total_steps=100)) for s in range(100)]
    assert lrs[0] < lrs[9]  # warming up
    assert max(lrs) == pytest.approx(1.0, rel=1e-2)
    assert lrs[-1] < 0.2  # decayed
    assert lrs[-1] >= 0.099  # min_ratio floor
