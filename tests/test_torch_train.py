"""The LM zoo's training step, port against the JAX reference on the CPU:
``launch/step_builders.make_train_step`` on every arch's smoke config in
f32 for 3 steps (two archs also with 2 microbatches, one in its own
bf16), held against the reference's own step function as ``bundle_for``
builds it, jitted with its shardings.

The reference's step bundles run on jax 0.9.0 over a mesh whose axes are
``AxisType.Auto``; ``make_smoke_mesh``'s Explicit axes make jax reject
``with_sharding_constraint`` (ROADMAP C). Both packages start from the
reference's initialised parameters and take the same seeded numpy
batches (``_torch_zoo``).

Bars: the parameters and both moments at 1e-4 of each leaf's largest
entry (``_torch_zoo.close``); loss, gnorm and lr at rtol 1e-5; the bf16
arch's loss at 5e-2. Two exceptions, both forced by the arithmetic:

- Zamba's per-application LoRA starts at zero (``b``), so ``a``'s first
  gradient is exactly zero and its next ones are products with a ``b``
  of the size of one lr step: entries near AdamW's eps (1e-8), where
  ``m / (sqrt(v) + eps)`` turns f32 summation-order noise into a
  visible share of a step. These leaves are held at 1e-4 of the tree's
  largest entry (as ROADMAP C holds zero-gradient leaves to the model's
  largest), which they meet 16x over (6.3e-6).
- With 2 microbatches the step casts its gradients to bf16
  (``step_builders.py:80``), so an f32 difference in the last bit can
  flip a gradient entry by one bf16 ULP (2^-8): the microbatched runs
  are held at 2^-8 of each leaf's largest entry (1.3e-3 read).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import _torch_zoo as Z  # noqa: E402
from repro.configs.base import SMOKE_MESH as JSMOKE_MESH  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.launch.step_builders import bundle_for as jbundle  # noqa: E402
from repro.optim.optimizers import adamw_init as jadamw_init  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.configs import ARCH_ORDER, smoke_config  # noqa: E402
from repro_torch.configs.base import (SMOKE_MESH, ShapeConfig,  # noqa: E402
                                      TrainConfig)
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.launch.step_builders import bundle_for  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

STEPS = 3
METRIC_RTOL = 1e-5
BF16_ULP = 2.0 ** -8
# leaves AdamW steps from eps-sized gradients (see the module docstring)
TREE_WIDE = {"zamba2-1.2b": ("['lora']",)}
BATCH, SEQ = 4, 16
# a schedule that moves the parameters: lr 5e-4, 1e-3, ~1e-3 over 3 steps
TRAIN = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)


def ref_train(jcfg, jparams, batches, microbatches=1):
    """The reference's jitted train step, ``len(batches)`` steps -> (params,
    opt state, [metrics])."""
    mesh = Z.auto_mesh((1, 1), ("data", "model"))
    tcfg = JTrain(microbatches=microbatches, **TRAIN)
    b = jbundle("train", jcfg, JShape("t", SEQ, BATCH, "train"), mesh,
                JSMOKE_MESH, tcfg)
    fn = jax.jit(b.fn, in_shardings=b.in_shardings,
                 out_shardings=b.out_shardings)
    params = jax.tree.map(jnp.asarray, jparams)
    opt = jadamw_init(params, tcfg)
    out = []
    with mesh:
        for step, batch in enumerate(batches):
            params, opt, m = fn(params, opt, Z.to_jax(batch), jnp.int32(step))
            out.append({k: float(v) for k, v in m.items()})
    return params, opt, out


def port_train(tcfg_model, tparams, batches, microbatches=1):
    tcfg = TrainConfig(microbatches=microbatches, **TRAIN)
    b = bundle_for("train", tcfg_model, ShapeConfig("t", SEQ, BATCH, "train"),
                   make_smoke_mesh("cpu"), SMOKE_MESH, tcfg)
    params, opt = tparams, adamw_init(tparams, tcfg)
    out = []
    for step, batch in enumerate(batches):
        params, opt, m = b.fn(params, opt, Z.to_torch(batch), step)
        out.append({k: float(v) for k, v in m.items()})
    return params, opt, out


def run_both(arch, microbatches=1, precision="f32"):
    jm, jp, tm, tp = Z.pair(arch, precision)
    batches = [Z.batch(tm.cfg, seed, BATCH, SEQ) for seed in range(STEPS)]
    want = ref_train(jm.cfg, jp, batches, microbatches)
    got = port_train(tm.cfg, tp, batches, microbatches)
    return got, want


@pytest.mark.parametrize("arch", ARCH_ORDER)
def test_train_step_matches_reference(arch):
    (tp, to, tm), (jp, jo, jm) = run_both(arch)
    for g, w in zip(tm, jm):
        for k in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL,
                                       err_msg=k)
    wide = TREE_WIDE.get(arch, ())
    Z.trees_match(tp, jp, tree_wide=wide)
    Z.trees_match(to.m, jo.m, tree_wide=wide)
    Z.trees_match(to.v, jo.v, tree_wide=wide)
    assert int(to.count) == int(jo.count) == STEPS
    assert to.count.dtype == torch.int32


@pytest.mark.parametrize("arch", ["qwen3-8b", "zamba2-1.2b"])
def test_train_step_microbatches_match_reference(arch):
    """2 microbatches: gradients summed in f32, then cast to bf16 whatever
    the parameter dtype (``step_builders.py:68-83``)."""
    (tp, to, tm), (jp, jo, jm) = run_both(arch, microbatches=2)
    for g, w in zip(tm, jm):
        for k in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL,
                                       err_msg=k)
    Z.trees_match(tp, jp, BF16_ULP)
    Z.trees_match(to.m, jo.m, BF16_ULP)
    Z.trees_match(to.v, jo.v, BF16_ULP)


def test_train_step_bf16_loss_matches_reference():
    """qwen3-8b's smoke config in its own bf16 parameters."""
    (_, _, tm), (_, _, jm) = run_both("qwen3-8b", precision="bf16")
    for g, w in zip(tm, jm):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=Z.BF16_BAR)


def test_train_step_is_out_of_place():
    """The step returns new trees and leaves its arguments as they were,
    as the reference's pure function does."""
    cfg = Z.f32(smoke_config("qwen3-8b"))
    b = bundle_for("train", cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                   make_smoke_mesh("cpu"), SMOKE_MESH, TrainConfig(**TRAIN))
    params = b.model.init(torch.Generator().manual_seed(0))
    opt = adamw_init(params, TrainConfig())
    before = [l.clone() for l in _tree.leaves((params, opt))]
    new_p, new_o, _ = b.fn(params, opt, Z.to_torch(Z.batch(cfg, 0, BATCH,
                                                            SEQ)), 0)
    for a, l in zip(before, _tree.leaves((params, opt))):
        assert torch.equal(a, l)
    assert not torch.equal(_tree.leaves(new_p)[0], _tree.leaves(params)[0])
    assert int(new_o.count) == 1
