"""Port of ``src/repro/launch/step_builders.py``: builders for the step
functions (train / prefill / decode / cross-pod FL round) with their
sharding plan.

Each builder takes the reference's arguments, with the port's mesh record
(``launch/mesh.py``) for the mesh. A ``StepBundle``'s ``fn`` is a plain
callable on tensors on the mesh's device; its ``in_specs`` are ``meta``
tensors and its shardings fields hold the plan's partition specs (tuples,
``sharding/rules.py``). The port runs on one device, so the specs describe
the reference's layout and place nothing.

Gradients come from ``torch.autograd.grad`` over the parameter leaves.
The train step's gradient accumulation keeps the reference's arithmetic
(an f32 sum from zeros, then ``(g / n)`` cast to bf16 whatever the
parameter dtype), and every optimizer update its operations
(``optim/optimizers.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import _tree
from repro_torch.configs.base import (MeshConfig, ModelConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.models import build_model
from repro_torch.optim.optimizers import (OptState, adamw_init, adamw_update,
                                          opt_state_axes)
from repro_torch.optim.schedules import cosine_warmup
from repro_torch.sharding.rules import MeshPlan, Sharder, _is_axes


@dataclasses.dataclass
class StepBundle:
    """Everything needed to run one cell."""
    fn: object  # callable on tensors
    in_specs: tuple  # meta-tensor trees of fn's arguments
    in_shardings: tuple  # partition-spec trees of fn's arguments
    out_shardings: object
    model: object
    plan: MeshPlan
    abstract_state: object  # params/opt/cache meta trees (for reports)


def _is_axes_leaf(x) -> bool:
    return x is None or (isinstance(x, tuple) and _is_axes(x))


def _model(cfg: ModelConfig, plan: MeshPlan, mesh):
    """The model on the mesh's device. The reference hands its models a
    ``Sharder``; the port's models take none, so the sharder is checked
    here: on a mesh of more than one device it raises."""
    Sharder(plan, mesh)(None, ())
    return build_model(cfg, device=mesh.device)


def value_and_grad(model, params, batch):
    """-> (loss, gradient tree) of ``model.loss`` at ``params``; each
    gradient in its parameter's dtype. A leaf the loss never reads gets
    zeros, as jax gives."""
    leaves, treedef = _tree.flatten(params)
    leaves = [l.detach().requires_grad_(True) for l in leaves]
    loss, _ = model.loss(_tree.unflatten(treedef, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), _tree.unflatten(treedef, list(grads))


def _lr(step, train_cfg: TrainConfig, device):
    return cosine_warmup(step, base_lr=train_cfg.learning_rate,
                         warmup_steps=train_cfg.warmup_steps,
                         total_steps=train_cfg.total_steps, device=device)


def _abstract(model, train_cfg: TrainConfig):
    p_shapes, p_axes = model.param_shapes(), model.param_axes()
    opt_shapes = adamw_init(p_shapes, train_cfg)
    return p_shapes, p_axes, opt_shapes, opt_state_axes(p_axes, train_cfg)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    mesh_cfg: MeshConfig, train_cfg: TrainConfig,
                    *, fl_pods: bool = False):
    """Synchronous data/tensor-parallel train step (one optimizer update).

    ``fn(params, opt_state, batch, step) -> (params, opt_state, {loss,
    gnorm, lr})``, out of place: the arguments are left as they were.
    """
    plan = MeshPlan(mesh_cfg)
    model = _model(cfg, plan, mesh)
    p_shapes, p_axes, opt_shapes, o_axes = _abstract(model, train_cfg)
    in_specs, in_axes = model.input_specs(shape)

    def train_step(params, opt_state, batch, step):
        if train_cfg.microbatches > 1:
            n = train_cfg.microbatches
            gsum = _tree.map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            lsum = 0.0
            for i in range(n):
                mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                      for k, v in batch.items()}
                l, g = value_and_grad(model, params, mb)
                with torch.no_grad():
                    _tree.map(lambda s, x: s.add_(x), gsum, g)
                lsum = lsum + l
                del g
            with torch.no_grad():
                grads = _tree.map(lambda g: (g / n).to(torch.bfloat16), gsum)
            del gsum
            loss = lsum / n
        else:
            loss, grads = value_and_grad(model, params, batch)
        lr = _lr(step, train_cfg, mesh.device)
        new_params, new_opt, gnorm = adamw_update(grads, opt_state, params,
                                                  lr, train_cfg)
        return new_params, new_opt, {"loss": loss, "gnorm": gnorm, "lr": lr}

    p_shard = plan.tree_specs(p_axes, p_shapes)
    o_shard = plan.tree_specs(o_axes, opt_shapes)
    b_shard = plan.tree_specs(in_axes, in_specs)
    in_shardings = (p_shard, o_shard, b_shard, ())
    out_shardings = (p_shard, o_shard, {"loss": (), "gnorm": (), "lr": ()})
    lower_args = (p_shapes, opt_shapes, in_specs,
                  torch.empty((), dtype=torch.int32, device="meta"))
    return StepBundle(train_step, lower_args, in_shardings, out_shardings,
                      model, plan, {"params": p_shapes, "opt": opt_shapes})


# ---------------------------------------------------------------------------
# serve steps (prefill forward / single-token decode)
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      mesh_cfg: MeshConfig):
    plan = MeshPlan(mesh_cfg)
    model = _model(cfg, plan, mesh)
    p_shapes, p_axes = model.param_shapes(), model.param_axes()
    in_specs, in_axes = model.input_specs(shape)

    def prefill_step(params, batch):
        with torch.no_grad():
            logits, _ = model.forward(params, batch)
        # serving returns only the last-position logits
        return logits[:, -1]

    p_shard = plan.tree_specs(p_axes, p_shapes)
    b_shard = plan.tree_specs(in_axes, in_specs)
    out_sh = plan.spec(("batch", "vocab"),
                       (shape.global_batch, cfg.vocab_size))
    return StepBundle(prefill_step, (p_shapes, in_specs),
                      (p_shard, b_shard), out_sh, model, plan,
                      {"params": p_shapes})


def make_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     mesh_cfg: MeshConfig):
    """One new token against a seq_len KV cache (decode_* cells)."""
    plan = MeshPlan(mesh_cfg)
    model = _model(cfg, plan, mesh)
    p_shapes, p_axes = model.param_shapes(), model.param_axes()
    in_specs, in_axes = model.input_specs(shape)
    cache_spec = model.cache_spec(shape.global_batch, shape.seq_len)
    cache_axes = model.cache_axes()

    def decode_step(params, cache, batch):
        """-> (logits, cache). The model's decode step writes the cache in
        place, so this step consumes ``cache`` and returns that same
        object, updated (the reference returns a new one)."""
        with torch.no_grad():
            return model.decode_step(params, cache, batch)

    p_shard = plan.tree_specs(p_axes, p_shapes)
    c_shard = plan.tree_specs(cache_axes, cache_spec)
    b_shard = plan.tree_specs(in_axes, in_specs)
    logit_sh = plan.spec(("batch", None, "vocab"),
                         (shape.global_batch, 1, cfg.vocab_size))
    return StepBundle(decode_step, (p_shapes, cache_spec, in_specs),
                      (p_shard, c_shard, b_shard), (logit_sh, c_shard),
                      model, plan, {"params": p_shapes, "cache": cache_spec})


# ---------------------------------------------------------------------------
# cross-pod FL round (the paper's technique at pod scale)
# ---------------------------------------------------------------------------

def _mean(scalars):
    """The mean as jnp's: the sum, then one division (``torch.mean``
    multiplies by 1/n, a different rounding for n not a power of 2)."""
    return torch.sum(torch.stack(scalars)) / len(scalars)


def crosspod_mean(anchor_leaf, stacked_leaf, compression: str):
    """The pods' mean delta from ``anchor_leaf`` (f32), as the round
    exchanges it. ``"int8"``: one scale over all pods, ``max|delta| / 127
    + 1e-12``; each delta rounded half to even to an int8 level in
    [-127, 127]; the levels summed over pods in int32, times the scale,
    over the pod count. Otherwise the f32 mean of the deltas."""
    n_pods = stacked_leaf.shape[0]
    delta = stacked_leaf.float() - anchor_leaf.float()[None]
    if compression == "int8":
        scale = torch.max(torch.abs(delta)) / 127.0 + 1e-12
        q = torch.clamp(torch.round(delta / scale), -127, 127).to(torch.int8)
        del delta
        return (torch.sum(q.to(torch.int32), dim=0).float() * scale
                / n_pods)
    return torch.sum(delta, dim=0) / n_pods


def make_fl_round_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       mesh_cfg: MeshConfig, train_cfg: TrainConfig,
                       *, local_steps: int = 4):
    """DiLoCo-style: each pod trains ``local_steps`` on its own batch, then
    pods exchange int8-quantised deltas. Requires the pod axis.

    ``fn(params_stacked, opt_stacked, anchor, batches, step) -> (reset,
    opt_stacked, new_anchor, loss)``: the parameters, optimizer states and
    batches are stacked over a leading pod dimension (batches ``(n_pods,
    local_steps, batch / n_pods, ...)``). The reference ``vmap``s the pods
    over its mesh; one device here runs them one after another, each
    pod's steps written into its own slice of the stacked trees. So ``fn``
    consumes ``params_stacked`` and ``opt_stacked``: it returns those same
    trees, the optimizer state stepped (not reset) and every pod's
    parameters a copy of the new anchor.

    ``fn.local_steps(params_stacked, opt_stacked, batches, step)`` and
    ``fn.exchange(anchor, params_stacked)`` are its two halves, for a
    caller that checks the exchange against the pods' own deltas.
    """
    assert "pod" in mesh_cfg.axis_names, "fl round needs the pod axis"
    n_pods = mesh_cfg.axis_size("pod")
    # per-pod plan: batch maps to 'data' only (pod handled by stacking)
    pod_mesh_cfg = dataclasses.replace(mesh_cfg, batch_axes=("data",))
    plan = MeshPlan(pod_mesh_cfg)
    model = _model(cfg, plan, mesh)
    p_shapes, p_axes, opt_shapes, o_axes = _abstract(model, train_cfg)
    in_specs, in_axes = model.input_specs(shape)

    # stack over pods: leading 'pod' logical axis
    def stack(tree, lead=(n_pods,)):
        return _tree.map(lambda s: torch.empty(lead + tuple(s.shape),
                                               dtype=s.dtype, device="meta"),
                         tree)

    def stack_axes(tree, lead=("pod_stack",)):
        return _tree.map(lambda a: lead + tuple(a or ()), tree,
                         is_leaf=_is_axes_leaf)

    plan_stacked = MeshPlan(pod_mesh_cfg,
                            extra_rules=(("pod_stack", ("pod",)),))
    ps_shapes, ps_axes = stack(p_shapes), stack_axes(p_axes)
    os_shapes, os_axes = stack(opt_shapes), stack_axes(o_axes)
    # per-pod batch: local batch = global/n_pods, stacked over pods
    bs_specs = _tree.map(
        lambda s: torch.empty((n_pods, local_steps, s.shape[0] // n_pods)
                              + tuple(s.shape[1:]), dtype=s.dtype,
                              device="meta"), in_specs)
    bs_axes = stack_axes(in_axes, ("pod_stack", None))

    def pod_slice(tree, i):
        return _tree.map(lambda x: x[i], tree)

    def local_steps_fn(params_stacked, opt_stacked, batches, step):
        """Every pod's ``local_steps`` AdamW steps, each pod's written into
        its slice of the stacked trees. -> (params_stacked, opt_stacked,
        the mean loss over pods and steps)."""
        lr = _lr(step, train_cfg, mesh.device)  # one lr for every step
        pod_losses = []
        for i in range(n_pods):
            p, o = pod_slice(params_stacked, i), pod_slice(opt_stacked, i)
            losses = []
            for k in range(local_steps):
                mb = {key: v[i, k] for key, v in batches.items()}
                loss, g = value_and_grad(model, p, mb)
                p, o, _ = adamw_update(g, o, p, lr, train_cfg, inplace=True)
                losses.append(loss)
                del g
            pod_losses.append(_mean(losses))
        return params_stacked, opt_stacked, _mean(pod_losses)

    def exchange(anchor, params_stacked):
        """-> (params_stacked with every pod set to the new anchor, the new
        anchor): each leaf's anchor plus the pods' exchanged mean delta,
        in the anchor's dtype."""
        a_leaves, treedef = _tree.flatten(anchor)
        s_leaves, sdef = _tree.flatten(params_stacked)
        if sdef != treedef:
            raise ValueError("fl_round: anchor and pods differ in structure")
        new = []
        with torch.no_grad():
            for a, s in zip(a_leaves, s_leaves):
                mean = crosspod_mean(a, s, train_cfg.crosspod_compression)
                new.append((a.float() + mean).to(a.dtype))
                del mean
                s.copy_(new[-1].expand_as(s))  # reset: a real copy per pod
        return params_stacked, _tree.unflatten(treedef, new)

    def fl_round(params_stacked, opt_stacked, anchor, batches, step):
        new_p, new_o, loss = local_steps_fn(params_stacked, opt_stacked,
                                            batches, step)
        reset, new_anchor = exchange(anchor, new_p)
        return reset, new_o, new_anchor, loss

    fl_round.local_steps = local_steps_fn
    fl_round.exchange = exchange

    ps_shard = plan_stacked.tree_specs(ps_axes, ps_shapes)
    os_shard = plan_stacked.tree_specs(os_axes, os_shapes)
    a_shard = plan_stacked.tree_specs(p_axes, p_shapes)
    b_shard = plan_stacked.tree_specs(bs_axes, bs_specs)
    in_shardings = (ps_shard, os_shard, a_shard, b_shard, ())
    out_shardings = (ps_shard, os_shard, a_shard, ())
    lower_args = (ps_shapes, os_shapes, p_shapes, bs_specs,
                  torch.empty((), dtype=torch.int32, device="meta"))
    return StepBundle(fl_round, lower_args, in_shardings, out_shardings,
                      model, plan_stacked,
                      {"params": ps_shapes, "opt": os_shapes})


def stack_pods(tree, n_pods: int):
    """``tree`` repeated over a new leading pod dimension (real copies),
    the layout ``make_fl_round_step``'s ``fn`` takes."""
    return _tree.map(lambda x: x.unsqueeze(0).repeat(
        (n_pods,) + (1,) * x.dim()), tree)


def bundle_for(kind: str, cfg: ModelConfig, shape: ShapeConfig, mesh,
               mesh_cfg: MeshConfig, train_cfg: Optional[TrainConfig] = None,
               **kw):
    train_cfg = train_cfg or TrainConfig()
    if kind == "train":
        return make_train_step(cfg, shape, mesh, mesh_cfg, train_cfg, **kw)
    if kind == "prefill":
        return make_prefill_step(cfg, shape, mesh, mesh_cfg)
    if kind == "decode":
        return make_decode_step(cfg, shape, mesh, mesh_cfg)
    if kind == "fl_round":
        return make_fl_round_step(cfg, shape, mesh, mesh_cfg, train_cfg, **kw)
    raise ValueError(kind)
