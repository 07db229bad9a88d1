"""Port of ``src/repro/launch/step_builders.py``: builders for the step
functions (train / prefill / decode / cross-pod FL round) with their
sharding plan.

Each builder takes the reference's arguments, with the port's mesh record
(``launch/mesh.py``) for the mesh. A ``StepBundle``'s ``fn`` is a plain
callable on tensors on the mesh's device; its ``in_specs`` are ``meta``
tensors and its shardings fields hold the plan's partition specs (tuples,
``sharding/rules.py``), for ``mesh_cfg`` as the reference's do.

On a mesh over a process group (``make_mesh`` inside one), ``fn`` lays
its arguments out as ``in_placements`` says (the plan on the real mesh:
parameters and moments FSDP over ``data``, tensor-parallel over
``model``, the batch over the batch axes, the decode cache's ``seq_kv``
over ``model``), as the reference's ``jit`` does with its
``in_shardings``, and returns DTensors laid out as its
``out_shardings``. Each rank gathers the parameters over the FSDP axes
only and computes with its ``model`` shards
(``sharding/tensor_parallel.py``: split matmuls, the vocab-parallel loss,
experts over ``expert``, flash-decode over the cache; Mamba2's blocks by
SSM heads, xLSTM's mLSTM blocks over their inner channels, by heads in
training and by the key dim of their state in decode, its sLSTM blocks
by heads), as GSPMD partitions the reference's steps; a leaf the model
runs whole (``tp_whole``: rule 1) is gathered over ``model`` too. The
decode state is laid out by ``cache_axes``, and a decode step moves
activations over ``model``, never state. The train step's gradient, each
rank's shard of it, is averaged
over the batch axes in f32: reduce-scattered over a leaf's FSDP dim,
all-reduced over the rest. On one device the same code runs with no
collective and places nothing. A batch shard whose MoE tokens would fall
into other routing groups than the whole batch's raises.

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
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch import _tree
from repro_torch.configs.base import (MeshConfig, ModelConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.models import build_model
from repro_torch.optim.optimizers import (OptState, adamw_init, adamw_update,
                                          opt_state_axes)
from repro_torch.optim.schedules import cosine_warmup
from repro_torch.sharding import tensor_parallel as tpar
from repro_torch.sharding.rules import (MeshPlan, Sharding,
                                        contiguous_stride, gather,
                                        is_axes_leaf, like, local, place,
                                        place_tree, placing, spec_axes)

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
    # Sharding trees of fn's tensor arguments on the real mesh (a None for
    # each on a mesh that places nothing: one device or meta)
    in_placements: Optional[tuple] = None
    # rule 1 on the real mesh: {"split": [...], "gathered": [...]}, the
    # paths of the parameter leaves the plan cuts over ``model`` that run
    # split there, and of those gathered to run whole (None: no group)
    tp_record: Optional[dict] = None


def _model(cfg: ModelConfig, plan: MeshPlan, mesh):
    """The model on this rank's device. The reference hands its models a
    ``Sharder``; the port's models take none (a step places the trees it
    is given), so only the mesh is checked here."""
    placing(mesh)  # raises on a mesh that could place nothing
    return build_model(cfg, device=mesh.device)


def _shardings(mesh, mesh_cfg: MeshConfig, pairs, extra_rules=()) -> tuple:
    """The Sharding tree of each ``(axes tree, shape tree)`` pair on
    ``mesh``, by ``mesh_cfg``'s rules at ``mesh``'s axis sizes (so the
    divisibility fallback keeps every shard whole); a None for each on a
    mesh that places nothing, which ``place_tree`` passes through."""
    if not placing(mesh):
        return (None,) * len(pairs)
    lay = MeshPlan(dataclasses.replace(mesh_cfg, shape=tuple(mesh.shape)),
                   extra_rules)
    return tuple(lay.tree_shardings(mesh, a, s) for a, s in pairs)


class _BatchAxes:
    """The dims of ``device_mesh`` of more than one rank that a batch's
    Sharding tree splits it over (its first leaf's spec, past ``skip``
    leading entries): each rank's gradient and loss are averaged over
    them, in f32. None for either (nothing placed): no ranks."""

    def __init__(self, device_mesh, shardings, skip: int = 0):
        self.groups, self.names, self.n = [], [], 1
        if device_mesh is None or shardings is None:
            return
        names = tuple(device_mesh.mesh_dim_names)
        specs = [sh.spec[skip:] for sh in _tree.leaves(shardings)]
        for e in next((sp for sp in specs if sp), ()):
            for j in (names.index(a) for a in spec_axes(e)):
                if device_mesh.size(j) > 1:
                    self.groups.append(device_mesh.get_group(j))
                    self.names.append(names[j])
                    self.n *= device_mesh.size(j)

    def check_moe_groups(self, cfg: ModelConfig, rows: int, seq: int
                         ) -> None:
        """Raise unless a batch of ``rows`` x ``seq`` tokens, split over
        these ranks, routes its MoE tokens in the whole batch's groups.
        ``moe_apply`` groups the tokens it is given, ``min(group_size, T)``
        at a time, so a rank's shard must hold whole groups of the whole
        batch: else capacities and dropped tokens would differ from one
        device's, silently."""
        if not cfg.num_experts or self.n == 1:
            return
        T = rows * seq
        g = min(cfg.moe_group_size, T)
        g = T if T % g else g  # moe_apply's single-group fallback
        if (T // self.n) % g:
            raise ValueError(
                f"a batch of {rows} x {seq} tokens over {self.n} ranks "
                f"leaves {T // self.n} tokens a rank, not a multiple of "
                f"the {g}-token MoE routing group of the whole batch: "
                f"raise the batch or seq_len, or lower moe_group_size")

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the batch's ranks, in ``t``'s dtype (the
        sum in f32, then one division); ``t`` itself over one rank."""
        if not self.groups:
            return t.detach()
        t32 = t.detach().to(torch.float32, copy=True)  # reduced in place
        for g in self.groups:
            dist.all_reduce(t32, group=g)
        return (t32 / self.n).to(t.dtype)


class _Compute:
    """How a model computes on a mesh: its ``model`` group (None: none)
    and, per parameter leaf, whether it keeps its ``model`` shard (it runs
    split) or is gathered over ``model`` too (``tp_whole``)."""

    def __init__(self, model, mesh):
        self.tp = tpar.model_group(mesh)
        self.keep = ([False] * len(_tree.leaves(model.param_shapes()))
                     if self.tp is None else
                     [not w for w in _tree.leaves(model.tp_whole(
                         self.tp.size))])

    def params(self, leaves) -> list:
        """Each leaf as this rank computes with it: gathered over every
        mesh dim but ``model`` where it keeps its shard (every rank
        calls: the gathers are collectives)."""
        with torch.no_grad():
            return [gather(p, keep=(tpar.AXIS,) if k else ())
                    for p, k in zip(leaves, self.keep)]

    def placed_params(self, params, lay):
        """``params`` laid out by ``lay`` (None: as they are), as this rank
        computes with them."""
        leaves, treedef = _tree.flatten(place_tree(params, lay))
        return _tree.unflatten(treedef, self.params(leaves))

    def kwargs(self) -> dict:
        return {} if self.tp is None else {"tp": self.tp}


def _grads_on_shards(model, params, batch, batch_axes, compute):
    """-> (loss, gradients laid out as ``params``): ``value_and_grad`` at
    the parameters as ``compute`` lays them out for this rank on its batch
    shard, each leaf's gradient averaged over the batch's ranks down to
    the rank's shard (``_grad_shard``; on one device: the plain
    ``value_and_grad``)."""
    leaves, treedef = _tree.flatten(params)
    run = compute.params(leaves)
    loss, grads = value_and_grad(model, _tree.unflatten(treedef, run),
                                 batch, **compute.kwargs())
    del run
    out = []
    with torch.no_grad():
        for p, g, k in zip(leaves, _tree.leaves(grads), compute.keep):
            out.append(like(p, _grad_shard(p, g, batch_axes, k)))
    return batch_axes.mean(loss), _tree.unflatten(treedef, out)


def _grad_shard(x, g, batch_axes, keep_model: bool):
    """This rank's shard of the mean over the batch's ranks of ``g``, the
    gradient of ``x`` as this rank computed with it, in ``g``'s dtype:
    over each mesh dim of more than one rank, a batch dim's partial sums
    are reduce-scattered along the dim it cuts ``x`` on (all-reduced when
    it cuts none), in f32; a dim the rank computed whole over (``model``
    for a leaf gathered there) is cut, no communication; a ``model`` shard
    it kept is its own already."""
    if not isinstance(x, DTensor):
        return batch_axes.mean(g)
    dm, t, summed, cut = x.device_mesh, g.detach(), False, False
    coord = dm.get_coordinate()
    for j, name in enumerate(dm.mesh_dim_names):
        n, pl = dm.size(j), x.placements[j]
        dim = pl.dim if isinstance(pl, Shard) else None
        if n == 1 or (keep_model and name == tpar.AXIS):
            continue
        if name not in batch_axes.names:
            if dim is not None:
                t, cut = t.chunk(n, dim=dim)[coord[j]], True
            continue
        if not summed:
            t, summed = t.to(torch.float32, copy=True), True
        if dim is None:
            dist.all_reduce(t, group=dm.get_group(j))
        else:
            parts = [c.contiguous() for c in t.chunk(n, dim=dim)]
            t = torch.empty_like(parts[0])
            dist.reduce_scatter_tensor(t, torch.cat(parts),
                                       group=dm.get_group(j))
    if not summed:  # a cut keeps no view of the whole gradient
        return t.clone(memory_format=torch.contiguous_format) if cut else t
    return (t / batch_axes.n).to(g.dtype)


def value_and_grad(model, params, batch, **kw):
    """-> (loss, gradient tree) of ``model.loss`` at ``params`` (``kw``:
    ``tp``, the model group the leaves are split over); each gradient in
    its parameter's dtype. A leaf the loss never reads gets zeros, as jax
    gives."""
    leaves, treedef = _tree.flatten(params)
    leaves = [l.detach().requires_grad_(True) for l in leaves]
    loss, _ = model.loss(_tree.unflatten(treedef, leaves), batch, **kw)
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
    gnorm, lr})``, out of place: the arguments are left as they were. On
    a mesh over a process group the trees are laid out by
    ``in_placements`` (the batch split over ``pod`` and ``data``) and come
    back as DTensors; the metrics are every rank's.
    """
    plan = MeshPlan(mesh_cfg)
    model = _model(cfg, plan, mesh)
    p_shapes, p_axes, opt_shapes, o_axes = _abstract(model, train_cfg)
    in_specs, in_axes = model.input_specs(shape)
    placed = _shardings(mesh, mesh_cfg, ((p_axes, p_shapes),
                                         (o_axes, opt_shapes),
                                         (in_axes, in_specs)))
    batch_axes = _BatchAxes(mesh.device_mesh, placed[2])
    batch_axes.check_moe_groups(
        cfg, shape.global_batch // train_cfg.microbatches, shape.seq_len)
    compute = _Compute(model, mesh)

    def grads_of(params, batch):
        return _grads_on_shards(model, params, batch, batch_axes, compute)

    def train_step(params, opt_state, batch, step):
        params, opt_state, batch = (place_tree(t, s) for t, s in zip(
            (params, opt_state, batch), placed))
        batch = _tree.map(local, batch)
        if train_cfg.microbatches > 1:
            n = train_cfg.microbatches
            gsum = _tree.map(lambda p: like(p, torch.zeros(
                local(p).shape, dtype=torch.float32,
                device=local(p).device)), params)
            lsum = 0.0
            for i in range(n):
                mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                      for k, v in batch.items()}
                l, g = grads_of(params, mb)
                with torch.no_grad():
                    _tree.map(lambda s, x: local(s).add_(local(x)), gsum, g)
                lsum = lsum + l
                del g
            with torch.no_grad():
                grads = _tree.map(lambda g: like(g, (local(g) / n).to(
                    torch.bfloat16)), gsum)
            del gsum
            loss = lsum / n
        else:
            loss, grads = grads_of(params, batch)
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
                      model, plan, {"params": p_shapes, "opt": opt_shapes},
                      placed, _tp_record(model, compute, placed[0]))


def _tp_record(model, compute, p_lay) -> Optional[dict]:
    """``StepBundle.tp_record`` from the parameters' Sharding tree."""
    if compute.tp is None or p_lay is None:
        return None
    rec = {"split": [], "gathered": []}
    for path, sh, keep in zip(_tree_paths(model.param_axes()),
                              _tree.leaves(p_lay), compute.keep):
        if any(tpar.AXIS in spec_axes(e) for e in sh.spec):
            rec["split" if keep else "gathered"].append(path)
    return rec


def _tree_paths(tree, prefix=()):
    """'/'-joined key paths of a nested dict's leaves, in leaf order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _tree_paths(tree[k], prefix + (k,))]
    return ["/".join(prefix)]


# ---------------------------------------------------------------------------
# serve steps (prefill forward / single-token decode)
# ---------------------------------------------------------------------------

def _place_batch(batch: dict, lay) -> dict:
    """The batch's tensors laid out by ``lay`` (None: as they are), as
    this rank's shards; the decode position passes through."""
    if lay is None:
        return batch
    return {k: v if k == "pos" else local(place(v, lay[k]))
            for k, v in batch.items()}


def _placed_out(x: torch.Tensor, sharding: Optional[Sharding], shape):
    """This rank's ``x`` as its shard of a DTensor of ``shape`` laid out by
    ``sharding`` (``x`` itself with none); its shape is checked against
    the layout's."""
    if sharding is None:
        return x
    dm = sharding.mesh.device_mesh
    want, coord = list(shape), dm.get_coordinate()
    for j, pl in enumerate(sharding.placements):
        if isinstance(pl, Shard):
            want[pl.dim] //= dm.size(j)
    if list(x.shape) != want:
        raise AssertionError(f"a shard of {tuple(x.shape)} where the "
                             f"layout {sharding.spec} of {tuple(shape)} on "
                             f"rank {coord} holds {tuple(want)}")
    return DTensor.from_local(x.contiguous(), dm, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      mesh_cfg: MeshConfig):
    """The forward of a batch of prompts -> the last position's logits. On
    a mesh over a process group they come back laid out as the reference's
    ``out_shardings``, ``("batch", "vocab")``."""
    plan = MeshPlan(mesh_cfg)
    model = _model(cfg, plan, mesh)
    compute = _Compute(model, mesh)
    p_shapes, p_axes = model.param_shapes(), model.param_axes()
    in_specs, in_axes = model.input_specs(shape)
    out_axes = ("batch", "vocab")
    out_shape = (shape.global_batch, cfg.vocab_size)
    out_sh = plan.spec(out_axes, out_shape)
    *placed, out_lay = _shardings(mesh, mesh_cfg, (
        (p_axes, p_shapes), (in_axes, in_specs),
        (out_axes, torch.empty(out_shape, device="meta"))))
    placed = tuple(placed)
    _BatchAxes(mesh.device_mesh, placed[1]).check_moe_groups(
        cfg, shape.global_batch, shape.seq_len)

    def prefill_step(params, batch):
        run = compute.placed_params(params, placed[0])
        with torch.no_grad():
            logits, _ = model.forward(run, _place_batch(batch, placed[1]),
                                      **compute.kwargs())
        # serving returns only the last-position logits
        return _placed_out(logits[:, -1], out_lay, out_shape)

    p_shard = plan.tree_specs(p_axes, p_shapes)
    b_shard = plan.tree_specs(in_axes, in_specs)
    return StepBundle(prefill_step, (p_shapes, in_specs),
                      (p_shard, b_shard), out_sh, model, plan,
                      {"params": p_shapes}, placed,
                      _tp_record(model, compute, placed[0]))


def make_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     mesh_cfg: MeshConfig):
    """One new token against a seq_len KV cache (decode_* cells). On a mesh
    over a process group the cache is laid out by ``cache_axes`` (its
    ``seq_kv`` over ``model``: flash-decode), and the logits come back as
    the reference's ``out_shardings``, ``("batch", None, "vocab")``."""
    plan = MeshPlan(mesh_cfg)
    model = _model(cfg, plan, mesh)
    compute = _Compute(model, mesh)
    p_shapes, p_axes = model.param_shapes(), model.param_axes()
    in_specs, in_axes = model.input_specs(shape)
    cache_spec = model.cache_spec(shape.global_batch, shape.seq_len)
    cache_axes = model.cache_axes()
    logits_axes = ("batch", None, "vocab")
    logits_shape = (shape.global_batch, 1, cfg.vocab_size)
    kv_axes = ("layers", "batch", "seq_kv")  # where the cache's seq lies
    *placed, out_lay, kv = _shardings(mesh, mesh_cfg, (
        (p_axes, p_shapes), (cache_axes, cache_spec), (in_axes, in_specs),
        (logits_axes, torch.empty(logits_shape, device="meta")),
        (kv_axes, torch.empty((1, shape.global_batch, shape.seq_len),
                              device="meta"))))
    placed = tuple(placed)
    _BatchAxes(mesh.device_mesh, placed[2]).check_moe_groups(
        cfg, shape.global_batch, 1)
    kw = compute.kwargs()
    if compute.tp is not None:
        kw["tp"] = dataclasses.replace(
            compute.tp, cache_split=any(tpar.AXIS in spec_axes(e)
                                        for e in kv.spec))

    def decode_step(params, cache, batch):
        """-> (logits, cache). The model's decode step writes the cache in
        place, so this step consumes ``cache`` and returns that same
        object, updated (the reference returns a new one); on a mesh, the
        cache laid out by ``in_placements`` (the same DTensors when they
        are laid out so already)."""
        run = compute.placed_params(params, placed[0])
        cache = place_tree(cache, placed[1])
        with torch.no_grad():
            logits, _ = model.decode_step(run, _tree.map(local, cache),
                                          _place_batch(batch, placed[2]),
                                          **kw)
        return _placed_out(logits, out_lay, logits_shape), cache

    p_shard = plan.tree_specs(p_axes, p_shapes)
    c_shard = plan.tree_specs(cache_axes, cache_spec)
    b_shard = plan.tree_specs(in_axes, in_specs)
    logit_sh = plan.spec(logits_axes, logits_shape)
    return StepBundle(decode_step, (p_shapes, cache_spec, in_specs),
                      (p_shard, c_shard, b_shard), (logit_sh, c_shard),
                      model, plan, {"params": p_shapes, "cache": cache_spec},
                      placed, _tp_record(model, compute, placed[0]))


# ---------------------------------------------------------------------------
# cross-pod FL round (the paper's technique at pod scale)
# ---------------------------------------------------------------------------

def _mean(scalars):
    """The mean as jnp's: the sum, then one division (``torch.mean``
    multiplies by 1/n, a different rounding for n not a power of 2)."""
    return torch.sum(torch.stack(scalars)) / len(scalars)


def crosspod_mean(anchor_leaf, stacked_leaf, compression: str, *,
                  n_pods: Optional[int] = None, pod_group=None,
                  scale_group=None):
    """The pods' mean delta from ``anchor_leaf`` (f32), as the round
    exchanges it. ``"int8"``: one scale over all pods, ``max|delta| / 127
    + 1e-12``; each delta rounded half to even to an int8 level in
    [-127, 127]; the levels summed over pods in int32, times the scale,
    over the pod count. Otherwise the f32 mean of the deltas.

    ``stacked_leaf`` holds this rank's pods (all ``n_pods`` of them when
    no group is given). Over several ranks the max is all-reduced over
    ``scale_group`` (every rank of the mesh: all pods, all shards), and
    the int8 levels (or f32 deltas) are all-gathered over ``pod_group``
    in pod order before the sum. Max and an integer sum do not depend on
    order, so an int8 exchange is bit for bit the one-device one."""
    n_pods = stacked_leaf.shape[0] if n_pods is None else n_pods
    delta = stacked_leaf.float() - anchor_leaf.float()[None]
    if compression == "int8":
        amax = torch.max(torch.abs(delta))
        if scale_group is not None:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=scale_group)
        scale = amax / 127.0 + 1e-12
        q = torch.clamp(torch.round(delta / scale), -127, 127).to(torch.int8)
        del delta
        q = _gather_pods(q, pod_group)  # 1-byte payloads on the wire
        return (torch.sum(q.to(torch.int32), dim=0).float() * scale
                / n_pods)
    return torch.sum(_gather_pods(delta, pod_group), dim=0) / n_pods


def _gather_pods(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's pods of ``x`` (leading dim), in pod order."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def make_fl_round_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       mesh_cfg: MeshConfig, train_cfg: TrainConfig,
                       *, local_steps: int = 4):
    """DiLoCo-style: each pod trains ``local_steps`` on its own batch, then
    pods exchange int8-quantised deltas. Requires the pod axis.

    ``fn(params_stacked, opt_stacked, anchor, batches, step) -> (reset,
    opt_stacked, new_anchor, loss)``: the parameters, optimizer states and
    batches are stacked over a leading pod dimension (batches ``(n_pods,
    local_steps, batch / n_pods, ...)``), ``n_pods`` being ``mesh_cfg``'s
    pod count. The reference ``vmap``s the pods over its mesh. Here the
    real mesh's pod axis, of size ``p``, must divide ``n_pods``: each rank
    holds ``n_pods / p`` pods and runs them one after another, each pod's
    steps written into its own slice of the stacked trees. On one device
    (``p = 1``) that is every pod; over a process group the stacked trees
    are laid out by ``in_placements`` (pods over ``pod``, each pod's
    leaves by the plan over ``data`` and ``model``, its batch over
    ``data``), and each pod's norm is its own. ``fn`` consumes
    ``params_stacked`` and ``opt_stacked``: it returns those same trees
    (on one device; over a group, the placed ones), the optimizer state
    stepped (not reset) and every pod's parameters a copy of the new
    anchor.

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
                         is_leaf=is_axes_leaf)

    stack_rules = (("pod_stack", ("pod",)),)
    plan_stacked = MeshPlan(pod_mesh_cfg, extra_rules=stack_rules)
    ps_shapes, ps_axes = stack(p_shapes), stack_axes(p_axes)
    os_shapes, os_axes = stack(opt_shapes), stack_axes(o_axes)
    # per-pod batch: local batch = global/n_pods, stacked over pods
    bs_specs = _tree.map(
        lambda s: torch.empty((n_pods, local_steps, s.shape[0] // n_pods)
                              + tuple(s.shape[1:]), dtype=s.dtype,
                              device="meta"), in_specs)
    bs_axes = stack_axes(in_axes, ("pod_stack", None))

    pods = _PodLayout(mesh, n_pods)
    ps_lay, os_lay, bs_lay = _shardings(
        mesh, pod_mesh_cfg, ((ps_axes, ps_shapes), (os_axes, os_shapes),
                             (bs_axes, bs_specs)), stack_rules)
    # the anchor as one pod's slice of the stacked layout, on every pod
    a_lay = None if ps_lay is None else _tree.map(
        lambda sh: Sharding(mesh, _trim(sh.spec[1:])), ps_lay)
    placed = (ps_lay, os_lay, a_lay, bs_lay)
    batch_axes = _BatchAxes(pods.sub_mesh, bs_lay, skip=1)
    batch_axes.check_moe_groups(cfg, shape.global_batch // n_pods,
                                shape.seq_len)
    compute = _Compute(model, mesh)

    def pod_slice(tree, i):
        return _tree.map(lambda x: pods.slice(x, i), tree)

    def place(args, which):
        return tuple(place_tree(t, placed[w]) for t, w in zip(args, which))

    def local_steps_fn(params_stacked, opt_stacked, batches, step):
        """Every pod's ``local_steps`` AdamW steps, each pod's written into
        its slice of the stacked trees. -> (params_stacked, opt_stacked,
        the mean loss over pods and steps)."""
        params_stacked, opt_stacked, batches = place(
            (params_stacked, opt_stacked, batches), (0, 1, 3))
        lr = _lr(step, train_cfg, mesh.device)  # one lr for every step
        pod_losses = []
        for i in range(pods.here):
            p, o = pod_slice(params_stacked, i), pod_slice(opt_stacked, i)
            losses = []
            for k in range(local_steps):
                mb = {key: local(v)[i, k] for key, v in batches.items()}
                loss, g = _grads_on_shards(model, p, mb, batch_axes,
                                           compute)
                p, o, _ = adamw_update(g, o, p, lr, train_cfg, inplace=True)
                losses.append(loss)
                del g
            pod_losses.append(_mean(losses))
        # every pod's loss, in pod order
        pod_losses = list(_gather_pods(torch.stack(pod_losses),
                                       pods.pod_group))
        return params_stacked, opt_stacked, _mean(pod_losses)

    def exchange(anchor, params_stacked):
        """-> (params_stacked with every pod set to the new anchor, the new
        anchor): each leaf's anchor plus the pods' exchanged mean delta,
        in the anchor's dtype."""
        anchor, params_stacked = place((anchor, params_stacked), (2, 0))
        a_leaves, treedef = _tree.flatten(anchor)
        s_leaves, sdef = _tree.flatten(params_stacked)
        if sdef != treedef:
            raise ValueError("fl_round: anchor and pods differ in structure")
        new = []
        with torch.no_grad():
            for a, s in zip(a_leaves, s_leaves):
                a_l, s_l = local(a), local(s)
                mean = crosspod_mean(a_l, s_l, train_cfg.crosspod_compression,
                                     n_pods=n_pods, pod_group=pods.pod_group,
                                     scale_group=pods.scale_group)
                new.append(like(a, (a_l.float() + mean).to(a.dtype)))
                del mean
                s_l.copy_(local(new[-1]).expand_as(s_l))  # a copy per pod
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
                      {"params": ps_shapes, "opt": os_shapes}, placed)


def _trim(spec: tuple) -> tuple:
    """``spec`` without trailing ``None``s, as the plan writes specs."""
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


class _PodLayout:
    """The pods on a mesh: ``here`` pods on each rank, the ``pod``
    sub-group the exchange gathers over, the group its scales are
    all-reduced over (every rank), and the mesh of one pod's ranks
    (``data`` x ``model``), on which a pod's slice of a stacked DTensor
    lives. On a mesh that places nothing every pod is here, with no
    groups and no sub-mesh."""

    def __init__(self, mesh, n_pods: int):
        self.here = n_pods
        self.pod_group = self.scale_group = self.sub_mesh = None
        if not placing(mesh):
            return
        dm = mesh.device_mesh
        names = tuple(dm.mesh_dim_names)
        p = dm.size(names.index("pod"))
        if n_pods % p:
            raise ValueError(f"{n_pods} pods do not divide over the mesh's "
                             f"pod axis of {p}")
        self.here = n_pods // p
        self.pod_group = dm.get_group("pod")
        self.scale_group = dist.group.WORLD
        self.rest = tuple(n for n in names if n != "pod")
        self.sub_mesh = dm[self.rest] if self.rest else None

    def slice(self, x, i: int):
        """Pod ``i`` (of this rank's) of a stacked leaf: a view of its
        local rows, as a DTensor on the pod's mesh."""
        if not isinstance(x, DTensor) or self.sub_mesh is None:
            return local(x)[i]
        names = tuple(x.device_mesh.mesh_dim_names)
        sub = tuple(Shard(pl.dim - 1) if isinstance(pl, Shard) else pl
                    for pl in (x.placements[names.index(n)]
                               for n in self.rest))
        return DTensor.from_local(local(x)[i], self.sub_mesh, sub,
                                  run_check=False, shape=x.shape[1:],
                                  stride=contiguous_stride(x.shape[1:]))


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
