"""Port of ``src/repro/optim/optimizers.py``: tree optimizers (AdamW and
SGD with momentum) and global-norm clipping, on the port's parameter trees
(``repro_torch._tree``).

Each update keeps the reference's arithmetic operation for operation, in
f32, and casts back to each leaf's and each moment's own dtype; the
leaves are visited in ``jax.tree.leaves`` order, so the global norm sums
them in the reference's order. ``torch.optim.AdamW`` is a different
update (its decoupled decay scales ``p`` by ``1 - lr*wd`` before the Adam
step) and is not used. Updates are out of place: they return new trees,
as the reference's do, and run without autograd.

Leaves may be DTensors (``sharding/rules.py``), all of a tree's leaves
laid out alike across the trees: each update runs on the local shards,
elementwise, and the global norm sums each leaf's squares over the mesh
dims that cut it, so every element counts once. A tree on a sub-mesh
(one pod's, in the FL round) sums over that sub-mesh only.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch import _tree
from repro_torch.configs.base import TrainConfig
from repro_torch.models.layers import dtype_of
from repro_torch.sharding.rules import like, local, sharded_dims


class OptState(NamedTuple):
    count: torch.Tensor  # 0-d int32
    m: dict
    v: dict  # empty dict for sgd


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled so their global L2 norm is at most ``max_norm``,
    the norm before scaling). ``max_norm`` 0 leaves them as they are and
    reports a norm of 0."""
    leaves = _tree.leaves(grads)
    if not max_norm:
        dev = local(leaves[0]).device if leaves else None
        return grads, torch.zeros((), dtype=torch.float32, device=dev)
    with torch.no_grad():
        total = 0
        for s in _squared_sums(leaves):
            total = total + s
        gnorm = torch.sqrt(total)
        # a true division: ``float / tensor`` would multiply by the
        # reciprocal, a second rounding
        scale = torch.clamp(torch.div(torch.full_like(gnorm, max_norm),
                                      torch.clamp(gnorm, min=1e-9)), max=1.0)
        return _tree.map(lambda g: like(g, (local(g).float() * scale).to(
            g.dtype)), grads), gnorm


def _squared_sums(leaves) -> list:
    """Each leaf's f32 sum of squares over all its elements: a DTensor's
    local sums all-reduced over the mesh dims of more than one rank that
    cut it, one collective per (mesh, dims) set."""
    sums = [torch.sum(torch.square(local(g).float())) for g in leaves]
    sets = []  # [(device mesh, dims, leaf indices)]
    for i, g in enumerate(leaves):
        dims = tuple(j for j in sharded_dims(g) if g.device_mesh.size(j) > 1)
        if not dims:
            continue
        for dm, ds, idx in sets:
            if ds == dims and dm == g.device_mesh:
                idx.append(i)
                break
        else:
            sets.append((g.device_mesh, dims, [i]))
    for dm, dims, idx in sets:
        buf = torch.stack([sums[i] for i in idx])
        for j in dims:
            dist.all_reduce(buf, group=dm.get_group(j))
        for k, i in enumerate(idx):
            sums[i] = buf[k]
    return sums


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _zeros_like(params, dtype):
    return _tree.map(lambda p: like(p, torch.zeros(
        local(p).shape, dtype=dtype, device=local(p).device)), params)


def _count0(params):
    leaves = _tree.leaves(params)
    return torch.zeros((), dtype=torch.int32,
                       device=local(leaves[0]).device if leaves else None)


def adamw_init(params, cfg: TrainConfig) -> OptState:
    mdt = dtype_of(cfg.moment_dtype)
    return OptState(count=_count0(params), m=_zeros_like(params, mdt),
                    v=_zeros_like(params, mdt))


def adamw_update(grads, state: OptState, params, lr, cfg: TrainConfig, *,
                 inplace: bool = False):
    """-> (new params, new state, the gradients' global norm).

    ``inplace`` writes the results into ``params`` and ``state`` (views
    too: one pod's slice of a stacked tree) and returns those same trees,
    with the same roundings: a memory saving for the cross-pod round,
    which steps each pod's slice where it lies."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    lr = local(lr)
    with torch.no_grad():
        count = local(state.count) + 1
        b1, b2 = cfg.beta1, cfg.beta2
        c1 = 1.0 - torch.pow(b1, count.float())
        c2 = 1.0 - torch.pow(b2, count.float())

        def upd(P, G, M, V):
            p, g, m, v = local(P), local(G), local(M), local(V)
            g32 = g.float()
            m32 = b1 * m.float() + (1 - b1) * g32
            v32 = b2 * v.float() + (1 - b2) * torch.square(g32)
            step = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
            step = step + cfg.weight_decay * p.float()
            new_p = p.float() - lr * step
            if inplace:  # copy_ rounds to the leaf's dtype as .to() does
                p.copy_(new_p), m.copy_(m32), v.copy_(v32)
                return P, M, V
            return (like(P, new_p.to(p.dtype)), like(M, m32.to(m.dtype)),
                    like(V, v32.to(v.dtype)))

        out, treedef = _apply(upd, params, grads, state.m, state.v)
        new_p, new_m, new_v = (_tree.unflatten(treedef, [o[i] for o in out])
                               for i in range(3))
    if inplace:
        local(state.count).copy_(count)
        count = state.count
    else:
        count = like(state.count, count)
    return new_p, OptState(count=count, m=new_m, v=new_v), gnorm


def _apply(fn, tree, *rest):
    """``fn`` over matching leaves -> (the list of its results, treedef)."""
    leaves, treedef = _tree.flatten(tree)
    others = []
    for r in rest:
        rl, rdef = _tree.flatten(r)
        if rdef != treedef:
            raise ValueError("optimizer: trees have different structures")
        others.append(rl)
    return [fn(*args) for args in zip(leaves, *others)], treedef


# ---------------------------------------------------------------------------
# SGD (FL clients commonly run plain local SGD)
# ---------------------------------------------------------------------------

def sgd_init(params, cfg: TrainConfig) -> OptState:
    return OptState(count=_count0(params),
                    m=_zeros_like(params, dtype_of(cfg.moment_dtype)), v={})


def sgd_update(grads, state: OptState, params, lr, cfg: TrainConfig,
               momentum: float = 0.9):
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    lr = local(lr)
    with torch.no_grad():

        def upd(P, G, M):
            p, g, m = local(P), local(G), local(M)
            g32 = g.float()
            m32 = momentum * m.float() + g32
            new_p = p.float() - lr * m32
            return like(P, new_p.to(p.dtype)), like(M, m32.to(m.dtype))

        out, treedef = _apply(upd, params, grads, state.m)
        new_p, new_m = (_tree.unflatten(treedef, [o[i] for o in out])
                        for i in range(2))
    count = like(state.count, local(state.count) + 1)
    return new_p, OptState(count=count, m=new_m, v={}), gnorm


def make_optimizer(cfg: TrainConfig):
    if cfg.optimizer == "adamw":
        return adamw_init, adamw_update
    if cfg.optimizer == "sgd":
        return sgd_init, lambda g, s, p, lr, c: sgd_update(g, s, p, lr, c)
    raise ValueError(cfg.optimizer)


def opt_state_axes(param_axes, cfg: TrainConfig):
    """Logical axes tree for OptState (moments shard like params)."""
    if cfg.optimizer == "adamw":
        return OptState(count=None, m=param_axes, v=param_axes)
    return OptState(count=None, m=param_axes, v={})
