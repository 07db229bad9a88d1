"""Tensor-parallel compute over the mesh's ``model`` axis: what GSPMD
inserts into the reference's jitted steps when it partitions a matmul by
the plan's tensor rules (``sharding/rules.py``: ``heads``, ``kv_heads``,
``mlp``, ``vocab``, ``expert`` and ``seq_kv`` over ``model``).

A :class:`TensorParallel` is the ``model`` group of a mesh over a process
group, with this rank's place in it (``model_group``; None on a mesh that
places nothing: no group, one device, ``meta``). The model layer
(``models/layers.py``, ``models/transformer.py``) takes it as ``tp`` and
multiplies the shards it holds: a column-parallel matmul reads its input
through ``copy_to`` (identity forward, all-reduce of the gradient), a
row-parallel one ends in ``reduce_from`` (all-reduce forward, identity
backward), and ``gather_from`` all-gathers along a dim (the rank's slice
of the gradient backward). Partial sums are all-reduced in f32 and cast
once, as the batch mean is (``launch/step_builders._BatchAxes``). Every
rank of the group takes part in each collective, in the same order.

A leaf runs split over the group when its local dim times the group's
size is the whole dim (``splits``): always over a group of one rank, where
every collective is a one-rank call and the arithmetic is the one-device
code's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.sharding.rules import placing

AXIS = "model"  # the mesh axis the plan's tensor rules map to


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The ``model`` group: its process group, this rank's coordinate on
    the axis and the axis' size. ``cache_split``: the decode cache's
    positions (``seq_kv``) are split over the group too."""
    group: object
    rank: int
    size: int
    cache_split: bool = False

    def splits(self, local_n: int, full_n: int) -> bool:
        """Whether a dim of ``full_n`` of which this rank holds ``local_n``
        runs split over the group (whole over one rank: split)."""
        return local_n * self.size == full_n


def model_group(mesh) -> Optional[TensorParallel]:
    """The ``model`` group of ``mesh``; None where ``placing(mesh)`` is
    false or the mesh has no ``model`` axis."""
    if not placing(mesh):
        return None
    dm = mesh.device_mesh
    names = tuple(dm.mesh_dim_names)
    if AXIS not in names:
        return None
    return TensorParallel(dm.get_group(AXIS), dm.get_local_rank(AXIS),
                          dm.size(names.index(AXIS)))


def splits(tp: Optional[TensorParallel], local_n: int, full_n: int) -> bool:
    """``tp.splits``; False with no group."""
    return tp is not None and tp.splits(local_n, full_n)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_reduce_f32(t: torch.Tensor, group, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
    """``t`` all-reduced over ``group`` in f32, cast back to ``t``'s dtype
    once (a new tensor; ``t`` is left as it was)."""
    t32 = t.detach().to(torch.float32, copy=True).contiguous()
    dist.all_reduce(t32, op=op, group=group)
    return t32.to(t.dtype)


def all_gather_dim(t: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` (``n`` ranks), concatenated along
    ``dim`` in rank order (one buffer: no per-rank copies)."""
    t = t.contiguous()
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out.reshape((n,) + tuple(t.shape)).movedim(0, dim).flatten(
        dim, dim + 1)


class _CopyTo(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the group."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_f32(g, ctx.tp.group), None


class _ReduceFrom(torch.autograd.Function):
    """Partial sums all-reduced over the group forward; identity
    backward."""

    @staticmethod
    def forward(ctx, x, tp):
        return all_reduce_f32(x, tp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    """All-gather along ``dim`` forward; this rank's slice of the gradient
    backward."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return all_gather_dim(x, tp.group, tp.size, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.tp.size, dim=ctx.dim)[ctx.tp.rank], None, None


def copy_to(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """``x`` (equal on every rank) entering split compute; ``x`` itself
    with no group."""
    return x if tp is None else _CopyTo.apply(x, tp)


def reduce_from(x: torch.Tensor, tp: Optional[TensorParallel]
                ) -> torch.Tensor:
    """The sum over the group of each rank's partial ``x``; ``x`` itself
    with no group."""
    return x if tp is None else _ReduceFrom.apply(x, tp)


def gather_from(x: torch.Tensor, tp: Optional[TensorParallel], dim: int
                ) -> torch.Tensor:
    """Each rank's ``x`` concatenated along ``dim`` in rank order; ``x``
    itself with no group."""
    return x if tp is None else _GatherFrom.apply(x, tp, dim)


def split_over(tp: Optional[TensorParallel], local_n: int, full_n: int
               ) -> Optional[TensorParallel]:
    """``tp`` where a dim of ``full_n`` of which this rank holds
    ``local_n`` runs split over it, else None: the group a block's
    collectives run over (none where it runs whole)."""
    return tp if splits(tp, local_n, full_n) else None


class _VocabLSE(torch.autograd.Function):
    """``logsumexp`` over the last dim of logits split over the group: the
    max all-reduced, the sum of exps all-reduced, then ``log(sum) + max``
    (``torch.logsumexp``'s arithmetic); backward ``g * exp(x - lse)``, its
    gradient formula, on this rank's columns."""

    @staticmethod
    def forward(ctx, x, tp):
        m = torch.amax(x, dim=-1, keepdim=True)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.group)
        s = torch.sum(torch.exp(x - m), dim=-1)
        dist.all_reduce(s, group=tp.group)
        lse = torch.log(s) + m[..., 0]
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g[..., None] * torch.exp(x - lse[..., None]), None


def vocab_logsumexp(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``logsumexp(x, -1)`` of the whole vocabulary from this rank's f32
    columns ``x``."""
    return _VocabLSE.apply(x, tp)
