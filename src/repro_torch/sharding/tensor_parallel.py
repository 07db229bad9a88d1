"""Tensor-parallel compute over the mesh's ``model`` axis: what GSPMD
inserts into the reference's jitted steps when it partitions a matmul by
the plan's tensor rules (``sharding/rules.py``: ``heads``, ``kv_heads``,
``mlp``, ``vocab``, ``expert``, ``seq_kv`` and ``ssm_inner`` over
``model``).

A :class:`TensorParallel` is the ``model`` group of a mesh over a process
group, with this rank's place in it (``model_group``; None on a mesh that
places nothing: no group, one device, ``meta``). The model layer
(``models/layers.py``, ``models/transformer.py``, ``models/zamba.py``,
``models/xlstm.py``) takes it as ``tp`` and multiplies the shards it
holds: a column-parallel matmul reads its input through ``copy_to``
(identity forward, all-reduce of the gradient), a row-parallel one ends
in ``reduce_from`` (all-reduce forward, identity backward), and
``gather_from`` all-gathers along a dim (the rank's slice of the gradient
backward). ``sum_over`` all-reduces both ways, for a sum each rank goes
on to use in its own split compute (the recurrent blocks' gated norm and
mLSTM gates). A packed leaf whose plan cut does not fall on the rank's
heads (Mamba's ``w_in`` and ``conv``, ``w_up``, ``w_gates``) is re-cut by
``columns``: all-gathered and sliced to the columns the rank multiplies,
its gradient reduce-scattered back to the plan's shard; a leaf the plan
never cuts, read on the rank's heads, is sliced after ``copy_to``
(``whole_columns``). Partial sums are all-reduced
in f32 and cast once, as the batch mean is
(``launch/step_builders._BatchAxes``). Every rank of the group takes part
in each collective, in the same order.

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
    dim %= t.dim()
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


def sum_over(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """The sum over the group of each rank's partial ``x``, where each rank
    goes on to use it in its own split compute: the gradient each rank's
    use sends back is partial too, so it is all-reduced as well; ``x``
    itself with no group."""
    return x if tp is None else _SumOver.apply(x, tp)


def split_over(tp: Optional[TensorParallel], local_n: int, full_n: int
               ) -> Optional[TensorParallel]:
    """``tp`` where a dim of ``full_n`` of which this rank holds
    ``local_n`` runs split over it, else None: the group a block's
    collectives run over (none where it runs whole)."""
    return tp if splits(tp, local_n, full_n) else None


class _SumOver(torch.autograd.Function):
    """Partial sums all-reduced over the group, forward and backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return all_reduce_f32(x, tp.group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_f32(g, ctx.tp.group), None


def _merged(pieces) -> tuple:
    """``(start, stop)`` ranges, empty ones dropped and adjacent ones
    merged."""
    out = []
    for a, b in pieces:
        if b <= a:
            continue
        if out and out[-1][1] == a:
            out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return tuple(out)


def take(t: torch.Tensor, dim: int, pieces) -> torch.Tensor:
    """``t``'s ranges ``pieces`` along ``dim``, concatenated in order (a
    view for one range; ``t`` itself for the whole dim)."""
    pieces = _merged(pieces)
    if len(pieces) == 1 and pieces[0] == (0, t.shape[dim]):
        return t
    parts = [t.narrow(dim, a, b - a) for a, b in pieces]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


class _Recut(torch.autograd.Function):
    """This rank's shard of a leaf cut over the group along ``dim`` -> the
    ranges ``pieces`` of the whole leaf (all-gathered, then sliced);
    backward, the gradient of those ranges placed in the whole leaf's
    shape and reduce-scattered over the group in f32: each rank's own
    shard of the sum of every rank's gradient."""

    @staticmethod
    def forward(ctx, w, tp, dim, pieces):
        whole = all_gather_dim(w, tp.group, tp.size, dim)
        ctx.tp, ctx.dim, ctx.pieces = tp, dim, pieces
        ctx.whole = whole.shape
        return take(whole, dim, pieces)

    @staticmethod
    def backward(ctx, g):
        tp, dim = ctx.tp, ctx.dim
        whole = g.new_zeros(ctx.whole, dtype=torch.float32)
        at = 0
        for a, b in ctx.pieces:
            whole.narrow(dim, a, b - a).copy_(g.narrow(dim, at, b - a))
            at += b - a
        parts = [c.contiguous() for c in whole.chunk(tp.size, dim=dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter_tensor(out, torch.cat(parts), group=tp.group)
        return out.to(g.dtype), None, None, None


def columns(w: torch.Tensor, tp: Optional[TensorParallel], full_n: int,
            pieces, dim: int = -1) -> torch.Tensor:
    """The ranges ``pieces`` (``(start, stop)`` in the whole leaf's
    coordinates) of a leaf whose dim ``dim`` is ``full_n`` whole, as this
    rank multiplies them: a leaf the plan cuts over the group (its local
    dim times the group's size is ``full_n``) re-cut (all-gathered and
    sliced; its gradient reduce-scattered back to the shard); a whole one
    read through ``copy_to`` and sliced (``whole_columns``). ``w`` itself
    with no group."""
    dim %= w.dim()
    if tp is None or not tp.splits(w.shape[dim], full_n):
        return whole_columns(w, tp, pieces, dim)
    return _Recut.apply(w, tp, dim, _merged(pieces))


def whole_columns(w: torch.Tensor, tp: Optional[TensorParallel], pieces,
                  dim: int = -1) -> torch.Tensor:
    """The ranges ``pieces`` of a leaf the plan never cuts (a norm's
    scale, a bias, per-head blocks), read through ``copy_to``: its
    gradient, partial on each rank, is all-reduced. ``w`` itself with no
    group."""
    if tp is None:
        return w
    return take(copy_to(w, tp), dim % w.dim(), pieces)


def share(tp: Optional[TensorParallel], n: int) -> tuple:
    """This rank's contiguous ``(start, stop)`` of ``n`` over the group;
    ``(0, n)`` with none."""
    if tp is None:
        return 0, n
    k = n // tp.size
    return tp.rank * k, (tp.rank + 1) * k


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
