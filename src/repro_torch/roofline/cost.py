"""The port's stand-in for the reference's HLO walk
(``src/repro/roofline/hlo_cost.py``'s ``entry_cost`` over a compiled dry
run): one step bundle's cost, counted from the port's own step function
on ``meta`` tensors and from its sharding plan. Nothing here computes a
value or needs a card.

- ``count_flops``: the step run once under ``FlopCounterMode`` on
  ``meta`` tensors. For train and the FL round this includes the
  backward pass and the remat recompute, as XLA's count does. The same
  run gives the temp-bytes estimate: the bytes that autograd saves for
  backward outside the remat regions (a region's own saves are
  recomputed), over the devices. It stands in for XLA's
  ``temp_size_in_bytes`` and is not that number.
- ``memory_bytes``: per-device argument and output bytes, each leaf's
  shard under its plan spec with every sharded dimension ceil-divided by
  its mesh axes' product, as XLA's buffer sizes come out. XLA's output
  is one tuple with a pointer (8 bytes) a leaf, which it counts too, and
  XLA drops the arguments a step never reads (xLSTM's decode position,
  Zamba2's unread LoRA, the VLM's cross-attention weights in decode):
  ``count_flops`` finds them by following which inputs reach an output.
- ``collective_bytes``: the collectives re-derived from the specs with
  the copied ring formulas. DCN: the FL round's cross-pod exchange (the
  int8 all-gather of each device's delta shard, or the f32 all-reduce,
  plus each leaf's scale and the loss over ``pod``). ICI: each gradient's
  all-reduce over the batch axes and each FSDP-sharded parameter's
  all-gather, per optimizer step. XLA's SPMD partitioner chooses its own
  collectives, so the ICI bytes are an estimate beside the reference's.

The byte functions trace nothing, so they hold on every cell quickly.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import _tree
from repro_torch.models.layers import dtype_of
from repro_torch.roofline.hlo_cost import collective_effective_bytes

POINTER_BYTES = 8  # an entry of XLA's output tuple


def _is_spec(x) -> bool:
    """A partition spec: a plain tuple of None, axis names or tuples of
    names (``sharding/rules.MeshPlan.spec``)."""
    return (type(x) is tuple and all(
        e is None or isinstance(e, str)
        or (type(e) is tuple and all(isinstance(n, str) for n in e))
        for e in x))


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_numel(shape, spec, mesh_cfg) -> int:
    """Elements of one device's shard of a leaf of ``shape`` under
    ``spec``: each sharded dimension ceil-divided by its axes' product."""
    n = 1
    for i, d in enumerate(shape):
        k = math.prod(mesh_cfg.axis_size(a) for a in
                      _axes(spec[i] if i < len(spec) else None))
        n *= -(-d // k)
    return n


def leaf_specs(tree, specs):
    """-> [(leaf, spec)] over ``tree`` and its spec tree."""
    leaves = _tree.leaves(tree)
    spec_leaves = _tree.leaves(specs, is_leaf=_is_spec)
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(leaves)} leaves against {len(spec_leaves)} "
                         "specs")
    return list(zip(leaves, spec_leaves))


def shard_bytes(tree, specs, mesh_cfg) -> int:
    """One device's bytes of ``tree`` under ``specs``."""
    return sum(shard_numel(l.shape, s, mesh_cfg) * l.element_size()
               for l, s in leaf_specs(tree, specs))


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def output_specs(bundle, kind: str, cfg, shape):
    """The step's outputs as ``meta`` trees, matching
    ``bundle.out_shardings``, built from the bundle's own trees."""
    f32 = _meta((), torch.float32)
    st = bundle.abstract_state
    logits_dtype = dtype_of(cfg.dtype)  # ``layers.lm_logits``: x's dtype
    if kind == "train":
        return (st["params"], st["opt"], {"loss": f32, "gnorm": f32,
                                          "lr": f32})
    if kind == "fl_round":
        return (st["params"], st["opt"], bundle.in_specs[2], f32)
    if kind == "prefill":
        return _meta((shape.global_batch, cfg.vocab_size), logits_dtype)
    if kind == "decode":
        return (_meta((shape.global_batch, 1, cfg.vocab_size), logits_dtype),
                st["cache"])
    raise ValueError(kind)


def memory_bytes(bundle, kind: str, cfg, shape, mesh_cfg,
                 unread=frozenset()) -> dict:
    """Per-device argument and output bytes of one step. ``unread``: the
    positions, in ``bundle.in_specs``' leaf order, of inputs the step
    never reads (``count_flops`` finds them), which XLA drops from its
    arguments."""
    pairs = leaf_specs(bundle.in_specs, bundle.in_shardings)
    args = sum(shard_numel(l.shape, s, mesh_cfg) * l.element_size()
               for i, (l, s) in enumerate(pairs) if i not in unread)
    out = output_specs(bundle, kind, cfg, shape)
    out_bytes = shard_bytes(out, bundle.out_shardings, mesh_cfg)
    n_out = len(_tree.leaves(out))
    if n_out > 1:
        out_bytes += POINTER_BYTES * n_out
    return {"argument_bytes": args, "output_bytes": out_bytes}


class _KeyLog(dict):
    """A batch that records the keys the step reads."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)

    def get(self, key, default=None):
        self.read.add(key)
        return super().get(key, default)


class _Reach(TorchDispatchMode):
    """Which input tensors reach an output. Each operation's results carry
    the union of its tensor arguments' inputs; a view shares its base's
    set, and an operation that writes an argument in place adds to that
    argument's set (so to every alias of it)."""

    def __init__(self, inputs):
        super().__init__()
        self.src = {id(t): {i} for i, t in enumerate(inputs)
                    if isinstance(t, torch.Tensor)}
        self.keep = list(inputs)  # no id is reused while the mode lives

    def _set(self, t) -> set:
        self.keep.append(t)
        return self.src.setdefault(id(t), set())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        srcs = set().union(*(self.src.get(id(t), ()) for t in
                             pytree.tree_leaves((args, kwargs))))
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if func.is_view:
            shared = self._set(args[0])
            shared |= srcs
            for t in outs:
                self.keep.append(t)
                self.src[id(t)] = shared
            return out
        written = [args[i] if i < len(args) else kwargs.get(a.name)
                   for i, a in enumerate(func._schema.arguments)
                   if a.alias_info is not None and a.alias_info.is_write]
        for t in written:
            if isinstance(t, torch.Tensor):
                self._set(t).update(srcs)
        if srcs:
            for t in outs:
                if id(t) not in self.src:
                    self._set(t).update(srcs)
        return out

    def reached(self, out) -> set:
        return set().union(*(self.src.get(id(t), ())
                             for t in _tree.leaves(out)))


def step_args(bundle, kind: str, shape):
    """``bundle.in_specs`` as the step takes them: a decode step's
    position is a host int (``decode_step`` reads it with ``int``), the
    last one, in a batch that records what the step reads."""
    if kind != "decode":
        return bundle.in_specs
    params, cache, batch = bundle.in_specs
    return params, cache, _KeyLog(batch, pos=shape.seq_len - 1)


def count_flops(bundle, kind: str, shape, chips: int) -> dict:
    """Run the step once on ``meta`` tensors: its global FLOPs (by
    ``FlopCounterMode``), the temp-bytes estimate per device and, for the
    forward-only steps, the inputs that reach no output (``unread``, as
    ``memory_bytes`` takes them; a training step writes every leaf)."""
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t

    # the decode position's stand-in is never passed, so never reached
    inputs = _tree.leaves(bundle.in_specs)
    args = step_args(bundle, kind, shape)
    reach = _Reach(inputs) if kind in ("prefill", "decode") \
        else contextlib.nullcontext()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), \
            FlopCounterMode(display=False) as counter, reach:
        out = bundle.fn(*args)
    unread = frozenset()
    if kind in ("prefill", "decode"):
        # the decode batch's position is a host int: read if its key was
        reached = reach.reached(out)
        keys = sorted(bundle.in_specs[-1])
        first_key = len(inputs) - len(keys)
        unread = frozenset(
            i for i in range(len(inputs)) if i not in reached
            and not (i >= first_key and keys[i - first_key] in
                     getattr(args[-1], "read", ())))
    return {"flops": float(counter.get_total_flops()),
            "temp_bytes_estimate": saved[0] // chips, "unread": unread}


def collective_bytes(bundle, kind: str, mesh_cfg, *, local_steps: int = 1,
                     compression: str = "none") -> dict:
    """Per-device collective bytes of one step, split ICI against DCN
    (across pods), by operation."""
    plan = bundle.plan
    by_op = {"all-gather": 0.0, "all-reduce": 0.0}
    ici = dcn = 0.0
    # one pod's parameters: the FL round's anchor (its pods are stacked)
    i = 2 if kind == "fl_round" else 0
    params, p_specs = bundle.in_specs[i], bundle.in_shardings[i]
    steps = local_steps if kind == "fl_round" else 1
    batch = [a for a in plan.mesh_cfg.batch_axes
             if a in plan.mesh_cfg.axis_names]
    b_group = math.prod(mesh_cfg.axis_size(a) for a in batch)
    for leaf, spec in leaf_specs(params, p_specs):
        nbytes = shard_numel(leaf.shape, spec, mesh_cfg) * leaf.element_size()
        used = {a for e in spec for a in _axes(e)}
        f_group = math.prod(mesh_cfg.axis_size(a)
                            for a in plan.mesh_cfg.fsdp_axes if a in used)
        gather = collective_effective_bytes("all-gather", nbytes * f_group,
                                            nbytes, f_group)
        reduce = 0.0
        if kind in ("train", "fl_round"):
            reduce = collective_effective_bytes("all-reduce", nbytes, nbytes,
                                                b_group)
        by_op["all-gather"] += steps * gather
        by_op["all-reduce"] += steps * reduce
        if "pod" in batch:
            ici += steps * gather
            dcn += steps * reduce
        else:
            ici += steps * (gather + reduce)
    if kind == "fl_round":
        x = exchange_bytes(bundle, mesh_cfg, compression)
        dcn += x
        by_op["cross-pod exchange"] = x
    return {"coll_ici_bytes": ici, "coll_dcn_bytes": dcn, "coll_by_op": by_op}


def exchange_bytes(bundle, mesh_cfg, compression: str) -> float:
    """Per-device DCN bytes of the FL round's delta exchange over ``pod``:
    each leaf's delta shard all-gathered in int8 with its scale's max
    all-reduced in f32, or all-reduced in f32; then the loss's mean."""
    n = mesh_cfg.axis_size("pod")
    scalar = collective_effective_bytes("all-reduce", 4, 4, n)
    total = scalar  # the loss
    for leaf, spec in leaf_specs(bundle.in_specs[2], bundle.in_shardings[2]):
        numel = shard_numel(leaf.shape, spec, mesh_cfg)
        if compression == "int8":
            total += collective_effective_bytes("all-gather", n * numel,
                                                numel, n) + scalar
        else:
            total += collective_effective_bytes("all-reduce", 4 * numel,
                                                4 * numel, n)
    return total
