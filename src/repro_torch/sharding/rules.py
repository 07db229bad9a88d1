"""Port of ``src/repro/sharding/rules.py``: logical-axis sharding rules
(MaxText-style), as pure logic.

Every parameter / activation tree carries a parallel "axes" tree of
tuples of *logical* axis names (e.g. ``("layers", "embed", "heads")``;
the models' ``param_axes()`` and ``input_specs``). A :class:`MeshPlan`
resolves each logical axis to zero or more physical mesh axes, giving one
partition spec per leaf: a tuple that mirrors the reference's
``PartitionSpec`` entry for entry (``None``, a mesh-axis name, or a tuple
of names; trailing ``None``s dropped).

On a mesh over a process group (``launch/mesh.make_mesh`` inside one) a
spec becomes DTensor placements (``placements``): mesh dim ``j`` is
``Shard(i)`` where entry ``i`` names axis ``j``, so a dim sharded over
``("pod", "data")`` is split by both, pod-major, as ``P(("pod",
"data"))`` is. A :class:`Sharding` (the port's ``NamedSharding``) pairs a
mesh with a spec; ``place`` lays a tensor out by one (a full tensor,
equal on every rank, is cut locally; a DTensor is redistributed), and
``gather`` is its inverse. ``Sharder`` and ``constrain`` place by the
plan there; on a mesh of one device or on ``meta`` (the dry run's
abstract meshes, ``launch/mesh.make_production_mesh``) they are the
identity. ``placing`` is the one place that tells these meshes apart.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import _tree
from repro_torch.configs.base import MeshConfig

# ---------------------------------------------------------------------------
# Logical axis vocabulary
# ---------------------------------------------------------------------------
# layers      scan-stacked layer dim                      -> never sharded
# vocab       embedding-table / lm-head vocab dim         -> tensor axes
# embed       model (residual) dim                        -> fsdp axes
# heads       flattened q-heads*head_dim projection dim   -> tensor axes
# kv_heads    flattened kv-heads*head_dim projection dim  -> tensor axes
# mlp         FFN hidden dim                              -> tensor axes
# expert      MoE expert dim                              -> tensor axes (EP)
# expert_in   per-expert input dim (embed inside experts) -> fsdp axes
# batch       global batch                                -> batch axes (pod+data)
# seq         sequence (activations)                      -> unsharded (SP opt-in)
# seq_kv      KV-cache sequence dim                       -> tensor axes (flash-decode SP)
# ssm_inner   mamba/mlstm inner dim                       -> tensor axes
# ssm_state   SSM state dim                               -> unsharded
# norm,const  tiny vectors                                -> unsharded

@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Resolution of logical axes onto a physical mesh."""

    mesh_cfg: MeshConfig
    extra_rules: tuple = ()  # ((logical, (phys, ...)), ...) overrides

    def rules(self) -> dict:
        m = self.mesh_cfg
        fsdp = tuple(a for a in m.fsdp_axes if a in m.axis_names)
        tensor = tuple(a for a in m.tensor_axes if a in m.axis_names)
        batch = tuple(a for a in m.batch_axes if a in m.axis_names)
        base = {
            "layers": (),
            "vocab": tensor,
            "embed": fsdp,
            "heads": tensor,
            "kv_heads": tensor,
            "mlp": tensor,
            "expert": tensor,
            "expert_in": fsdp,
            "batch": batch,
            "seq": (),
            "seq_kv": tensor,
            "ssm_inner": tensor,
            "ssm_state": (),
            "norm": (),
            "const": (),
            None: (),
        }
        base.update(dict(self.extra_rules))
        return base

    # ------------------------------------------------------------------
    def spec(self, axes: Optional[tuple], shape: Optional[tuple] = None
             ) -> tuple:
        """The partition spec of one leaf. If ``shape`` is given, drop
        shardings that do not divide it."""
        if axes is None:
            return ()
        rules = self.rules()
        used: set = set()
        dims = []
        for i, a in enumerate(axes):
            phys = tuple(p for p in rules.get(a, ()) if p not in used)
            truncated = False
            if shape is not None and phys:
                total = math.prod(self.mesh_cfg.axis_size(p) for p in phys)
                if shape[i] % total != 0:
                    # try a divisible prefix (e.g. batch=128 on pod*data=32 ok,
                    # batch=1 -> unsharded)
                    keep = []
                    run = 1
                    for p in phys:
                        if shape[i] % (run * self.mesh_cfg.axis_size(p)) == 0:
                            keep.append(p)
                            run *= self.mesh_cfg.axis_size(p)
                        else:
                            break
                    truncated = len(keep) < len(phys)
                    phys = tuple(keep)
            used.update(phys)
            if len(phys) == 0:
                dims.append(None)
            elif len(phys) == 1 and not truncated:
                dims.append(phys[0])
            else:
                # keep the tuple form for a truncated multi-axis rule:
                # (('pod',),) documents that ('pod', 'data') was requested
                dims.append(phys)
        while dims and dims[-1] is None:
            dims.pop()
        return tuple(dims)

    def tree_specs(self, axes_tree, shape_tree=None):
        """``spec`` over an axes tree (and the matching tree of tensors or
        ``meta`` stand-ins, for the divisibility fallback)."""
        if shape_tree is None:
            return _tree.map(lambda ax: self.spec(ax), axes_tree,
                             is_leaf=is_axes_leaf)
        axes, treedef = _tree.flatten(axes_tree, is_axes_leaf)
        shapes, sdef = _tree.flatten(shape_tree)
        if len(axes) != len(shapes):
            raise ValueError("tree_specs: axes and shapes differ in leaves")
        return _tree.unflatten(treedef, [
            self.spec(ax, tuple(sd.shape)) for ax, sd in zip(axes, shapes)])

    def tree_shardings(self, mesh, axes_tree, shape_tree=None):
        """``tree_specs`` as a tree of :class:`Sharding` on ``mesh``."""
        axes, treedef = _tree.flatten(axes_tree, is_axes_leaf)
        shapes = ([None] * len(axes) if shape_tree is None else
                  [tuple(s.shape) for s in _tree.leaves(shape_tree)])
        if len(shapes) != len(axes):
            raise ValueError("tree_shardings: axes and shapes differ in "
                             "leaves")
        return _tree.unflatten(treedef, [Sharding(mesh, self.spec(a, s))
                                         for a, s in zip(axes, shapes)])


def _is_axes(x) -> bool:
    """A leaf in an axes-tree is a tuple of str/None (or None)."""
    return all(isinstance(e, str) or e is None for e in x)


def is_axes_leaf(x) -> bool:
    return x is None or (isinstance(x, tuple) and _is_axes(x))


# ---------------------------------------------------------------------------
# Placements on a DeviceMesh
# ---------------------------------------------------------------------------

def placing(mesh) -> bool:
    """Whether tensors are laid out on ``mesh``: True on a mesh over a
    process group (it carries a ``DeviceMesh``, of any size); False with
    no mesh, on one device or on ``meta`` (the dry run's abstract
    meshes), where the plan is the identity. A mesh record of several
    real devices with no ``DeviceMesh`` raises: nothing could place on
    it."""
    if mesh is None:
        return False
    if mesh.device_mesh is not None:
        return True
    if math.prod(mesh.shape) == 1 or str(mesh.device) == "meta":
        return False
    raise ValueError(
        f"mesh {tuple(mesh.shape)} over {tuple(mesh.axis_names)} on "
        f"{mesh.device} has no DeviceMesh: make it with make_mesh inside a "
        f"process group of {math.prod(mesh.shape)} ranks")


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(axis_names, spec) -> tuple:
    """DTensor placements of ``spec`` on a mesh with ``axis_names``: mesh
    dim ``j`` is ``Shard(i)`` where entry ``i`` names axis ``j``, else
    ``Replicate()``. DTensor splits a dim in mesh-dim order, so an entry's
    axes must come in the mesh's order (major first)."""
    names = tuple(axis_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        idx = [names.index(a) for a in spec_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} splits a dim against the "
                             f"mesh's axis order {names}")
        for j in idx:
            out[j] = Shard(i)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """The port's ``NamedSharding``: a mesh (``launch/mesh.Mesh``) and one
    leaf's partition spec."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh.axis_names, self.spec)


def local(x):
    """This rank's shard of ``x`` (a DTensor), or ``x`` itself; a view, so
    writing into it writes into ``x``."""
    return x.to_local() if isinstance(x, DTensor) else x


def like(x, local_tensor):
    """``local_tensor`` as this rank's shard of a DTensor laid out as
    ``x`` (same global shape); ``local_tensor`` itself if ``x`` is
    plain."""
    if not isinstance(x, DTensor):
        return local_tensor
    return DTensor.from_local(local_tensor, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=contiguous_stride(x.shape))


def contiguous_stride(shape) -> tuple:
    stride, run = [], 1
    for n in reversed(tuple(shape)):
        stride.append(run)
        run *= n
    return tuple(reversed(stride))


def _cut(full: torch.Tensor, device_mesh, pls) -> DTensor:
    """This rank's shard of ``full`` (equal on every rank), no
    communication: split in mesh-dim order, as DTensor's ``Shard`` is. A
    leaf no dim of more than one rank cuts is kept, not copied (so a step
    on a one-rank mesh writes into its caller's tensors, as on one
    device)."""
    coord = device_mesh.get_coordinate()
    t = full
    for j, pl in enumerate(pls):
        n = device_mesh.size(j)
        if isinstance(pl, Shard) and n > 1:
            if t.shape[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(full.shape)} does "
                                 f"not divide over {n} ranks")
            t = t.chunk(n, dim=pl.dim)[coord[j]]
    if t is not full:  # a copy: the shard keeps no view of the whole
        t = t.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(t.contiguous(), device_mesh, pls,
                              run_check=False, shape=full.shape,
                              stride=contiguous_stride(full.shape))


def place_on(x, device_mesh, pls):
    """``x`` laid out as ``pls`` on ``device_mesh``: a plain tensor (the
    full value, equal on every rank) cut locally; a DTensor kept if it is
    so laid out already, else gathered and cut (every rank must call)."""
    pls = tuple(pls)
    if isinstance(x, DTensor):
        if x.device_mesh == device_mesh and tuple(x.placements) == pls:
            return x
        x = gather(x)
    return _cut(x, device_mesh, pls)


def place(x, sharding: Optional[Sharding]):
    """``x`` laid out by ``sharding``; ``x`` itself when there is none or
    its mesh places nothing (``placing``)."""
    if sharding is None or not placing(sharding.mesh):
        return x
    return place_on(x, sharding.mesh.device_mesh, sharding.placements)


def place_tree(tree, shardings):
    """``place`` over matching leaves (``shardings`` may be None)."""
    if shardings is None:
        return tree
    leaves, treedef = _tree.flatten(tree)
    shs = _tree.leaves(shardings)
    if len(shs) != len(leaves):
        raise ValueError("place_tree: tree and shardings differ in leaves")
    return _tree.unflatten(treedef, [place(x, s)
                                     for x, s in zip(leaves, shs)])


def gather(x, keep: tuple = ()):
    """The full tensor of a DTensor ``x`` on every rank (every rank of its
    mesh must call), gathering innermost mesh dims first (DTensor cuts
    the outermost first); the mesh dims named in ``keep`` stay cut (this
    rank's shard over them). A plain tensor is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    dm, t = x.device_mesh, x.to_local()
    for j in reversed(range(dm.ndim)):
        pl = x.placements[j]
        if not isinstance(pl, Shard) or dm.size(j) == 1 \
                or dm.mesh_dim_names[j] in keep:
            continue
        parts = [torch.empty_like(t) for _ in range(dm.size(j))]
        dist.all_gather(parts, t.contiguous(), group=dm.get_group(j))
        t = torch.cat(parts, dim=pl.dim)
    return t


def gather_tree(tree):
    """``gather`` over every leaf."""
    return _tree.map(gather, tree)


def sharded_dims(x) -> tuple:
    """The mesh dims that cut a DTensor ``x`` (none for a plain one)."""
    if not isinstance(x, DTensor):
        return ()
    return tuple(j for j, pl in enumerate(x.placements)
                 if isinstance(pl, Shard))


# ---------------------------------------------------------------------------
# Helpers used across launch / tests
# ---------------------------------------------------------------------------

def constrain(tree, plan: MeshPlan, axes_tree):
    """The reference's ``with_sharding_constraint`` by logical axes: each
    DTensor leaf redistributed to the plan's placements on its own mesh;
    the identity on plain leaves under a one-device plan. A plain leaf
    under a larger plan raises: it has no mesh to be placed on."""
    axes, _ = _tree.flatten(axes_tree, is_axes_leaf)
    leaves, treedef = _tree.flatten(tree)
    if len(axes) != len(leaves):
        raise ValueError("constrain: tree and axes differ in leaves")
    out = []
    for ax, x in zip(axes, leaves):
        if isinstance(x, DTensor):
            dm = x.device_mesh
            spec = plan.spec(ax, tuple(x.shape))
            out.append(place_on(x, dm, placements(dm.mesh_dim_names, spec)))
        elif plan.mesh_cfg.num_devices == 1:
            out.append(x)
        else:
            raise ValueError(
                f"constrain: a plain tensor under a plan for "
                f"{plan.mesh_cfg.num_devices} devices: place it on a mesh "
                f"first (sharding.place)")
    if all(o is x for o, x in zip(out, leaves)):
        return tree
    return _tree.unflatten(treedef, out)


def batch_spec(plan: MeshPlan, global_batch: int, extra_dims: int = 1
               ) -> tuple:
    """Partition spec for a (batch, ...) input with divisibility fallback."""
    return plan.spec(("batch",) + (None,) * extra_dims,
                     (global_batch,) + (1,) * extra_dims)


def bytes_of(tree) -> int:
    return sum(math.prod(l.shape) * l.element_size()
               for l in _tree.leaves(tree))


class Sharder:
    """Callable applying logical-axis sharding constraints.

    ``Sharder(None)``, and a ``Sharder`` on a mesh of one device or on a
    ``meta`` mesh, are the identity: the same model code runs unsharded.
    On a mesh over a process group it places ``x`` by the plan's spec for
    ``axes`` (the divisibility fallback applied to ``x``'s shape). A mesh
    record of several real devices with no ``DeviceMesh`` raises.
    """

    def __init__(self, plan: Optional[MeshPlan] = None, mesh=None):
        self.plan = plan
        self.mesh = mesh

    def __call__(self, x, axes):
        if self.plan is None or not placing(self.mesh):
            return x
        return place(x, Sharding(self.mesh,
                                 self.plan.spec(tuple(axes), tuple(x.shape))))
