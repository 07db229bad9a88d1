"""Port of ``src/repro/sharding/rules.py``: logical-axis sharding rules
(MaxText-style), as pure logic.

Every parameter / activation tree carries a parallel "axes" tree of
tuples of *logical* axis names (e.g. ``("layers", "embed", "heads")``;
the models' ``param_axes()`` and ``input_specs``). A :class:`MeshPlan`
resolves each logical axis to zero or more physical mesh axes, giving one
partition spec per leaf: a tuple that mirrors the reference's
``PartitionSpec`` entry for entry (``None``, a mesh-axis name, or a tuple
of names; trailing ``None``s dropped).

The port runs on one device. ``Sharder`` and ``constrain`` are the
identity on a mesh whose axes all have size 1 (as the reference's are on
one device) and raise ``NotImplementedError`` on a larger one: sharding
across cards is ROADMAP item 16's open part, not something to pretend.
``Sharder`` is also the identity on a mesh on ``meta`` of any size
(``launch/mesh.make_production_mesh``): such a mesh is abstract, and
nothing on it computes a value.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

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

MULTI_DEVICE = ("sharding over more than one device is not ported yet "
                "(ROADMAP A, item 16): the port runs on one device")


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
        is_leaf = lambda x: x is None or (isinstance(x, tuple)
                                          and _is_axes(x))
        if shape_tree is None:
            return _tree.map(lambda ax: self.spec(ax), axes_tree,
                             is_leaf=is_leaf)
        axes, treedef = _tree.flatten(axes_tree, is_leaf)
        shapes, sdef = _tree.flatten(shape_tree)
        if len(axes) != len(shapes):
            raise ValueError("tree_specs: axes and shapes differ in leaves")
        return _tree.unflatten(treedef, [
            self.spec(ax, tuple(sd.shape)) for ax, sd in zip(axes, shapes)])


def _is_axes(x) -> bool:
    """A leaf in an axes-tree is a tuple of str/None (or None)."""
    return all(isinstance(e, str) or e is None for e in x)


# ---------------------------------------------------------------------------
# Helpers used across launch / tests
# ---------------------------------------------------------------------------

def _one_device(mesh_cfg: MeshConfig) -> bool:
    return mesh_cfg.num_devices == 1


def constrain(tree, plan: MeshPlan, axes_tree):
    """The reference's ``with_sharding_constraint`` by logical axes: the
    identity on one device."""
    if not _one_device(plan.mesh_cfg):
        raise NotImplementedError(MULTI_DEVICE)
    return tree


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

    ``Sharder(None)``, a ``Sharder`` on a mesh whose axes all have size 1,
    and one on a ``meta`` mesh are the identity: the same model code runs
    unsharded. On a larger mesh of a real device it raises
    ``NotImplementedError``.
    """

    def __init__(self, plan: Optional[MeshPlan] = None, mesh=None):
        self.plan = plan
        self.mesh = mesh

    def __call__(self, x, axes):
        if self.plan is None or self.mesh is None:
            return x
        if math.prod(self.mesh.shape) != 1 and str(self.mesh.device) != "meta":
            raise NotImplementedError(MULTI_DEVICE)
        return x
