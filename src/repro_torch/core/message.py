"""Port of ``src/repro/core/message.py``.

FL message model (paper §III-A): every message = small metadata record +
(optionally large) parameter payload.

Payload flavours:
* ``TensorPayload``  — a real tree of tensors or host arrays (tests + live
  FL training).
* ``PackedPayload``  — quantised (int8+scales) tree from compression/.
* ``VirtualPayload`` — sized-but-unmaterialised stand-in used by the
  paper-scale benchmarks (simulated time/memory are charged from
  ``nbytes`` identically either way).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import _tree

_mid = itertools.count()


def leaf_nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(np.asarray(leaf).nbytes)


def tree_nbytes(tree) -> int:
    return sum(leaf_nbytes(l) for l in _tree.leaves(tree))


@dataclasses.dataclass
class TensorPayload:
    tree: Any

    @property
    def nbytes(self) -> int:
        return tree_nbytes(self.tree)

    def fingerprint(self) -> int:
        leaves = _tree.leaves(self.tree)
        if not leaves:
            return 0
        first = leaves[0]
        if isinstance(first, torch.Tensor):
            # one element crosses to the host, never the whole leaf
            head = float(first.reshape(-1)[0]) if first.numel() else 0.0
        else:
            first = np.asarray(first).reshape(-1)
            head = float(first[0]) if first.size else 0.0
        return hash((len(leaves), self.nbytes, head))


@dataclasses.dataclass
class PackedPayload:
    """Compressed tree: either q/scales/block/orig_len (qsgd int8 blocks)
    or idx/vals/n (top-k sparsification)."""
    packed: dict

    @property
    def nbytes(self) -> int:
        if "idx" in self.packed:  # top-k: int32 indices + f32 values
            return int(np.size(self.packed["idx"])) * 4 + \
                int(np.size(self.packed["vals"])) * 4
        return int(np.size(self.packed["q"])) + \
            int(np.size(self.packed["scales"])) * 4

    def fingerprint(self) -> int:
        orig = self.packed.get("orig_len", self.packed.get("n", 0))
        return hash(("packed", self.nbytes, int(orig)))


@dataclasses.dataclass
class VirtualPayload:
    size: int
    tag: str = ""

    @property
    def nbytes(self) -> int:
        return self.size

    def fingerprint(self) -> int:
        return hash(("virtual", self.size, self.tag))


@dataclasses.dataclass
class FLMessage:
    msg_type: str  # init | model_sync | client_update | control | ack
    sender: str
    receiver: str
    round: int = 0
    payload: Optional[Any] = None  # one of the payload classes
    metadata: dict = dataclasses.field(default_factory=dict)
    msg_id: int = dataclasses.field(default_factory=lambda: next(_mid))

    @property
    def payload_nbytes(self) -> int:
        return 0 if self.payload is None else self.payload.nbytes

    def meta_only(self, extra: Optional[dict] = None) -> "FLMessage":
        md = dict(self.metadata)
        if extra:
            md.update(extra)
        return dataclasses.replace(self, payload=None, metadata=md)
