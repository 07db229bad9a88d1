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
import hashlib
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


# A payload's content digest: the sum mod 2**64, over every 32-bit word of
# its leaves' bytes, of splitmix64's finaliser applied to (position << 32 |
# word). The finaliser is a bijection, so each word at each position adds
# its own pseudo-random 64-bit value: two payloads whose bytes differ
# anywhere share a digest with odds of about 2**-64, where a key of a few
# sampled elements collides whenever they agree. The sum runs where the
# leaves live, a pass of WORDS_PER_PASS words at a time, and one integer
# crosses to the host.
WORDS_PER_PASS = 1 << 24
_GOLDEN, _M1, _M2 = (c - (1 << 64) for c in (  # as the int64 of their bits
    0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB))


def _shr(z, s: int):
    """Logical right shift of int64 bits (``>>`` is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix(z):
    """splitmix64's finaliser, with int64 arithmetic wrapping mod 2**64."""
    z = (z ^ _shr(z, 30)) * _M1
    z = (z ^ _shr(z, 27)) * _M2
    return z ^ _shr(z, 31)


def _words(leaf) -> torch.Tensor:
    """A leaf's bytes as int32 words, zero-padded to a whole word."""
    if isinstance(leaf, torch.Tensor):
        b = leaf.detach().contiguous().reshape(-1).view(torch.uint8)
    else:
        a = np.ascontiguousarray(leaf).reshape(-1).view(np.uint8)
        b = torch.from_numpy(a if a.flags.writeable else a.copy())
    if b.numel() % 4:
        b = torch.cat([b, b.new_zeros(4 - b.numel() % 4)])
    return b.view(torch.int32)


def _layout(leaf) -> tuple:
    """(shape, dtype name), a host array's as a tensor's."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).removeprefix("torch.")
    a = np.asarray(leaf)
    return a.shape, str(a.dtype)


def content_digest(leaves) -> int:
    """A 64-bit identity of ``leaves``' contents, shapes and dtypes: equal
    for equal contents, a host array's as a tensor's."""
    if not leaves:
        return 0
    words = [_words(l) for l in leaves]
    dev = words[0].device
    flat = torch.cat([w.to(dev) for w in words])
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for start in range(0, flat.numel(), WORDS_PER_PASS):
        w = flat[start:start + WORDS_PER_PASS].to(torch.int64) & 0xFFFFFFFF
        pos = torch.arange(start, start + w.numel(), dtype=torch.int64,
                           device=dev)
        total += _mix(((pos << 32) | w) + _GOLDEN).sum()
    meta = [_layout(l) for l in leaves]
    h = hashlib.blake2b(repr((int(total), meta)).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little")


@dataclasses.dataclass
class TensorPayload:
    tree: Any

    @property
    def nbytes(self) -> int:
        return tree_nbytes(self.tree)

    def fingerprint(self) -> int:
        return content_digest(_tree.leaves(self.tree))


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
        return content_digest(_tree.leaves(self.packed))


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
