"""Port of ``src/repro/roofline/hlo_cost.py``: its framework-free
helpers only.

Copied as the reference has them: ``Cost``, the ring-algorithm collective
formulas (``collective_effective_bytes``), replica-group parsing and
``crosses_pod``, ``arithmetic_intensity`` and ``is_bandwidth_bound``.

Not copied: ``parse_hlo``, ``computation_cost`` and ``entry_cost``. They
walk XLA's optimized HLO text, which the port never produces. The port
counts a step's cost from its own step functions on ``meta`` tensors
instead (``roofline/cost.py``), and uses these formulas for the
collectives it derives from the sharding plan.
"""
from __future__ import annotations

import dataclasses
import re
from collections import defaultdict

import numpy as np


def parse_replica_groups(attrs: str):
    """-> (group_size, groups_or_None). Handles explicit {{0,1},{2,3}} and
    iota [G,S]<=[dims]T(perm) formats."""
    m = re.search(r"replica_groups=\{\{([^}]*)\}", attrs)
    if m:
        first = m.group(1)
        size = len(first.split(","))
        groups = []
        for g in re.findall(r"\{([\d,]+)\}", attrs.split("replica_groups=")[1]):
            groups.append([int(x) for x in g.split(",")])
        return max(size, 1), groups
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?",
                  attrs)
    if m:
        G, S = int(m.group(1)), int(m.group(2))
        dims = [int(x) for x in m.group(3).split(",")]
        perm = [int(x) for x in m.group(4).split(",")] if m.group(4) else None
        arr = np.arange(int(np.prod(dims))).reshape(dims)
        if perm:
            arr = arr.transpose(perm)
        groups = arr.reshape(G, S)
        return S, groups.tolist()
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]", attrs)
    if m:
        return int(m.group(2)), None
    return 1, None


def crosses_pod(groups, pod_size: int) -> bool:
    if groups is None:
        return False
    for g in groups:
        pods = {d // pod_size for d in g}
        if len(pods) > 1:
            return True
    return False


def collective_effective_bytes(opcode: str, result_bytes: int,
                               operand_bytes: int, group: int) -> float:
    """Per-device bytes crossing links (ring algorithms)."""
    if group <= 1:
        return 0.0
    if opcode.startswith("all-reduce"):
        return 2.0 * (group - 1) / group * max(result_bytes, operand_bytes)
    if opcode.startswith("all-gather"):
        return (group - 1) / group * result_bytes
    if opcode.startswith("reduce-scatter"):
        return (group - 1) / group * operand_bytes
    if opcode.startswith("all-to-all"):
        return (group - 1) / group * max(result_bytes, operand_bytes)
    if opcode.startswith("collective"):
        return float(max(result_bytes, operand_bytes))
    return 0.0


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_ici_bytes: float = 0.0
    coll_dcn_bytes: float = 0.0
    coll_by_op: dict = dataclasses.field(default_factory=dict)
    bytes_by_op: dict = dataclasses.field(default_factory=dict)

    def __add__(self, o):
        merged = defaultdict(float)
        for d in (self.coll_by_op, o.coll_by_op):
            for k, v in d.items():
                merged[k] += v
        bmerged = defaultdict(float)
        for d in (self.bytes_by_op, o.bytes_by_op):
            for k, v in d.items():
                bmerged[k] += v
        return Cost(self.flops + o.flops, self.hbm_bytes + o.hbm_bytes,
                    self.coll_ici_bytes + o.coll_ici_bytes,
                    self.coll_dcn_bytes + o.coll_dcn_bytes, dict(merged),
                    dict(bmerged))

    def scale(self, k: float):
        return Cost(self.flops * k, self.hbm_bytes * k,
                    self.coll_ici_bytes * k, self.coll_dcn_bytes * k,
                    {kk: v * k for kk, v in self.coll_by_op.items()},
                    {kk: v * k for kk, v in self.bytes_by_op.items()})


# H100 SXM machine balance (peak flops / HBM bandwidth, the data sheet's
# at 700 W), flops per byte: 989.4 TFLOP/s dense bf16 over 3.35 TB/s ≈
# 295. A kernel whose arithmetic intensity sits far below this is
# bandwidth-bound: more compute cannot speed it up, only fewer bytes can.
MACHINE_BALANCE_FLOPS_PER_BYTE = 989.4e12 / 3.35e12


def arithmetic_intensity(cost: Cost) -> float:
    """flops per HBM byte of a walked computation (inf when byte-free)."""
    if cost.hbm_bytes <= 0:
        return float("inf")
    return cost.flops / cost.hbm_bytes


def is_bandwidth_bound(cost: Cost, *, balance: float =
                       MACHINE_BALANCE_FLOPS_PER_BYTE) -> bool:
    """True when the computation's intensity sits below the machine
    balance point — the roofline says HBM bandwidth, not compute, limits
    it. The batched-codec CI assertion: the fused quantize stage must
    stay bandwidth-bound (it streams rows; if intensity ever climbs the
    fusion regressed into recomputation)."""
    return arithmetic_intensity(cost) < balance
