"""Port of ``src/repro/fl/aggregator.py``, limited to the sync path.

``fedavg``            — weighted average of client trees, through the
                        ``fedavg_reduce`` kernel.
``staleness_weight``  — FedBuff-style polynomial discount for async modes.
``merge_global``      — staleness-damped server update (event-driven modes).
Aggregation compute time is measured for the Fig 5 'aggregation' bars.

``StreamingAccumulator`` and ``fedavg_quantized`` arrive with the
``fedavg_accumulate`` and ``fedavg_reduce_q8`` kernels.
"""
from __future__ import annotations

import time
from typing import Sequence

from repro_torch import _tree
from repro_torch._device import synchronize
from repro_torch.kernels import ops


def fedavg(updates: Sequence, weights):
    """updates: list of trees; weights ~ num_examples per client.
    Returns (aggregate tree, measured seconds)."""
    t0 = time.perf_counter()
    agg = ops.fedavg_aggregate(updates, weights)
    synchronize(_tree.leaves(agg)[0])  # the seconds enter the round
    return agg, time.perf_counter() - t0


def simulated_agg_time(nbytes: int, n_clients: int,
                       hbm_bw: float = 400e9) -> float:
    """Aggregation is bandwidth-bound: read N updates + write one
    (used when payloads are virtual)."""
    return (n_clients + 1) * nbytes / hbm_bw


def staleness_weight(staleness: float, exponent: float = 0.5) -> float:
    """FedBuff-style polynomial staleness discount ``(1 + s)^-a``.

    ``s`` is how many global versions elapsed between the model a client
    trained on and the one it is merged into; ``a = 0`` disables the
    discount (every update counts fully, the sync-FedAvg limit)."""
    return (1.0 + max(float(staleness), 0.0)) ** (-exponent)


def merge_global(global_tree, merged_tree, lam: float):
    """Damped server update: ``(1 - lam) * global + lam * merged``.

    ``lam = server_lr * (effective weight / raw weight)`` — a buffer of
    fresh updates (lam -> 1) replaces the global model exactly like sync
    FedAvg; a stale-heavy buffer moves it proportionally less."""
    lam = min(max(lam, 0.0), 1.0)
    if global_tree is None or lam >= 1.0 - 1e-12:
        return merged_tree
    return _tree.map(lambda g, m: (1.0 - lam) * g + lam * m,
                     global_tree, merged_tree)
