"""Port of ``src/repro/fl/aggregator.py``: server-side aggregation.

``fedavg``            — weighted average of client trees, through the
                        ``fedavg_reduce`` kernel.
``fedavg_quantized``  — aggregates int8 client payloads through the fused
                        ``fedavg_reduce_q8`` kernel (never materialises
                        dequantised f32 copies).
``StreamingAccumulator`` — O(model) running fold for the fleet-scale hub
                        (one ``acc + eff * update`` per arrival, through the
                        ``fedavg_accumulate`` kernel, instead of buffering
                        O(clients) update trees).
``staleness_weight``  — FedBuff-style polynomial discount for async modes.
``merge_global``      — staleness-damped server update (event-driven modes).
Aggregation compute time is measured for the Fig 5 'aggregation' bars.

``merge_global`` and ``StreamingAccumulator.merged`` flush subnormal
inputs and results as XLA flushes them when it runs the reference's
arithmetic on the CPU (``kernels/quantize.py``'s rule: ``mul_ftz``,
``div_ftz``).
"""
from __future__ import annotations

import time
from typing import Sequence

import torch

from repro_torch import _tree, obs
from repro_torch._device import synchronize
from repro_torch.kernels import ops
from repro_torch.kernels.quantize import div_ftz, mul_ftz
from repro_torch.kernels.quantize import flush_subnormals as _flush


@obs.spanned("round.aggregate")
def fedavg(updates: Sequence, weights):
    """updates: list of trees; weights ~ num_examples per client.
    Returns (aggregate tree, measured seconds)."""
    t0 = time.perf_counter()
    agg = ops.fedavg_aggregate(updates, weights)
    synchronize(_tree.leaves(agg)[0])  # the seconds enter the round
    return agg, time.perf_counter() - t0


@obs.spanned("round.aggregate")
def fedavg_quantized(packed_list: Sequence[dict], weights, unflatten, *,
                     device=None):
    """packed_list: qsgd-packed updates (``ops.quantize_flat_batch``
    outputs sharing one block and orig_len), host or device; ``device``:
    where host ones are aggregated (default: the card). Returns
    (aggregate tree, measured seconds)."""
    t0 = time.perf_counter()
    agg = ops.fedavg_aggregate_q8(packed_list, weights, unflatten,
                                  device=device)
    synchronize(_tree.leaves(agg)[0])  # the seconds enter the round
    return agg, time.perf_counter() - t0


class StreamingAccumulator:
    """O(model) streaming replacement for the hub's dense update buffer.

    ``fold`` adds one effective-weight-scaled update into a flat f32
    running sum on the update's device (``ops.fedavg_accumulate_flat``,
    one kernel launch per fold on a card); ``merged`` divides by the
    summed effective weight, which equals the dense ``fedavg(trees, eff)``
    normalised average within float tolerance (tested). Virtual payloads
    fold as bookkeeping only (count / weight sums), so paper-scale runs
    keep their analytic merge timing.
    """

    def __init__(self):
        self.acc = None  # flat f32 running sum of eff-weighted updates
        self.unflatten = None
        self.sum_eff = 0.0
        self.sum_weight = 0.0
        self.count = 0  # client updates folded (records' ``count`` sum)
        self.agg_s = 0.0  # accumulated fold compute seconds

    @obs.spanned("round.aggregate")
    def fold(self, rec, alpha: float):
        """rec: scheduler UpdateRecord; alpha: its staleness discount."""
        from repro_torch.core.message import TensorPayload
        eff = rec.weight * float(alpha)
        self.sum_eff += eff
        self.sum_weight += rec.weight
        self.count += rec.count
        if isinstance(rec.payload, TensorPayload):
            t0 = time.perf_counter()
            flat, unflatten = ops.flatten_pytree(rec.payload.tree)
            if self.acc is None:
                self.unflatten = unflatten
                self.acc = ops.fedavg_accumulate_flat(
                    torch.zeros_like(flat), flat, eff)
            else:
                self.acc = ops.fedavg_accumulate_flat(self.acc, flat, eff)
            synchronize(self.acc)
            self.agg_s += time.perf_counter() - t0

    @obs.spanned("round.aggregate")
    def merged(self):
        """-> (merged tree | None, measured agg seconds)."""
        if self.acc is None or self.sum_eff <= 0:
            return None, self.agg_s
        t0 = time.perf_counter()
        tree = self.unflatten(div_ftz(self.acc, self.sum_eff))
        synchronize(_tree.leaves(tree)[0])
        return tree, self.agg_s + time.perf_counter() - t0

    def reset(self):
        self.acc = None
        self.unflatten = None
        self.sum_eff = 0.0
        self.sum_weight = 0.0
        self.count = 0
        self.agg_s = 0.0


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


@obs.spanned("round.aggregate")
def merge_global(global_tree, merged_tree, lam: float):
    """Damped server update: ``(1 - lam) * global + lam * merged``.

    ``lam = server_lr * (effective weight / raw weight)`` — a buffer of
    fresh updates (lam -> 1) replaces the global model exactly like sync
    FedAvg; a stale-heavy buffer moves it proportionally less."""
    lam = min(max(lam, 0.0), 1.0)
    if global_tree is None or lam >= 1.0 - 1e-12:
        return merged_tree
    # one flat vector per tree: a few launches per merge, not a few per leaf
    gl, treedef = _tree.flatten(global_tree)
    ml, mdef = _tree.flatten(merged_tree)
    if mdef != treedef:
        raise ValueError("merge_global: trees have different structures")
    g, m = (torch.cat([l.float().reshape(-1) for l in ls]) for ls in (gl, ml))
    out = _flush(mul_ftz(g, 1.0 - lam) + mul_ftz(m, lam))
    return _tree.unflatten(treedef, [
        v.view(l.shape).to(l.dtype)
        for v, l in zip(out.split([l.numel() for l in gl]), gl)])
