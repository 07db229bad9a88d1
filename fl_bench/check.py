"""The comparison that decides ``correct``.

The window's program runs its first ``CHECKED`` aggregations in set-up,
through the same calls and data as the window. The reference replays
them from the same initial weights and data, and these numbers compare
the two:

- ``first_loss_gap``: the largest relative gap between the program's and
  the reference's loss of the first local step, over the updates trained
  on the initial model: the forward pass alone, at the same weights;
- ``loss_gap``: the largest relative gap between a client's mean local
  loss in the program and in the reference, over every update the
  checked aggregations took;
- ``step1_leaf_gap``: the server's first step, the global model's change
  over the first aggregation, by its worst leaf: the gap between the
  program's and the reference's norms of that leaf's change, over the
  larger of the reference's norm and the median leaf's;
- ``step3_leaf_gap``: the same for the change over all the checked
  aggregations;
- ``step1_large_leaf_gap``, ``step3_large_leaf_gap`` and
  ``step1_small_leaves_gap``, ``step3_small_leaves_gap``, in place of the
  worst leaf for a cell whose codec rounds every parameter to a grid
  coarser than a step's change (qsgd): there a small leaf's change is a
  few whole steps of the grid, one more where an entry sat on a rounding
  boundary on one side only, and the worst leaf reads up to 1 on sound
  runs. The first is the worst of the leaves of at least ``LARGE_LEAF``
  entries; the second takes the smaller leaves together as one vector,
  its change's norm against the reference's;
- ``served_model_gap``: over the whole run, window included, the largest
  relative gap between a leaf's norm in the global model a client trained
  on and in the server's global model of that version (a stale or
  altered model served to a client).

A cell's ``limits/<cell>.json`` names the numbers it compares.

A leaf whose change in the reference is under a thousandth of the median
leaf's moves by rounding alone and is left out of a leaf gap.
"""
from __future__ import annotations

import statistics

import torch

from fl_bench.reference.tree import leaves

CHECKED = 3  # aggregations the reference follows
LARGE_LEAF = 4096  # entries: 16 blocks of the qsgd codec
NUMBERS = ("first_loss_gap", "loss_gap", "step1_leaf_gap",
           "step3_leaf_gap", "step1_large_leaf_gap", "step3_large_leaf_gap",
           "step1_small_leaves_gap", "step3_small_leaves_gap",
           "served_model_gap")


def leaf_norms(p0, got, want) -> tuple:
    """Norms of each leaf's change ``p0 -> got`` and ``p0 -> want``, and
    each leaf's entries."""
    n_got, n_want, sizes = [], [], []
    for a, g, w in zip(leaves(p0), leaves(got), leaves(want)):
        a = a.double().cpu()
        n_got.append(float(torch.linalg.vector_norm(g.double().cpu() - a)))
        n_want.append(float(torch.linalg.vector_norm(w.double().cpu() - a)))
        sizes.append(a.numel())
    return n_got, n_want, sizes


def leaf_gaps(n_got, n_want, sizes) -> list:
    """[(gap, entries)] of each counted leaf's change."""
    median = statistics.median(n_want)
    return [(abs(ng - nw) / max(nw, median), n)
            for ng, nw, n in zip(n_got, n_want, sizes) if nw >= 1e-3 * median]


def small_leaves_gap(n_got, n_want, sizes) -> float:
    """The leaves under ``LARGE_LEAF`` entries as one vector: the gap of
    its change's norms over the reference's."""
    ng = sum(x * x for x, n in zip(n_got, sizes) if n < LARGE_LEAF) ** 0.5
    nw = sum(x * x for x, n in zip(n_want, sizes) if n < LARGE_LEAF) ** 0.5
    return abs(ng - nw) / nw if nw > 0 else 0.0


def loss_gap(got: dict, want: dict, keys=None) -> float:
    worst = 0.0
    for key in want if keys is None else keys:
        w = want[key]
        g = got.get(key)
        if g is None:
            return float("inf")
        worst = max(worst, abs(g - w) / max(abs(w), 1e-12))
    return worst


def served_gap(versions: dict, served: list) -> float:
    """``versions``: {version: the server's per-leaf norms}; ``served``:
    [(version, per-leaf norms of the model a client trained on)]. A
    served version the server never made reads inf."""
    worst = 0.0
    for v, got in served:
        want = versions.get(v)
        if want is None:
            return float("inf")
        median = statistics.median(want)
        worst = max([worst] + [abs(g - w) / max(w, median, 1e-30)
                               for g, w in zip(got, want)])
    return worst


def readings(p0, got, want, served_model_gap: float = 0.0) -> dict:
    """``got``, ``want``: (globals after each checked aggregation, mean
    local losses, first steps' losses), the losses keyed by (client,
    version)."""
    (got_g, got_l, got_f), (want_g, want_l, want_f) = got, want
    out = {"first_loss_gap": loss_gap(got_f, want_f,
                                      [k for k in want_f if k[1] == 0]),
           "loss_gap": loss_gap(got_l, want_l)}
    for step, g in (("step1", got_g[0]), ("step3", got_g[-1])):
        norms = leaf_norms(p0, g, want_g[0 if step == "step1" else -1])
        gaps = leaf_gaps(*norms)
        out[f"{step}_leaf_gap"] = max(x for x, _ in gaps)
        out[f"{step}_large_leaf_gap"] = max(
            (x for x, n in gaps if n >= LARGE_LEAF), default=0.0)
        out[f"{step}_small_leaves_gap"] = small_leaves_gap(*norms)
    out["served_model_gap"] = served_model_gap
    return out


def verdict(values: dict, lims: dict) -> tuple:
    """-> (correct, {name: {"value", "limit"}}) over the numbers the
    cell's limits name; a number that is not finite fails."""
    out, ok = {}, True
    for name in NUMBERS:
        if name not in lims:
            continue
        v, lim = values[name], lims[name]["limit"]
        out[name] = {"value": v, "limit": lim}
        ok = ok and v == v and v <= lim
    return ok, out
