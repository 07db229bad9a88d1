"""The FL arithmetic of one deployment, in plain PyTorch: local SGD on a
silo's batches, the payload codec's round trip, FedAvg and the server's
staleness-damped merge, replayed over the schedule the run recorded
(which client trained on which global version, and which updates each
aggregation took). The schedule comes from the run's event order, which
only the run's simulated network decides; every number is worked out
here again from the seeded data and initial weights."""
from __future__ import annotations

import importlib

import numpy as np
import torch

from fl_bench.reference import nn
from fl_bench.reference.tree import leaves, replace_leaves

LEARNING_RATE = 0.05  # the deployment's local SGD step


def model_module(family: str):
    return importlib.import_module(f"fl_bench.reference.{family}")


def batch_indices(n: int, batch_size: int, seed: int, silo_id: int,
                  steps: int):
    """The rows of each local step: a silo draws ``batch_size`` distinct
    rows per step from a generator seeded by the round."""
    rng = np.random.default_rng(seed * 1000 + silo_id)
    return [rng.choice(n, size=min(batch_size, n), replace=False)
            for _ in range(steps)]


def local_train(model, cfg, params, silo, *, batch_size: int, steps: int,
                seed: int, device, dtype=torch.float32):
    """``steps`` SGD steps from ``params``; the model computes in ``dtype``
    and the weights stay float32. -> (new params, [loss of each step])."""
    ws = [l.detach().float() for l in leaves(params)]
    losses = []
    for idx in batch_indices(len(silo.labels), batch_size, seed,
                             silo.silo_id, steps):
        x = torch.from_numpy(silo.features[idx]).to(device)
        y = torch.from_numpy(silo.labels[idx]).to(device)
        live = [w.requires_grad_(True) for w in ws]
        tree = replace_leaves(params, [w.to(dtype) for w in live])
        loss = nn.cross_entropy(model.forward(tree, x.to(dtype), cfg), y)
        grads = torch.autograd.grad(loss, live)
        with torch.no_grad():
            ws = [w - LEARNING_RATE * g.float() for w, g in zip(live, grads)]
        losses.append(float(loss.detach()))
    return replace_leaves(params, [w.detach() for w in ws]), losses


def flat(tree) -> torch.Tensor:
    return torch.cat([l.reshape(-1).float() for l in leaves(tree)])


def unflat(vec, like):
    out, off = [], 0
    for l in leaves(like):
        out.append(vec[off:off + l.numel()].reshape(l.shape))
        off += l.numel()
    return replace_leaves(like, out)


def topk_round_trip(tree, frac: float):
    """Keep the k = max(1, int(n * frac)) entries largest in magnitude
    (ties to the lower index), zero the rest."""
    f = flat(tree)
    k = max(1, int(f.numel() * frac))
    keep = torch.sort(f.abs(), descending=True, stable=True).indices[:k]
    out = torch.zeros_like(f)
    out[keep] = f[keep]
    return unflat(out, tree)


def qsgd_round_trip(tree, block: int):
    """int8 per block of ``block`` entries: scale = max |x| / 127,
    q = round(x / scale) clamped to +-127, back as q * scale."""
    f = flat(tree)
    n = f.numel()
    x = torch.nn.functional.pad(f, (0, -n % block)).view(-1, block)
    scale = x.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.where(scale > 0, torch.clamp(torch.round(x / safe), -127, 127),
                    torch.zeros_like(x))
    return unflat((q * scale).reshape(-1)[:n], tree)


def round_trip(tree, codec: str):
    name, _, arg = (codec or "none").partition(":")
    if name == "none":
        return tree
    if name == "topk":
        return topk_round_trip(tree, float(arg) if arg else 0.05)
    if name == "qsgd":
        return qsgd_round_trip(tree, int(arg) if arg else 256)
    raise KeyError(f"no reference for codec '{codec}'")


def fedavg(trees, weights):
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    out = [sum(float(wi) * l for wi, l in zip(w, ls))
           for ls in zip(*[leaves(t) for t in trees])]
    return replace_leaves(trees[0], out)


def merge(global_tree, merged, lam: float):
    lam = min(max(lam, 0.0), 1.0)
    if lam >= 1.0 - 1e-12:
        return merged
    return replace_leaves(global_tree, [
        (1.0 - lam) * g + lam * m
        for g, m in zip(leaves(global_tree), leaves(merged))])


def replay(family: str, cfg: dict, params0, silos, schedule, *,
           client_seeds, batch_size: int, local_steps: int, codec: str,
           mode: str, staleness_exponent: float, server_lr: float, device,
           dtype=torch.float32):
    """Replay the recorded aggregations from ``params0``.

    ``schedule``: one list per aggregation of records ``{"client": i,
    "version": v}``, the updates it took; ``version`` is the global
    version the update trained on. An update weighs its silo's examples. Returns (globals after each
    aggregation, {(client, version): mean local loss}, {(client, version):
    loss of the first local step})."""
    model = model_module(family)
    globals_ = [params0]
    losses, first = {}, {}
    for j, agg in enumerate(schedule):
        trees, eff, raw = [], [], []
        for rec in agg:
            c, v = rec["client"], rec["version"]
            new, step_losses = local_train(
                model, cfg, globals_[v], silos[c], batch_size=batch_size,
                steps=local_steps, seed=client_seeds[c] + v, device=device,
                dtype=dtype)
            losses[(c, v)] = float(np.mean(step_losses))
            first[(c, v)] = step_losses[0]
            trees.append(round_trip(new, codec))
            alpha = 1.0 if mode == "sync" else \
                (1.0 + max(j - v, 0)) ** -staleness_exponent
            weight = float(len(silos[c].labels))  # the silo's examples
            eff.append(weight * alpha)
            raw.append(weight)
        merged = fedavg(trees, eff)
        if mode == "sync":
            globals_.append(merged)
        else:
            lam = server_lr * sum(eff) / max(sum(raw), 1e-12)
            globals_.append(merge(globals_[j], merged, lam))
    return globals_[1:], losses, first
