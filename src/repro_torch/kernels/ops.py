"""Port of ``src/repro/kernels/ops.py``: flat- and tree-level wrappers
over the kernels, with padding and flattening handled here.

``flatten_pytree`` and ``fedavg_aggregate`` (the FedAvg path), the
quantize / dequantize wrappers of the qsgd codec, ``topk_flat_batch``
(the top-k codec), ``fedavg_accumulate_flat`` (the streaming hub) and
``fedavg_aggregate_q8`` (FedAvg over qsgd-packed updates).

Padding of the quantize path follows the reference exactly: each item is
padded to a multiple of ``block * ROW_TILE`` elements, because the padded
``q`` length and the number of scales are on the wire (they set
``PackedPayload.nbytes`` and with it the simulated wire time).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import _tree
from repro_torch._device import resolve_device
from repro_torch.kernels import fedavg_reduce as fr
from repro_torch.kernels import quantize as qz
from repro_torch.kernels import topk as tk


def flatten_pytree(tree):
    """-> (flat f32 vector, unflatten_fn), leaves in ``jax.tree.flatten``
    order. Leaves may be tensors or host arrays; the vector lies on the
    first leaf's device. Dtype-preserving on unflatten."""
    leaves, treedef = _tree.flatten(tree)
    leaves = [torch.as_tensor(l) for l in leaves]
    sizes = [l.numel() for l in leaves]
    shapes = [l.shape for l in leaves]
    dtypes = [l.dtype for l in leaves]
    flat = torch.cat([l.float().reshape(-1) for l in leaves]) \
        if leaves else torch.zeros((0,), dtype=torch.float32)

    def unflatten(vec):
        out, off = [], 0
        for size, shape, dt in zip(sizes, shapes, dtypes):
            out.append(vec[off:off + size].reshape(shape).to(dt))
            off += size
        return _tree.unflatten(treedef, out)

    return flat, unflatten


# ---------------------------------------------------------------------------
# quantize / dequantize (the qsgd codec's path)
# ---------------------------------------------------------------------------
#
# A batch of flat vectors is padded item by item to whole (ROW_TILE, block)
# row tiles inside ONE zeroed device buffer and quantised by one kernel
# launch; quantisation is row-wise, so every item's rows are bit-identical
# to quantising it alone. A span ``(first row, rows, orig_len)`` locates
# each item in the batch.

Span = Tuple[int, int, int]


def _flat_tensor(x) -> torch.Tensor:
    return torch.as_tensor(x).reshape(-1)


def quantize_rows_batch(flats: Sequence, *, block: int = 256):
    """[x_i] (flat, one device) -> (q (R, block) int8, scales (R, 1) f32,
    [span_i]) on that device, through one quantize launch."""
    xs = [_flat_tensor(x) for x in flats]
    mult = block * qz.ROW_TILE
    pad_lens = [-(-x.numel() // mult) * mult for x in xs]
    big = torch.zeros(sum(pad_lens), dtype=torch.float32,
                      device=xs[0].device)
    spans, off = [], 0
    for x, pl in zip(xs, pad_lens):
        big[off:off + x.numel()] = x
        spans.append((off // block, pl // block, x.numel()))
        off += pl
    q, s = qz.quantize_blocks(big.reshape(-1, block))
    return q, s, spans


def packed_on_host(q: torch.Tensor, s: torch.Tensor, spans: Sequence[Span],
                   block: int) -> List[dict]:
    """The wire form of a quantised batch: ``q`` and ``scales`` cross to the
    host once each (the real device->host copy) and every item's packed
    dict holds numpy views of them, keyed as the reference keys them."""
    q, s = q.cpu().numpy(), s.cpu().numpy()
    return [{"q": q[r0:r0 + rows].reshape(-1),
             "scales": s[r0:r0 + rows].reshape(-1),
             "block": block, "orig_len": n} for r0, rows, n in spans]


def dequantize_rows(q: torch.Tensor, s: torch.Tensor, spans: Sequence[Span],
                    out_dtype=torch.float32) -> List[torch.Tensor]:
    """Inverse of ``quantize_rows_batch`` for the items at ``spans``, on
    ``q``'s device, through one dequantize launch; flat views, unpadded."""
    if sum(rows for _, rows, _ in spans) == q.shape[0]:  # the whole batch
        qq, ss, starts = q, s, [r0 for r0, _, _ in spans]
    else:
        qq = torch.cat([q[r0:r0 + rows] for r0, rows, _ in spans])
        ss = torch.cat([s[r0:r0 + rows] for r0, rows, _ in spans])
        starts = np.cumsum([0] + [rows for _, rows, _ in spans[:-1]])
    x = qz.dequantize_blocks(qq, ss, out_dtype)
    return [x[int(r0):int(r0) + rows].reshape(-1)[:n]
            for r0, (_, rows, n) in zip(starts, spans)]


def quantize_flat(x, *, block: int = 256) -> dict:
    """x: (T,) float -> dict(q=(T',) int8, scales, block, orig_len) on x's
    device."""
    q, s, ((_, _, n),) = quantize_rows_batch([x], block=block)
    return {"q": q.reshape(-1), "scales": s.reshape(-1), "block": block,
            "orig_len": n}


def quantize_flat_batch(flats: Sequence, *, block: int = 256) -> List[dict]:
    """[x_i] -> [packed_i] with host q/scales, one quantize launch and one
    device->host copy for the whole batch. Per-item results are
    bit-identical to ``quantize_flat(x_i)``."""
    if not flats:
        return []
    q, s, spans = quantize_rows_batch(flats, block=block)
    return packed_on_host(q, s, spans, block)


def _target(packed_list, device) -> torch.device:
    """Where a batch dequantises: ``device`` if given, else the device of
    tensor inputs; host (wire) inputs default to the card."""
    if device is not None:
        return torch.device(device)
    q = packed_list[0]["q"]
    return q.device if isinstance(q, torch.Tensor) else resolve_device()


def dequantize_flat(packed: dict, *, out_dtype=torch.float32,
                    device=None) -> torch.Tensor:
    return dequantize_flat_batch([packed], out_dtype=out_dtype,
                                 device=device)[0]


def dequantize_flat_batch(packed_list: Sequence[dict], *,
                          out_dtype=torch.float32, device=None
                          ) -> List[torch.Tensor]:
    """[packed_i] -> [x_i] on ``device``, one dequantize launch when every
    item shares one block size. Host (wire) q/scales are concatenated on
    the host and cross to the device once."""
    if not packed_list:
        return []
    dev = _target(packed_list, device)
    blocks = {int(p["block"]) for p in packed_list}
    if len(blocks) > 1:  # mixed block sizes cannot share a (rows, block)
        return [dequantize_flat(p, out_dtype=out_dtype, device=dev)
                for p in packed_list]
    block = blocks.pop()

    def cat(key, width):
        parts = [p[key] for p in packed_list]
        if all(isinstance(a, torch.Tensor) for a in parts):
            parts = [a.to(dev).reshape(-1, width) for a in parts]
            return parts[0] if len(parts) == 1 else torch.cat(parts)
        parts = [np.asarray(a).reshape(-1, width) for a in parts]
        host = np.ascontiguousarray(
            parts[0] if len(parts) == 1 else np.concatenate(parts))
        if not host.flags.writeable:  # a wire buffer: torch wants a copy
            host = host.copy()
        return torch.from_numpy(host).to(dev)

    q, s = cat("q", block), cat("scales", 1)
    spans, row = [], 0
    for p in packed_list:
        rows = int(np.size(p["q"])) // block
        spans.append((row, rows, int(p["orig_len"])))
        row += rows
    return dequantize_rows(q, s, spans, out_dtype)


# ---------------------------------------------------------------------------
# batched top-k selection (the top-k codec's path)
# ---------------------------------------------------------------------------

def topk_flat_batch(flats: Sequence, *, k_frac: float = 0.05) -> List[dict]:
    """[x_i] -> [{idx, vals, n}], the top-k sparse wire form, batched.

    Items are grouped by (length, k), k = ``max(1, int(size * k_frac))``
    (a per-length wire constant, computed as the reference does), and each
    group is stacked on its device and runs as ONE ``topk_rows`` call. No
    padding, ever: padding would change k and the selected set. Results lie
    on the items' device."""
    xs = [_flat_tensor(x).float() for x in flats]
    groups: dict = {}
    for i, x in enumerate(xs):
        size = x.numel()
        k = max(1, int(size * k_frac))
        groups.setdefault((size, k, x.device), []).append(i)
    out: List[dict] = [None] * len(xs)
    for (size, k, _), idxs in groups.items():
        gi, gv = tk.topk_rows(torch.stack([xs[i] for i in idxs]), k)
        for row, i in enumerate(idxs):
            out[i] = {"idx": gi[row], "vals": gv[row], "n": size}
    return out


def fedavg_accumulate_flat(acc, x, w) -> torch.Tensor:
    """One streaming fold ``acc + w * x`` over flat (T,) f32 vectors on one
    device, through the ``fedavg_accumulate`` kernel (no padding)."""
    return fr.fedavg_accumulate(torch.as_tensor(acc, dtype=torch.float32),
                                torch.as_tensor(x, dtype=torch.float32),
                                float(w))


def quantize_pytree(tree, *, block: int = 256):
    flat, unflatten = flatten_pytree(tree)
    return quantize_flat(flat, block=block), unflatten


def _normalised(weights) -> np.ndarray:
    """``weights / sum(weights)`` in f32, subnormal weights, sum and
    quotients flushed as XLA flushes them when the reference normalises
    (``quantize.div_ftz``)."""
    w = qz.flush_subnormals(torch.as_tensor(np.asarray(weights, np.float32)))
    total = np.sum(w.numpy(), dtype=np.float32)
    return qz.div_ftz(w, qz.flush_subnormals(torch.as_tensor(total))).numpy()


def fedavg_aggregate(updates: Sequence, weights):
    """Weighted average of N trees through the ``fedavg_reduce`` kernel's
    tree form, which reads every client's leaves in place (one launch on
    the card; on the CPU its plain version flattens and stacks them).
    Weights are normalised in f32 on the host, as the reference does.
    Returns a tree like updates[0], its leaves in updates[0]'s dtypes."""
    w = _normalised(weights)
    first, treedef = _tree.flatten(updates[0])
    leaves = [[l if isinstance(l, torch.Tensor) else torch.as_tensor(l)
               for l in ls]
              for ls in [first] + [_tree.leaves(u) for u in updates[1:]]]
    agg = fr.fedavg_reduce_leaves(leaves, w)
    return _tree.unflatten(treedef, [a.to(l.dtype)
                                     for a, l in zip(agg, leaves[0])])


def fedavg_aggregate_q8(packed_list: Sequence[dict], weights, unflatten, *,
                        device=None):
    """FedAvg over qsgd-packed updates (outputs of ``quantize_flat_batch``
    sharing one block and orig_len) through the ``fedavg_reduce_q8``
    kernel, which never materialises dequantised copies. Weights are
    normalised in f32 on the host. Host (wire) q/scales are stacked on the
    host and cross to ``device`` (default: the card) once; device ones stay
    where they are. The reference pads T to COL_TILE; the kernel masks its
    tail instead, and the result is cut to orig_len and unflattened."""
    w = _normalised(weights)
    dev = _target(packed_list, device)
    block = int(packed_list[0]["block"])
    orig = int(packed_list[0]["orig_len"])

    def stack(key):
        parts = [p[key] for p in packed_list]
        if all(isinstance(a, torch.Tensor) for a in parts):
            return torch.stack([a.reshape(-1) for a in parts]).to(dev)
        host = np.stack([np.asarray(a).reshape(-1) for a in parts])
        return torch.from_numpy(host).to(dev)

    agg = fr.fedavg_reduce_q8(stack("q"), stack("scales"),
                              torch.from_numpy(w).to(dev), block)
    return unflatten(agg[:orig])
