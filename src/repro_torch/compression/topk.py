"""Port of ``src/repro/compression/topk.py``: top-k magnitude
sparsification with error feedback (Wangni et al. 2018), on the
``topk_rows`` kernel (``kernels/ops.topk_flat_batch``).

Messages sharing a (length, k) land in one kernel call, and the sparse
wire form (|value| descending, ties to the lower index) is the
reference's bit for bit. The error-feedback residual stays on the
update's device: ``fed - recon`` is ``fed`` with the selected entries set
to 0, exactly, so it is computed as a copy of ``fed`` with zeros
scattered at ``idx``, without a round trip through the host wire copy.
``fed`` itself is the flushed ``f + error`` of ``qsgd.error_fed`` where a
state is given, as the reference's XLA add is; without one, ``f`` goes to
the kernel as it is (subnormals kept, as ``jax.lax.top_k`` keeps them).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.compression.qsgd import QuantState, error_fed
from repro_torch.kernels import ops


def topk_compress(tree, k_frac: float, state: Optional[QuantState] = None):
    """-> (payload dict {idx, vals, n}, new_state, unflatten)."""
    flat, unflatten = ops.flatten_pytree(tree)
    (payload,), (new_state,) = topk_compress_flat_batch(
        [flat], [state], k_frac=k_frac)
    return payload, new_state, unflatten


def topk_compress_flat_batch(flats, states, *, k_frac: float):
    """Batched core: [flat_i], [state_i|None] -> ([payload_i],
    [new_state_i]). Same-shape messages share one ``topk_rows`` call;
    per-item payloads and error-feedback transitions are bit-identical to
    ``topk_compress`` run message by message. Payloads lie on the flats'
    device."""
    fed = [error_fed(f, s) for f, s in zip(flats, states)]
    payloads = ops.topk_flat_batch(fed, k_frac=k_frac)
    new_states = [None] * len(flats)
    for i, s in enumerate(states):
        if s is None:
            continue
        residual = fed[i].float().clone()
        residual[payloads[i]["idx"].long()] = 0.0
        new_states[i] = QuantState(error=residual)
    return payloads, new_states


def topk_decompress(payload, unflatten, *, device=None):
    """The dense flat vector (zeros but at ``idx``), unflattened, on
    ``device`` (default: where ``vals`` lies)."""
    vals = torch.as_tensor(payload["vals"])
    dev = vals.device if device is None else torch.device(device)
    flat = torch.zeros(int(payload["n"]), dtype=vals.dtype, device=dev)
    flat[torch.as_tensor(payload["idx"]).to(dev).long()] = vals.to(dev)
    return unflatten(flat)


def payload_nbytes(payload) -> int:
    """Wire size of a sparse payload (int32 indices + f32 values)."""
    def numel(a):
        return a.numel() if isinstance(a, torch.Tensor) else int(np.size(a))
    return numel(payload["idx"]) * 4 + numel(payload["vals"]) * 4
