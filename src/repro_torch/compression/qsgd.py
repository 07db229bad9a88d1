"""Port of ``src/repro/compression/qsgd.py``: QSGD-style int8 compression
with error feedback (Alistarh et al. 2017), on the quantize kernels.

The error-feedback residual lives on the update's device. The new
residual is ``fed - recon``, with ``recon`` dequantised on that device
from the device ``q`` and scales of the same launch; the host copy of
``q`` and scales is only the wire form. The numbers are the reference's,
which dequantises the host copy.

The error-feedback add ``f + error`` and the new residual ``fed - recon``
are flushed as XLA flushes subnormals when it runs the reference on the
CPU (``kernels/quantize.py``'s rule): inputs and results alike.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.quantize import flush_subnormals


class QuantState(NamedTuple):
    error: torch.Tensor  # flat f32 residual carried between rounds


def error_fed(flat, state: Optional[QuantState]) -> torch.Tensor:
    """The vector a codec compresses: ``flat``, plus the carried residual
    where a state is given, flushed as the reference's XLA add is."""
    flat = torch.as_tensor(flat)
    if state is None:
        return flat
    return flush_subnormals(flush_subnormals(flat)
                            + flush_subnormals(state.error))


def qsgd_init(example_tree) -> QuantState:
    flat, _ = ops.flatten_pytree(example_tree)
    return QuantState(error=torch.zeros_like(flat))


def qsgd_compress(tree, state: Optional[QuantState] = None, *,
                  block: int = 256):
    """-> (packed dict, new_state, unflatten). Wire payload = packed."""
    flat, unflatten = ops.flatten_pytree(tree)
    (packed,), (new_state,) = qsgd_compress_flat_batch([flat], [state],
                                                       block=block)
    return packed, new_state, unflatten


def qsgd_compress_flat_batch(flats, states, *, block: int = 256):
    """Batched core: [flat_i], [state_i|None] -> ([packed_i],
    [new_state_i]). One quantize launch for the whole batch, one
    dequantize launch for the error-feedback residuals, one host copy of
    the wire form; bit-identical per item to ``qsgd_compress`` run message
    by message."""
    fed = [error_fed(f, s) for f, s in zip(flats, states)]
    q, s, spans = ops.quantize_rows_batch(fed, block=block)
    ef_idx = [i for i, st in enumerate(states) if st is not None]
    new_states = [None] * len(flats)
    if ef_idx:
        recons = ops.dequantize_rows(q, s, [spans[i] for i in ef_idx])
        for i, recon in zip(ef_idx, recons):
            new_states[i] = QuantState(error=flush_subnormals(fed[i] - recon))
    return ops.packed_on_host(q, s, spans, block), new_states


def qsgd_decompress(packed, unflatten, *, device=None):
    return unflatten(ops.dequantize_flat(packed, device=device))


def packed_nbytes(packed) -> int:
    """Wire size of a packed payload (int8 + f32 scales)."""
    def numel(a):
        return a.numel() if isinstance(a, torch.Tensor) else int(np.size(a))
    return numel(packed["q"]) + numel(packed["scales"]) * 4
