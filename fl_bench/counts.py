"""The yardstick's arithmetic: the card's published peaks, the model
FLOPs of a local step counted from shapes, and the logical bytes of each
device op whose roofline share the benchmark reports (each input byte
read once, each output byte written once)."""
from __future__ import annotations

import math

import torch

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def hbm_rate(card: str) -> float:
    if card not in HBM_BYTES_PER_S:
        raise RuntimeError(f"no memory rate on record for card '{card}'")
    return HBM_BYTES_PER_S[card]


def bound_s(nbytes: float, card: str) -> float:
    """The least time the card could move ``nbytes`` in."""
    return nbytes / hbm_rate(card)


def step_flops(family_module, cfg: dict, specs, batch: int,
               image_size: int) -> int:
    """Model FLOPs of one local step (forward and backward) at ``batch``
    images of ``image_size``, counted on the ``meta`` device by
    ``FlopCounterMode`` (matmuls and convolutions)."""
    from torch.utils.flop_counter import FlopCounterMode

    from fl_bench.reference.tree import map_tree
    params = map_tree(lambda s: torch.empty(s[1], device="meta",
                                            requires_grad=True), specs)
    images = torch.empty((batch, image_size, image_size, 3), device="meta")
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: conv_backward_flops})
    with counter:
        logits = family_module.forward(params, images, cfg)
        logits.sum().backward()
    return int(counter.get_total_flops())


def conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                        _padding, _dilation, transposed, _output_padding,
                        _groups, output_mask, out_shape=None) -> int:
    """The input and weight gradients of a convolution each cost what its
    forward costs, 2 x output positions x the weight's elements. The
    weight holds C_in / groups input channels, so a depthwise conv counts
    as such (torch's own formula counts its gradients C_in times over)."""
    fwd = 2 * grad_out_shape[0] * math.prod(grad_out_shape[2:]) \
        * math.prod(w_shape)
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def _nbytes(t) -> int:
    t = torch.as_tensor(t)
    return t.numel() * t.element_size()


# logical bytes of one call of each op, from its arguments and result
def fedavg_bytes(args, out) -> int:
    """ops.fedavg_aggregate(updates, weights): N trees in, one out."""
    from fl_bench.reference.tree import leaves
    updates = args[0]
    one = sum(_nbytes(l) for l in leaves(updates[0]))
    return (len(updates) + 1) * one


def topk_bytes(args, out) -> int:
    """ops.topk_flat_batch(flats): each row read; k indices and values
    written per row."""
    read = sum(_nbytes(f) for f in args[0])
    return read + sum(_nbytes(o["idx"]) + _nbytes(o["vals"]) for o in out)


def quantize_bytes(args, out) -> int:
    """ops.quantize_rows_batch(flats): n floats read; n int8 and one f32
    scale per block written (the item's own length, not the padding)."""
    block = 256 if len(args) < 2 else int(args[1])
    n = sum(torch.as_tensor(f).numel() for f in args[0])
    blocks = sum(math.ceil(torch.as_tensor(f).numel() / block)
                 for f in args[0])
    return 4 * n + n + 4 * blocks


def dequantize_bytes(args, out) -> int:
    """ops.dequantize_rows(q, s, spans): per item n int8 and its scales
    read, n floats written."""
    q, spans = args[0], args[2]
    block = q.shape[1]
    n = sum(s[2] for s in spans)
    blocks = sum(math.ceil(s[2] / block) for s in spans)
    return n + 4 * blocks + 4 * n
