"""Initial weights made on the device from the seed: one normal draw for
every random leaf together, from a generator on that device, cut into
leaves and scaled; norm scales are ones and biases zeros."""
from __future__ import annotations

import math

import torch

from fl_bench.reference.tree import items, replace_leaves


def init_params(specs, seed: int, device):
    """specs: a tree of ("normal", shape, std) | ("ones", shape) |
    ("zeros", shape) leaves -> a tree of float32 tensors on ``device``."""
    device = torch.device(device)
    specs_flat = [s for _, s in items(specs)]
    sizes = [math.prod(s[1]) for s in specs_flat]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    draw = torch.randn(sum(n for n, s in zip(sizes, specs_flat)
                           if s[0] == "normal"),
                       generator=gen, device=device, dtype=torch.float32)
    out, off = [], 0
    for n, s in zip(sizes, specs_flat):
        if s[0] == "normal":
            out.append(draw[off:off + n].view(s[1]) * s[2])
            off += n
        elif s[0] == "ones":
            out.append(torch.ones(s[1], device=device))
        else:
            out.append(torch.zeros(s[1], device=device))
    return replace_leaves(specs, out)
