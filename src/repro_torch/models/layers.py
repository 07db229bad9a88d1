"""Port of ``src/repro/models/layers.py``, limited to the loss the
vision models use; the LM layers arrive with the LM slice."""
from __future__ import annotations

import torch


def cross_entropy(logits, targets, *, z_loss: float = 1e-4):
    """Mean token cross-entropy in fp32 with z-loss regulariser."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    loss = torch.mean(lse - ll)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss
