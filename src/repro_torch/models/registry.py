"""Port of ``src/repro/models/registry.py``: family -> implementation,
plus analytic param counting.

There is no ``Sharder``: ``build_model`` takes the device the model runs
on instead (the card unless the caller names another). Shapes come from
``init`` on the ``meta`` device, which allocates nothing. The port has no
logical axes, so the per-expert weights are found by their path (a
``moe`` block's ``w_gate``, ``w_up`` and ``w_down``), where the reference
looks for its ``expert`` and ``expert_in`` axes.
"""
from __future__ import annotations

import math

from repro_torch import _tree
from repro_torch.configs.base import ModelConfig

_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def build_model(cfg: ModelConfig, device=None):
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.models.xlstm import XLSTMModel
    from repro_torch.models.zamba import ZambaModel

    if cfg.family in ("dense", "moe", "audio", "vlm"):
        return TransformerLM(cfg, device)
    if cfg.family == "ssm":
        return XLSTMModel(cfg, device)
    if cfg.family == "hybrid":
        return ZambaModel(cfg, device)
    raise ValueError(f"unknown family {cfg.family}")


def param_shapes(cfg: ModelConfig):
    """The parameter tree as ``meta`` tensors: shapes and dtypes only."""
    return build_model(cfg, device="meta").init(None)


def param_count(cfg: ModelConfig) -> int:
    return sum(math.prod(l.shape) for l in _tree.leaves(param_shapes(cfg)))


def _expert_counts(tree, parent=""):
    """-> [(elements, is a per-expert weight)] over the tree's leaves."""
    out = []
    for key, child in tree.items():
        if isinstance(child, dict):
            out += _expert_counts(child, key)
        else:
            out.append((math.prod(child.shape),
                        parent == "moe" and key in _EXPERT_LEAVES))
    return out


def active_param_count(cfg: ModelConfig) -> int:
    """Active params per token (MoE: top-k of E experts + everything else)."""
    if cfg.num_experts == 0:
        return param_count(cfg)
    frac = cfg.experts_per_token / cfg.num_experts
    return sum(int(n * frac) if expert else n
               for n, expert in _expert_counts(param_shapes(cfg)))


def model_flops_per_token(cfg: ModelConfig) -> float:
    """MODEL_FLOPS = 6*N(_active)*D convention (per token, fwd+bwd)."""
    return 6.0 * active_param_count(cfg)
