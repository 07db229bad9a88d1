"""Port of ``src/repro/configs/shapes.py``: the assigned input-shape set
and the (arch x shape) applicability matrix."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig

TRAIN_4K = ShapeConfig(name="train_4k", seq_len=4096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig(name="prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig(name="decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig(name="long_500k", seq_len=524_288, global_batch=1, kind="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

# families with sub-quadratic sequence mixing (may run long_500k)
_SUBQUADRATIC = {"ssm", "hybrid"}


def applicability(cfg: ModelConfig, shape: ShapeConfig):
    """Returns (runnable, reason). Reason explains documented skips (DESIGN.md)."""
    if shape.kind == "decode" and cfg.is_encoder_only:
        return False, f"{cfg.name} is encoder-only: no autoregressive decode step"
    if shape.name == "long_500k" and cfg.family not in _SUBQUADRATIC:
        return False, (
            f"{cfg.name} uses full attention; long_500k requires sub-quadratic "
            "sequence mixing (run only for ssm/hybrid archs)")
    return True, ""


def runnable_cells(configs: dict):
    """All (arch, shape) pairs; yields (cfg, shape, runnable, reason)."""
    for name in configs:
        cfg = configs[name]
        for sname in SHAPE_ORDER:
            shape = SHAPES[sname]
            ok, reason = applicability(cfg, shape)
            yield cfg, shape, ok, reason
