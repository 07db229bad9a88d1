"""Port of ``src/repro/configs/``: the 10 LM architectures
(``get_config(arch_id)``, ``smoke_config`` for their reduced same-family
variants), the input shapes, the FL round config and the paper's payload
tiers. Every field is copied as the reference writes it.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import FLConfig, ModelConfig, ShapeConfig
from repro_torch.configs.paper_tiers import TIER_ORDER, TIERS, Tier
from repro_torch.configs.shapes import (SHAPES, SHAPE_ORDER, applicability,
                                        runnable_cells)

__all__ = ["ARCHS", "ARCH_ORDER", "FLConfig", "ModelConfig", "SHAPES",
           "SHAPE_ORDER", "ShapeConfig", "TIERS", "TIER_ORDER", "Tier",
           "applicability", "get_config", "runnable_cells", "smoke_config"]

# ---------------------------------------------------------------------------
# the 10 assigned architectures
# ---------------------------------------------------------------------------

XLSTM_1_3B = ModelConfig(
    name="xlstm-1.3b", family="ssm",  # [arXiv:2405.04517; unverified]
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4, d_ff=0,
    vocab_size=50304, slstm_every=8, ssm_expand=2, mlstm_chunk=256)

QWEN3_8B = ModelConfig(
    name="qwen3-8b", family="dense",  # [hf:Qwen/Qwen3-8B; hf]
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8, d_ff=12288,
    vocab_size=151936, head_dim=128, qk_norm=True, rope_theta=1e6)

DEEPSEEK_67B = ModelConfig(
    name="deepseek-67b", family="dense",  # [arXiv:2401.02954; hf]
    num_layers=95, d_model=8192, num_kv_heads=8, num_heads=64, d_ff=22016,
    vocab_size=102400, head_dim=128)

GRANITE_3_8B = ModelConfig(
    name="granite-3-8b", family="dense",  # [hf:ibm-granite/granite-3.0; hf]
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8, d_ff=12800,
    vocab_size=49155, head_dim=128, tie_embeddings=True)

STABLELM_12B = ModelConfig(
    name="stablelm-12b", family="dense",  # [hf:stabilityai/stablelm-2; hf]
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, d_ff=13824,
    vocab_size=100352, head_dim=160)

ZAMBA2_1_2B = ModelConfig(
    name="zamba2-1.2b", family="hybrid",  # [arXiv:2411.15242; hf]
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32, d_ff=8192,
    vocab_size=32000, head_dim=64, ssm_state=64, ssm_head_dim=64,
    ssm_expand=2, attn_every=6, shared_attn_lora_rank=64)

GRANITE_MOE_1B = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",  # [hf:ibm-granite; hf]
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8, d_ff=512,
    vocab_size=49155, head_dim=64, num_experts=32, experts_per_token=8,
    moe_interleave=1, tie_embeddings=True)

LLAMA4_MAVERICK = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",  # [hf:meta-llama; unverified]
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, d_ff=8192,
    vocab_size=202048, head_dim=128, num_experts=128, experts_per_token=1,
    moe_interleave=2, d_ff_dense=16384, num_shared_experts=1,
    capacity_factor=1.25)

HUBERT_XLARGE = ModelConfig(
    name="hubert-xlarge", family="audio",  # [arXiv:2106.07447; unverified]
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16, d_ff=5120,
    vocab_size=504, causal=False, external_embeddings=True)

LLAMA32_VISION_11B = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",  # [hf:meta-llama; unverified]
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8, d_ff=14336,
    vocab_size=128256, head_dim=128, cross_attn_every=5,
    num_image_tokens=1601)

ARCHS = {c.name: c for c in (
    XLSTM_1_3B, QWEN3_8B, DEEPSEEK_67B, GRANITE_3_8B, STABLELM_12B,
    ZAMBA2_1_2B, GRANITE_MOE_1B, LLAMA4_MAVERICK, HUBERT_XLARGE,
    LLAMA32_VISION_11B)}
ARCH_ORDER = list(ARCHS)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; available: {list(ARCHS)}")
    return ARCHS[name]


# ---------------------------------------------------------------------------
# reduced same-family smoke configs (CPU: one fwd/train step, tiny shapes)
# ---------------------------------------------------------------------------

def smoke_config(name: str) -> ModelConfig:
    cfg = get_config(name)
    common = dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                  vocab_size=128, remat="none", attn_chunk=32,
                  moe_group_size=64)
    if cfg.family == "ssm":
        return dataclasses.replace(
            cfg, name=f"{cfg.name}-smoke", num_layers=4, slstm_every=2,
            mlstm_chunk=8, **{**common, "num_kv_heads": 4})
    if cfg.family == "hybrid":
        return dataclasses.replace(
            cfg, name=f"{cfg.name}-smoke", num_layers=5, attn_every=2,
            ssm_state=8, ssm_head_dim=16, ssm_chunk=8, d_ff=128,
            shared_attn_lora_rank=4,
            **{**common, "num_kv_heads": 4})
    if cfg.family == "moe":
        k = cfg.moe_interleave
        return dataclasses.replace(
            cfg, name=f"{cfg.name}-smoke", num_layers=2 * k, d_ff=32,
            d_ff_dense=64 if cfg.d_ff_dense else 0, num_experts=4,
            experts_per_token=min(cfg.experts_per_token, 2), **common)
    if cfg.family == "vlm":
        return dataclasses.replace(
            cfg, name=f"{cfg.name}-smoke", num_layers=2 * cfg.cross_attn_every,
            d_ff=128, num_image_tokens=8, **common)
    # dense / audio
    return dataclasses.replace(cfg, name=f"{cfg.name}-smoke", num_layers=2,
                               d_ff=128, **common)
