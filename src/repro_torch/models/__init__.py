"""Port of ``src/repro/models/``: the paper-tier models (ResNet56,
MobileNetV3, DistilBERT, ViT-Large) and the LM zoo (the dense, MoE, audio
and VLM transformers, xLSTM, Zamba2) with its registry."""
from repro_torch.models.registry import (active_param_count, build_model,
                                         model_flops_per_token, param_count,
                                         param_shapes)

__all__ = ["build_model", "param_count", "active_param_count",
           "model_flops_per_token", "param_shapes"]
