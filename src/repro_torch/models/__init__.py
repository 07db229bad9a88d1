"""Port of ``src/repro/models/``: the paper-tier models (ResNet56,
MobileNetV3, DistilBERT, ViT-Large) and the dense transformer core."""
