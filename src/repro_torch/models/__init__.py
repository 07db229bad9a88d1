"""Port of ``src/repro/models/``: the paper-tier models (ResNet56 so far)."""
