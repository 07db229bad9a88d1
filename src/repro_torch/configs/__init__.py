"""Port of ``src/repro/configs/``: the FL round config and the paper's
payload tiers."""
from repro_torch.configs.base import FLConfig
from repro_torch.configs.paper_tiers import TIER_ORDER, TIERS, Tier

__all__ = ["FLConfig", "TIERS", "TIER_ORDER", "Tier"]
