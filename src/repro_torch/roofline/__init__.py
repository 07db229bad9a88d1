"""Port of ``src/repro/roofline/``: the roofline of a dry-run cell on H100
targets (``analysis``), its counts on ``meta`` tensors (``cost``) and the
reference's framework-free collective helpers (``hlo_cost``)."""
from repro_torch.roofline.analysis import (DCN_BW, HBM_BW, ICI_BW, PEAK_FLOPS,
                                           Roofline, analyze, model_flops_for)
from repro_torch.roofline.hlo_cost import Cost

__all__ = ["analyze", "Roofline", "Cost", "model_flops_for", "PEAK_FLOPS",
           "HBM_BW", "ICI_BW", "DCN_BW"]
