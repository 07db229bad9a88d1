"""Port of ``src/repro/roofline/analysis.py``: the 4-term roofline of one
dry-run cell, on NVIDIA H100 SXM targets.

compute term    = FLOPs / peak_FLOP/s          (per device)
memory term     = bytes / HBM_bw               (per device)
collective term = collective_bytes / link_bw   [ICI; NVLink here]
DCN term        = cross-pod bytes / DCN_bw     (multi-pod)

The reference reads its counts from a compiled XLA artifact (its HLO walk
and ``memory_analysis()``). The port has none: ``analyze`` takes the
counts of ``roofline/cost.py`` instead, counted from the step function on
``meta`` tensors and from the sharding plan. The memory term uses the
reference's buffer inventory, every buffer written once and read once
(arguments + outputs + 2 x temps), with the temp-bytes estimate of
``cost.count_flops`` for XLA's temps.

The constants are the H100 SXM data sheet's, at its 700 W limit. A 16x16
mesh of H100s spans 32 hosts of 8 cards, so most of its "ICI" traffic
crosses hosts over the network, not NVLink: the ICI term at the NVLink
rate is a lower bound.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM, per card (data sheet, 700 W)
PEAK_FLOPS = 989.4e12  # dense bf16
HBM_BW = 3.35e12  # bytes/s
ICI_BW = 450e9  # bytes/s: NVLink 4, one direction
DCN_BW = 50e9  # bytes/s: one 400 Gb/s NDR port per card


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    kind: str
    mesh: str
    chips: int
    flops: float  # per device, counted on ``meta`` tensors
    bytes: float  # buffer-inventory traffic (args + outputs + 2*temps)
    coll_ici_bytes: float
    coll_dcn_bytes: float
    coll_by_op: dict
    model_flops: float  # 6*N(_active)*tokens for train, 2*N for fwd-only
    # seconds
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    t_dcn: float = 0.0

    def finalize(self):
        self.t_compute = self.flops / PEAK_FLOPS
        self.t_memory = self.bytes / HBM_BW
        self.t_collective = self.coll_ici_bytes / ICI_BW
        self.t_dcn = self.coll_dcn_bytes / DCN_BW
        return self

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective, "dcn": self.t_dcn}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective,
                   self.t_dcn)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (catches remat/dispatch waste).
        The count is per device, MODEL_FLOPS global -> divide by chips."""
        per_chip_model = self.model_flops / self.chips
        return per_chip_model / max(self.flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the program ran at
        its bound: (useful flops / peak) / bound_time."""
        per_chip_model = self.model_flops / self.chips
        ideal = per_chip_model / PEAK_FLOPS
        return ideal / max(self.bound_time, 1e-30)

    def to_dict(self):
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant, bound_time=self.bound_time,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS convention: 6*N*D for training; 2*N*D forward-only
    (prefill); 2*N_active per token for decode."""
    from repro_torch.models.registry import active_param_count

    n_active = active_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens_per_step
    return 2.0 * n_active * shape.tokens_per_step


def analyze(*, flops: float, memory: dict, collectives: dict, arch: str,
            shape, kind: str, mesh_name: str, chips: int, cfg) -> Roofline:
    """The roofline from ``roofline/cost.py``'s counts: per-device
    ``flops``, ``memory`` (argument, output and temp bytes) and
    ``collectives`` (``coll_ici_bytes``, ``coll_dcn_bytes``,
    ``coll_by_op``)."""
    traffic = (memory["argument_bytes"] + memory["output_bytes"]
               + 2 * memory["temp_bytes"])
    rl = Roofline(
        arch=arch, shape=shape.name, kind=kind, mesh=mesh_name, chips=chips,
        flops=flops, bytes=float(traffic), **collectives,
        model_flops=model_flops_for(cfg, shape))
    return rl.finalize()
