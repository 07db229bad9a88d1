"""Port of ``src/repro/sweep/result.py`` (copied; imports re-pointed).

CellResult: the one record schema every study's cells emit.

Whatever a study measures — a p2p latency, a broadcast memory peak, a
full event-driven FL run — its cell lands in the same shape: identity
(study / cell name / spec fingerprint / axis values) plus the unified
wire-level block (simulated time, bytes on wire, per-stage charges,
retransmits, round reports) plus study-specific ``metrics``. The run
store (engine.RunStore) persists these as JSONL, and ``from_metrics``
canonicalises every value through JSON at creation time so a freshly-run
cell compares equal to its cached replay (tuples become lists, floats
survive exactly — important for the bit-for-bit trace comparisons the
fault studies make across cells).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List

# metric keys run_cell may emit that are lifted into typed fields
_LIFTED = ("sim_time_s", "bytes_on_wire", "retransmits",
           "transfers_failed", "n_rounds", "stage_charges",
           "round_reports")


@dataclasses.dataclass(frozen=True)
class CellResult:
    """One executed (or cache-replayed) sweep cell."""
    study: str
    cell: str                     # human-readable cell name (row name)
    fingerprint: str              # spec fingerprint (engine.fingerprint)
    overrides: Dict[str, Any]     # scenario axis values (dotted field ->)
    params: Dict[str, Any]        # non-scenario axis values + constants
    # -- the unified wire-level block -----------------------------------
    sim_time_s: float = 0.0       # simulated span of the cell's run
    bytes_on_wire: float = 0.0    # fabric bytes actually transmitted
    retransmits: float = 0.0      # fault-model chunk retransmissions
    transfers_failed: float = 0.0  # bounded-retry give-ups
    n_rounds: int = 0             # rounds / aggregations completed
    stage_charges: Dict[str, float] = dataclasses.field(
        default_factory=dict)     # per-stage/state simulated seconds
    round_reports: List[Any] = dataclasses.field(default_factory=list)
    # -- study-specific extras ------------------------------------------
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_metrics(cls, study: str, cell: str, fingerprint: str,
                     overrides: Dict[str, Any], params: Dict[str, Any],
                     metrics: Dict[str, Any]) -> "CellResult":
        """Lift the reserved keys of a run_cell metrics dict into the
        typed fields; the rest is study-specific. Everything is pushed
        through one JSON round-trip so fresh == cached, always."""
        metrics = dict(metrics)
        lifted = {k: metrics.pop(k) for k in _LIFTED if k in metrics}
        rec = cls(study=study, cell=cell, fingerprint=fingerprint,
                  overrides=dict(overrides), params=dict(params),
                  metrics=metrics, **lifted)
        return cls.from_dict(json.loads(json.dumps(rec.to_dict())))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "CellResult":
        if not isinstance(data, dict):
            raise ValueError(
                f"CellResult: expected an object, got {type(data).__name__}")
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - fields)
        if unknown:
            raise ValueError(f"CellResult: unknown key(s) {unknown}; "
                             f"valid keys: {sorted(fields)}")
        return cls(**data)

    def row(self) -> dict:
        """The benchmarks/run.py CSV row: name + every scalar metric."""
        out = {"name": self.cell}
        for k, v in self.metrics.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[k] = v
        return out

    def get(self, key: str, default: Any = None) -> Any:
        """Convenience lookup across the typed block and metrics."""
        if key in _LIFTED:
            return getattr(self, key)
        return self.metrics.get(key, default)
