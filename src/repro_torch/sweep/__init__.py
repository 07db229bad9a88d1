"""Port of ``src/repro/sweep/__init__.py`` (copied; imports re-pointed).

Declarative experiment engine: a Sweep (base Scenario + axes) expanded
into fingerprinted cells, executed with a resumable JSONL run store, and
reduced to reports by Study hooks (see spec.py / engine.py / runners.py;
the §VII decision-guideline study rides this in
benchmarks/fig10_decision_guide.py)."""
from repro_torch.sweep.engine import (Engine, RunStore, Study,
                                      StudyRunStats, fingerprint)
from repro_torch.sweep.result import CellResult
from repro_torch.sweep.runners import make_clients, run_scenario, wire_stats
from repro_torch.sweep.spec import Axis, Cell, Sweep, SweepError

__all__ = ["Axis", "Sweep", "Cell", "SweepError", "CellResult",
           "Engine", "RunStore", "Study", "StudyRunStats", "fingerprint",
           "run_scenario", "make_clients", "wire_stats"]
