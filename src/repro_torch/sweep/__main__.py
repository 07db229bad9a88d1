"""Port of ``src/repro/sweep/__main__.py`` (copied; imports re-pointed,
and the run store's default root is ``benchmarks_torch/out``, apart from
the reference's ``benchmarks/out``: a cell's fingerprint names its study
and scenario, not the package that ran it).

``python -m repro_torch.sweep sweep.json``: run a declarative sweep file.

Every cell goes through the generic scenario runner
(``repro_torch.sweep.runners.run_scenario``) — the same ``build_runtime`` path
``fl_train --scenario`` takes — with completed cells replayed from the
resumable run store. Prints one summary row per cell and optionally
writes the full CellResult list as a JSON report.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.scenario import ScenarioError
from repro_torch.sweep.engine import Engine, Study
from repro_torch.sweep.runners import run_scenario_cell
from repro_torch.sweep.spec import Sweep

OUT_DIR = "benchmarks_torch/out"


def run_sweep_file(path: str, *, out_dir: str = OUT_DIR,
                   fresh: bool = False, verbose: bool = True,
                   report_path: str = None, workers: int = 0) -> list:
    """Load + expand + execute one sweep file; returns the CellResults."""
    sweep = Sweep.load(path)
    study = Study(name=sweep.name, sweeps=lambda quick: (sweep,),
                  cell=run_scenario_cell,  # module-level: --workers pickles it
                  title=f"ad-hoc sweep {sweep.name} ({path})")
    engine = Engine(out_dir)
    cells = sweep.expand()
    results = engine.run_cells(study, cells, fresh=fresh, verbose=verbose,
                               workers=workers)
    if verbose:
        print(f"{'cell':44s} {'sim_time_s':>11s} {'round_s':>9s} "
              f"{'wire_MB':>9s} {'retx':>5s}")
        for r in results:
            print(f"{r.cell:44s} {r.sim_time_s:11.2f} "
                  f"{r.metrics.get('round_s', 0.0):9.2f} "
                  f"{r.bytes_on_wire / 2**20:9.1f} {r.retransmits:5.0f}")
    if report_path:
        os.makedirs(os.path.dirname(os.path.abspath(report_path)),
                    exist_ok=True)
        with open(report_path, "w") as f:
            json.dump([r.to_dict() for r in results], f, indent=2)
        if verbose:
            print(f"[sweep] JSON report -> {report_path}")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sweep",
        description="run a declarative Sweep file (base scenario + axes) "
                    "through the generic scenario runner")
    ap.add_argument("sweep", help="sweep JSON file (see "
                                  "examples/scenarios/*.json)")
    ap.add_argument("--out-dir", default=OUT_DIR,
                    help=f"run-store / report root (default {OUT_DIR})")
    ap.add_argument("--report", default=None,
                    help="write the full CellResult list to this JSON file")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore the run store; re-run every cell")
    ap.add_argument("--workers", type=int, default=0,
                    help="run missing cells on N worker processes")
    args = ap.parse_args(argv)
    try:
        run_sweep_file(args.sweep, out_dir=args.out_dir, fresh=args.fresh,
                       report_path=args.report, workers=args.workers)
    except (ScenarioError, OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
