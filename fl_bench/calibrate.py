"""Readings that the correctness limits are set from, at a cell's own
sizes, on the card: the program over many seeds, the control (the
reference in bfloat16 in the program's place) and the planted faults.

    python3 fl_bench/calibrate.py --workload <name> --seeds 1 2 3 ... \
        [--control 3] \
        [--faults <name>...] [--fault-seeds 3]

Each line of output is one JSON object: the workload, the seed, what ran
(``program``, ``control`` or the fault's name) and the compared numbers.
No measured window: the checked aggregations run and are compared.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0,
                    help="how many of the seeds also run the control")
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from fl_bench import cell as cells
    from fl_bench import faults, harness
    cell = cells.resolve(ROOT, args.workload)

    def emit(seed, what, values, t0):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "what": what, "seconds": time.perf_counter() - t0,
                          **values}), flush=True)

    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        emit(seed, "program", harness.readings(cell, seed, args.device), t0)
        if i < args.control:
            t0 = time.perf_counter()
            emit(seed, "control", harness.readings(
                cell, seed, args.device, control=True), t0)
    for name in args.faults:
        for seed in args.seeds[:args.fault_seeds]:
            t0 = time.perf_counter()
            with faults.FAULTS[name]():
                emit(seed, name, harness.readings(cell, seed, args.device),
                     t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
