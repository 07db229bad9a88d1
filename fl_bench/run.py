"""Run one cell of the port's benchmark once, on the CUDA card.

    python3 fl_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``: each number the correctness check compared, with its limit
(also the last lines of standard error). Without a card, or with fewer
cards than the cell asks for, it exits 3 and prints no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "repro")
HOST_THREADS = 4


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"[fl_bench] no program to measure: {ROOT / 'src'} holds no "
              "repro_torch", file=sys.stderr)
        return 2
    # one process, few threads: the host's share of a step is steadier
    os.environ["OMP_NUM_THREADS"] = str(HOST_THREADS)
    # every cache stays inside the checkout, at a fixed path
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    torch.set_num_threads(HOST_THREADS)

    from fl_bench import cell as cells
    from fl_bench import harness
    cell = cells.resolve(ROOT, args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"[fl_bench] {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 3
    result = harness.run(cell, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace), device="cuda", t0=T0)
    found = banned_modules()
    if found:
        print(f"[fl_bench] the run loaded {', '.join(found)}: no result",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"[fl_bench] check {name} = {c['value']!r} "
              f"(limit {c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
