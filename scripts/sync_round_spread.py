"""How far one reduced sync round on the card lands from the same round on
the CPU, run after run: ``chip_smoke.py`` phase 6's comparison, repeated.

Each LABEL=ROOT names a checkout (a directory holding ``chip_smoke.py``
and ``src/``). Each runs in its own subprocess on its own ``src/``, in
turns (in order, then reversed): one round on the CPU (in the tree's
first turn, kept under ``build/`` for its second), then ``--repeats``
rounds on the card with cuDNN's default algorithms, each held leaf by leaf
against the CPU's. Per card round it prints phase 6's number (the largest
|card - CPU| of a leaf over that leaf's largest entry) and the leaves
above phase 6's bar of 1e-4, by name. Needs one CUDA card:

    python scripts/sync_round_spread.py parent=build/parent change=. \\
        --repeats 6
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

WORKER = r"""
import json, sys
root, repeats, cache = sys.argv[1], int(sys.argv[2]), sys.argv[3]
import os
sys.path[:0] = [root, root + "/src"]
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def named(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named(tree[k], f"{path}.{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, c in enumerate(tree):
            yield from named(c, f"{path}[{i}]")
    else:
        yield path, tree


def round_on(device):
    (rep,), params, _ = cs.run_rounds("torch_rpc", rounds=1, reduced=True,
                                      device=device, quorum=1.0)
    return rep.losses, dict(named(params))


if os.path.exists(cache):  # this tree's CPU round, from its first turn
    cpu_loss, cpu = torch.load(cache)
else:
    cpu_loss, cpu = round_on("cpu")
    torch.save((cpu_loss, cpu), cache)
for r in range(repeats):
    loss, card = round_on("cuda")
    leaves = []
    for name, want in cpu.items():
        got = card[name].detach().cpu().float()
        err = float((got - want.float()).abs().max())
        top = float(want.abs().max())
        leaves.append((err / max(top, 1e-12), name, err, top))
    leaves.sort(reverse=True)
    print(json.dumps({"run": r, "loss": loss, "cpu_loss": cpu_loss,
                      "max_rel_err": leaves[0][0],
                      "above_1e-4": [l for l in leaves if l[0] > 1e-4],
                      "worst": leaves[:3]}), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", metavar="LABEL=ROOT")
    ap.add_argument("--repeats", type=int, default=6)
    args = ap.parse_args()
    trees = dict(t.split("=", 1) for t in args.trees)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    order = list(trees)
    fails = {label: 0 for label in order}
    runs = {label: 0 for label in order}
    (ROOT / "build").mkdir(exist_ok=True)
    for label in order:
        (ROOT / "build" / f"spread_cpu_{label}.pt").unlink(missing_ok=True)
    for label in order + order[::-1]:
        root = (ROOT / trees[label]).resolve()
        cache = ROOT / "build" / f"spread_cpu_{label}.pt"
        proc = subprocess.run([sys.executable, "-c", WORKER, str(root),
                               str(args.repeats), str(cache)],
                              capture_output=True, text=True, cwd=root)
        if proc.returncode:
            raise RuntimeError(f"{label}: the rounds failed\n"
                               f"{proc.stdout}{proc.stderr[-4000:]}")
        for line in proc.stdout.splitlines():
            if not line.startswith("{"):
                continue
            r = json.loads(line)
            runs[label] += 1
            fails[label] += bool(r["above_1e-4"])
            print(f"{label} run {r['run']}: loss {r['loss']:.6f} (CPU "
                  f"{r['cpu_loss']:.6f}), max rel err {r['max_rel_err']:.3e}"
                  f"; leaves above 1e-4: " + (", ".join(
                      f"{n} (err {e:.3e}, largest entry {t:.3e}, rel "
                      f"{q:.3e})" for q, n, e, t in r["above_1e-4"])
                      or "none") + "; worst: " + ", ".join(
                      f"{n} {q:.3e}" for q, n, _, _ in r["worst"]),
                  flush=True)
    for label in order:
        print(f"{label}: {fails[label]} of {runs[label]} card rounds have a "
              f"leaf above phase 6's bar of 1e-4 ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
