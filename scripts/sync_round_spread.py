"""How far one reduced sync round on the card lands from the same round on
the CPU, run after run: ``chip_smoke.py`` phase 6's comparison, repeated.

Each LABEL=ROOT names a checkout (a directory holding ``chip_smoke.py``
and ``src/``). Each runs in its own subprocess on its own ``src/``, in
turns (in order, then reversed): one round on the CPU (in the tree's
first turn, kept under ``build/`` for its second), then ``--repeats``
pairs of rounds on the card, one with cuDNN's deterministic algorithms and
one with its default ones, each held leaf by leaf against the CPU's. Per
card round it prints phase 6's numbers: the largest |card - CPU| of a
leaf over that leaf's largest entry, the largest |card - CPU| of any
leaf, and the leaves above the round's bar, by name (1e-4 of the leaf's
largest entry with the deterministic algorithms; max(that, LEAF_ATOL)
with the default ones). Once per tree it lists the kernels that one
training step of the reduced model launches under one setting and not
the other (``torch.profiler``): the algorithms the setting swaps. Needs
one CUDA card:

    python scripts/sync_round_spread.py change=. --repeats 6
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


def step_kernels(det):
    # the kernels one reduced training step launches under this setting
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import fl_train
    server, params, _, _ = fl_train.build_deployment(
        cs.FLConfig(num_clients=1), local_steps=1, device="cuda")
    client = server.clients[0]
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in next(client.dataset.batches(16, seed=0)).items()}
    with cs.cudnn_deterministic(det):
        client.train_fn(params, batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            client.train_fn(params, batch)
            torch.cuda.synchronize()
    return {cs.short_name(e.key) for e in prof.key_averages()}


if os.path.exists(cache):  # this tree's CPU round, from its first turn
    cpu_loss, cpu = torch.load(cache)
else:
    cpu_loss, cpu = round_on("cpu")
    torch.save((cpu_loss, cpu), cache)
    det, default = step_kernels(True), step_kernels(False)
    print(json.dumps({"only_deterministic": sorted(det - default),
                      "only_default": sorted(default - det)}), flush=True)
for r in range(repeats):
    for det in (True, False):
        with cs.cudnn_deterministic(det):
            loss, card = round_on("cuda")
        leaves = []
        for name, want in cpu.items():
            got = card[name].detach().cpu().float()
            err = float((got - want.float()).abs().max())
            top = float(want.abs().max())
            bar = max(cs.LEAF_RTOL * top, 0.0 if det else cs.LEAF_ATOL)
            leaves.append((err / max(top, 1e-12), name, err, top,
                           err / max(bar, 1e-30)))
        leaves.sort(reverse=True)
        print(json.dumps({"run": r, "deterministic": det, "loss": loss,
                          "cpu_loss": cpu_loss,
                          "max_rel_err": leaves[0][0],
                          "max_abs_err": max(l[2] for l in leaves),
                          "above_bar": [l for l in leaves if l[4] > 1.0],
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
    modes = {True: "deterministic", False: "default"}
    fails = {(label, m): 0 for label in order for m in modes}
    runs = {(label, m): 0 for label in order for m in modes}
    worst_abs = {(label, m): 0.0 for label in order for m in modes}
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
            if "only_default" in r:
                print(f"{label}: kernels of one training step with cuDNN's "
                      f"default algorithms only: {r['only_default']}; with "
                      f"its deterministic ones only: "
                      f"{r['only_deterministic']}", flush=True)
                continue
            key = (label, r["deterministic"])
            runs[key] += 1
            fails[key] += bool(r["above_bar"])
            worst_abs[key] = max(worst_abs[key], r["max_abs_err"])
            print(f"{label} run {r['run']} ({modes[r['deterministic']]}): "
                  f"loss {r['loss']:.6f} (CPU {r['cpu_loss']:.6f}), max rel "
                  f"err {r['max_rel_err']:.3e}, max abs err "
                  f"{r['max_abs_err']:.3e}; leaves above the bar: " + (
                      ", ".join(f"{n} (err {e:.3e}, largest entry {t:.3e}, "
                                f"rel {q:.3e})"
                                for q, n, e, t, _ in r["above_bar"])
                      or "none") + "; worst: " + ", ".join(
                      f"{n} {q:.3e} (abs {e:.3e})"
                      for q, n, e, _, _ in r["worst"]), flush=True)
    for (label, det), n in runs.items():
        bar = "1e-4 of each leaf's largest entry" if det else \
            "max(1e-4 of each leaf's largest entry, LEAF_ATOL)"
        print(f"{label}, {modes[det]} algorithms: {fails[label, det]} of {n} "
              f"card rounds have a leaf above phase 6's bar ({bar}); largest "
              f"abs err of any leaf {worst_abs[label, det]:.3e} ({smi})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
