"""Time builds of the port's ``topk_rows`` and ``fedavg_accumulate`` kernels
from several source trees side by side on the card, e.g. a parent commit's
sources against the working tree's:

    git archive HEAD~1 src/repro_torch/kernels/csrc | tar -x -C build/parent
    python scripts/kernel_ab.py \\
        parent=build/parent/src/repro_torch/kernels/csrc \\
        change=src/repro_torch/kernels/csrc

Each directory's ``topk.cu`` and ``fedavg_reduce.cu`` are built with the
port's nvcc flags into ``build/kernel_ab/<label>/``, each build is held
bit-exact against the plain versions at the main paths' shapes, and then
every build is timed in turns (in order, then reversed, twice) with L2
flushed before each call (``chip_smoke.time_cold``), beside
``torch.topk(x.abs(), k)`` and ``torch.add(acc, x, alpha=w)``. Each build's
``topk_rows`` is also broken down by kernel with ``torch.profiler``.
Needs a CUDA card; the C interfaces of the two files must be the ones
``kernels/topk.py`` and ``kernels/fedavg_reduce.py`` bind.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

OUT = ROOT / "build" / "kernel_ab"
P = ctypes.c_void_p
I64 = ctypes.c_int64


def build(label: str, csrc: Path) -> dict:
    """Compile the two sources of one tree; returns the bound libraries and
    the ptxas lines (registers, spills)."""
    out = OUT / label
    out.mkdir(parents=True, exist_ok=True)
    libs, report = {}, []
    for name in ("topk", "fedavg_reduce"):
        so = out / f"lib{name}.so"
        proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(so), str(csrc / f"{name}.cu")],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{label}: nvcc failed on {name}.cu\n"
                               f"{proc.stdout}{proc.stderr}")
        report += [ln.strip() for ln in (proc.stdout + proc.stderr)
                   .splitlines() if "registers" in ln or "spill" in ln]
        libs[name] = ctypes.CDLL(str(so))
    topk = libs["topk"]
    topk.topk_rows_f32.argtypes = [P, P, P, P, I64, I64, I64, P]
    topk.topk_rows_scratch_words.argtypes = [I64, I64, I64]
    topk.topk_rows_scratch_words.restype = I64
    acc = libs["fedavg_reduce"]
    acc.fedavg_accumulate_f32.argtypes = [P, P, ctypes.c_float, P, I64, P]
    return {"topk": topk, "acc": acc, "report": report}


def topk_call(lib, x, k):
    b, t = x.shape
    idx = torch.empty((b, k), dtype=torch.int32, device=x.device)
    vals = torch.empty((b, k), dtype=torch.float32, device=x.device)
    scratch = torch.empty(lib.topk_rows_scratch_words(b, t, k),
                          dtype=torch.int32, device=x.device)
    rc = lib.topk_rows_f32(x.data_ptr(), idx.data_ptr(), vals.data_ptr(),
                           scratch.data_ptr(), b, t, k,
                           torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"topk_rows launch failed ({rc})")
    return idx, vals


def acc_call(lib, acc, x, w):
    out = torch.empty_like(acc)
    rc = lib.fedavg_accumulate_f32(acc.data_ptr(), x.data_ptr(), w,
                                   out.data_ptr(), acc.shape[0],
                                   torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"fedavg_accumulate launch failed ({rc})")
    return out


def in_turns(fns: dict) -> dict:
    """{label: fn} -> {label: [ms, ...]}: timed in order, then reversed,
    twice."""
    times = {label: [] for label in fns}
    order = list(fns)
    for turn in range(4):
        for label in (order if turn % 2 == 0 else order[::-1]):
            times[label].append(cs.time_cold(fns[label], reps=20))
    return times


def show(what: str, times: dict, card: str) -> None:
    print(f"{what}: " + "; ".join(
        f"{label} " + " / ".join(f"{ms * 1e3:.3f}" for ms in v) + " µs"
        for label, v in times.items()) + f" ({card})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("builds", nargs="+", metavar="LABEL=CSRC_DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    trees = dict(b.split("=", 1) for b in args.builds)
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    with ThreadPoolExecutor(max_workers=len(trees)) as pool:
        built = dict(zip(trees, pool.map(
            lambda kv: build(kv[0], ROOT / kv[1]), trees.items())))
    for label, b in built.items():
        print(f"{label} ({trees[label]}) ptxas: " + " | ".join(
            sorted(set(b["report"]))), flush=True)

    g = torch.Generator(device="cuda").manual_seed(14)
    for t in (cs.MEDIUM_T, cs.MAIN_T):
        k = cs.topk_k(t)
        x = torch.randn((1, t), generator=g, device="cuda") * 1e-2
        for b in built.values():
            cs.hold_topk(x, k, topk_call(b["topk"], x, k))
        fns = {label: (lambda b=b: topk_call(b["topk"], x, k))
               for label, b in built.items()}
        fns["torch.topk"] = lambda: torch.topk(x.abs(), k)
        show(f"topk_rows (1, {t}) k={k}, bit-exact", in_turns(fns), card)
        for label, b in built.items():
            parts = cs.device_breakdown(lambda b=b: topk_call(b["topk"], x, k))
            print(f"  {label} by kernel (warm, µs per call): " + "; ".join(
                f"{cs.short_name(n)} {us:.3f} (x{c:g})" for n, us, c in parts),
                flush=True)

    acc = torch.randn(cs.MAIN_T, generator=g, device="cuda")
    upd = torch.randn(cs.MAIN_T, generator=g, device="cuda")
    for b in built.values():
        cs.hold_accumulate(acc, upd, cs.ACC_W,
                           acc_call(b["acc"], acc, upd, cs.ACC_W))
    fns = {label: (lambda b=b: acc_call(b["acc"], acc, upd, cs.ACC_W))
           for label, b in built.items()}
    fns["torch.add"] = lambda: torch.add(acc, upd, alpha=cs.ACC_W)
    show(f"fedavg_accumulate T={cs.MAIN_T}, bit-exact", in_turns(fns), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
