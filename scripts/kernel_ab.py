"""Time builds of the port's ``topk_rows``, ``fedavg_accumulate``,
``quantize_blocks``, ``dequantize_blocks``, ``fedavg_reduce`` and
``fedavg_reduce_q8`` kernels from several source trees side by side on the
card, e.g. a parent commit's sources against the working tree's:

    git archive HEAD~1 src/repro_torch | tar -x -C build/parent
    python scripts/kernel_ab.py \\
        parent=build/parent/src/repro_torch/kernels/csrc \\
        change=src/repro_torch/kernels/csrc

Each directory's ``topk.cu``, ``fedavg_reduce.cu`` and ``quantize.cu`` are
built with the port's nvcc flags into ``build/kernel_ab/<label>/``, each
build is held against the plain versions at the main paths' shapes (bit-exact; dequantize rtol 1e-6; quantize and dequantize
also on inputs off 16-byte alignment), and then every build is timed in
turns (in order, then reversed, twice) with L2 flushed before each call
(``chip_smoke.time_cold``), beside ``torch.topk(x.abs(), k)``,
``torch.add(acc, x, alpha=w)`` and, for the quantize pair at (3392, 256)
f32, ``torch.mul(q, s)``, the same-bytes casts ``x.to(torch.int8)`` and
``q.to(torch.float32)`` and an empty kernel launch (this checkout's
``quantize.cu``). The quantize pair is timed once more with L2 emptied by
a read, which leaves no dirty lines to write back. Each build's
``topk_rows``, ``quantize_blocks`` and ``dequantize_blocks`` are also
broken down by kernel with ``torch.profiler`` (warm).

FedAvg: every build's (N, T) ``fedavg_reduce`` at (5, 868,123) f32 and
``fedavg_reduce_q8`` at (5, 868,352) block 256, held against this
checkout's plain versions (bit-exact where the build flushes and sums in
client order as they do, else at the reference's rtol 1e-4 / atol 1e-5),
timed in turns cold and replayed from a CUDA graph (warm), beside this
checkout's tree form on 5 ResNet56 trees (prepared tables), ``torch.mv``
and an empty launch. Then ``ops.fedavg_aggregate`` on 5 ResNet56 trees
runs in a subprocess on each tree's own ``src/`` (the directory three
levels above its ``csrc``), in turns: synchronised host ms and the device
µs per call that ``torch.profiler`` sums over its kernels, and then
``fl.aggregator.merge_global`` of two ResNet56 trees (the event-driven
server's merge), synchronised host ms. Needs a CUDA
card; a tree whose C interface lacks a symbol that ``kernels/topk.py``,
``kernels/fedavg_reduce.py`` or ``kernels/quantize.py`` binds is reported
by name and stops the run.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fedavg_reduce as fr  # noqa: E402
from repro_torch.kernels import quantize as qz  # noqa: E402
from repro_torch.models.vision import ResNet, ResNetConfig  # noqa: E402

OUT = ROOT / "build" / "kernel_ab"
P = ctypes.c_void_p
I64 = ctypes.c_int64


def bind(label: str, lib, sym: str, argtypes, restype=ctypes.c_int):
    try:
        fn = getattr(lib, sym)
    except AttributeError:
        raise RuntimeError(f"{label}: its C interface has no {sym}") from None
    fn.argtypes, fn.restype = argtypes, restype


def build(label: str, csrc: Path) -> dict:
    """Compile the three sources of one tree; returns the bound libraries
    and the ptxas lines (registers, spills)."""
    out = OUT / label
    out.mkdir(parents=True, exist_ok=True)
    libs, report = {}, []
    for name in ("topk", "fedavg_reduce", "quantize"):
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
    bind(label, libs["topk"], "topk_rows_f32", [P, P, P, P, I64, I64, I64, P])
    bind(label, libs["topk"], "topk_rows_scratch_words", [I64, I64, I64],
         I64)
    bind(label, libs["fedavg_reduce"], "fedavg_accumulate_f32",
         [P, P, ctypes.c_float, P, I64, P])
    bind(label, libs["fedavg_reduce"], "fedavg_reduce_f32",
         [P, P, P, I64, I64, P])
    bind(label, libs["fedavg_reduce"], "fedavg_reduce_q8",
         [P, P, P, P, I64, I64, I64, P])
    for sym in ("quantize_blocks_f32", "dequantize_blocks_f32"):
        bind(label, libs["quantize"], sym, [P, P, P, I64, I64, P])
    return {"topk": libs["topk"], "acc": libs["fedavg_reduce"],
            "qz": libs["quantize"], "report": report}


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


def quantize_call(lib, x):
    rows, block = x.shape
    q = torch.empty((rows, block), dtype=torch.int8, device=x.device)
    s = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    rc = lib.quantize_blocks_f32(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                                 rows, block,
                                 torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"quantize_blocks launch failed ({rc})")
    return q, s


def dequantize_call(lib, q, s):
    rows, block = q.shape
    out = torch.empty((rows, block), dtype=torch.float32, device=q.device)
    rc = lib.dequantize_blocks_f32(q.data_ptr(), s.data_ptr(),
                                   out.data_ptr(), rows, block,
                                   torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"dequantize_blocks launch failed ({rc})")
    return out


def reduce_call(lib, x, w):
    n, t = x.shape
    out = torch.empty(t, dtype=torch.float32, device=x.device)
    rc = lib.fedavg_reduce_f32(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                               n, t, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"fedavg_reduce launch failed ({rc})")
    return out


def q8_call(lib, q, s, w, block):
    n, t = q.shape
    out = torch.empty(t, dtype=torch.float32, device=q.device)
    rc = lib.fedavg_reduce_q8(q.data_ptr(), s.data_ptr(), w.data_ptr(),
                              out.data_ptr(), n, t, block,
                              torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"fedavg_reduce_q8 launch failed ({rc})")
    return out


def hold_close(what: str, got, want) -> str:
    """'bit-exact', or the max abs error within the reference's bar."""
    if cs.bits_equal(got, want):
        return "bit-exact"
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
        raise AssertionError(f"{what}: max abs err {err:.3e} beyond rtol "
                             f"1e-4 / atol 1e-5")
    return f"max abs err {err:.3e}"


def time_clean(fn, reps: int = 30) -> float:
    """As ``chip_smoke.time_cold``, but L2 is emptied by reading a buffer
    larger than it, so no dirty line is left to write back."""
    flush = torch.ones(cs.FLUSH_BYTES // 4, dtype=torch.float32,
                       device="cuda")
    fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        flush.max()
        torch.cuda._sleep(200_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def in_turns(fns: dict, timer=cs.time_cold) -> dict:
    """{label: fn} -> {label: [ms, ...]}: timed in order, then reversed,
    twice."""
    times = {label: [] for label in fns}
    order = list(fns)
    for turn in range(4):
        for label in (order if turn % 2 == 0 else order[::-1]):
            times[label].append(timer(fns[label], reps=20))
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
    quantize_ab(built, g, card)
    fedavg_ab(built, g, card)
    aggregate_ab(trees, card)
    return 0


def fedavg_ab(built: dict, g, card: str) -> None:
    """The (N, T) form and q8 of every build, and this checkout's tree
    form, cold and graph-replayed, in turns."""
    n, t = cs.MAIN_N, cs.MAIN_T
    template, _ = _tree.flatten(ResNet(ResNetConfig(), device="cuda").init(
        torch.Generator().manual_seed(1)))
    leaves = cs.client_leaves(template, n, g, views=False)
    x = torch.stack([torch.cat([l.reshape(-1) for l in c]) for c in leaves])
    wd = torch.full((n,), 1.0 / n, device="cuda")
    w = wd.cpu().numpy()
    want = fr.fedavg_reduce_plain(x, wd)
    for label, b in built.items():
        print(f"{label} fedavg_reduce ({n}, {t}): "
              f"{hold_close(label, reduce_call(b['acc'], x, wd), want)}",
              flush=True)
    call = fr.leaf_call(leaves, w)
    out = torch.empty(call.plan.numel, device="cuda")
    cs.hold_leaves(leaves, w, fr.leaf_views(call.plan,
                                            fr.launch_leaves(call, out)))
    fns = {label: (lambda b=b: reduce_call(b["acc"], x, wd))
           for label, b in built.items()}
    fns["this checkout's tree form"] = lambda: fr.launch_leaves(call, out)
    fns["torch.mv"] = lambda: torch.mv(x.t(), wd)
    fns["empty launch"] = cs.empty_launch
    for timer, how in ((cs.time_cold, "cold, L2 flushed by writes"),
                       (cs.time_graph, "graph-replayed, warm")):
        show(f"fedavg_reduce ({n}, {t}) f32 as (N, T) rows, and the tree "
             f"form on {n} ResNet56 trees, {how}", in_turns(fns, timer), card)

    tq = cs.Q8_T
    q = torch.randint(-127, 128, (n, tq), generator=g, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((n, tq // cs.QSGD_BLOCK), generator=g, device="cuda") \
        * 1e-2
    want = fr.fedavg_reduce_q8_plain(q, s, wd, cs.QSGD_BLOCK)
    for label, b in built.items():
        got = q8_call(b["acc"], q, s, wd, cs.QSGD_BLOCK)
        print(f"{label} fedavg_reduce_q8 ({n}, {tq}): "
              f"{hold_close(label, got, want)}", flush=True)
    fns = {label: (lambda b=b: q8_call(b["acc"], q, s, wd, cs.QSGD_BLOCK))
           for label, b in built.items()}
    fns["empty launch"] = cs.empty_launch
    for timer, how in ((cs.time_cold, "cold, L2 flushed by writes"),
                       (cs.time_graph, "graph-replayed, warm")):
        show(f"fedavg_reduce_q8 ({n}, {tq}) block {cs.QSGD_BLOCK}, {how}",
             in_turns(fns, timer), card)


AGGREGATE = r"""
import json, statistics, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import ops
from repro_torch.models.vision import ResNet, ResNetConfig
model = ResNet(ResNetConfig(), device="cuda")
trees = [model.init(torch.Generator().manual_seed(s)) for s in range(5)]
w = [64.0] * 5
for _ in range(3):
    ops.fedavg_aggregate(trees, w)
torch.cuda.synchronize()
host = []
for _ in range(30):
    t0 = time.perf_counter()
    ops.fedavg_aggregate(trees, w)
    torch.cuda.synchronize()
    host.append((time.perf_counter() - t0) * 1e3)
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(5):
        ops.fedavg_aggregate(trees, w)
    torch.cuda.synchronize()
dev = {}
for e in prof.key_averages():
    us = getattr(e, "device_time_total", None)
    us = getattr(e, "cuda_time_total", 0.0) if us is None else us
    if us > 0:
        dev[e.key[:60]] = us / 5
from repro_torch.fl.aggregator import merge_global
for _ in range(3):
    merge_global(trees[0], trees[1], 0.5)
torch.cuda.synchronize()
merge = []
for _ in range(30):
    t0 = time.perf_counter()
    merge_global(trees[0], trees[1], 0.5)
    torch.cuda.synchronize()
    merge.append((time.perf_counter() - t0) * 1e3)
print(json.dumps({"host_ms": statistics.median(host), "host_ms_all": host,
                  "device_us": sum(dev.values()), "kernels": dev,
                  "merge_ms": statistics.median(merge)}))
"""


def aggregate_ab(trees: dict, card: str) -> None:
    """``ops.fedavg_aggregate`` on 5 ResNet56 trees, each tree's own
    ``src/`` in its own subprocess, in turns (in order, then reversed)."""
    order = list(trees)
    got = {label: [] for label in order}
    for label in order + order[::-1]:
        src = (ROOT / trees[label]).resolve().parents[2]
        proc = subprocess.run([sys.executable, "-c", AGGREGATE, str(src)],
                              capture_output=True, text=True, cwd=ROOT)
        if proc.returncode:
            raise RuntimeError(f"{label}: fedavg_aggregate failed\n"
                               f"{proc.stdout}{proc.stderr}")
        got[label].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for label, runs in got.items():
        print(f"ops.fedavg_aggregate, 5 x ResNet56 trees, {label} "
              f"({trees[label]}): host ms (median of 30, synchronised) "
              + " / ".join(f"{r['host_ms']:.3f}" for r in runs)
              + "; device µs per call (torch.profiler, summed over kernels) "
              + " / ".join(f"{r['device_us']:.3f}" for r in runs)
              + f" ({card})", flush=True)
        print(f"fl.aggregator.merge_global, 2 ResNet56 trees at lam 0.5, "
              f"{label}: host ms (median of 30, synchronised) "
              + " / ".join(f"{r['merge_ms']:.3f}" for r in runs)
              + f" ({card})", flush=True)
        print(f"  {label} kernels per call (µs): " + "; ".join(
            f"{k} {v:.3f}" for k, v in sorted(runs[0]["kernels"].items(),
                                             key=lambda kv: -kv[1])),
              flush=True)


def quantize_ab(built: dict, g, card: str) -> None:
    """The quantize pair at the main path's (3392, 256) f32: held, then
    timed in turns beside the yardsticks, L2 flushed by writes (the
    repo's yardstick) and by a read."""
    shape = (cs.MAIN_ROWS, cs.QSGD_BLOCK)
    x = torch.randn(shape, generator=g, device="cuda") * 1e-2
    q, s = qz.quantize_blocks_plain(x)
    off, qoff = cs.off_alignment(x), cs.off_alignment(q)
    for b in built.values():
        for xx, qq in ((x, q), (off, qoff)):  # fast and general paths
            cs.hold_quantize(xx, quantize_call(b["qz"], xx))
            cs.hold_dequantize(qq, s, torch.float32,
                               dequantize_call(b["qz"], qq, s))
    quant = {label: (lambda b=b: quantize_call(b["qz"], x))
             for label, b in built.items()}
    quant["x.to(torch.int8)"] = lambda: x.to(torch.int8)
    quant["empty launch"] = cs.empty_launch
    dequant = {label: (lambda b=b: dequantize_call(b["qz"], q, s))
               for label, b in built.items()}
    dequant["torch.mul(q, s)"] = lambda: torch.mul(q, s)
    dequant["q.to(torch.float32)"] = lambda: q.to(torch.float32)
    for timer, how in ((cs.time_cold, "L2 flushed by writes"),
                       (time_clean, "L2 emptied by a read")):
        show(f"quantize_blocks {shape} f32, bit-exact, {how}",
             in_turns(quant, timer), card)
        show(f"dequantize_blocks {shape} f32, rtol {cs.DEQ_RTOL}, {how}",
             in_turns(dequant, timer), card)
    for label, b in built.items():
        for what, fn in (("quantize_blocks",
                          lambda b=b: quantize_call(b["qz"], x)),
                         ("dequantize_blocks",
                          lambda b=b: dequantize_call(b["qz"], q, s))):
            parts = cs.device_breakdown(fn)
            print(f"  {label} {what} by kernel (warm, µs per call): "
                  + "; ".join(f"{cs.short_name(n)} {us:.3f} (x{c:g})"
                              for n, us, c in parts), flush=True)


if __name__ == "__main__":
    sys.exit(main())
