"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. the card: its name and power limit (``nvidia-smi``) and the TF32
   flags, both set off so convolutions and matmuls run in full f32 like
   the JAX reference;
2. build every kernel of the main path from ``src/repro_torch/kernels/
   csrc`` with ``nvcc`` for ``sm_90a``;
3. hold every kernel against its plain PyTorch version on the card at the
   main path's shapes, and time the kernel, the plain version and the
   one-call library yardstick (L2 flushed before every timed call);
   FedAvg's shape is (counted updates, parameters): at quorum 0.7 of 7
   silos the round closes on the first ceil(0.7 * 7) = 5 arrivals;
4. the main path: 2 sync FL rounds of full-width ResNet56 over 7 geo
   silos on ``grpc``, ``torch_rpc`` and ``grpc+s3``; FedAvg must go
   through the kernel once per round, at phase 3's shape, and each
   round's FedAvg is held against the plain version on the same inputs;
5. the fault story: ``mpi_generic`` aborts when clients drop, ``grpc+s3``
   meets its quorum;
6. the reference check: a reduced round on the card against the same
   round on the CPU, and a full-width forward pass likewise;
7. the event-driven path at full width (ResNet56), through ``fl_train``:
   ``examples/scenarios/geo_wan_qsgd.json`` as written (grpc+s3, fedbuff,
   qsgd:256, 14 geo silos, link loss 0.05), fedbuff + qsgd on grpc (the
   error-feedback residual), semisync + qsgd + the streaming hub (the
   accumulate kernel) and hier with qsgd on the relay WAN hop. Each run
   starts with every launch count at 0; the counts must match what the
   run's report implies, every kernel call is held against its plain
   version on the same inputs, and the global model stays on the card;
8. the event-driven reference check: a reduced semisync run at quorum 1.0
   on the card against the same run on the CPU, without a payload codec
   and with qsgd, the card once with cuDNN's deterministic algorithms and
   once with its default ones.

Phase 3 also holds ``quantize_blocks``, ``dequantize_blocks`` and
``fedavg_accumulate`` against their plain versions (ragged shapes, then
the main path's (3392, 256) and T = 868,123) and times them, and times
the host-side flat wrappers around them on one ResNet56 update.

Each phase's wall seconds are printed as it ends. The last lines are the
``kernels`` JSON record and the ``ok`` line. The script imports neither
JAX nor the JAX package; it exits non-zero, printing no result, when no
CUDA card is present.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import _tree  # noqa: E402
from repro_torch.compression.stages import QsgdCodec  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core import TensorPayload  # noqa: E402
from repro_torch.kernels import fedavg_reduce as fr  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize as qz  # noqa: E402
from repro_torch.launch import fl_train  # noqa: E402
from repro_torch.models.vision import ResNet, ResNetConfig  # noqa: E402

# Device-memory rate of the card the port targets (NVIDIA data sheet),
# for the bytes bound.
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
SILOS = 7  # geo_distributed hosts
QUORUM = 0.7
MAIN_N = math.ceil(QUORUM * SILOS)  # updates FedAvg averages per round
MAIN_T = 868_123  # ResNetConfig() parameters: the FedAvg vector length
BACKENDS = ("grpc", "torch_rpc", "grpc+s3")
ROUNDS = 2
LOCAL_STEPS = 3
RTOL, ATOL = 1e-4, 1e-5  # kernel vs plain: both sum f32 products
DEQ_RTOL = 1e-6  # dequantize vs plain: one rounded product each
ACC_ATOL = 1e-6  # accumulate vs plain: the reference's bar
ACC_W = 0.37  # a fold's effective weight (any non-trivial value)
QSGD_BLOCK = 256
# one ResNet56 update padded to whole (ROW_TILE, block) tiles: 3,392 rows
MAIN_ROWS = -(-MAIN_T // (QSGD_BLOCK * qz.ROW_TILE)) * qz.ROW_TILE
QUANT_OPS = 6  # per element: |x|, max, multiply, round, two clamps
FLUSH_BYTES = 256 * 2 ** 20  # > the 50 MB L2
KERNELS = ("fedavg_reduce", "fedavg_accumulate", "quantize_blocks",
           "dequantize_blocks")
_MODULE = {"fedavg_reduce": fr, "fedavg_accumulate": fr,
           "quantize_blocks": qz, "dequantize_blocks": qz}
_COUNTER = {"fedavg_reduce": "LAUNCHES",
            "fedavg_accumulate": "ACCUMULATE_LAUNCHES",
            "quantize_blocks": "QUANTIZE_LAUNCHES",
            "dequantize_blocks": "DEQUANTIZE_LAUNCHES"}


def log(msg: str) -> None:
    print(f"[chip] {msg}", flush=True)


def hbm_rate(name: str) -> float:
    if name not in HBM_BYTES_PER_S:
        raise RuntimeError(f"no memory rate on record for card '{name}'")
    return HBM_BYTES_PER_S[name]


def time_cold(fn, reps: int = 30) -> float:
    """Median device ms of ``fn()``, with L2 flushed before every call and
    the host given a head start so launch overhead is not timed."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(200_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def time_host(fn, reps: int = 20) -> float:
    """Median wall ms of ``fn()`` ending in a device synchronise."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def launches() -> dict:
    return {k: getattr(_MODULE[k], _COUNTER[k]) for k in KERNELS}


def zero_launches() -> None:
    for k in KERNELS:
        setattr(_MODULE[k], _COUNTER[k], 0)


def bound(nbytes: int, ops_: int, card: str):
    """-> (bound ms, "bytes" | "operations") on this card."""
    bytes_ms = nbytes / hbm_rate(card) * 1e3
    ops_ms = ops_ / F32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


# -- phase 3: kernel against its plain version --------------------------
def hold_against_plain(x, w, got) -> float:
    """Max abs error of the kernel's ``got`` against the plain version on
    the same inputs; raises past the tolerance."""
    want = fr.fedavg_reduce_plain(x, w)
    err = float((got - want).abs().max())
    if got.shape != want.shape or got.dtype != torch.float32 \
            or not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"fedavg_reduce disagrees with its plain "
                             f"version at {tuple(x.shape)} {x.dtype}: max "
                             f"abs err {err:.3e}")
    return err


def check_fedavg_reduce(n: int, t: int, dtype, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, t), generator=g, device="cuda").to(dtype)
    w = torch.rand((n,), generator=g, device="cuda") + 0.5
    w = w / w.sum()
    return x, w, hold_against_plain(x, w, fr.fedavg_reduce(x, w))


def kernel_phase(card: str) -> dict:
    for n, t in ((3, 3007), (1, 1), (5, 255), (16, 4096)):  # ragged tails
        for dtype in (torch.float32, torch.bfloat16):
            _, _, err = check_fedavg_reduce(n, t, dtype, seed=n * 7 + t)
            log(f"fedavg_reduce ({n}, {t}) {dtype}: max abs err {err:.3e}")
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, w, err = check_fedavg_reduce(MAIN_N, MAIN_T, dtype, seed=11)
        nbytes = x.numel() * x.element_size() + 4 * MAIN_N + 4 * MAIN_T
        bytes_ms = nbytes / hbm_rate(card) * 1e3
        ops_ms = 2 * MAIN_N * MAIN_T / F32_FLOPS * 1e3
        kernel_ms = time_cold(lambda: fr.fedavg_reduce(x, w))
        plain_ms = time_cold(lambda: fr.fedavg_reduce_plain(x, w))
        library_ms = (time_cold(lambda: torch.mv(x.t(), w))
                      if dtype == torch.float32 else None)
        log(f"fedavg_reduce ({MAIN_N}, {MAIN_T}) {dtype}: max abs err "
            f"{err:.3e} kernel_ms={kernel_ms:.6f} plain_ms={plain_ms:.6f} "
            f"library_ms={library_ms} bound_ms={max(bytes_ms, ops_ms):.6f} "
            f"({nbytes} bytes; {card})")
        rec[dtype] = {"max_abs_err": err, "ms": kernel_ms,
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": max(bytes_ms, ops_ms),
                      "bound_by": "bytes" if bytes_ms >= ops_ms
                      else "operations"}

    # the tree-level call the server makes: MAIN_N ResNet56 trees of 169
    # leaves
    model = ResNet(ResNetConfig(), device="cuda")
    trees = [model.init(torch.Generator().manual_seed(s))
             for s in range(MAIN_N)]
    agg_ms = time_host(lambda: ops.fedavg_aggregate(trees, [64.0] * MAIN_N))
    log(f"ops.fedavg_aggregate, {MAIN_N} x ResNet56 trees (169 leaves): "
        f"{agg_ms:.6f} ms host clock ({card})")
    return rec[torch.float32]


def hold_quantize(x, got) -> float:
    """int8 and scales bit-exact: the kernel and the plain version take
    the same IEEE operations on the same card. Returns the max abs error
    over the int8 values and the scales (0 when exact)."""
    q, s = got
    pq, ps = qz.quantize_blocks_plain(x)
    err = max(float((q.int() - pq.int()).abs().max()) if q.numel() else 0.0,
              float((s - ps).abs().max()) if s.numel() else 0.0)
    if not (torch.equal(q, pq) and torch.equal(s, ps)):
        raise AssertionError(f"quantize_blocks disagrees with its plain "
                             f"version at {tuple(x.shape)} {x.dtype}: max "
                             f"abs err {err:.3e}")
    return err


def hold_dequantize(q, s, out_dtype, got) -> float:
    want = qz.dequantize_blocks_plain(q, s, out_dtype)
    err = float((got.float() - want.float()).abs().max()) \
        if got.numel() else 0.0
    if got.dtype != out_dtype or not torch.allclose(
            got.float(), want.float(), rtol=DEQ_RTOL, atol=0.0):
        raise AssertionError(f"dequantize_blocks disagrees with its plain "
                             f"version at {tuple(q.shape)} -> {out_dtype}: "
                             f"max abs err {err:.3e}")
    return err


def hold_accumulate(acc, x, w, got) -> float:
    want = fr.fedavg_accumulate_plain(acc, x, w)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if err > ACC_ATOL:
        raise AssertionError(f"fedavg_accumulate disagrees with its plain "
                             f"version at T={acc.shape[0]}: max abs err "
                             f"{err:.3e}")
    return err


HOLD = {"fedavg_reduce": lambda args, out: hold_against_plain(*args, out),
        "quantize_blocks": lambda args, out: hold_quantize(*args, out),
        "dequantize_blocks": lambda args, out: hold_dequantize(
            args[0], args[1], args[2] if len(args) > 2 else torch.float32,
            out),
        "fedavg_accumulate": lambda args, out: hold_accumulate(*args, out)}


def new_kernels_phase(card: str) -> dict:
    """Phase 3 for the event-driven path's kernels: ragged and edge
    shapes, then the main path's shapes, held and timed."""
    g = torch.Generator(device="cuda").manual_seed(12)
    rec = {}
    qerr = derr = aerr = 0.0
    for rows, block in ((8, 256), (24, 128), (5, 100), (1, 1), (17, 256)):
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn((rows, block), generator=g, device="cuda")
                 * 3).to(dtype)
            x[rows // 2] = 0  # an all-zero row: scale 0, q 0
            q, s = qz.quantize_blocks(x)
            qerr = max(qerr, hold_quantize(x, (q, s)))
            for out_dtype in (torch.float32, torch.bfloat16):
                derr = max(derr, hold_dequantize(
                    q, s, out_dtype, qz.dequantize_blocks(q, s, out_dtype)))
    for t in (1, 255, 3001, 4097):  # T not a multiple of anything
        acc = torch.randn(t, generator=g, device="cuda")
        x = torch.randn(t, generator=g, device="cuda")
        aerr = max(aerr, hold_accumulate(acc, x, ACC_W, fr.fedavg_accumulate(
            acc, x, ACC_W)))
        flat = torch.randn(t, generator=g, device="cuda")
        for block in (256, 128):  # the flat wrapper's wire: as on the CPU
            got = ops.quantize_flat_batch([flat], block=block)[0]
            want = ops.quantize_flat_batch([flat.cpu()], block=block)[0]
            if got["q"].tobytes() != want["q"].tobytes() or \
                    got["scales"].tobytes() != want["scales"].tobytes():
                raise AssertionError(f"quantize_flat_batch on the card "
                                     f"differs from the CPU at T={t}")
    log(f"quantize/dequantize/accumulate, ragged shapes, f32 and bf16: max "
        f"abs err {qerr:.3e} / {derr:.3e} / {aerr:.3e}")

    # the main path's shapes: one ResNet56 update as (3392, 256) f32
    x = torch.randn((MAIN_ROWS, QSGD_BLOCK), generator=g, device="cuda") \
        * 1e-2
    q, s = qz.quantize_blocks(x)
    n = MAIN_ROWS * QSGD_BLOCK
    qbytes = 4 * n + n + 4 * MAIN_ROWS  # read x f32, write q and scales
    entries = {
        "quantize_blocks": (
            hold_quantize(x, (q, s)), qbytes, QUANT_OPS * n,
            lambda: qz.quantize_blocks(x),
            lambda: qz.quantize_blocks_plain(x), None),
        "dequantize_blocks": (
            hold_dequantize(q, s, torch.float32, qz.dequantize_blocks(q, s)),
            qbytes, n, lambda: qz.dequantize_blocks(q, s),
            lambda: qz.dequantize_blocks_plain(q, s),
            lambda: torch.mul(q, s)),
    }
    acc = torch.randn(MAIN_T, generator=g, device="cuda")
    upd = torch.randn(MAIN_T, generator=g, device="cuda")
    entries["fedavg_accumulate"] = (
        hold_accumulate(acc, upd, ACC_W,
                        fr.fedavg_accumulate(acc, upd, ACC_W)),
        12 * MAIN_T, 2 * MAIN_T,
        lambda: fr.fedavg_accumulate(acc, upd, ACC_W),
        lambda: fr.fedavg_accumulate_plain(acc, upd, ACC_W),
        lambda: torch.add(acc, upd, alpha=ACC_W))
    for name, (err, nbytes, ops_, kern, plain, lib) in entries.items():
        bound_ms, bound_by = bound(nbytes, ops_, card)
        kernel_ms = time_cold(kern)
        plain_ms = time_cold(plain)
        library_ms = time_cold(lib) if lib is not None else None
        log(f"{name} main shape: max abs err {err:.3e} "
            f"kernel_ms={kernel_ms:.6f} plain_ms={plain_ms:.6f} "
            f"library_ms={library_ms} bound_ms={bound_ms:.6f} "
            f"({nbytes} bytes, {bound_by}; {card})")
        rec[name] = {"max_abs_err": max(err, {"quantize_blocks": qerr,
                                              "dequantize_blocks": derr,
                                              "fedavg_accumulate": aerr}[name]),
                     "ms": kernel_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms}

    # the host-side wrappers around the kernels, on one ResNet56 update
    model = ResNet(ResNetConfig(), device="cuda")
    tree = model.init(torch.Generator().manual_seed(3))
    flat, _ = ops.flatten_pytree(tree)
    packed = ops.quantize_flat_batch([flat])
    codec = QsgdCodec(QSGD_BLOCK)
    (pp, _, info), = codec.encode_batch([TensorPayload(tree)], [None])
    host = {
        "ops.quantize_flat_batch (pad, kernel, device->host copy)":
            lambda: ops.quantize_flat_batch([flat]),
        "ops.dequantize_flat_batch (host->device copy, kernel)":
            lambda: ops.dequantize_flat_batch(packed, device="cuda"),
        "QsgdCodec.encode_batch (flatten 169 leaves + the above)":
            lambda: codec.encode_batch([TensorPayload(tree)], [None]),
        "QsgdCodec.decode_batch (the above + unflatten)":
            lambda: codec.decode_batch([pp], [info], device="cuda"),
    }
    for what, fn in host.items():
        log(f"{what}, one ResNet56 update: {time_host(fn):.6f} ms host "
            f"clock ({card})")
    return rec


@contextlib.contextmanager
def recording(calls: dict):
    """Keep the inputs and output of every call of the four kernel
    wrappers (``calls[name]``: a list of (args, out)), so each can be held
    against its plain version after the run, outside its timed state."""
    kept = {name: getattr(_MODULE[name], name) for name in KERNELS}

    def record(name, *args):
        out = kept[name](*args)
        calls.setdefault(name, []).append((args, out))
        return out

    for name in KERNELS:
        setattr(_MODULE[name], name, functools.partial(record, name))
    try:
        yield
    finally:
        for name, fn in kept.items():
            setattr(_MODULE[name], name, fn)


# -- phases 4-5: the main path and the fault story ----------------------
def run_rounds(backend: str, *, rounds: int, reduced: bool, device,
               dropped=None, quorum: float = QUORUM, fedavg=None):
    """``fedavg``, on the card: a list that gets, per round, the shape
    FedAvg ran at and the kernel's max abs error against the plain
    version on the same inputs."""
    cfg = FLConfig(backend=backend, environment="geo_distributed",
                   quorum_fraction=quorum)
    server, params, _, store = fl_train.build_deployment(
        cfg, reduced=reduced, local_steps=LOCAL_STEPS, device=device)
    reports = []
    for r in range(rounds):
        before = fr.LAUNCHES
        rec = {}
        with recording(rec):
            rep = server.run_round(TensorPayload(params),
                                   dropped=dropped if r == 0 else None)
        calls = rec.get("fedavg_reduce", [])
        params = server.global_params
        leaves = _tree.leaves(params)
        if torch.device(device).type == "cuda":
            if fr.LAUNCHES != before + 1 or len(calls) != 1:
                raise AssertionError(f"{backend} round {r}: FedAvg launched "
                                     f"the kernel {fr.LAUNCHES - before} "
                                     f"times, expected once")
            if not all(l.is_cuda for l in leaves):
                raise AssertionError(f"{backend}: global params left the card")
            (x, w), got = calls[0]
            err = hold_against_plain(x, w, got)
            if fedavg is not None:
                fedavg.append((tuple(x.shape), err))
        if rep.losses is None or not math.isfinite(rep.losses) or not all(
                bool(torch.isfinite(l).all()) for l in leaves):
            raise AssertionError(f"{backend} round {r}: non-finite loss "
                                 f"{rep.losses} or params")
        reports.append(rep)
    return reports, params, store


def main_path(device):
    """2 full-width rounds on each backend; returns the kernel launches and
    the largest error of a round's FedAvg against the plain version."""
    fedavg = []
    fr.LAUNCHES = 0
    for backend in BACKENDS:
        t0 = time.perf_counter()
        reps, _, _ = run_rounds(backend, rounds=ROUNDS, reduced=False,
                                device=device, fedavg=fedavg)
        r = reps[-1]
        log(f"{backend}: {ROUNDS} rounds in {time.perf_counter() - t0:.3f} s "
            f"wall; round={r.round_time:.4f}s sim, loss {reps[0].losses:.4f}"
            f" -> {r.losses:.4f}, server peak mem "
            f"{r.peak_server_memory / 2 ** 20:.1f}MB")
        log(f"   client states: " + " ".join(
            f"{k}={v:.4f}s" for k, v in r.clients.items()))
        log(f"   server states: " + " ".join(
            f"{k}={v:.4f}s" for k, v in r.server.items()))
    launches = fr.LAUNCHES
    if launches != ROUNDS * len(BACKENDS):
        raise AssertionError(f"main path launched fedavg_reduce {launches} "
                             f"times, expected {ROUNDS * len(BACKENDS)}")
    shapes = {shape for shape, _ in fedavg}
    if shapes != {(MAIN_N, MAIN_T)}:
        raise AssertionError(f"main path ran FedAvg at {shapes}, phase 3 "
                             f"checked and timed {(MAIN_N, MAIN_T)}")
    err = max(e for _, e in fedavg)
    log(f"main path FedAvg at {(MAIN_N, MAIN_T)}, every round against the "
        f"plain version: max abs err {err:.3e}")
    return launches, err


def fault_story(device) -> None:
    dropped = {"client0", "client1"}
    (mpi,), _, _ = run_rounds("mpi_generic", rounds=1, reduced=False,
                              device=device, dropped=dropped)
    (s3,), _, store = run_rounds("grpc+s3", rounds=1, reduced=False,
                                 device=device, dropped=dropped)
    log(f"fault story: mpi_generic aborted={mpi.aborted}; grpc+s3 "
        f"aborted={s3.aborted} participants={s3.n_participants}/{SILOS} "
        f"stats={dict(store.stats)}")
    alive = SILOS - len(dropped)
    if not mpi.aborted or s3.aborted or s3.n_participants != alive:
        raise AssertionError("fault story differs from the reference: "
                             "mpi_generic must abort and grpc+s3 must "
                             f"aggregate {alive} of {SILOS} clients")


# -- phase 6: the card against the CPU ------------------------------------
def max_rel_err(got_tree, want_tree) -> float:
    """Largest |got - want| over a leaf, relative to that leaf's max."""
    worst = 0.0
    for g, w in zip(_tree.leaves(got_tree), _tree.leaves(want_tree)):
        g, w = g.detach().cpu().float(), w.detach().cpu().float()
        scale = max(float(w.abs().max()), 1e-12)
        worst = max(worst, float((g - w).abs().max()) / scale)
    return worst


def reference_check(device) -> None:
    # Full quorum: with 0.7, which 5 of 7 updates are averaged depends on
    # the measured training seconds, and those differ between the card and
    # the CPU. Bar: the port's parity bar (rtol 1e-4), relative to each
    # leaf's largest entry: f32 on both sides, but cuDNN's convolution
    # algorithms sum in another order than the CPU's.
    bar = 1e-4
    (card_rep,), card_p, _ = run_rounds("torch_rpc", rounds=1, reduced=True,
                                        device=device, quorum=1.0)
    (cpu_rep,), cpu_p, _ = run_rounds("torch_rpc", rounds=1, reduced=True,
                                      device="cpu", quorum=1.0)
    err = max_rel_err(card_p, cpu_p)
    log(f"reduced round, card vs CPU: loss {card_rep.losses:.6f} vs "
        f"{cpu_rep.losses:.6f}, params max rel err {err:.3e} (bar {bar})")
    if err > bar or not math.isclose(card_rep.losses, cpu_rep.losses,
                                     rel_tol=bar):
        raise AssertionError("the round on the card disagrees with the CPU")

    model = ResNet(ResNetConfig(), device=device)
    p = model.init(torch.Generator().manual_seed(5))
    images = torch.randn((2, 32, 32, 3),
                         generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        got = model.forward(p, images.to(device))
        want = model.forward(_tree.map(lambda a: a.cpu(), p), images)
    err = max_rel_err(got, want)
    log(f"full-width forward, card vs CPU: logits max rel err {err:.3e} "
        f"(bar {bar})")
    if tuple(got.shape) != (2, 203) or err > bar:
        raise AssertionError("full-width forward disagrees with the CPU")


# -- phase 7: the event-driven path at full width -------------------------
EVENT_RUNS = (
    ("geo_wan_qsgd.json", ["--scenario", str(
        ROOT / "examples" / "scenarios" / "geo_wan_qsgd.json")]),
    ("fedbuff+qsgd grpc", ["--mode", "fedbuff", "--compression", "qsgd",
                           "--backend", "grpc", "--environment",
                           "geo_distributed", "--clients", "7", "--rounds",
                           "3"]),
    ("semisync+qsgd+hub grpc", ["--mode", "semisync", "--compression",
                                "qsgd", "--streaming-hub", "--backend",
                                "grpc", "--environment", "geo_distributed",
                                "--clients", "7", "--quorum", "0.7",
                                "--rounds", "3"]),
    ("hier+qsgd WAN grpc", ["--mode", "hier", "--compression", "qsgd",
                            "--backend", "grpc", "--environment",
                            "geo_distributed", "--clients", "14",
                            "--rounds", "2"]),
)


def event_run(argv, device, *, reduced: bool):
    """One event-driven run through the port's ``fl_train``: the CLI's
    scenario resolution, ``build_deployment`` and ``run_event_driven``.
    Returns (AsyncRunReport, FLScheduler)."""
    ap = fl_train._parser()
    sc = fl_train.resolve_scenario(ap.parse_args(argv), ap)
    fl_cfg = sc.fl_config()
    server, params, _, store = fl_train.build_deployment(
        fl_cfg, tier=sc.fleet.tier, reduced=reduced,
        local_steps=sc.fleet.local_steps, scenario=sc, device=device)
    return fl_train.run_event_driven(fl_cfg, server, params, store, sc)


def _rows(calls, name) -> int:
    """Rows of (rows, block) int8 a kernel went through, over its calls."""
    return sum((args[0] if name == "dequantize_blocks" else out[0]).shape[0]
               for args, out in calls.get(name, []))


def update_rows(sched) -> int:
    """(rows, block) rows that one update of this run's model quantises
    to: its parameters padded to whole (ROW_TILE, block) tiles."""
    t = sum(l.numel() for l in _tree.leaves(sched.global_params))
    return -(-t // (QSGD_BLOCK * qz.ROW_TILE)) * qz.ROW_TILE


def expect(name: str, what: str, got: int, want: int, at_least=False):
    ok = got >= want if at_least else got == want
    if not ok:
        raise AssertionError(f"{name}: {what} = {got}, expected "
                             f"{'>= ' if at_least else ''}{want}")


def event_path(device, errs: dict) -> dict:
    """Phase 7: each run with every launch count at 0 just before it and
    read just after. Returns the launches summed over the runs."""
    total = {k: 0 for k in KERNELS}
    for name, argv in EVENT_RUNS:
        calls = {}
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        with recording(calls):
            rep, sched = event_run(argv, device, reduced=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = launches()
        for k in KERNELS:
            total[k] += got[k]
            # every launch went through the recorded wrapper, on the card
            expect(name, f"{k} launches vs recorded calls", got[k],
                   len(calls.get(k, [])))
            for args, out in calls.get(k, []):
                if not all(a.is_cuda for a in args
                           if isinstance(a, torch.Tensor)):
                    raise AssertionError(f"{name}: {k} got a host tensor")
                errs[k] = max(errs[k], HOLD[k](args, out))
        # what the report implies (MAIN_ROWS rows per ResNet56 update)
        n_upd, n_agg = rep.n_client_updates, rep.n_aggregations
        q_upd = _rows(calls, "quantize_blocks") / MAIN_ROWS
        dq_upd = _rows(calls, "dequantize_blocks") / MAIN_ROWS
        expect(name, "rows of one update", update_rows(sched), MAIN_ROWS)
        strat = sched.strategy
        if strat.name == "hier":  # relay partials ride the WAN codec
            regions = len(strat.groups)
            expect(name, "fedavg_reduce launches", got["fedavg_reduce"],
                   n_agg * (1 + regions))
            expect(name, "updates quantised", q_upd, n_agg * regions)
            expect(name, "updates dequantised (EF + hub decode)", dq_upd,
                   2 * n_agg * regions, at_least=True)
            expect(name, "accumulate launches", got["fedavg_accumulate"], 0)
        else:
            ef = sched.backend.name != "grpc+s3"  # EF off on grpc+s3
            hub = sched.streaming_hub
            expect(name, "fedavg_reduce launches", got["fedavg_reduce"],
                   0 if hub else n_agg)
            expect(name, "accumulate launches", got["fedavg_accumulate"],
                   n_upd if hub else 0)
            expect(name, "updates quantised", q_upd, n_upd, at_least=True)
            expect(name, "updates dequantised", dq_upd,
                   (2 if ef else 1) * n_upd, at_least=True)
        leaves = _tree.leaves(sched.global_params)
        if not all(l.is_cuda and bool(torch.isfinite(l).all())
                   for l in leaves):
            raise AssertionError(f"{name}: global params left the card or "
                                 f"are not finite")
        log(f"{name}: sim_time={rep.sim_time:.4f}s aggregations={n_agg} "
            f"client_updates={n_upd} mean_staleness="
            f"{rep.mean_staleness:.4f} wall={wall:.3f}s; launches {got}; "
            f"updates quantised {q_upd:g}, dequantised {dq_upd:g}")
    if not all(total.values()):
        raise AssertionError(f"a kernel of the event-driven path never "
                             f"launched: {total}")
    return total


# -- phase 8: the event-driven path, card against CPU ----------------------
# Without a payload codec each leaf is held to LEAF_RTOL of its largest
# entry when cuDNN runs its deterministic algorithms. Its default ones sum
# some weight gradients in an order that changes from run to run; that
# moves the normalisation biases, whose entries are all ~1e-4 after two
# rounds, by far more than 1e-4 of their own size, so that run's bar has
# the floor LEAF_ATOL.
LEAF_RTOL, LEAF_ATOL = 1e-4, 2e-5


def leaf_errors(got_tree, want_tree):
    """Per leaf: (max |got - want|, want's largest entry)."""
    return [(float((g.detach().cpu() - w).abs().max()),
             float(w.abs().max()))
            for g, w in zip(_tree.leaves(got_tree), _tree.leaves(want_tree))]


@contextlib.contextmanager
def cudnn_deterministic(on: bool):
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = on
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def event_reference_check(device) -> None:
    """Quorum 1.0 and no deadline: every round merges every client, so the
    measured aggregation seconds cannot change which updates a merge
    takes. The card runs twice, with cuDNN's deterministic algorithms and
    with its default ones. Without a payload codec every leaf is held to
    LEAF_RTOL * its largest entry in the deterministic run, and to
    max(LEAF_RTOL * its largest entry, LEAF_ATOL) in the default one. With
    qsgd the bar is the reference's own band,
    8 * max|param| / 127 (tests/test_scheduler.py:277): a 1e-7 difference
    in training can move a value across a rounding boundary, so one int8
    level may flip."""
    base = ["--mode", "semisync", "--quorum", "1.0", "--backend",
            "torch_rpc", "--environment", "geo_distributed", "--clients",
            "3", "--rounds", "2", "--local-steps", "2"]
    for codec in ("none", "qsgd"):
        argv = base + ["--compression", codec]
        cpu, cpu_sched = event_run(argv, "cpu", reduced=True)
        want = cpu_sched.global_params
        top = max(float(w.abs().max()) for w in _tree.leaves(want))
        for det in (True, False):
            with cudnn_deterministic(det):
                card, card_sched = event_run(argv, device, reduced=True)
            if (card.n_aggregations, card.n_client_updates) != \
                    (cpu.n_aggregations, cpu.n_client_updates):
                raise AssertionError(f"semisync {codec}: the card merged "
                                     f"other updates than the CPU")
            errs = leaf_errors(card_sched.global_params, want)
            err = max(e for e, _ in errs)
            rel = max(e / max(m, 1e-12) for e, m in errs)
            floor = 0.0 if det else LEAF_ATOL
            to_bar = [e / max(LEAF_RTOL * m, floor, 1e-30) for e, m in errs]
            i = max(range(len(errs)), key=to_bar.__getitem__)
            log(f"semisync quorum 1.0 compression={codec} cudnn."
                f"deterministic={det}, card vs CPU: params max abs err "
                f"{err:.3e} (max|param| {top:.4f}); per leaf, relative to "
                f"its largest entry: {rel:.3e}; leaf {i} of {len(errs)} "
                f"nearest the leaf bar: err {errs[i][0]:.3e}, largest entry "
                f"{errs[i][1]:.3e}; losses {card.final_loss:.6f} vs "
                f"{cpu.final_loss:.6f}")
            if codec == "none":
                bad = [j for j, r in enumerate(to_bar) if r > 1.0]
                if bad:
                    raise AssertionError(
                        f"semisync none, cudnn.deterministic={det}: leaves "
                        f"{bad} disagree with the CPU beyond max("
                        f"{LEAF_RTOL} * largest entry, {floor})")
            elif err > 8.0 / 127.0 * top:
                raise AssertionError(f"semisync qsgd: the card disagrees "
                                     f"with the CPU beyond 8 * max|param| "
                                     f"/ 127 = {8.0 / 127.0 * top:.3e}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    smi = smi.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; card {card}")
    log(f"tf32: cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")
    print(smi, flush=True)

    phase_t = [time.perf_counter()]

    def phase_done(what: str) -> None:
        phase_t.append(time.perf_counter())
        log(f"phase {what}: {phase_t[-1] - phase_t[-2]:.3f} s wall")

    # one nvcc per source, all started together
    with ThreadPoolExecutor(max_workers=2) as pool:
        for f in [pool.submit(fr.build), pool.submit(qz.build)]:
            f.result()
    log(f"built {', '.join(fr.SOURCES + qz.SOURCES)} for sm_90a")
    phase_done("2 (build)")

    rec = {"fedavg_reduce": kernel_phase(card), **new_kernels_phase(card)}
    phase_done("3 (kernels against plain)")
    sync_launches, path_err = main_path(device)
    rec["fedavg_reduce"]["max_abs_err"] = max(
        rec["fedavg_reduce"]["max_abs_err"], path_err)
    phase_done("4 (sync main path)")
    fault_story(device)
    phase_done("5 (fault story)")
    reference_check(device)
    phase_done("6 (sync, card against CPU)")
    errs = {k: rec[k]["max_abs_err"] for k in KERNELS}
    event_launches = event_path(device, errs)
    phase_done("7 (event-driven main path)")
    event_reference_check(device)
    phase_done("8 (event-driven, card against CPU)")

    # launches: over the main paths each kernel is on, each path run with
    # the counts at 0 (fedavg_reduce: the sync rounds and the event runs)
    path_launches = dict(event_launches)
    path_launches["fedavg_reduce"] += sync_launches
    sources = {"fedavg_reduce": ("fedavg_reduce.cu", "fedavg_reduce.py:42"),
               "fedavg_accumulate": ("fedavg_reduce.cu",
                                     "fedavg_reduce.py:69"),
               "quantize_blocks": ("quantize.cu", "quantize.py:45"),
               "dequantize_blocks": ("quantize.cu", "quantize.py:63")}
    kernels = []
    for k in KERNELS:
        src, ref = sources[k]
        kernels.append({
            "name": k, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{ref}",
            "launches": path_launches[k],
            **rec[k], "max_abs_err": errs[k]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
