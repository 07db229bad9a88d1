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
   round on the CPU, and a full-width forward pass likewise.

The last lines are the ``kernels`` JSON record and the ``ok`` line. The
script imports neither JAX nor the JAX package; it exits non-zero,
printing no result, when no CUDA card is present.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import _tree  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core import TensorPayload  # noqa: E402
from repro_torch.kernels import fedavg_reduce as fr  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
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
FLUSH_BYTES = 256 * 2 ** 20  # > the 50 MB L2


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


@contextlib.contextmanager
def recording_fedavg(calls: list):
    """Keep the inputs and output of every ``fedavg_reduce`` call that
    ``ops.fedavg_aggregate`` makes, so the round's FedAvg can be held
    against the plain version after the round, outside its timed state."""
    kernel = fr.fedavg_reduce

    def record(x, w):
        out = kernel(x, w)
        calls.append((x, w, out))
        return out

    fr.fedavg_reduce = record
    try:
        yield
    finally:
        fr.fedavg_reduce = kernel


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
        calls = []
        with recording_fedavg(calls):
            rep = server.run_round(TensorPayload(params),
                                   dropped=dropped if r == 0 else None)
        params = server.global_params
        leaves = _tree.leaves(params)
        if torch.device(device).type == "cuda":
            if fr.LAUNCHES != before + 1 or len(calls) != 1:
                raise AssertionError(f"{backend} round {r}: FedAvg launched "
                                     f"the kernel {fr.LAUNCHES - before} "
                                     f"times, expected once")
            if not all(l.is_cuda for l in leaves):
                raise AssertionError(f"{backend}: global params left the card")
            x, w, got = calls[0]
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

    t0 = time.perf_counter()
    fr.build()
    log(f"built {', '.join(fr.SOURCES)} for sm_90a in "
        f"{time.perf_counter() - t0:.3f} s")

    rec = kernel_phase(card)
    launches, path_err = main_path(device)
    rec["max_abs_err"] = max(rec["max_abs_err"], path_err)
    fault_story(device)
    reference_check(device)

    kernels = [{"name": "fedavg_reduce", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/fedavg_reduce.cu",
                "replaces": "src/repro/kernels/fedavg_reduce.py:42",
                "launches": launches, **rec}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
