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
   one-call library yardstick, cold (L2 flushed before every timed call)
   and, where the call can be captured, replayed from a CUDA graph (warm),
   beside an empty launch under both; FedAvg runs in its tree form, which
   reads the clients' leaves in place, on (counted updates) full-width
   trees: at quorum 0.7 of 7 silos the round closes on the first
   ceil(0.7 * 7) = 5 arrivals; ResNet56 (169 leaves), MobileNetV3 (151),
   DistilBERT (100) and ViT-Large (13 stacked leaves, 1.21 GB a tree),
   beside the (N, T) form and ``torch.mv`` on the stacked matrix;
4. the main path: 2 sync FL rounds of full-width ResNet56 over 7 geo
   silos on ``grpc``, ``torch_rpc`` and ``grpc+s3``; FedAvg must go
   through the kernel's tree form once per round, at phase 3's shape,
   and each round's FedAvg is held bit for bit against the plain version
   on the same inputs;
5. the fault story: ``mpi_generic`` aborts when clients drop, ``grpc+s3``
   meets its quorum;
6. the reference check: a reduced round on the card, with cuDNN's
   deterministic algorithms, against the same round on the CPU at 1e-4 of
   each leaf's largest entry; the same round with cuDNN's default
   algorithms at max(1e-4 of the leaf's largest entry, LEAF_ATOL), as
   phase 8 holds its default run; and a full-width forward pass;
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
   once with its default ones;
9. ``fl.aggregator.fedavg_quantized`` on 5 qsgd-packed full-width ResNet56
   updates (host wire buffers), through the ``fedavg_reduce_q8`` kernel,
   held against FedAvg of the dequantised trees and against the plain
   version on the same inputs, and timed;
10. the Medium tier's MobileNetV3 at full width: one loss and gradient on
   the card (f32) and on the CPU (f32), each held against the CPU (f64),
   from the same parameters and batch;
11. the Large tier's live path: one sync round of full-width ViT-Large
   (303,236,096 parameters) over 7 geo silos on ``grpc+s3`` (3 local
   steps, quorum 0.7), its FedAvg one tree-form launch held bit for bit
   against the plain version, then fedbuff with ``qsgd:256`` on
   ``grpc+s3`` (K = 3, the tier's knob; 2 aggregations), every quantize
   and dequantize call held against its plain version as it returns and
   every launch count against the run's report; per-step training ms, the
   codec's and the wire's host ms per update, FedAvg ms, peak device and
   host memory and wall seconds are printed;
12. the Large and Big tiers' models at full width: a ViT-Large forward
   pass on the card against the CPU (f32), and DistilBERT's loss and
   gradients at batch 2, sequence 512 (``flash_attention``'s 2 x 2
   blocks), the card's f32 and the CPU's f32 runs each against the CPU's
   f64 run;
13. vertical (split) FL at full width, through ``fl_train``'s
   ``build_deployment``, ``_vertical_strategy`` and ``run_event_driven``:
   (a) ResNet56 cut after unit 2 under ``examples/scenarios/
   vertical_geo.json``'s channel, faults and split (auto, zlib, 8 MB
   chunks, link loss 0.01, 8 batches a round, ``qsgd:256`` on the
   activations and their gradients; 4 geo parties, 2 rounds), and (b)
   MobileNetV3 cut after unit 2 on grpc with ``topk:0.05`` (3 parties, 1
   round). Each run starts with every launch count at 0; every quantize,
   dequantize and ``topk_rows`` call is held against its plain version as
   it returns, at least one encode and one decode launch is asserted per
   activation and per gradient that completed, the error-feedback
   streams must be one per direction, and every bottom and the top stay
   on the card; per-batch ms of bottom forward, top step and bottom
   backward, the codec's host ms per message, the message shapes and wire
   bytes, AUTO's routes, the simulated round, wall seconds and peak device
   memory are printed. Then the kernels at the messages' shapes ((256,
   256) quantize pair, (1, 6,144) ``topk_rows`` with k = 307), timed cold
   and replayed from a CUDA graph beside an empty launch; split == unsplit
   at full width on the card (ResNet56 and MobileNetV3, cut 2); and a
   reduced vertical run on the card against the CPU.

The three FedAvg kernels flush subnormals as XLA does on the CPU and sum
the clients in order, so each is held bit for bit against its plain
version, on rows across 1e-46-1e-33 too. Phase 3 also holds
``quantize_blocks``, ``dequantize_blocks`` and
``fedavg_accumulate`` against their plain versions (ragged shapes; blocks
on and off the quantize pair's fast path; rows for each of the quantize
pair's subnormal rules, half-way ties and subnormal scales; views off
16-byte alignment; then the main path's (3392, 256) and T = 868,123, the
quantize pair also off 16-byte alignment) and times them beside the
floors of this harness (an empty kernel launch; the casts that move the
quantize pair's bytes), and times the host-side flat wrappers around
them on one ResNet56 update; then ``topk_rows`` (edge
shapes with ties and signed zeros, k over many sort tiles, k = T,
all-equal rows of 1,000,000, then one MobileNetV3 and one ResNet56
update at ``topk:0.05``, each broken down by kernel) and
``fedavg_reduce_q8`` (edge shapes on both of its paths, then 5 ResNet56
updates), and the top-k
codec's host work on one MobileNetV3 update. Phase 7 also runs the repo's
``examples/scenarios/hospitals_geo3.json`` as written (semisync, grpc+s3,
``topk:0.05`` + ``zlib:3``, 3 geo silos, the Medium tier's MobileNetV3 at
full width, 20 aggregations) and fedbuff + top-k on grpc (7 silos,
ResNet56), with every ``topk_rows`` call held against its plain version.
Phase 3 holds and times the quantize pair on one Large update too,
(1,184,520, 256) f32, and on one Big update, (259,232, 256).

Each phase's wall seconds are printed as it ends. The last lines are the
``kernels`` JSON record and the ``ok`` line. The script imports neither
JAX nor the JAX package; it exits non-zero, printing no result, when no
CUDA card is present.
"""
from __future__ import annotations

import contextlib
import functools
import json
import gc
import math
import resource
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
from repro_torch.compression.stages import QsgdCodec, TopkCodec  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.configs.paper_tiers import TIERS  # noqa: E402
from repro_torch.core import TensorPayload  # noqa: E402
from repro_torch.core.channel import make_channel  # noqa: E402
from repro_torch.data import make_silo_datasets  # noqa: E402
from repro_torch.fl import vertical as tv  # noqa: E402
from repro_torch.fl.aggregator import fedavg, fedavg_quantized  # noqa: E402
from repro_torch.kernels import fedavg_reduce as fr  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize as qz  # noqa: E402
from repro_torch.kernels import topk as tk  # noqa: E402
from repro_torch.launch import fl_train  # noqa: E402
from repro_torch.models.bert import BertConfig, DistilBert  # noqa: E402
from repro_torch.models.vision import (MobileNetConfig, MobileNetV3,  # noqa: E402
                                       ResNet, ResNetConfig, ViT, ViTConfig)

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
RTOL, ATOL = 1e-4, 1e-5  # fedavg_quantized vs FedAvg of dequantised trees
DEQ_RTOL = 1e-6  # dequantize vs plain: one rounded product each
ACC_W = 0.37  # a fold's effective weight (any non-trivial value)
QSGD_BLOCK = 256
# one ResNet56 update padded to whole (ROW_TILE, block) tiles: 3,392 rows
MAIN_ROWS = -(-MAIN_T // (QSGD_BLOCK * qz.ROW_TILE)) * qz.ROW_TILE
QUANT_OPS = 6  # per element: |x|, max, multiply, round, two clamps
FLUSH_BYTES = 256 * 2 ** 20  # > the 50 MB L2
TOPK_FRAC = 0.05  # hospitals_geo3.json's topk:0.05, and the codec default
MEDIUM_T = 4_375_723  # MobileNetConfig() parameters: one Medium update
MAIN_LEAVES = 169  # ResNetConfig()'s leaves: the tree form's L
MEDIUM_LEAVES = 151  # MobileNetConfig()'s leaves
Q8_N = 5  # fedavg_quantized: the main path's FedAvg count of updates
LARGE_T = 303_236_096  # ViTConfig() parameters: one Large update, 1.21 GB
LARGE_LEAVES = 13  # its leaves: the 24 layers stacked on a leading axis
BIG_T = 66_362_880  # BertConfig() parameters, the 20-class head apart
BIG_LEAVES = 100
# one Large update on the qsgd wire: padded to whole (ROW_TILE, block) tiles
LARGE_ROWS = -(-LARGE_T // (QSGD_BLOCK * qz.ROW_TILE)) * qz.ROW_TILE
BIG_ROWS = -(-BIG_T // (QSGD_BLOCK * qz.ROW_TILE)) * qz.ROW_TILE
Q8_T = MAIN_ROWS * QSGD_BLOCK  # one ResNet56 update on the qsgd wire
KERNELS = ("fedavg_reduce", "fedavg_accumulate", "quantize_blocks",
           "dequantize_blocks", "fedavg_reduce_q8", "topk_rows")
_MODULE = {"fedavg_reduce": fr, "fedavg_accumulate": fr,
           "quantize_blocks": qz, "dequantize_blocks": qz,
           "fedavg_reduce_q8": fr, "topk_rows": tk}
# the wrappers that launch each kernel (fedavg_reduce: the (N, T) form and
# the tree form)
_WRAPPERS = {"fedavg_reduce": ("fedavg_reduce", "fedavg_reduce_leaves")}
_COUNTER = {"fedavg_reduce": "LAUNCHES",
            "fedavg_accumulate": "ACCUMULATE_LAUNCHES",
            "quantize_blocks": "QUANTIZE_LAUNCHES",
            "dequantize_blocks": "DEQUANTIZE_LAUNCHES",
            "fedavg_reduce_q8": "Q8_LAUNCHES", "topk_rows": "LAUNCHES"}


def topk_k(t: int) -> int:
    """The codec's k for a row of t entries (as ``ops.topk_flat_batch``)."""
    return max(1, int(t * TOPK_FRAC))


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


def time_graph(fn, reps: int = 20, replays: int = 10) -> float:
    """Median device ms per call of ``fn()`` replayed from one CUDA graph
    that holds ``reps`` calls: the warm yardstick beside ``time_cold``, with
    no launch gaps and no flush (inputs that fit stay in L2). ``fn`` must
    be capturable: no host copies, no synchronise."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    out = []
    for _ in range(replays):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        graph.replay()
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e) / reps)
    return statistics.median(out)


def synchronize() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_host(fn, reps: int = 20) -> float:
    """Median wall ms of ``fn()`` ending in a device synchronise."""
    fn()
    synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def device_breakdown(fn, reps: int = 5):
    """[(kernel name, device µs per call, launches per call)] of ``fn()``
    from ``torch.profiler`` (warm, L2 not flushed), largest first; empty
    when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us > 0:
            rows.append((e.key, us / reps, e.count / reps))
    return sorted(rows, key=lambda r: -r[1])


def short_name(kernel: str) -> str:
    """'void (anonymous namespace)::hist_kernel<float>(...)' -> 'hist_kernel<float>'."""
    name = kernel.replace("(anonymous namespace)::", "")
    name = name.split("(")[0]
    return name[5:] if name.startswith("void ") else name


def bits_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bit for bit (int32 views: torch.equal calls -0.0 equal to
    +0.0)."""
    return got.shape == want.shape and got.dtype == want.dtype \
        and torch.equal(got.view(torch.int32), want.view(torch.int32))


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
    """The (N, T) form: bit-exact against the plain version on the same
    inputs (same operations, same client order, same flushes); returns
    the max abs error (0 when exact), raises otherwise."""
    want = fr.fedavg_reduce_plain(x, w)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not bits_equal(got, want):
        raise AssertionError(f"fedavg_reduce disagrees with its plain "
                             f"version at {tuple(x.shape)} {x.dtype}: max "
                             f"abs err {err:.3e}")
    return err


def hold_leaves(leaves, w, got) -> float:
    """The tree form: every output leaf bit-exact against the plain
    version on the same leaves and weights."""
    want = fr.fedavg_reduce_leaves_plain(leaves, w)
    err = max(float((a - b).abs().max()) if a.numel() else 0.0
              for a, b in zip(got, want))
    if len(got) != len(want) or not all(bits_equal(a, b)
                                        for a, b in zip(got, want)):
        raise AssertionError(f"fedavg_reduce's tree form disagrees with its "
                             f"plain version on {len(leaves)} trees of "
                             f"{len(leaves[0])} leaves: max abs err "
                             f"{err:.3e}")
    return err


def hold_reduce(args, out) -> float:
    """Either form of ``fedavg_reduce``, by its arguments."""
    if isinstance(args[0], torch.Tensor):
        return hold_against_plain(*args, out)
    return hold_leaves(*args, out)


def reduce_shape(args) -> tuple:
    """(N, T) of an (N, T) call; (N, T, L) of a tree-form call."""
    if isinstance(args[0], torch.Tensor):
        return tuple(args[0].shape)
    leaves = args[0]
    return (len(leaves), sum(l.numel() for l in leaves[0]), len(leaves[0]))


def vector_tiles(leaves) -> tuple:
    """(tiles that take the kernel's 16-byte loads, all tiles) of a
    tree-form call on N clients' ``leaves``: a tile does when the N
    pointers to it are all aligned to 4 elements (every output slot is).
    Tiles start at multiples of fr.TILE, so a tile is aligned as its leaf."""
    vec = tiles = 0
    for col in zip(*leaves):
        k = -(-col[0].numel() // fr.TILE)
        tiles += k
        if all(l.data_ptr() % (4 * l.element_size()) == 0 for l in col):
            vec += k
    return vec, tiles


def check_fedavg_reduce(n: int, t: int, dtype, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, t), generator=g, device="cuda").to(dtype)
    w = torch.rand((n,), generator=g, device="cuda") + 0.5
    w = w / w.sum()
    return x, w, hold_against_plain(x, w, fr.fedavg_reduce(x, w))


def tiny_values(n: int, g) -> torch.Tensor:
    """(n,) f32 on the card: both signs, magnitudes spanning 1e-46-1e-33,
    every 97th value normal."""
    x = 10.0 ** (torch.rand(n, generator=g, device="cuda") * 13 - 46) \
        * torch.randn(n, generator=g, device="cuda").sign()
    x[::97] = torch.randn(x[::97].shape, generator=g, device="cuda")
    return x


def window_values(n: int, w: float, g) -> torch.Tensor:
    """(n,) f32 on the card whose products with the f32 ``w`` lie within
    2**-21 of FLT_MIN: some in the window just below it that IEEE rounds
    up to FLT_MIN and XLA's flush, like the kernels' mul.rn.ftz.f32,
    makes 0."""
    target = qz.FLT_MIN * (1 + (torch.rand(n, generator=g, device="cuda",
                                           dtype=torch.float64) * 2 - 1)
                           * 2.0 ** -21)
    sign = torch.randint(0, 2, (n,), generator=g, device="cuda") * 2 - 1
    return (target / float(w) * sign).float()


def client_leaves(template, n: int, g, *, views: bool, kind="randn",
                  dtype=torch.float32, w=None):
    """n clients' leaves shaped like ``template``: separate tensors (as the
    wire decodes raw payloads) or views of one flat vector at the leaves'
    running offsets (as the codecs decode); ``kind`` "randn" (normal),
    "tiny" (across the subnormal range) or "window" (client i's products
    with w[i] just around FLT_MIN)."""
    sizes = [l.numel() for l in template]
    out = []
    for i in range(n):
        if kind == "window":
            flat = window_values(sum(sizes), w[i], g)
        elif kind == "tiny":
            flat = tiny_values(sum(sizes), g)
        else:
            flat = torch.randn(sum(sizes), generator=g, device="cuda")
        parts = flat.to(dtype).split(sizes)
        out.append([(p if views else p.clone()).view(l.shape)
                    for p, l in zip(parts, template)])
    return out


# the tree form's cases held on the small tiers: (views, kind, dtype); the
# Large and Big tiers take the first two, the main paths' f32 leaves as
# the wire decodes them and as the codecs do
TREE_CASES = ((False, "randn", torch.float32), (True, "randn", torch.float32),
              (False, "tiny", torch.float32), (True, "tiny", torch.float32),
              (False, "window", torch.float32),
              (True, "window", torch.float32),
              (False, "randn", torch.bfloat16), (True, "tiny", torch.bfloat16))


def tree_form_phase(card: str, g) -> dict:
    """The tree form on MAIN_N full-width trees of each tier: held bit for
    bit (separate leaves, views off 16-byte alignment; on the two small
    tiers also bf16, the subnormal range and N 1 and 25), timed cold and
    from a CUDA graph beside the (N, T) form and ``torch.mv``;
    ``ops.fedavg_aggregate``'s host ms. The Big and Large tiers' templates
    are built on the ``meta`` device: only their shapes are needed.
    Returns the record of the ResNet56 call, the main path's."""
    tiers = {"ResNet56": (ResNet(ResNetConfig(), device="meta"), MAIN_T,
                          MAIN_LEAVES),
             "MobileNetV3": (MobileNetV3(MobileNetConfig(), device="meta"),
                             MEDIUM_T, MEDIUM_LEAVES),
             "DistilBERT": (DistilBert(BertConfig(), device="meta"), BIG_T,
                            BIG_LEAVES),
             "ViT-Large": (ViT(ViTConfig(), device="meta"), LARGE_T,
                           LARGE_LEAVES)}
    w = torch.rand((MAIN_N,), generator=g, device="cuda") + 0.5
    w = (w / w.sum()).cpu().numpy()
    rec = None
    for tier, (model, t, n_leaves) in tiers.items():
        small = t < BIG_T
        template, treedef = _tree.flatten(
            model.init(torch.Generator().manual_seed(1)))
        expect(tier, "parameters", sum(l.numel() for l in template), t)
        expect(tier, "leaves", len(template), n_leaves)
        err = 0.0
        for views, kind, dtype in TREE_CASES if small else TREE_CASES[:2]:
            leaves = client_leaves(template, MAIN_N, g, views=views,
                                   kind=kind, dtype=dtype, w=w)
            err = max(err, hold_leaves(leaves, w, fr.fedavg_reduce_leaves(
                leaves, w)))
        for n in (1, 25) if small else ():
            leaves = client_leaves(template, n, g, views=True)
            wn = torch.full((n,), 1.0 / n).numpy()
            err = max(err, hold_leaves(leaves, wn, fr.fedavg_reduce_leaves(
                leaves, wn)))
        del leaves
        log(f"fedavg_reduce tree form, {tier} ({n_leaves} leaves), N "
            + (f"1/{MAIN_N}/25, separate leaves and views off 16-byte "
               f"alignment, f32 and bf16, random, across 1e-46-1e-33 and "
               f"products just around FLT_MIN" if small else
               f"{MAIN_N}, separate leaves and views off 16-byte alignment,"
               f" f32, random") + ": bit-exact")
        leaves = client_leaves(template, MAIN_N, g, views=False)
        call = fr.leaf_call(leaves, w)
        out = torch.empty(call.plan.numel, device="cuda")
        vleaves = client_leaves(template, MAIN_N, g, views=True)
        vcall = fr.leaf_call(vleaves, w)
        vec, tiles = vector_tiles(vleaves)
        stacked = torch.stack([torch.cat([l.reshape(-1) for l in c])
                               for c in leaves])
        wd = torch.from_numpy(w).cuda()
        mv_out = torch.empty(t, device="cuda")
        nbytes = 4 * MAIN_N * t + 4 * MAIN_N + 4 * t
        bound_ms, bound_by = bound(nbytes, 2 * MAIN_N * t, card)
        timed = {
            "tree kernel (prepared tables)":
                lambda: fr.launch_leaves(call, out),
            f"tree kernel on views of one flat vector (prepared tables; "
            f"{vec} of {tiles} tiles aligned)":
                lambda: fr.launch_leaves(vcall, out),
            "tree wrapper (tables copied, kernel)":
                lambda: fr.fedavg_reduce_leaves(leaves, w),
            "(N, T) form on the stacked matrix":
                lambda: fr.fedavg_reduce(stacked, wd),
            "plain version": lambda: fr.fedavg_reduce_leaves_plain(leaves, w),
            "torch.mv(stacked.t(), w)":
                lambda: torch.mv(stacked.t(), wd, out=mv_out)}
        # every call in a graph keeps its own output: the (N, T) form's
        # 20 outputs of a large tree would not fit
        graph_ok = ("tree kernel (prepared tables)", list(timed)[1],
                    "torch.mv(stacked.t(), w)") + (
                        ("(N, T) form on the stacked matrix",) if small
                        else ())
        ms = {}
        for what, fn in timed.items():
            ms[what] = time_cold(fn, reps=30 if small else 10)
            warm = (f"; graph-replayed {time_graph(fn):.6f} ms"
                    if what in graph_ok else "")
            log(f"fedavg_reduce {tier} ({MAIN_N}, {t}), {n_leaves} leaves, "
                f"{what}: cold {ms[what]:.6f} ms{warm} (bound "
                f"{bound_ms:.6f} ms, {nbytes} bytes, {bound_by}; {card})")
        trees = [_tree.unflatten(treedef, c) for c in leaves]
        agg_ms = time_host(lambda: ops.fedavg_aggregate(trees,
                                                        [64.0] * MAIN_N),
                           reps=20 if small else 5)
        log(f"ops.fedavg_aggregate, {MAIN_N} x {tier} trees ({n_leaves} "
            f"leaves): {agg_ms:.6f} ms host clock, synchronised ({card})")
        if tier == "ResNet56":
            rec = {"max_abs_err": err,
                   "ms": ms["tree kernel (prepared tables)"],
                   "plain_ms": ms["plain version"],
                   "library_ms": ms["torch.mv(stacked.t(), w)"],
                   "bound_ms": bound_ms, "bound_by": bound_by}
        else:
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
        del leaves, vleaves, stacked, trees, call, vcall, out, mv_out
        release()
    return rec


def release() -> None:
    """Return the memory of a large tier's tensors to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def kernel_phase(card: str) -> dict:
    for n, t in ((3, 3007), (1, 1), (5, 255), (16, 4096)):  # ragged tails
        for dtype in (torch.float32, torch.bfloat16):
            _, _, err = check_fedavg_reduce(n, t, dtype, seed=n * 7 + t)
            log(f"fedavg_reduce ({n}, {t}) {dtype}: bit-exact")
    log(f"floor: an empty kernel launch: cold {time_cold(empty_launch):.6f} "
        f"ms, graph-replayed {time_graph(empty_launch):.6f} ms ({card})")
    for dtype in (torch.float32, torch.bfloat16):
        x, w, err = check_fedavg_reduce(MAIN_N, MAIN_T, dtype, seed=11)
        nbytes = x.numel() * x.element_size() + 4 * MAIN_N + 4 * MAIN_T
        bound_ms, _ = bound(nbytes, 2 * MAIN_N * MAIN_T, card)
        log(f"fedavg_reduce (N, T) form ({MAIN_N}, {MAIN_T}) {dtype} (rows "
            f"after the first off 16-byte alignment: single-element loads): "
            f"bit-exact; cold {time_cold(lambda: fr.fedavg_reduce(x, w)):.6f}"
            f" ms, graph-replayed "
            f"{time_graph(lambda: fr.fedavg_reduce(x, w)):.6f} ms, plain "
            f"{time_cold(lambda: fr.fedavg_reduce_plain(x, w)):.6f} ms "
            f"(bound {bound_ms:.6f} ms, {nbytes} bytes; {card})")
    g = torch.Generator(device="cuda").manual_seed(10)
    return tree_form_phase(card, g)


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
    """Bit-exact (as int32 views): the kernel and the plain version round
    the same product and the same sum on the same card."""
    want = fr.fedavg_accumulate_plain(acc, x, w)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if got.shape != want.shape or not torch.equal(
            got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"fedavg_accumulate disagrees with its plain "
                             f"version at T={acc.shape[0]}: max abs err "
                             f"{err:.3e}")
    return err


def hold_topk(x, k, got) -> float:
    """idx equal and vals equal bit for bit (as int32 views: torch.equal
    calls -0.0 equal to +0.0). Returns the max abs error of vals (0 when
    exact)."""
    idx, vals = got
    pi, pv = tk.topk_rows_plain(x, k)
    err = float((vals - pv).abs().max()) if vals.numel() else 0.0
    if not (idx.dtype == torch.int32 and torch.equal(idx, pi)
            and torch.equal(vals.view(torch.int32), pv.view(torch.int32))):
        raise AssertionError(f"topk_rows disagrees with its plain version "
                             f"at {tuple(x.shape)} {x.dtype}, k = {k}: "
                             f"max abs err {err:.3e}")
    return err


def hold_q8(q, s, w, block, got) -> float:
    """Bit-exact, on either of the kernel's paths: the same operations in
    the same client order, with the same flushes."""
    want = fr.fedavg_reduce_q8_plain(q, s, w, block)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not bits_equal(got, want):
        raise AssertionError(f"fedavg_reduce_q8 disagrees with its plain "
                             f"version at {tuple(q.shape)} block {block}: "
                             f"max abs err {err:.3e}")
    return err


HOLD = {"fedavg_reduce": hold_reduce,
        "topk_rows": lambda args, out: hold_topk(*args, out),
        "fedavg_reduce_q8": lambda args, out: hold_q8(*args, out),
        "quantize_blocks": lambda args, out: hold_quantize(*args, out),
        "dequantize_blocks": lambda args, out: hold_dequantize(
            args[0], args[1], args[2] if len(args) > 2 else torch.float32,
            out),
        "fedavg_accumulate": lambda args, out: hold_accumulate(*args, out)}


def empty_launch() -> None:
    """One launch of an empty kernel: the floor every timed call pays."""
    rc = qz.build().quantize_empty_launch(
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"empty kernel launch failed ({rc})")


def off_alignment(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` one element into a buffer: off 16-byte
    alignment, so the quantize kernels take their general path."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:] = x.reshape(-1)
    return buf[1:].reshape(x.shape)


def quantize_edge_rows(block: int, g) -> torch.Tensor:
    """(9, block) f32 on the card: a row per subnormal rule of
    ``kernels/quantize.py`` (scale flushed to 0; subnormal entries under a
    normal scale; scale exactly FLT_MIN; scale below 2**-128, where
    1 / scale would overflow; subnormals only; a normal row with subnormal
    entries; signed zeros), then x * inv exactly k + 0.5 at scales 1 and
    2 (ties round to even)."""
    fmin = qz.FLT_MIN
    x = torch.randn((9, block), generator=g, device="cuda")
    x[0] = torch.linspace(-1e-36, 1e-36, block, device="cuda")
    x[1] *= 1e-38
    x[1, 0] = 1.5e-36
    x[2] = torch.tensor([fmin, -fmin, fmin / 2, -fmin / 2, 0.0],
                        device="cuda")[torch.arange(block, device="cuda") % 5]
    x[2, 0] = 127 * fmin
    x[3] = x[3].clamp(-3, 3) * 1e-37
    x[3, ::7] = 0.0
    x[4] *= 1e-40
    x[5, ::5] *= 1e-39
    x[6] = -0.0
    k = torch.randint(-126, 126, (2, block), generator=g, device="cuda")
    x[7:] = (k + 0.5) * torch.tensor([[1.0], [2.0]], device="cuda")
    x[7:, 0] = torch.tensor([127.0, 254.0], device="cuda")
    return x


SCALE_EDGES = torch.tensor([1e-40, qz.FLT_MIN, -1e-40, 0.0, -0.0, 2e-38])


def new_kernels_phase(card: str) -> dict:
    """Phase 3 for the event-driven path's kernels: ragged and edge
    shapes, then the main path's shapes, held and timed."""
    g = torch.Generator(device="cuda").manual_seed(12)
    rec = {}
    qerr = derr = aerr = 0.0
    paths = set()
    edges = SCALE_EDGES.cuda()
    for rows, block in ((8, 256), (24, 128), (5, 100), (1, 1), (17, 256),
                        (8, 512), (8, 1024), (4, 2048), (16, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn((rows, block), generator=g, device="cuda")
                 * 3).to(dtype)
            x[rows // 2] = 0  # an all-zero row: scale 0, q 0
            edge = quantize_edge_rows(block, g).to(dtype)
            for xx in (x, edge, off_alignment(edge)):
                paths.add(qz.fast_path(xx, dtype))
                qerr = max(qerr, hold_quantize(xx, qz.quantize_blocks(xx)))
            q, s = qz.quantize_blocks(x)
            # every 2nd scale subnormal, FLT_MIN or a signed zero
            s[::2] = edges[torch.arange(0, rows, 2, device="cuda")
                           % len(edges), None]
            for out_dtype in (torch.float32, torch.bfloat16):
                for qq in (q, off_alignment(q)):
                    derr = max(derr, hold_dequantize(
                        qq, s, out_dtype,
                        qz.dequantize_blocks(qq, s, out_dtype)))
    if paths != {True, False}:
        raise AssertionError(f"quantize edge cases took paths {paths}")
    for t in (1, 2, 3, 8, 255, 3001, 4097):  # T < 4, T % 4 != 0
        acc = torch.randn(t, generator=g, device="cuda")
        x = torch.randn(t, generator=g, device="cuda")
        aerr = max(aerr, hold_accumulate(acc, x, ACC_W, fr.fedavg_accumulate(
            acc, x, ACC_W)))
    for t, acc_off, x_off in ((MAIN_T, 1, 1), (MAIN_T, 0, 1), (1001, 1, 0),
                              (3, 1, 1)):  # views off 16-byte alignment
        acc = torch.randn(t + acc_off, generator=g, device="cuda")[acc_off:]
        x = torch.randn(t + x_off, generator=g, device="cuda")[x_off:]
        aerr = max(aerr, hold_accumulate(acc, x, ACC_W, fr.fedavg_accumulate(
            acc, x, ACC_W)))
    for t, off in ((MAIN_T, 0), (MAIN_T, 1), (4097, 3)):  # subnormal range
        acc = tiny_values(t + off, g)[off:]
        x = tiny_values(t + off, g)[off:]
        for w in (ACC_W, 1e-39, 1.0):
            aerr = max(aerr, hold_accumulate(acc, x, w, fr.fedavg_accumulate(
                acc, x, w)))
    for t in (1, 255, 3001, 4097):
        flat = torch.randn(t, generator=g, device="cuda")
        for block in (256, 128):  # the flat wrapper's wire: as on the CPU
            got = ops.quantize_flat_batch([flat], block=block)[0]
            want = ops.quantize_flat_batch([flat.cpu()], block=block)[0]
            if got["q"].tobytes() != want["q"].tobytes() or \
                    got["scales"].tobytes() != want["scales"].tobytes():
                raise AssertionError(f"quantize_flat_batch on the card "
                                     f"differs from the CPU at T={t}")
    log(f"quantize/dequantize/accumulate, ragged shapes (accumulate also "
        f"on views off 16-byte alignment and across 1e-46-1e-33), f32 and "
        f"bf16: max abs err "
        f"{qerr:.3e} / {derr:.3e} / {aerr:.3e}")

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

    # the quantize pair's general path at the main shape (inputs off
    # 16-byte alignment), then what any pass of these bytes costs here
    xo, qo = off_alignment(x), off_alignment(q)
    if qz.fast_path(xo, torch.float32) or qz.fast_path(qo, torch.float32):
        raise AssertionError("an input off 16-byte alignment would take the "
                             "fast path")
    general = {
        "quantize_blocks": (hold_quantize(xo, qz.quantize_blocks(xo)),
                            lambda: qz.quantize_blocks(xo)),
        "dequantize_blocks": (hold_dequantize(qo, s, torch.float32,
                                              qz.dequantize_blocks(qo, s)),
                              lambda: qz.dequantize_blocks(qo, s))}
    for name, (err, fn) in general.items():
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)
        log(f"{name} main shape off 16-byte alignment (general path): max "
            f"abs err {err:.3e} kernel_ms={time_cold(fn):.6f} ({card})")
    floors = {
        f"x.to(torch.int8), {4 * n + n} bytes as quantize's without the "
        f"row max": lambda: x.to(torch.int8),
        f"q.to(torch.float32), {n + 4 * n} bytes as dequantize's without "
        f"the scale": lambda: q.to(torch.float32),
        "an empty kernel launch": empty_launch}
    for what, fn in floors.items():
        log(f"floor: {what}: {time_cold(fn):.6f} ms ({card})")

    large_quantize_pair(card, g, rec)

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


def large_quantize_pair(card: str, g, rec: dict) -> None:
    """The quantize pair on one update of each large tier, (LARGE_ROWS,
    256) f32 (ViT-Large, 1.21 GB) and (BIG_ROWS, 256) (DistilBERT), held
    as at the main shape and timed beside its bound."""
    for tier, rows in (("Large", LARGE_ROWS), ("Big", BIG_ROWS)):
        x = torch.randn((rows, QSGD_BLOCK), generator=g, device="cuda") \
            * 1e-2
        q, s = qz.quantize_blocks(x)
        n = rows * QSGD_BLOCK
        nbytes = 4 * n + n + 4 * rows
        pair = {"quantize_blocks": (hold_quantize(x, (q, s)), QUANT_OPS * n,
                                    lambda: qz.quantize_blocks(x),
                                    lambda: qz.quantize_blocks_plain(x),
                                    None),
                "dequantize_blocks": (
                    hold_dequantize(q, s, torch.float32,
                                    qz.dequantize_blocks(q, s)), n,
                    lambda: qz.dequantize_blocks(q, s),
                    lambda: qz.dequantize_blocks_plain(q, s),
                    lambda: torch.mul(q, s))}
        for name, (err, ops_, kern, plain, lib) in pair.items():
            rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)
            bound_ms, bound_by = bound(nbytes, ops_, card)
            library = f"{time_cold(lib, reps=10):.6f}" if lib else "None"
            log(f"{name} {tier} update ({rows}, {QSGD_BLOCK}): max abs err "
                f"{err:.3e} kernel_ms={time_cold(kern, reps=10):.6f} "
                f"plain_ms={time_cold(plain, reps=10):.6f} "
                f"library_ms={library} bound_ms={bound_ms:.6f} ({nbytes} "
                f"bytes, {bound_by}; {card})")
        del x, q, s, pair
        release()


def topk_rows_input(b: int, t: int, dtype, g) -> torch.Tensor:
    """(b, t) on the card: normal values with |value| ties of both signs,
    +-0.0, a run of equal magnitudes and, for b > 1, a row of signed
    zeros only."""
    x = torch.randn((b, t), generator=g, device="cuda")
    if t >= 8:
        x[:, 1] = -x[:, 0]
        x[:, 3] = x[:, 2]
        x[:, t // 2] = x[:, 0]
        x[:, -1] = -0.0
        x[:, -2] = 0.0
    if t >= 64:
        x[:, 8:40] = 0.125
        x[:, 20:30] *= -1
    if b > 1:
        x[1] = 0.0
        x[1, ::3] = -0.0
    return x.to(dtype)


def topk_sort_inputs(g):
    """(x, k) on the card that drive the multi-tile sort of the survivors:
    k over many tiles and not a multiple of one, k = T, an all-equal row
    of 1,000,000 (ties across every tile boundary; k = 300,001 and k = T),
    a row of +-0.0 with a few values (the threshold is 0), and 3 rows with
    different thresholds; f32 and bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        yield torch.randn((1, 200_003), generator=g, device="cuda") \
            .to(dtype), 30_001
        yield torch.randn((1, 65_537), generator=g, device="cuda") \
            .to(dtype), 65_537
        x = torch.full((1, 1_000_000), 0.75, device="cuda")
        x[0, 1::2] = -0.75
        yield x.to(dtype), 300_001
        yield x.to(dtype), 1_000_000
        x = torch.zeros((1, 50_000), device="cuda")
        x[0, 1::2] = -0.0
        x[0, ::97] = torch.randn(516, generator=g, device="cuda")
        yield x.to(dtype), 20_000
        x = torch.randn((3, 100_000), generator=g, device="cuda")
        x[1] = (x[1] * 1e-3 * 64).round() / 64
        x[2, ::2] = 0.0
        x[2, 1::4] = -0.0
        yield x.to(dtype), 40_000


def last_kernels_phase(card: str) -> dict:
    """Phase 3 for ``topk_rows`` and ``fedavg_reduce_q8``: edge shapes,
    then the main paths' shapes, held and timed."""
    g = torch.Generator(device="cuda").manual_seed(13)
    rec = {}
    terr = qerr = 0.0
    n_checked = 0
    for b in (1, 3):
        for t in (1, 8, 1000, 4099, 65_537):
            for k in sorted({1, max(1, int(0.05 * t)), t}):
                for dtype in (torch.float32, torch.bfloat16):
                    x = topk_rows_input(b, t, dtype, g)
                    terr = max(terr, hold_topk(x, k, tk.topk_rows(x, k)))
                    n_checked += 1
    for x, k in topk_sort_inputs(g):
        terr = max(terr, hold_topk(x, k, tk.topk_rows(x, k)))
        n_checked += 1
    log(f"topk_rows, {n_checked} edge cases (B 1/3, T 1..1,000,000, k 1 / "
        f"5 % / T and across many sort tiles, ties, all-equal rows, +-0.0, "
        f"zero rows, f32 and bf16): idx and vals bit-exact")
    q8_paths = set()
    for n in (1, 3, 5):
        for t in (256, 2048 + 256, Q8_T):
            for block, offset in ((128, 0), (256, 0), (256, 1), (64, 3)):
                buf = torch.randint(-127, 128, (n * t + offset,), generator=g,
                                    device="cuda", dtype=torch.int8)
                q = buf[offset:].view(n, t)  # offset 1, 3: the general path
                s = torch.rand((n, t // block), generator=g,
                               device="cuda") * 1e-2
                s[:, ::5] = tiny_values(s[:, ::5].numel(), g).abs() \
                    .view(n, -1)  # subnormal scales, and products of FLT_MIN
                s[0, 0] = qz.FLT_MIN
                w = torch.rand((n,), generator=g, device="cuda") + 0.5
                w = w / w.sum()
                q8_paths.add(fr.q8_fast_path(q, block))
                qerr = max(qerr, hold_q8(q, s, w, block,
                                         fr.fedavg_reduce_q8(q, s, w, block)))
        for t, block in ((2002, 2), (63, 7), (2000, 100)):  # 2, 7: general
            q = torch.randint(-127, 128, (n, t), generator=g, device="cuda",
                              dtype=torch.int8)
            w = torch.full((n,), 1.0 / n, device="cuda")
            s = torch.stack([window_values(t // block, float(wi), g).abs()
                             for wi in w])  # q = +-1: products at FLT_MIN
            q[:, ::2] = q[:, ::2].sign()
            q8_paths.add(fr.q8_fast_path(q, block))
            qerr = max(qerr, hold_q8(q, s, w, block,
                                     fr.fedavg_reduce_q8(q, s, w, block)))
    if q8_paths != {True, False}:
        raise AssertionError(f"fedavg_reduce_q8 edge cases took paths "
                             f"{q8_paths}")
    log(f"fedavg_reduce_q8, N 1/3/5, T' 63..{Q8_T}, block 2..256, q on and "
        f"off 4-byte alignment (both paths), scales across 1e-46-1e-33 and "
        f"products just around FLT_MIN: bit-exact")

    # the main paths' shapes: one Medium and one Small update at topk:0.05
    for t in (MEDIUM_T, MAIN_T):
        k = topk_k(t)
        x = torch.randn((1, t), generator=g, device="cuda") * 1e-2
        err = hold_topk(x, k, tk.topk_rows(x, k))
        nbytes = 4 * t + 8 * k  # read the row, write idx and vals
        bound_ms, bound_by = bound(nbytes, 0, card)
        kernel_ms = time_cold(lambda: tk.topk_rows(x, k), reps=20)
        plain_ms = time_cold(lambda: tk.topk_rows_plain(x, k), reps=20)
        library_ms = time_cold(lambda: torch.topk(x.abs(), k), reps=20)
        log(f"topk_rows (1, {t}) k={k}: bit-exact; kernel_ms={kernel_ms:.6f} "
            f"plain_ms={plain_ms:.6f} library_ms={library_ms:.6f} "
            f"(torch.topk(x.abs(), k)) bound_ms={bound_ms:.6f} ({nbytes} "
            f"bytes, {bound_by}; {card})")
        parts = device_breakdown(lambda: tk.topk_rows(x, k))
        log(f"topk_rows (1, {t}) by kernel (torch.profiler, warm, µs per "
            f"call): " + ("; ".join(f"{short_name(name)} {us:.3f} "
                                   f"(x{n:g})" for name, us, n in parts)
                          or "no device time recorded"))
        if t == MEDIUM_T:  # the slice's main path: its line in the record
            rec["topk_rows"] = {"max_abs_err": max(err, terr),
                                "ms": kernel_ms, "plain_ms": plain_ms,
                                "bound_ms": bound_ms, "bound_by": bound_by,
                                "library_ms": library_ms}

    q = torch.randint(-127, 128, (Q8_N, Q8_T), generator=g, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((Q8_N, Q8_T // QSGD_BLOCK), generator=g,
                   device="cuda") * 1e-2
    w = torch.full((Q8_N,), 1.0 / Q8_N, device="cuda")
    if not fr.q8_fast_path(q, QSGD_BLOCK):
        raise AssertionError("the main shape would take q8's general path")
    err = hold_q8(q, s, w, QSGD_BLOCK, fr.fedavg_reduce_q8(q, s, w, QSGD_BLOCK))
    nbytes = Q8_N * Q8_T + 4 * Q8_N * (Q8_T // QSGD_BLOCK) + 4 * Q8_N \
        + 4 * Q8_T
    bound_ms, bound_by = bound(nbytes, 3 * Q8_N * Q8_T, card)
    kernel_ms = time_cold(lambda: fr.fedavg_reduce_q8(q, s, w, QSGD_BLOCK))
    graph_ms = time_graph(lambda: fr.fedavg_reduce_q8(q, s, w, QSGD_BLOCK))
    plain_ms = time_cold(lambda: fr.fedavg_reduce_q8_plain(q, s, w,
                                                          QSGD_BLOCK))
    qo = off_alignment(q)
    if fr.q8_fast_path(qo, QSGD_BLOCK):
        raise AssertionError("q off 4-byte alignment would take q8's fast "
                             "path")
    err = max(err, hold_q8(qo, s, w, QSGD_BLOCK,
                           fr.fedavg_reduce_q8(qo, s, w, QSGD_BLOCK)))
    general_ms = time_cold(lambda: fr.fedavg_reduce_q8(qo, s, w, QSGD_BLOCK))
    log(f"fedavg_reduce_q8 ({Q8_N}, {Q8_T}) block {QSGD_BLOCK}: bit-exact; "
        f"fast path kernel_ms={kernel_ms:.6f} graph-replayed {graph_ms:.6f} "
        f"ms; general path (q off 4-byte alignment) {general_ms:.6f} ms; "
        f"plain_ms={plain_ms:.6f} "
        f"library_ms=None (no one call computes it) bound_ms={bound_ms:.6f} "
        f"({nbytes} bytes, {bound_by}; {card})")
    rec["fedavg_reduce_q8"] = {"max_abs_err": max(err, qerr),
                               "ms": kernel_ms, "plain_ms": plain_ms,
                               "bound_ms": bound_ms, "bound_by": bound_by,
                               "library_ms": None}

    # the top-k codec's host work on one MobileNetV3 update
    model = MobileNetV3(MobileNetConfig(), device="cuda")
    tree = model.init(torch.Generator().manual_seed(3))
    codec = TopkCodec(TOPK_FRAC)
    (pp, _, info), = codec.encode_batch([TensorPayload(tree)], [None])
    host = {
        "TopkCodec.encode_batch (flatten 151 leaves, kernel, device->host "
        "copy of idx and vals)":
            lambda: codec.encode_batch([TensorPayload(tree)], [None]),
        "TopkCodec.decode_batch (host->device copy, scatter, unflatten)":
            lambda: codec.decode_batch([pp], [info], device="cuda"),
    }
    for what, fn in host.items():
        log(f"{what}, one MobileNetV3 update: {time_host(fn):.6f} ms host "
            f"clock ({card})")
    return rec


@contextlib.contextmanager
def recording(calls: dict, at_once: dict = None):
    """Keep the inputs and output of every call of the kernel
    wrappers (``calls[name]``: a list of (args, out), both forms of
    ``fedavg_reduce`` under its name), so each can be held against its
    plain version after the run, outside its timed state.

    ``at_once`` (kernel name -> its largest error so far) names kernels
    whose calls are held as they return, their tensors checked to lie on
    the card; such a call keeps only its tensors' shapes (``meta``
    tensors), so a run's inputs need not all fit on the card at once."""
    kept = {(name, w): getattr(_MODULE[name], w) for name in KERNELS
            for w in _WRAPPERS.get(name, (name,))}
    at_once = {} if at_once is None else at_once

    def record(key, *args):
        out = kept[key](*args)
        name = key[0]
        if name in at_once:
            if not all(a.is_cuda for a in _tensors(args)):
                raise AssertionError(f"{name} got a host tensor")
            at_once[name] = max(at_once[name], HOLD[name](args, out))
            calls.setdefault(name, []).append((shapes_only(args),
                                               shapes_only(out)))
        else:
            calls.setdefault(name, []).append((args, out))
        return out

    for key in kept:
        setattr(_MODULE[key[0]], key[1], functools.partial(record, key))
    try:
        yield
    finally:
        for (name, w), fn in kept.items():
            setattr(_MODULE[name], w, fn)


def shapes_only(obj):
    """``obj`` with every tensor in it replaced by a ``meta`` tensor of its
    shape and dtype."""
    if isinstance(obj, torch.Tensor):
        return torch.empty_like(obj, device="meta")
    if isinstance(obj, (list, tuple)):
        return type(obj)(shapes_only(o) for o in obj)
    return obj


# -- phases 4-5: the main path and the fault story ----------------------
def run_rounds(backend: str, *, rounds: int, reduced: bool, device,
               dropped=None, quorum: float = QUORUM, fedavg=None,
               tier: str = "small", step_ms=None):
    """``fedavg``, on the card: a list that gets, per round, the shape
    FedAvg ran at and the kernel's max abs error against the plain
    version on the same inputs. ``step_ms``: a list that gets the
    synchronised wall ms of every local training step."""
    cfg = FLConfig(backend=backend, environment="geo_distributed",
                   quorum_fraction=quorum)
    server, params, _, store = fl_train.build_deployment(
        cfg, tier=tier, reduced=reduced, local_steps=LOCAL_STEPS,
        device=device)
    if step_ms is not None:
        for client in server.clients:
            client.train_fn = timed_steps(client.train_fn, step_ms)
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
            (args, got), = calls
            err = hold_reduce(args, got)
            if fedavg is not None:
                shape = reduce_shape(args)
                fedavg.append((shape, err, vector_tiles(args[0])
                               if len(shape) == 3 else (0, 0)))
        if rep.losses is None or not math.isfinite(rep.losses) or not all(
                bool(torch.isfinite(l).all()) for l in leaves):
            raise AssertionError(f"{backend} round {r}: non-finite loss "
                                 f"{rep.losses} or params")
        reports.append(rep)
    return reports, params, store


def timed_steps(train_fn, step_ms: list):
    """``train_fn`` with each call's wall ms, between two synchronises,
    appended to ``step_ms``."""
    def step(params, batch):
        synchronize()
        t0 = time.perf_counter()
        out = train_fn(params, batch)
        synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    return step


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
    shapes = {shape for shape, _, _ in fedavg}
    if shapes != {(MAIN_N, MAIN_T, MAIN_LEAVES)}:
        raise AssertionError(f"main path ran FedAvg at {shapes}, phase 3 "
                             f"checked and timed the tree form at "
                             f"{(MAIN_N, MAIN_T, MAIN_LEAVES)}")
    err = max(e for _, e, _ in fedavg)
    vec, tiles = (sum(v[i] for _, _, v in fedavg) for i in (0, 1))
    log(f"main path FedAvg through the tree form at (N, T, leaves) "
        f"{(MAIN_N, MAIN_T, MAIN_LEAVES)}, every round bit-exact against "
        f"the plain version (max abs err {err:.3e}); {len(fedavg)} "
        f"launches, {vec} of {tiles} tiles on the 16-byte path")
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
# Phases 6 and 8 hold each leaf to LEAF_RTOL of its largest entry when
# cuDNN runs its deterministic algorithms. Its default ones sum some weight
# gradients in an order that changes from run to run; that moves the
# normalisation biases, whose entries are all ~1e-4 after a round or two,
# by far more than 1e-4 of their own size, so those runs' bars have the
# floor LEAF_ATOL.
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


def max_rel_err(got_tree, want_tree) -> float:
    """Largest |got - want| over a leaf, relative to that leaf's max."""
    worst = 0.0
    for g, w in zip(_tree.leaves(got_tree), _tree.leaves(want_tree)):
        g, w = g.detach().cpu().float(), w.detach().cpu().float()
        scale = max(float(w.abs().max()), 1e-12)
        worst = max(worst, float((g - w).abs().max()) / scale)
    return worst


def reference_check(device) -> None:
    """Full quorum: with 0.7, which 5 of 7 updates are averaged depends on
    the measured training seconds, and those differ between the card and
    the CPU. The card runs the round twice. With cuDNN's deterministic
    algorithms, each leaf is held to the port's parity bar, 1e-4 of its
    largest entry (f32 on both sides; the convolutions sum in another
    order than the CPU's, the same order in every run). With its default
    ones, some weight gradients are summed in an order that changes from
    run to run, which moves the normalisation biases (entries ~1e-4 after
    one round) by more than 1e-4 of their own size in about 1 run in 12;
    that run is held as phase 8 holds its default run, to max(LEAF_RTOL *
    the leaf's largest entry, LEAF_ATOL) (PERF.md: the spread of both runs
    over 12 rounds, ``scripts/sync_round_spread.py``)."""
    bar = LEAF_RTOL
    (cpu_rep,), cpu_p, _ = run_rounds("torch_rpc", rounds=1, reduced=True,
                                      device="cpu", quorum=1.0)
    for det in (True, False):
        with cudnn_deterministic(det):
            (card_rep,), card_p, _ = run_rounds(
                "torch_rpc", rounds=1, reduced=True, device=device,
                quorum=1.0)
        errs = leaf_errors(card_p, cpu_p)
        floor = 0.0 if det else LEAF_ATOL
        rel = max(e / max(m, 1e-12) for e, m in errs)
        to_bar = [e / max(bar * m, floor, 1e-30) for e, m in errs]
        i = max(range(len(errs)), key=to_bar.__getitem__)
        log(f"reduced round, cudnn.deterministic={det}, card vs CPU: loss "
            f"{card_rep.losses:.6f} vs {cpu_rep.losses:.6f}; params, per "
            f"leaf relative to its largest entry: max {rel:.3e}; leaf {i} "
            f"of {len(errs)} nearest its bar max({bar} * largest entry, "
            f"{floor}): err {errs[i][0]:.3e}, largest entry "
            f"{errs[i][1]:.3e}")
        if to_bar[i] > 1.0 or not math.isclose(card_rep.losses,
                                               cpu_rep.losses, rel_tol=bar):
            raise AssertionError(f"the round on the card (cudnn."
                                 f"deterministic={det}) disagrees with the "
                                 f"CPU")

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
    # the Medium tier (MobileNetV3, full width) with the top-k codec
    ("hospitals_geo3.json", ["--scenario", str(
        ROOT / "examples" / "scenarios" / "hospitals_geo3.json")]),
    ("fedbuff+topk grpc", ["--mode", "fedbuff", "--compression", "topk",
                           "--backend", "grpc", "--environment",
                           "geo_distributed", "--clients", "7", "--rounds",
                           "3"]),
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


def _tensors(args):
    """The tensors in a call's arguments, lists of leaves included."""
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _tensors(a)


def expect(name: str, what: str, got: int, want: int, at_least=False):
    ok = got >= want if at_least else got == want
    if not ok:
        raise AssertionError(f"{name}: {what} = {got}, expected "
                             f"{'>= ' if at_least else ''}{want}")


TOPK_RUNS = ("hospitals_geo3.json", "fedbuff+topk grpc")


def check_global(name: str, sched) -> None:
    leaves = _tree.leaves(sched.global_params)
    if not all(l.is_cuda and bool(torch.isfinite(l).all()) for l in leaves):
        raise AssertionError(f"{name}: global params left the card or are "
                             f"not finite")


def topk_checks(name, calls, got, sched, n_upd, n_agg) -> None:
    """A top-k run (fedbuff or semisync, no hub): every update's row went
    through ``topk_rows`` at the model's length and the codec's k, FedAvg
    ran once per aggregation, and nothing was quantised."""
    t = sum(l.numel() for l in _tree.leaves(sched.global_params))
    if name == "hospitals_geo3.json":
        expect(name, "parameters of the Medium tier", t, MEDIUM_T)
    shapes = {tuple(args[0].shape[1:]) + (int(args[1]),)
              for args, _ in calls.get("topk_rows", [])}
    if shapes != {(t, topk_k(t))}:
        raise AssertionError(f"{name}: topk_rows ran at (T, k) {shapes}, "
                             f"expected {(t, topk_k(t))}")
    rows = sum(args[0].shape[0] for args, _ in calls.get("topk_rows", []))
    expect(name, "update rows through topk_rows", rows, n_upd, at_least=True)
    expect(name, "fedavg_reduce launches", got["fedavg_reduce"], n_agg)
    for k in ("quantize_blocks", "dequantize_blocks", "fedavg_accumulate"):
        expect(name, f"{k} launches", got[k], 0)
    check_global(name, sched)


def event_path(device, errs: dict) -> dict:
    """Phase 7: each run with every launch count at 0 just before it and
    read just after. Returns the launches summed over the runs."""
    total = {k: 0 for k in KERNELS}
    vec = tiles = 0  # the tree form's tiles on its 16-byte path, all tiles
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
                if not all(a.is_cuda for a in _tensors(args)):
                    raise AssertionError(f"{name}: {k} got a host tensor")
                if k == "fedavg_reduce":
                    if len(reduce_shape(args)) != 3:
                        raise AssertionError(f"{name}: FedAvg stacked its "
                                             f"trees instead of the tree "
                                             f"form")
                    v, a = vector_tiles(args[0])
                    vec, tiles = vec + v, tiles + a
                errs[k] = max(errs[k], HOLD[k](args, out))
        n_upd, n_agg = rep.n_client_updates, rep.n_aggregations
        strat = sched.strategy
        if name in TOPK_RUNS:
            topk_checks(name, calls, got, sched, n_upd, n_agg)
            log(f"{name}: sim_time={rep.sim_time:.4f}s aggregations={n_agg} "
                f"client_updates={n_upd} mean_staleness="
                f"{rep.mean_staleness:.4f} wall={wall:.3f}s; launches {got}; "
                f"topk_rows rows per call "
                f"{sorted({a[0].shape[0] for a, _ in calls['topk_rows']})}")
            continue
        # what the report implies (MAIN_ROWS rows per ResNet56 update)
        q_upd = _rows(calls, "quantize_blocks") / MAIN_ROWS
        dq_upd = _rows(calls, "dequantize_blocks") / MAIN_ROWS
        expect(name, "rows of one update", update_rows(sched), MAIN_ROWS)
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
        check_global(name, sched)
        log(f"{name}: sim_time={rep.sim_time:.4f}s aggregations={n_agg} "
            f"client_updates={n_upd} mean_staleness="
            f"{rep.mean_staleness:.4f} wall={wall:.3f}s; launches {got}; "
            f"updates quantised {q_upd:g}, dequantised {dq_upd:g}")
    log(f"event-driven FedAvg: {total['fedavg_reduce']} launches, {vec} of "
        f"{tiles} tiles on the 16-byte path")
    never = [k for k, v in total.items() if not v and k != "fedavg_reduce_q8"]
    if never:
        raise AssertionError(f"a kernel of the event-driven path never "
                             f"launched: {total}")
    return total


# -- phase 8: the event-driven path, card against CPU ----------------------


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


# -- phase 9: FedAvg over qsgd-packed updates ------------------------------
def q8_phase(card: str, device) -> int:
    """``fl.aggregator.fedavg_quantized`` on Q8_N distinct full-width
    ResNet56 updates, quantised on the card into host wire buffers, held
    against FedAvg of the dequantised trees and against the plain version
    on the same inputs. Returns the kernel's launches in the call."""
    model = ResNet(ResNetConfig(), device=device)
    trees = [model.init(torch.Generator().manual_seed(20 + i))
             for i in range(Q8_N)]
    flats = [ops.flatten_pytree(t)[0] for t in trees]
    _, unflatten = ops.flatten_pytree(trees[0])
    packed = ops.quantize_flat_batch(flats, block=QSGD_BLOCK)
    if any(isinstance(p["q"], torch.Tensor) for p in packed):
        raise AssertionError("quantize_flat_batch did not give host wires")
    weights = [64.0, 32.0, 128.0, 16.0, 48.0]
    calls = {}
    synchronize()
    zero_launches()
    with recording(calls):
        agg, secs = fedavg_quantized(packed, weights, unflatten,
                                     device=device)
    synchronize()
    launched = fr.Q8_LAUNCHES
    on_card = torch.device(device).type == "cuda"
    expect("fedavg_quantized", "fedavg_reduce_q8 launches", launched,
           1 if on_card else 0)
    expect("fedavg_quantized", "recorded calls",
           len(calls.get("fedavg_reduce_q8", [])), 1)
    (args, out), = calls["fedavg_reduce_q8"]
    if tuple(args[0].shape) != (Q8_N, Q8_T) or args[3] != QSGD_BLOCK:
        raise AssertionError(f"fedavg_quantized ran the kernel at "
                             f"{tuple(args[0].shape)} block {args[3]}, phase "
                             f"3 timed {(Q8_N, Q8_T)} block {QSGD_BLOCK}")
    err = hold_q8(*args, out)
    if on_card and not fr.q8_fast_path(args[0], args[3]):
        raise AssertionError("fedavg_quantized took q8's general path")
    deq = ops.dequantize_flat_batch(packed, device=device)
    want, _ = fedavg([unflatten(x) for x in deq], weights)
    leaves = _tree.leaves(agg)
    if not all(l.device == torch.device(device) for l in leaves):
        raise AssertionError(f"fedavg_quantized left {device}")
    worst = 0.0
    for g, w in zip(leaves, _tree.leaves(want)):
        worst = max(worst, float((g - w).abs().max()))
        if not torch.allclose(g, w, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"fedavg_quantized disagrees with FedAvg of "
                                 f"the dequantised trees: {worst:.3e}")
    host_ms = time_host(lambda: fedavg_quantized(packed, weights, unflatten,
                                                 device=device))
    log(f"fedavg_quantized, {Q8_N} x ResNet56 qsgd wires: against the plain "
        f"version {err:.3e}, against fedavg of the dequantised trees "
        f"{worst:.3e} (bar rtol {RTOL} / atol {ATOL}); the call took "
        f"{secs * 1e3:.6f} ms, {host_ms:.6f} ms host clock median "
        f"(synchronised; {card})")
    return launched


# -- phase 10: the Medium tier's model, card against CPU -------------------
def mobilenet_reference_check(device) -> None:
    """One full-width MobileNetV3 loss and gradient on the silos' 16x16
    batch of 16, from the same parameters: the card in f32 with cuDNN's
    deterministic algorithms (TF32 is off for the whole run) and the CPU
    in f32, both against the CPU in f64. Each leaf is held to 1e-4 of its
    largest entry, phase 6's bar, except the ``bn_p`` biases: each feeds
    the next normalisation through a linear 1x1 conv, so their gradient
    is zero and f32 gives rounding noise there; they are held to zero,
    within 1e-6 of the model's largest gradient entry. On this input one
    normalised value sits 6.2e-6 below hard_swish's kink at 3 in f64; a
    run that rounds it across gives gradients up to 0.13 of a leaf's
    largest entry away (PERF.md, the MobileNetV3 repair)."""
    bar, zero_bar = 1e-4, 1e-6
    model = MobileNetV3(MobileNetConfig(), device=device)
    params = model.init(torch.Generator().manual_seed(8))
    silo = make_silo_datasets(1, kind="image", examples_per_silo=64,
                              num_classes=8, image_size=16, seed=8)[0]
    batch = {k: torch.as_tensor(v) for k, v in
             next(silo.batches(16, seed=1)).items()}

    def loss_and_grads(dev, dtype=torch.float32):
        leaves, treedef = _tree.flatten(params)
        leaves = [l.detach().to(dev, dtype).requires_grad_(True)
                  for l in leaves]
        b = {k: v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
             for k, v in batch.items()}
        loss, _ = MobileNetV3(MobileNetConfig(), device=dev).loss(
            _tree.unflatten(treedef, leaves), b)
        return float(loss), [g.detach().cpu().double()
                             for g in torch.autograd.grad(loss, leaves)]

    with cudnn_deterministic(True):
        card_loss, card_g = loss_and_grads(device)
    ref_loss, ref_g = loss_and_grads("cpu", torch.float64)
    cpu_loss, cpu_g = loss_and_grads("cpu")
    top = max(float(g.abs().max()) for g in ref_g)
    zero = zero_grad_leaves(params)

    def per_leaf(got):
        return max(float((g - w).abs().max())
                   / max(float(w.abs().max()), 1e-30)
                   for i, (g, w) in enumerate(zip(got, ref_g))
                   if i not in zero)

    def worst_zero(got):
        return max(float(got[i].abs().max()) / top for i in zero)

    for side, loss, got in (("card", card_loss, card_g),
                            ("CPU", cpu_loss, cpu_g)):
        worst, wz = per_leaf(got), worst_zero(got)
        log(f"MobileNetV3 full width, {side} f32 vs CPU f64: loss "
            f"{loss:.7f} vs {ref_loss:.7f}; gradients, per leaf relative to "
            f"its largest entry, max {worst:.3e} (bar {bar}); the "
            f"{len(zero)} bn_p bias gradients (zero) at most {wz:.3e} of "
            f"the largest entry (bar {zero_bar})")
        if worst > bar or wz > zero_bar or not math.isclose(
                loss, ref_loss, rel_tol=bar):
            raise AssertionError(f"MobileNetV3 f32 on the {side} disagrees "
                                 f"with the CPU's f64 run")


def zero_grad_leaves(params) -> set:
    """Indices (in leaf order) of the ``bn_p`` biases of every block."""
    marked = _tree.map(lambda a: 0, params)
    for blk in marked["blocks"]:
        blk["bn_p"]["bias"] = 1
    return {i for i, v in enumerate(_tree.leaves(marked)) if v == 1}


# -- phase 11: the Large tier's live path ---------------------------------
LARGE_BUFFER_K = TIERS["large"].async_knobs("geo_distributed",
                                            SILOS)["buffer_k"]
LARGE_EVENT_ARGV = ["--mode", "fedbuff", "--compression",
                    f"qsgd:{QSGD_BLOCK}", "--backend", "grpc+s3",
                    "--environment", "geo_distributed", "--clients",
                    str(SILOS), "--rounds", "2", "--local-steps",
                    str(LOCAL_STEPS), "--tier", "large", "--buffer-k",
                    str(LARGE_BUFFER_K)]


def memory_note() -> str:
    """The peak device memory since the last reset, and this process's
    peak resident host memory so far (ru_maxrss is in KiB on Linux)."""
    host = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    return (f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
            f"(torch.cuda.max_memory_allocated), peak host RSS so far "
            f"{host:.3f} GiB")


def fresh_run() -> None:
    """Before a counted run: memory returned, the peak reset, the card
    idle and every launch count at 0."""
    release()
    torch.cuda.reset_peak_memory_stats()
    synchronize()
    zero_launches()


def large_tier_path(card: str, device, errs: dict) -> dict:
    """Phase 11: one sync round and one fedbuff + qsgd run of full-width
    ViT-Large on grpc+s3, each with every launch count at 0 just before it
    and read just after. Returns each kernel's launches over both runs."""
    total = {k: 0 for k in KERNELS}
    step_ms, fedavg = [], []
    fresh_run()
    t0 = time.perf_counter()
    (rep,), _, store = run_rounds("grpc+s3", rounds=1, reduced=False,
                                  device=device, tier="large", fedavg=fedavg,
                                  step_ms=step_ms)
    synchronize()
    wall = time.perf_counter() - t0
    got = launches()
    expect("Large sync round", "FedAvg calls", len(fedavg), 1)
    (shape, err, (vec, tiles)), = fedavg
    if shape != (MAIN_N, LARGE_T, LARGE_LEAVES):
        want = (MAIN_N, LARGE_T, LARGE_LEAVES)
        raise AssertionError(f"the Large sync round ran FedAvg at {shape}, "
                             f"phase 3 timed {want}")
    for k in KERNELS:
        expect("Large sync round", f"{k} launches", got[k],
               int(k == "fedavg_reduce"))
        total[k] += got[k]
    errs["fedavg_reduce"] = max(errs["fedavg_reduce"], err)
    steps = sorted(step_ms)
    log(f"Large tier, sync round on grpc+s3 (ViT-Large, {SILOS} silos, "
        f"{LOCAL_STEPS} local steps, quorum {QUORUM}): wall {wall:.3f} s; "
        f"round={rep.round_time:.4f}s sim, loss {rep.losses:.4f}; "
        f"{len(steps)} training steps (batch 16, 196 positions), "
        f"synchronised ms: first {step_ms[0]:.3f}, median "
        f"{statistics.median(steps):.3f}, min {steps[0]:.3f}, max "
        f"{steps[-1]:.3f}; FedAvg {rep.server['aggregation'] * 1e3:.3f} ms "
        f"synchronised (one tree-form launch at {shape}, bit-exact against "
        f"the plain version, {vec} of {tiles} tiles on the 16-byte path); "
        f"{memory_note()}; {card}")
    log("   client states: " + " ".join(
        f"{k}={v:.4f}s" for k, v in rep.clients.items()))
    log("   server states: " + " ".join(
        f"{k}={v:.4f}s" for k, v in rep.server.items())
        + f"; store {dict(store.stats)}")
    del rep, store, fedavg

    name = "Large fedbuff+qsgd grpc+s3"
    calls = {}
    at_once = {"quantize_blocks": 0.0, "dequantize_blocks": 0.0}
    fresh_run()
    t0 = time.perf_counter()
    with recording(calls, at_once):
        rep, sched = event_run(LARGE_EVENT_ARGV, device, reduced=False)
    synchronize()
    wall = time.perf_counter() - t0
    got = launches()
    for k in KERNELS:
        expect(name, f"{k} launches vs recorded calls", got[k],
               len(calls.get(k, [])))
        total[k] += got[k]
    for args, out in calls.get("fedavg_reduce", []):
        if not all(a.is_cuda for a in _tensors(args)):
            raise AssertionError(f"{name}: fedavg_reduce got a host tensor")
        shape = reduce_shape(args)
        if len(shape) != 3 or shape[1:] != (LARGE_T, LARGE_LEAVES):
            raise AssertionError(f"{name}: FedAvg ran at {shape}")
        errs["fedavg_reduce"] = max(errs["fedavg_reduce"],
                                    hold_reduce(args, out))
    for k, e in at_once.items():
        errs[k] = max(errs[k], e)
    n_upd, n_agg = rep.n_client_updates, rep.n_aggregations
    expect(name, "aggregations", n_agg, 2)
    expect(name, "rows of one update", update_rows(sched), LARGE_ROWS)
    q_upd = _rows(calls, "quantize_blocks") / LARGE_ROWS
    dq_upd = _rows(calls, "dequantize_blocks") / LARGE_ROWS
    expect(name, "fedavg_reduce launches", got["fedavg_reduce"], n_agg)
    expect(name, "updates quantised", q_upd, n_upd, at_least=True)
    # error feedback is off on grpc+s3: one decode per update
    expect(name, "updates dequantised", dq_upd, n_upd, at_least=True)
    for k in ("fedavg_accumulate", "topk_rows", "fedavg_reduce_q8"):
        expect(name, f"{k} launches", got[k], 0)
    check_global(name, sched)
    log(f"{name} (ViT-Large, K = {LARGE_BUFFER_K}): wall {wall:.3f} s; "
        f"sim_time={rep.sim_time:.4f}s aggregations={n_agg} "
        f"client_updates={n_upd} mean_staleness={rep.mean_staleness:.4f}; "
        f"launches {got}; updates quantised {q_upd:g}, dequantised "
        f"{dq_upd:g}, every call held against its plain version as it "
        f"returned (max abs err {at_once}); {memory_note()}; {card}")

    # the host's work per update on the two wires this tier sends
    tree = sched.global_params
    del rep, sched, calls
    update = make_channel("generic", compression=f"qsgd:{QSGD_BLOCK}",
                          error_feedback=False, device=device)
    model = make_channel("generic", device=device)
    enc_u = update.encode(TensorPayload(tree), "s3")
    enc_m = model.encode(TensorPayload(tree))
    host = {"update wire encode (flatten 13 leaves, quantize, device->host "
            "copy, pickle)": lambda: update.encode(TensorPayload(tree), "s3"),
            "update wire decode (unpickle, host->device copy, dequantize, "
            "unflatten)": lambda: update.decode(enc_u.wire),
            "model wire encode (device->host copy, pickle)":
                lambda: model.encode(TensorPayload(tree)),
            "model wire decode (unpickle, host->device copy)":
                lambda: model.decode(enc_m.wire)}
    for what, fn in host.items():
        log(f"Large tier, {what}: {time_host(fn, reps=3):.3f} ms host clock, "
            f"synchronised; wire "
            f"{(enc_u if 'update' in what else enc_m).wire.nbytes} bytes "
            f"({card})")
    del enc_u, enc_m, host
    step_breakdown(card, tree)
    del tree
    release()
    return total


def step_breakdown(card: str, params) -> None:
    """Where one ViT-Large training step (batch 16 of the silos' images,
    the live path's ``train_fn``) goes on the card: its wall ms,
    synchronised, and its kernels' device time by name from
    ``torch.profiler``, whose sum over the wall time is the device's busy
    share."""
    model = ViT(ViTConfig(), device="cuda")
    silo = make_silo_datasets(1, kind="image", examples_per_silo=64,
                              num_classes=8, image_size=16, seed=0)[0]
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in next(silo.batches(16, seed=0)).items()}
    step = fl_train.make_train_fn(model)
    wall_ms = time_host(lambda: step(params, batch), reps=3)
    parts = device_breakdown(lambda: step(params, batch), reps=2)
    busy_ms = sum(us for _, us, _ in parts) / 1e3
    log(f"ViT-Large training step (batch 16, 196 positions): {wall_ms:.3f} "
        f"ms wall, synchronised; {busy_ms:.3f} ms of kernels "
        f"(torch.profiler), a busy share of {busy_ms / wall_ms:.3f}; by "
        f"kernel, ms per step: " + "; ".join(
            f"{short_name(name)[:60]} {us / 1e3:.3f} (x{n:g})"
            for name, us, n in parts[:8]) + f" ({card})")


# -- phase 12: the Large and Big tiers' models, card against CPU -----------
def large_models_check(device) -> None:
    """ViT-Large's forward pass on the silos' 16x16 images at batch 2 (one
    patch broadcast to 196 positions), card f32 against CPU f32 at 1e-4
    of the largest logit; DistilBERT's loss and gradients at batch 2,
    sequence 512, the card's and the CPU's f32 runs each against the CPU's
    f64 run at 1e-4 of each leaf's largest entry. The key projections'
    biases add one constant per query to every score, which the softmax
    removes: their gradient is zero, and f32 gives rounding noise there,
    so they are held to zero within 1e-6 of the largest gradient entry."""
    bar, zero_bar = 1e-4, 1e-6
    vit = ViT(ViTConfig(), device="cpu")
    params = vit.init(torch.Generator().manual_seed(9))
    silo = make_silo_datasets(1, kind="image", examples_per_silo=64,
                              num_classes=8, image_size=16, seed=9)[0]
    images = torch.as_tensor(next(silo.batches(2, seed=1))["images"])
    with torch.no_grad():
        want = vit.forward(params, images)
        got = ViT(ViTConfig(), device=device).forward(
            _tree.map(lambda a: a.to(device), params), images.to(device))
    top = float(want.abs().max())
    err = float((got.cpu() - want).abs().max())
    log(f"ViT-Large full width, forward at batch 2, card f32 vs CPU f32: "
        f"logits max abs err {err:.3e}, {err / top:.3e} of the largest "
        f"logit {top:.4f} (bar {bar})")
    if tuple(got.shape) != (2, ViTConfig().num_classes) or err > bar * top:
        raise AssertionError("ViT-Large's forward on the card disagrees with "
                             "the CPU")
    del vit, params, got
    release()

    bert = DistilBert(BertConfig(), device="cpu")
    g = torch.Generator().manual_seed(10)
    body, head = bert.init(g), bert.init_head(g)
    batch = {"tokens": torch.randint(0, BertConfig().vocab_size, (2, 512),
                                     generator=g),
             "labels": torch.randint(0, BertConfig().num_classes, (2,),
                                     generator=g)}
    leaves, treedef = _tree.flatten((body, head))
    zero = {i for i, v in enumerate(_tree.leaves(
        ({**_tree.map(lambda a: 0, body), "layers": [
            {**_tree.map(lambda a: 0, blk), "k": {"b": 1, "w": 0}}
            for blk in body["layers"]]}, _tree.map(lambda a: 0, head))))
        if v == 1}
    expect("DistilBERT", "key-bias leaves", len(zero),
           BertConfig().num_layers)

    def loss_and_grads(dev, dtype=torch.float32):
        xs = [l.detach().to(dev, dtype).requires_grad_(True) for l in leaves]
        b, h = _tree.unflatten(treedef, xs)
        loss, _ = DistilBert(BertConfig(), device=dev).loss(
            b, h, {k: v.to(dev) for k, v in batch.items()})
        return float(loss.detach()), [x.detach().cpu().double()
                             for x in torch.autograd.grad(loss, xs)]

    card_loss, card_g = loss_and_grads(device)
    ref_loss, ref_g = loss_and_grads("cpu", torch.float64)
    cpu_loss, cpu_g = loss_and_grads("cpu")
    top = max(float(x.abs().max()) for x in ref_g)
    for side, loss, got in (("card", card_loss, card_g),
                            ("CPU", cpu_loss, cpu_g)):
        worst = max(float((a - w).abs().max()) / max(float(w.abs().max()),
                                                     1e-30)
                    for i, (a, w) in enumerate(zip(got, ref_g))
                    if i not in zero)
        wz = max(float(got[i].abs().max()) / top for i in zero)
        log(f"DistilBERT full width, batch 2 x 512, {side} f32 vs CPU f64: "
            f"loss {loss:.7f} vs {ref_loss:.7f}; gradients, per leaf "
            f"relative to its largest entry, max {worst:.3e} (bar {bar}); "
            f"the {len(zero)} key-bias gradients (zero) at most {wz:.3e} of "
            f"the largest entry (bar {zero_bar})")
        if worst > bar or wz > zero_bar or not math.isclose(
                loss, ref_loss, rel_tol=bar):
            raise AssertionError(f"DistilBERT f32 on the {side} disagrees "
                                 f"with the CPU's f64 run")


# -- phase 13: vertical (split) FL at full width ----------------------------
VERTICAL_GEO = ROOT / "examples" / "scenarios" / "vertical_geo.json"
VERTICAL_RUNS = (
    # (a) vertical_geo.json's channel, faults and split (auto, zlib, 8 MB
    # chunks, link loss 0.01, cut 2, 8 batches a round, qsgd:256 on the
    # activations and their gradients, 4 geo parties) on ResNet56: the
    # reference has no adapter for the file's Big tier (DistilBERT)
    ("vertical_geo.json on ResNet56", ["--scenario", str(VERTICAL_GEO),
                                       "--tier", "small", "--rounds", "2"]),
    # (b) MobileNetV3 with top-k on the activations and their gradients
    ("vertical MobileNetV3 topk grpc", [
        "--mode", "vertical", "--backend", "grpc", "--environment",
        "geo_distributed", "--clients", "3", "--rounds", "1", "--tier",
        "medium", "--cut-layer", "2", "--activation-codec",
        f"topk:{TOPK_FRAC}"]),
)
# the messages of the two runs: batch 16 of the silos' 16x16 images
RESNET_ACTS = (16, 16, 16, 16)  # ResNet56 after unit 2 (stage 0 keeps 16x16)
ACT_ROWS = -(-math.prod(RESNET_ACTS) // (QSGD_BLOCK * qz.ROW_TILE)) \
    * qz.ROW_TILE
MOBILENET_ACTS = (16, 4, 4, 24)  # MobileNetV3 after unit 2
VERTICAL_REF_ARGV = ["--mode", "vertical", "--backend", "torch_rpc",
                     "--environment", "lan", "--clients", "2", "--rounds",
                     "1", "--batches-per-round", "2", "--activation-codec",
                     "none"]
SPLIT_TOL = 1e-5  # split == unsplit (tests/test_vertical.py)


@contextlib.contextmanager
def vertical_probe(ms: dict, seen: dict):
    """Within: every bottom forward, top step and bottom backward of the
    live vertical path is timed (synchronised wall ms, into ``ms``), the
    batches whose backward ran are counted (``seen["completed"]``), and
    the last activation and activation gradient are kept."""
    kept = {"bottom_forward": tv.SplitPlan.bottom_forward,
            "_on_activation": tv.VerticalStrategy._on_activation,
            "_on_grad": tv.VerticalStrategy._on_grad,
            "_send_grad": tv.VerticalStrategy._send_grad}
    seen["completed"] = 0

    def timed(what, fn, *args, **kw):
        synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        synchronize()
        ms.setdefault(what, []).append((time.perf_counter() - t0) * 1e3)
        return out

    def bottom_forward(plan, bottom, batch):
        acts = timed("bottom forward", kept["bottom_forward"], plan, bottom,
                     batch)
        seen["acts"] = acts.detach()
        return acts

    def on_activation(strat, now, **kw):
        return timed("top step", kept["_on_activation"], strat, now, **kw)

    def on_grad(strat, now, *, client, msg):
        key = (client.client_id, msg.round, int(msg.metadata["batch"]))
        pending = key in strat._vjp
        timed("bottom backward", kept["_on_grad"], strat, now, client=client,
              msg=msg)
        seen["completed"] += pending and key not in strat._vjp

    def send_grad(strat, now, **kw):
        seen["grad"] = kw["payload"].tree["g"]
        return kept["_send_grad"](strat, now, **kw)

    tv.SplitPlan.bottom_forward = bottom_forward
    tv.VerticalStrategy._on_activation = on_activation
    tv.VerticalStrategy._on_grad = on_grad
    tv.VerticalStrategy._send_grad = send_grad
    try:
        yield
    finally:
        tv.SplitPlan.bottom_forward = kept["bottom_forward"]
        for name in ("_on_activation", "_on_grad", "_send_grad"):
            setattr(tv.VerticalStrategy, name, kept[name])


def routed(backend):
    """The backend that carries a vertical message: AUTO routes every one
    of them (far below its 10 MB knee) to its gRPC backend."""
    return getattr(backend, "grpc", backend)


def ms_summary(xs) -> str:
    xs = sorted(xs)
    return (f"median {statistics.median(xs):.3f}, min {xs[0]:.3f}, max "
            f"{xs[-1]:.3f} over {len(xs)}")


def vertical_checks(name, sched, calls, got, seen, device) -> None:
    """Launch counts against the run, the kernels' shapes, the
    per-direction error-feedback streams, and the parties on the card."""
    strat, rep_clients = sched.strategy, sched.clients
    done = seen["completed"]
    topk = "topk" in name
    for k in KERNELS:
        expect(name, f"{k} launches vs recorded calls", got[k],
               len(calls.get(k, [])))
    # one encode per message sent and one decode per message received:
    # at least one of each per activation and per gradient that completed
    if topk:
        k = topk_k(math.prod(MOBILENET_ACTS))
        shapes = {tuple(a[0].shape) + (int(a[1]),)
                  for a, _ in calls.get("topk_rows", [])}
        if shapes != {(1, math.prod(MOBILENET_ACTS), k)}:
            raise AssertionError(f"{name}: topk_rows ran at (B, T, k) "
                                 f"{shapes}")
        expect(name, "topk_rows launches", got["topk_rows"], 2 * done,
               at_least=True)
        quiet = ("quantize_blocks", "dequantize_blocks")
    else:
        shapes = {tuple(a[0].shape) for a, _ in
                  calls.get("quantize_blocks", [])}
        if shapes != {(ACT_ROWS, QSGD_BLOCK)}:
            raise AssertionError(f"{name}: quantize_blocks ran at {shapes}")
        expect(name, "quantize_blocks launches", got["quantize_blocks"],
               2 * done, at_least=True)
        expect(name, "dequantize_blocks launches", got["dequantize_blocks"],
               2 * done, at_least=True)
        quiet = ("topk_rows",)
    # a vertical round closes on virtual records: no FedAvg
    for k in quiet + ("fedavg_reduce", "fedavg_accumulate",
                      "fedavg_reduce_q8"):
        expect(name, f"{k} launches", got[k], 0)
    # activations ride up on each party's channel (one residual stream,
    # keyed by the server), gradients down on the server's (one per party)
    for c in rep_clients:
        state = routed(c.backend).channel.compress_stage._state
        if set(state) != {"server"}:
            raise AssertionError(f"{name}: {c.client_id}'s error-feedback "
                                 f"streams are {sorted(state)}")
    down = routed(sched.backend).channel.compress_stage._state
    if set(down) != {c.client_id for c in rep_clients}:
        raise AssertionError(f"{name}: the server's error-feedback streams "
                             f"are {sorted(down)}")
    leaves = _tree.leaves((strat.live.top, strat.live.bottoms))
    if not all(l.device.type == torch.device(device).type
               and bool(torch.isfinite(l).all()) for l in leaves):
        raise AssertionError(f"{name}: a party's parameters left the card "
                             f"or are not finite")
    if strat._vjp:
        raise AssertionError(f"{name}: {len(strat._vjp)} bottom graphs "
                             f"were never released")
    losses = [e.loss for e in sched.agg_log]
    if not losses or not all(l is not None and math.isfinite(l)
                             for l in losses):
        raise AssertionError(f"{name}: losses {losses}")


def vertical_path(card: str, device, errs: dict) -> dict:
    """Phase 13: runs (a) and (b), each with every launch count at 0 just
    before it and read just after; every quantize, dequantize and
    ``topk_rows`` call held against its plain version as it returns.
    Returns each kernel's launches over both runs."""
    total = {k: 0 for k in KERNELS}
    for name, argv in VERTICAL_RUNS:
        calls, ms, seen = {}, {}, {}
        at_once = {"quantize_blocks": 0.0, "dequantize_blocks": 0.0,
                   "topk_rows": 0.0}
        fresh_run()
        t0 = time.perf_counter()
        with recording(calls, at_once), vertical_probe(ms, seen):
            rep, sched = event_run(argv, device, reduced=False)
        synchronize()
        wall = time.perf_counter() - t0
        got = launches()
        mem = memory_note()
        for k in KERNELS:
            total[k] += got[k]
        for k, e in at_once.items():
            errs[k] = max(errs[k], e)
        vertical_checks(name, sched, calls, got, seen, device)
        strat = sched.strategy
        n_batches = len(sched.clients) * strat.batches_per_round \
            * rep.n_aggregations
        if "topk" in name:  # no faults: every batch completes
            expect(name, "batches completed", seen["completed"], n_batches)
            expect(name, "aggregations", rep.n_aggregations, 1)
        else:
            expect(name, "aggregations", rep.n_aggregations, 2)
        acts, grad = seen["acts"], seen["grad"]
        want = MOBILENET_ACTS if "topk" in name else RESNET_ACTS
        if tuple(acts.shape) != want or tuple(grad.shape) != want:
            raise AssertionError(f"{name}: activations {tuple(acts.shape)}, "
                                 f"gradients {tuple(grad.shape)}")
        log(f"{name} ({type(strat.live.plan.model).__name__}, cut "
            f"{strat.cut_layer}, {len(sched.clients)} parties, "
            f"{strat.batches_per_round} batches a round): wall {wall:.3f} s; "
            f"sim_time={rep.sim_time:.4f}s aggregations="
            f"{rep.n_aggregations} (simulated round "
            f"{rep.sim_time / rep.n_aggregations:.4f} s) batches completed "
            f"{seen['completed']} of {n_batches}, discarded "
            f"{rep.n_discarded}; losses "
            f"{[round(e.loss, 4) for e in sched.agg_log]}; launches {got}; "
            f"every call held against its plain version as it returned "
            f"(max abs err {at_once}); {mem}; {card}")
        log(f"   per batch, synchronised wall ms: " + "; ".join(
            f"{what} {ms_summary(xs)}" for what, xs in ms.items()))
        fabric = sched.backend.fabric
        decisions = {}
        for be in [sched.backend] + [c.backend for c in sched.clients]:
            for mt, nb, route in getattr(be, "decisions", []):
                n, top = decisions.get(f"{mt}:{route}", (0, 0))
                decisions[f"{mt}:{route}"] = (n + 1, max(top, nb))
        off = [key for key in decisions if key.split(":")[0] in
               ("activation", "grad") and not key.endswith(":grpc")]
        if off:
            raise AssertionError(f"{name}: AUTO routed vertical messages "
                                 f"off gRPC: {decisions}")
        log(f"   wire: {dict(fabric.stats)}; AUTO's routes (count, "
            f"largest wire estimate in bytes): {decisions or 'not AUTO'}")
        # the codec's host work per message, on the run's own channels
        client = sched.clients[0]
        up = routed(client.backend).channel
        down = routed(sched.backend).channel
        enc_a = up.encode(TensorPayload({"acts": acts}), "server")
        enc_g = down.encode(TensorPayload({"g": grad}), client.client_id)
        host = {"activation encode": lambda: up.encode(
                    TensorPayload({"acts": acts}), "server"),
                "activation decode": lambda: down.decode(enc_a.wire),
                "gradient encode": lambda: down.encode(
                    TensorPayload({"g": grad}), client.client_id),
                "gradient decode": lambda: up.decode(enc_g.wire)}
        log(f"   messages: activation {tuple(acts.shape)} "
            f"{acts.numel() * 4} bytes -> wire {enc_a.wire.nbytes} bytes, "
            f"gradient {tuple(grad.shape)} -> wire {enc_g.wire.nbytes} "
            f"bytes ({up.signature()}); codec host ms, synchronised: "
            + ", ".join(f"{what} {time_host(fn):.3f}"
                        for what, fn in host.items()) + f" ({card})")
        del rep, sched, calls, seen, acts, grad, enc_a, enc_g, host
        release()
    return total


def activation_kernels(card: str) -> None:
    """The vertical path's kernels at its message shapes, held against
    their plain versions and timed cold and replayed from a CUDA graph,
    beside an empty launch under both."""
    g = torch.Generator(device="cuda").manual_seed(17)
    x = torch.relu(torch.randn(RESNET_ACTS, generator=g, device="cuda")) \
        .reshape(ACT_ROWS, QSGD_BLOCK)
    q, s = qz.quantize_blocks(x)
    hold_quantize(x, (q, s))
    hold_dequantize(q, s, torch.float32, qz.dequantize_blocks(q, s))
    n = ACT_ROWS * QSGD_BLOCK
    qbytes = 4 * n + n + 4 * ACT_ROWS
    t = math.prod(MOBILENET_ACTS)
    k = topk_k(t)
    row = torch.randn(MOBILENET_ACTS, generator=g, device="cuda") \
        .reshape(1, t)
    hold_topk(row, k, tk.topk_rows(row, k))
    cases = {
        f"quantize_blocks ({ACT_ROWS}, {QSGD_BLOCK})": (
            lambda: qz.quantize_blocks(x), lambda: qz.quantize_blocks_plain(x),
            None, qbytes, QUANT_OPS * n),
        f"dequantize_blocks ({ACT_ROWS}, {QSGD_BLOCK})": (
            lambda: qz.dequantize_blocks(q, s),
            lambda: qz.dequantize_blocks_plain(q, s),
            lambda: torch.mul(q, s), qbytes, n),
        f"topk_rows (1, {t}) k={k}": (
            lambda: tk.topk_rows(row, k), lambda: tk.topk_rows_plain(row, k),
            lambda: torch.topk(row.abs(), k), 4 * t + 8 * k, 0)}
    for what, (kern, plain, lib, nbytes, ops_) in cases.items():
        bound_ms, bound_by = bound(nbytes, ops_, card)
        library = f"{time_cold(lib):.6f}" if lib else "None"
        log(f"{what}, the vertical path's message: kernel_ms="
            f"{time_cold(kern):.6f} graph-replayed {time_graph(kern):.6f} ms; "
            f"plain_ms={time_cold(plain):.6f}; library_ms={library} "
            f"bound_ms={bound_ms:.6f} ({nbytes} bytes, {bound_by}; {card})")
    log(f"floor: an empty kernel launch: {time_cold(empty_launch):.6f} ms "
        f"cold, {time_graph(empty_launch):.6f} ms graph-replayed ({card})")


def split_grads(fn, *trees):
    """``fn(*trees)`` and its gradient, one tree per input tree."""
    flat = [_tree.flatten(t) for t in trees]
    xs = [[l.detach().requires_grad_(True) for l in ls] for ls, _ in flat]
    out = fn(*[_tree.unflatten(d, x) for x, (_, d) in zip(xs, flat)])
    grads = iter(torch.autograd.grad(out, [l for x in xs for l in x]))
    return float(out.detach()), [
        _tree.unflatten(d, [next(grads) for _ in x])
        for x, (_, d) in zip(xs, flat)]


def vertical_reference_check(device) -> None:
    """Two checks, under cuDNN's deterministic algorithms. At full width
    on the card, one batch's split loss and merged gradients against
    ``model.loss`` for ResNet56 and MobileNetV3 (cut 2), at SPLIT_TOL of
    the larger of 1 and each leaf's largest entry; then a reduced vertical
    run (2 parties, LAN, torch_rpc, no codec, 1 round of 2 batches) on the
    card against the same run on the CPU: the same event trace, and every
    bottom, the top and the losses within LEAF_RTOL of each leaf's
    largest entry, as phase 8 holds its deterministic run."""
    silo = make_silo_datasets(1, kind="image", examples_per_silo=64,
                              num_classes=8, image_size=16, seed=13)[0]
    batch = {k: torch.as_tensor(v).to(device)
             for k, v in next(silo.batches(16, seed=1)).items()}
    for model in (ResNet(ResNetConfig(), device=device),
                  MobileNetV3(MobileNetConfig(), device=device)):
        params = model.init(torch.Generator().manual_seed(13))
        plan = tv.SplitPlan(model, 2)
        with cudnn_deterministic(True):
            loss, (grads,) = split_grads(
                lambda p: model.loss(p, batch)[0], params)
            split_loss, (g_b, g_t) = split_grads(
                lambda b, t: plan.loss(b, t, batch)[0],
                *plan.split_params(params))
        merged = plan.merge_params(g_b, g_t)
        worst = max(float((a - b).abs().max()) / max(1.0, float(
            b.abs().max())) for a, b in zip(_tree.leaves(merged),
                                            _tree.leaves(grads)))
        log(f"{type(model).__name__} full width, split at unit 2 vs "
            f"unsplit on the card: loss {split_loss:.7f} vs {loss:.7f}; "
            f"merged gradients, per leaf, max {worst:.3e} of max(1, the "
            f"leaf's largest entry) (bar {SPLIT_TOL})")
        if abs(split_loss - loss) > SPLIT_TOL or worst > SPLIT_TOL:
            raise AssertionError(f"{type(model).__name__}: split != unsplit "
                                 f"on the card")
    del params, grads, merged, g_b, g_t

    cpu, cpu_sched = event_run(VERTICAL_REF_ARGV, "cpu", reduced=True)
    with cudnn_deterministic(True):
        card, card_sched = event_run(VERTICAL_REF_ARGV, device, reduced=True)
    if card_sched.loop.trace != cpu_sched.loop.trace:
        raise AssertionError("the vertical run's event trace differs between "
                             "the card and the CPU")
    got, want = card_sched.strategy.live, cpu_sched.strategy.live
    errs = leaf_errors((got.top, got.bottoms), (want.top, want.bottoms))
    to_bar = [e / max(LEAF_RTOL * m, 1e-30) for e, m in errs]
    i = max(range(len(errs)), key=to_bar.__getitem__)
    card_l = [e.loss for e in card_sched.agg_log]
    cpu_l = [e.loss for e in cpu_sched.agg_log]
    log(f"reduced vertical run, cudnn.deterministic=True, card vs CPU: "
        f"losses {card_l} vs {cpu_l}; {len(errs)} leaves of the top and "
        f"the bottoms, leaf {i} nearest its bar {LEAF_RTOL} * largest "
        f"entry: err {errs[i][0]:.3e}, largest entry {errs[i][1]:.3e}")
    if to_bar[i] > 1.0 or len(card_l) != len(cpu_l) or not all(
            math.isclose(a, b, rel_tol=LEAF_RTOL)
            for a, b in zip(card_l, cpu_l)):
        raise AssertionError("the reduced vertical run on the card disagrees "
                             "with the CPU")


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
    with ThreadPoolExecutor(max_workers=3) as pool:
        for f in [pool.submit(m.build) for m in (fr, qz, tk)]:
            f.result()
    log(f"built {', '.join(fr.SOURCES + qz.SOURCES + tk.SOURCES)} for "
        f"sm_90a")
    phase_done("2 (build)")

    rec = {"fedavg_reduce": kernel_phase(card), **new_kernels_phase(card),
           **last_kernels_phase(card)}
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
    q8_launches = q8_phase(card, device)
    phase_done("9 (fedavg_quantized)")
    mobilenet_reference_check(device)
    phase_done("10 (MobileNetV3, card against CPU)")
    large_launches = large_tier_path(card, device, errs)
    phase_done("11 (the Large tier's live path)")
    large_models_check(device)
    phase_done("12 (ViT-Large and DistilBERT, card against CPU)")
    vertical_launches = vertical_path(card, device, errs)
    activation_kernels(card)
    vertical_reference_check(device)
    phase_done("13 (vertical FL at full width)")

    # launches: over the main paths each kernel is on, each path run with
    # the counts at 0 (fedavg_reduce: the sync rounds, the event runs and
    # the Large tier's two runs; the quantize pair: the event runs, the
    # Large fedbuff run and vertical run (a); topk_rows: the event runs
    # and vertical run (b); fedavg_reduce_q8: the fedavg_quantized phase)
    path_launches = {k: event_launches[k] + large_launches[k]
                     + vertical_launches[k] for k in KERNELS}
    path_launches["fedavg_reduce"] += sync_launches
    path_launches["fedavg_reduce_q8"] += q8_launches
    sources = {"fedavg_reduce": ("fedavg_reduce.cu", "fedavg_reduce.py:42"),
               "fedavg_accumulate": ("fedavg_reduce.cu",
                                     "fedavg_reduce.py:69"),
               "quantize_blocks": ("quantize.cu", "quantize.py:45"),
               "dequantize_blocks": ("quantize.cu", "quantize.py:63"),
               "fedavg_reduce_q8": ("fedavg_reduce.cu",
                                    "fedavg_reduce.py:100"),
               "topk_rows": ("topk.cu", "topk.py:52")}
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
