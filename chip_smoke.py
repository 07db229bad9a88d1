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
   reduced vertical run on the card against the CPU;
14. the LM zoo's serving path, through ``launch/serve.generate``: (a)
   ``qwen3-8b`` (dense), ``zamba2-1.2b`` (hybrid), ``xlstm-1.3b`` (ssm)
   and ``granite-moe-1b-a400m`` (MoE) at full width in bf16 with each
   config's own remat, parameters drawn on the card from a CUDA
   generator, element counts equal to ``registry.param_count``; 8
   requests, prompt 32, gen 16 (the reference CLI's defaults); finite
   logits, tokens in range, the decode logits at the prompt's positions
   within 5e-2 of the largest |logit| of ``forward`` on the prompt
   (xLSTM's within 2.5e-1, and again in f32 from the same values made
   f32 within 1e-4);
   prefill and decode seconds, ms per decode step, tokens/s, a step's
   bytes bound and peak device memory printed; the six kernels' launch
   counts over the phase printed and asserted 0 (the path reaches none);
   (b) every causal arch's smoke config in f32, 8 decode steps, and
   ``hubert-xlarge``'s forward, card against CPU from the same parameters
   at 1e-4 of the largest logit (llama4-maverick's interleaved MoE with a
   shared expert and llama-3.2-vision's cross-attention among them);
15. the LM zoo's training path, through ``launch/train.train`` and
   ``launch/step_builders``: (a) ``zamba2-1.2b`` (hybrid) and
   ``granite-moe-1b-a400m`` (MoE) at full width and depth, bf16
   parameters drawn on the card, AdamW with f32 moments, each config's
   own remat, 16 steps of the training CLI's batch (4 x 64, lr 1e-3,
   warmup 5): finite losses that end below where they start, element
   counts equal to ``registry.param_count``; the same run stopped at
   step 8 with a checkpoint, restored by a fresh ``train`` call and run
   on, bit for bit the uninterrupted run (parameters, moments, count and
   losses) under ``torch.use_deterministic_algorithms``; ms per step,
   tokens/s, peak device memory, and ``granite-moe``'s peak under remat
   ``none``, ``dots`` and ``full``; (b) the cross-pod FL round of
   ``granite-moe-1b-a400m`` at full width, the 2 pods of
   ``MULTI_POD_MESH``'s pod axis on one card, 2 local AdamW steps a pod on
   its own 4 x 64 batches, 3 rounds exchanging int8 deltas and one
   exchanging f32 deltas: after each, every pod equals the new anchor,
   the anchor equals its plain recomputation from the pods' deltas bit for
   bit, and (int8) lies within one int8 level plus one bf16 ULP of the
   f32-mean anchor; ms per round, peak memory and the exchange's bytes in
   int8 against f32; the six kernels' launch counts over (a) and (b)
   asserted 0; (c) every arch's smoke config in f32, 3 train steps
   (qwen3-8b's again with 2 microbatches), and a 2-pod int8 FL round of
   qwen3-8b's, card against CPU with cuDNN's deterministic algorithms, at
   the CPU tests' bars (``tests/test_torch_train.py``); beside the chained
   steps, each step again on the card from the CPU run's state before it,
   every leaf at the per-leaf bar but the zero-first-gradient leaves
   (ROADMAP C4), the worst leaf printed for each step;
16. the example twins and the dry run: (a) ``examples_torch/``'s
   ``cross_silo_fl`` (three backends and the fault story), ``quickstart``
   (qwen3-8b, 40 steps, 8 tokens), ``multipod_fl_train`` (8 rounds),
   ``serve_lm`` and ``dev_smoke`` (all ten archs) on the card as written,
   with every launch count at 0 before and read after: one
   ``fedavg_reduce`` launch per round that aggregated, each held bit for
   bit against the plain version, the other five kernels 0; (b) the
   cross-silo twin's grpc+s3 flow for 2 rounds at full width (ResNet56),
   one tree-form launch a round at phase 3's shape, bit for bit; (c)
   ``launch/dryrun.run_cell`` on the host for qwen3-8b ``train_4k`` on
   16x16 and granite-moe ``train_4k``'s int8 FL round on 2x16x16 (run in
   processes of their own beside (a) and (b)), each record's per-device
   bytes, FLOPs and H100 roofline terms printed; then phase 15's
   ``zamba2-1.2b`` step counted the same way, its bound beside the
   measured step;
17. the multi-device path, over a process group of one rank a card
   (NCCL): at world size 1 (one card) (a) granite-moe's full-width int8
   FL round from one state, stacked as phase 15 (b) runs it and through
   the distributed exchange (both pods on the rank: an NCCL all-reduce
   of each leaf's max, an all-gather of its int8 levels), anchor, pods,
   moments, counts and loss bit for bit; (b) a full-width train step
   through a (1, 1) ``DeviceMesh`` bit for bit the one-device step from
   the same state; (c) the distributed checkpoint save of its parameters
   byte for byte the one-device save (the manifest and every npz
   member); world size, backend, ms, collectives and their bytes, the
   exchange's int8 against f32 bytes and peak memory printed; with 2 or
   more cards, granite-moe's smoke round with the pods on separate ranks
   against the stacked round; the six kernels' launch counts asserted 0;
18. tensor-parallel compute over ``model`` (the transformer family's split
   matmuls, vocab-parallel loss, experts over ``expert``, flash-decode
   over the cache's ``seq_kv``), over a process group of one rank a card:
   at world size 1 (a) qwen3-8b at full width in bf16, prefill of 8 x 32,
   then 32 + 16 decode steps through ``make_prefill_step`` /
   ``make_decode_step`` on a (1, 1) ``DeviceMesh``, every logit and token
   bit for bit the one-device steps', ms per generated step, collectives
   and peak memory printed; (b) granite-moe's full-width train step
   through the tensor-parallel code bit for bit the one-device step; with
   2 or more cards (c) qwen3-8b at full width on (1, n), one rank a card:
   one AdamW train step from the drawn parameters, then decode over world
   size 1's tokens, every step's logits within phase 14's bf16 bar of
   world size 1's, each rank's step ms, peak memory and collectives
   printed (on one card, a line says no cross-card run took place); the
   six kernels' launch counts asserted 0;
19. tensor-parallel compute over ``model`` for the recurrent families
   (zamba2's Mamba blocks by SSM heads and its shared block as the
   transformer's; xLSTM's mLSTM blocks over their inner channels, their
   decode state by the key dim, its sLSTM blocks by heads), over a
   process group of one rank a card: at world size 1, for ``zamba2-1.2b``
   and ``xlstm-1.3b`` at full width in bf16, (a) 12 decode steps of 8
   rows from ``init_cache`` through ``make_decode_step``, one-device,
   split, split, one-device in one process, every step's logits and the
   final state bit for bit, ms a step (host clock), one-rank collectives
   and a step's launches and device ms under ``torch.profiler``; (b) the
   train step (4 x 64) through the tensor-parallel code bit for bit the
   one-device step, then 3 warm steps of each, alternating; with 2 or
   more cards (c) each arch on (1, n) as phase 18 (c) runs qwen3-8b,
   zamba2 in bf16 and both in f32 (every decode step's logits within
   F32_BAR of world size 1's); the six kernels' launch counts asserted 0.

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
update at ``topk:0.05``, each broken down by kernel, and one ViT-Large
update, 303,236,096 entries at k = 15,161,804, timed cold and from a
graph beside ``torch.topk(x.abs(), k)``) and
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
import dataclasses
import functools
import json
import gc
import importlib.util
import math
import os
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import _dist, _tree  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.compression.stages import QsgdCodec, TopkCodec  # noqa: E402
from repro_torch.configs import ARCH_ORDER, get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import (MULTI_POD_MESH, SMOKE_MESH,  # noqa: E402
                                      FLConfig, MeshConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.configs.paper_tiers import TIERS  # noqa: E402
from repro_torch.core import TensorPayload  # noqa: E402
from repro_torch.core.channel import make_channel  # noqa: E402
from repro_torch.data import lm_batch_iterator, make_silo_datasets  # noqa: E402
from repro_torch.fl import vertical as tv  # noqa: E402
from repro_torch.fl.aggregator import fedavg, fedavg_quantized  # noqa: E402
from repro_torch.kernels import fedavg_reduce as fr  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize as qz  # noqa: E402
from repro_torch.kernels import topk as tk  # noqa: E402
from repro_torch.launch import fl_train, serve  # noqa: E402
from repro_torch.launch import step_builders as sb  # noqa: E402
from repro_torch.launch import train as lt  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_mesh,  # noqa: E402
                                     make_smoke_mesh)
from repro_torch.launch.step_builders import bundle_for  # noqa: E402
from repro_torch.models import (active_param_count, build_model,  # noqa: E402
                                param_count)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.bert import BertConfig, DistilBert  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.roofline.analysis import analyze  # noqa: E402
from repro_torch.sharding.rules import local  # noqa: E402
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
    """Equal bit for bit (integer views: torch.equal calls -0.0 equal to
    +0.0)."""
    return got.shape == want.shape and got.dtype == want.dtype \
        and torch.equal(raw(got), raw(want))


def raw(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits as same-width integers."""
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()])


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

    # one Large (ViT-Large) update at topk:0.05, timed beside its bound
    t, k = LARGE_T, topk_k(LARGE_T)
    x = torch.randn((1, t), generator=g, device="cuda") * 1e-2
    err = hold_topk(x, k, tk.topk_rows(x, k))
    rec["topk_rows"]["max_abs_err"] = max(rec["topk_rows"]["max_abs_err"],
                                          err)
    nbytes = 4 * t + 8 * k
    bound_ms, bound_by = bound(nbytes, 0, card)
    kernel_ms = time_cold(lambda: tk.topk_rows(x, k), reps=5)
    graph_ms = time_graph(lambda: tk.topk_rows(x, k), reps=3, replays=3)
    plain_ms = time_cold(lambda: tk.topk_rows_plain(x, k), reps=3)
    library_ms = time_cold(lambda: torch.topk(x.abs(), k), reps=3)
    log(f"topk_rows (1, {t}) k={k} (a Large update): idx and vals bit-exact "
        f"(vals as int32 views); kernel_ms={kernel_ms:.6f} graph-replayed "
        f"{graph_ms:.6f} ms; plain_ms={plain_ms:.6f} "
        f"library_ms={library_ms:.6f} (torch.topk(x.abs(), k)) "
        f"bound_ms={bound_ms:.6f} ({nbytes} bytes, {bound_by}; {card})")
    del x
    release()

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


# -- phase 14: the LM zoo's serving path at full width ---------------------
# serve's default (dense), examples/serve_lm.py's default (hybrid), the
# ssm and the MoE family; each through the port's serve loop at the
# reference CLI's defaults
SERVE_ARCHS = ("qwen3-8b", "zamba2-1.2b", "xlstm-1.3b",
               "granite-moe-1b-a400m")
SERVE_REQUESTS, SERVE_PROMPT, SERVE_GEN = 8, 32, 16
SERVE_BAR = 5e-2  # decode against forward, bf16, of the largest |logit|
# xLSTM's bf16 decode and forward part further at full width, in the
# reference too: on the CPU at 16 of its 48 layers the reference reads
# 1.87e-1 and the port 7.9e-2 (tests/xlstm_bf16_drift.py). An arch with a
# looser bf16 bar has its decode path held again in f32, from the same
# values made f32, at F32_BAR
SERVE_BARS = {"xlstm-1.3b": 2.5e-1}
F32_BAR = 1e-4
SMOKE_STEPS = 8


def decode_step_bytes(model, params, cache, valid: int) -> int:
    """The least bytes one decode step moves: every parameter read once,
    except an untied embedding table, of which only the requests' rows
    are read; a recurrent state read and written whole; a KV cache's
    ``valid`` slots read and one slot written; the logits written."""
    cfg = model.cfg
    b = SERVE_REQUESTS
    nbytes = sum(l.numel() * l.element_size() for l in _tree.leaves(params))
    table = params["embed"].get("embedding")
    if table is not None and not cfg.tie_embeddings:
        nbytes -= table.numel() * table.element_size()
        nbytes += b * cfg.d_model * table.element_size()
    kv = 0
    for path, leaf in _tree_items(cache):
        size = leaf.numel() * leaf.element_size()
        if path[-1] in ("k", "v"):  # (..., b, smax, hkv, hd)
            kv += size // leaf.shape[-3] * (valid + 1)
        elif path[-1] in ("xk", "xv"):  # the VLM's static image kv: read
            kv += size
        else:
            kv += 2 * size
    logit_bytes = b * cfg.vocab_size * L.dtype_of(cfg.dtype).itemsize
    return nbytes + kv + logit_bytes


def _tree_items(tree, path=()):
    """(key path, leaf) over nested dicts, lists and named tuples."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_items(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", range(len(tree)))
        for k, c in zip(fields, tree):
            yield from _tree_items(c, path + (str(k),))
    else:
        yield path, tree


def decode_against_forward(run, model, params, prompts):
    """-> (max abs err, largest |logit|, all finite) of the decode logits
    at the prompt's positions against ``forward`` on the prompt."""
    with torch.inference_mode():
        full, _ = model.forward(params, {"tokens": prompts})
    got, want = run.prompt_logits.float(), full.float()
    return (float((got - want).abs().max()), float(want.abs().max()),
            bool(torch.isfinite(got).all() and torch.isfinite(want).all()))


def serve_arch(arch: str, card: str, device) -> None:
    """One arch at full width in bf16 with its own remat: parameters drawn
    on the card, 8 requests served through ``serve.generate``, the decode
    logits at the prompt's positions held against ``forward`` on the
    prompt (for the archs in SERVE_BARS, again in f32 from the same values
    made f32)."""
    cfg = get_config(arch)
    fresh_peak()
    t0 = time.perf_counter()
    model = build_model(cfg, device=device)
    g = torch.Generator(device=device).manual_seed(14)
    params = model.init(g)
    n = sum(l.numel() for l in _tree.leaves(params))
    expect(arch, "parameters", n, param_count(cfg))
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_REQUESTS, SERVE_PROMPT),
                            generator=g, device=device)
    synchronize()
    init_s = time.perf_counter() - t0
    run = serve.generate(model, params, prompts, SERVE_GEN)
    err, top, finite = decode_against_forward(run, model, params, prompts)
    in_range = bool(((run.tokens >= 0) & (run.tokens < cfg.vocab_size)).all())
    step_ms = statistics.median(run.step_s) * 1e3
    cache = model.init_cache(SERVE_REQUESTS, SERVE_PROMPT + SERVE_GEN)
    nbytes = decode_step_bytes(model, params, cache,
                               SERVE_PROMPT + SERVE_GEN // 2)
    bound_ms = nbytes / hbm_rate(card) * 1e3
    log(f"serve {arch} ({cfg.family}) full width bf16, remat={cfg.remat}: "
        f"{n:,} parameters, {active_param_count(cfg):,} active, drawn on "
        f"the card in {init_s:.3f} s; {SERVE_REQUESTS} requests, prompt "
        f"{SERVE_PROMPT}, gen {SERVE_GEN}: prefill {run.prefill_s:.4f} s, "
        f"decode {run.decode_s:.4f} s, {step_ms:.3f} ms per decode step "
        f"(median of {SERVE_GEN}; min {min(run.step_s) * 1e3:.3f}, max "
        f"{max(run.step_s) * 1e3:.3f}), "
        f"{SERVE_REQUESTS * SERVE_GEN / run.decode_s:.1f} tokens/s; a step's "
        f"bytes bound {nbytes:,} B / {hbm_rate(card) / 1e12:.2f} TB/s = "
        f"{bound_ms:.3f} ms ({bound_ms / step_ms:.3f} of the step); "
        f"{memory_note()}")
    with torch.inference_mode():
        rows = device_breakdown(lambda: model.decode_step(
            params, cache, {"tokens": prompts[:, :1], "pos": SERVE_PROMPT}))
    busy_ms = sum(r[1] for r in rows) / 1e3
    top3 = ", ".join(f"{short_name(k)[:40]} {us:.1f} µs x {n:.0f}"
                     for k, us, n in rows[:3])
    log(f"serve {arch}: one decode step under torch.profiler: "
        f"{sum(r[2] for r in rows):.0f} kernel launches, {busy_ms:.3f} ms of "
        f"device time, {busy_ms / step_ms:.3f} of the median step (the rest "
        f"the host's launching); largest {top3}")
    bar = SERVE_BARS.get(arch, SERVE_BAR)
    log(f"serve {arch}: decode logits at the prompt's positions vs forward "
        f"on the prompt, bf16, max abs err {err:.4e}, {err / top:.4e} of the "
        f"largest |logit| {top:.4f} (bar {bar}); sample "
        f"{run.tokens[0, :8].tolist()}")
    if not finite or not in_range or err > bar * top:
        raise AssertionError(f"serve {arch}: finite {finite}, tokens in "
                             f"range {in_range}, decode vs forward {err:.4e} "
                             f"of {top:.4f}")
    del cache
    if arch not in SERVE_BARS:
        return
    bf16_logits = run.prompt_logits.float()
    del run
    cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model = build_model(cfg, device=device)
    params = _tree.map(lambda a: a.float(), params)
    fresh_peak()
    run = serve.generate(model, params, prompts, 1)
    err, top, finite = decode_against_forward(run, model, params, prompts)
    drift = float((bf16_logits - run.prompt_logits.float()).abs().max())
    log(f"serve {arch}: the same values in f32, decode logits at the "
        f"prompt's positions vs forward on the prompt, max abs err "
        f"{err:.4e}, {err / top:.4e} of the largest |logit| {top:.4f} (bar "
        f"{F32_BAR}); the bf16 decode logits vs these, {drift / top:.4e} of "
        f"it; {memory_note()}")
    if not finite or err > F32_BAR * top:
        raise AssertionError(f"serve {arch} f32: decode vs forward "
                             f"{err:.4e} of {top:.4f}")


def fresh_peak() -> None:
    """Memory returned to the card and its peak reset."""
    release()
    torch.cuda.reset_peak_memory_stats()


def serving_path(card: str, device) -> None:
    """Phase 14 (a): the four archs at full width; the six kernels' launch
    counts set to 0 before and read after, over the phase, which reaches
    none of them."""
    zero_launches()
    for arch in SERVE_ARCHS:
        serve_arch(arch, card, device)
    release()
    counts = launches()
    log(f"phase 14 launches of the six kernels: {counts}")
    if any(counts.values()):
        raise AssertionError("the LM serving path launched a FedAvg, "
                             "quantize or top-k kernel")


def serving_reference_check(device) -> None:
    """Phase 14 (b): every causal arch's smoke config in f32, 8 decode
    steps, card against CPU from the same parameters (TF32 off), each
    step's logits at 1e-4 of the CPU's largest; hubert-xlarge's forward
    the same way. llama4-maverick (interleaved MoE with a shared expert)
    and llama-3.2-vision (cross-attention) run the branches the full-width
    runs lack."""
    bar = 1e-4
    for arch in ARCH_ORDER:
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                                  param_dtype="float32")
        cpu = build_model(cfg, device="cpu")
        params = cpu.init(torch.Generator().manual_seed(15))
        card_model = build_model(cfg, device=device)
        card_params = _tree.map(lambda a: a.to(device), params)
        g = torch.Generator().manual_seed(16)
        worst = 0.0
        with torch.inference_mode():
            if not cfg.causal:
                embeds = torch.randn((2, 16, cfg.d_model), generator=g)
                want, _ = cpu.forward(params, {"embeds": embeds})
                got, _ = card_model.forward(card_params,
                                            {"embeds": embeds.to(device)})
                pairs = [(got, want)]
            else:
                tokens = torch.randint(0, cfg.vocab_size, (2, SMOKE_STEPS),
                                       generator=g)
                caches = [cpu.init_cache(2, SMOKE_STEPS),
                          card_model.init_cache(2, SMOKE_STEPS)]
                pairs = []
                for pos in range(SMOKE_STEPS):
                    t = tokens[:, pos:pos + 1]
                    want, caches[0] = cpu.decode_step(
                        params, caches[0], {"tokens": t, "pos": pos})
                    got, caches[1] = card_model.decode_step(
                        card_params, caches[1],
                        {"tokens": t.to(device), "pos": pos})
                    pairs.append((got, want))
            for got, want in pairs:
                err = float((got.cpu() - want).abs().max())
                worst = max(worst, err / float(want.abs().max()))
        what = "forward" if not cfg.causal else f"{SMOKE_STEPS} decode steps"
        log(f"smoke {arch} f32, {what}, card vs CPU: logits max abs err "
            f"{worst:.3e} of the largest (bar {bar})")
        if worst > bar:
            raise AssertionError(f"smoke {arch}: the card disagrees with the "
                                 f"CPU")


# -- phase 15: the LM zoo's training path at full width --------------------
# the hybrid and the MoE family, each small enough for AdamW's f32 moments
# on one card (qwen3-8b would need ~98 GB); the reference CLI's shape
TRAIN_ARCHS = ("zamba2-1.2b", "granite-moe-1b-a400m")
TRAIN_BATCH, TRAIN_SEQ = 4, 64
TRAIN_STEPS = 16
RESUME_AT = 8  # the resumed run's checkpoint: half way
REMAT_ARCH = "granite-moe-1b-a400m"  # its remat none / dots / full differ
REMAT_STEPS = 2
FL_ARCH = "granite-moe-1b-a400m"
FL_PODS = MULTI_POD_MESH.axis_size("pod")
FL_LOCAL = 2  # the dry run's fl_local_steps default
FL_ROUNDS = 3  # int8, then one round with the f32 exchange
POD_AXES = ("pod", "data", "model")
SMOKE_TRAIN_STEPS = 3
# the CPU tests' bars (tests/test_torch_train.py): leaves at 1e-4 of their
# largest entry; microbatched steps, whose gradients are cast to bf16, at
# one bf16 ULP; leaves whose first gradient is exactly zero, so that AdamW
# steps them next from gradients near its eps, at 1e-4 of the tree's
# largest: Zamba's LoRA (b starts at 0) and the VLM's cross-attention
# behind its gate (xgate starts at 0), ONE_STEP_WIDE in the one-step check.
# The chained 3-step run holds every leaf of the VLM ("" is in every path)
# at the tree's bar: per leaf it reads 2.0 at seg0/b1_self/attn/wo,
# inherited from step 1. There one entry's f64 gradient is -2.5e-8,
# below its leaf's f32 noise (~5.6e-8): the CPU's -1.30e-8 and the card's
# -7.57e-9 become 0.565 and 0.430 of AdamW's first step, 2.0 of the bar
# apart (the CPU's own f32 step reads 3.0 against f64's). From a common
# state every VLM leaf holds per leaf (the one-step check, which holds
# such entries within the step's lr: 0.024, 0.117 and 0.021 of the bar at
# steps 1-3 on the H100), so the card's steps are sound.
ONE_STEP_WIDE = {"zamba2-1.2b": ("lora",), "llama-3.2-vision-11b": ("xattn",)}
# one step's f32 gradient against the CPU's f64 one, of each leaf's largest
# entry: the card and the CPU read <= 1.3e-6 on four smoke archs
GRAD_BAR = 1e-5
TREE_WIDE = {"zamba2-1.2b": ("lora",), "llama-3.2-vision-11b": ("",)}
BF16_ULP = 2.0 ** -8


def train_config(steps: int, **kw) -> TrainConfig:
    """The training CLI's optimizer: AdamW, lr 1e-3, warmup 5."""
    return TrainConfig(learning_rate=1e-3, warmup_steps=5,
                       total_steps=steps, **kw)


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms`` on (warning where an op has
    no deterministic form), yielding the warnings raised; cuBLAS runs on
    one stream here, and the workspace setting only stills its check."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("default")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield caught
        finally:
            torch.use_deterministic_algorithms(False)


def quiet(*_):
    pass


def train_arch(arch: str, card: str, device, ckpt_root: str) -> float:
    """Phase 15 (a), one arch: ``launch/train.train`` at full width (bf16
    parameters drawn on the card, AdamW with f32 moments, the config's own
    remat) for TRAIN_STEPS steps of the CLI's batch; then the same run
    stopped at RESUME_AT with a checkpoint, restored by a fresh ``train``
    call and run on: bit for bit the uninterrupted run."""
    cfg = get_config(arch)
    shape = ShapeConfig("cli", TRAIN_SEQ, TRAIN_BATCH, "train")
    tcfg = train_config(TRAIN_STEPS)

    def gen():
        return torch.Generator(device=device).manual_seed(15)

    fresh_peak()
    with deterministic_algorithms() as caught:
        t0 = time.perf_counter()
        whole = lt.train(cfg, shape, tcfg, TRAIN_STEPS, device=device,
                         generator=gen(), log=quiet)
        whole_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        n = sum(l.numel() for l in _tree.leaves(whole.params))
        expect(arch, "parameters", n, param_count(cfg))
        state_bytes = sum(l.numel() * l.element_size()
                          for l in _tree.leaves((whole.params,
                                                 whole.opt_state)))
        step_ms = statistics.median(whole.step_s[1:]) * 1e3
        ls = whole.losses
        log(f"train {arch} ({cfg.family}) full width, bf16 parameters, "
            f"AdamW f32 moments, remat={cfg.remat}: {n:,} parameters, "
            f"{state_bytes:,} B of parameters and moments; "
            f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} in "
            f"{whole_s:.3f} s wall (model, draw and steps); step 0 "
            f"{whole.step_s[0] * 1e3:.3f} ms, then {step_ms:.3f} ms per step "
            f"(median; min {min(whole.step_s[1:]) * 1e3:.3f}, max "
            f"{max(whole.step_s[1:]) * 1e3:.3f}), "
            f"{TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3:.1f} tokens/s; loss "
            f"{ls[0]:.4f} -> {ls[-1]:.4f} (min {min(ls):.4f}); peak device "
            f"memory {peak / 2 ** 30:.3f} GiB")
        # each step's loss is on its own batch, and they spread by ~0.1
        # (zamba2 at full width on the H100: 10.716 -> 10.723, min 10.651):
        # learning is read on one batch, the first, before and after
        model = build_model(cfg, device=device)
        batch0 = lt.lm_batch(cfg, next(lm_batch_iterator(
            0, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)), 0, device)
        with torch.no_grad():
            after = float(model.loss(whole.params, batch0)[0])
        log(f"train {arch}: loss on the first batch {ls[0]:.4f} at the start, "
            f"{after:.4f} after the {TRAIN_STEPS} steps")
        if not all(math.isfinite(x) for x in ls) or not after < ls[0]:
            raise AssertionError(f"train {arch}: losses {ls}, the first "
                                 f"batch's after the run {after}")
        d = tempfile.mkdtemp(prefix=f"ckpt-{arch}-", dir=ckpt_root)
        try:
            t0 = time.perf_counter()
            first = lt.train(cfg, shape, tcfg, RESUME_AT, ckpt_dir=d,
                             ckpt_every=RESUME_AT, device=device,
                             generator=gen(), log=quiet)
            first_s = time.perf_counter() - t0
            first_losses, first_steps = first.losses, sum(first.step_s)
            disk = sum(f.stat().st_size for f in Path(d).rglob("*")
                       if f.is_file())
            del first
            release()
            t0 = time.perf_counter()
            rest = lt.train(cfg, shape, tcfg, TRAIN_STEPS, ckpt_dir=d,
                            ckpt_every=TRAIN_STEPS + 1, device=device,
                            generator=torch.Generator(
                                device=device).manual_seed(99), log=quiet)
            rest_s = time.perf_counter() - t0
        finally:
            shutil.rmtree(d, ignore_errors=True)
        pairs = list(zip(_tree.leaves((rest.params, rest.opt_state)),
                         _tree.leaves((whole.params, whole.opt_state))))
        same = all(bits_equal(a, b) for a, b in pairs)
        worst = max(float((a.float() - b.float()).abs().max())
                    for a, b in pairs if a.is_floating_point())
    ops_ = sorted({str(w.message).split(" does not have")[0]
                   for w in caught if "deterministic" in str(w.message)})
    log(f"train {arch}: resumed run ({RESUME_AT} steps, a checkpoint of "
        f"{disk:,} B, a fresh train call restoring it, "
        f"{TRAIN_STEPS - RESUME_AT} more steps) vs the uninterrupted run, "
        f"under "
        f"torch.use_deterministic_algorithms: parameters, moments and count "
        f"bit for bit {same} (max abs diff {worst:.3e}); losses equal "
        f"{first_losses + rest.losses == whole.losses}; wall {first_s:.3f} s "
        f"to step {RESUME_AT} with the save ({first_s - first_steps:.3f} s "
        f"besides the steps: model, draw, save), {rest_s:.3f} s from the "
        f"restore on ({rest_s - sum(rest.step_s):.3f} s besides the steps: "
        f"model, draw, restore); ops that "
        f"warned for want of a deterministic form: {ops_ or 'none'}")
    if not same or first_losses + rest.losses != whole.losses \
            or rest.start_step != RESUME_AT:
        raise AssertionError(f"train {arch}: the resumed run differs")
    del rest, pairs
    release()
    profile_step(arch, cfg, shape, tcfg, whole, device)
    del whole
    release()
    return step_ms


def profile_step(arch, cfg, shape, tcfg, run, device) -> None:
    """One more training step from the run's end state under
    ``torch.profiler``: launches, device time and its share of the step."""
    bundle = sb.make_train_step(cfg, shape, make_smoke_mesh(device),
                                SMOKE_MESH, tcfg)
    data = lm_batch_iterator(1, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)
    batch = {k: torch.from_numpy(v).to(device) for k, v in next(data).items()}
    step_ms = statistics.median(run.step_s[1:]) * 1e3
    rows = device_breakdown(lambda: bundle.fn(run.params, run.opt_state,
                                              batch, TRAIN_STEPS), reps=2)
    busy_ms = sum(r[1] for r in rows) / 1e3
    top3 = ", ".join(f"{short_name(k)[:40]} {us / 1e3:.3f} ms x {n:.0f}"
                     for k, us, n in rows[:3])
    log(f"train {arch}: one step under torch.profiler: "
        f"{sum(r[2] for r in rows):.0f} kernel launches, {busy_ms:.3f} ms of "
        f"device time, {busy_ms / step_ms:.3f} of the median step; largest "
        f"{top3}")


def remat_memory(card: str, device) -> None:
    """Phase 15 (a): REMAT_ARCH's loss and gradients at full width (the
    part of a step remat changes; the optimizer's update, whose old and
    new states set the step's peak, is the same under each) by remat
    policy: the peak device memory above the parameters, and ms."""
    cfg = get_config(REMAT_ARCH)
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(15))
    data = lm_batch_iterator(0, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)
    batch = {k: torch.from_numpy(v).to(device) for k, v in next(data).items()}
    base = torch.cuda.memory_allocated()
    out = []
    for policy in ("none", "dots", "full"):
        model = build_model(dataclasses.replace(cfg, remat=policy),
                            device=device)
        ms = []
        for _ in range(REMAT_STEPS + 1):
            release()
            torch.cuda.reset_peak_memory_stats()
            synchronize()
            t0 = time.perf_counter()
            loss, grads = sb.value_and_grad(model, params, batch)
            synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            del loss, grads
        peak = torch.cuda.max_memory_allocated() - base
        out.append(f"{policy} {peak / 2 ** 30:.3f} GiB ({ms[-1]:.3f} ms)")
    log(f"train {REMAT_ARCH}: loss and gradients at {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, peak device memory above the {base / 2 ** 30:.3f} GiB "
        f"of parameters (gradients and activations) and ms, by remat policy: "
        f"{'; '.join(out)}")
    del params
    release()


def exchange_expected(a0, pre, compression: str):
    """The round's new anchor leaf done again from the pods' own deltas,
    plainly: the max, the rounding and the int32 sum (int8), or the f32
    mean; and, for int8, the level (``scale``)."""
    delta = pre.float() - a0.float()[None]
    if compression != "int8":
        return (a0.float() + delta.sum(0) / pre.shape[0]).to(a0.dtype), None
    scale = delta.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(delta / scale), -127, 127).to(torch.int32)
    mean = q.sum(0).float() * scale / pre.shape[0]
    return (a0.float() + mean).to(a0.dtype), scale


def fl_round_checks(anchor, pre, new_anchor, stacked, compression) -> float:
    """-> the largest distance from the f32-mean anchor in levels (int8).
    Raises unless every pod equals the new anchor and each leaf equals
    its plain recomputation bit for bit; with int8, each entry within one
    level plus one bf16 ULP of the f32-mean anchor, rounded as the anchor
    is."""
    worst = 0.0
    for a0, p, na, s in zip(_tree.leaves(anchor), pre,
                            _tree.leaves(new_anchor), _tree.leaves(stacked)):
        want, scale = exchange_expected(a0, p, compression)
        if not bits_equal(na, want):
            raise AssertionError("fl_round: the anchor differs from its plain "
                                 "recomputation")
        if not all(torch.equal(s[i], na) for i in range(s.shape[0])):
            raise AssertionError("fl_round: a pod differs from the anchor")
        if scale is None:
            continue
        mean32 = (a0.float() + (p.float() - a0.float()[None]).mean(0)).to(
            na.dtype).float()
        ulp = torch.where(mean32 == 0, torch.zeros_like(mean32),
                          torch.finfo(na.dtype).eps * 2.0 ** torch.floor(
                              torch.log2(mean32.abs())))
        err = (na.float() - mean32).abs() - ulp
        worst = max(worst, float(err.max()) / float(scale))
        if worst > 1.0:
            raise AssertionError(f"fl_round: {worst:.3f} levels from the f32 "
                                 "mean")
    return worst


def fl_round_path(card: str, device) -> None:
    """Phase 15 (b): ``make_fl_round_step`` on FL_ARCH at full width, the
    pod axis of MULTI_POD_MESH (2 pods) on one card, FL_LOCAL AdamW steps a
    pod a round on its own TRAIN_BATCH x TRAIN_SEQ batches; FL_ROUNDS
    rounds exchanging int8 deltas, then one exchanging f32 deltas."""
    cfg = get_config(FL_ARCH)
    shape = ShapeConfig("fl", TRAIN_SEQ, TRAIN_BATCH * FL_PODS, "train")
    mesh = make_mesh(MeshConfig((1, 1, 1), POD_AXES), device)
    bundles = {c: bundle_for("fl_round", cfg, shape, mesh, MULTI_POD_MESH,
                             train_config(FL_ROUNDS + 1,
                                          crosspod_compression=c),
                             local_steps=FL_LOCAL)
               for c in ("int8", "none")}
    fresh_peak()
    model = bundles["int8"].model
    anchor = model.init(torch.Generator(device=device).manual_seed(15))
    stacked = sb.stack_pods(anchor, FL_PODS)
    opt = sb.stack_pods(adamw_init(anchor, TrainConfig()), FL_PODS)
    data = lm_batch_iterator(15, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)
    n = sum(l.numel() for l in _tree.leaves(anchor))
    n_leaves = len(_tree.leaves(anchor))
    for rnd in range(FL_ROUNDS + 1):
        comp = "int8" if rnd < FL_ROUNDS else "none"
        fn = bundles[comp].fn
        per = [[next(data) for _ in range(FL_LOCAL)] for _ in range(FL_PODS)]
        batches = {k: torch.stack([torch.stack(
            [torch.from_numpy(per[i][j][k]) for j in range(FL_LOCAL)])
            for i in range(FL_PODS)]).to(device) for k in per[0][0]}
        synchronize()
        t0 = time.perf_counter()
        stacked, opt, loss = fn.local_steps(stacked, opt, batches, rnd)
        synchronize()
        local_s = time.perf_counter() - t0
        pre = [l.clone() for l in _tree.leaves(stacked)]
        synchronize()
        t0 = time.perf_counter()
        stacked, new_anchor = fn.exchange(anchor, stacked)
        synchronize()
        exchange_s = time.perf_counter() - t0
        levels = fl_round_checks(anchor, pre, new_anchor, stacked, comp)
        del pre
        sent = (FL_PODS * n + 4 * n_leaves if comp == "int8"
                else 4 * FL_PODS * n)
        log(f"fl_round {FL_ARCH} round {rnd} ({comp}): {FL_PODS} pods x "
            f"{FL_LOCAL} local steps in {local_s * 1e3:.3f} ms, exchange "
            f"{exchange_s * 1e3:.3f} ms, {(local_s + exchange_s) * 1e3:.3f} "
            f"ms the round; loss {float(loss):.4f}; every pod equal to the "
            f"new anchor, the anchor bit for bit its plain recomputation"
            + (f", within {levels:.3f} int8 level (+1 bf16 ULP) of the f32 "
               f"mean" if comp == "int8" else "")
            + f"; the exchange would carry {sent:,} B ({FL_PODS} x {n:,} "
            + ("int8 + 4 B a leaf's scale x "
               f"{n_leaves}, against {4 * FL_PODS * n:,} B in f32)"
               if comp == "int8" else "f32)")
            + f"; counts {opt.count.tolist()}")
        if opt.count.tolist() != [FL_LOCAL * (rnd + 1)] * FL_PODS:
            raise AssertionError("fl_round: the optimizer state was reset")
        anchor = new_anchor
    log(f"fl_round {FL_ARCH}: {memory_note()}")
    del anchor, stacked, opt, new_anchor, bundles, model
    release()


def training_path(card: str, device) -> dict:
    """Phase 15 (a) and (b); the six kernels' launch counts set to 0 before
    and read after, over both, which reach none of them. -> each arch's
    median ms per step."""
    zero_launches()
    ckpt_root = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    step_ms = {}
    try:
        for arch in TRAIN_ARCHS:
            step_ms[arch] = train_arch(arch, card, device, ckpt_root)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    remat_memory(card, device)
    fl_round_path(card, device)
    counts = launches()
    log(f"phase 15 launches of the six kernels: {counts}")
    if any(counts.values()):
        raise AssertionError("the LM training path launched a FedAvg, "
                             "quantize or top-k kernel")
    return step_ms


def smoke_batches(cfg, n: int, b: int, s: int, seed: int):
    """``n`` seeded batches on the host: tokens (or f32 frame embeddings),
    the VLM's image embeddings, targets."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        batch = {}
        if cfg.external_embeddings:
            batch["embeds"] = torch.randn((b, s, cfg.d_model), generator=g)
        else:
            batch["tokens"] = torch.randint(0, cfg.vocab_size, (b, s),
                                            generator=g, dtype=torch.int32)
        if cfg.family == "vlm":
            batch["image_embeds"] = torch.randn(
                (b, cfg.num_image_tokens, cfg.d_model), generator=g)
        batch["targets"] = torch.randint(0, cfg.vocab_size, (b, s),
                                         generator=g, dtype=torch.int32)
        out.append(batch)
    return out


def leaves_within(got_tree, want_tree, bar: float, wide=()):
    """-> (the worst error over the leaves as a share of the bar, that
    leaf's path): the bar times each leaf's largest entry, or the tree's
    for a leaf whose path holds one of ``wide``. Above 1 fails."""
    got = {"/".join(p): l for p, l in _tree_items(got_tree)}
    want = {"/".join(p): l for p, l in _tree_items(want_tree)}
    top = max(float(w.float().abs().max()) for w in want.values())
    worst = (0.0, "")
    for path, w in want.items():
        g = got[path].cpu().float()
        w = w.float()
        scale = top if any(x in path for x in wide) else \
            float(w.abs().max())
        err = float((g - w).abs().max())
        share = err / (bar * scale) if scale else \
            (0.0 if err == 0 else math.inf)
        worst = max(worst, (share, path))
    return worst


def train_steps(bundle, params, tcfg, batches, device):
    """``len(batches)`` train steps on ``device`` from ``params`` -> (the
    state (parameters, optimizer state) before each step and after the
    last, [(loss, gnorm)])."""
    p = _tree.map(lambda a: a.to(device), params)
    o = adamw_init(p, tcfg)
    states, metrics = [(p, o)], []
    for step, batch in enumerate(batches):
        p, o, m = bundle.fn(p, o, {k: v.to(device) for k, v in
                                   batch.items()}, step)
        states.append((p, o))
        metrics.append((float(m["loss"]), float(m["gnorm"])))
    return states, metrics


def state_within(got, want, bar: float, wide=()):
    """``leaves_within`` over a train state's parameters and both moments."""
    (gp, go), (wp, wo) = got, want
    return max(leaves_within(gp, wp, bar, wide),
               leaves_within(go.m, wo.m, bar, wide),
               leaves_within(go.v, wo.v, bar, wide))


def f64_of(tree):
    return _tree.map(lambda a: a.double() if a.is_floating_point() else a,
                     tree)


def gradients(cfg, params, batch, device):
    """The gradient tree of ``cfg``'s model at ``params`` on ``batch``,
    on ``device``."""
    model = build_model(cfg, device=device)
    _, g = sb.value_and_grad(
        model, _tree.map(lambda a: a.to(device), params),
        {k: v.to(device) for k, v in batch.items()})
    return g


def grad_within(got, want):
    """-> (the worst leaf's error against the f64 gradient ``want`` as a
    share of GRAD_BAR times that leaf's largest entry, its path)."""
    worst = (0.0, "")
    for (path, g), (_, w) in zip(_tree_items(got), _tree_items(want)):
        err = float((g.detach().cpu().double() - w).abs().max())
        scale = float(w.abs().max())
        share = err / (GRAD_BAR * scale) if scale else \
            (0.0 if err == 0 else math.inf)
        worst = max(worst, (share, "/".join(path)))
    return worst


def params_within(got, want, g64, lr: float, bar: float, wide=()):
    """``leaves_within`` over parameters, but an entry whose f64 gradient
    lies within GRAD_BAR of its leaf's largest of zero is held within the
    step's ``lr`` instead: AdamW's eps-sized denominator turns that
    gradient's f32 noise into a share of a step, on any two f32 devices.
    -> (worst share, its path, the entries held so)."""
    top = max(float(w.float().abs().max()) for _, w in _tree_items(want))
    worst, held = (0.0, ""), 0
    for (path, g), (_, w), (_, d) in zip(_tree_items(got), _tree_items(want),
                                         _tree_items(g64)):
        path = "/".join(path)
        diff = (g.detach().cpu().float() - w.float()).abs()
        near = d.abs() <= GRAD_BAR * float(d.abs().max())
        held += int(near.sum())
        if bool((diff[near] > lr).any()):
            worst = max(worst, (math.inf, path))
        scale = top if any(x in path for x in wide) else \
            float(w.float().abs().max())
        err = float(torch.where(near, 0.0, diff).max())
        share = err / (bar * scale) if scale else \
            (0.0 if err == 0 else math.inf)
        worst = max(worst, (share, path))
    return worst[0], worst[1], held


def one_step_readings(cfg, bundle, states, batches, device, bar: float,
                      wide=()):
    """ROADMAP C4's check, from a run's state before each step (``states``,
    as ``train_steps`` returns them) -> per step:

    - ``grad``: that step's gradient on ``device`` against the CPU's f64
      gradient, every leaf at GRAD_BAR of its largest entry (``cpu``: the
      CPU's f32 gradient read the same way, for scale);
    - ``step``: that one step on ``device`` against the run's own next
      state: both moments at ``bar`` of each leaf's largest entry
      (``wide``'s leaves: the tree's), the parameters too except the
      entries ``params_within`` holds within the step's lr (``held``).

    Each reading is (the worst leaf's share of its bar, its path)."""
    cfg64 = dataclasses.replace(cfg, dtype="float64", param_dtype="float64")
    out = []
    for step, batch in enumerate(batches):
        (p0, o0), (p1, o1) = states[step], states[step + 1]
        g64 = gradients(cfg64, f64_of(p0), f64_of(batch), "cpu")
        p, o = (_tree.map(lambda a: a.to(device), t) for t in (p0, o0))
        p, o, m = bundle.fn(p, o, {k: v.to(device) for k, v in
                                   batch.items()}, step)
        share, path, held = params_within(p, p1, g64, float(m["lr"]), bar,
                                          wide)
        out.append({
            "grad": grad_within(gradients(cfg, p0, batch, device), g64),
            "cpu": grad_within(gradients(cfg, p0, batch, "cpu"), g64),
            "step": max((share, path), leaves_within(o.m, o1.m, bar, wide),
                        leaves_within(o.v, o1.v, bar, wide)),
            "held": held})
    return out


def training_reference_check(device) -> None:
    """Phase 15 (c): every arch's smoke config in f32, SMOKE_TRAIN_STEPS
    train steps (qwen3-8b's again with 2 microbatches), card against CPU
    from the same parameters and batches, with cuDNN's deterministic
    algorithms: parameters and both moments at 1e-4 of each leaf's
    largest entry (the CPU tests' bars, TREE_WIDE and BF16_ULP included),
    loss and gnorm at 1e-5. Beside the chained run (one microbatch), each
    step again on the card from the CPU run's state before it
    (``one_step_readings``, ROADMAP C4): its gradient against the CPU's
    f64 one at GRAD_BAR, every leaf; the step against the CPU's at the
    per-leaf bar, ONE_STEP_WIDE's leaves at the tree's and entries with a
    gradient within GRAD_BAR of zero within the step's lr. Then one 2-pod int8
    FL round of qwen3-8b's smoke config the same way, the anchor within
    one int8 level plus 1e-4 of each leaf's largest entry."""
    shape = ShapeConfig("t", 16, 4, "train")
    runs = [(a, 1) for a in ARCH_ORDER] + [("qwen3-8b", 2)]
    with cudnn_deterministic(True):
        for arch, micro in runs:
            cfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                                      param_dtype="float32")
            tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2,
                               total_steps=10, microbatches=micro)
            params = build_model(cfg, device="cpu").init(
                torch.Generator().manual_seed(17))
            batches = smoke_batches(cfg, SMOKE_TRAIN_STEPS, 4, 16, 18)
            cpu_b, card_b = (bundle_for("train", cfg, shape,
                                        make_smoke_mesh(dev), SMOKE_MESH,
                                        tcfg) for dev in ("cpu", device))
            cpu_states, cm = train_steps(cpu_b, params, tcfg, batches, "cpu")
            card_states, gm = train_steps(card_b, params, tcfg, batches,
                                          device)
            bar = BF16_ULP if micro > 1 else 1e-4
            wide = TREE_WIDE.get(arch, ())
            worst, where = state_within(card_states[-1], cpu_states[-1], bar,
                                        wide)
            scope = ""
            if wide:
                scope = f"; {', '.join(wide) or 'every leaf'} of the tree's"
            metric_err = max(abs(g - c) / abs(c) for gs, cs in zip(gm, cm)
                             for g, c in zip(gs, cs))
            one_wide = ONE_STEP_WIDE.get(arch, ())
            # one microbatch: the ten archs; a microbatched step casts its
            # gradients to bf16, whose ULP is up to 2^-7 of a leaf's largest
            steps = [] if micro > 1 else one_step_readings(
                cfg, card_b, cpu_states, batches, device, bar, one_wide)
            one_scope = f"; {', '.join(one_wide)} of the tree's" \
                if one_wide else ""
            log(f"smoke train {arch} f32, {SMOKE_TRAIN_STEPS} steps"
                f"{', 2 microbatches' if micro > 1 else ''}, card vs CPU: "
                f"parameters and moments at {worst:.3e} of the bar ({bar} of "
                f"each leaf's largest entry{scope}), worst at {where}; loss "
                f"and gnorm "
                f"{metric_err:.3e} relative (bar 1e-5)")
            for k, r in enumerate(steps):
                log(f"  one step {k + 1} from the CPU's state: gradient, card "
                    f"vs CPU f64, {r['grad'][0]:.3e} of {GRAD_BAR} of each "
                    f"leaf's largest at {r['grad'][1]} (the CPU's f32 "
                    f"{r['cpu'][0]:.3e} at {r['cpu'][1]}); the step, card vs "
                    f"CPU, {r['step'][0]:.3e} of the bar (each leaf's"
                    f"{one_scope}) at {r['step'][1]}, {r['held']} entries "
                    f"with a gradient within {GRAD_BAR} of zero held within "
                    f"the step's lr")
            if worst > 1.0 or metric_err > 1e-5:
                raise AssertionError(f"smoke train {arch}: the card disagrees "
                                     "with the CPU")
            if max((max(r["grad"][0], r["step"][0]) for r in steps),
                   default=0.0) > 1.0:
                raise AssertionError(f"smoke train {arch}: one step on the "
                                     "card from the CPU's state disagrees "
                                     "with the CPU's step or its gradient "
                                     "with the f64 one")
        fl_round_reference_check(device)


def fl_round_reference_check(device) -> None:
    cfg = dataclasses.replace(smoke_config("qwen3-8b"), dtype="float32",
                              param_dtype="float32")
    shape = ShapeConfig("t", 16, 4, "train")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                       crosspod_compression="int8")
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(19))
    batch = smoke_batches(cfg, 1, FL_PODS * FL_LOCAL * 2, 16, 20)[0]
    batch = {k: v.reshape((FL_PODS, FL_LOCAL, 2) + v.shape[1:])
             for k, v in batch.items()}
    out = []
    for dev in ("cpu", device):
        b = bundle_for("fl_round", cfg, shape,
                       make_mesh(MeshConfig((1, 1, 1), POD_AXES), dev),
                       MeshConfig((FL_PODS, 1, 1), POD_AXES), tcfg,
                       local_steps=FL_LOCAL)
        a = _tree.map(lambda x: x.to(dev), params)
        ps, o = sb.stack_pods(a, FL_PODS), sb.stack_pods(
            adamw_init(a, tcfg), FL_PODS)
        ps, o, pre_loss = b.fn.local_steps(ps, o, {k: v.to(dev) for k, v in
                                                   batch.items()}, 0)
        deltas = [(l.float() - x.float()[None]) for l, x in
                  zip(_tree.leaves(ps), _tree.leaves(a))]
        ps, anchor = b.fn.exchange(a, ps)
        out.append((anchor, o, deltas, float(pre_loss)))
    (ca, co, cd, cl), (ga, go, _, gl) = out
    worst = 0.0
    for c, g, d in zip(_tree.leaves(ca), _tree.leaves(ga), cd):
        level = float(d.abs().max()) / 127.0
        err = float((g.cpu() - c).abs().max())
        worst = max(worst, err / (level + 1e-4 * float(c.abs().max())))
    opt_worst, _ = max(leaves_within(go.m, co.m, 1e-4),
                       leaves_within(go.v, co.v, 1e-4))
    log(f"smoke fl_round qwen3-8b f32, {FL_PODS} pods x {FL_LOCAL} local "
        f"steps, int8, card vs CPU: anchor at {worst:.3e} of one level + 1e-4 "
        f"of each leaf's largest entry, moments at {opt_worst:.3e} of 1e-4 of "
        f"each leaf's largest; loss {gl:.6f} / {cl:.6f}")
    if worst > 1.0 or opt_worst > 1.0 or abs(gl - cl) > 1e-5 * abs(cl):
        raise AssertionError("smoke fl_round: the card disagrees with the CPU")


# -- phase 16: the example twins and the dry run ---------------------------
TWINS = ROOT / "examples_torch"
# the dry run's cells on the card machine's host: a training cell on one
# pod and the int8 FL round across two
DRY_CELLS = (("qwen3-8b", "train_4k", False, False, ""),
             ("granite-moe-1b-a400m", "train_4k", True, True, "int8"))
DRY_SCRIPT = """
import json, sys
from repro_torch.launch import dryrun
arch, shape, multi, fl, comp = json.loads(sys.argv[1])
rec = dryrun.run_cell(arch, shape, multi_pod=multi, fl=fl, fl_compress=comp,
                      out_dir=sys.argv[2], verbose=False)
print(json.dumps(rec))
"""


def load_twin(name: str):
    """``examples_torch/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"twin_{name}",
                                                  TWINS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def start_dry_runs(out_dir: str) -> list:
    """Each DRY_CELLS cell's ``dryrun.run_cell`` in a process of its own on
    the host (it traces on ``meta`` tensors and launches nothing), started
    before the twins run on the card."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return [(cell, time.perf_counter(), subprocess.Popen(
        [sys.executable, "-c", DRY_SCRIPT, json.dumps(cell), out_dir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for cell in DRY_CELLS]


def held_fedavg(calls: dict, what: str) -> None:
    """Every recorded FedAvg call held against the plain version: bit for
    bit, else fail."""
    err = max((hold_reduce(args, got) for args, got in
               calls.get("fedavg_reduce", [])), default=0.0)
    if err != 0.0:
        raise AssertionError(f"{what}: FedAvg differs from the plain version "
                             f"by {err:.3e}")


def twins_path(device) -> int:
    """Phase 16 (a): the five twins as written, on the card, with every
    launch count at 0 before and read after; -> fedavg_reduce's launches,
    asserted equal to the rounds that aggregated (the other five read 0),
    each held bit for bit against the plain version."""
    zero_launches()
    calls = {}
    twin = load_twin("cross_silo_fl")
    with recording(calls):
        out, fault = twin.run(device)
    reps = [r for backend in twin.BACKENDS for r in out[backend]]
    reps += [rep for rep, _ in fault.values()]
    # a round averages what its quorum counted, an MPI round marked aborted
    # too (fl/server.py, as the reference's)
    aggregated = sum(r.n_participants > 0 for r in reps)
    counts = launches()
    expect("cross_silo_fl", "fedavg_reduce launches",
           counts["fedavg_reduce"], aggregated)
    expect("cross_silo_fl", "recorded FedAvg calls",
           len(calls.get("fedavg_reduce", [])), aggregated)
    held_fedavg(calls, "cross_silo_fl")
    (mpi, _), (s3, _) = fault["mpi_generic"], fault["grpc+s3"]
    if not mpi.aborted or s3.aborted or s3.n_participants != SILOS - 2:
        raise AssertionError("cross_silo_fl: the fault story differs")
    log(f"twin cross_silo_fl: {aggregated} rounds aggregated, each one "
        f"tree-form fedavg_reduce launch bit for bit its plain version")

    losses, tokens = load_twin("quickstart").run("qwen3-8b", device=device)
    if not losses[-1] < losses[0] or len(tokens) != 8:
        raise AssertionError(f"quickstart: losses {losses[0]} -> "
                             f"{losses[-1]}, tokens {tokens}")
    log(f"twin quickstart qwen3-8b: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"in {len(losses)} steps; greedy decode {tokens}")
    for name, argv in (("multipod_fl_train", []), ("serve_lm", []),
                       ("dev_smoke", [])):
        t0 = time.perf_counter()
        if load_twin(name).main(argv + ["--device", str(device)]) != 0:
            raise AssertionError(f"{name} exited non-zero")
        log(f"twin {name}: ok in {time.perf_counter() - t0:.3f} s")
    counts = launches()
    log(f"phase 16 (a) launches of the six kernels: {counts}")
    if counts["fedavg_reduce"] != aggregated or any(
            v for k, v in counts.items() if k != "fedavg_reduce"):
        raise AssertionError("the twins launched a kernel beyond FedAvg's "
                             "one a round")
    return aggregated


def cross_silo_full_width(device) -> int:
    """Phase 16 (b): the cross-silo twin's grpc+s3 flow for ROUNDS rounds
    at full width (ResNet56), each round's FedAvg one tree-form launch at
    phase 3's shape, bit for bit its plain version."""
    twin = load_twin("cross_silo_fl")
    zero_launches()
    t0 = time.perf_counter()
    server, params, store = twin.deploy("grpc+s3", device=device,
                                        reduced=False)
    calls = {}
    with recording(calls):
        reps, params = twin.train_rounds(server, params, ROUNDS)
    wall = time.perf_counter() - t0
    n = sum(l.numel() for l in _tree.leaves(params))
    expect("cross_silo_fl full width", "parameters", n, MAIN_T)
    expect("cross_silo_fl full width", "fedavg_reduce launches",
           launches()["fedavg_reduce"], ROUNDS)
    shapes = {reduce_shape(args) for args, _ in calls["fedavg_reduce"]}
    if len(calls["fedavg_reduce"]) != ROUNDS or \
            shapes != {(MAIN_N, MAIN_T, MAIN_LEAVES)}:
        raise AssertionError(f"cross_silo_fl full width: FedAvg at {shapes}")
    held_fedavg(calls, "cross_silo_fl full width")
    if any(v for k, v in launches().items() if k != "fedavg_reduce"):
        raise AssertionError("cross_silo_fl full width: a kernel beyond "
                             "FedAvg launched")
    log(f"twin cross_silo_fl grpc+s3 full width ({n:,} parameters): "
        f"{ROUNDS} rounds in {wall:.3f} s wall (deployment included), round "
        f"{reps[-1].round_time:.4f} s sim, loss {reps[0].losses:.4f} -> "
        f"{reps[-1].losses:.4f}; FedAvg at (N, T, leaves) "
        f"{(MAIN_N, MAIN_T, MAIN_LEAVES)}, one launch a round, bit for bit "
        f"its plain version; store {dict(store.stats)}")
    return ROUNDS


def roofline_line(rl, mem) -> str:
    return (f"args {mem['argument_bytes']:,} B, outputs "
            f"{mem['output_bytes']:,} B, temp (estimate) "
            f"{mem['temp_bytes']:,} B a device; {rl['flops']:.4e} FLOPs a "
            f"device (model {rl['model_flops']:.4e} in all); compute "
            f"{rl['t_compute'] * 1e3:.3f} ms, memory "
            f"{rl['t_memory'] * 1e3:.3f} ms, ICI "
            f"{rl['t_collective'] * 1e3:.3f} ms, DCN "
            f"{rl['t_dcn'] * 1e3:.3f} ms -> {rl['dominant']}-bound")


def dry_run_path(procs, step_ms: dict) -> None:
    """Phase 16 (c): the dry-run cells' records, then phase 15's
    ``zamba2-1.2b`` step counted the same way, its bound beside the step
    phase 15 measured (not a gate: that step is host-bound)."""
    for cell, t0, proc in procs:
        out, err = proc.communicate(timeout=900)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"dry run {cell}: {err[-2000:]}")
        rec = json.loads(out.strip().splitlines()[-1])
        if rec["status"] != "ok":
            raise AssertionError(f"dry run {cell}: {rec.get('error')}")
        line = roofline_line(rec["roofline"], rec["memory_analysis"])
        log(f"dry run {rec['arch']} {rec['shape']}"
            f"{' fl ' + rec['fl_compress'] if rec['fl'] else ''} "
            f"@{rec['mesh']}: {line}; {rec['compile_s']} s to build and "
            f"count ({secs:.1f} s wall); DCN "
            f"{rec['roofline']['coll_dcn_bytes']:,.0f} B a device")
    arch = "zamba2-1.2b"
    cfg = get_config(arch)
    shape = ShapeConfig("cli", TRAIN_SEQ, TRAIN_BATCH, "train")
    tcfg = train_config(TRAIN_STEPS)
    mesh = Mesh(SMOKE_MESH.axis_names, SMOKE_MESH.shape, torch.device("meta"))
    t0 = time.perf_counter()
    bundle = bundle_for("train", cfg, shape, mesh, SMOKE_MESH, tcfg)
    c = dryrun.count(bundle, "train", cfg, shape, SMOKE_MESH, tcfg)
    rl = analyze(flops=c["flops"], memory=c["memory"],
                 collectives=c["collectives"], arch=arch, shape=shape,
                 kind="train", mesh_name="1x1", chips=1, cfg=cfg).to_dict()
    bound_ms = rl["bound_time"] * 1e3
    log(f"roofline of phase 15's {arch} step ({TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"bf16, 1x1, H100 SXM data sheet): {roofline_line(rl, c['memory'])}; "
        f"bound {bound_ms:.3f} ms against the measured {step_ms[arch]:.3f} ms "
        f"median step ({bound_ms / step_ms[arch]:.4f} of it; counted in "
        f"{time.perf_counter() - t0:.1f} s)")


def examples_path(device, step_ms: dict) -> int:
    """Phase 16; -> its fedavg_reduce launches, each held bit for bit."""
    out_dir = tempfile.mkdtemp(prefix="chip-smoke-dryrun-")
    procs = start_dry_runs(out_dir)
    try:
        n = twins_path(device)
        n += cross_silo_full_width(device)
        dry_run_path(procs, step_ms)
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    return n


# -- phase 17: the multi-device path ----------------------------------------
# granite-moe at full width, as phase 15 (b) and (a) run it, through a
# process group over NCCL: at world size 1 (a machine with one card) each
# result is held bit for bit against the one-device code from the same
# state; with 2 or more cards the pods also run on separate ranks
DIST_ARCH = FL_ARCH
# one rank of the cross-card round: FL_ARCH's smoke config in f32, one
# int8 round on a (2, 1, world / 2) mesh; rank 0 writes the gathered anchor
RANK_SCRIPT = """
import dataclasses, json, sys
import torch
from repro_torch import _dist, _tree
from repro_torch.configs import smoke_config
from repro_torch.configs.base import MeshConfig, ShapeConfig, TrainConfig
from repro_torch.data import lm_batch_iterator
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.step_builders import bundle_for, stack_pods
from repro_torch.optim import adamw_init
from repro_torch.sharding import gather_tree
arch, rank, world, init, out, dev, local = json.loads(sys.argv[1])
cfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                          param_dtype="float32")
_dist.init(dev, rank=rank, world_size=world, init_file=init)
names = ("pod", "data", "model")
shape3 = (2, 1, world // 2)
tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=5, total_steps=4,
                   crosspod_compression="int8")
b = bundle_for("fl_round", cfg, ShapeConfig("fl", 32, 8, "train"),
               make_mesh(MeshConfig(shape3, names), dev),
               MeshConfig(shape3, names), tcfg, local_steps=local)
params = b.model.init(torch.Generator().manual_seed(17))
it = lm_batch_iterator(17, 4, 32, cfg.vocab_size)
per = [[next(it) for _ in range(local)] for _ in range(2)]
batches = {k: torch.stack([torch.stack([torch.from_numpy(per[i][j][k])
                                        for j in range(local)])
                           for i in range(2)]) for k in per[0][0]}
stacked, opt = stack_pods(params, 2), stack_pods(adamw_init(params, tcfg), 2)
_, _, anchor, loss = b.fn(stacked, opt, params, batches, 0)
anchor = gather_tree(anchor)
if rank == 0:
    torch.save({"anchor": [l.cpu() for l in _tree.leaves(anchor)],
                "loss": float(loss)}, out)
_dist.shutdown()
"""


@contextlib.contextmanager
def recording_collectives(log: list):
    """``torch.distributed``'s all_reduce, all_gather,
    all_gather_into_tensor and reduce_scatter_tensor, each call noted as
    (name, dtype, payload bytes a rank sends)."""
    import torch.distributed as dist
    orig = {n: getattr(dist, n) for n in ("all_reduce", "all_gather",
                                          "all_gather_into_tensor",
                                          "reduce_scatter_tensor")}

    def wrap(name):
        def call(*args, **kw):
            t = args[1] if name != "all_reduce" else args[0]
            log.append((name, str(t.dtype), t.numel() * t.element_size()))
            return orig[name](*args, **kw)
        return call

    for n in orig:
        setattr(dist, n, wrap(n))
    try:
        yield
    finally:
        for n, f in orig.items():
            setattr(dist, n, f)


def collective_note(log: list) -> str:
    by = {}
    for name, dtype, nbytes in log:
        c, b = by.get((name, dtype), (0, 0))
        by[(name, dtype)] = (c + 1, b + nbytes)
    return "; ".join(f"{n} {d}: {c} calls, {b:,} B" for (n, d), (c, b)
                     in sorted(by.items())) or "none"


def checkpoint_bytes(step_dir: Path) -> tuple:
    """The manifest's bytes and each npz member's (name, bytes), in order:
    the zip headers also hold the write time."""
    import zipfile
    with zipfile.ZipFile(step_dir / "arrays.npz") as z:
        members = [(n, z.read(n)) for n in z.namelist()]
    return (step_dir / "manifest.json").read_bytes(), members


def dist_fl_round(card: str, device, bundles: dict) -> None:
    """Phase 17 (a): phase 15 (b)'s full-width int8 round from one state,
    once stacked on the card and once through the distributed exchange
    (both pods on this rank; NCCL's all_reduce of each leaf's max and
    all-gather of its int8 levels): bit for bit the same."""
    import torch.distributed as dist
    cfg = get_config(DIST_ARCH)
    model = bundles["stacked"].model
    fresh_peak()
    anchor = model.init(torch.Generator(device=device).manual_seed(15))
    data = lm_batch_iterator(15, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)
    per = [[next(data) for _ in range(FL_LOCAL)] for _ in range(FL_PODS)]
    batches = {k: torch.stack([torch.stack(
        [torch.from_numpy(per[i][j][k]) for j in range(FL_LOCAL)])
        for i in range(FL_PODS)]).to(device) for k in per[0][0]}
    n = sum(l.numel() for l in _tree.leaves(anchor))
    want = None
    for name in ("stacked", "distributed"):
        fn = bundles[name].fn
        stacked = sb.stack_pods(anchor, FL_PODS)
        opt = sb.stack_pods(adamw_init(anchor, TrainConfig()), FL_PODS)
        torch.cuda.reset_peak_memory_stats()
        calls, ex_calls = [], []
        with deterministic_algorithms():
            with recording_collectives(calls):
                synchronize()
                t0 = time.perf_counter()
                stacked, opt, loss = fn.local_steps(stacked, opt, batches, 0)
                synchronize()
            t1 = time.perf_counter()
            with recording_collectives(ex_calls):
                stacked, new_anchor = fn.exchange(anchor, stacked)
                synchronize()
            t2 = time.perf_counter()
        na = [local(l) for l in _tree.leaves(new_anchor)]
        pods = [local(l) for l in _tree.leaves(stacked)]
        if not all(torch.equal(p[i], a) for p, a in zip(pods, na)
                   for i in range(p.shape[0])):
            raise AssertionError(f"phase 17 (a) {name}: a pod differs from "
                                 "the new anchor")
        moments = [local(l) for l in _tree.leaves((opt.m, opt.v))]
        log(f"phase 17 (a) {DIST_ARCH} int8 round, {name}"
            + (f" (world size {dist.get_world_size()}, "
               f"{dist.get_backend()})" if name == "distributed" else "")
            + f": {FL_PODS} pods x {FL_LOCAL} local steps "
            f"{(t1 - t0) * 1e3:.3f} ms, exchange {(t2 - t1) * 1e3:.3f} ms, "
            f"{(t2 - t0) * 1e3:.3f} ms the round; loss {float(loss):.6f}; "
            f"collectives: local steps {collective_note(calls)}, exchange "
            f"{collective_note(ex_calls)}; the pod all-gather "
            f"carries {FL_PODS * n:,} B of int8 levels (f32 deltas: "
            f"{4 * FL_PODS * n:,} B); {memory_note()} ({card})")
        if name == "stacked":
            want = ([a.cpu() for a in na], [m.cpu() for m in moments],
                    float(loss), local(opt.count).tolist())
        else:
            got = (na, moments, float(loss), local(opt.count).tolist())
            gathers = [c for c in ex_calls if c[0] == "all_gather"]
            if not gathers or any(c[1] != "torch.int8" for c in gathers):
                raise AssertionError(f"phase 17 (a): the exchange gathered "
                                     f"{gathers[:3]}, not int8 levels")
            same = all(bits_equal(g, w.to(device)) for g, w in
                       zip(got[0] + got[1], want[0] + want[1]))
            if not (same and got[2:] == want[2:]):
                raise AssertionError("phase 17 (a): the distributed round "
                                     "differs from the stacked one")
            log(f"phase 17 (a): the distributed round's anchor, pods, "
                f"moments, counts and loss bit for bit the stacked round's")
        del stacked, opt, new_anchor, na, pods, moments
        release()
    del anchor, want, got, batches
    release()


def dist_train_step(card: str, device, ckpt_root: str) -> None:
    """Phase 17 (b), (c): phase 15 (a)'s full-width train step from one
    state, on the one-device mesh and through a (1, 1) DeviceMesh, bit for
    bit; then the parameters saved by the distributed save (gathered,
    written by rank 0) and by the one-device save, byte for byte."""
    cfg = get_config(DIST_ARCH)
    shape = ShapeConfig("cli", TRAIN_SEQ, TRAIN_BATCH, "train")
    tcfg = train_config(TRAIN_STEPS)
    one = Mesh(SMOKE_MESH.axis_names, SMOKE_MESH.shape, device)
    mesh = make_mesh(SMOKE_MESH, device.type)
    plain = bundle_for("train", cfg, shape, one, SMOKE_MESH, tcfg)
    dist_b = bundle_for("train", cfg, shape, mesh, SMOKE_MESH, tcfg)
    fresh_peak()
    params = plain.model.init(torch.Generator(device=device).manual_seed(15))
    opt = adamw_init(params, tcfg)
    batch = lt.lm_batch(cfg, next(lm_batch_iterator(
        0, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)), 0, device)
    out, ms = {}, {}
    for name, b in (("one-device", plain), ("distributed", dist_b)):
        calls = []
        with deterministic_algorithms(), recording_collectives(calls):
            synchronize()
            t0 = time.perf_counter()
            out[name] = b.fn(params, opt, batch, 0)
            synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
        log(f"phase 17 (b) {DIST_ARCH} train step, {name}: "
            f"{ms[name]:.3f} ms (step 0: autograd's first pass included), "
            f"loss {float(out[name][2]['loss']):.6f}, gnorm "
            f"{float(out[name][2]['gnorm']):.6f}; collectives: "
            f"{collective_note(calls)}; {memory_note()} ({card})")
    (p1, o1, m1), (p2, o2, m2) = out["one-device"], out["distributed"]
    same = all(bits_equal(local(b), a) for a, b in zip(
        _tree.leaves((p1, o1)), _tree.leaves((p2, o2))))
    same &= all(bits_equal(m2[k], m1[k]) for k in ("loss", "gnorm", "lr"))
    if not same:
        raise AssertionError("phase 17 (b): the step through the DeviceMesh "
                             "differs from the one-device step")
    log("phase 17 (b): parameters, moments, count, loss, gnorm and lr bit "
        "for bit the one-device step's")
    del params, opt, o1, o2, out
    release()
    secs = {}
    for name, tree in (("one-device", p1), ("distributed", p2)):
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(ckpt_root, name), 1, tree)
        secs[name] = time.perf_counter() - t0
    a, b = (checkpoint_bytes(Path(ckpt_root) / name / "step_000000001")
            for name in ("one-device", "distributed"))
    nbytes = sum(len(m) for _, m in a[1])
    if a != b:
        raise AssertionError("phase 17 (c): the distributed save differs "
                             "from the one-device save")
    log(f"phase 17 (c): the distributed save of {DIST_ARCH}'s parameters "
        f"({nbytes:,} B of npz members) byte for byte the one-device save "
        f"(manifest and every member); {secs['distributed']:.3f} s against "
        f"{secs['one-device']:.3f} s")
    del p1, p2
    release()


def pods_across_cards(card: str, n_cards: int, device) -> None:
    """Phase 17 with 2 or more cards: FL_ARCH's smoke round with the 2 pods
    on separate ranks, one process a card, over NCCL; its anchor held
    against the round stacked on card 0 from the same state, at the CPU
    tests' bar (one int8 level plus 1e-4 of each leaf's largest entry)."""
    world = n_cards - n_cards % 2
    tmp = tempfile.mkdtemp(prefix="chip-smoke-ranks-")
    try:
        out = os.path.join(tmp, "anchor.pt")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT, json.dumps(
                [DIST_ARCH, r, world, os.path.join(tmp, "init"), out,
                 device.type, FL_LOCAL])],
            env=dict(env, LOCAL_RANK=str(r))) for r in range(world)]
        try:
            rcs = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(rcs):
            raise AssertionError(f"phase 17: the {world} ranks exited {rcs}")
        got = torch.load(out)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cfg = dataclasses.replace(smoke_config(DIST_ARCH), dtype="float32",
                              param_dtype="float32")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=5, total_steps=4,
                       crosspod_compression="int8")
    b = bundle_for("fl_round", cfg, ShapeConfig("fl", 32, 8, "train"),
                   Mesh(POD_AXES, (1, 1, 1), device),
                   MeshConfig((2, 1, world // 2), POD_AXES), tcfg,
                   local_steps=FL_LOCAL)
    params = b.model.init(torch.Generator().manual_seed(17))
    it = lm_batch_iterator(17, 4, 32, cfg.vocab_size)
    per = [[next(it) for _ in range(FL_LOCAL)] for _ in range(2)]
    batches = {k: torch.stack([torch.stack(
        [torch.from_numpy(per[i][j][k]) for j in range(FL_LOCAL)])
        for i in range(2)]).to(device) for k in per[0][0]}
    stacked = sb.stack_pods(params, 2)
    opt = sb.stack_pods(adamw_init(params, tcfg), 2)
    stacked, opt, loss = b.fn.local_steps(stacked, opt, batches, 0)
    pre = _tree.leaves(stacked)
    _, anchor = b.fn.exchange(params, stacked)
    worst = 0.0
    for a0, p, want, g in zip(_tree.leaves(params), pre,
                              _tree.leaves(anchor), got["anchor"]):
        level = float((p.float() - a0.float()[None]).abs().max()) / 127
        err = float((g.to(device) - want).abs().max())
        bar = level + 1e-4 * float(want.abs().max())
        worst = max(worst, err / bar if bar else err)
        if err > bar:
            raise AssertionError(f"phase 17 across {world} cards: anchor "
                                 f"{err:.3e} from the stacked round's, bar "
                                 f"{bar:.3e}")
    log(f"phase 17 across {world} cards ({card}): {DIST_ARCH} smoke int8 "
        f"round, pods on separate ranks over {_dist.backend_for(device)}, "
        f"{wall:.3f} s wall with "
        f"the ranks' start; loss {got['loss']:.6f} (stacked "
        f"{float(loss):.6f}); anchor within {worst:.3f} of the bar of the "
        f"stacked round's")


def multi_device_path(card: str, device) -> None:
    """Phase 17: a process group of one rank over NCCL on this card for
    (a)-(c); then, with 2 or more cards, the pods across cards."""
    import torch.distributed as dist
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 1
    cfg = get_config(DIST_ARCH)
    shape = ShapeConfig("fl", TRAIN_SEQ, TRAIN_BATCH * FL_PODS, "train")
    tcfg = train_config(FL_ROUNDS + 1, crosspod_compression="int8")
    # the stacked bundle is phase 15 (b)'s: its mesh made before the group
    one = make_mesh(MeshConfig((1, 1, 1), POD_AXES), device)
    bundles = {"stacked": bundle_for("fl_round", cfg, shape, one,
                                     MULTI_POD_MESH, tcfg,
                                     local_steps=FL_LOCAL)}
    tmp = tempfile.mkdtemp(prefix="chip-smoke-dist-")
    t0 = time.perf_counter()
    _dist.init(device.type, rank=0, world_size=1,
               init_file=os.path.join(tmp, "init"))
    try:
        mesh = make_mesh(MeshConfig((1, 1, 1), POD_AXES), device.type)
        log(f"phase 17: world size {dist.get_world_size()}, backend "
            f"{dist.get_backend()}, mesh {mesh.shape} over {mesh.axis_names} "
            f"on {mesh.device} ({n_cards} card(s), {card}); group and mesh "
            f"up in {time.perf_counter() - t0:.3f} s")
        bundles["distributed"] = bundle_for(
            "fl_round", cfg, shape, mesh, MULTI_POD_MESH, tcfg,
            local_steps=FL_LOCAL)
        dist_fl_round(card, device, bundles)
        del bundles
        release()
        dist_train_step(card, device, tmp)
    finally:
        _dist.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    if n_cards >= 2:
        pods_across_cards(card, n_cards, device)
    else:
        log("phase 17: one card, so no rank-to-rank exchange ran (NCCL "
            "takes one rank a card)")


# -- phase 18: tensor-parallel compute over model ---------------------------
# the transformer family's train step, prefill and decode through the
# tensor-parallel code (sharding/tensor_parallel.py): at world size 1
# every split is whole and every collective a one-rank call, so each is
# held bit for bit against the one-device code; with 2 or more cards,
# qwen3-8b at full width on (1, n), one rank a card
TP_SERVE_ARCH = "qwen3-8b"  # phase 14's width
TP_TRAIN_ARCH = DIST_ARCH  # phase 17 (b)'s step
TP_SEED = 18
TP_TRAIN_TIMED = 3  # phase 18 (b)'s timed steps of each variant
# one rank of the cross-card run: TP_SERVE_ARCH at full width on (1,
# world): one train step from the drawn parameters, then the decode steps
# on the tokens world size 1 took; each rank writes its readings, rank 0
# the gathered logits too
TP_RANK_SCRIPT = """
import dataclasses, json, sys, time
import torch
from repro_torch import _dist
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import MeshConfig, ShapeConfig, TrainConfig
from repro_torch.data import lm_batch_iterator
from repro_torch.launch import train as lt
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.step_builders import bundle_for
from repro_torch.optim import adamw_init
from repro_torch.sharding import gather, place_tree
from chip_smoke import recording_collectives
(arch, rank, world, init, tokens_in, out, smoke, seed,
 f32) = json.loads(sys.argv[1])
dev = _dist.init("cuda" if torch.cuda.is_available() and not smoke
                 else "cpu", rank=rank, world_size=world, init_file=init)
torch.backends.cuda.matmul.allow_tf32 = False
cfg = smoke_config(arch) if smoke else get_config(arch)
if f32:
    cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
names = ("data", "model")
mcfg = MeshConfig((1, world), names)
mesh = make_mesh(mcfg, dev.type)
cuda = dev.type == "cuda"
train_calls, calls = [], []
def sync():
    if cuda:
        torch.cuda.synchronize()
def peak():
    return torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
tokens = torch.load(tokens_in).to(dev)
b, total = tokens.shape
tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=5, total_steps=16)
tb = bundle_for("train", cfg, ShapeConfig("t", 64, 4, "train"), mesh, mcfg,
                tcfg)
g = torch.Generator(device=dev).manual_seed(seed)
params = place_tree(tb.model.init(g), tb.in_placements[0])
if cuda:
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
opt = adamw_init(params, tcfg)
batch = lt.lm_batch(cfg, next(lm_batch_iterator(0, 4, 64, cfg.vocab_size)),
                    0, dev)
with recording_collectives(train_calls):
    sync()
    t0 = time.perf_counter()
    _, _, m = tb.fn(params, opt, batch, 0)
    sync()
train_ms = (time.perf_counter() - t0) * 1e3
del opt, _
train_peak = peak()
if cuda:
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
db = bundle_for("decode", cfg, ShapeConfig("d", total, b, "decode"), mesh,
                mcfg)
cache = db.model.init_cache(b, total)
logits, step_s = [], []
with recording_collectives(calls):
    for pos in range(total):
        sync()
        t1 = time.perf_counter()
        lg, cache = db.fn(params, cache, {"tokens": tokens[:, pos:pos + 1],
                                          "pos": pos})
        lg = gather(lg)
        sync()
        step_s.append(time.perf_counter() - t1)
        logits.append(lg.cpu())
rec = {"rank": rank, "device": str(dev), "loss": float(m["loss"]),
       "gnorm": float(m["gnorm"]), "train_ms": train_ms,
       "train_peak_gib": train_peak, "decode_peak_gib": peak(),
       "decode_ms": sorted(step_s)[len(step_s) // 2] * 1e3,
       "train_calls": train_calls, "decode_calls": calls,
       "record": {k: len(v) for k, v in tb.tp_record.items()}}
torch.save({"rec": rec, "logits": logits if rank == 0 else None},
           out.format(rank=rank))
_dist.shutdown()
"""


def tp_record_note(bundle) -> str:
    rec = bundle.tp_record
    return (f"{len(rec['split'])} leaves split over model, "
            f"{len(rec['gathered'])} gathered (rule 1)")


def serve_steps(prefill, decode, params, prompts) -> dict:
    """Prefill ``prompts`` through ``prefill``, then every prompt position
    through ``decode`` (filling the cache, as ``serve.generate`` does),
    then SERVE_GEN greedy steps: -> the prefill's logits, every decode
    step's logits, the tokens fed and the generated steps' ms."""
    b, plen = prompts.shape
    last = local(prefill.fn(params, {"tokens": prompts}))
    cache = decode.model.init_cache(b, plen + SERVE_GEN)
    logits, step_s, fed = [], [], [prompts]
    for pos in range(plen + SERVE_GEN):
        tok = prompts[:, pos:pos + 1] if pos < plen else fed[-1]
        synchronize()
        t0 = time.perf_counter()
        lg, cache = decode.fn(params, cache, {"tokens": tok, "pos": pos})
        lg = local(lg)
        nxt = torch.argmax(lg.reshape(b, -1), dim=-1,
                           keepdim=True).to(torch.int32)
        synchronize()
        if pos >= plen:
            step_s.append(time.perf_counter() - t0)
        logits.append(lg)
        if pos >= plen - 1 and pos < plen + SERVE_GEN - 1:
            fed.append(nxt)
    return {"prefill": last, "logits": logits,
            "tokens": torch.cat(fed, dim=1), "step_ms": step_s}


def tp_serving(card: str, smi: str, device, join):
    """Phase 18 (a): TP_SERVE_ARCH at full width in bf16, prefill then
    the prompt's and SERVE_GEN decode steps through make_prefill_step /
    make_decode_step, on the one-device mesh and through the
    tensor-parallel code on the mesh ``join()`` makes (the one-rank
    group; world size 1), from one state: bit for bit. The one-device
    steps run first before the group exists, then inside it alternating
    with the split steps (one-device, split, split, one-device); each run
    takes the prompt's steps untimed, then SERVE_GEN timed. Phase 14's
    loop (``serve.generate``) runs before the group and in it too. ->
    (the tokens fed, for the cross-card run; the mesh)."""
    cfg = get_config(TP_SERVE_ARCH)
    plen = SERVE_PROMPT
    one = Mesh(SMOKE_MESH.axis_names, SMOKE_MESH.shape, device)
    fresh_peak()
    g = torch.Generator(device=device).manual_seed(TP_SEED)

    def bundles_on(m):
        return (bundle_for("prefill", cfg, ShapeConfig(
            "p", plen, SERVE_REQUESTS, "prefill"), m, SMOKE_MESH),
            bundle_for("decode", cfg, ShapeConfig(
                "d", plen + SERVE_GEN, SERVE_REQUESTS, "decode"), m,
                SMOKE_MESH))

    solo = bundles_on(one)
    params = solo[0].model.init(g)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_REQUESTS, plen),
                            generator=g, device=device, dtype=torch.int32)
    step_s, runs, mesh = {}, [], None

    def generate(label):
        run = serve.generate(solo[1].model, params, prompts, SERVE_GEN)
        step_s.setdefault(label, []).extend(run.step_s)

    def bundle_run(label, pb, db):
        calls, first = [], label not in step_s
        torch.cuda.reset_peak_memory_stats()
        with recording_collectives(calls):
            run = serve_steps(pb, db, params, prompts)
        runs.append(run)
        step_s.setdefault(label, []).extend(run["step_ms"])
        if first and mesh is not None:  # each variant's first in the group
            ms = statistics.median(run["step_ms"]) * 1e3
            note = (f"{tp_record_note(pb)}; collectives: "
                    f"{collective_note(calls)}; "
                    f"{tp_host_costs(db, params, mesh, calls, plen + SERVE_GEN)}"
                    f"; " if pb.tp_record else "")
            log(f"phase 18 (a) {TP_SERVE_ARCH} full width bf16, {label}: "
                f"{note}{decode_profile(db, params, prompts, ms)}; "
                f"{memory_note()} ({smi})")

    generate("serve.generate, before the group")
    bundle_run("one-device, before the group", *solo)
    mesh = join()
    split = bundles_on(mesh)
    for label, bs in (("one-device", solo), ("tensor-parallel", split),
                      ("tensor-parallel", split), ("one-device", solo)):
        bundle_run(label, *bs)
    generate("serve.generate, in the group")
    for label, t in step_s.items():
        log(f"phase 18 (a) {TP_SERVE_ARCH}, {label}: prefill of "
            f"{SERVE_REQUESTS} x {plen}, then {plen} + {SERVE_GEN} decode "
            f"steps; {statistics.median(t) * 1e3:.3f} ms per generated "
            f"step (median of {len(t)}; min {min(t) * 1e3:.3f}, max "
            f"{max(t) * 1e3:.3f}), "
            f"{SERVE_REQUESTS * len(t) / sum(t):.1f} tokens/s ({smi})")
    a = runs[0]
    same = all(bits_equal(b["prefill"], a["prefill"]) and all(
        bits_equal(x, y) for x, y in zip(b["logits"], a["logits"]))
        and torch.equal(b["tokens"], a["tokens"]) for b in runs[1:])
    if not same:
        raise AssertionError("phase 18 (a): prefill or decode through the "
                             "tensor-parallel code differs from the "
                             "one-device steps")
    log(f"phase 18 (a): the prefill's logits, every decode step's logits "
        f"and the generated tokens of all {len(runs)} runs bit for bit "
        f"the first one-device run's (sample "
        f"{a['tokens'][0, plen:plen + 8].tolist()})")
    tokens = a["tokens"].cpu()
    del params, runs, a, solo, split
    release()
    return tokens, mesh


def tp_host_costs(decode, params, mesh, calls: list, steps: int) -> str:
    """What the tensor-parallel decode step adds on the host at world size
    1: laying the parameters out and gathering them for compute (each
    step does it), and the one-rank collectives at the step's shapes,
    each timed over 100 calls; -> a note with their sum over a step's
    calls (``calls``: the run's collectives, over ``steps`` steps)."""
    from repro_torch.sharding import tensor_parallel as tpar
    cfg, tp = decode.model.cfg, tpar.model_group(mesh)
    x = torch.zeros((SERVE_REQUESTS, 1, cfg.d_model), dtype=torch.bfloat16,
                    device=mesh.device)
    heads = cfg.num_heads + 2 * cfg.num_kv_heads
    y = torch.zeros((1, SERVE_REQUESTS, 1, heads, cfg.head_dim),
                    dtype=torch.bfloat16, device=mesh.device)
    lay = sb._Compute(decode.model, mesh)

    def layout():
        lay.placed_params(params, decode.in_placements[0])

    us = {name: time_host(fn, reps=100) * 1e3 for name, fn in (
        ("layout", layout),
        ("all_reduce", lambda: tpar.all_reduce_f32(x, tp.group)),
        ("all_gather", lambda: tpar.gather_from(y, tp, 0)),
        ("add", lambda: x + x))}
    n = {k: sum(1 for c in calls if c[0].startswith(k)) / steps
         for k in ("all_reduce", "all_gather")}
    total = (us["layout"] + n["all_reduce"] * us["all_reduce"]
             + n["all_gather"] * us["all_gather"]) / 1e3
    return (f"host µs: the parameters' layout and gather {us['layout']:.1f}"
            f" a step, a one-rank all_reduce (f32 round trip) "
            f"{us['all_reduce']:.1f}, all_gather {us['all_gather']:.1f}, "
            f"an add {us['add']:.1f}; with {n['all_reduce']:.1f} all_reduce"
            f" and {n['all_gather']:.1f} all_gather calls a step: "
            f"{total:.3f} ms a step")


def decode_profile(decode, params, prompts, step_ms: float) -> str:
    """One decode step of ``decode`` (at the prompt's end, on a fresh
    cache) under ``torch.profiler``: its kernel launches, device ms and
    their share of ``step_ms``."""
    b, plen = prompts.shape
    cache = decode.model.init_cache(b, plen + SERVE_GEN)
    rows = device_breakdown(lambda: decode.fn(
        params, cache, {"tokens": prompts[:, -1:], "pos": plen}))
    busy = sum(r[1] for r in rows) / 1e3
    del cache
    return (f"one step under torch.profiler: {sum(r[2] for r in rows):.0f} "
            f"kernel launches, {busy:.3f} ms of device time, "
            f"{busy / step_ms:.3f} of the median step")


def tp_training(card: str, smi: str, device, mesh, arch: str = TP_TRAIN_ARCH,
                phase: str = "18 (b)") -> None:
    """Phase 18 (b) (and 19 (b) for ``arch``): ``arch``'s full-width train
    step (phase 15 (a)'s shape) on the one-device mesh and through the
    tensor-parallel code on ``mesh`` (world size 1), from one state: bit
    for bit. Each variant's first step warms it and is the one compared;
    then TP_TRAIN_TIMED steps of each from the same state, in the order
    split, one-device, one-device, split, ..., their median reported."""
    cfg = get_config(arch)
    shape = ShapeConfig("cli", TRAIN_SEQ, TRAIN_BATCH, "train")
    tcfg = train_config(TRAIN_STEPS)
    one = Mesh(SMOKE_MESH.axis_names, SMOKE_MESH.shape, device)
    bundles = {name: bundle_for("train", cfg, shape, m, SMOKE_MESH, tcfg)
               for name, m in (("one-device", one),
                               ("tensor-parallel", mesh))}
    fresh_peak()
    params = bundles["one-device"].model.init(
        torch.Generator(device=device).manual_seed(TP_SEED))
    opt = adamw_init(params, tcfg)
    batch = lt.lm_batch(cfg, next(lm_batch_iterator(
        0, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)), 0, device)
    out, ms = {}, {name: [] for name in bundles}

    def step(name):
        with deterministic_algorithms():
            synchronize()
            t0 = time.perf_counter()
            got = bundles[name].fn(params, opt, batch, 0)
            synchronize()
        return got, (time.perf_counter() - t0) * 1e3

    for name, b in bundles.items():
        calls = []
        with recording_collectives(calls):
            out[name], warm = step(name)
        note = (f"; {tp_record_note(b)}" if b.tp_record else "")
        log(f"phase {phase} {arch} train step, {name}: {warm:.3f} ms "
            f"(its first step), loss {float(out[name][2]['loss']):.6f}, "
            f"gnorm {float(out[name][2]['gnorm']):.6f}{note}; collectives: "
            f"{collective_note(calls)}; {memory_note()} ({smi})")
    (p1, o1, m1), (p2, o2, m2) = out["one-device"], out["tensor-parallel"]
    same = all(bits_equal(local(y), x) for x, y in zip(
        _tree.leaves((p1, o1)), _tree.leaves((p2, o2))))
    same &= all(bits_equal(m2[k], m1[k]) for k in ("loss", "gnorm", "lr"))
    del out, p1, o1, p2, o2  # the timed steps' outputs need the room
    release()
    if not same:
        raise AssertionError(f"phase {phase}: the train step through the "
                             "tensor-parallel code differs from the "
                             "one-device step")
    log(f"phase {phase}: {arch}'s parameters, moments, count, loss, gnorm "
        f"and lr bit for bit the one-device step's")
    order = ("tensor-parallel", "one-device", "one-device", "tensor-parallel")
    for i in range(TP_TRAIN_TIMED):
        for name in (order[:2] if i % 2 == 0 else order[2:]):
            ms[name].append(step(name)[1])
    for name, t in ms.items():
        log(f"phase {phase} {arch} train step, {name}: "
            f"{statistics.median(t):.3f} ms (median of {len(t)} warm steps "
            f"from one state, the variants alternating: "
            f"{', '.join(f'{x:.3f}' for x in t)}) ({smi})")
    del params, opt
    release()


def tp_across_cards(card: str, n_cards: int, device, tokens,
                    smoke: bool = False, arch: str = TP_SERVE_ARCH,
                    phase: str = "18 (c)", f32: bool = False) -> None:
    """Phase 18 (c) (and 19 (c) for ``arch``), with 2 or more cards:
    ``arch`` at full width on (1, n), one rank a card over NCCL: one train
    step (AdamW from the drawn parameters), then decode over ``tokens``
    (world size 1's tokens), every step's logits held against world size
    1's at phase 14's bf16 bar for ``arch`` (``f32``: the config in f32,
    at F32_BAR). ``smoke``: its smoke config (a rehearsal)."""
    label = f"{arch} {'f32' if f32 else 'bf16'}"
    tmp = tempfile.mkdtemp(prefix="chip-smoke-tp-")
    world = n_cards
    try:
        tokens_in = os.path.join(tmp, "tokens.pt")
        torch.save(tokens, tokens_in)
        out = os.path.join(tmp, "rank{rank}.pt")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            (str(ROOT / "src"), str(ROOT))))
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", TP_RANK_SCRIPT, json.dumps(
                [arch, r, world, os.path.join(tmp, "init"),
                 tokens_in, out, smoke, TP_SEED, f32])],
            env=dict(env, LOCAL_RANK=str(r))) for r in range(world)]
        try:
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(rcs):
            raise AssertionError(f"phase {phase}: the {world} ranks exited "
                                 f"{rcs}")
        wall = time.perf_counter() - t0
        got = [torch.load(out.format(rank=r)) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for g in got:
        r = g["rec"]
        log(f"phase {phase} rank {r['rank']} of {world} ({r['device']}, "
            f"{card}): {label} train step {r['train_ms']:.3f} ms "
            f"(step 0), loss {r['loss']:.6f}, gnorm {r['gnorm']:.6f}, peak "
            f"{r['train_peak_gib']:.3f} GiB; decode "
            f"{r['decode_ms']:.3f} ms a step (median of "
            f"{tokens.shape[1]}), peak {r['decode_peak_gib']:.3f} GiB; "
            f"leaves {r['record']}; collectives: train "
            f"{collective_note(r['train_calls'])}, decode "
            f"{collective_note(r['decode_calls'])}")
    want = tp_reference_logits(tokens, device, smoke, arch, f32)
    bar = F32_BAR if f32 else SERVE_BARS.get(arch, SERVE_BAR)
    errs = []
    for g, w in zip(got[0]["logits"], want):
        top = float(w.float().abs().max())
        errs.append(float((g.float() - w.float()).abs().max()) / top
                    if bool(torch.isfinite(g.float()).all()) else math.inf)
    log(f"phase {phase} {label} across {world} cards ({card}): {wall:.3f} s "
        f"wall with the ranks' start; each decode step's logits from world "
        f"size 1's, of the largest |logit|: "
        f"{', '.join(f'{e:.4e}' for e in errs)} (bar {bar})")
    if max(errs) > bar:
        raise AssertionError(f"phase {phase}: {label}'s decode across "
                             f"{world} cards {max(errs):.4e} of the largest "
                             f"|logit| from world size 1's (bar {bar})")


def tp_reference_logits(tokens, device, smoke: bool,
                        arch: str = TP_SERVE_ARCH, f32: bool = False) -> list:
    """Every decode step's logits at world size 1 (the one-device code)
    over ``tokens``, from the parameters TP_SEED draws (``f32``: the
    config in f32)."""
    cfg = smoke_config(arch) if smoke else get_config(arch)
    if f32:
        cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    b, total = tokens.shape
    one = Mesh(SMOKE_MESH.axis_names, SMOKE_MESH.shape, device)
    db = bundle_for("decode", cfg, ShapeConfig("d", total, b, "decode"), one,
                    SMOKE_MESH)
    params = db.model.init(torch.Generator(device=device).manual_seed(
        TP_SEED))
    cache, tokens, out = db.model.init_cache(b, total), tokens.to(device), []
    for pos in range(total):
        lg, cache = db.fn(params, cache, {"tokens": tokens[:, pos:pos + 1],
                                          "pos": pos})
        out.append(lg.cpu())
    del params, cache
    release()
    return out


def tensor_parallel_path(card: str, smi: str, device) -> None:
    """Phase 18: a process group of one rank on this card for (a) and (b);
    then, with 2 or more cards, (c)."""
    import torch.distributed as dist
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 1
    tmp = tempfile.mkdtemp(prefix="chip-smoke-tp1-")

    def join():
        _dist.init(device.type, rank=0, world_size=1,
                   init_file=os.path.join(tmp, "init"))
        mesh = make_mesh(SMOKE_MESH, device.type)
        log(f"phase 18: world size {dist.get_world_size()}, backend "
            f"{dist.get_backend()}, mesh {mesh.shape} over "
            f"{mesh.axis_names} on {mesh.device} ({n_cards} card(s), "
            f"{smi})")
        return mesh

    try:
        tokens, mesh = tp_serving(card, smi, device, join)
        tp_training(card, smi, device, mesh)
    finally:
        _dist.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    if n_cards >= 2:
        tp_across_cards(card, n_cards, device, tokens)
    else:
        log("phase 18 (c): one card, so no cross-card run took place (NCCL "
            "takes one rank a card): the tensor-parallel code ran at world "
            "size 1 only")


# -- phase 19: tensor-parallel compute over model, the recurrent families --
# zamba2's Mamba blocks by SSM heads (its shared block as the
# transformer's), xLSTM's mLSTM blocks over their inner channels (in
# decode, the key dim of their state) and its sLSTM blocks by heads,
# through the same code at world size 1: bit for bit the one-device steps
TPR_ARCHS = ("zamba2-1.2b", "xlstm-1.3b")
TPR_DECODE_STEPS = 12  # from init_cache; the first of each run warms it
TPR_VARIANTS = ("one-device", "tensor-parallel", "tensor-parallel",
                "one-device")


def step_device(fn) -> str:
    """One call of ``fn`` under ``torch.profiler`` (warm): its kernel
    launches and device ms."""
    rows = device_breakdown(fn, reps=3)
    return (f"{sum(r[2] for r in rows):.0f} kernel launches, "
            f"{sum(r[1] for r in rows) / 1e3:.3f} ms of device time")


def tpr_decode(arch: str, smi: str, device, mesh):
    """Phase 19 (a): ``arch`` at full width in bf16, TPR_DECODE_STEPS
    decode steps of SERVE_REQUESTS rows from ``init_cache`` through
    ``make_decode_step`` on the one-device mesh and through the
    tensor-parallel code on ``mesh`` (world size 1), alternating in the
    order TPR_VARIANTS, from one state: every step's logits and the final
    state bit for bit the first run's. -> the tokens fed (for the
    cross-card run)."""
    cfg = get_config(arch)
    total = TPR_DECODE_STEPS
    shape = ShapeConfig("d", total, SERVE_REQUESTS, "decode")
    one = Mesh(SMOKE_MESH.axis_names, SMOKE_MESH.shape, device)
    bundles = {"one-device": bundle_for("decode", cfg, shape, one,
                                        SMOKE_MESH),
               "tensor-parallel": bundle_for("decode", cfg, shape, mesh,
                                             SMOKE_MESH)}
    fresh_peak()
    g = torch.Generator(device=device).manual_seed(TP_SEED)
    params = bundles["one-device"].model.init(g)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_REQUESTS, total),
                           generator=g, device=device, dtype=torch.int32)
    want, same, step_s, notes = None, True, {}, {}
    for name in TPR_VARIANTS:
        b, calls, logits, times = bundles[name], [], [], []
        cache = b.model.init_cache(SERVE_REQUESTS, total)
        with recording_collectives(calls):
            for pos in range(total):
                synchronize()
                t0 = time.perf_counter()
                lg, cache = b.fn(params, cache, {
                    "tokens": tokens[:, pos:pos + 1], "pos": pos})
                synchronize()
                times.append(time.perf_counter() - t0)
                logits.append(local(lg))
        step_s.setdefault(name, []).extend(times[1:])
        got = (logits, [local(x) for x in _tree.leaves(cache)])
        if want is None:
            want = (logits, [x.clone() for x in got[1]])
        else:
            same &= all(bits_equal(x, y) for x, y in zip(
                got[0] + got[1], want[0] + want[1]))
        if name not in notes:
            note = (f"{tp_record_note(b)}; one-rank collectives over its "
                    f"{total} steps: {collective_note(calls)}; "
                    if b.tp_record else "")
            notes[name] = (f"{note}a step under torch.profiler: "
                           + step_device(lambda: b.fn(params, cache, {
                               "tokens": tokens[:, :1], "pos": 0})))
        del cache, got
    for name, t in step_s.items():
        log(f"phase 19 (a) {arch} full width bf16, {name}: "
            f"{SERVE_REQUESTS} rows, {total} decode steps from init_cache; "
            f"{statistics.median(t) * 1e3:.3f} ms a step (median of "
            f"{len(t)} warm, host clock; min {min(t) * 1e3:.3f}, max "
            f"{max(t) * 1e3:.3f}); {notes[name]}; {memory_note()} ({smi})")
    if not same:
        raise AssertionError(f"phase 19 (a): {arch}'s decode through the "
                             f"tensor-parallel code differs from the "
                             f"one-device steps")
    log(f"phase 19 (a): {arch}'s logits of every decode step and the final "
        f"state of all {len(TPR_VARIANTS)} runs bit for bit the first "
        f"one-device run's")
    del params, want
    release()
    return tokens.cpu()


def recurrent_tp_path(card: str, smi: str, device) -> None:
    """Phase 19: a process group of one rank on this card for (a) and (b),
    each arch of TPR_ARCHS; then, with 2 or more cards, (c)."""
    import torch.distributed as dist
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 1
    tmp = tempfile.mkdtemp(prefix="chip-smoke-tpr-")
    tokens = {}
    try:
        _dist.init(device.type, rank=0, world_size=1,
                   init_file=os.path.join(tmp, "init"))
        mesh = make_mesh(SMOKE_MESH, device.type)
        log(f"phase 19: world size {dist.get_world_size()}, backend "
            f"{dist.get_backend()}, mesh {mesh.shape} over "
            f"{mesh.axis_names} on {mesh.device} ({n_cards} card(s), "
            f"{smi})")
        for arch in TPR_ARCHS:
            tokens[arch] = tpr_decode(arch, smi, device, mesh)
            tp_training(card, smi, device, mesh, arch, "19 (b)")
    finally:
        _dist.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    if n_cards >= 2:
        # in f32 at F32_BAR, and in bf16 at phase 14's bar where that bar
        # is SERVE_BAR: xLSTM's bf16 decode moves with the order of its
        # sums (phase 14's looser bar), and the split reorders every
        # row-parallel sum
        for arch in TPR_ARCHS:
            for f32 in (True,) if arch in SERVE_BARS else (False, True):
                tp_across_cards(card, n_cards, device, tokens[arch],
                                arch=arch, phase="19 (c)", f32=f32)
    else:
        log("phase 19 (c): one card, so no cross-card run took place (NCCL "
            "takes one rank a card): the recurrent families' split ran at "
            "world size 1 only")


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
    serving_path(card, device)
    serving_reference_check(device)
    phase_done("14 (the LM zoo's serving path)")
    step_ms = training_path(card, device)
    training_reference_check(device)
    phase_done("15 (the LM zoo's training path)")
    twin_launches = examples_path(device, step_ms)
    phase_done("16 (the example twins and the dry run)")
    zero_launches()
    multi_device_path(card, device)
    counts = launches()
    log(f"phase 17 launches of the six kernels: {counts}")
    if any(counts.values()):
        raise AssertionError("the multi-device path launched a FedAvg, "
                             "quantize or top-k kernel")
    phase_done("17 (the multi-device path)")
    zero_launches()
    tensor_parallel_path(card, smi, device)
    counts = launches()
    log(f"phase 18 launches of the six kernels: {counts}")
    if any(counts.values()):
        raise AssertionError("the tensor-parallel path launched a FedAvg, "
                             "quantize or top-k kernel")
    phase_done("18 (tensor-parallel compute over model)")
    zero_launches()
    recurrent_tp_path(card, smi, device)
    counts = launches()
    log(f"phase 19 launches of the six kernels: {counts}")
    if any(counts.values()):
        raise AssertionError("the recurrent families' tensor-parallel path "
                             "launched a FedAvg, quantize or top-k kernel")
    phase_done("19 (tensor-parallel compute over model, the recurrent "
               "families)")

    # launches: over the main paths each kernel is on, each path run with
    # the counts at 0 (fedavg_reduce: the sync rounds, the event runs, the
    # Large tier's two runs and the cross-silo twin's rounds; the quantize
    # pair: the event runs, the Large fedbuff run and vertical run (a);
    # topk_rows: the event runs
    # and vertical run (b); fedavg_reduce_q8: the fedavg_quantized phase)
    path_launches = {k: event_launches[k] + large_launches[k]
                     + vertical_launches[k] for k in KERNELS}
    path_launches["fedavg_reduce"] += sync_launches + twin_launches
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
