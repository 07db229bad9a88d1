"""Port of ``src/repro/kernels/fedavg_reduce.py``: the FL server's
weighted aggregation of N client updates, ``out = sum_i w_i * x_i``
(``fedavg_reduce``), its streaming form, one weighted update folded
into a running sum, ``acc + w * x`` (``fedavg_accumulate``, the
fleet-scale hub's fold), and its fused form over int8-quantised updates,
``sum_i w_i * (q_i * s_i[t / block])`` (``fedavg_reduce_q8``, behind
``fl.aggregator.fedavg_quantized``).

``fedavg_reduce`` comes in two forms over one kernel: the tree form
``fedavg_reduce_leaves`` reads N client trees of L leaves where they lie,
through a table of N * L pointers (the server's path, ``ops.
fedavg_aggregate``), and the (N, T) form takes the rows of one matrix.
The tree form's tile table depends only on the leaves' shapes and dtypes,
so it is built once per tree structure and cached on the card; each call
copies only the N * L leaf pointers and the N weights to the card, in one
copy. Its output is one f32 buffer whose leaf slots each start on 16
bytes; the leaves come back as views of it.

Subnormals and rounding, as XLA computes the reference on the CPU (the
TPU has no subnormals): every multiply flushes its inputs and result as
``quantize.mul_ftz`` does (x after bf16 is widened, w, the scale), and
every partial sum below ``FLT_MIN`` reads as a zero of its sign. The
clients are summed in their order, one rounded multiply and one rounded
add each, in the plain versions and the kernels (PTX ``.ftz`` operations)
alike, so the two agree bit for bit. XLA sums in another order than the
clients', so the port agrees with the reference at its own bars (rtol
1e-4 / atol 1e-5), and exactly on inputs that every order sums alike.

Dispatch is by the device of the tensors given: CPU tensors go to the
plain version; CUDA tensors go to the hand-written Hopper kernels in
``csrc/fedavg_reduce.cu`` (built with ``nvcc`` at first use) or raise.
``LAUNCHES``, ``ACCUMULATE_LAUNCHES`` and ``Q8_LAUNCHES`` count kernel
launches, so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes
import operator
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quantize import flush_subnormals as _flush
from repro_torch.kernels.quantize import mul_ftz

SOURCES = ("fedavg_reduce.cu",)
LAUNCHES = 0
ACCUMULATE_LAUNCHES = 0
Q8_LAUNCHES = 0
TILE = 1024  # elements of a leaf per block (csrc: kTile)
SLOT = 4  # f32 per 16 bytes: every leaf's output slot starts on one
MAX_CLIENTS = 4096  # the kernel keeps N pointers and weights in shared memory

_SYMBOLS = {torch.float32: "fedavg_reduce_f32",
            torch.bfloat16: "fedavg_reduce_bf16"}
_BF16_FLAG = {torch.float32: 0, torch.bfloat16: 1}


def fedavg_reduce_plain(updates: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """updates (N, T), weights (N,) -> (T,) f32 (``kernels/ref.py:44``),
    summed in client order with the module's flushes."""
    x = updates.float()
    acc = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for i in range(x.shape[0]):
        acc = _flush(acc + mul_ftz(weights[i], x[i]))
    return acc


def fedavg_accumulate_plain(acc: torch.Tensor, x: torch.Tensor,
                            w: float) -> torch.Tensor:
    """acc, x (T,), w scalar -> (T,) f32 ``acc + w * x``
    (``kernels/ref.py:50``): a rounded multiply, then a rounded add, with
    the module's flushes."""
    return _flush(_flush(acc.float()) + mul_ftz(x, float(w)))


def fedavg_reduce_q8_plain(q: torch.Tensor, scales: torch.Tensor,
                           weights: torch.Tensor, block: int) -> torch.Tensor:
    """q (N, T) int8, scales (N, T / block), weights (N,) -> (T,) f32
    (``kernels/ref.py:65``): each value dequantised, then weighted, summed
    in client order with the module's flushes."""
    n, t = q.shape
    acc = torch.zeros(t, dtype=torch.float32, device=q.device)
    for i in range(n):
        x = mul_ftz(q[i].float().reshape(t // block, block),
                    scales[i][:, None])
        acc = _flush(acc + mul_ftz(weights[i], x.reshape(t)))
    return acc


def fedavg_reduce_leaves_plain(leaves: Sequence[Sequence[torch.Tensor]],
                               weights) -> List[torch.Tensor]:
    """The tree form's plain version: client i's leaves flattened and
    stacked, ``fedavg_reduce_plain``, split into f32 leaves of client 0's
    shapes."""
    first = leaves[0]
    x = torch.stack([torch.cat([l.float().reshape(-1) for l in c])
                     for c in leaves])
    flat = fedavg_reduce_plain(x, _host_weights(weights, len(leaves))
                               .to(x.device))
    return [v.view(l.shape) for v, l in
            zip(flat.split([l.numel() for l in first]), first)]


def build() -> ctypes.CDLL:
    """Compile (or load the cached) kernel library and bind its symbols."""
    lib = _build.load("fedavg_reduce", SOURCES)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    for sym in _SYMBOLS.values():
        fn = getattr(lib, sym)
        fn.argtypes = [p, p, p, i64, i64, p]
        fn.restype = ctypes.c_int
    lib.fedavg_reduce_leaves.argtypes = [p, i64, p, p, p, i64, p]
    lib.fedavg_reduce_leaves.restype = ctypes.c_int
    lib.fedavg_accumulate_f32.argtypes = [p, p, ctypes.c_float, p, i64, p]
    lib.fedavg_accumulate_f32.restype = ctypes.c_int
    lib.fedavg_reduce_q8.argtypes = [p, p, p, p, i64, i64, i64, p]
    lib.fedavg_reduce_q8.restype = ctypes.c_int
    lib.fedavg_q8_fast_path.argtypes = [i64, i64, p]
    lib.fedavg_q8_fast_path.restype = ctypes.c_int
    lib.fedavg_error_string.argtypes = [ctypes.c_int]
    lib.fedavg_error_string.restype = ctypes.c_char_p
    return lib


def _launch(device, what: str, sym: str, *args) -> None:
    """Call the C launcher ``sym`` on ``device``'s current stream."""
    lib = build()
    with torch.cuda.device(device):
        rc = getattr(lib, sym)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.fedavg_error_string(rc).decode()}")


def _host_weights(weights, n: int) -> torch.Tensor:
    w = torch.as_tensor(weights, dtype=torch.float32).cpu().reshape(-1)
    if w.shape[0] != n:
        raise ValueError(f"fedavg_reduce: {n} clients but {w.shape[0]} "
                         f"weights")
    return w


# ---------------------------------------------------------------------------
# the tree form
# ---------------------------------------------------------------------------

class LeafPlan(NamedTuple):
    """What the tree form needs of one tree structure on one device."""
    sig: tuple  # per leaf: (shape, dtype) every client's leaf must have
    tiles: torch.Tensor  # (3 * n_tiles,) int64: out offset, start, meta
    n_tiles: int
    numel: int  # the output buffer: every leaf slot padded to SLOT floats
    views: tuple  # per leaf: (shape, stride, offset) in the output buffer


class LeafCall(NamedTuple):
    """One call's tables: the plan and, on its device, the N * L leaf
    pointers (leaf by leaf) followed by the N weights as f32."""
    plan: LeafPlan
    table: torch.Tensor
    n: int


_PLANS: dict = {}
_SIG = operator.attrgetter("shape", "dtype")


def _strides(shape) -> tuple:
    out, step = [], 1
    for d in reversed(shape):
        out.append(step)
        step *= d
    return tuple(reversed(out))


def leaf_plan(first: Sequence[torch.Tensor], device) -> LeafPlan:
    """The cached plan for trees whose leaves are shaped like ``first``:
    tiles of at most TILE elements that never cross a leaf, and each
    leaf's 16-byte aligned slot in the output."""
    sig = tuple(map(_SIG, first))
    key = (sig, torch.device(device))
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    rows, views, off = [], [], 0
    for leaf, (shape, dtype) in enumerate(sig):
        if dtype not in _BF16_FLAG:
            raise TypeError(f"fedavg_reduce: leaves must be float32 or "
                            f"bfloat16, leaf {leaf} is {dtype}")
        size = int(np.prod(shape, dtype=np.int64))
        for start in range(0, size, TILE):
            rows.append((off + start, start, leaf << 32
                         | _BF16_FLAG[dtype] << 31 | min(TILE, size - start)))
        views.append((shape, _strides(shape), off))
        off += -(-size // SLOT) * SLOT
    tiles = torch.tensor(rows, dtype=torch.int64).reshape(-1).to(key[1])
    plan = _PLANS[key] = LeafPlan(sig, tiles, len(rows), off, tuple(views))
    return plan


def leaf_call(leaves: Sequence[Sequence[torch.Tensor]], weights) -> LeafCall:
    """The host side of one tree-form call: check every client's leaves
    against client 0's structure, gather the N * L ``data_ptr()``s and the
    weights, and copy them to the leaves' device in one copy."""
    n = len(leaves)
    if not 1 <= n <= MAX_CLIENTS or not leaves[0]:
        raise ValueError(f"fedavg_reduce: need 1..{MAX_CLIENTS} clients of "
                         f"at least one leaf, got {n}")
    first = leaves[0]
    device = first[0].device
    plan = leaf_plan(first, device)
    w = _host_weights(weights, n)
    nl = len(first)
    table = np.empty(nl * n + (n + 1) // 2, np.int64)
    ptrs = table[:nl * n].reshape(nl, n)
    where = {first[0].get_device()}
    for i, client in enumerate(leaves):
        if tuple(map(_SIG, client)) != plan.sig:
            raise ValueError(f"fedavg_reduce: client {i}'s leaves differ "
                             f"in number, shape or dtype from client 0's")
        if set(map(torch.Tensor.get_device, client)) != where:
            raise ValueError(f"fedavg_reduce: client {i}'s leaves are not "
                             f"all on {device}")
        if not all(map(torch.Tensor.is_contiguous, client)):
            raise ValueError(f"fedavg_reduce: client {i} has a "
                             f"non-contiguous leaf")
        ptrs[:, i] = list(map(torch.Tensor.data_ptr, client))
    table[nl * n:].view(np.float32)[:n] = w.numpy()
    return LeafCall(plan, torch.from_numpy(table).to(device,
                                                     non_blocking=True), n)


def launch_leaves(call: LeafCall, out: torch.Tensor = None) -> torch.Tensor:
    """One launch of the kernel over a prepared call; returns the output
    buffer (``call.plan.numel`` f32; ``out`` if given)."""
    plan, table, n = call
    if table.device.type != "cuda":
        raise ValueError(f"fedavg_reduce: no kernel for {table.device}")
    if out is None:
        out = torch.empty(plan.numel, dtype=torch.float32,
                          device=table.device)
    if out.dtype != torch.float32 or out.device != table.device \
            or not out.is_contiguous() or out.numel() < plan.numel:
        raise ValueError(f"fedavg_reduce: the output must be {plan.numel} "
                         f"contiguous f32 on {table.device}")
    if plan.n_tiles == 0:
        return out
    _launch(table.device, "fedavg_reduce", "fedavg_reduce_leaves",
            plan.tiles.data_ptr(), plan.n_tiles, table.data_ptr(),
            table.data_ptr() + 8 * (table.shape[0] - (n + 1) // 2),
            out.data_ptr(), n)
    global LAUNCHES
    LAUNCHES += 1
    return out


def leaf_views(plan: LeafPlan, out: torch.Tensor) -> List[torch.Tensor]:
    """The leaves of an output buffer: views with client 0's shapes."""
    return [out.as_strided(shape, stride, off)
            for shape, stride, off in plan.views]


def fedavg_reduce_leaves(leaves: Sequence[Sequence[torch.Tensor]],
                         weights) -> List[torch.Tensor]:
    """leaves: N lists of L contiguous f32 or bf16 tensors, client i's
    leaves in one order, every client's shaped like client 0's; weights:
    (N,) host f32, already normalised -> L f32 tensors, leaf l =
    sum_i w_i * leaves[i][l], views of one buffer. One launch on the card."""
    if not leaves or not leaves[0]:
        raise ValueError("fedavg_reduce: need at least one client of at "
                         "least one leaf")
    device = leaves[0][0].device
    if device.type == "cpu":
        return fedavg_reduce_leaves_plain(leaves, weights)
    if device.type != "cuda":
        raise ValueError(f"fedavg_reduce: no kernel for {device}")
    call = leaf_call(leaves, weights)
    return leaf_views(call.plan, launch_leaves(call))


# ---------------------------------------------------------------------------
# the (N, T) form, the streaming fold and the fused int8 form
# ---------------------------------------------------------------------------

def fedavg_reduce(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """updates: (N, T) f32 or bf16; weights: (N,) f32, already normalised
    -> (T,) f32 weighted sum. Any T: the kernel masks its ragged tail."""
    if updates.dim() != 2 or weights.dim() != 1 \
            or weights.shape[0] != updates.shape[0]:
        raise ValueError(f"fedavg_reduce: need (N, T) updates and (N,) "
                         f"weights, got {tuple(updates.shape)} and "
                         f"{tuple(weights.shape)}")
    if updates.device != weights.device:
        raise ValueError(f"fedavg_reduce: updates on {updates.device}, "
                         f"weights on {weights.device}")
    if updates.device.type == "cpu":
        return fedavg_reduce_plain(updates, weights)
    if updates.device.type != "cuda":
        raise ValueError(f"fedavg_reduce: no kernel for {updates.device}")
    if updates.dtype not in _SYMBOLS or weights.dtype != torch.float32:
        raise TypeError(f"fedavg_reduce: updates must be float32 or "
                        f"bfloat16 and weights float32, got {updates.dtype} "
                        f"and {weights.dtype}")
    if not (updates.is_contiguous() and weights.is_contiguous()):
        raise ValueError("fedavg_reduce: inputs must be contiguous")
    n, t = updates.shape
    if not 1 <= n <= MAX_CLIENTS:
        raise ValueError(f"fedavg_reduce: need 1..{MAX_CLIENTS} rows, got "
                         f"{n}")
    out = torch.empty(t, dtype=torch.float32, device=updates.device)
    if t == 0:
        return out
    _launch(updates.device, "fedavg_reduce", _SYMBOLS[updates.dtype],
            updates.data_ptr(), weights.data_ptr(), out.data_ptr(), n, t)
    global LAUNCHES
    LAUNCHES += 1
    return out


def fedavg_accumulate(acc: torch.Tensor, x: torch.Tensor,
                      w: float) -> torch.Tensor:
    """acc, x: (T,) f32 on one device; w: Python scalar -> a new (T,) f32
    ``acc + w * x``. Any T: the kernel masks its ragged tail."""
    if acc.dim() != 1 or acc.shape != x.shape:
        raise ValueError(f"fedavg_accumulate: need two (T,) vectors, got "
                         f"{tuple(acc.shape)} and {tuple(x.shape)}")
    if acc.device != x.device:
        raise ValueError(f"fedavg_accumulate: acc on {acc.device}, x on "
                         f"{x.device}")
    if acc.device.type == "cpu":
        return fedavg_accumulate_plain(acc, x, w)
    if acc.device.type != "cuda":
        raise ValueError(f"fedavg_accumulate: no kernel for {acc.device}")
    if acc.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"fedavg_accumulate: acc and x must be float32, "
                        f"got {acc.dtype} and {x.dtype}")
    if not (acc.is_contiguous() and x.is_contiguous()):
        raise ValueError("fedavg_accumulate: inputs must be contiguous")
    t = acc.shape[0]
    out = torch.empty(t, dtype=torch.float32, device=acc.device)
    if t == 0:
        return out
    _launch(acc.device, "fedavg_accumulate", "fedavg_accumulate_f32",
            acc.data_ptr(), x.data_ptr(), float(w), out.data_ptr(), t)
    global ACCUMULATE_LAUNCHES
    ACCUMULATE_LAUNCHES += 1
    return out


def q8_fast_path(q: torch.Tensor, block: int) -> bool:
    """Whether ``fedavg_reduce_q8`` on the (N, T) int8 CUDA tensor ``q``
    takes the kernel's fast path: block % 4 == 0, T % 4 == 0 and ``q``
    4-byte aligned (the launcher's own rule, ``csrc/fedavg_reduce.cu``)."""
    return bool(build().fedavg_q8_fast_path(int(block), q.shape[1],
                                            q.data_ptr()))


def fedavg_reduce_q8(q: torch.Tensor, scales: torch.Tensor,
                     weights: torch.Tensor, block: int) -> torch.Tensor:
    """q: (N, T) int8; scales: (N, T / block) f32; weights: (N,) f32,
    already normalised -> (T,) f32. Any ``block`` that divides T; any T:
    the kernel masks its ragged tail."""
    block = int(block)
    if q.dim() != 2 or weights.dim() != 1 or weights.shape[0] != q.shape[0]:
        raise ValueError(f"fedavg_reduce_q8: need (N, T) q and (N,) "
                         f"weights, got {tuple(q.shape)} and "
                         f"{tuple(weights.shape)}")
    n, t = q.shape
    if block < 1 or t % block or tuple(scales.shape) != (n, t // block):
        raise ValueError(f"fedavg_reduce_q8: block {block} must divide T = "
                         f"{t} and scales must be {(n, t // max(block, 1))}"
                         f", got {tuple(scales.shape)}")
    if not (q.device == scales.device == weights.device):
        raise ValueError(f"fedavg_reduce_q8: q on {q.device}, scales on "
                         f"{scales.device}, weights on {weights.device}")
    if q.device.type == "cpu":
        return fedavg_reduce_q8_plain(q, scales, weights, block)
    if q.device.type != "cuda":
        raise ValueError(f"fedavg_reduce_q8: no kernel for {q.device}")
    if q.dtype != torch.int8 or scales.dtype != torch.float32 \
            or weights.dtype != torch.float32:
        raise TypeError(f"fedavg_reduce_q8: need int8 q and float32 scales "
                        f"and weights, got {q.dtype}, {scales.dtype} and "
                        f"{weights.dtype}")
    if not (q.is_contiguous() and scales.is_contiguous()
            and weights.is_contiguous()):
        raise ValueError("fedavg_reduce_q8: inputs must be contiguous")
    out = torch.empty(t, dtype=torch.float32, device=q.device)
    if t == 0:
        return out
    _launch(q.device, "fedavg_reduce_q8", "fedavg_reduce_q8", q.data_ptr(),
            scales.data_ptr(), weights.data_ptr(), out.data_ptr(), n, t,
            block)
    global Q8_LAUNCHES
    Q8_LAUNCHES += 1
    return out
