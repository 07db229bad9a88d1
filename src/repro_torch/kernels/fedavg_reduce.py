"""Port of ``src/repro/kernels/fedavg_reduce.py``: the FL server's
weighted aggregation of N client updates, ``out = sum_i w_i * x_i``
(``fedavg_reduce``), its streaming form, one weighted update folded
into a running sum, ``acc + w * x`` (``fedavg_accumulate``, the
fleet-scale hub's fold), and its fused form over int8-quantised updates,
``sum_i w_i * (q_i * s_i[t / block])`` (``fedavg_reduce_q8``, behind
``fl.aggregator.fedavg_quantized``).

Dispatch is by the device of the tensor given: a CPU tensor goes to the
plain version; a CUDA tensor goes to the hand-written Hopper kernels in
``csrc/fedavg_reduce.cu`` (built with ``nvcc`` at first use) or raises.
``LAUNCHES``, ``ACCUMULATE_LAUNCHES`` and ``Q8_LAUNCHES`` count kernel
launches, so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCES = ("fedavg_reduce.cu",)
LAUNCHES = 0
ACCUMULATE_LAUNCHES = 0
Q8_LAUNCHES = 0

_SYMBOLS = {torch.float32: "fedavg_reduce_f32",
            torch.bfloat16: "fedavg_reduce_bf16"}


def fedavg_reduce_plain(updates: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """updates (N, T), weights (N,) -> (T,) f32 (``kernels/ref.py:44``)."""
    return torch.sum(updates.float() * weights.float()[:, None], dim=0)


def fedavg_accumulate_plain(acc: torch.Tensor, x: torch.Tensor,
                            w: float) -> torch.Tensor:
    """acc, x (T,), w scalar -> (T,) f32 ``acc + w * x``
    (``kernels/ref.py:50``): a rounded multiply, then a rounded add."""
    return acc.float() + torch.mul(x.float(), float(w))


def fedavg_reduce_q8_plain(q: torch.Tensor, scales: torch.Tensor,
                           weights: torch.Tensor, block: int) -> torch.Tensor:
    """q (N, T) int8, scales (N, T / block), weights (N,) -> (T,) f32
    (``kernels/ref.py:65``): each value dequantised, then weighted."""
    n, t = q.shape
    x = q.float().reshape(n, t // block, block) * scales.float()[..., None]
    return torch.sum(x.reshape(n, t) * weights.float()[:, None], dim=0)


def build() -> ctypes.CDLL:
    """Compile (or load the cached) kernel library and bind its symbols."""
    lib = _build.load("fedavg_reduce", SOURCES)
    for sym in _SYMBOLS.values():
        fn = getattr(lib, sym)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.fedavg_accumulate_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p]
    lib.fedavg_accumulate_f32.restype = ctypes.c_int
    lib.fedavg_reduce_q8.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.fedavg_reduce_q8.restype = ctypes.c_int
    lib.fedavg_error_string.argtypes = [ctypes.c_int]
    lib.fedavg_error_string.restype = ctypes.c_char_p
    return lib


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
    out = torch.empty(t, dtype=torch.float32, device=updates.device)
    if t == 0:
        return out
    lib = build()
    with torch.cuda.device(updates.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, _SYMBOLS[updates.dtype])(
            updates.data_ptr(), weights.data_ptr(), out.data_ptr(), n, t,
            stream)
    if rc != 0:
        raise RuntimeError(f"fedavg_reduce kernel launch failed: "
                           f"{lib.fedavg_error_string(rc).decode()}")
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
    lib = build()
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fedavg_accumulate_f32(acc.data_ptr(), x.data_ptr(),
                                       float(w), out.data_ptr(), t, stream)
    if rc != 0:
        raise RuntimeError(f"fedavg_accumulate kernel launch failed: "
                           f"{lib.fedavg_error_string(rc).decode()}")
    global ACCUMULATE_LAUNCHES
    ACCUMULATE_LAUNCHES += 1
    return out


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
    lib = build()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fedavg_reduce_q8(q.data_ptr(), scales.data_ptr(),
                                  weights.data_ptr(), out.data_ptr(), n, t,
                                  block, stream)
    if rc != 0:
        raise RuntimeError(f"fedavg_reduce_q8 kernel launch failed: "
                           f"{lib.fedavg_error_string(rc).decode()}")
    global Q8_LAUNCHES
    Q8_LAUNCHES += 1
    return out
