"""Port of ``src/repro/kernels/fedavg_reduce.py``: the FL server's
weighted aggregation of N client updates, ``out = sum_i w_i * x_i``.

Only ``fedavg_reduce`` (the sync FedAvg kernel) is ported in this slice;
``fedavg_accumulate`` and ``fedavg_reduce_q8`` wait for the slices whose
paths reach them (see ROADMAP.md queue B).

Dispatch is by the device of the tensor given: a CPU tensor goes to
``fedavg_reduce_plain``; a CUDA tensor goes to the hand-written Hopper
kernel in ``csrc/fedavg_reduce.cu`` (built with ``nvcc`` at first use)
or raises. ``LAUNCHES`` counts kernel launches, so a run can show that
its path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCES = ("fedavg_reduce.cu",)
LAUNCHES = 0

_SYMBOLS = {torch.float32: "fedavg_reduce_f32",
            torch.bfloat16: "fedavg_reduce_bf16"}


def fedavg_reduce_plain(updates: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """updates (N, T), weights (N,) -> (T,) f32 (``kernels/ref.py:44``)."""
    return torch.sum(updates.float() * weights.float()[:, None], dim=0)


def build() -> ctypes.CDLL:
    """Compile (or load the cached) kernel library and bind its symbols."""
    lib = _build.load("fedavg_reduce", SOURCES)
    for sym in _SYMBOLS.values():
        fn = getattr(lib, sym)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
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
