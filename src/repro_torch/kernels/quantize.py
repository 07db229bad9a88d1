"""Port of ``src/repro/kernels/quantize.py``: blockwise symmetric int8
quantisation, the compression hot spot of the communication layer (QSGD
payloads on the event-driven update path).

Layout: the input is viewed as (rows, block), one f32 scale per row of
``block`` contiguous elements. The flat wrappers in ``ops.py`` pad each
item to a multiple of ``block * ROW_TILE`` elements, as the reference
does: the padded lengths are on the wire.

Dispatch is by the device of the tensor given: a CPU tensor goes to the
plain version; a CUDA tensor goes to the hand-written Hopper kernels in
``csrc/quantize.cu`` (built with ``nvcc`` at first use) or raises.
``QUANTIZE_LAUNCHES`` and ``DEQUANTIZE_LAUNCHES`` count kernel launches,
so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

ROW_TILE = 8  # the reference's row tile: part of the wire's padding rule
SOURCES = ("quantize.cu",)
QUANTIZE_LAUNCHES = 0
DEQUANTIZE_LAUNCHES = 0

_QUANTIZE = {torch.float32: "quantize_blocks_f32",
             torch.bfloat16: "quantize_blocks_bf16"}
_DEQUANTIZE = {torch.float32: "dequantize_blocks_f32",
               torch.bfloat16: "dequantize_blocks_bf16"}


def quantize_blocks_plain(x: torch.Tensor):
    """(rows, block) float -> (q int8 (rows, block), scales f32 (rows, 1))
    (``kernels/ref.py:11``)."""
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    # tensor / tensor: true IEEE divisions, as the reference and the kernel
    # take them (PyTorch's CUDA `t / scalar` multiplies by a reciprocal)
    scale = torch.div(amax, torch.full_like(amax, 127.0))
    inv = torch.where(scale > 0.0,
                      torch.div(torch.ones_like(scale), scale),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(x * inv), -127.0, 127.0).to(torch.int8)
    return q, scale


def dequantize_blocks_plain(q: torch.Tensor, scales: torch.Tensor,
                            out_dtype=torch.float32) -> torch.Tensor:
    """(rows, block) int8, (rows, 1) f32 -> (rows, block) ``out_dtype``
    (``kernels/ref.py:21``)."""
    return (q.float() * scales.float()).to(out_dtype)


def build() -> ctypes.CDLL:
    """Compile (or load the cached) kernel library and bind its symbols."""
    lib = _build.load("quantize", SOURCES)
    for sym in (*_QUANTIZE.values(), *_DEQUANTIZE.values()):
        fn = getattr(lib, sym)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.quantize_error_string.argtypes = [ctypes.c_int]
    lib.quantize_error_string.restype = ctypes.c_char_p
    return lib


def _launch(lib, sym: str, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, sym)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{sym} kernel launch failed: "
                           f"{lib.quantize_error_string(rc).decode()}")


def quantize_blocks(x: torch.Tensor):
    """x: (rows, block) f32 or bf16 -> (q int8 (rows, block), scales f32
    (rows, 1)). Any rows and block: the kernel needs no row tile."""
    if x.dim() != 2:
        raise ValueError(f"quantize_blocks: need (rows, block), got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize_blocks_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_blocks: no kernel for {x.device}")
    if x.dtype not in _QUANTIZE:
        raise TypeError(f"quantize_blocks: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantize_blocks: x must be contiguous")
    rows, block = x.shape
    q = torch.empty((rows, block), dtype=torch.int8, device=x.device)
    scales = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if rows == 0 or block == 0:
        return q, scales.zero_()
    _launch(build(), _QUANTIZE[x.dtype], x.device, x.data_ptr(),
            q.data_ptr(), scales.data_ptr(), rows, block)
    global QUANTIZE_LAUNCHES
    QUANTIZE_LAUNCHES += 1
    return q, scales


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor,
                      out_dtype=torch.float32) -> torch.Tensor:
    """q: (rows, block) int8; scales: (rows, 1) f32 -> (rows, block)
    ``out_dtype`` (f32 or bf16)."""
    if q.dim() != 2 or tuple(scales.shape) != (q.shape[0], 1):
        raise ValueError(f"dequantize_blocks: need (rows, block) q and "
                         f"(rows, 1) scales, got {tuple(q.shape)} and "
                         f"{tuple(scales.shape)}")
    if q.device != scales.device:
        raise ValueError(f"dequantize_blocks: q on {q.device}, scales on "
                         f"{scales.device}")
    if q.device.type == "cpu":
        return dequantize_blocks_plain(q, scales, out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"dequantize_blocks: no kernel for {q.device}")
    if q.dtype != torch.int8 or scales.dtype != torch.float32 \
            or out_dtype not in _DEQUANTIZE:
        raise TypeError(f"dequantize_blocks: need int8 q, float32 scales "
                        f"and a float32 or bfloat16 output, got {q.dtype}, "
                        f"{scales.dtype} and {out_dtype}")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("dequantize_blocks: inputs must be contiguous")
    rows, block = q.shape
    out = torch.empty((rows, block), dtype=out_dtype, device=q.device)
    if rows == 0 or block == 0:
        return out
    _launch(build(), _DEQUANTIZE[out_dtype], q.device, q.data_ptr(),
            scales.data_ptr(), out.data_ptr(), rows, block)
    global DEQUANTIZE_LAUNCHES
    DEQUANTIZE_LAUNCHES += 1
    return out
