"""Port of ``src/repro/kernels/quantize.py``: blockwise symmetric int8
quantisation, the compression hot spot of the communication layer (QSGD
payloads on the event-driven update path).

Layout: the input is viewed as (rows, block), one f32 scale per row of
``block`` contiguous elements. The flat wrappers in ``ops.py`` pad each
item to a multiple of ``block * ROW_TILE`` elements, as the reference
does: the padded lengths are on the wire.

Subnormal f32 values are flushed as XLA flushes them when it runs the
reference's codec on the CPU (the TPU has no subnormals), in the plain
versions and the kernels alike:

* quantize: an input value with |x| < ``FLT_MIN`` (2**-126), after bf16
  input is widened to f32, reads as a zero of its sign before |x|, the row
  max and the product; a scale ``amax / 127`` below ``FLT_MIN`` becomes 0,
  so its row takes the ``inv = 0`` branch and quantises to 0;
* dequantize: a scale with |scale| < ``FLT_MIN`` reads as a zero of its
  sign. A scale of at least ``FLT_MIN`` times |q| >= 1 is never
  subnormal, so the product needs no flush.

The reference's NumPy twin ``ref.quantize_blocks_np`` does not flush; it
agrees with these rules on inputs without subnormals.

Elsewhere in the port (FedAvg, the server merge, the codecs' error
feedback) ``mul_ftz`` and ``div_ftz`` give a product or quotient exactly as
XLA's CPU flush does: subnormal inputs read as zeros of their sign, and
the result becomes one when its value rounded to 24 bits with an
unbounded exponent lies below ``FLT_MIN`` (tininess after rounding). A
product whose exact value lies within 2**-25 of ``FLT_MIN`` below it
would round up to ``FLT_MIN`` in IEEE arithmetic and is flushed all the
same; the H100's ``mul.rn.ftz.f32`` flushes by the same rule (PERF.md).
A sum of two flushed f32 values below ``FLT_MIN`` is exact, so for
additions ``flush_subnormals`` of the IEEE sum is the same rule.

Dispatch is by the device of the tensor given: a CPU tensor goes to the
plain version; a CUDA tensor goes to the hand-written Hopper kernels in
``csrc/quantize.cu`` (built with ``nvcc`` at first use) or raises.
``QUANTIZE_LAUNCHES`` and ``DEQUANTIZE_LAUNCHES`` count kernel launches,
so a run can show that its path went through the kernels. Which of the
kernels' two paths a call takes is decided in the C launcher and can be
asked with ``fast_path`` (see ``csrc/quantize.cu``).
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build

ROW_TILE = 8  # the reference's row tile: part of the wire's padding rule
FLT_MIN = torch.finfo(torch.float32).tiny  # 2**-126, the least normal f32
SOURCES = ("quantize.cu",)
QUANTIZE_LAUNCHES = 0
DEQUANTIZE_LAUNCHES = 0

_QUANTIZE = {torch.float32: "quantize_blocks_f32",
             torch.bfloat16: "quantize_blocks_bf16"}
_DEQUANTIZE = {torch.float32: "dequantize_blocks_f32",
               torch.bfloat16: "dequantize_blocks_bf16"}


def flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` with every subnormal value replaced by a zero of its sign."""
    return torch.where(x.abs() < FLT_MIN,
                       torch.zeros_like(x).copysign(x), x)


# |exact| below this rounds, with 24 bits and an unbounded exponent, to less
# than FLT_MIN: FLT_MIN - 2**-151, halfway to the next f32 below FLT_MIN
_TINY = FLT_MIN * (1 - 2.0 ** -25)


def _flush_exact(exact: torch.Tensor) -> torch.Tensor:
    """The f64 ``exact`` rounded to f32, a zero of its sign where XLA's
    flush makes it one."""
    r = exact.float()
    return torch.where(exact.abs() < _TINY, torch.zeros_like(r).copysign(r),
                       r)


def _operand(v, device) -> torch.Tensor:
    """``v`` as f32, flushed, widened to f64 on ``device``. A host number
    is rounded and flushed on the host and filled in on the device, so no
    host-to-device copy waits for the card."""
    if isinstance(v, torch.Tensor):
        return flush_subnormals(v.to(device, torch.float32)).double()
    v = float(np.float32(v))
    return torch.full((), math.copysign(0.0, v) if abs(v) < FLT_MIN else v,
                      dtype=torch.float64, device=device)


def _device(a, b) -> torch.device:
    return (a if isinstance(a, torch.Tensor) else b).device


def mul_ftz(a, b) -> torch.Tensor:
    """f32 ``a * b`` with XLA's flush, ``a`` or ``b`` a tensor. The product
    of two f32 values is exact in f64, and rounding it to f32 once is the
    IEEE product."""
    dev = _device(a, b)
    return _flush_exact(_operand(a, dev) * _operand(b, dev))


def div_ftz(a, b) -> torch.Tensor:
    """f32 ``a / b`` with XLA's flush, ``a`` or ``b`` a tensor. The f64
    quotient rounded to f32 is the IEEE f32 quotient (53 >= 2 * 24 + 2
    bits); ``b`` is a tensor on the device, never a host scalar, which
    torch's CUDA division would turn into a multiply by its reciprocal."""
    dev = _device(a, b)
    return _flush_exact(_operand(a, dev) / _operand(b, dev))


def quantize_blocks_plain(x: torch.Tensor):
    """(rows, block) float -> (q int8 (rows, block), scales f32 (rows, 1))
    (``kernels/ref.py:11``), subnormals flushed as the module says."""
    x = flush_subnormals(x.float())
    amax = x.abs().amax(dim=-1, keepdim=True)
    # tensor / tensor: true IEEE divisions, as the reference and the kernel
    # take them (PyTorch's CUDA `t / scalar` multiplies by a reciprocal)
    scale = torch.div(amax, torch.full_like(amax, 127.0))
    scale = torch.where(scale < FLT_MIN, torch.zeros_like(scale), scale)
    inv = torch.where(scale > 0.0,
                      torch.div(torch.ones_like(scale), scale),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(x * inv), -127.0, 127.0).to(torch.int8)
    return q, scale


def dequantize_blocks_plain(q: torch.Tensor, scales: torch.Tensor,
                            out_dtype=torch.float32) -> torch.Tensor:
    """(rows, block) int8, (rows, 1) f32 -> (rows, block) ``out_dtype``
    (``kernels/ref.py:21``), a subnormal scale read as zero."""
    return (q.float() * flush_subnormals(scales.float())).to(out_dtype)


def build() -> ctypes.CDLL:
    """Compile (or load the cached) kernel library and bind its symbols."""
    lib = _build.load("quantize", SOURCES)
    for sym in (*_QUANTIZE.values(), *_DEQUANTIZE.values()):
        fn = getattr(lib, sym)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.quantize_fast_path.argtypes = [ctypes.c_int64, ctypes.c_int,
                                       ctypes.c_void_p, ctypes.c_void_p]
    lib.quantize_fast_path.restype = ctypes.c_int
    lib.quantize_empty_launch.argtypes = [ctypes.c_void_p]
    lib.quantize_empty_launch.restype = ctypes.c_int
    lib.quantize_error_string.argtypes = [ctypes.c_int]
    lib.quantize_error_string.restype = ctypes.c_char_p
    return lib


def fast_path(t: torch.Tensor, float_dtype) -> bool:
    """Whether a kernel call on the (rows, block) CUDA tensor ``t`` takes
    the kernels' fast path: ``t`` is quantize's input (``float_dtype`` its
    dtype) or dequantize's int8 input (``float_dtype`` the output's). The
    launcher decides from the block, the float dtype and both pointers; the
    wrappers' fresh outputs are always 16-byte aligned."""
    return bool(build().quantize_fast_path(
        t.shape[1], torch.finfo(float_dtype).bits // 8, t.data_ptr(), 0))


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
