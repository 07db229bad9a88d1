"""Port of ``src/repro/kernels/topk.py``: batched magnitude top-k
selection, the sparsification hot spot of the top-k payload codec.

Per row of a (B, T) input, the k entries of largest |x| as (idx int32,
signed vals f32), ordered by |x| descending with ties going to the lower
index: ``jax.lax.top_k``'s rule, and the Pallas kernel's.

Dispatch is by the device of the tensor given: a CPU tensor goes to the
plain version; a CUDA tensor goes to the hand-written Hopper kernels in
``csrc/topk.cu`` (a radix select, an ordered compaction and a stable
radix sort of the survivors; built with ``nvcc`` at first use) or raises.
``LAUNCHES`` counts ``topk_rows`` calls that launched the kernels, so a
run can show that its path went through them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCES = ("topk.cu",)
LAUNCHES = 0
MAX_ROWS = 65_535  # the kernels put rows on grid.y

_SYMBOLS = {torch.float32: "topk_rows_f32", torch.bfloat16: "topk_rows_bf16"}


def topk_rows_plain(x: torch.Tensor, k: int):
    """(B, T) float -> (idx (B, k) int32, vals (B, k) f32)
    (``kernels/ref.py:topk_rows_ref``). A stable descending sort keeps
    equal |x| in index order; ``torch.topk`` does not promise that."""
    xf = x.float()
    order = torch.sort(xf.abs(), dim=-1, descending=True, stable=True)[1]
    idx = order[:, :k]
    return idx.to(torch.int32), torch.gather(xf, -1, idx)


def build() -> ctypes.CDLL:
    """Compile (or load the cached) kernel library and bind its symbols."""
    lib = _build.load("topk", SOURCES)
    for sym in _SYMBOLS.values():
        fn = getattr(lib, sym)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.topk_rows_scratch_words.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                            ctypes.c_int64]
    lib.topk_rows_scratch_words.restype = ctypes.c_int64
    lib.topk_error_string.argtypes = [ctypes.c_int]
    lib.topk_error_string.restype = ctypes.c_char_p
    return lib


def topk_rows(x: torch.Tensor, k: int):
    """x: (B, T) f32 or bf16, contiguous; 1 <= k <= T -> (idx (B, k)
    int32, vals (B, k) f32) on x's device."""
    if x.dim() != 2:
        raise ValueError(f"topk_rows: need (B, T), got {tuple(x.shape)}")
    b, t = x.shape
    k = int(k)
    if not 1 <= k <= t:
        raise ValueError(f"topk_rows: need 1 <= k <= T = {t}, got k = {k}")
    if x.device.type == "cpu":
        return topk_rows_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"topk_rows: no kernel for {x.device}")
    if x.dtype not in _SYMBOLS:
        raise TypeError(f"topk_rows: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("topk_rows: x must be contiguous")
    if b > MAX_ROWS or t >= 2 ** 31:
        raise ValueError(f"topk_rows: at most {MAX_ROWS} rows of fewer "
                         f"than 2**31 entries, got {tuple(x.shape)}")
    idx = torch.empty((b, k), dtype=torch.int32, device=x.device)
    vals = torch.empty((b, k), dtype=torch.float32, device=x.device)
    if b == 0:
        return idx, vals
    lib = build()
    scratch = torch.empty(lib.topk_rows_scratch_words(b, t, k),
                          dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, _SYMBOLS[x.dtype])(
            x.data_ptr(), idx.data_ptr(), vals.data_ptr(),
            scratch.data_ptr(), b, t, k, stream)
    if rc != 0:
        raise RuntimeError(f"topk_rows kernel launch failed: "
                           f"{lib.topk_error_string(rc).decode()}")
    global LAUNCHES
    LAUNCHES += 1
    return idx, vals
