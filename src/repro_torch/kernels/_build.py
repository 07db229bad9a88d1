"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each library is compiled at first use for Hopper (``sm_90a``) into
``build/kernels/`` at the root of the checkout, under a name keyed by a
hash of its sources and flags, so an edited source rebuilds and an
unchanged one loads the cached ``.so``. The sources have a plain C
interface and include no PyTorch header, which keeps a build to seconds.
Nothing here runs at import time: a machine without ``nvcc`` can import
every module and only fails when a kernel is actually asked for.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                           "toolkit's bin/ on PATH to build the kernels")
    return found


def library_path(name: str, sources) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load(name: str, sources) -> ctypes.CDLL:
    """Compile ``csrc/<sources>`` into ``lib<name>`` if needed and load it.
    The compiler's report (``-Xptxas -v``: registers, spills) is kept next
    to the library as ``.log``."""
    if name in _loaded:
        return _loaded[name]
    so = library_path(name, sources)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC / s) for s in sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
    lib = ctypes.CDLL(str(so))
    _loaded[name] = lib
    return lib
