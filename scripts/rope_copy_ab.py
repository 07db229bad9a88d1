"""What copying RoPE's frequency table to the card on every ``apply_rope``
call costs one full-width ViT-Large training step.

Runs ``chip_smoke.py`` phase 11's ``step_breakdown`` (batch 16 of the
silos' 16x16 images, the live path's ``train_fn``: wall ms synchronised,
device ms of kernels from ``torch.profiler`` and their busy share) in
turns: with the table cached on the card (the port's ``apply_rope``), with
it copied from host memory on every call, then the two again in reverse
order. A copy from pageable host memory waits for the card's queue to
empty, and ``apply_rope`` runs twice a layer. TF32 off, as in
``chip_smoke.py``. Needs one CUDA card:

    python scripts/rope_copy_ab.py
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.vision import ViT, ViTConfig  # noqa: E402

CACHED = L._rope_freqs_on


def copied(head_dim: int, theta: float, device: torch.device):
    return torch.from_numpy(L.rope_freqs(head_dim, theta)).to(device)


def main() -> int:
    if not torch.cuda.is_available():
        print("rope_copy_ab: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    params = ViT(ViTConfig(), device="cuda").init(
        torch.Generator().manual_seed(0))
    for mode in ("cached", "copied", "copied", "cached"):
        L._rope_freqs_on = CACHED if mode == "cached" else copied
        print(f"RoPE table {mode}:", flush=True)
        cs.step_breakdown(smi, params)
    L._rope_freqs_on = CACHED
    return 0


if __name__ == "__main__":
    sys.exit(main())
