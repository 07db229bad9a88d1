"""Quickstart on the PyTorch port, the twin of ``examples/quickstart.py``:
build an assigned arch (reduced), train it on synthetic LM data until the
loss drops, then decode a few tokens. Runs on the CUDA card unless
``--device`` names another device:

    PYTHONPATH=src python examples_torch/quickstart.py [arch] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import ARCH_ORDER, smoke_config  # noqa: E402
from repro_torch.configs.base import (SMOKE_MESH, ShapeConfig,  # noqa: E402
                                      TrainConfig)
from repro_torch.data import lm_batch_iterator  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.launch.step_builders import make_train_step  # noqa: E402
from repro_torch.launch.train import lm_batch  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

STEPS = 40
BATCH, SEQ = 8, 64
DECODE_TOKENS = 8


def run(arch="qwen3-8b", *, steps=STEPS, device=None, params=None, cfg=None):
    """``steps`` AdamW steps of ``arch``'s smoke config (or ``cfg``) at 8 x
    64 from ``params`` (drawn from a generator seeded 0 when not given),
    then 8 greedy decode tokens (causal archs). -> (losses, tokens)."""
    cfg = cfg or smoke_config(arch)
    print(f"[quickstart] arch={arch} (reduced: {cfg.num_layers} layers, "
          f"d={cfg.d_model})")

    shape = ShapeConfig(name="qs", seq_len=SEQ, global_batch=BATCH,
                        kind="train")
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=40)
    mesh = make_smoke_mesh(device)
    bundle = make_train_step(cfg, shape, mesh, SMOKE_MESH, tcfg)
    model = bundle.model

    if params is None:
        params = model.init(torch.Generator().manual_seed(0))
    opt = adamw_init(params, tcfg)
    data = lm_batch_iterator(0, BATCH, SEQ, cfg.vocab_size)

    losses = []
    for step in range(steps):
        batch = lm_batch(cfg, next(data), step, mesh.device)
        params, opt, m = bundle.fn(params, opt, batch, step)
        losses.append(float(m["loss"]))
        if step % 10 == 0:
            print(f"  step {step:3d}  loss {losses[-1]:.3f}")
    print(f"[quickstart] loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'learned' if losses[-1] < losses[0] else 'no progress?!'})")

    tokens = []
    if cfg.causal:
        with torch.no_grad():
            cache = model.init_cache(2, 16)
            tok = torch.zeros((2, 1), dtype=torch.int32, device=mesh.device)
            for pos in range(DECODE_TOKENS):
                logits, cache = model.decode_step(
                    params, cache, {"tokens": tok, "pos": pos})
                lg = logits[:, -1] if logits.dim() == 3 else logits
                tok = torch.argmax(lg, -1, keepdim=True).to(torch.int32)
                tokens.append(int(tok[0, 0]))
        print(f"[quickstart] greedy decode: {tokens}")
    return losses, tokens


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?", default="qwen3-8b", choices=ARCH_ORDER)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    run(args.arch, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
