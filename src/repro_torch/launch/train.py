"""Port of ``src/repro/launch/train.py``: the training driver.

Runs on the card unless ``--device`` names another device; the CLI
trains the reduced ``smoke_config`` of ``--arch``, as the reference's
does (its ``--smoke`` flag is on by default and cannot be turned off):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
        --steps 30 --ckpt-dir ckpt [--device cpu]

Restart behaviour: if ``--ckpt-dir`` holds a checkpoint, training resumes
from it (kill the process mid-run and rerun the command). A resumed run
first skips the data batches the saved steps trained on, so it sees what
an uninterrupted run would (the reference restarts its data stream).

``train`` is the loop itself, for any config (the chip smoke test drives
it at full width).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_ORDER, get_config, smoke_config
from repro_torch.configs.base import (SMOKE_MESH, ModelConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.data import lm_batch_iterator
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.step_builders import make_train_step
from repro_torch.optim.optimizers import adamw_init


@dataclasses.dataclass
class TrainRun:
    params: dict
    opt_state: object
    losses: List[float]  # one per step run here
    step_s: List[float]  # each step's wall seconds, to its loss on the host
    start_step: int  # the step this run began at (> 0 when resumed)


def lm_batch(cfg: ModelConfig, np_batch, step: int, device):
    """Step ``step``'s model inputs from a synthetic numpy batch on
    ``device``: frame embeddings for an ``external_embeddings`` arch, zero
    image embeddings for a VLM, as the reference's loop feeds them."""
    batch = {k: torch.from_numpy(v).to(device) for k, v in np_batch.items()}
    b, s = batch["targets"].shape
    if cfg.external_embeddings:
        # jax's random streams cannot be reproduced: frame embeddings from
        # a generator seeded with the step, as the reference folds it in
        g = torch.Generator().manual_seed(step)
        embeds = torch.randn((b, s, cfg.d_model), generator=g)
        batch = {"embeds": embeds.to(device, torch.bfloat16),
                 "targets": batch["targets"]}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.zeros(
            (b, cfg.num_image_tokens, cfg.d_model), dtype=torch.bfloat16,
            device=device)
    return batch


def train(cfg: ModelConfig, shape: ShapeConfig, train_cfg: TrainConfig,
          steps: int, *, ckpt_dir: str = "", ckpt_every: int = 10,
          device=None, generator: torch.Generator = None,
          log=print) -> TrainRun:
    """Train ``cfg`` to step ``steps`` on synthetic LM batches (seed 0) of
    ``shape``: parameters drawn from ``generator`` (seed 0 on the host by
    default), AdamW, a checkpoint every ``ckpt_every`` steps under
    ``ckpt_dir``, resuming from its latest."""
    mesh = make_smoke_mesh(device)
    bundle = make_train_step(cfg, shape, mesh, SMOKE_MESH, train_cfg)
    model = bundle.model
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = model.init(generator)
    opt_state = adamw_init(params, train_cfg)
    start_step = 0
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if ckpt is not None and ckpt.latest_step() is not None:
        (params, opt_state), start_step, _ = ckpt.restore(
            (params, opt_state), device=model.device)
        log(f"[train] resumed from step {start_step}")

    data = lm_batch_iterator(0, shape.global_batch, shape.seq_len,
                             cfg.vocab_size)
    for _ in range(start_step):
        next(data)
    losses, step_s = [], []
    for step in range(start_step, steps):
        batch = lm_batch(cfg, next(data), step, model.device)
        t0 = time.perf_counter()
        params, opt_state, metrics = bundle.fn(params, opt_state, batch, step)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)
        if step % 5 == 0 or step == steps - 1:
            log(f"[train] step {step} loss={losses[-1]:.4f} "
                f"gnorm={float(metrics['gnorm']):.3f}")
        if ckpt is not None and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, (params, opt_state))
    if ckpt is not None:
        ckpt.wait()
    return TrainRun(params, opt_state, losses, step_s, start_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=ARCH_ORDER)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeConfig(name="cli", seq_len=args.seq,
                        global_batch=args.batch, kind="train")
    train_cfg = TrainConfig(learning_rate=args.lr, warmup_steps=5,
                            total_steps=args.steps)
    t0 = time.time()
    run = train(cfg, shape, train_cfg, args.steps, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, device=args.device)
    losses = run.losses
    dt = time.time() - t0
    print(f"[train] {args.steps - run.start_step} steps in {dt:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert np.isfinite(losses[-1])
    return 0 if losses[-1] < losses[0] else 1


if __name__ == "__main__":
    raise SystemExit(main())
