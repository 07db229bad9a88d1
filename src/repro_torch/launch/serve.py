"""Port of ``src/repro/launch/serve.py``: the serving driver, batched
prefill + greedy decode with a KV/SSM cache.

Runs on the card unless ``--device`` names another; the CLI serves the
reduced ``smoke_config`` of ``--arch`` as the reference's does:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --requests 8 --prompt-len 32 --gen 16 [--device cpu]

``generate`` is the loop itself, for any model and parameters (the chip
smoke test drives it at full width). Each decode step updates the cache
in place.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List

import torch

from repro_torch._device import synchronize
from repro_torch.configs import ARCH_ORDER, smoke_config


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor  # (requests, gen) int32, on the host
    prompt_logits: torch.Tensor  # (requests, prompt_len, vocab), the prefill's
    prefill_s: float
    decode_s: float
    step_s: List[float]  # each generated token's step, to its host copy


def generate(model, params, prompts: torch.Tensor, gen: int) -> Generation:
    """Prefill ``prompts`` (requests, prompt_len) through decode steps (one
    path for every family's cache), then decode ``gen`` tokens greedily,
    under ``torch.inference_mode``."""
    b, plen = prompts.shape
    with torch.inference_mode():
        cache = model.init_cache(b, plen + gen)
        t0 = time.perf_counter()
        seen = []
        for pos in range(plen):
            batch = {"tokens": prompts[:, pos:pos + 1], "pos": pos}
            logits, cache = model.decode_step(params, cache, batch)
            seen.append(logits.reshape(b, 1, -1))
        synchronize(logits)
        prefill_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        out, step_s = [], []
        tok = torch.argmax(logits.reshape(b, -1), dim=-1,
                           keepdim=True).to(torch.int32)
        for i in range(gen):
            t1 = time.perf_counter()
            batch = {"tokens": tok, "pos": plen + i}
            logits, cache = model.decode_step(params, cache, batch)
            tok = torch.argmax(logits.reshape(b, -1), dim=-1,
                               keepdim=True).to(torch.int32)
            out.append(tok.cpu())
            step_s.append(time.perf_counter() - t1)
        decode_s = time.perf_counter() - t0
    return Generation(torch.cat(out, dim=1), torch.cat(seen, dim=1),
                      prefill_s, decode_s, step_s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=ARCH_ORDER)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch)
    if not cfg.causal:
        print(f"[serve] {args.arch} is encoder-only; no decode loop")
        return 0
    from repro_torch.models import build_model
    model = build_model(cfg, device=args.device)
    g = torch.Generator().manual_seed(0)
    params = model.init(g)

    b = args.requests
    prompts = torch.randint(0, cfg.vocab_size, (b, args.prompt_len),
                            generator=g).to(model.device)
    run = generate(model, params, prompts, args.gen)
    gen = run.tokens.numpy()
    assert gen.shape == (b, args.gen) and (gen >= 0).all()
    print(f"[serve] {b} reqs: prefill({args.prompt_len} tok) "
          f"{run.prefill_s:.2f}s, decode {args.gen} tok in "
          f"{run.decode_s:.2f}s "
          f"({b * args.gen / max(run.decode_s, 1e-9):.1f} tok/s)")
    print(f"[serve] sample generation: {gen[0][:8].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
