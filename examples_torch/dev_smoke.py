"""Dev-only quick check of every family's fwd/bwd/decode on tiny configs,
on the PyTorch port: the twin of ``scripts/dev_smoke.py``. Runs on the
CUDA card unless ``--device`` names another device:

    PYTHONPATH=src python examples_torch/dev_smoke.py [arch ...] [--device cpu]
"""
import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch import _tree  # noqa: E402
from repro_torch.configs import ARCH_ORDER, smoke_config  # noqa: E402
from repro_torch.launch.step_builders import value_and_grad  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import dtype_of  # noqa: E402

B, S = 2, 16


def smoke_batch(cfg, device):
    """The check's batch, from a generator seeded 0: tokens (or frame
    embeddings), the VLM's image embeddings, targets."""
    g = torch.Generator().manual_seed(0)
    dt = dtype_of(cfg.dtype)
    batch = {}
    if cfg.external_embeddings:
        batch["embeds"] = torch.randn((B, S, cfg.d_model), generator=g).to(dt)
    else:
        batch["tokens"] = torch.randint(0, cfg.vocab_size, (B, S),
                                        generator=g, dtype=torch.int32)
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.randn(
            (B, cfg.num_image_tokens, cfg.d_model), generator=g).to(dt)
    batch["targets"] = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                     dtype=torch.int32)
    return {k: v.to(device) for k, v in batch.items()}


def check(name, *, device=None, params=None, cfg=None):
    """``name``'s smoke config (or ``cfg``): the loss, the gradient norm
    and one decode step, each asserted finite. -> (n_params, loss,
    gnorm)."""
    cfg = cfg or smoke_config(name)
    model = build_model(cfg, device=device)
    if params is None:
        params = model.init(torch.Generator().manual_seed(0))
    n = sum(math.prod(l.shape) for l in _tree.leaves(params))
    batch = smoke_batch(cfg, model.device)

    loss, grads = value_and_grad(model, params, batch)
    if not torch.isfinite(loss):
        raise AssertionError((name, float(loss)))
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in _tree.leaves(grads)))
    if not torch.isfinite(gnorm):
        raise AssertionError((name, "grad nan"))

    out = [f"{name}: params={n:,} loss={float(loss):.3f} "
           f"gnorm={float(gnorm):.3f}"]
    if cfg.causal:
        with torch.no_grad():
            cache = model.init_cache(B, 32)
            tokens = batch.get("tokens", torch.zeros(
                (B, S), dtype=torch.int32, device=model.device))
            logits, cache = model.decode_step(
                params, cache, {"tokens": tokens[:, :1], "pos": 0})
        if not bool(torch.isfinite(logits.float()).all()):
            raise AssertionError((name, "decode nan"))
        out.append("decode ok")
    print(" | ".join(out))
    return n, float(loss), float(gnorm)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="*", help=f"any of {ARCH_ORDER}")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    unknown = set(args.archs) - set(ARCH_ORDER)
    if unknown:
        ap.error(f"unknown archs {sorted(unknown)}; pick from {ARCH_ORDER}")
    for nm in args.archs or ARCH_ORDER:
        check(nm, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
