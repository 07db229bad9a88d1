"""How far xLSTM's recurrent decode drifts from its chunkwise forward in
bf16, at xlstm-1.3b's widths, in the JAX reference and in the PyTorch
port.

xlstm-1.3b's widths (d_model 2048, 4 heads of 1024) with the depth cut to
each of ``--layers`` (multiples of ``slstm_every`` = 8) and the
vocabulary to 4,096. Both packages start from the reference's initialised
bf16 parameters, and the f32 runs from the same values made f32. For each
depth it prints, each as a fraction of the largest |logit|: decode
against forward at the prompt's positions in bf16 and in f32, bf16
against f32 (forward and decode), in each package; and each package's
forward and decode against the other's, in bf16 and in f32.

    PYTHONPATH=src python tests/xlstm_bf16_drift.py [--layers 8 16]

(~1 minute and ~4 GiB of host memory at 8 layers, on the CPU.)

``--port-only --device cuda`` runs the port alone, on the card, from
parameters the port draws there (seed 14, as ``chip_smoke.py`` phase 14
draws them); it imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model

VOCAB = 4096


def reference_run(cfg, params, tokens):
    """-> (forward logits, decode logits at every position), f32 numpy."""
    import jax
    import jax.numpy as jnp

    from repro.models import build_model as jbuild
    model = jbuild(cfg)
    b, s = tokens.shape
    full = jax.jit(model.forward)(params, {"tokens": jnp.asarray(tokens)})[0]
    step = jax.jit(model.decode_step)
    cache, out = model.init_cache(b, s), []
    for pos in range(s):
        logits, cache = step(params, cache, {
            "tokens": jnp.asarray(tokens[:, pos:pos + 1]),
            "pos": jnp.int32(pos)})
        out.append(np.asarray(logits, np.float32).reshape(b, -1))
    return np.asarray(full, np.float32), np.stack(out, axis=1)


def port_run(cfg, params, tokens, device):
    model = build_model(cfg, device=device)
    b, s = tokens.shape
    t = torch.from_numpy(tokens).to(device)
    with torch.inference_mode():
        full = model.forward(params, {"tokens": t})[0].float().cpu().numpy()
        cache, out = model.init_cache(b, s), []
        for pos in range(s):
            logits, cache = model.decode_step(
                params, cache, {"tokens": t[:, pos:pos + 1], "pos": pos})
            out.append(logits.float().reshape(b, -1).cpu().numpy())
    return full, np.stack(out, axis=1)


def rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def drift(name, runs):
    """``runs``: {"bf16": (forward, decode), "f32": (forward, decode)}."""
    (bf, bd), (ff, fd) = runs["bf16"], runs["f32"]
    return (f"{name}: decode vs forward bf16 {rel(bd, bf):.4e}, f32 "
            f"{rel(fd, ff):.4e}; bf16 vs f32 forward {rel(bf, ff):.4e}, "
            f"decode {rel(bd, fd):.4e}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[8])
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--port-only", action="store_true")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    tokens = np.random.default_rng(0).integers(
        0, VOCAB, (args.requests, args.prompt_len)).astype(np.int32)
    for layers in args.layers:
        change = dict(num_layers=layers, vocab_size=VOCAB)
        cfgs = {dt: dataclasses.replace(get_config("xlstm-1.3b"), dtype=dt,
                                        param_dtype=dt, **change)
                for dt in ("bfloat16", "float32")}
        port, ref = {}, {}
        if args.port_only:
            params = build_model(cfgs["bfloat16"], device=device).init(
                torch.Generator(device=device).manual_seed(14))
        else:
            import jax
            import jax.numpy as jnp

            from repro.configs import get_config as jget
            from repro.models import build_model as jbuild
            jcfgs = {dt: dataclasses.replace(
                jget("xlstm-1.3b"), dtype=dt, param_dtype=dt, **change)
                for dt in cfgs}
            jparams = jbuild(jcfgs["bfloat16"]).init(jax.random.key(0))[0]
            params = params_from_jax(
                jax.tree.map(np.asarray, jparams), device,
                like=build_model(cfgs["bfloat16"], device="meta").init(None))
            ref["bf16"] = reference_run(jcfgs["bfloat16"], jparams, tokens)
            ref["f32"] = reference_run(
                jcfgs["float32"],
                jax.tree.map(lambda a: a.astype(jnp.float32), jparams),
                tokens)
        port["bf16"] = port_run(cfgs["bfloat16"], params, tokens, device)
        port["f32"] = port_run(cfgs["float32"],
                               _tree.map(lambda a: a.float(), params),
                               tokens, device)
        head = (f"xlstm-1.3b widths, {layers} layers, {args.requests} x "
                f"{args.prompt_len} tokens, on {args.device}, each of the "
                f"largest |logit|")
        lines = [drift("port", port)]
        if ref:
            lines.append(drift("reference", ref))
            lines.append(
                "port vs reference: bf16 forward "
                f"{rel(port['bf16'][0], ref['bf16'][0]):.4e}, decode "
                f"{rel(port['bf16'][1], ref['bf16'][1]):.4e}; f32 forward "
                f"{rel(port['f32'][0], ref['f32'][0]):.4e}, decode "
                f"{rel(port['f32'][1], ref['f32'][1]):.4e}")
        print(head + "\n  " + "\n  ".join(lines), flush=True)
        del params, port, ref


if __name__ == "__main__":
    main()
