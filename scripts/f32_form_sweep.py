"""How far the port's f32 results move with the form of the normalisation
and of the depthwise conv, on the CPU (no card, no JAX).

    PYTHONPATH=src python scripts/f32_form_sweep.py --seeds 0:24
    PYTHONPATH=src python scripts/f32_form_sweep.py --kink
    PYTHONPATH=src python scripts/f32_form_sweep.py --phase8

--seeds: for each seed, full-width MobileNetV3 (``MobileNetConfig()``) from
the port's init and the silos' 16x16 batch of 16 (``chip_smoke.py`` phase
10's configuration at seed 8), the worst per-leaf gradient error of an f32
run against the f64 run of the same form, relative to the leaf's largest
entry (the ``bn_p`` biases, zero in exact arithmetic, left out), for each
form in FORMS; the count of seeds past 2e-4 ends each column.
--kink: at seed 8, the normalised value of ``blocks[12].bn_d`` that sits
next to hard_swish's kink at 3, in f64 and in f32 under each form.
--phase8: ``chip_smoke.py`` phase 8's reduced semisync run (no codec) on
the CPU in f32 under each form, each pair of forms compared per leaf.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import _tree  # noqa: E402
from repro_torch.data import make_silo_datasets  # noqa: E402
from repro_torch.models import vision as V  # noqa: E402

REPO_NORM, REPO_CONV = V.norm_apply, V.conv


def conv_channels_last(x, w, stride=1, groups=1):
    """``conv`` as it was before the depthwise convs took an NCHW copy."""
    ph = V._same_pad(x.shape[1], w.shape[0], stride)
    pw = V._same_pad(x.shape[2], w.shape[1], stride)
    xc = x.permute(0, 3, 1, 2)
    if any(ph) or any(pw):
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def norm_mean64(p, x, eps=1e-5):
    mean = torch.mean(x, dim=(0, 1, 2), keepdim=True, dtype=torch.float64)
    var = torch.var(x, dim=(0, 1, 2), keepdim=True, unbiased=False)
    return (x - mean.to(x.dtype)) * torch.rsqrt(var + eps) * p["scale"] \
        + p["bias"]


def norm_stats64(p, x, eps=1e-5):
    x64 = x.double()
    mean = torch.mean(x64, dim=(0, 1, 2), keepdim=True)
    var = torch.var(x64, dim=(0, 1, 2), keepdim=True, unbiased=False)
    return ((x64 - mean) * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"] \
        + p["bias"]


def norm_var_mean(p, x, eps=1e-5):
    var, mean = torch.var_mean(x, dim=(0, 1, 2), keepdim=True,
                               unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


# name -> (norm_apply, conv)
FORMS = {"repo": (REPO_NORM, REPO_CONV),
         "dw-channels-last": (REPO_NORM, conv_channels_last),
         "mean64": (norm_mean64, conv_channels_last),
         "stats64": (norm_stats64, conv_channels_last),
         "var_mean": (norm_var_mean, conv_channels_last)}


def use(form: str) -> None:
    V.norm_apply, V.conv = FORMS[form]


def setup(seed: int):
    model = V.MobileNetV3(V.MobileNetConfig(), device="cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    silo = make_silo_datasets(1, kind="image", examples_per_silo=64,
                              num_classes=8, image_size=16, seed=seed)[0]
    batch = {k: torch.as_tensor(v)
             for k, v in next(silo.batches(16, seed=1)).items()}
    return model, params, batch


def grads(model, params, batch, dtype):
    leaves, treedef = _tree.flatten(params)
    leaves = [l.detach().to(dtype).requires_grad_(True) for l in leaves]
    b = {k: v.to(dtype) if v.is_floating_point() else v
         for k, v in batch.items()}
    loss, _ = model.loss(_tree.unflatten(treedef, leaves), b)
    return [g.double() for g in torch.autograd.grad(loss, leaves)]


def zero_leaves(params) -> set:
    marked = _tree.map(lambda a: 0, params)
    for blk in marked["blocks"]:
        blk["bn_p"]["bias"] = 1
    return {i for i, v in enumerate(_tree.leaves(marked)) if v == 1}


def sweep(seeds) -> None:
    print("seed " + " ".join(f"{f:>16}" for f in FORMS), flush=True)
    worst = {f: [] for f in FORMS}
    for seed in seeds:
        model, params, batch = setup(seed)
        zero = zero_leaves(params)
        for form in FORMS:
            use(form)
            want = grads(model, params, batch, torch.float64)
            got = grads(model, params, batch, torch.float32)
            worst[form].append(max(
                float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                for i, (g, w) in enumerate(zip(got, want)) if i not in zero))
        print(f"{seed:4d} " + " ".join(f"{worst[f][-1]:16.3e}" for f in FORMS),
              flush=True)
    print("> 2e-4 " + " ".join(f"{sum(e > 2e-4 for e in worst[f]):14d}"
                               for f in FORMS))


def kink() -> None:
    """blocks[12].bn_d's input is captured at its norm (stem, then bn_e,
    bn_d, bn_p per block: call 1 + 12 * 3 + 1) and normalised in f64."""
    model, params, batch = setup(8)
    for form in FORMS:
        use(form)
        seen = {}
        norm = V.norm_apply

        def capture(p, x, eps=1e-5):
            out = norm(p, x, eps)
            seen.setdefault(x.dtype, []).append(out.detach())
            return out

        V.norm_apply = capture
        with torch.no_grad():
            for dtype in (torch.float64, torch.float32):
                model.forward(_tree.map(lambda a: a.to(dtype), params),
                              batch["images"].to(dtype))
        at = 1 + 12 * 3 + 1
        print(f"{form:>16}: blocks[12].bn_d[8, 0, 0, 932] f64 "
              f"{float(seen[torch.float64][at][8, 0, 0, 932]):.9f} f32 "
              f"{float(seen[torch.float32][at][8, 0, 0, 932]):.9f} "
              f"(hard_swish's kink at 3)", flush=True)


def phase8() -> None:
    import chip_smoke as cs
    argv = ["--mode", "semisync", "--quorum", "1.0", "--backend",
            "torch_rpc", "--environment", "geo_distributed", "--clients",
            "3", "--rounds", "2", "--local-steps", "2", "--compression",
            "none"]
    runs = {}
    for form in ("repo", "var_mean", "stats64"):
        use(form)
        runs[form] = cs.event_run(argv, "cpu", reduced=True)[1].global_params
    names = list(runs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            errs = cs.leaf_errors(runs[a], runs[b])
            j = max(range(len(errs)),
                    key=lambda n: errs[n][0] / max(errs[n][1], 1e-12))
            print(f"phase 8 configuration, CPU f32, {a} vs {b}: per leaf "
                  f"{errs[j][0] / max(errs[j][1], 1e-12):.3e} of its largest "
                  f"entry (leaf {j}: err {errs[j][0]:.3e}, largest "
                  f"{errs[j][1]:.3e})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", help="first:last (last excluded)")
    ap.add_argument("--kink", action="store_true")
    ap.add_argument("--phase8", action="store_true")
    args = ap.parse_args()
    if args.seeds:
        first, last = map(int, args.seeds.split(":"))
        sweep(range(first, last))
    if args.kink:
        kink()
    if args.phase8:
        phase8()
    return 0


if __name__ == "__main__":
    sys.exit(main())
