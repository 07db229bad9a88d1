"""Cross-pod federated training on the PyTorch port, the twin of
``examples/multipod_fl_train.py``: each 'pod' runs K local AdamW steps on
its own data shard, then pods exchange int8-quantised deltas (the paper's
cross-silo round at pod granularity). Loss must drop and pods must stay
in sync. Runs on the CUDA card unless ``--device`` names another device:

    PYTHONPATH=src python examples_torch/multipod_fl_train.py [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 8 \
        examples_torch/multipod_fl_train.py [--device cpu]

The world size decides the layout. The reference executes its 2 pods on
a (2, 2, 2) mesh of 8 host devices; launched as 8 ranks (8 cards over
NCCL, or 8 CPU processes over gloo) the twin does the same: one pod a
``pod`` coordinate, each pod's parameters FSDP over ``data`` and stored
over ``model``, its batch split over ``data``. Launched alone it stacks
both pods on its one device: a (1, 1, 1) mesh planned for
``MeshConfig((2, 1, 1), ...)``, each pod's steps written into its slice of
the stacked trees (``launch/step_builders.make_fl_round_step``). Every
rank prints; every rank's asserts hold.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import _dist, _tree  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import (MeshConfig, ShapeConfig,  # noqa: E402
                                      TrainConfig)
from repro_torch.data import synthetic_lm_batch  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.step_builders import (make_fl_round_step,  # noqa: E402
                                              stack_pods)
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.sharding import gather_tree  # noqa: E402

POD_AXES = ("pod", "data", "model")
N_PODS = 2
K = 4  # local steps a pod
ROUNDS = 8
SEQ, POD_BATCH = 32, 4
TRAIN = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=64,
                    crosspod_compression="int8")


def mesh_shape(world: int) -> tuple:
    """The (pod, data, model) mesh of ``world`` ranks: (1, 1, 1) alone,
    the reference's (2, 2, 2) at 8; pods first, then data."""
    pod = min(world, N_PODS)
    data = min(world // pod, 2)
    if pod * data * (world // (pod * data)) != world or world % pod:
        raise ValueError(f"no (pod, data, model) mesh of {world} ranks for "
                         f"{N_PODS} pods")
    return (pod, data, world // (pod * data))


def round_bundle(cfg, device):
    """The round's step bundle: the pods stacked on one device, or over
    the ranks of the process group the launcher started."""
    world = _dist.launched_world_size()
    if world > 1:
        device = _dist.init(device)
    shape3 = mesh_shape(world)
    mesh = make_mesh(MeshConfig(shape3, POD_AXES), device)
    shape = ShapeConfig(name="fl", seq_len=SEQ,
                        global_batch=N_PODS * POD_BATCH, kind="train")
    plan = (N_PODS,) + shape3[1:]
    return make_fl_round_step(cfg, shape, mesh, MeshConfig(plan, POD_AXES),
                              TRAIN, local_steps=K)


def round_batches(rng, cfg, device):
    """One round's batches, (pods, K, POD_BATCH, SEQ), from ``rng``."""
    raw = synthetic_lm_batch(rng, N_PODS * K * POD_BATCH, SEQ,
                             cfg.vocab_size)
    return {k: torch.from_numpy(v).reshape(N_PODS, K, POD_BATCH, SEQ)
            .to(device) for k, v in raw.items()}


def run_rounds(rounds=ROUNDS, *, device=None, params=None, cfg=None):
    """``rounds`` FL rounds of qwen3-8b's smoke config (or ``cfg``) from
    ``params`` (drawn from a generator seeded 0 when not given). ->
    (losses, the pods' stacked parameters, their optimizer states, the
    anchor)."""
    cfg = cfg or smoke_config("qwen3-8b")
    bundle = round_bundle(cfg, device)
    anchor = params if params is not None else bundle.model.init(
        torch.Generator().manual_seed(0))
    stacked = stack_pods(anchor, N_PODS)
    opt = stack_pods(adamw_init(anchor, TRAIN), N_PODS)
    rng = np.random.default_rng(0)
    losses = []
    for rnd in range(rounds):
        batches = round_batches(rng, cfg, bundle.model.device)
        stacked, opt, anchor, loss = bundle.fn(stacked, opt, anchor, batches,
                                               rnd * K)
        losses.append(float(loss))
        print(f"[multipod-fl] round {rnd} (K={K} local steps/pod, int8 "
              f"delta sync): loss={losses[-1]:.3f}")
    return losses, stacked, opt, anchor


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    losses, stacked, _, _ = run_rounds(device=args.device)
    # pods hold identical params after sync (every rank gathers)
    leaf = _tree.leaves(gather_tree(stacked))[0]
    drift = float(torch.max(torch.abs(leaf[0].float() - leaf[1].float())))
    print(f"[multipod-fl] loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"cross-pod param drift after sync = {drift:.2e}")
    if not losses[-1] < losses[0]:
        raise AssertionError("no learning?")
    if not drift < 1e-3:
        raise AssertionError("pods out of sync")
    print("[multipod-fl] OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
