"""Cross-silo FL demo on the PyTorch port, the twin of
``examples/cross_silo_fl.py``: the paper end to end.

Trains the Small tier (ResNet) across 7 geo-distributed silos under THREE
backends, printing the paper's per-state breakdown, then demonstrates the
fault story: a client drops mid-round — MPI aborts, gRPC+S3 sails on and
the late client re-fetches from the object store. Runs on the CUDA card
unless ``--device`` names another device:

    PYTHONPATH=src python examples_torch/cross_silo_fl.py [--device cpu]

``deploy`` builds one deployment and ``train_rounds`` runs its rounds, so
a caller can change the clients in between.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core import TensorPayload  # noqa: E402
from repro_torch.launch.fl_train import build_deployment  # noqa: E402

BACKENDS = ("grpc", "torch_rpc", "grpc+s3")
QUORUM = 0.7
LOCAL_STEPS = 3
DROPPED = frozenset({"client0", "client1"})


def deploy(backend, *, device, reduced=True):
    """-> (server, initial parameters, object store) of one deployment:
    7 geo-distributed silos, quorum 0.7, 3 local steps; the reduced ResNet
    unless ``reduced`` is False (full-width ResNet56)."""
    cfg = FLConfig(backend=backend, environment="geo_distributed",
                   quorum_fraction=QUORUM)
    server, params, _, store = build_deployment(
        cfg, reduced=reduced, local_steps=LOCAL_STEPS, device=device)
    return server, params, store


def train_rounds(server, params, rounds=2, dropped=None):
    """``rounds`` sync rounds from ``params``; ``dropped`` clients drop in
    the first. -> (the rounds' reports, the final parameters)."""
    out = []
    for r in range(rounds):
        rep = server.run_round(TensorPayload(params),
                               dropped=dropped if r == 0 else None)
        if server.global_params is not None:
            params = server.global_params
        out.append(rep)
    return out, params


def run(device):
    """The demo: -> ({backend: its rounds' reports} for the three backends,
    {backend: (report, store)} of the fault story)."""
    print("== cross-silo FL, 7 geo-distributed silos, Small tier ==")
    out, fault = {}, {}
    for backend in BACKENDS:
        server, params, store = deploy(backend, device=device)
        reps, _ = train_rounds(server, params)
        out[backend] = reps
        r = reps[-1]
        print(f"\n-- {backend}: round={r.round_time:.2f}s sim, "
              f"loss {reps[0].losses:.3f} -> {reps[-1].losses:.3f}, "
              f"server peak mem {r.peak_server_memory / 2 ** 20:.1f}MB")
        print(f"   client states: comm={r.clients['communication']:.2f}s "
              f"train={r.clients['training']:.2f}s "
              f"ser={r.clients['serialization']:.3f}s "
              f"wait={r.clients['waiting']:.2f}s")

    print("\n== fault tolerance: client0+client1 drop mid-round ==")
    for backend in ("mpi_generic", "grpc+s3"):
        server, params, store = deploy(backend, device=device)
        (rep,), _ = train_rounds(server, params, rounds=1, dropped=DROPPED)
        fault[backend] = (rep, store)
    rep, _ = fault["mpi_generic"]
    print(f"   mpi_generic : aborted={rep.aborted} (static world -> "
          "restore checkpoint + re-run)")
    rep, store = fault["grpc+s3"]
    print(f"   grpc+s3     : aborted={rep.aborted}, "
          f"participants={rep.n_participants}/7 (quorum), "
          f"late clients re-fetch from S3 "
          f"(stats={dict(store.stats)})")
    return out, fault


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
