"""One live sync FL round of the port against the JAX reference.

Both deployments are built by their own ``build_deployment`` (geo WAN,
3 silos, the reduced ResNet, ``local_steps=2``) and start from the
reference's initial parameters. The silo data streams are identical
(the synthetic pipeline is a numpy copy). Clients charge a fixed
simulated training time on both sides ("live compute, simulated
clock"), so every simulated state except the ones that include the
measured FedAvg seconds is comparable:

* ``torch_rpc`` (zero-copy wires, byte-identical): states are equal;
* ``grpc`` / ``grpc+s3`` (pickled wires): states agree within the
  pickled-treedef header's share of the wire;
* the aggregated parameters and losses agree within the FedAvg bar
  loosened for two SGD steps through f32 convolutions summed in a
  different order (rtol 1e-4, atol 1e-4 of the leaf's largest entry).

``round_time``, ``training`` and ``aggregation`` hold measured wall
seconds and are not compared (ROADMAP "Clock-parity limits").
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs.base import FLConfig as JFLConfig  # noqa: E402
from repro.core import TensorPayload as JPayload  # noqa: E402
from repro.launch.fl_train import build_deployment as jbuild  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.compression.stages import make_codec  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import TensorPayload  # noqa: E402
from repro_torch.core.message import FLMessage, VirtualPayload  # noqa: E402
from repro_torch.fl.client import FLClient  # noqa: E402
from repro_torch.launch import fl_train  # noqa: E402

N_CLIENTS = 3
SIM_TRAIN_S = 2.0
_REF_TRAIN_FN = {}

CLIENT_STATES = ("communication", "serialization", "migration", "training")
SERVER_STATES = ("communication", "serialization", "migration", "waiting")


def _ref(backend, **kw):
    server, params, _, _ = jbuild(
        JFLConfig(backend=backend, num_clients=N_CLIENTS, **kw),
        local_steps=2)
    # the reference jits one train step per client; the steps are the
    # same function of (params, batch), so one compiled step serves all
    fn = _REF_TRAIN_FN.setdefault("fn", server.clients[0].train_fn)
    for c in server.clients:
        c.train_fn = fn
        c.sim_train_s = SIM_TRAIN_S
    return server, jax.tree.map(np.array, params)


def _port(backend, ref_params, **kw):
    server, params, _, _ = fl_train.build_deployment(
        FLConfig(backend=backend, num_clients=N_CLIENTS, **kw),
        local_steps=2, device="cpu")
    for c in server.clients:
        c.sim_train_s = SIM_TRAIN_S
    return server, params_from_jax(ref_params, "cpu", like=params)


@pytest.mark.parametrize("backend,rtol", [("torch_rpc", 0.0),
                                          ("grpc", 1e-2),
                                          ("grpc+s3", 1e-2)])
def test_sync_round_matches_reference(backend, rtol):
    jserver, jparams = _ref(backend)
    tserver, tparams = _port(backend, jparams)
    jrep = jserver.run_round(JPayload(jax.tree.map(jax.numpy.asarray,
                                                   jparams)))
    trep = tserver.run_round(TensorPayload(tparams))

    assert trep.n_participants == jrep.n_participants == N_CLIENTS
    assert not trep.aborted and not jrep.aborted
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=1e-4)
    for k in CLIENT_STATES:
        np.testing.assert_allclose(trep.clients[k], jrep.clients[k],
                                   rtol=rtol, err_msg=f"client {k}")
    for k in SERVER_STATES:
        np.testing.assert_allclose(trep.server[k], jrep.server[k],
                                   rtol=rtol, err_msg=f"server {k}")
    got = _tree.leaves(tserver.global_params)
    want = jax.tree.leaves(jserver.global_params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))


@pytest.mark.parametrize("backend,aborts", [("mpi_generic", True),
                                            ("grpc+s3", False)])
def test_dropped_client_fault_story_matches(backend, aborts):
    """MPI's static world aborts on a lost rank; gRPC+S3 meets quorum."""
    jserver, jparams = _ref(backend, quorum_fraction=0.5)
    tserver, tparams = _port(backend, jparams, quorum_fraction=0.5)
    jrep = jserver.run_round(JPayload(jax.tree.map(jax.numpy.asarray,
                                                   jparams)),
                             dropped={"client0"})
    trep = tserver.run_round(TensorPayload(tparams), dropped={"client0"})
    assert trep.aborted is jrep.aborted is aborts
    assert trep.n_participants == jrep.n_participants == N_CLIENTS - 1
    assert trep.n_dropped == jrep.n_dropped


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        _, params, _, _ = fl_train.build_deployment(
            FLConfig(num_clients=2), local_steps=1)
        assert _tree.leaves(params)[0].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fl_train.build_deployment(FLConfig(num_clients=2), local_steps=1)


def test_client_device_defaults_to_cuda():
    """A client built without ``device`` trains on the card (or raises
    without one); a simulated-mode client needs no card at all."""
    server, params, _, _ = fl_train.build_deployment(
        FLConfig(num_clients=2), local_steps=1, device="cpu")
    built = server.clients[0]
    live = FLClient("c", built.backend, dataset=built.dataset,
                    train_fn=built.train_fn)
    if torch.cuda.is_available():
        new_params, _, _ = live.local_train(params, 1)
        assert _tree.leaves(new_params)[0].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            live.local_train(params, 1)
    sim = FLClient("s", built.backend, sim_train_s=1.0)
    update, timing, _ = sim.run_round(
        FLMessage("model_sync", "server", "s", payload=VirtualPayload(64)),
        ready_t=0.0, local_steps=1)
    assert isinstance(update.payload, VirtualPayload)
    assert timing.training == 1.0 and sim.device is None


def test_cli_runs_sync_rounds_on_cpu(capsys):
    assert fl_train.main(["--rounds", "2", "--clients", "2", "--backend",
                          "torch_rpc", "--local-steps", "1",
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "round 1:" in out and "losses:" in out


@pytest.mark.parametrize("argv", [["--mode", "vertical"],
                                  ["--sweep", "x.json"],
                                  ["--multi", "x.json"]])
def test_cli_refuses_unported_runners(argv, capsys):
    with pytest.raises(SystemExit) as e:
        fl_train.main(argv + ["--device", "cpu"])
    assert e.value.code != 0
    assert "not yet ported" in capsys.readouterr().err


@pytest.mark.parametrize("spec", ["topk", "topk:0.1"])
def test_payload_codecs_build_like_the_reference(spec):
    from repro.compression.stages import make_codec as jmake_codec
    codec, want = make_codec(spec), jmake_codec(spec)
    assert codec.name == want.name == "topk"
    assert codec.signature() == want.signature()
    assert codec.ratio() == want.ratio()
