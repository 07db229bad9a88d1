"""The port's event-driven runtime against the JAX reference, on the CPU.

* Virtual-payload runs (the paper-scale path of fig6 and fig8): fedbuff,
  semisync and hier (relay depth 1 and 2) with cohort sampling, the
  streaming hub, an availability trace, link loss and the qsgd ratio
  give the *identical* event trace, report, aggregation log and wire
  stats in both packages (exact floats).
* Live runs of a small linear model, both packages fed the same silo
  data and the same zero initial parameters, at the reference's own bar
  for a quantised path, 8 * max|param| / 127 (tests/test_scheduler.py:277;
  a 1e-7 difference in training can move a value across a rounding
  boundary, so one int8 level may flip): semisync at quorum 1.0 with qsgd
  and the streaming hub; fedbuff with qsgd, with the measured FedAvg
  seconds pinned to 0 in both packages (then its trace is identical as
  well); hier with qsgd on the relay WAN hop.
* The ``fl_train`` CLI runs the event-driven modes on the CPU.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.fl as jfl  # noqa: E402
import repro.fl.fault as jfault  # noqa: E402
import repro.fl.scheduler as jsched_mod  # noqa: E402
import repro.scenario as jscn  # noqa: E402
from repro.data import make_silo_datasets as jsilos  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.fl as tfl  # noqa: E402
import repro_torch.fl.fault as tfault  # noqa: E402
import repro_torch.fl.scheduler as tsched_mod  # noqa: E402
import repro_torch.scenario as tscn  # noqa: E402
from repro_torch.data import make_silo_datasets as tsilos  # noqa: E402
from repro_torch.launch import fl_train  # noqa: E402

JAX_PKG = dict(core=jcore, fl=jfl, fault=jfault, scn=jscn, silos=jsilos,
               device=None)
PORT_PKG = dict(core=tcore, fl=tfl, fault=tfault, scn=tscn, silos=tsilos,
                device="cpu")
N_FEATURES, N_CLASSES = 8 * 8 * 3, 4


# ---------------------------------------------------------------------------
# deployments, built the same way in both packages
# ---------------------------------------------------------------------------

def _deployment(pkg, *, backend, env_name, n, compression=None,
                link_loss=0.0, chunk_mb=0.0, live=False, sim_train_s=5.0,
                straggle=None):
    sc = pkg["scn"].Scenario.from_dict({
        "name": "parity", "seed": 0,
        "topology": {"kind": env_name, "num_clients": n},
        "faults": {"link_loss": link_loss}})
    rt = pkg["scn"].build_runtime(sc)
    silos = (pkg["silos"](n, kind="image", examples_per_silo=24,
                          num_classes=N_CLASSES, image_size=8, seed=0)
             if live else None)
    kw = {} if pkg["device"] is None else {"device": pkg["device"]}
    clients = []
    for i, host in enumerate(rt.env.clients):
        cb = pkg["core"].make_backend(backend, rt.env, rt.fabric,
                                      host.host_id, store=rt.store,
                                      compression=compression,
                                      chunk_mb=chunk_mb, **kw)
        if live:
            c = pkg["fl"].FLClient(
                host.host_id, cb, dataset=silos[i],
                train_fn=_train_fn(pkg), batch_size=8,
                sim_train_s=sim_train_s, seed=i, **kw)
        else:
            c = pkg["fl"].FLClient(host.host_id, cb, sim_train_s=sim_train_s)
        c.straggle_factor = (straggle or {}).get(host.host_id, 1.0)
        clients.append(c)
    sb = pkg["core"].make_backend(backend, rt.env, rt.fabric, "server",
                                  store=rt.store, chunk_mb=chunk_mb, **kw)
    return sb, clients, rt.fabric


def _strategy(pkg, mode, **kw):
    cls = {"fedbuff": "FedBuffStrategy", "semisync": "SemiSyncStrategy",
           "hier": "HierarchicalStrategy"}[mode]
    return getattr(pkg["fl"], cls)(**kw)


def _run(pkg, *, mode, strategy, deployment, payload, max_agg,
         availability=None, cohort_k=0, streaming_hub=False):
    sb, clients, fabric = _deployment(pkg, **deployment)
    avail = None
    if availability is not None:
        avail = pkg["fault"].make_availability(
            availability, [c.client_id for c in clients], horizon_s=3000.0,
            seed=0)
    sched = pkg["fl"].FLScheduler(
        sb, clients, _strategy(pkg, mode, **strategy), local_steps=2,
        availability=avail, cohort_k=cohort_k, cohort_seed=0,
        streaming_hub=streaming_hub)
    report = sched.run(payload(pkg), max_aggregations=max_agg)
    return report, sched, fabric


# ---------------------------------------------------------------------------
# virtual payloads: identical traces
# ---------------------------------------------------------------------------

def _virtual(nbytes, tag):
    return lambda pkg: pkg["core"].VirtualPayload(nbytes, tag=tag)


VIRTUAL_CASES = {
    "fedbuff-straggler": dict(
        mode="fedbuff", strategy=dict(buffer_k=3, staleness_exponent=0.5),
        deployment=dict(backend="grpc", env_name="geo_distributed", n=7,
                        straggle={"client6": 3.0}),
        max_agg=5),
    "fedbuff-s3-qsgd-cohort-hub-loss": dict(
        mode="fedbuff", strategy=dict(buffer_k=3, staleness_exponent=0.5),
        deployment=dict(backend="grpc+s3", env_name="geo_distributed",
                        n=14, compression="qsgd", link_loss=0.05,
                        chunk_mb=8.0),
        max_agg=4, cohort_k=5, streaming_hub=True),
    "semisync-qsgd-churn-hub-chunks": dict(
        mode="semisync",
        strategy=dict(quorum_fraction=0.5, round_deadline_s=30.0,
                      staleness_exponent=0.25),
        deployment=dict(backend="grpc", env_name="geo_distributed", n=6,
                        compression="qsgd", chunk_mb=4.0,
                        straggle={"client3": 3.0}),
        max_agg=6, streaming_hub=True,
        availability="client0:leave@50,join@200;client3:leave@20"),
    "semisync-rpc-churn-loss-cohort": dict(
        mode="semisync", strategy=dict(quorum_fraction=0.7),
        deployment=dict(backend="torch_rpc", env_name="geo_distributed",
                        n=8, link_loss=0.05),
        max_agg=5, cohort_k=4, availability="auto:300/100"),
    "hier-depth1-qsgd-loss-churn": dict(
        mode="hier",
        strategy=dict(wan_compression="qsgd", relay_depth=1,
                      region_quorum=0.5, chunk_mb=4.0),
        deployment=dict(backend="grpc", env_name="geo_distributed", n=14,
                        link_loss=0.05),
        max_agg=3, availability="client1:leave@10,join@400"),
    "hier-depth2-s3": dict(
        mode="hier", strategy=dict(relay_depth=2, wan_compression="qsgd"),
        deployment=dict(backend="grpc+s3", env_name="geo_distributed",
                        n=14),
        max_agg=3),
}


@pytest.mark.parametrize("case", sorted(VIRTUAL_CASES))
def test_virtual_runs_trace_identical(case):
    kw = VIRTUAL_CASES[case]
    out = []
    for pkg in (JAX_PKG, PORT_PKG):
        out.append(_run(pkg, payload=_virtual(32 << 20, f"v:{case}"), **kw))
    (jrep, jsched, jfab), (trep, tsched, tfab) = out
    assert jrep.n_aggregations == kw["max_agg"]
    assert trep.n_events > 10
    assert tsched.loop.trace == jsched.loop.trace
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert [dataclasses.asdict(e) for e in tsched.agg_log] == \
        [dataclasses.asdict(e) for e in jsched.agg_log]
    assert tsched.update_log == jsched.update_log
    assert dict(tfab.stats) == dict(jfab.stats)
    # the case really exercised what it names
    if kw["deployment"].get("link_loss"):
        assert tfab.stats["retransmits"] > 0
    if kw.get("availability"):
        assert trep.n_departures > 0
    if kw.get("streaming_hub"):
        assert tsched._acc is not None


# ---------------------------------------------------------------------------
# live runs
# ---------------------------------------------------------------------------

def _jax_train_fn():
    @jax.jit
    def train_fn(params, batch):
        def loss_fn(p):
            x = batch["images"].reshape(batch["images"].shape[0], -1)
            logits = x @ p["w"] + p["b"]
            onehot = jax.nn.one_hot(batch["labels"], N_CLASSES)
            return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot,
                                     axis=-1))
        loss, grads = jax.value_and_grad(loss_fn)(params)
        return jax.tree.map(lambda p, g: p - 0.1 * g, params, grads), loss
    return train_fn


def _torch_train_step(params, batch):
    w = params["w"].detach().requires_grad_(True)
    b = params["b"].detach().requires_grad_(True)
    x = batch["images"].reshape(batch["images"].shape[0], -1)
    onehot = F.one_hot(batch["labels"].long(), N_CLASSES).float()
    loss = -torch.mean(torch.sum(F.log_softmax(x @ w + b, dim=-1) * onehot,
                                 dim=-1))
    gw, gb = torch.autograd.grad(loss, [w, b])
    with torch.no_grad():
        return {"w": w - 0.1 * gw, "b": b - 0.1 * gb}, loss.detach()


def _train_fn(pkg):
    return _jax_train_fn() if pkg is JAX_PKG else _torch_train_step


def _zeros(pkg):
    if pkg is JAX_PKG:
        params = {"w": jnp.zeros((N_FEATURES, N_CLASSES), jnp.float32),
                  "b": jnp.zeros((N_CLASSES,), jnp.float32)}
    else:
        params = {"w": torch.zeros((N_FEATURES, N_CLASSES)),
                  "b": torch.zeros((N_CLASSES,))}
    return pkg["core"].TensorPayload(params)


def _assert_params_within_band(tsched, jsched):
    want = {k: np.asarray(v) for k, v in jsched.global_params.items()}
    upd = max(float(np.max(np.abs(v))) for v in want.values())
    tol = max(8.0 * upd / 127.0, 1e-4)
    for k, v in want.items():
        got = tsched.global_params[k]
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), v, atol=tol)
    return tol


def _pin_fedavg_seconds(monkeypatch, module):
    real = module.fedavg

    def fedavg(trees, weights):
        agg, _ = real(trees, weights)
        return agg, 0.0
    monkeypatch.setattr(module, "fedavg", fedavg)


def test_live_semisync_qsgd_streaming_hub_matches_reference():
    kw = dict(mode="semisync", strategy=dict(quorum_fraction=1.0),
              deployment=dict(backend="grpc", env_name="geo_distributed",
                              n=4, compression="qsgd", live=True),
              max_agg=2, streaming_hub=True)
    jrep, jsched, _ = _run(JAX_PKG, payload=_zeros, **kw)
    trep, tsched, _ = _run(PORT_PKG, payload=_zeros, **kw)
    assert trep.n_aggregations == jrep.n_aggregations == 2
    assert trep.n_client_updates == jrep.n_client_updates == 8
    assert [e.n_updates for e in tsched.agg_log] == [4, 4]
    _assert_params_within_band(tsched, jsched)
    np.testing.assert_allclose(trep.final_loss, jrep.final_loss, rtol=1e-4)


def test_live_fedbuff_qsgd_matches_reference(monkeypatch):
    """With the measured FedAvg seconds pinned to 0 and the training time
    simulated, the clock holds no measured time: the traces are identical
    (torch_rpc wires are byte-identical) and the parameters agree."""
    _pin_fedavg_seconds(monkeypatch, jsched_mod)
    _pin_fedavg_seconds(monkeypatch, tsched_mod)
    kw = dict(mode="fedbuff",
              strategy=dict(buffer_k=2, staleness_exponent=0.5),
              deployment=dict(backend="torch_rpc",
                              env_name="geo_distributed", n=4,
                              compression="qsgd", live=True,
                              straggle={"client3": 2.0}),
              max_agg=3)
    jrep, jsched, _ = _run(JAX_PKG, payload=_zeros, **kw)
    trep, tsched, _ = _run(PORT_PKG, payload=_zeros, **kw)
    assert tsched.loop.trace == jsched.loop.trace
    assert tsched.update_log == jsched.update_log
    rep_t, rep_j = dataclasses.asdict(trep), dataclasses.asdict(jrep)
    assert rep_t.pop("final_loss") == pytest.approx(rep_j.pop("final_loss"),
                                                    rel=1e-4)
    assert rep_t == rep_j
    _assert_params_within_band(tsched, jsched)


@pytest.mark.parametrize("depth", [1, 2])
def test_live_hier_qsgd_wan_hop_matches_reference(depth):
    kw = dict(mode="hier",
              strategy=dict(staleness_exponent=0.0, wan_compression="qsgd",
                            relay_depth=depth),
              deployment=dict(backend="grpc", env_name="geo_distributed",
                              n=8, live=True),
              max_agg=2)
    jrep, jsched, _ = _run(JAX_PKG, payload=_zeros, **kw)
    trep, tsched, _ = _run(PORT_PKG, payload=_zeros, **kw)
    assert trep.n_client_updates == jrep.n_client_updates == 16
    tol = _assert_params_within_band(tsched, jsched)
    states = tsched.strategy.wan_ef_states()
    assert len(states) == len(jsched.strategy.wan_ef_states()) > 0
    for st in states:
        assert isinstance(st.error, torch.Tensor)
        assert float(st.error.abs().max()) <= tol


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--mode", "fedbuff", "--compression", "qsgd", "--clients", "3",
     "--rounds", "2"],
    ["--scenario", "examples/scenarios/geo_wan_qsgd.json", "--clients", "3",
     "--rounds", "2"],
    ["--mode", "hier", "--compression", "qsgd:128", "--clients", "4",
     "--rounds", "1", "--relay-depth", "2"],
    ["--mode", "semisync", "--compression", "qsgd", "--clients", "3",
     "--rounds", "1", "--streaming-hub", "--cohort-k", "2",
     "--availability-trace", "client1:leave@500", "--link-loss", "0.05",
     "--region-quorum", "0.5"],
])
def test_cli_runs_event_driven_modes_on_cpu(argv, capsys):
    root = Path(__file__).resolve().parents[1]
    argv = [str(root / a) if a.endswith(".json") else a for a in argv]
    assert fl_train.main(argv + ["--local-steps", "1",
                                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "aggregations=" in out and "throughput=" in out


def test_cli_sync_mode_drops_payload_compression(capsys):
    assert fl_train.main(["--compression", "qsgd", "--rounds", "1",
                          "--clients", "2", "--local-steps", "1",
                          "--backend", "torch_rpc", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "sync rounds aggregate exact in-proc trees, ignoring" in out
    assert "round 0:" in out


def test_cli_scenario_runs_on_the_card_by_default(capsys):
    """Without ``--device`` the scenario's deployment is built on the card;
    without one the CLI refuses and names ``--device cpu``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py phase 7 runs the "
                    "scenario on it")
    root = Path(__file__).resolve().parents[1]
    with pytest.raises(SystemExit) as e:
        fl_train.main(["--scenario",
                       str(root / "examples/scenarios/geo_wan_qsgd.json"),
                       "--clients", "3", "--rounds", "1"])
    assert e.value.code != 0
    assert "device='cpu'" in capsys.readouterr().err
