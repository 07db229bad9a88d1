"""The object store's wires and the payloads' content keys, on the CPU.

* ``TensorPayload.fingerprint`` is a digest of every byte: trees that
  agree in their sizes and first element and differ elsewhere get
  different keys, equal trees (a host array's and a tensor's too) the
  same; the digest is the formula it states, in one pass or many.
* ``ObjectStore`` releases a wire when its last holder drops it and
  keeps the object's metadata; a revived object reads as before; its
  counters and span exist only while ``obs`` is on.
* A live gRPC+S3 sync run and a FedBuff run of 6 aggregations leave no
  closed round's wire in the store, the bytes it holds stay within one
  aggregation's wires, and the simulated clock, the trace, ``stats`` and
  the model equal those of the same run with nothing released (the
  store as it kept every wire).
* ``examples/scenarios/hospitals_geo3.json`` at a small size: every
  model a client trains on is the server's global of that version (a
  key of sizes and first element served the first model again there).
"""
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import _tree, obs
from repro_torch.configs.base import FLConfig
from repro_torch.core import TensorPayload
from repro_torch.core import message
from repro_torch.core.message import PackedPayload, content_digest
from repro_torch.core.netsim import Region
from repro_torch.core.objectstore import ObjectStore
from repro_torch.core.serialization import WireData
from repro_torch.fl import make_strategy
from repro_torch.fl import scheduler as sched_mod
from repro_torch.fl import server as server_mod
from repro_torch.fl.client import FLClient
from repro_torch.launch import fl_train
from repro_torch.scenario import Scenario

REPO = Path(__file__).resolve().parents[1]
M64 = (1 << 64) - 1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Beside XLA's CPU thread pool (another test module in the same
    worker) torch's OpenMP threads at the core count run the live rounds
    many times slower, so this module's torch runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree_of(seed: int):
    g = torch.Generator().manual_seed(seed)
    return {"b": torch.zeros(8), "w": torch.randn(4, 6, generator=g),
            "n": [torch.ones(3), torch.arange(5, dtype=torch.int32)]}


def _changed(tree, fn):
    out = copy.deepcopy(tree)
    fn(out)
    return out


def _swap(tree):
    flat = tree["w"].view(-1)
    flat[[3, 4]] = flat[[4, 3]].clone()


# trees of the same leaves, bytes and first element as _tree_of(0)
DIFFERENT = {
    "one entry": lambda t: t["w"].view(-1)[-1].add_(1.0),
    "signs of two entries": lambda t: t["w"][1, :2].neg_(),
    "two entries swapped": _swap,
    "an int leaf": lambda t: t["n"][1].add_(1),
    "a zero made negative": lambda t: t["b"][5].copy_(torch.tensor(-0.0)),
}


@pytest.mark.parametrize("case", sorted(DIFFERENT))
def test_different_contents_get_different_keys(case):
    tree = _tree_of(0)
    other = _changed(tree, DIFFERENT[case])
    assert float(other["b"][0]) == float(tree["b"][0])
    assert TensorPayload(other).nbytes == TensorPayload(tree).nbytes
    assert TensorPayload(other).fingerprint() != \
        TensorPayload(tree).fingerprint()


def test_equal_contents_share_a_key():
    tree = _tree_of(1)
    same = copy.deepcopy(tree)
    host = _tree.map(lambda t: t.numpy().copy(), tree)
    host["w"].setflags(write=False)  # a wire's arrays are read-only
    keys = {TensorPayload(t).fingerprint() for t in (tree, same, host)}
    assert len(keys) == 1
    # the same bytes under another shape or dtype are another payload
    flat = dict(tree, w=tree["w"].reshape(-1))
    bits = dict(tree, w=tree["w"].view(torch.int32))
    assert len(keys | {TensorPayload(flat).fingerprint(),
                       TensorPayload(bits).fingerprint()}) == 3


def _mix(z):
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
    return z ^ (z >> 31)


def test_digest_is_its_formula_in_any_number_of_passes(monkeypatch):
    """The device sum wraps mod 2**64 as the integer formula does, and a
    pass boundary anywhere leaves it as it is."""
    leaves = _tree.leaves(_tree_of(2)) + [torch.tensor([1, 2, 3],
                                                       dtype=torch.int8)]
    words = np.concatenate([message._words(l).numpy() for l in leaves])
    want = 0
    for i, w in enumerate(words.astype(np.int64).tolist()):
        want = (want + _mix((((i << 32) | (w & 0xFFFFFFFF))
                             + 0x9E3779B97F4A7C15) & M64)) & M64
    seen = []
    real = message._mix
    monkeypatch.setattr(message, "_mix", lambda z: seen.append(
        int(real(z).sum()) & M64) or real(z))
    one = content_digest(leaves)
    assert sum(seen) & M64 == want and len(seen) == 1
    for per_pass in (1, 7, 16):
        monkeypatch.setattr(message, "WORDS_PER_PASS", per_pass)
        seen.clear()
        assert content_digest(leaves) == one
        assert len(seen) == -(-words.size // per_pass)


def test_packed_payload_key_is_its_contents():
    a = PackedPayload({"idx": np.arange(4, dtype=np.int32),
                       "vals": np.ones(4, np.float32), "n": 100})
    b = PackedPayload({"idx": np.array([0, 1, 2, 5], np.int32),
                       "vals": np.ones(4, np.float32), "n": 100})
    assert a.nbytes == b.nbytes and a.fingerprint() != b.fingerprint()
    assert a.fingerprint() == PackedPayload(copy.deepcopy(a.packed)) \
        .fingerprint()


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def _store():
    return ObjectStore(Region("hub", bw_single=1e9, bw_multi=1e9,
                              latency=0.01))


@pytest.mark.parametrize("traced", [False, True])
def test_last_drop_releases_and_keeps_the_object(traced):
    store = _store()
    wire = WireData(nbytes=1000, buffers=[b"x" * 1000])
    obs.reset()  # an earlier test's record
    if traced:
        obs.enable()
    try:
        store.put("k", wire, 1000, now=1.0)
        store.put("v", None, 500, now=1.0)  # a virtual payload's
        store.hold("k")
        store.hold("k")
        store.drop("k")
        assert store.get("k")[0].wire is wire and not store.released("k")
        store.drop("k")
        obj, _ = store.get("k")
        assert obj.wire is None and store.released("k")
        assert (obj.nbytes, obj.created, store.size("k")) == (1000, 1.0,
                                                              1000)
        assert store.has("k") and store.stats["puts"] == 2
        store.settle("v")  # nothing to release
        assert not store.released("v")
        store.revive("k", wire)
        assert store.get("k")[0].wire is wire and not store.released("k")
        store.settle("k")
        snap = obs.snapshot()
    finally:
        obs.disable()
    if traced:
        assert snap["counters"] == {"store.bytes_put": 2000,
                                    "store.bytes_released": 2000,
                                    "store.objects_released": 2}
        assert snap["spans"]["store.release"]["n"] == 2
    else:
        assert snap == {"spans": {}, "counters": {}}


# ---------------------------------------------------------------------------
# live runs
# ---------------------------------------------------------------------------

AGGREGATIONS = 6


def _deploy(mode, **kw):
    """A reduced CPU deployment over gRPC+S3 whose measured seconds are
    pinned, so its simulated clock holds no wall time."""
    cfg = FLConfig(num_clients=3, rounds=AGGREGATIONS, seed=0, mode=mode,
                   backend="grpc+s3", **kw)
    server, params, _, _ = fl_train.build_deployment(cfg, local_steps=1,
                                                     device="cpu")
    for c in server.clients:
        c.sim_train_s = c.sim_train_s or 1.0
    return cfg, server, params


def _live_wires(store):
    return {k: o.wire.nbytes for k, o in store._objects.items()
            if o.wire is not None}


def _run(mode, monkeypatch, check=None, **kw):
    """-> (store stats, simulated end, event trace, model bytes); ``check``
    sees the store after each aggregation."""
    def fedavg(orig):
        return lambda trees, weights: (orig(trees, weights)[0], 0.0)
    monkeypatch.setattr(server_mod, "fedavg", fedavg(server_mod.fedavg))
    monkeypatch.setattr(sched_mod, "fedavg", fedavg(sched_mod.fedavg))
    cfg, server, params = _deploy(mode, **kw)
    store = server.backend.store
    if mode == "sync":
        for _ in range(AGGREGATIONS):
            server.run_round(TensorPayload(params))
            params = server.global_params
            if check is not None:
                check(store, server)
        trace, end = [], server.now
    else:
        aggregate = sched_mod.FLScheduler.aggregate

        def checked(sched, records, now):
            done = aggregate(sched, records, now)
            if check is not None:
                check(store, server)
            return done
        monkeypatch.setattr(sched_mod.FLScheduler, "aggregate", checked)
        report, sched = server.run_async(
            TensorPayload(params), make_strategy(cfg, cfg.num_clients),
            max_aggregations=AGGREGATIONS)
        assert report.n_aggregations == AGGREGATIONS
        trace, end = sched.loop.trace, report.sim_time
    model = [l.numpy().tobytes() for l in _tree.leaves(server.global_params)]
    return dict(store.stats), end, trace, model


CASES = {"sync": dict(), "fedbuff-qsgd": dict(compression="qsgd",
                                              buffer_k=2)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_live_run_releases_closed_rounds(case, monkeypatch):
    mode = "sync" if case == "sync" else "fedbuff"
    seen = []

    def check(store, server):
        live = _live_wires(store)
        snap = obs.snapshot()["counters"]
        held = snap["store.bytes_put"] - snap.get("store.bytes_released", 0)
        assert held == sum(live.values())
        if mode == "sync":
            assert live == {}  # the round closed: nothing is left
        else:
            # the server's newest model, the one a dispatch may still be
            # reading and one update a client: one aggregation's wires
            model = max(live.values())
            assert len(live) <= 2 + 3 and held <= 5 * model
            assert server.backend._published in live
        seen.append(len(live))

    obs.enable()
    try:
        _run(mode, monkeypatch, check, **CASES[case])
    finally:
        obs.disable()
    assert len(seen) == AGGREGATIONS


@pytest.mark.parametrize("case", sorted(CASES))
def test_release_leaves_clock_and_stats_bit_for_bit(case, monkeypatch):
    mode = "sync" if case == "sync" else "fedbuff"
    released = _run(mode, monkeypatch, **CASES[case])
    monkeypatch.undo()
    monkeypatch.setattr(ObjectStore, "release", lambda self, key: None)
    kept = _run(mode, monkeypatch, **CASES[case])
    assert released == kept
    assert released[0]["puts"] > 0


def test_cache_hit_on_a_released_model_encodes_it_again(monkeypatch):
    """A sync round serving the previous round's model again: the store
    released it when that round closed, the sender's cache hits and
    encodes the wire anew, every client decodes it, and the simulated
    round and ``stats`` are those of a store that kept it."""
    fedavg = server_mod.fedavg
    monkeypatch.setattr(server_mod, "fedavg", lambda trees, weights: (
        fedavg(trees, weights)[0], 0.0))

    def twice():
        cfg, server, params = _deploy("sync")
        payload = TensorPayload(params)
        server.run_round(payload)
        got = []
        run_round = FLClient.run_round

        def recv(client, msg, *a, **kw):
            got.append(msg.payload.tree)
            return run_round(client, msg, *a, **kw)
        monkeypatch.setattr(FLClient, "run_round", recv)
        report = server.run_round(payload)
        monkeypatch.setattr(FLClient, "run_round", run_round)
        return got, report, dict(server.backend.store.stats)

    got, report, stats = twice()
    assert len(got) == 3 and stats["cache_hits"] == 1
    for tree in got:
        assert all(torch.equal(a, b) for a, b in
                   zip(_tree.leaves(tree), _tree.leaves(_deploy("sync")[2])))
    monkeypatch.setattr(ObjectStore, "release", lambda self, key: None)
    _, kept_report, kept_stats = twice()
    assert stats == kept_stats
    assert report.round_time == kept_report.round_time


def test_hospitals_scenario_serves_every_version_as_made(monkeypatch):
    """Top-k zeroes the first element of every global after the first, so
    a key of sizes and first element made them all one object."""
    sc = Scenario.from_dict(json.loads(
        (REPO / "examples/scenarios/hospitals_geo3.json").read_text()))
    cfg = sc.fl_config()
    server, params, _, _ = fl_train.build_deployment(
        cfg, scenario=sc, tier=sc.fleet.tier, local_steps=2, device="cpu")
    made = {0: _tree.leaves(params)}
    served = []
    aggregate = sched_mod.FLScheduler.aggregate

    def recorded(sched, records, now):
        done = aggregate(sched, records, now)
        made[sched.version] = [l.clone() for l in
                               _tree.leaves(sched.global_params)]
        return done
    run_round = FLClient.run_round

    def received(client, msg, *a, **kw):
        served.append((msg.metadata["version"],
                       _tree.leaves(msg.payload.tree)))
        return run_round(client, msg, *a, **kw)
    monkeypatch.setattr(sched_mod.FLScheduler, "aggregate", recorded)
    monkeypatch.setattr(FLClient, "run_round", received)
    server.run_async(TensorPayload(params),
                     make_strategy(cfg, cfg.num_clients),
                     max_aggregations=3)
    assert {v for v, _ in served} >= {0, 1, 2}
    for v, leaves in served:
        assert all(torch.equal(a, b) for a, b in zip(leaves, made[v])), v


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the digest runs where the tree is")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_digest_on_the_card_is_the_hosts(cuda, monkeypatch):
    """On the card, in one pass and in several, the digest of a tree is
    the one its host copy gets."""
    g = torch.Generator().manual_seed(3)
    leaves = [torch.randn(1000, 37, generator=g), torch.zeros(5),
              torch.arange(11, dtype=torch.int8)]
    want = content_digest(leaves)
    assert content_digest([l.to(cuda) for l in leaves]) == want
    monkeypatch.setattr(message, "WORDS_PER_PASS", 4096)
    assert content_digest([l.to(cuda) for l in leaves]) == want
