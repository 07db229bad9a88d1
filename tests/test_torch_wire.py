"""Wires and the simulated network of the port against the JAX reference.

* membuff / tensor_rpc wires of identical arrays are byte-identical,
  with and without the zlib wire codec;
* generic / protobuf wires carry equal tensor buffers; their sizes
  differ only by the pickled treedef (JAX's vs the port's);
* the copied netsim gives identical finish times on seeded random
  transfer sets, in the scalar and the vectorised solver.
"""
import pickle

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import netsim as jnet  # noqa: E402
from repro.core.channel import make_channel as jmake_channel  # noqa: E402
from repro.core.message import TensorPayload as JPayload  # noqa: E402
from repro.core.serialization import SERIALIZERS as JSER  # noqa: E402
from repro.scenario import TopologySpec as JTopologySpec  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.core import netsim as tnet  # noqa: E402
from repro_torch.core.channel import make_channel  # noqa: E402
from repro_torch.core.message import TensorPayload  # noqa: E402
from repro_torch.core.serialization import SERIALIZERS  # noqa: E402
from repro_torch.scenario import TopologySpec  # noqa: E402


def _trees(rng):
    tree = {"stage": [{"c2": rng.normal(size=(3, 3, 4, 4)),
                       "bn": {"scale": rng.normal(size=(4,)),
                              "bias": rng.normal(size=(4,))}}],
            "head": {"w": rng.normal(size=(4, 8)), "b": np.zeros(8)},
            "steps": np.arange(5, dtype=np.int32)}
    tree = _tree.map(lambda a: a.astype(np.float32)
                     if a.dtype == np.float64 else a, tree)
    return (jax.tree.map(jnp.asarray, tree),
            _tree.map(lambda a: torch.from_numpy(a.copy()), tree))


@pytest.mark.parametrize("name", ["membuff", "tensor_rpc"])
@pytest.mark.parametrize("codec", [None, "zlib"])
def test_buffer_wires_byte_identical(name, codec, rng):
    jtree, ttree = _trees(rng)
    jw = jmake_channel(name, compression=codec).encode(JPayload(jtree)).wire
    tw = make_channel(name, compression=codec).encode(
        TensorPayload(ttree)).wire
    assert tw.nbytes == jw.nbytes and tw.codec == jw.codec
    assert len(tw.buffers) == len(jw.buffers)
    for a, b in zip(tw.buffers, jw.buffers):
        a = a if isinstance(a, bytes) else np.asarray(a).tobytes()
        b = b if isinstance(b, bytes) else np.asarray(b).tobytes()
        assert a == b
    if codec is None:
        assert [(s, str(d)) for s, d in tw.obj[2]] == \
            [(s, str(d)) for s, d in jw.obj[2]]


@pytest.mark.parametrize("name", ["generic", "protobuf"])
def test_generic_wires_equal_buffers(name, rng):
    jtree, ttree = _trees(rng)
    jw = JSER[name].serialize(JPayload(jtree))
    tw = SERIALIZERS[name].serialize(TensorPayload(ttree))
    jobj, tobj = pickle.loads(jw.buffers[0]), pickle.loads(tw.buffers[0])
    assert tobj["arrs"] == jobj["arrs"] and tobj["meta"] == jobj["meta"]
    tensor_bytes = sum(len(b) for b in tobj["arrs"])
    # only the pickled treedef differs: a header, small beside the tensors
    assert abs(tw.nbytes - jw.nbytes) < 0.5 * tensor_bytes
    back = SERIALIZERS[name].deserialize(tw).tree
    for a, b in zip(_tree.leaves(back), _tree.leaves(ttree)):
        np.testing.assert_array_equal(a, b.numpy())


def test_payload_accounting_matches(rng):
    """Equal sizes. The reference keys a payload by its leaves, bytes and
    first element; the port by a digest of every byte, so two trees that
    agree there and differ elsewhere share the reference's key and not
    the port's, and equal trees share both."""
    jtree, ttree = _trees(rng)
    assert TensorPayload(ttree).nbytes == JPayload(jtree).nbytes
    other = _tree.map(lambda t: t.clone(), ttree)
    assert TensorPayload(other).fingerprint() == \
        TensorPayload(ttree).fingerprint()
    other["head"]["w"][-1, -1] += 1
    jother = jax.tree.map(lambda t: jnp.asarray(t.numpy()), other)
    assert JPayload(jother).fingerprint() == JPayload(jtree).fingerprint()
    assert TensorPayload(other).fingerprint() != \
        TensorPayload(ttree).fingerprint()


def _transfers(net, env, rng, n):
    hosts = [env.host("server")] + [env.host(c.host_id)
                                    for c in env.clients]
    out = []
    for i in range(n):
        a, b = rng.choice(len(hosts), size=2, replace=False)
        out.append(net.Transfer(start=float(rng.uniform(0, 5)),
                                src=hosts[a], dst=hosts[b],
                                nbytes=float(rng.integers(1, 50) * 2 ** 20),
                                conns=int(rng.integers(1, 9)),
                                tag=f"t{i}"))
    return out


@pytest.mark.parametrize("n", [12, 64, 150])
@pytest.mark.parametrize("solver", ["dispatch", "scalar"])
@pytest.mark.parametrize("topology", ["geo_distributed", "lan"])
def test_netsim_finish_times_identical(n, solver, topology):
    finishes = []
    for net, spec in ((jnet, JTopologySpec), (tnet, TopologySpec)):
        env = spec.preset(topology, num_clients=9).build()
        trs = _transfers(net, env, np.random.default_rng(7 + n), n)
        if solver == "scalar":
            with net.scalar_transfers():
                net.simulate_transfers(trs)
        else:  # n >= 64 takes the vectorised solver
            net.simulate_transfers(trs)
        finishes.append([t.finish for t in trs])
    assert np.all(np.isfinite(finishes[0]))
    assert finishes[0] == finishes[1]
