"""The port's FedAvg reductions against the JAX reference, on the CPU.

The same numpy inputs go through the Pallas ``fedavg_reduce`` and
``fedavg_reduce_q8`` (interpret mode, as tests/test_kernels.py runs
them), the jnp oracles and the port's plain versions / tree-level
``ops.fedavg_aggregate`` and ``fl.aggregator.fedavg_quantized``.
Tolerances are the reference's own (tests/test_kernels.py:57-59, 73-74):
rtol 1e-4 / atol 1e-5 in f32, 1e-2 in bf16 (both sides accumulate in
f32, in different orders).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.fl.aggregator import fedavg_quantized as jfedavg_quantized  # noqa: E402
from repro.kernels.fedavg_reduce import COL_TILE  # noqa: E402
from repro.kernels.fedavg_reduce import fedavg_reduce as jax_fedavg  # noqa: E402
from repro.kernels.fedavg_reduce import fedavg_reduce_q8 as jax_q8  # noqa: E402
from repro_torch.fl.aggregator import fedavg_quantized  # noqa: E402
from repro_torch.kernels import fedavg_reduce as fr  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2, 1e-2)}


def _inputs(rng, n, t, dtype):
    jdt, tdt, _, _ = DTYPES[dtype]
    x = rng.normal(size=(n, t)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    # both frameworks round f32 -> bf16 to nearest-even: identical values
    return (jnp.asarray(x).astype(jdt), jnp.asarray(w),
            torch.from_numpy(x).to(tdt), torch.from_numpy(w))


@pytest.mark.parametrize("n,t", [(2, 1024), (5, 2048), (16, 4096)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fedavg_reduce_plain_matches_jax(n, t, dtype, rng):
    ju, jw, tu, tw = _inputs(rng, n, t, dtype)
    _, _, rtol, atol = DTYPES[dtype]
    before = fr.LAUNCHES
    out = fr.fedavg_reduce(tu, tw)  # CPU tensor -> the plain version
    assert fr.LAUNCHES == before  # no kernel launch off the card
    assert out.dtype == torch.float32 and out.shape == (t,)
    np.testing.assert_allclose(out.numpy(), np.asarray(
        jax_fedavg(ju, jw, interpret=True)), rtol=rtol, atol=atol)
    np.testing.assert_allclose(out.numpy(), np.asarray(
        jref.fedavg_reduce_ref(ju, jw)), rtol=rtol, atol=atol)


@pytest.mark.parametrize("n,t", [(3, 3 * 1000 + 7), (2, 1024), (7, 5000)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fedavg_aggregate_matches_jax(n, t, dtype, rng):
    """Tree-level FedAvg: the reference pads T to COL_TILE, the port
    passes the ragged T to the kernel as it is."""
    jdt, tdt, rtol, atol = DTYPES[dtype]
    split = t // 3
    trees_np = [{"b": rng.normal(size=(t - split,)).astype(np.float32),
                 "a": rng.normal(size=(split,)).astype(np.float32)}
                for _ in range(n)]
    weights = [float(v) for v in rng.integers(1, 100, size=n)]
    jtrees = [{k: jnp.asarray(v).astype(jdt) for k, v in tr.items()}
              for tr in trees_np]
    ttrees = [{k: torch.from_numpy(v).to(tdt) for k, v in tr.items()}
              for tr in trees_np]
    before = fr.LAUNCHES
    got = ops.fedavg_aggregate(ttrees, weights)
    assert fr.LAUNCHES == before
    want = jops.fedavg_aggregate(jtrees, weights, interpret=True)
    for k in ("a", "b"):
        assert got[k].dtype == tdt and tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   rtol=rtol, atol=atol)


def test_fedavg_reduce_rejects_bad_shapes():
    with pytest.raises(ValueError):
        fr.fedavg_reduce(torch.zeros(3, 8), torch.ones(2))
    with pytest.raises(ValueError):
        fr.fedavg_reduce(torch.zeros(8), torch.ones(8))


@pytest.mark.parametrize("n,t,block", [(3, COL_TILE, 256),
                                       (7, 2 * COL_TILE, 512)])
def test_fedavg_reduce_q8_plain_matches_jax(n, t, block, rng):
    """tests/test_kernels.py:59's shapes, inputs quantised by the
    reference (which pads each to whole (8, block) tiles: T' columns)."""
    qs, ss = [], []
    for _ in range(n):
        p = jops.quantize_flat(jnp.asarray(rng.normal(size=t).astype(
            np.float32)), block=block, interpret=True)
        qs.append(np.asarray(p["q"]))
        ss.append(np.asarray(p["scales"]))
    q, s = np.stack(qs), np.stack(ss)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    before = fr.Q8_LAUNCHES
    out = fr.fedavg_reduce_q8(torch.from_numpy(q), torch.from_numpy(s),
                              torch.from_numpy(w), block)
    assert fr.Q8_LAUNCHES == before  # no kernel launch off the card
    assert out.dtype == torch.float32 and out.shape == (q.shape[1],)
    jq, js, jw = jnp.asarray(q), jnp.asarray(s), jnp.asarray(w)
    np.testing.assert_allclose(out.numpy(), np.asarray(
        jax_q8(jq, js, jw, block=block, interpret=True)), rtol=1e-4,
        atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(
        jref.fedavg_reduce_q8_ref(jq, js, jw, block=block)), rtol=1e-4,
        atol=1e-5)


@pytest.mark.parametrize("t,block", [(3 * 1000 + 7, 256), (4096, 256),
                                     (2 * 2048 + 300, 128)])
@pytest.mark.parametrize("on_host", [True, False])
def test_fedavg_quantized_matches_jax(t, block, on_host, rng):
    """Tree-level: 4 packed updates of one tree (T not a multiple of
    COL_TILE in two cases, so the reference pads and the port masks), the
    packed form either host wire buffers or CPU tensors."""
    split = t // 3
    trees = [{"b": rng.normal(size=(t - split,)).astype(np.float32),
              "a": rng.normal(size=(split,)).astype(np.float32)}
             for _ in range(4)]
    weights = [float(v) for v in rng.integers(1, 100, size=4)]
    flats = [torch.from_numpy(np.concatenate([tr["a"], tr["b"]]))
             for tr in trees]
    packed = ops.quantize_flat_batch(flats, block=block)
    if not on_host:
        packed = [{**p, "q": torch.from_numpy(p["q"].copy()),
                   "scales": torch.from_numpy(p["scales"].copy())}
                  for p in packed]
    _, unflatten = ops.flatten_pytree(
        {k: torch.from_numpy(v) for k, v in trees[0].items()})
    _, junflatten = jops.flatten_pytree(
        {k: jnp.asarray(v) for k, v in trees[0].items()})
    before = fr.Q8_LAUNCHES
    got, secs = fedavg_quantized(packed, weights, unflatten, device="cpu")
    assert fr.Q8_LAUNCHES == before and secs >= 0.0
    jpacked = [{"q": jnp.asarray(np.asarray(p["q"])),
                "scales": jnp.asarray(np.asarray(p["scales"])),
                "block": p["block"], "orig_len": p["orig_len"]}
               for p in packed]
    want, _ = jfedavg_quantized(jpacked, weights, junflatten, interpret=True)
    for k in ("a", "b"):
        assert got[k].dtype == torch.float32
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5)


def test_fedavg_reduce_q8_rejects_bad_shapes():
    q = torch.zeros((2, 512), dtype=torch.int8)
    w = torch.ones(2)
    with pytest.raises(ValueError):  # block does not divide T
        fr.fedavg_reduce_q8(q, torch.zeros((2, 2)), w, 300)
    with pytest.raises(ValueError):  # scales of the wrong shape
        fr.fedavg_reduce_q8(q, torch.zeros((2, 3)), w, 256)
