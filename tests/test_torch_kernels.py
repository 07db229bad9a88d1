"""The port's FedAvg reduction against the JAX reference, on the CPU.

The same numpy inputs go through the Pallas ``fedavg_reduce`` (interpret
mode, as tests/test_kernels.py runs it), the jnp oracle and the port's
plain version / tree-level ``ops.fedavg_aggregate``. Tolerances are the
reference's own (tests/test_kernels.py:57-59): rtol 1e-4 / atol 1e-5 in
f32, 1e-2 in bf16 (both sides accumulate in f32, in different orders).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fedavg_reduce import fedavg_reduce as jax_fedavg  # noqa: E402
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
