"""Subnormal f32 values through the port's FedAvg, codec and server-merge
arithmetic, against the JAX reference on the CPU.

XLA flushes subnormals when it runs the reference on the CPU: an input
with |v| < FLT_MIN (2**-126) reads as a zero of its sign, and so does a
result. The port flushes at the same places by explicit comparisons
(``kernels/quantize.py``'s rule): the codecs' error-feedback add and
qsgd's residual, the three FedAvg plain versions and the weight
normalisation, ``merge_global`` and ``StreamingAccumulator.merged``. The
same numpy inputs go through both packages (Pallas kernels in interpret
mode, as tests/test_kernels.py runs them). On inputs built so that every
summation order gives the same result the two agree bit for bit; XLA sums
FedAvg's clients in another order than the port, so on random inputs the
bar is the reference's own (rtol 1e-4 / atol 1e-5) and no output holds a
subnormal.
"""
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.compression import qsgd as jqsgd  # noqa: E402
from repro.compression import topk as jtopk  # noqa: E402
from repro.core.message import TensorPayload as JPayload  # noqa: E402
from repro.fl import aggregator as jagg  # noqa: E402
from repro.kernels import fedavg_reduce as jfr  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.compression import qsgd, topk  # noqa: E402
from repro_torch.core.message import TensorPayload  # noqa: E402
from repro_torch.fl import aggregator as agg  # noqa: E402
from repro_torch.kernels import fedavg_reduce as fr  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

FMIN = np.float32(np.finfo(np.float32).tiny)  # 2**-126
COL = jfr.COL_TILE


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _flush(x) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return np.where(np.abs(x) < FMIN, np.copysign(np.float32(0), x), x)


def _no_subnormals(x) -> bool:
    a = np.abs(np.asarray(x, np.float32))
    return not ((a > 0) & (a < FMIN)).any()


def _tiny(rng, *shape) -> np.ndarray:
    """Random f32 of both signs with magnitudes spanning 1e-46-1e-33."""
    mag = 10.0 ** rng.uniform(-46, -33, size=shape)
    return (mag * rng.choice([-1.0, 1.0], size=shape)).astype(np.float32)


# -- the codecs -----------------------------------------------------------

def test_topk_wire_flushes_subnormal_residual():
    """f[3] = 1.0 and a residual of 3e-39 at entry 30, k = 2 of 40: the
    reference's XLA add reads the residual as 0, so the second pick is the
    lowest-index zero, entry 0 (without the flush: entry 30)."""
    f = np.zeros(40, np.float32)
    f[3] = 1.0
    err = np.zeros(40, np.float32)
    err[30] = 3e-39
    (got,), (gs,) = topk.topk_compress_flat_batch(
        [torch.from_numpy(f)], [qsgd.QuantState(torch.from_numpy(err))],
        k_frac=0.05)
    (want,), (ws,) = jtopk.topk_compress_flat_batch(
        [jnp.asarray(f)], [jqsgd.QuantState(jnp.asarray(err))], k_frac=0.05,
        interpret=True)
    np.testing.assert_array_equal(got["idx"].numpy(), [3, 0])
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(want["idx"]))
    np.testing.assert_array_equal(_bits(got["vals"]), _bits(want["vals"]))
    np.testing.assert_array_equal(_bits(gs.error), _bits(ws.error))


def test_qsgd_residual_and_error_feedback_flush():
    """A row with scale 2**-120: entry 1 quantises to 3 and leaves a
    residual of 2**-140, a subnormal the reference flushes to 0; entries 2
    and 3 carry subnormal residuals in, which the reference's add reads as
    zeros of their signs."""
    f = np.zeros(256, np.float32)
    f[0] = np.float32(127 * 2.0 ** -120)  # the row max: scale 2**-120
    f[1] = np.float32(3 * 2.0 ** -120 + 2.0 ** -140)
    err = np.zeros(256, np.float32)
    err[2], err[3], err[4] = 1e-39, -2e-39, np.float32(5 * 2.0 ** -120)
    (gp,), (gs,) = qsgd.qsgd_compress_flat_batch(
        [torch.from_numpy(f)], [qsgd.QuantState(torch.from_numpy(err))],
        block=256)
    (wp,), (ws,) = jqsgd.qsgd_compress_flat_batch(
        [jnp.asarray(f)], [jqsgd.QuantState(jnp.asarray(err))], block=256,
        interpret=True)
    np.testing.assert_array_equal(np.asarray(gp["q"]), np.asarray(wp["q"]))
    np.testing.assert_array_equal(_bits(gp["scales"]), _bits(wp["scales"]))
    np.testing.assert_array_equal(_bits(gs.error), _bits(ws.error))
    assert gs.error[1] == 0 and int(gp["q"][1]) == 3
    assert _no_subnormals(gs.error)


# -- FedAvg -----------------------------------------------------------------

C1_ROWS = np.stack([np.full(COL, 1e-30, np.float32),
                    np.full(COL, 1e-39, np.float32)])
C1_WEIGHTS = [1e-9, 0.5]


def _jnormalised(weights):
    w = jnp.asarray(np.asarray(weights, np.float32))
    return w / jnp.sum(w)


def test_fedavg_reduce_plain_flushes_products():
    """w = [2e-9, 1]: 1e-30 * 2e-9 is subnormal and 1e-39 is read as 0, so
    the reference sums zeros (without the flushes: 3e-39)."""
    w = _jnormalised(C1_WEIGHTS)
    got = fr.fedavg_reduce(torch.from_numpy(C1_ROWS),
                           torch.from_numpy(np.array(w)))
    for want in (jfr.fedavg_reduce(jnp.asarray(C1_ROWS), w, interpret=True),
                 jref.fedavg_reduce_ref(jnp.asarray(C1_ROWS), w)):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not got.any()


def test_fedavg_aggregate_flushes_c1_rows():
    trees = [{"x": torch.from_numpy(r[:4].copy())} for r in C1_ROWS]
    jtrees = [{"x": jnp.asarray(r[:4])} for r in C1_ROWS]
    got = ops.fedavg_aggregate(trees, C1_WEIGHTS)["x"]
    want = jops.fedavg_aggregate(jtrees, C1_WEIGHTS, interpret=True)["x"]
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not got.any()


def test_fedavg_reduce_q8_plain_flushes():
    """q = 1 everywhere: client 0's scale FLT_MIN times w = 0.5 gives a
    subnormal product, client 1's subnormal scale reads as 0."""
    q = np.ones((2, COL), np.int8)
    s = np.stack([np.full(COL // 256, FMIN, np.float32),
                  np.full(COL // 256, 1e-39, np.float32)])
    w = np.asarray([0.5, 0.5], np.float32)
    got = fr.fedavg_reduce_q8(torch.from_numpy(q), torch.from_numpy(s),
                              torch.from_numpy(w), 256)
    jq, js, jw = jnp.asarray(q), jnp.asarray(s), jnp.asarray(w)
    for want in (jfr.fedavg_reduce_q8(jq, js, jw, block=256, interpret=True),
                 jref.fedavg_reduce_q8_ref(jq, js, jw, block=256)):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not got.any()


def test_fedavg_accumulate_plain_flushes():
    """acc + w * x, element by element: subnormal acc and x read as 0, a
    subnormal product and a subnormal sum become 0. Every product here is
    exact, so XLA's jitted form, which may contract the two operations
    into one FMA, rounds alike."""
    acc = np.zeros(COL, np.float32)
    acc[:6] = [1e-39, -1e-39, 0.0, np.float32(1.5) * FMIN, 2.0, -0.0]
    for w in (0.5, 1.0):
        x = np.zeros(COL, np.float32)
        x[:6] = [1.0, 1.0, FMIN, -FMIN / np.float32(w), 1e-39, -3e-39]
        got = fr.fedavg_accumulate(torch.from_numpy(acc),
                                   torch.from_numpy(x), w)
        for want in (jfr.fedavg_accumulate(jnp.asarray(acc), jnp.asarray(x),
                                           w, interpret=True),
                     jref.fedavg_accumulate_ref(jnp.asarray(acc),
                                                jnp.asarray(x), w)):
            np.testing.assert_array_equal(_bits(got), _bits(want))
        assert _no_subnormals(got)
    assert float(got[3]) == 0.0  # 1.5 FLT_MIN - FLT_MIN: a subnormal sum


@pytest.mark.parametrize("weights", [[1e-39, 1.0], [1e-30, 1e8],
                                     [3.0, 5.0, 1e-40]])
def test_weight_normalisation_flushes(weights):
    np.testing.assert_array_equal(_bits(ops._normalised(weights)),
                                  _bits(_jnormalised(weights)))


def test_plain_sums_flush_partial_sums_in_client_order():
    """1.5 FLT_MIN - FLT_MIN is a subnormal partial sum: flushed before
    the third client's FLT_MIN is added (a sequential f32 model of the
    kernels' order, since XLA's order differs)."""
    x = np.zeros((3, 8), np.float32)
    x[:, 0] = [np.float32(1.5) * FMIN, -FMIN, FMIN]
    w = torch.ones(3)
    got = fr.fedavg_reduce_plain(torch.from_numpy(x), w)
    assert got[0] == FMIN
    q = torch.ones((3, 256), dtype=torch.int8)
    q[1] = -1
    s = torch.tensor([[1.5 * FMIN], [FMIN], [FMIN]])
    assert fr.fedavg_reduce_q8_plain(q, s, w, 256)[0] == FMIN


def _window_pairs(rng, n):
    """(a, b) normal f32 whose products lie within 2**-21 of FLT_MIN, a
    sixteenth of them in the window (FLT_MIN - 2**-150, FLT_MIN -
    2**-151] that rounds up to FLT_MIN in IEEE arithmetic but that XLA's
    flush, which tests tininess after rounding to 24 bits with an
    unbounded exponent, makes zero."""
    a = ((1 + rng.integers(1, 2 ** 23, n) * 2.0 ** -23) * 2.0 ** -63) \
        * rng.choice([-1.0, 1.0], n)
    a = a.astype(np.float32)
    target = float(FMIN) * (1 + rng.uniform(-2.0 ** -21, 2.0 ** -21, n))
    b = (target / np.abs(a.astype(np.float64))).astype(np.float32)
    return a, b


def test_mul_ftz_matches_xla_in_the_rounding_window(rng):
    from repro_torch.kernels import quantize as qz
    a, b = _window_pairs(rng, 100_000)
    got = qz.mul_ftz(torch.from_numpy(a), torch.from_numpy(b))
    want = jnp.asarray(a) * jnp.asarray(b)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    ieee = _flush(a * b)  # round, then compare: not XLA's rule
    assert (_bits(ieee) != _bits(want)).sum() > 1000


def test_fedavg_reduce_plain_flushes_window_products(rng):
    """One client, so every order sums alike: each product in the window
    is flushed as the reference's kernel flushes it. Values, not bits: the
    sign of a zero sum follows the summation order (XLA drops the sum of
    one row and keeps the product's -0.0; the port adds it to +0.0), as
    the reference's Pallas kernel and jnp oracle differ on it already."""
    w = np.asarray([0.75], np.float32)
    target = float(FMIN) * (1 + rng.uniform(-2.0 ** -21, 2.0 ** -21, COL))
    x = ((target / 0.75) * rng.choice([-1.0, 1.0], COL)).astype(np.float32)
    x = x[None]
    got = fr.fedavg_reduce(torch.from_numpy(x), torch.from_numpy(w))
    want = jfr.fedavg_reduce(jnp.asarray(x), jnp.asarray(w), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == 0).sum() > 10


# -- the server merge -------------------------------------------------------

def test_merge_global_flushes():
    g = np.asarray([1e-39, 3e-39, 1.0], np.float32)
    m = np.asarray([1e-39, 0.0, 1.0], np.float32)
    got = agg.merge_global({"x": torch.from_numpy(g)},
                           {"x": torch.from_numpy(m)}, 0.5)["x"]
    want = jagg.merge_global({"x": jnp.asarray(g)}, {"x": jnp.asarray(m)},
                             0.5)["x"]
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(got.numpy(), [0.0, 0.0, 1.0])


@pytest.mark.parametrize("lam", [0.3, 0.123456])
def test_merge_global_of_model_trees_matches_reference(lam):
    """A reduced ResNet56 tree (43 leaves), tiny values mixed in: the
    port merges one flat vector per tree, the reference leaf by leaf; the
    two agree bit for bit and keep each leaf's shape and dtype."""
    from repro_torch import _tree
    from repro_torch.models.vision import ResNet, ResNetConfig
    model = ResNet(ResNetConfig(blocks_per_stage=2, num_classes=8,
                                image_size=16), device="cpu")
    g, m = (model.init(torch.Generator().manual_seed(s)) for s in (0, 1))
    rng = np.random.default_rng(7)
    for leaf in _tree.leaves(g)[::3]:
        leaf.view(-1)[::5] = torch.from_numpy(_tiny(rng, leaf.numel())[::5])
    got = agg.merge_global(g, m, lam)
    want = jagg.merge_global(*(_tree.map(lambda a: jnp.asarray(a.numpy()), t)
                               for t in (g, m)), lam)
    for a, b, ref in zip(_tree.leaves(got), jax.tree.leaves(want),
                         _tree.leaves(g)):
        assert a.shape == ref.shape and a.dtype == ref.dtype
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    with pytest.raises(ValueError, match="structures"):
        agg.merge_global(g, {"other": m}, lam)


@pytest.mark.parametrize("s", [0.3, -1e-39, 3.0 * 2.0 ** -127, 7.0])
def test_ftz_host_scalars_match_tensor_scalars(s, rng):
    """A host number given to ``mul_ftz`` / ``div_ftz`` (as the server
    merge and ``merged`` give theirs) is rounded and flushed as a 0-dim
    f32 tensor of the same value would be."""
    from repro_torch.kernels import quantize as qz
    x = np.concatenate([rng.normal(size=64), _tiny(rng, 64),
                        [FMIN * 0.75, FMIN * 1.5, 0.0, -0.0]]) \
        .astype(np.float32)
    xt, st = torch.from_numpy(x), torch.tensor(s, dtype=torch.float32)
    for op in (qz.mul_ftz, qz.div_ftz):
        np.testing.assert_array_equal(_bits(op(xt, s).numpy()),
                                      _bits(op(xt, st).numpy()))
    np.testing.assert_array_equal(_bits(qz.mul_ftz(s, xt).numpy()),
                                  _bits(qz.mul_ftz(st, xt).numpy()))


def _fold_all(acc_cls, payload_cls, trees, weights, **kw):
    acc = acc_cls()
    for tree, w in zip(trees, weights):
        acc.fold(types.SimpleNamespace(weight=w, count=1,
                                       payload=payload_cls(tree)), 1.0, **kw)
    return acc.merged()[0]


def test_streaming_merged_flushes_quotient():
    """2e-38 folded with weight 1 and zeros with weight 7: the merge
    divides 2e-38 by 8, a subnormal the reference flushes."""
    x = np.full(8, 2e-38, np.float32)
    z = np.zeros(8, np.float32)
    got = _fold_all(agg.StreamingAccumulator, TensorPayload,
                    [{"x": torch.from_numpy(x)}, {"x": torch.from_numpy(z)}],
                    [1.0, 7.0])["x"]
    want = _fold_all(jagg.StreamingAccumulator, JPayload,
                     [{"x": jnp.asarray(x)}, {"x": jnp.asarray(z)}],
                     [1.0, 7.0], interpret=True)["x"]
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not got.any()


# -- random rows across the subnormal range ---------------------------------

def _random_case(what, rng):
    """-> (port output, reference output) on random inputs spanning
    1e-46-1e-33 (with a few normal values)."""
    n, t = 3, COL
    x = _tiny(rng, n, t)
    x[:, ::97] = rng.normal(size=x[:, ::97].shape) * 1e-30
    w = np.asarray([0.2, 0.3, 0.5], np.float32)
    if what == "fedavg_reduce":
        return (fr.fedavg_reduce(torch.from_numpy(x), torch.from_numpy(w)),
                jfr.fedavg_reduce(jnp.asarray(x), jnp.asarray(w),
                                  interpret=True))
    if what == "fedavg_reduce_q8":
        q = rng.integers(-127, 128, size=(n, t)).astype(np.int8)
        s = np.abs(_tiny(rng, n, t // 256)) * 1e2
        args = (q, s, w)
        return (fr.fedavg_reduce_q8(*map(torch.from_numpy, args), 256),
                jfr.fedavg_reduce_q8(*map(jnp.asarray, args), block=256,
                                     interpret=True))
    if what == "fedavg_accumulate":
        return (fr.fedavg_accumulate(torch.from_numpy(x[0]),
                                     torch.from_numpy(x[1]), 0.37),
                jfr.fedavg_accumulate(jnp.asarray(x[0]), jnp.asarray(x[1]),
                                      0.37, interpret=True))
    if what == "fedavg_aggregate":
        trees = [{"a": r[:100], "b": r[100:]} for r in x]
        return (ops.fedavg_aggregate([{k: torch.from_numpy(v.copy())
                                       for k, v in tr.items()}
                                      for tr in trees], [1.0, 3.0, 5.0])["b"],
                jops.fedavg_aggregate([{k: jnp.asarray(v)
                                        for k, v in tr.items()}
                                       for tr in trees], [1.0, 3.0, 5.0],
                                      interpret=True)["b"])
    if what == "merge_global":
        return (agg.merge_global([torch.from_numpy(x[0])],
                                 [torch.from_numpy(x[1])], 0.3)[0],
                jagg.merge_global([jnp.asarray(x[0])], [jnp.asarray(x[1])],
                                  0.3)[0])
    if what == "merged":
        return (_fold_all(agg.StreamingAccumulator, TensorPayload,
                          [[torch.from_numpy(r)] for r in x], [3.0, 5.0, 7.0]
                          )[0],
                _fold_all(jagg.StreamingAccumulator, JPayload,
                          [[jnp.asarray(r)] for r in x], [3.0, 5.0, 7.0],
                          interpret=True)[0])
    flats, errs = x[0], x[1] * 1e3
    if what == "qsgd_residual":
        (_,), (gs,) = qsgd.qsgd_compress_flat_batch(
            [torch.from_numpy(flats)],
            [qsgd.QuantState(torch.from_numpy(errs))])
        (_,), (ws,) = jqsgd.qsgd_compress_flat_batch(
            [jnp.asarray(flats)], [jqsgd.QuantState(jnp.asarray(errs))],
            interpret=True)
        return gs.error, ws.error
    assert what == "topk_residual"
    (_,), (gs,) = topk.topk_compress_flat_batch(
        [torch.from_numpy(flats)], [qsgd.QuantState(torch.from_numpy(errs))],
        k_frac=0.05)
    (_,), (ws,) = jtopk.topk_compress_flat_batch(
        [jnp.asarray(flats)], [jqsgd.QuantState(jnp.asarray(errs))],
        k_frac=0.05, interpret=True)
    return gs.error, ws.error


@pytest.mark.parametrize("what", ["fedavg_reduce", "fedavg_reduce_q8",
                                  "fedavg_accumulate", "fedavg_aggregate",
                                  "merge_global", "merged", "qsgd_residual",
                                  "topk_residual"])
def test_random_rows_across_subnormal_range(what, rng):
    got, want = _random_case(what, rng)
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert _no_subnormals(want)  # the reference flushes
    assert _no_subnormals(got)
    assert np.any(got != 0)  # normal values survive
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
