"""Checkpoints: the reference's own cases (``tests/test_checkpoint.py``)
held on the port, and the on-disk format across packages: a ``(params,
OptState)`` tree of bf16, f32 and int32 leaves saved by either package
loads in the other bit for bit, and the two packages write the same
leaf names, shapes, dtypes and crc32s.
"""
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import load_checkpoint as jload  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.optim import OptState as JOptState  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    load_checkpoint, save_checkpoint)
from repro_torch.checkpoint.ckpt import list_steps  # noqa: E402
from repro_torch.optim import OptState  # noqa: E402


def _tree_of(v=1.0):
    return {"layer": {"w": torch.full((8, 4), v), "b": torch.zeros((4,))},
            "step_scale": torch.tensor(0.5)}


# -- the reference's cases ----------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 3, _tree_of(2.0), meta={"note": "x"})
    restored, step, meta = load_checkpoint(d, _tree_of(0.0))
    assert step == 3 and meta["note"] == "x"
    np.testing.assert_array_equal(restored["layer"]["w"].numpy(), 2.0)


def test_checksum_detects_corruption(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree_of())
    path = os.path.join(d, "step_000000001", "arrays.npz")
    data = dict(np.load(path))
    data["layer/w"] = data["layer/w"] + 1.0
    np.savez(path, **data)
    with pytest.raises(IOError):
        load_checkpoint(d, _tree_of())


def test_keep_last_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_writes=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree_of(float(s)))
    assert list_steps(str(tmp_path)) == [3, 4]
    restored, step, _ = mgr.restore(_tree_of())
    assert step == 4
    np.testing.assert_array_equal(restored["layer"]["w"].numpy(), 4.0)


def test_async_write_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_writes=True)
    tree = _tree_of(7.0)
    mgr.save(7, tree)
    tree["layer"]["w"].fill_(-1.0)  # the pending write holds its own copy
    mgr.wait()
    restored, step, _ = mgr.restore(_tree_of())
    assert step == 7
    np.testing.assert_array_equal(restored["layer"]["w"].numpy(), 7.0)


def test_restore_onto_a_device(tmp_path):
    """The port's counterpart of the reference's restore with new
    shardings: leaves land on ``device=`` whatever the template's (a
    ``meta`` template too), in the template's dtype."""
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree_of(3.0))
    template = _tree.map(lambda t: torch.empty(t.shape, dtype=torch.float64,
                                               device="meta"), _tree_of())
    restored, _, _ = load_checkpoint(d, template, device="cpu")
    w = restored["layer"]["w"]
    assert w.device.type == "cpu" and w.dtype == torch.float64
    np.testing.assert_array_equal(w.numpy(), 3.0)


def test_shape_mismatch_rejected(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree_of())
    bad = {"layer": {"w": torch.zeros((4, 4)), "b": torch.zeros((4,))},
           "step_scale": torch.tensor(0.0)}
    with pytest.raises(ValueError):
        load_checkpoint(d, bad)


# -- across packages ----------------------------------------------------------

def _np_state(seed):
    """A (params, OptState) tree as numpy: bf16 and f32 parameters, f32
    moments, an int32 count; the bf16 values as f32 to be cast."""
    rng = np.random.default_rng(seed)
    p = {"embed": {"tok": rng.normal(size=(16, 8)).astype(np.float32)},
         "blocks": [rng.normal(size=(2, 8, 8)).astype(np.float32),
                    rng.normal(size=(8,)).astype(np.float32)]}
    m = _tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), p)
    v = _tree.map(lambda a: rng.random(size=a.shape).astype(np.float32), p)
    return p, m, v


BF16 = ("embed/tok", "blocks/1")  # parameters kept in bf16


def _jax_state(seed):
    p, m, v = _np_state(seed)
    jp = {"embed": {"tok": jnp.asarray(p["embed"]["tok"]).astype(jnp.bfloat16)},
          "blocks": [jnp.asarray(p["blocks"][0]),
                     jnp.asarray(p["blocks"][1]).astype(jnp.bfloat16)]}
    return (jp, JOptState(count=jnp.asarray(5, jnp.int32),
                          m=jax.tree.map(jnp.asarray, m),
                          v=jax.tree.map(jnp.asarray, v)))


def _torch_state(seed):
    p, m, v = _np_state(seed)
    tp = {"embed": {"tok": torch.from_numpy(p["embed"]["tok"]).bfloat16()},
          "blocks": [torch.from_numpy(p["blocks"][0]),
                     torch.from_numpy(p["blocks"][1]).bfloat16()]}
    return (tp, OptState(count=torch.tensor(5, dtype=torch.int32),
                         m=_tree.map(torch.from_numpy, m),
                         v=_tree.map(torch.from_numpy, v)))


def _bits(x):
    """A leaf's raw bytes as a flat uint8 array (bf16 included)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return (x.view(torch.uint8) if x.dtype == torch.bfloat16
                else x).numpy().reshape(-1).view(np.uint8)
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _same_bits(torch_tree, jax_tree):
    tl, jl = _tree.leaves(torch_tree), jax.tree.leaves(jax_tree)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert str(t.dtype) == f"torch.{j.dtype}"
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_array_equal(_bits(t), _bits(j))


def test_port_and_reference_write_the_same_checkpoint(tmp_path):
    jsave(str(tmp_path / "ref"), 5, _jax_state(0), meta={"arch": "x"})
    save_checkpoint(str(tmp_path / "port"), 5, _torch_state(0),
                    meta={"arch": "x"})
    manifests = [json.load(open(tmp_path / side / "step_000000005"
                                / "manifest.json"))
                 for side in ("ref", "port")]
    assert manifests[0] == manifests[1]
    names = list(manifests[0]["leaves"])
    assert names == ["0/blocks/0", "0/blocks/1", "0/embed/tok", "1/.count",
                     "1/.m/blocks/0", "1/.m/blocks/1", "1/.m/embed/tok",
                     "1/.v/blocks/0", "1/.v/blocks/1", "1/.v/embed/tok"]
    assert manifests[0]["leaves"]["0/embed/tok"]["dtype"] == "bfloat16"
    arrays = [np.load(tmp_path / side / "step_000000005" / "arrays.npz")
              for side in ("ref", "port")]
    assert sorted(arrays[0].files) == sorted(arrays[1].files)
    for k in arrays[0].files:
        assert arrays[0][k].dtype == arrays[1][k].dtype, k
        np.testing.assert_array_equal(arrays[0][k], arrays[1][k], err_msg=k)


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    d = str(tmp_path)
    saved = _torch_state(1)
    save_checkpoint(d, 9, saved, meta={"from": "port"})
    template = jax.tree.map(jnp.zeros_like, _jax_state(2))
    restored, step, meta = jload(d, template)
    assert step == 9 and meta == {"from": "port"}
    assert isinstance(restored[1], JOptState)
    _same_bits(saved, restored)


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    d = str(tmp_path)
    saved = _jax_state(3)
    jsave(d, 11, saved, meta={"from": "reference"})
    template = _tree.map(torch.zeros_like, _torch_state(4))
    restored, step, meta = load_checkpoint(d, template)
    assert step == 11 and meta == {"from": "reference"}
    assert isinstance(restored[1], OptState)
    _same_bits(restored, saved)
