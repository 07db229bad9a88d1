"""Shared by the LM zoo's parity tests (``test_torch_decode.py``,
``test_torch_recurrent.py``): the reference's model and the port's,
started from the reference's own initialised parameters (carried across
by ``params_from_jax(like=...)``, bf16 bit for bit), the same seeded
numpy batches, and the bars.

Bars: the layer functions at rtol 1e-5; models, gradients and decode
steps in f32 at rtol 1e-4 with an atol of 1e-4 of the compared tensor's
largest entry (two f32 matmuls summed in another order differ in the
last bits near zero); the leaves whose gradient is exactly zero are held
to zero within 1e-6 of the model's largest gradient entry; bf16 logits at
5e-2 of the largest |logit| (bf16 against f32 of the same parameters
reads up to 1.3e-2 in the reference alone).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import AxisType

from repro.configs import smoke_config as jsmoke
from repro.models import build_model as jbuild
from repro_torch import _tree
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model

LAYER_RTOL = 1e-5
MODEL_RTOL = 1e-4
BF16_BAR = 5e-2
ZERO_BAR = 1e-6


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


@functools.lru_cache(maxsize=None)
def _ref_params(jcfg):
    jm = jbuild(jcfg)
    return jax.tree.map(np.asarray, jm.init(jax.random.key(0))[0])


def pair(arch, precision="f32"):
    """-> (reference model, its params as numpy, port model, port params
    converted from them), on the CPU, for ``arch``'s smoke config in f32
    or in its own bf16."""
    jc, tc = jsmoke(arch), smoke_config(arch)
    if precision == "f32":
        jc, tc = f32(jc), f32(tc)
    return pair_of(jc, tc)


def pair_of(jc, tc):
    """``pair`` for a given reference config and its port twin."""
    jm, tm = jbuild(jc), build_model(tc, device="cpu")
    jp = _ref_params(jc)
    tp = params_from_jax(jp, "cpu",
                         like=build_model(tc, device="meta").init(None))
    return jm, jp, tm, tp


def batch(cfg, seed, b=2, s=16):
    """A seeded numpy batch: tokens or frame embeddings, image embeddings
    for the VLM, targets."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.external_embeddings:
        out["embeds"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    if cfg.family == "vlm":
        out["image_embeds"] = rng.normal(
            size=(b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    out["targets"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return out


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def as_f32(x):
    """A tensor or array (bf16 too) as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def close(got, want, rtol):
    got, want = as_f32(got), as_f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def within(got, want, bar):
    """max |got - want| within ``bar`` of the largest |want|."""
    got, want = as_f32(got), as_f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= bar * float(np.abs(want).max()), err


def ref_paths(tree):
    return [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def loss_and_grads_match(jloss, jp, tloss, tp, zero=()):
    """Loss and every gradient leaf, reference against port, from the same
    parameters. A leaf whose path contains one of ``zero`` has a gradient
    of exactly zero; both packages' are held to zero against the model's
    largest gradient entry. An input the port never reads gets no
    gradient from autograd: it counts as zero."""
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(jnp.asarray, jp))
    leaves, treedef = _tree.flatten(tp)
    leaves = [l.clone().requires_grad_(True) for l in leaves]
    tl = tloss(_tree.unflatten(treedef, leaves))
    tg = torch.autograd.grad(tl, leaves, allow_unused=True,
                             materialize_grads=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=MODEL_RTOL)
    paths = ref_paths(jg)
    jleaves = [np.asarray(w) for w in jax.tree.leaves(jg)]
    assert len(jleaves) == len(tg) == len(paths)
    top = max(float(np.abs(w).max()) for w in jleaves)
    n_zero = 0
    for path, g, w in zip(paths, tg, jleaves):
        if any(z in path for z in zero):
            assert float(np.abs(w).max()) <= ZERO_BAR * top, path
            assert float(g.abs().max()) <= ZERO_BAR * top, path
            n_zero += 1
            continue
        close(g, w, MODEL_RTOL)
    assert n_zero or not zero


def decode_pair(jm, jp, tm, tp, tokens, smax):
    """``len(tokens[0])`` decode steps in both packages from fresh caches:
    -> ([(reference logits, port logits)] per step, the reference's final
    cache, the port's)."""
    step = jax.jit(jm.decode_step)
    jcache = jm.init_cache(tokens.shape[0], smax)
    tcache = tm.init_cache(tokens.shape[0], smax)
    jparams = jax.tree.map(jnp.asarray, jp)
    out = []
    with torch.inference_mode():
        for pos in range(tokens.shape[1]):
            t = tokens[:, pos:pos + 1]
            jl, jcache = step(jparams, jcache, {"tokens": jnp.asarray(t),
                                                "pos": jnp.int32(pos)})
            tl, tcache = tm.decode_step(tp, tcache,
                                        {"tokens": torch.from_numpy(t),
                                         "pos": pos})
            out.append((np.asarray(jl), tl.clone()))
    return out, jcache, tcache


def caches_match(jcache, tcache, rtol):
    jl = jax.tree.leaves(jcache)
    tl = _tree.leaves(tcache)
    assert len(jl) == len(tl)
    for path, w, g in zip(ref_paths(jcache), jl, tl):
        w = as_f32(w)
        if not np.abs(w).max() or np.abs(w).max() >= 1e29:
            # all zero (the VLM's unfilled cross cache), or holding the
            # -1e30 stabiliser fill: exact
            np.testing.assert_array_equal(as_f32(g), w, err_msg=path)
            continue
        close(g, w, rtol)


def cache_dtypes_match(jcache, tcache):
    """Every cache leaf in the reference's dtype: a state kept in bf16
    where the reference keeps f32 moves bf16 logits less than bf16 noise
    does, so the logits alone do not show it."""
    jl, tl = jax.tree.leaves(jcache), _tree.leaves(tcache)
    assert len(jl) == len(tl)
    for path, w, g in zip(ref_paths(jcache), jl, tl):
        assert str(g.dtype) == f"torch.{w.dtype}", (path, g.dtype, w.dtype)


def reference_serve(jm, jp, prompts, gen):
    """The reference's serve loop (``launch/serve.py:44-66``) on given
    params and prompts: -> generated tokens (requests, gen)."""
    decode = jax.jit(jm.decode_step)
    params = jax.tree.map(jnp.asarray, jp)
    cache = jm.init_cache(prompts.shape[0], prompts.shape[1] + gen)
    prompts = jnp.asarray(prompts)
    for pos in range(prompts.shape[1]):
        logits, cache = decode(params, cache, {"tokens": prompts[:, pos:pos + 1],
                                               "pos": jnp.int32(pos)})
    tok = jnp.argmax(logits[:, -1], axis=-1, keepdims=True).astype(jnp.int32)
    out = []
    for i in range(gen):
        logits, cache = decode(params, cache, {
            "tokens": tok, "pos": jnp.int32(prompts.shape[1] + i)})
        tok = jnp.argmax(logits[:, -1], axis=-1,
                         keepdims=True).astype(jnp.int32)
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


def auto_mesh(shape, names):
    """A mesh with ``AxisType.Auto`` axes: the reference's step bundles run
    jitted with their shardings on it (jax 0.9.0 rejects their
    ``with_sharding_constraint`` on ``make_smoke_mesh``'s Explicit axes)."""
    return jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(shape))


def trees_match(got, want, bar=MODEL_RTOL, tree_wide=()):
    """Each leaf of the port's tree against the reference's at rtol
    ``bar`` with an atol of ``bar`` times its largest entry; a leaf whose
    path holds one of ``tree_wide`` with an atol of ``bar`` times the
    tree's largest entry. Dtypes equal."""
    gl, wl = _tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    top = max(float(np.abs(as_f32(w)).max()) for w in wl)
    for path, g, w in zip(ref_paths(want), gl, wl):
        assert str(g.dtype) == f"torch.{w.dtype}", (path, g.dtype, w.dtype)
        w = as_f32(w)
        wide = any(t in path for t in tree_wide)
        np.testing.assert_allclose(
            as_f32(g), w, rtol=bar, err_msg=path,
            atol=bar * (top if wide else float(np.abs(w).max())))
