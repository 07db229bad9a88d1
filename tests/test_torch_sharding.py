"""The logical-axis sharding plan and the models' axes, port against the
JAX reference on the CPU: ``param_axes()`` and ``param_shapes()`` of the
ten full configs key for key (the reference's through ``jax.eval_shape``,
the port's on ``meta``), ``input_specs`` for every (arch, shape) the
applicability matrix allows, the decode caches' axes, and ``MeshPlan``'s
partition spec of every parameter, optimizer-state and input leaf on the
four meshes, equal to the reference's ``PartitionSpec`` entry for entry;
the reference's ``tests/test_sharding.py`` cases held on the port; and
that ``Sharder`` and ``make_mesh`` need a process group for a mesh of
more than one device (``tests/test_torch_multidevice.py`` runs one).
"""
import pytest
from _hypothesis_compat import given, settings, st

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import (MULTI_POD_MESH as JMULTI,  # noqa: E402
                                MULTI_POD_MESH_FSDP_POD as JFSDP_POD,
                                SINGLE_POD_MESH as JSINGLE, SMOKE_MESH as JSMOKE)
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.launch.step_builders import bundle_for as jbundle  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.layers import abstract_init  # noqa: E402
from repro.optim.optimizers import adamw_init as jadamw_init  # noqa: E402
from repro.optim.optimizers import opt_state_axes as jopt_axes  # noqa: E402
from repro.sharding.rules import MeshPlan as JPlan  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.configs import (ARCH_ORDER, SHAPE_ORDER, SHAPES,  # noqa: E402
                                 applicability, get_config, smoke_config)
from repro_torch.configs.base import (MULTI_POD_MESH, MULTI_POD_MESH_FSDP_POD,  # noqa: E402
                                      SINGLE_POD_MESH, SMOKE_MESH, MeshConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.launch.mesh import (Mesh, make_mesh, make_smoke_mesh,  # noqa: E402
                                     mesh_config_for)
from repro_torch.launch.step_builders import bundle_for  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.optim.optimizers import opt_state_axes  # noqa: E402
from repro_torch.sharding import (MeshPlan, Sharder, batch_spec,  # noqa: E402
                                  bytes_of, constrain)

MESHES = {"single_pod": (SINGLE_POD_MESH, JSINGLE),
          "multi_pod": (MULTI_POD_MESH, JMULTI),
          "multi_pod_fsdp_pod": (MULTI_POD_MESH_FSDP_POD, JFSDP_POD),
          "smoke": (SMOKE_MESH, JSMOKE)}
LOGICAL = ["layers", "vocab", "embed", "heads", "kv_heads", "mlp", "expert",
           "expert_in", "batch", "seq", "seq_kv", "ssm_inner", "norm", None]


def is_axes(x):
    return x is None or (isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x))


def ref_leaves(tree):
    """-> [(path, leaf)] of a reference tree whose leaves are axes tuples,
    PartitionSpecs or shape structs, in flatten order."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: is_axes(x)
        or isinstance(x, jax.sharding.PartitionSpec))[0]
    return [(jax.tree_util.keystr(p), l) for p, l in flat]


def is_spec(x):
    """A port partition spec: a tuple of names, None, or tuples of names."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) or (isinstance(e, tuple) and all(
            isinstance(n, str) for n in e)) for e in x)


def port_leaves(tree):
    return _tree.leaves(tree, is_axes)


def port_paths(tree, path=""):
    """jax's ``keystr`` of every axes leaf of a port tree of dicts."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in port_paths(tree[k], f"{path}['{k}']")]
    return [path]


def ref_shapes(jm):
    return abstract_init(jm.init)[0]


def as_jax(spec):
    """A port spec as jax's ``PartitionSpec`` reads back: jax 0.9 stores a
    one-name tuple entry as the name (``P(('pod',))`` iterates as
    ``('pod',)``), where the port keeps the tuple the reference's code
    builds for a truncated rule (``sharding/rules.py:107-109``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def specs_equal(got_tree, want_tree):
    """The port's spec tuples against the reference's PartitionSpecs, or
    the specs of its NamedShardings, leaf for leaf."""
    named = not _is_spec_tree(want_tree)
    want = ref_leaves(jax.tree.map(
        lambda s: s.spec, want_tree,
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
        if named else want_tree)
    got = _tree.leaves(got_tree, is_spec)
    assert len(got) == len(want)
    for g, (path, w) in zip(got, want):
        assert as_jax(g) == tuple(w), (path, g, w)


def _is_spec_tree(tree):
    leaves = jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return not leaves or isinstance(leaves[0], jax.sharding.PartitionSpec)


# -- the models' axes, shapes and input specs ---------------------------------

@pytest.mark.parametrize("arch", ARCH_ORDER)
def test_param_axes_and_shapes_match_reference(arch):
    jm, tm = jbuild(jget(arch)), build_model(get_config(arch), device="meta")
    want, got = ref_leaves(jm.param_axes()), port_leaves(tm.param_axes())
    assert [a for _, a in want] == got
    assert [p for p, _ in want] == port_paths(tm.param_axes())
    jshapes = jax.tree.leaves(ref_shapes(jm))
    tshapes = _tree.leaves(tm.param_shapes())
    assert [(tuple(s.shape), str(s.dtype)) for s in jshapes] == \
        [(tuple(s.shape), str(s.dtype).replace("torch.", "")) for s in tshapes]
    assert _tree.flatten(tm.param_axes(), is_axes)[1] == \
        _tree.flatten(tm.param_shapes())[1]


def _spec_pairs():
    for arch in ARCH_ORDER:
        for sname in SHAPE_ORDER:
            if applicability(get_config(arch), SHAPES[sname])[0]:
                yield arch, sname


@pytest.mark.parametrize("arch,shape", list(_spec_pairs()))
def test_input_specs_match_reference(arch, shape):
    jspecs, jaxes = jbuild(jget(arch)).input_specs(_jshape(SHAPES[shape]))
    tspecs, taxes = build_model(get_config(arch), device="meta").input_specs(
        SHAPES[shape])
    assert taxes == jaxes
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jspecs.items()} == \
        {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in tspecs.items()}
    assert all(v.device.type == "meta" for v in tspecs.values())


@pytest.mark.parametrize("arch", ["qwen3-8b", "zamba2-1.2b", "xlstm-1.3b",
                                  "llama-3.2-vision-11b"])
def test_cache_axes_match_reference(arch):
    _, jaxes = jbuild(jget(arch)).cache_spec(4, 64)
    got = build_model(get_config(arch), device="meta").cache_axes()
    assert port_leaves(got) == [a for _, a in ref_leaves(jaxes)]
    assert port_paths(got) == [p for p, _ in ref_leaves(jaxes)]


def _jshape(s: ShapeConfig):
    return JShape(s.name, s.seq_len, s.global_batch, s.kind)


# -- MeshPlan.spec on the four meshes -----------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_ORDER)
def test_partition_specs_match_reference(arch, mesh):
    """Every parameter, AdamW state and train/decode input leaf of the full
    config, with the divisibility fallback on the leaf's shape."""
    tcfg, jcfg = MESHES[mesh]
    tplan, jplan = MeshPlan(tcfg), JPlan(jcfg)
    jm, tm = jbuild(jget(arch)), build_model(get_config(arch), device="meta")
    jshapes, taxes = ref_shapes(jm), tm.param_axes()
    jaxes = jm.param_axes()
    specs_equal(tplan.tree_specs(taxes, tm.param_shapes()),
                jplan.tree_specs(jaxes, jshapes))
    specs_equal(tplan.tree_specs(taxes), jplan.tree_specs(jaxes))
    jo = jax.eval_shape(lambda p: jadamw_init(p, JTrain()), jshapes)
    to = adamw_init(tm.param_shapes(), TrainConfig())
    specs_equal(tplan.tree_specs(opt_state_axes(taxes, TrainConfig()), to),
                jplan.tree_specs(jopt_axes(jaxes, JTrain()), jo))
    for sname in ("train_4k", "decode_32k"):
        if not applicability(get_config(arch), SHAPES[sname])[0]:
            continue
        jspecs, jin = jm.input_specs(_jshape(SHAPES[sname]))
        tspecs, tin = tm.input_specs(SHAPES[sname])
        specs_equal(tplan.tree_specs(tin, tspecs),
                    jplan.tree_specs(jin, jspecs))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode", "fl_round"])
def test_bundle_shardings_match_reference(kind):
    """The step bundles' shardings fields hold the reference's specs: a
    smoke config on the multi-pod plan (its pod axis over 2 pods for the
    FL round), the reference's bundle built over a one-device Auto mesh."""
    arch = "granite-moe-1b-a400m"
    shape = ShapeConfig("t", 64, 8, "decode" if kind == "decode" else
                        "prefill" if kind == "prefill" else "train")
    names = MULTI_POD_MESH.axis_names
    jmesh = jax.make_mesh((1, 1, 1), names, axis_types=(AxisType.Auto,) * 3)
    kw = {"local_steps": 2} if kind == "fl_round" else {}
    jb = jbundle(kind, smoke_config(arch) and _jsmoke(arch), _jshape(shape),
                 jmesh, JMULTI, JTrain(), **kw)
    tb = bundle_for(kind, smoke_config(arch), shape,
                    make_mesh(MeshConfig((1, 1, 1), names), "cpu"),
                    MULTI_POD_MESH, TrainConfig(), **kw)
    specs_equal(tb.in_shardings, jb.in_shardings)
    specs_equal(tb.out_shardings, jb.out_shardings)
    assert len(tb.in_specs) == len(jb.in_specs)
    for t, j in zip(tb.in_specs, jb.in_specs):
        tl, jl = _tree.leaves(t), jax.tree.leaves(j)
        assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]


def _jsmoke(arch):
    from repro.configs import smoke_config as jsmoke
    return jsmoke(arch)


# -- the reference's own cases (tests/test_sharding.py) -----------------------

def test_basic_resolution():
    plan = MeshPlan(SINGLE_POD_MESH)
    assert plan.spec(("vocab", "embed")) == ("model", "data")
    assert plan.spec(("embed", "heads")) == ("data", "model")
    assert plan.spec(("norm",)) == ()
    assert plan.spec(("layers", "embed", "mlp")) == (None, "data", "model")


def test_duplicate_axis_dropped():
    plan = MeshPlan(SINGLE_POD_MESH)
    # expert and mlp both map to 'model': second use must be dropped
    spec = plan.spec(("expert", "expert_in", "mlp"))
    flat = []
    for s in spec:
        if s is not None:
            flat += list(s) if isinstance(s, tuple) else [s]
    assert len(flat) == len(set(flat))
    assert spec[0] == "model"


def test_divisibility_fallback():
    plan = MeshPlan(MULTI_POD_MESH)
    assert plan.spec(("batch",), (1,)) == ()
    assert plan.spec(("batch",), (128,)) == (("pod", "data"),)
    assert plan.spec(("batch",), (2,)) == (("pod",),)
    assert batch_spec(plan, 2) == (("pod",),)


@given(axes=st.lists(st.sampled_from(LOGICAL), min_size=0, max_size=5),
       mesh=st.sampled_from(list(MESHES)))
@settings(max_examples=200, deadline=None)
def test_spec_matches_reference_and_never_reuses_a_mesh_axis(axes, mesh):
    tcfg, jcfg = MESHES[mesh]
    spec = MeshPlan(tcfg).spec(tuple(axes))
    assert as_jax(spec) == tuple(JPlan(jcfg).spec(tuple(axes)))
    flat = []
    for s in spec:
        if s is not None:
            flat += list(s) if isinstance(s, tuple) else [s]
    assert len(flat) == len(set(flat))
    assert all(a in tcfg.axis_names for a in flat)


@given(axes=st.lists(st.sampled_from(LOGICAL), min_size=1, max_size=4),
       dims=st.lists(st.sampled_from([1, 2, 3, 16, 32, 256, 4096]),
                     min_size=1, max_size=4))
@settings(max_examples=200, deadline=None)
def test_shape_aware_spec_always_divisible(axes, dims):
    n = min(len(axes), len(dims))
    axes, dims = tuple(axes[:n]), tuple(dims[:n])
    spec = MeshPlan(MULTI_POD_MESH).spec(axes, dims)
    assert as_jax(spec) == tuple(JPlan(JMULTI).spec(axes, dims))
    for dim, s in zip(dims, spec + (None,) * (n - len(spec))):
        if s is None:
            continue
        total = 1
        for p in s if isinstance(s, tuple) else (s,):
            total *= MULTI_POD_MESH.axis_size(p)
        assert dim % total == 0, (axes, dims, spec)


def test_tree_specs_match_structure():
    plan = MeshPlan(SINGLE_POD_MESH)
    axes_tree = {"a": ("embed", "heads"), "b": {"c": ("norm",), "d": None}}
    specs = plan.tree_specs(axes_tree)
    assert specs["a"] == ("data", "model")
    assert specs["b"]["c"] == ()
    assert specs["b"]["d"] == ()


# -- one device ---------------------------------------------------------------

def test_sharder_is_the_identity_on_one_device_and_raises_on_more():
    x = torch.ones(4, 8)
    assert Sharder()(x, ("batch", None)) is x
    assert Sharder(MeshPlan(SMOKE_MESH), make_smoke_mesh("cpu"))(
        x, ("batch", None)) is x
    plan = MeshPlan(SINGLE_POD_MESH)
    big = Mesh(SINGLE_POD_MESH.axis_names, SINGLE_POD_MESH.shape,
               torch.device("cpu"))
    # a record of 256 real devices with no DeviceMesh places nothing: it
    # raises (tests/test_torch_multidevice.py places over real ranks)
    with pytest.raises(ValueError, match="no DeviceMesh"):
        Sharder(plan, big)(x, ("batch", None))
    assert constrain(x, MeshPlan(SMOKE_MESH), ("batch", None)) is x
    with pytest.raises(ValueError, match="place it on a mesh"):
        constrain(x, plan, ("batch", None))
    with pytest.raises(ValueError, match="no DeviceMesh"):
        bundle_for("train", smoke_config("qwen3-8b"),
                   ShapeConfig("t", 16, 4, "train"), big, SINGLE_POD_MESH)


def test_meshes():
    m = make_smoke_mesh("cpu")
    assert (m.axis_names, m.shape, m.device) == (("data", "model"), (1, 1),
                                                 torch.device("cpu"))
    assert mesh_config_for(m) == SMOKE_MESH
    for cfg in (SINGLE_POD_MESH, MULTI_POD_MESH):
        with pytest.raises(RuntimeError, match="process group"):
            make_mesh(cfg, "cpu")  # no group of 256 / 512 ranks here
        assert mesh_config_for(Mesh(cfg.axis_names, cfg.shape, None)) == cfg
    assert MULTI_POD_MESH.num_devices == 512
    assert MULTI_POD_MESH.axis_size("pod") == 2
    assert SINGLE_POD_MESH.axis_size("pod") == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_smoke_mesh()


def test_bytes_of_counts_meta_leaves():
    tree = {"a": torch.empty(4, 8, dtype=torch.bfloat16, device="meta"),
            "b": [torch.empty(3, dtype=torch.float32, device="meta")]}
    assert bytes_of(tree) == 4 * 8 * 2 + 3 * 4
