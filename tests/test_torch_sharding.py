"""The port's sharding rules against the JAX reference, on the CPU.

`repro_torch.sharding.rules.spec_for` must give the reference's
`spec_for` (compared as `tuple(PartitionSpec)`) for every parameter of
all ten architectures at published width (the reference's tree through
`jax.eval_shape`, the port's `Model` on `meta`) under the param rules,
and for every cache tensor of the two decode shapes under the
activation rules, on three device-free meshes: one pod
(`AbstractMesh((16, 16), ("data", "model"))`), two pods
(`AbstractMesh((2, 16, 16), ("pod", "data", "model"))`) and the 1x1
host mesh.  The reference's tuples carry a leading `"layers"` axis
(stacked leaves) that maps to no mesh axis; the port keeps one module a
layer, so its spec is the reference's with that first `None` dropped.
Named cases cover the three ways a rule falls back (an axis already
used, a dimension that does not divide, a mesh axis that is absent),
and a property holds every spec to its shape: each placed dimension
divides and each mesh axis is used at most once.  Exact equality: the
rules are pure structure.
"""
import functools

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as REF_ARCHS
from repro.launch.specs import _abstract_caches as ref_abstract_caches
from repro.launch.specs import _abstract_model as ref_abstract_model
from repro.launch.specs import config_for as ref_config_for
from repro.models import cache_axes as ref_cache_axes
from repro.models.common import is_axes_leaf as ref_is_axes_leaf
from repro.sharding.rules import DEFAULT_ACT_RULES as REF_ACT_RULES
from repro.sharding.rules import DEFAULT_PARAM_RULES as REF_PARAM_RULES
from repro.sharding.rules import spec_for as ref_spec_for
from repro_torch.bridge import reference_path
from repro_torch.config import SHAPES
from repro_torch.configs import ARCHS, get
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.specs import config_for
from repro_torch.models import cache_axes, init_caches, param_axes
from repro_torch.models.model import Model
from repro_torch.sharding import (
    DEFAULT_ACT_RULES,
    DEFAULT_PARAM_RULES,
    Mesh,
    NamedSharding,
    constrain,
    logical_to_sharding,
    spec_for,
)

MESHES = {
    "pod": (AbstractMesh((16, 16), ("data", "model")),
            make_production_mesh(multi_pod=False)),
    "multipod": (AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                 make_production_mesh(multi_pod=True)),
    "host": (AbstractMesh((1, 1), ("data", "model")), make_host_mesh()),
}
DECODE_SHAPES = [s for s in SHAPES if SHAPES[s].kind == "decode"]


def flatten(tree, prefix=""):
    """A reference tree (dicts and NamedTuples) -> {path: leaf}, an
    axes tuple counting as a leaf."""
    if ref_is_axes_leaf(tree) or not isinstance(tree, (dict, tuple)):
        return {prefix: tree}
    items = (tree.items() if isinstance(tree, dict)
             else zip(tree._fields, tree))
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@functools.lru_cache(maxsize=None)
def ref_model(arch):
    """{path: (shape, axes)} of the reference's tree at published width."""
    sds, axes = ref_abstract_model(ref_config_for(arch, "train_4k"))
    sds, axes = flatten(sds), flatten(axes)
    assert set(sds) == set(axes)
    return {p: (tuple(sds[p].shape), axes[p]) for p in sds}


@functools.lru_cache(maxsize=None)
def port_model(arch):
    """{name: (shape, axes)} of the port's model on `meta`."""
    model = Model(get(arch), device="meta")
    axes = param_axes(model)
    return {n: (tuple(p.shape), axes[n])
            for n, p in model.named_parameters()}


def ref_spec(axes, shape, mesh, rules):
    return tuple(ref_spec_for(axes, shape, mesh, rules))


def test_reference_archs_are_the_ports():
    assert list(REF_ARCHS) == list(ARCHS)


def test_meshes_are_the_references():
    for ref, port in MESHES.values():
        assert dict(ref.shape) == port.shape
        assert tuple(ref.axis_names) == port.axis_names
    assert make_production_mesh(multi_pod=False).size == 256
    assert make_production_mesh(multi_pod=True).size == 512


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_references(arch, mesh_kind):
    ref_mesh, mesh = MESHES[mesh_kind]
    ref = ref_model(arch)
    port = port_model(arch)
    want = {}
    n_sharded = 0
    for name, (shape, axes) in port.items():
        path, layer = reference_path(name)
        ref_shape, ref_axes = ref[path]
        if path not in want:
            want[path] = ref_spec(ref_axes, ref_shape, ref_mesh,
                                  REF_PARAM_RULES)
        expect = want[path]
        if layer is not None:   # the stacked leaf's `layers` axis
            assert ref_axes[0] == "layers" and expect[0] is None
            expect = expect[1:]
        got = spec_for(axes, shape, mesh, DEFAULT_PARAM_RULES)
        assert got == expect, (name, axes, shape)
        n_sharded += any(e is not None for e in got)
    assert set(want) == set(ref)   # every reference leaf was compared
    if mesh_kind != "host":
        assert n_sharded > 0


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("shape_name", DECODE_SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_references(arch, shape_name, mesh_kind):
    ref_mesh, mesh = MESHES[mesh_kind]
    sh = SHAPES[shape_name]
    ref_cfg = ref_config_for(arch, shape_name)
    ref_sds = flatten(ref_abstract_caches(ref_cfg, sh.global_batch,
                                          sh.seq_len))
    ref_axes = flatten(ref_cache_axes(ref_cfg))
    assert set(ref_sds) == set(ref_axes)
    cfg = config_for(arch, shape_name)
    caches = init_caches(cfg, sh.global_batch, sh.seq_len, device="meta")
    placed = logical_to_sharding(cache_axes(cfg), caches, mesh,
                                 DEFAULT_ACT_RULES)
    seen = set()
    for layer, (cache, shs) in enumerate(zip(caches, placed)):
        for part in ("kv", "ssm"):
            if getattr(cache, part) is None:
                continue
            for field, t, s in zip(getattr(cache, part)._fields,
                                   getattr(cache, part), getattr(shs, part)):
                path = f"{part}/{field}"
                seen.add(path)
                ref_shape = tuple(ref_sds[path].shape)
                assert ref_shape == (cfg.n_layers, *t.shape), path
                want = ref_spec(ref_axes[path], ref_shape, ref_mesh,
                                REF_ACT_RULES)
                assert want[0] is None
                assert isinstance(s, NamedSharding) and s.mesh == mesh
                assert s.spec == want[1:], (layer, path)
    assert seen == set(ref_sds)


# --- the three fallbacks, by name -----------------------------------------

def test_kv_heads_lose_model_to_cache_seq():
    """Every KV cache's `kv_heads` divides by 16 here, yet goes
    unsharded: `cache_seq` took `model` first."""
    cfg = get("stablelm-1.6b")
    assert cfg.n_kv % 16 == 0
    caches = init_caches(cfg, 128, 32768, device="meta")
    for kind, want in (("pod", ("data", "model", None, None)),
                       ("multipod", ("data", "model", None, None))):
        mesh = MESHES[kind][1]
        placed = logical_to_sharding(cache_axes(cfg), caches, mesh,
                                     DEFAULT_ACT_RULES)
        assert placed[0].kv.k.spec == want
        assert placed[0].kv.k.shard_shape((128, 32768, 32, 64)) == (
            128 // 16, 32768 // 16, 32, 64)
        ref = ref_spec(("layers", "cache_batch", "cache_seq", "kv_heads",
                        None), (24, 128, 32768, 32, 64), MESHES[kind][0],
                       REF_ACT_RULES)
        assert ref == (None, *want)


def test_expert_mlp_loses_model_to_experts():
    """Arctic's and Phi-3.5-MoE's expert stacks: `experts` takes `model`,
    so `mlp` is left unsharded; the dense residual's `mlp` keeps it."""
    mesh = MESHES["pod"][1]
    for arch in ("arctic-480b", "phi3.5-moe-42b-a6.6b"):
        axes = port_model(arch)
        shape, ax = axes["blocks.0.moe.wi"]
        assert ax == ("experts", "embed", "mlp")
        assert shape[2] % 16 == 0
        assert spec_for(ax, shape, mesh) == ("model", "data", None)
    shape, ax = port_model("arctic-480b")["blocks.0.moe.residual.wi.w"]
    assert spec_for(ax, shape, mesh) == ("data", "model")


def test_indivisible_dim_replicates():
    """Hymba's fused SSM input projection is 6,482 wide: not a multiple
    of 16, so `ssm_inner` is dropped; its out_proj (3,200) keeps it.
    InternVL2's 14 heads x 64 = 896 divide, its 2 KV heads x 64 = 128
    too."""
    mesh = MESHES["pod"][1]
    shape, ax = port_model("hymba-1.5b")["blocks.0.ssm.in_proj.w"]
    assert shape == (1600, 6482) and 6482 % 16
    assert spec_for(ax, shape, mesh) == ("data", None)
    shape, ax = port_model("hymba-1.5b")["blocks.0.ssm.out_proj.w"]
    assert spec_for(ax, shape, mesh) == ("model", "data")
    assert spec_for(("embed", "heads"), (896, 14), mesh) == ("data", None)


def test_absent_mesh_axis_is_dropped():
    """`embed` maps to (pod, data): one pod has no `pod`, so only `data`
    is left (as a name, as PartitionSpec gives it); two pods keep both."""
    shape, ax = port_model("stablelm-1.6b")["blocks.0.attn.q.w"]
    assert spec_for(ax, shape, MESHES["pod"][1]) == ("data", "model")
    assert spec_for(ax, shape, MESHES["multipod"][1]) == (
        ("pod", "data"), "model")
    assert spec_for(ax, shape, MESHES["host"][1]) == ("data", "model")
    assert spec_for(("batch",), (8,), Mesh((4,), ("model",)),
                    DEFAULT_ACT_RULES) == (None,)


def test_constrain_is_the_identity():
    x = object()
    assert constrain(x, "batch", "seq", "embed") is x


def test_shard_shape_divides_by_the_spec():
    """Every rank holds a slice of one shape: each placed dim over the
    product of its mesh axes; a dim that does not divide raises."""
    mesh = Mesh((2, 4, 2), ("pod", "data", "model"))
    sh = NamedSharding(mesh, (("pod", "data"), "model", None))
    for rank in (0, mesh.size - 1):
        assert sh.local_shape((16, 6, 3), rank) == (2, 3, 3)
    with pytest.raises(ValueError):
        sh.local_shape((16, 6, 3), mesh.size)
    with pytest.raises(ValueError):
        sh.shard_shape((12, 6, 3))
    assert NamedSharding(mesh, ()).shard_shape((5, 7)) == (5, 7)


# --- property: every spec fits its shape ----------------------------------

NAMES = sorted(set(DEFAULT_PARAM_RULES) | set(DEFAULT_ACT_RULES)) + [None]
DIMS = [1, 2, 3, 6, 14, 16, 32, 48, 100, 128, 6482]


@settings(max_examples=300, deadline=None)
@given(st.lists(st.sampled_from(NAMES), min_size=1, max_size=5),
       st.lists(st.sampled_from(DIMS), min_size=5, max_size=5),
       st.sampled_from(list(MESHES)), st.booleans())
def test_specs_divide_and_use_each_axis_once(names, dims, mesh_kind, act):
    ref_mesh, mesh = MESHES[mesh_kind]
    shape = tuple(dims[:len(names)])
    rules = DEFAULT_ACT_RULES if act else DEFAULT_PARAM_RULES
    spec = spec_for(tuple(names), shape, mesh, rules)
    assert len(spec) == len(shape)
    used = []
    for dim, entry in zip(shape, spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        assert dim % size == 0
        used += axes
    assert len(used) == len(set(used))
    assert spec == ref_spec(tuple(names), shape, ref_mesh,
                            REF_ACT_RULES if act else REF_PARAM_RULES)


# --- the specs' helpers ----------------------------------------------------

ACT_CASES = [("batch", "seq", "embed"), ("cache_batch", "cache_seq"),
             ("batch", "heads", None), ("vocab",), ()]


@pytest.mark.parametrize("mesh_kind", ["pod", "multipod"])
def test_act_and_batch_placements_equal_the_references(mesh_kind):
    from repro.launch.specs import _act as ref_act
    from repro.launch.specs import _batch_sharding as ref_batch_sharding
    from repro_torch.launch.specs import _act, _batch_sharding

    ref_mesh, mesh = MESHES[mesh_kind]
    for names in ACT_CASES:
        assert _act(mesh, *names).spec == tuple(
            ref_act(ref_mesh, *names).spec), names
    for batch in (1, 16, 32, 128, 256, 7):
        assert _batch_sharding(mesh, batch).spec == tuple(
            ref_batch_sharding(ref_mesh, batch).spec), batch
