"""The port's dry run against the JAX reference, on the CPU.

* `param_axes` (every parameter's logical axes, by `named_parameters`
  name) equals the reference's axes tree leaf by leaf (its path from
  `repro_torch.bridge.reference_path`, a stacked leaf's `"layers"`
  axis dropped), for all ten architectures at published width and at
  their smoke sizes; `cache_axes` equals the reference's per layer.
* `SHAPES`, `config_for` (the long_500k window and its
  `variant_note`), `param_count` and `active_param_count` equal the
  reference's.
* `argument_bytes_per_device` of `run_one` equals, exactly, the bytes
  of one device's slice of the state under the reference's own rules
  (`repro.launch.specs`' `_abstract_model` / `_abstract_caches`, its
  `logical_to_sharding` on an `AbstractMesh`, `NamedSharding.
  shard_shape`): the parameters in bf16, for train_4k also the float32
  master weights and both moments of `repro.training.adamw.init`, for
  the decode shapes also the caches under the activation rules; the
  token batch and the step counter are left out on both sides.  All 80
  (arch x shape x mesh) combos.
* `FlopCounterMode` counts the same FLOPs for a step run on `meta` as
  for the same step on real CPU tensors (train, prefill and decode, on
  three smoke families), which is what the dry run's `flops` rests on.
* `run_one` writes an `ok` record for a smoke config on each shape;
  `materialize_shard(..., device="cpu")` allocates each state tensor's
  predicted local shape and dtype.
"""
import dataclasses
import functools
import json
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.utils.flop_counter import FlopCounterMode

from repro.config import SHAPES as REF_SHAPES
from repro.configs import get as ref_get
from repro.configs import get_smoke as ref_get_smoke
from repro.launch.specs import _abstract_caches as ref_abstract_caches
from repro.launch.specs import _abstract_model as ref_abstract_model
from repro.launch.specs import config_for as ref_config_for
from repro.models import cache_axes as ref_cache_axes
from repro.sharding.rules import DEFAULT_ACT_RULES as REF_ACT_RULES
from repro.sharding.rules import logical_to_sharding as ref_to_sharding
from repro.training import adamw as ref_adamw
from repro_torch.bridge import reference_path
from repro_torch.config import SHAPES, TrainConfig
from repro_torch.configs import ARCHS, get, get_smoke
from repro_torch.launch.dryrun import run_one
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (
    build_spec,
    config_for,
    materialize_shard,
    shard_alloc_nbytes,
    shard_nbytes,
    state_leaves,
)
from repro_torch.models import cache_axes, init_model, param_axes
from repro_torch.models.model import Model, init_caches
from repro_torch.serving.engine import prefill_step, serve_step
from repro_torch.training import init_train_state
from repro_torch.training.train_step import train_step
from test_torch_sharding import flatten

torch.set_num_threads(2)

REF_MESHES = {"pod": AbstractMesh((16, 16), ("data", "model")),
              "multipod": AbstractMesh((2, 16, 16),
                                       ("pod", "data", "model"))}


# --- axes, shapes, configs -------------------------------------------------

@functools.lru_cache(maxsize=None)
def ref_tree(arch, smoke):
    cfg = ref_get_smoke(arch) if smoke else ref_get(arch)
    sds, axes = ref_abstract_model(cfg)
    return flatten(sds), flatten(axes)


@pytest.mark.parametrize("smoke", [False, True], ids=["published", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_the_references(arch, smoke):
    cfg = get_smoke(arch) if smoke else get(arch)
    sds, ref_axes = ref_tree(arch, smoke)
    model = Model(cfg, device="meta")
    axes = param_axes(model)
    assert list(axes) == [n for n, _ in model.named_parameters()]
    assert param_axes(cfg) == axes
    seen = set()
    for name, p in model.named_parameters():
        path, layer = reference_path(name)
        want = ref_axes[path]
        if layer is not None:
            assert want[0] == "layers"
            want = want[1:]
            assert tuple(sds[path].shape[1:]) == tuple(p.shape)
        assert axes[name] == want, name
        assert len(want) == p.dim()
        seen.add(path)
    assert seen == set(ref_axes)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_equal_the_references(arch):
    cfg = get(arch)
    ref = flatten(ref_cache_axes(ref_get(arch)))
    layers = cache_axes(cfg)
    assert len(layers) == cfg.n_layers
    for layer in layers:
        got = {}
        for part in ("kv", "ssm"):
            sub = getattr(layer, part)
            if sub is not None:
                got.update({f"{part}/{f}": ("layers", *a)
                            for f, a in zip(sub._fields, sub)})
        assert got == ref


def test_shapes_equal_the_references():
    assert list(SHAPES) == list(REF_SHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            REF_SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_counts_equal_the_references(arch):
    for shape in SHAPES:
        cfg, ref = config_for(arch, shape), ref_config_for(arch, shape)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref), shape
        assert cfg.attention_free == ref.attention_free
    long = config_for(arch, "long_500k")
    if long.arch_type in ("ssm", "hybrid"):
        assert long == get(arch)
    else:
        assert long.sliding_window == 8192
        assert long.variant_note.startswith("sliding-window(8192)")
    for port, ref in ((get(arch), ref_get(arch)),
                      (get_smoke(arch), ref_get_smoke(arch))):
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        assert port.active_param_count() <= port.param_count()


# --- bytes a device --------------------------------------------------------

def _shard_bytes(sds_tree, sh_tree):
    per = jax.tree.map(
        lambda s, sh: math.prod(sh.shard_shape(s.shape)) * s.dtype.itemsize,
        sds_tree, sh_tree)
    return sum(jax.tree.leaves(per))


@functools.lru_cache(maxsize=None)
def _ref_model(cfg):
    return ref_abstract_model(cfg)


def reference_rule_bytes(arch, shape_name, mesh_kind):
    """One device's bytes of the state under the reference's rules."""
    mesh = REF_MESHES[mesh_kind]
    shape = REF_SHAPES[shape_name]
    cfg = ref_config_for(arch, shape_name)
    sds, axes = _ref_model(cfg)
    params_sh = ref_to_sharding(axes, sds, mesh)
    total = _shard_bytes(sds, params_sh)
    if shape.kind == "train":
        opt = jax.eval_shape(ref_adamw.init, sds)
        for part in (opt.master, opt.m, opt.v):
            total += _shard_bytes(part, params_sh)
    if shape.kind == "decode":
        caches = ref_abstract_caches(cfg, shape.global_batch, shape.seq_len)
        cache_sh = ref_to_sharding(ref_cache_axes(cfg), caches, mesh,
                                   REF_ACT_RULES)
        total += _shard_bytes(caches, cache_sh)
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_the_reference_rules(arch):
    for mesh_kind in REF_MESHES:
        for shape_name in SHAPES:
            rec = run_one(arch, shape_name, mesh_kind, save=False,
                          flops=False)
            assert rec["ok"], rec.get("error")
            want = reference_rule_bytes(arch, shape_name, mesh_kind)
            assert rec["argument_bytes_per_device"] == want, (
                shape_name, mesh_kind)
            assert rec["fits_hbm"]
            blocks = rec["argument_bytes_allocated"] - want
            assert 0 <= blocks < 512 * rec["n_state_tensors"]
    if arch == "arctic-480b":
        rec = run_one(arch, "train_4k", "pod", save=False, flops=False)
        assert round(rec["argument_bytes_per_device"] / 1e9, 2) == 26.08


# --- FLOPs: meta against real tensors --------------------------------------

FLOP_ARCHS = ["stablelm-1.6b", "phi3.5-moe-42b-a6.6b", "hymba-1.5b"]
FLOP_B, FLOP_S = 2, 24


def _flops(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops(), counter.get_flop_counts()["Global"]


def _step(kind, cfg, device):
    """A closure running one `kind` step of `cfg` on `device`, its model
    built there (`init_model` on the CPU, uninitialised on meta)."""
    model = (init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
             if device == "cpu" else Model(cfg, device=device))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (FLOP_B, FLOP_S + 1), generator=gen,
                         dtype=torch.int32).to(device)
    if kind == "train":
        tc = TrainConfig(remat=True)
        state = init_train_state(model, tc, device=device)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        return lambda: train_step(state, batch, tc)
    if kind == "prefill":
        return lambda: prefill_step(model, toks[:, :-1], 64, impl="plain")
    caches = init_caches(cfg, FLOP_B, 64, device=device)
    return lambda: serve_step(model, toks[:, :1], FLOP_S, caches,
                              impl="plain")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_meta_flops_equal_real_flops(arch, kind):
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    meta_total, meta_ops = _flops(_step(kind, cfg, "meta"))
    real_total, real_ops = _flops(_step(kind, cfg, "cpu"))
    assert meta_total > 0
    assert meta_total == real_total
    assert dict(meta_ops) == dict(real_ops)


# --- records and materialisation -------------------------------------------

@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_run_one_writes_ok_records(shape_name, tmp_path):
    for arch in ("stablelm-1.6b", "hymba-1.5b"):
        cfg = get_smoke(arch)
        if shape_name == "long_500k" and cfg.arch_type not in ("ssm",
                                                               "hybrid"):
            cfg = cfg.with_sliding_window(64)
        rec = run_one(arch, shape_name, "multipod", cfg_override=cfg,
                      out_dir=str(tmp_path))
        assert rec["ok"], rec.get("traceback")
        assert rec["flops"] > 0 and rec["n_devices"] == 512
        assert rec["variant"] == cfg.variant_note
        with open(tmp_path / f"{arch}__{shape_name}__multipod.json") as f:
            assert json.load(f) == rec
    assert not any(k in rec for k in ("temp_size_in_bytes", "collectives"))


def test_run_one_records_a_failure(tmp_path):
    cfg = dataclasses.replace(get_smoke("stablelm-1.6b"), arch_type="bogus")
    rec = run_one("stablelm-1.6b", "train_4k", "pod", cfg_override=cfg,
                  out_dir=str(tmp_path))
    assert not rec["ok"] and "bogus" in rec["error"]


@pytest.mark.parametrize("arch,shape_name,mesh_kind,smoke", [
    ("stablelm-1.6b", "train_4k", "multipod", False),
    ("hymba-1.5b", "decode_32k", "pod", True),
    ("phi3.5-moe-42b-a6.6b", "long_500k", "pod", True),
    ("musicgen-large", "prefill_32k", "multipod", True),
])
def test_materialize_shard_allocates_the_predicted_shapes(
        arch, shape_name, mesh_kind, smoke):
    cfg = get_smoke(arch) if smoke else None
    if cfg is not None and shape_name == "long_500k":
        cfg = cfg.with_sliding_window(64)
    mesh = make_production_mesh(multi_pod=mesh_kind == "multipod")
    spec = build_spec(arch, shape_name, mesh, cfg_override=cfg)
    shard = materialize_shard(spec, device="cpu")
    leaves = list(state_leaves(spec))
    assert list(shard.tensors) == [n for n, _, _ in leaves]
    for name, t, sh in leaves:
        got = shard.tensors[name]
        assert got.device.type == "cpu" and got.dtype == t.dtype
        assert tuple(got.shape) == sh.local_shape(t.shape, 0)
        assert tuple(got.shape) == sh.shard_shape(t.shape)
    assert shard.allocated == shard_nbytes(spec)
    rounded = sum(-(-x.nbytes // 512) * 512 for x in shard.tensors.values())
    assert shard_alloc_nbytes(spec) == rounded
    names = [n for n, _, _ in leaves]
    if spec.kind == "train":
        assert sum(n.startswith("opt.master.") for n in names) == len(
            list(spec.args[0].model.parameters()))
    if spec.kind == "decode":
        assert any(n.startswith("caches.") for n in names)
    assert np.all([x.is_contiguous() for x in shard.tensors.values()])
