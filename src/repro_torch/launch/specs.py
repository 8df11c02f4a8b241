"""Input specs and placements of the dry run.

Counterpart of `repro.launch.specs`.  For each (arch, shape) it builds

  * the step to run (`train_step` / `prefill_step` / `serve_step`, the
    plain path, as the reference lowers its XLA path),
  * its arguments on the `meta` device (every shape and dtype, nothing
    allocated: the counterpart of the reference's `ShapeDtypeStruct`s),
  * their placements on a mesh, from the logical-axis rules.

The parameters (and, for a train step, the float32 master weights and
both AdamW moments) take the param rules; the decode caches take the
activation rules, where `cache_batch` and `cache_seq` live (with the
param rules a KV cache would be replicated whole on every device).
The token inputs are split over the batch axes when the batch divides
by them.  `shard_nbytes` sums one rank's local slices of the state,
`materialize_shard` allocates them on a device, and `sharded_args`
gives the step's arguments as DTensors on a live mesh (the dry run's
sharded step).

long_500k policy: native for ssm/hybrid; every full-attention arch runs
as its sliding-window(8192) VARIANT, recorded in `cfg.variant_note`.
"""
from __future__ import annotations

import copy
import math
from typing import Any, Iterator, NamedTuple

import torch

from repro_torch.config import SHAPES, ModelConfig, TrainConfig
from repro_torch.configs import get
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.common import dtype_of
from repro_torch.models.model import Model, cache_axes, init_caches, param_axes
from repro_torch.serving.engine import prefill_step, serve_step
from repro_torch.sharding.dist import (
    ALLOC_BLOCK,
    distribute,
    distribute_module,
)
from repro_torch.sharding.rules import (
    DEFAULT_ACT_RULES,
    Mesh,
    NamedSharding,
    logical_to_sharding,
)
from repro_torch.training.train_step import (
    TrainState,
    init_train_state,
    train_step,
)

LONG_WINDOW = 8192
META = torch.device("meta")


class LoweringSpec(NamedTuple):
    fn: Any               # the step: fn(*args) runs it
    args: tuple           # its arguments, tensors on `meta`
    in_shardings: tuple   # their placements, in the same structure
    cfg: ModelConfig
    note: str
    kind: str             # train | prefill | decode


def config_for(arch: str, shape_name: str) -> ModelConfig:
    cfg = get(arch)
    if shape_name == "long_500k" and cfg.arch_type not in ("ssm", "hybrid"):
        cfg = cfg.with_sliding_window(LONG_WINDOW)
    return cfg


def _abstract_model(cfg: ModelConfig):
    """(the model on `meta`, {parameter name: logical axes})."""
    model = Model(cfg, device=META)
    return model, param_axes(model)


def _abstract_caches(cfg: ModelConfig, batch: int, max_seq: int):
    return init_caches(cfg, batch, max_seq, device=META)


def _params_shardings(axes, model: Model, mesh: Mesh):
    return logical_to_sharding(axes, dict(model.named_parameters()), mesh)


def _act(mesh: Mesh, *logical) -> NamedSharding:
    """A placement by activation-axis names alone (no divisibility
    check: the caller's shapes divide by construction)."""
    spec = []
    for name in logical:
        rule = DEFAULT_ACT_RULES.get(name or "none")
        if rule is None:
            spec.append(None)
        elif isinstance(rule, str):
            spec.append(rule if rule in mesh.axis_names else None)
        else:
            present = tuple(a for a in rule if a in mesh.axis_names)
            spec.append((present[0] if len(present) == 1 else present)
                        if present else None)
    return NamedSharding(mesh, tuple(spec))


def _batch_sharding(mesh: Mesh, batch: int) -> NamedSharding:
    """Shard batch over (pod, data) when divisible, else replicate."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    size = math.prod(mesh.shape[a] for a in axes)
    if batch % size != 0:
        return NamedSharding(mesh, (None,))
    return NamedSharding(mesh, (axes[0] if len(axes) == 1 else axes,))


def _cache_shardings(cfg: ModelConfig, caches, mesh: Mesh):
    # ACT rules, not param rules: cache_batch/cache_seq only exist there
    return logical_to_sharding(cache_axes(cfg), caches, mesh,
                               DEFAULT_ACT_RULES)


def build_spec(arch: str, shape_name: str, mesh: Mesh,
               microbatches: int = 1,
               cfg_override: ModelConfig | None = None) -> LoweringSpec:
    shape = SHAPES[shape_name]
    cfg = cfg_override if cfg_override is not None else config_for(
        arch, shape_name)
    dtype = dtype_of(cfg.dtype)
    model, axes = _abstract_model(cfg)
    params_sh = _params_shardings(axes, model, mesh)
    B, S = shape.global_batch, shape.seq_len
    tok_sh = _batch_sharding(mesh, B)
    repl = NamedSharding(mesh, ())

    # VLM/audio: the assigned seq_len covers prefix embeddings + text, so
    # the text stream is S - prefix_len tokens (total context = S exactly)
    prefix = None
    S_txt = S
    if cfg.prefix_len:
        S_txt = S - cfg.prefix_len
        prefix = torch.empty((B, cfg.prefix_len, cfg.d_model), dtype=dtype,
                             device=META)

    if shape.kind == "train":
        tc = TrainConfig(microbatches=microbatches)
        state = init_train_state(model, tc, device=META)
        opt_sh = type(state.opt)(step=repl, master=params_sh, m=params_sh,
                                 v=params_sh)
        batch = {"tokens": torch.empty((B, S_txt), dtype=torch.int32,
                                       device=META),
                 "labels": torch.empty((B, S_txt), dtype=torch.int32,
                                       device=META)}
        batch_sh = {"tokens": tok_sh, "labels": tok_sh}
        if prefix is not None:
            batch["prefix_embeds"] = prefix
            batch_sh["prefix_embeds"] = tok_sh

        def fn(state, batch):
            return train_step(state, batch, tc)

        return LoweringSpec(fn, (state, batch),
                            (TrainState(params_sh, opt_sh), batch_sh),
                            cfg, cfg.variant_note, shape.kind)

    if shape.kind == "prefill":
        tokens = torch.empty((B, S_txt), dtype=torch.int32, device=META)

        def fn(model, tokens, prefix_embeds=None):
            return prefill_step(model, tokens, max_seq=S,
                                prefix_embeds=prefix_embeds, impl="plain")

        args = (model, tokens) + ((prefix,) if prefix is not None else ())
        shs = (params_sh, tok_sh) + ((tok_sh,) if prefix is not None else ())
        return LoweringSpec(fn, args, shs, cfg, cfg.variant_note, shape.kind)

    # decode: ONE new token, at the last position of a cache of seq_len
    caches = _abstract_caches(cfg, B, S)
    cache_sh = _cache_shardings(cfg, caches, mesh)
    token = torch.empty((B, 1), dtype=torch.int32, device=META)

    def fn(model, token, pos, caches):
        return serve_step(model, token, pos, caches, impl="plain")

    return LoweringSpec(fn, (model, token, S - 1, caches),
                        (params_sh, tok_sh, repl, cache_sh),
                        cfg, cfg.variant_note, shape.kind)


def state_leaves(spec: LoweringSpec
                 ) -> Iterator[tuple[str, torch.Tensor, NamedSharding]]:
    """(name, meta tensor, placement) of every tensor of the step's
    state: the parameters, for a train step the AdamW master weights
    and moments, for a decode step the caches.  The token inputs (a few
    kB to MB a rank) and the step counter are not state and are left
    out."""
    first, first_sh = spec.args[0], spec.in_shardings[0]
    model, params_sh = ((first.model, first_sh.model)
                        if spec.kind == "train" else (first, first_sh))
    for name, p in model.named_parameters():
        yield name, p, params_sh[name]
    if spec.kind == "train":
        for part in ("master", "m", "v"):
            tensors, shs = getattr(first.opt, part), getattr(first_sh.opt, part)
            for name, t in tensors.items():
                yield f"opt.{part}.{name}", t, shs[name]
    if spec.kind == "decode":
        caches, caches_sh = spec.args[3], spec.in_shardings[3]
        for i, (layer, layer_sh) in enumerate(zip(caches, caches_sh)):
            for part in ("kv", "ssm"):
                sub, sub_sh = getattr(layer, part), getattr(layer_sh, part)
                if sub is None:
                    continue
                for field, t, sh in zip(sub._fields, sub, sub_sh):
                    yield f"caches.{i}.{part}.{field}", t, sh


def sharded_args(spec: LoweringSpec, dmesh, device=None) -> tuple:
    """The step's arguments as DTensors on `dmesh`, each built from
    this rank's local slice of its placement (`repro_torch.sharding.
    dist.distribute`): new tensors on `device` (the mesh's by default;
    `meta` allocates nothing).  The spec's own arguments are left as
    they are."""
    args = copy.deepcopy(spec.args)
    out = []
    for a, sh in zip(args, spec.in_shardings):
        if isinstance(a, Model):
            a = distribute_module(a, sh, dmesh, device)
        elif isinstance(a, TrainState):
            a = TrainState(distribute_module(a.model, sh.model, dmesh, device),
                           distribute(a.opt, sh.opt, dmesh, device))
        else:
            a = distribute(a, sh, dmesh, device)
        out.append(a)
    return tuple(out)


def _nbytes(shape, dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def shard_nbytes(spec: LoweringSpec, rank: int = 0) -> int:
    """Bytes of `rank`'s local slice of the step's state (every rank's
    are equal: every placed dimension divides)."""
    return sum(_nbytes(sh.local_shape(t.shape, rank), t.dtype)
               for _, t, sh in state_leaves(spec))


def shard_alloc_nbytes(spec: LoweringSpec, rank: int = 0) -> int:
    """`shard_nbytes` with each tensor rounded up to the allocator's
    block: what `materialize_shard` should add to the card's
    `memory_allocated()`."""
    return sum(-(-_nbytes(sh.local_shape(t.shape, rank), t.dtype)
                 // ALLOC_BLOCK) * ALLOC_BLOCK
               for _, t, sh in state_leaves(spec))


class Shard(NamedTuple):
    tensors: dict          # state name -> the local slice, uninitialised
    allocated: int         # bytes the device's allocator added for them


def materialize_shard(spec: LoweringSpec, rank: int = 0,
                      device=DEFAULT_DEVICE) -> Shard:
    """Allocate `rank`'s local slices of the step's state on `device`
    (CUDA unless the caller names another), each in its dtype.  On the
    card `allocated` is the growth of `torch.cuda.memory_allocated()`;
    elsewhere the tensors' storage bytes.  Drop the result to free
    them."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    before = torch.cuda.memory_allocated(dev) if cuda else 0
    tensors = {name: torch.empty(sh.local_shape(t.shape, rank),
                                 dtype=t.dtype, device=dev)
               for name, t, sh in state_leaves(spec)}
    if cuda:
        allocated = torch.cuda.memory_allocated(dev) - before
    else:
        allocated = sum(x.untyped_storage().nbytes() for x in tensors.values())
    return Shard(tensors, allocated)
