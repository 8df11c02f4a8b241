"""Logical-axis -> mesh-axis sharding rules (MaxText-style).

Counterpart of `repro.sharding.rules`, with the same two rule tables
and the same `spec_for`.  Every parameter carries a tuple of *logical*
axis names (`repro_torch.models.model.param_axes`; the caches'
`cache_axes`), and `spec_for` maps them onto the axes of a mesh,
dropping a rule where it cannot hold:

  * the rule names a mesh axis the mesh lacks (`pod` on one pod);
  * a mesh axis is already used by an earlier dimension of the same
    tensor (a mesh axis appears at most once in a spec: a KV cache's
    `kv_heads` loses `model` to `cache_seq`, an expert stack's `mlp`
    loses it to `experts`);
  * the dimension does not divide by the axis size (Hymba's fused SSM
    input projection, 6,482 wide, on a 16-way `model` axis).

The mesh is a device-free description (`Mesh`: axis names and sizes,
the counterpart of `jax.sharding.AbstractMesh`), and a placement
(`NamedSharding`) is a mesh and a spec, a tuple of `None`, an axis name
or a tuple of axis names per dimension, which compares equal to
`tuple(jax.sharding.PartitionSpec(...))`.  Nothing here creates a
`torch.distributed` process group or touches a device: the placements
say which slice of each tensor a rank of a production mesh would hold
(`NamedSharding.local_shape`), which is what `repro_torch.launch.specs`
sums and materialises; `repro_torch.sharding.dist` lays them over a
live process group as DTensors.

Param logical axes:
  embed                   d_model on params      -> FSDP axes (pod, data)
  vocab / heads / kv_heads / q_heads / mlp / experts / ssm_inner
                          parallel dims          -> tensor axis (model)
  layers / none           never sharded (the port keeps one module a
                          layer, so its tuples have no `layers` entry)

Activation logical axes:
  batch -> (pod, data)    seq -> None (train/prefill)
  cache_batch -> data     cache_seq -> model (decode)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Sequence

from torch.distributed.tensor import DTensor

# logical axis -> mesh axes (tuple = joint sharding over several mesh axes)
DEFAULT_PARAM_RULES: dict[str, Any] = {
    "layers": None,
    "embed": ("pod", "data"),       # FSDP / ZeRO-3 over the data axes
    "vocab": "model",
    "heads": "model",
    "q_heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "ssm_inner": "model",
    "none": None,
}

DEFAULT_ACT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "cache_batch": "data",
    "cache_seq": "model",
    "none": None,
}

Spec = tuple  # of None | str | tuple[str, ...], one entry a dimension


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device-free mesh: axis sizes and names."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh: {self.axis_sizes} sizes for "
                             f"{self.axis_names} names")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def _flat(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's placement on a mesh: the counterpart of
    `jax.sharding.NamedSharding`."""
    mesh: Mesh
    spec: Spec

    def _parts(self, i: int) -> int:
        entry = self.spec[i] if i < len(self.spec) else None
        return math.prod(self.mesh.shape[a] for a in _flat(entry))

    def shard_shape(self, global_shape: Sequence[int]) -> tuple[int, ...]:
        """The shape of one rank's slice (every placed dim divides)."""
        out = []
        for i, dim in enumerate(global_shape):
            n = self._parts(i)
            if dim % n:
                raise ValueError(f"dim {i} of {tuple(global_shape)} does not "
                                 f"divide by {n} ({self.spec[i]})")
            out.append(dim // n)
        return tuple(out)

    def local_shape(self, global_shape: Sequence[int], rank: int = 0
                    ) -> tuple[int, ...]:
        """The shape of `rank`'s slice: `shard_shape` for every rank,
        since every placed dimension divides."""
        if not 0 <= rank < self.mesh.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.mesh.size}")
        return self.shard_shape(global_shape)


def _mesh_axes_present(mesh: Mesh, axes) -> Optional[Any]:
    """Restrict a rule to axes that exist in this mesh."""
    if axes is None:
        return None
    if isinstance(axes, str):
        return axes if axes in mesh.axis_names else None
    present = tuple(a for a in axes if a in mesh.axis_names)
    return present if present else None


def _axis_size(mesh: Mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in _flat(axes))


def spec_for(
    logical_axes: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh: Mesh,
    rules: Mapping[str, Any] | None = None,
) -> Spec:
    """The spec of one tensor, dropping rules that cannot hold."""
    rules = rules or DEFAULT_PARAM_RULES
    spec = []
    used: set[str] = set()
    for dim, name in zip(shape, logical_axes):
        axes = _mesh_axes_present(mesh, rules.get(name or "none"))
        if axes is not None and any(a in used for a in _flat(axes)):
            axes = None  # a mesh axis may appear once per spec
        if axes is not None and dim % _axis_size(mesh, axes) != 0:
            axes = None  # non-divisible: replicate instead (adaptation)
        used.update(_flat(axes))
        if isinstance(axes, tuple) and len(axes) == 1:
            axes = axes[0]   # as PartitionSpec normalises a 1-tuple
        spec.append(axes)
    return tuple(spec)


def constrain(x, *logical):
    """Pin an activation's placement by logical activation-axis names:
    the reference's `with_sharding_constraint`.  A DTensor is
    redistributed to the placements `DEFAULT_ACT_RULES` give it on its
    own mesh; a plain tensor (every unsharded path) is returned as it
    is."""
    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding.dist import mesh_of, placements

    mesh = mesh_of(x.device_mesh)
    sh = NamedSharding(mesh, spec_for(logical, x.shape, mesh,
                                      DEFAULT_ACT_RULES))
    pl = placements(sh, x.dim())
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        isinstance(e, (str, type(None))) for e in x)


def _shape_of(x) -> tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def logical_to_sharding(
    axes_tree: Any,
    tensors_or_shapes: Any,
    mesh: Mesh,
    rules: Mapping[str, Any] | None = None,
) -> Any:
    """Map a tree of logical-axes tuples (dicts, lists and NamedTuples
    of them; None where a tree has no tensor) and a tree of the same
    structure holding tensors or shapes to the same tree of
    `NamedSharding`s."""
    if axes_tree is None:
        return None
    if is_axes_leaf(axes_tree):
        return NamedSharding(mesh, spec_for(
            axes_tree, _shape_of(tensors_or_shapes), mesh, rules))
    if isinstance(axes_tree, Mapping):
        return {k: logical_to_sharding(a, tensors_or_shapes[k], mesh, rules)
                for k, a in axes_tree.items()}
    parts = [logical_to_sharding(a, t, mesh, rules)
             for a, t in zip(axes_tree, tensors_or_shapes, strict=True)]
    return type(axes_tree)(*parts) if hasattr(axes_tree, "_fields") \
        else type(axes_tree)(parts)
