"""Carry the reference's state across: numpy NamedTuples -> port types.

`from_numpy(obj, device)` turns the reference's NamedTuples (the
`RequestBatch`, the jitter vector, `PolicyConfig`, `ProviderPhysics`,
`ProviderDynamics`, `ArrivalSchedule`, `SimState`, `WindowCarry`, and
the fleet's `Fleet`, `FleetPhysics`, `FleetDynamics`, `FleetState`),
given with numpy (or any array-like) leaves, into this package's types
on `device`; None leaves (a mechanism that is off) and Python bools
(`ArrivalSchedule.mix_varies`) stay as they are.  Types are matched by
field name (`_fields`), not by importing the reference: among the port
types whose fields all appear in the object, and which lack only fields
that are None there, the one of the same class name wins, else the one
with the most fields (`FleetPhysics` has `ProviderPhysics`'s fields).  Dtypes are kept exactly: float32, int32 and
bool; anything else raises.  `PolicyConfig.alloc_mode` becomes a
Python int.  `to_numpy` is the inverse, for the tests.

`params_from_jax(params, cfg, device)` carries the reference's model
parameters across: its tree (nested dicts of arrays, the blocks stacked
on a leading `L` axis, as `repro.models.init_model` builds it) becomes a
port `Model` that computes the same function.  Leaves are matched by
path, so every architecture's carry over as they are: the MoE layer's
`moe/router/w`, its expert stacks `moe/wi`, `moe/wg`, `moe/wo` ((L, E,
d, ff) and (L, E, ff, d)) and Arctic's `moe/residual/...`, and the
attention biases `attn/{q,k,v}/b` of Qwen1.5 and InternVL2.  float32 leaves are
copied; bfloat16 leaves (numpy dtype name `bfloat16`, as `np.asarray`
of a JAX bfloat16 array gives them) are copied by their bits as uint16
and viewed as `torch.bfloat16`, so no `ml_dtypes` import is needed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.policy import PolicyConfig
from repro_torch.core.types import (
    FleetState,
    ProviderState,
    RequestBatch,
    RequestState,
    SchedState,
    SimState,
    WindowCarry,
)
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.sim.provider import (
    Fleet,
    FleetDynamics,
    FleetPhysics,
    ProviderDynamics,
    ProviderPhysics,
)
from repro_torch.sim.workload import ArrivalSchedule

PORT_TYPES = (RequestBatch, RequestState, SchedState, ProviderState,
              SimState, WindowCarry, PolicyConfig, ProviderPhysics,
              ProviderDynamics, ArrivalSchedule, Fleet, FleetPhysics,
              FleetDynamics, FleetState)
_DTYPES = (np.dtype(np.float32), np.dtype(np.int32), np.dtype(np.bool_))


def _match(obj):
    fields = set(obj._fields)
    best = None
    for t in PORT_TYPES:
        own = set(t._fields)
        if not own <= fields:
            continue
        if any(getattr(obj, f) is not None for f in fields - own):
            continue
        if t.__name__ == type(obj).__name__:
            return t
        if best is None or len(own) > len(best._fields):
            best = t
    if best is None:
        raise TypeError(f"no port type matches {type(obj).__name__} "
                        f"fields {obj._fields}")
    return best


def _convert(obj, dev):
    if obj is None or isinstance(obj, bool):
        return obj
    if hasattr(obj, "_fields"):
        t = _match(obj)
        vals = {}
        for f in t._fields:
            v = getattr(obj, f)
            vals[f] = (int(np.asarray(v)) if t is PolicyConfig
                       and f == "alloc_mode" else _convert(v, dev))
        return t(**vals)
    arr = np.asarray(obj)
    if arr.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {arr.dtype}: the bridge carries "
                        f"float32, int32 and bool exactly")
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def from_numpy(obj, device="cuda"):
    """The reference's NamedTuple (or array) as the port's, on `device`."""
    return _convert(obj, resolve_device(device))


def to_numpy(obj):
    """Port NamedTuples/tensors -> the same structure with numpy leaves."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if hasattr(obj, "_fields"):
        return type(obj)(*(to_numpy(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_numpy(v) for v in obj)
    return obj


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            out.update(_flatten(val, path))
        else:
            out[path] = val
    return out


def _param_tensor(arr) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype == np.float32:
        return torch.from_numpy(a.copy())
    raise TypeError(f"unsupported parameter dtype {a.dtype}: the bridge "
                    f"carries float32 and bfloat16")


def params_from_jax(params, cfg, device="cuda") -> Model:
    """The reference's parameter tree for `cfg` as a port `Model` on
    `device`.  The tree must hold exactly the leaves the port's model
    has, each of its shape (with the leading layer axis under `blocks`)
    and of the config's dtype; anything else raises."""
    model = Model(cfg, device)
    flat = _flatten(params)
    want = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            layer, rest = int(parts[1]), "/".join(parts[2:])
            want.setdefault(f"blocks/{rest}", []).append((layer, p))
        else:
            want["/".join(parts)] = [(None, p)]
    missing, extra = sorted(set(want) - set(flat)), sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"params_from_jax: the tree does not match "
                         f"{cfg.name}: missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for path, targets in want.items():
            src = _param_tensor(flat[path])
            shape = targets[0][1].shape
            if targets[0][0] is not None:
                shape = (cfg.n_layers, *shape)
            if tuple(src.shape) != tuple(shape):
                raise ValueError(f"params_from_jax: {path} has shape "
                                 f"{tuple(src.shape)}, {cfg.name} needs "
                                 f"{tuple(shape)}")
            if src.dtype != targets[0][1].dtype:
                raise TypeError(f"params_from_jax: {path} is {src.dtype}, "
                                f"{cfg.name} needs {targets[0][1].dtype}")
            for layer, p in targets:
                p.copy_(src if layer is None else src[layer])
    return model
