"""Carry the reference's state across: numpy NamedTuples -> port types.

`from_numpy(obj, device)` turns the reference's NamedTuples (the
`RequestBatch`, the jitter vector, `PolicyConfig`, `ProviderPhysics`,
`SimState`, `WindowCarry`), given with numpy (or any array-like)
leaves, into this package's types on `device`.  Types are matched by
field name (`_fields`), not by importing the reference: the port type
whose fields all appear in the object wins, as long as every field it
lacks is None there (fleet-only fields such as `RequestState.endpoint`
and `SimState.fleet`).  Dtypes are kept exactly: float32, int32 and
bool; anything else raises.  `PolicyConfig.alloc_mode` becomes a
Python int.  `to_numpy` is the inverse, for the tests.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.policy import PolicyConfig
from repro_torch.core.types import (
    ProviderState,
    RequestBatch,
    RequestState,
    SchedState,
    SimState,
    WindowCarry,
)
from repro_torch.device import resolve_device
from repro_torch.sim.provider import ProviderPhysics

PORT_TYPES = (RequestBatch, RequestState, SchedState, ProviderState,
              SimState, WindowCarry, PolicyConfig, ProviderPhysics)
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
        if best is None or len(own) > len(best._fields):
            best = t
    if best is None:
        raise TypeError(f"no port type matches {type(obj).__name__} "
                        f"fields {obj._fields}")
    return best


def _convert(obj, dev):
    if obj is None:
        return None
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
