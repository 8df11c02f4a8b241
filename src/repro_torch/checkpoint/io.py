"""npz checkpoints with metadata and an atomic rename.

Counterpart of `repro.checkpoint.io`: the same file names
(`ckpt_%08d.npz` beside `ckpt_%08d.json`), the same metadata, a write
to a `.tmp` file in the directory renamed over the target, and
bfloat16 stored as its uint16 bits.  A state is flattened to
`/`-joined keys: a NamedTuple by its fields, a dict by its keys (the
dots of a parameter name become `/`), an `nn.Module` by its
`named_parameters()`, a tensor as a leaf.  So the port's `TrainState`
is stored as `model/<parameter path>` and `opt/step`,
`opt/{master,m,v}/<parameter path>`.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any

import numpy as np
import torch


def _leaves(tree: Any, prefix: str = ""):
    """(key, tensor) for every leaf of `tree`, in its own order."""
    if isinstance(tree, torch.nn.Module):
        items = tree.named_parameters()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = tree.items()
    else:
        if not isinstance(tree, torch.Tensor):
            raise TypeError(f"checkpoint leaf {prefix!r} is a "
                            f"{type(tree).__name__}, not a tensor")
        yield prefix, tree
        return
    for k, v in items:
        key = str(k).replace(".", "/")
        yield from _leaves(v, f"{prefix}/{key}" if prefix else key)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:   # numpy has no bfloat16: store the bits
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_checkpoint(directory: str, step: int, tree: Any,
                    meta: dict | None = None) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = {k: _to_numpy(t) for k, t in _leaves(tree)}
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    with open(os.path.join(directory, f"ckpt_{step:08d}.json"), "w") as f:
        json.dump({"step": step, "n_arrays": len(flat), **(meta or {})}, f)
    return path


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(f[5:13]) for f in os.listdir(directory)
             if f.startswith("ckpt_") and f.endswith(".npz")]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, like: Any) -> Any:
    """Restore into `like` in place and return it: each of its tensors
    takes the stored array of its key, keeping its own dtype and device.
    Raises `ValueError` when a key is missing or a shape differs."""
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    leaves = list(_leaves(like))
    with np.load(path) as data:
        missing = sorted({k for k, _ in leaves} - set(data.files))
        if missing:
            raise ValueError(f"checkpoint missing keys: {missing[:5]} ...")
        with torch.no_grad():
            for key, t in leaves:
                arr = data[key]
                if t.dtype == torch.bfloat16 and arr.dtype == np.uint16:
                    src = torch.from_numpy(arr.view(np.int16)).view(
                        torch.bfloat16)
                else:
                    src = torch.from_numpy(arr)
                if tuple(src.shape) != tuple(t.shape):
                    raise ValueError(f"checkpoint {key}: shape "
                                     f"{tuple(src.shape)}, want "
                                     f"{tuple(t.shape)}")
                t.copy_(src)
    return like
