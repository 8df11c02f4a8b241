"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: torch.device | str | None = DEFAULT_DEVICE
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (explicitly or by default)
    and no card is present — the port never falls back to the CPU on
    its own."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the CPU")
    return dev


def to_device(obj, device: torch.device):
    """`obj` (a tensor, or NamedTuples/tuples of them) with every tensor
    on `device`; other leaves (ints, None) are returned as they are."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if hasattr(obj, "_fields"):
        return type(obj)(*(to_device(v, device) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(v, device) for v in obj)
    return obj
