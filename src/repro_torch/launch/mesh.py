"""Production meshes of the dry run.

Counterpart of `repro.launch.mesh`: the same shapes and axis names, one
pod of 16 x 16 = 256 devices (`data`, `model`) and two pods of 512
(`pod`, `data`, `model`), read here as 256 and 512 H100s.  The meshes
are device-free descriptions (`repro_torch.sharding.Mesh`): building
one touches no device and creates no process group.
"""
from __future__ import annotations

from repro_torch.sharding.rules import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_host_mesh() -> Mesh:
    """Single-process debug mesh (1 device)."""
    return Mesh((1, 1), ("data", "model"))


# Hardware constants of one H100 SXM5 80GB (NVIDIA H100 Tensor Core GPU
# datasheet: dense bf16 tensor-core rate without sparsity, HBM3
# bandwidth, memory, and NVLink 4 bandwidth summed over its 18 links in
# both directions)
PEAK_FLOPS_BF16 = 989e12      # FLOP/s per device
HBM_BW = 3.35e12              # bytes/s per device
NVLINK_BW = 900e9             # bytes/s per device
HBM_PER_CHIP = 80e9           # bytes
