"""Sharding of the port (counterpart of `repro.sharding`): the
logical-axis rules, device-free meshes and placements."""
from repro_torch.sharding.rules import (  # noqa: F401
    DEFAULT_ACT_RULES,
    DEFAULT_PARAM_RULES,
    Mesh,
    NamedSharding,
    constrain,
    logical_to_sharding,
    spec_for,
)
