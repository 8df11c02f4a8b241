"""Entry points of the port (counterpart of `repro.launch`): the serving
launcher, `python -m repro_torch.launch.serve`, the training launcher,
`python -m repro_torch.launch.train`, and the dry run of the production
meshes, `python -m repro_torch.launch.dryrun` (over `mesh` and
`specs`)."""
from repro_torch.launch.mesh import (  # noqa: F401
    HBM_BW,
    HBM_PER_CHIP,
    NVLINK_BW,
    PEAK_FLOPS_BF16,
    make_host_mesh,
    make_production_mesh,
)
from repro_torch.launch.specs import (  # noqa: F401
    LONG_WINDOW,
    LoweringSpec,
    build_spec,
    config_for,
    materialize_shard,
    shard_alloc_nbytes,
    shard_nbytes,
    state_leaves,
)
