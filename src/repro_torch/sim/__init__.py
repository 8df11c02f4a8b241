"""Discrete-event simulation of the black-box provider boundary, in torch."""
from repro_torch.sim.engine import SimConfig, run_sim  # noqa: F401
from repro_torch.sim.metrics import SimMetrics, compute_metrics  # noqa: F401
from repro_torch.sim.provider import ProviderPhysics, default_physics  # noqa: F401
from repro_torch.sim.runner import (  # noqa: F401
    fmt_cell,
    run_cell,
    summarize,
    window_for,
)
from repro_torch.sim.workload import REGIMES, WorkloadConfig, generate  # noqa: F401
