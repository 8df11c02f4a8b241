"""Discrete-event simulation of the black-box provider boundary, in torch."""
from repro_torch.sim.engine import SimConfig, run_sim  # noqa: F401
from repro_torch.sim.faults import FaultSchedule, fault_draw  # noqa: F401
from repro_torch.sim.metrics import (  # noqa: F401
    PhaseMetrics,
    SimMetrics,
    compute_metrics,
    compute_phase_metrics,
)
from repro_torch.sim.provider import (  # noqa: F401
    Fleet,
    FleetDynamics,
    FleetPhysics,
    ProviderDynamics,
    ProviderPhysics,
    availability_schedule,
    default_physics,
    fleet_brownout_schedule,
    physics_for_arch,
    uniform_fleet_physics,
)
from repro_torch.sim.runner import (  # noqa: F401
    fmt_cell,
    run_cell,
    run_scenario_cell,
    summarize,
    window_for,
)
from repro_torch.sim.scenarios import (  # noqa: F401
    SCENARIOS,
    FleetSpec,
    Phase,
    Scenario,
    build_fleet,
    get_scenario,
    list_scenarios,
)
from repro_torch.sim.workload import REGIMES, WorkloadConfig, generate  # noqa: F401
