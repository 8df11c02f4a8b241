"""Scenario registry: named nonstationary workload and provider regimes.

Counterpart of `repro.sim.scenarios`.  A `Scenario` is a static,
hashable spec composing

  * an arrival shape: piecewise-constant phases `(frac, rate_mult, mix)`
    over the scenario's arrival span (burst trains, diurnal ramps, flash
    crowds, heavy-dominated phase shifts);
  * provider dynamics: brownout windows and per-class token-bucket rate
    limits with 429-style bounces (`sim/provider.ProviderDynamics`),
    optionally with a refill that varies over time (`tb_windows`);
  * or a fleet of P endpoints (`FleetSpec`): skewed physics, fail
    windows, per-endpoint brownouts and a per-endpoint limiter, which
    `build_fleet` turns into a `Fleet` of (T, P) schedules.  Fleet and
    single-provider dynamics never coexist: `build` gives no dynamics
    for a fleet scenario.

`build` turns the spec into tensors on the CPU: the arrival schedule,
the (T,)-shaped provider schedules and the metric phase edges.  Each is
computed with the reference's float32 operations in the reference's
order, so the bits are the reference's.

Phases lie over the expected stationary arrival span (`n_requests /
base_rate`), not the horizon, which includes the drain.  Registry
scenarios keep the frac-weighted mean rate multiplier at 1.0.  Fault
schedules ride the spec for the live path (A6); the simulator ignores
them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.sim.faults import FaultSchedule
from repro_torch.sim.provider import (
    Fleet,
    FleetDynamics,
    ProviderDynamics,
    ProviderPhysics,
    availability_schedule,
    brownout_schedule,
    fleet_brownout_schedule,
    token_bucket_schedule,
    token_bucket_windows,
    uniform_fleet_physics,
)
from repro_torch.sim.workload import (
    MIXES,
    ArrivalSchedule,
    WorkloadConfig,
    arrival_rate,
    n_classes_of,
)

_F32 = torch.float32


class Phase(NamedTuple):
    """One arrival phase: a fraction of the arrival span at a rate
    multiplier, optionally with its own bucket mix."""

    frac: float
    rate_mult: float = 1.0
    mix: Optional[str] = None  # None = the scenario's base mix


class FleetSpec(NamedTuple):
    """Static (P,) fleet spec riding a `Scenario`: endpoint count, skew
    of their physics, and per-endpoint incidents; `build_fleet` turns it
    into (T, P) schedules."""

    p: int = 4
    # per-endpoint ms/token multiplier (< 1 is faster) and comfort-knee
    # multiplier; None = a uniform fleet
    speed_mult: Optional[tuple[float, ...]] = None
    comfort_mult: Optional[tuple[float, ...]] = None
    # (endpoint, start_frac, end_frac) hard-down windows over the arrival
    # span: in-flight work is killed and requeued
    fail_windows: tuple[tuple[int, float, float], ...] = ()
    # (endpoint, start_frac, end_frac, comfort_scale) brownouts
    brownouts: tuple[tuple[int, float, float, float], ...] = ()
    # per-endpoint per-class sustained grant rate; None = no (P, K) grid
    tb_rate_rps: Optional[float] = None
    tb_burst: float = 6.0
    retry_after_ms: float = 1500.0


class Scenario(NamedTuple):
    """Static scenario spec (hashable)."""

    name: str
    mix: str = "balanced"
    congestion: str = "medium"
    phases: tuple[Phase, ...] = (Phase(1.0),)
    # brownout windows: (start_frac, end_frac, comfort_scale) over the
    # arrival span
    brownouts: tuple[tuple[float, float, float], ...] = ()
    # per-class token-bucket rate (sustained grants/s); a scalar applies
    # to every class, None disables the limiter
    tb_rate_rps: Optional[float | tuple[float, ...]] = None
    tb_burst: float = 6.0
    retry_after_ms: float = 1500.0
    # (start_frac, end_frac, rate_mult) windows scaling the refill
    tb_windows: tuple[tuple[float, float, float], ...] = ()
    fleet: Optional[FleetSpec] = None
    fault_schedule: Optional[FaultSchedule] = None

    @property
    def faults(self) -> Optional[FaultSchedule]:
        """The fault schedule if it injects anything, else None."""
        fs = self.fault_schedule
        return fs if fs is not None and fs.injects else None

    @property
    def has_dynamics(self) -> bool:
        return bool(self.brownouts) or self.tb_rate_rps is not None


def arrival_span_ms(sc: Scenario, n_requests: int,
                    arrival_scale: float = 1.0) -> float:
    """Expected stationary arrival span the phases are laid over."""
    return n_requests / (
        arrival_rate(sc.mix, sc.congestion) * arrival_scale) * 1000.0


def phase_edges_ms(sc: Scenario, n_requests: int,
                   arrival_scale: float = 1.0) -> torch.Tensor:
    """(P+1,) float32 wall-clock phase boundaries: the metric windows."""
    span = arrival_span_ms(sc, n_requests, arrival_scale)
    # a running float32 sum, one rounding an add as in the reference
    # (torch's CPU cumsum accumulates float32 in float64)
    cum = [torch.zeros((), dtype=_F32)]
    for p in sc.phases:
        cum.append(cum[-1] + torch.tensor(p.frac, dtype=_F32))
    return torch.stack(cum) * span


def build_arrival_schedule(sc: Scenario, n_requests: int,
                           arrival_scale: float = 1.0) -> ArrivalSchedule:
    """The piecewise schedule's tensors from the static spec."""
    total = sum(p.frac for p in sc.phases)
    if abs(total - 1.0) > 1e-6:
        raise ValueError(
            f"scenario {sc.name!r}: phase fracs must sum to 1, got {total}")
    span = arrival_span_ms(sc, n_requests, arrival_scale)
    t0, cum_work = [], []
    t = w = 0.0
    for p in sc.phases:
        if p.rate_mult <= 0:
            raise ValueError(
                f"scenario {sc.name!r}: rate_mult must be > 0, got "
                f"{p.rate_mult}")
        t0.append(t)
        cum_work.append(w)
        t += p.frac * span
        w += p.rate_mult * p.frac * span
    return ArrivalSchedule(
        t0_ms=torch.tensor(t0, dtype=_F32),
        cum_work_ms=torch.tensor(cum_work, dtype=_F32),
        rate_mult=torch.tensor([p.rate_mult for p in sc.phases], dtype=_F32),
        mix_w=torch.tensor(
            [MIXES[p.mix if p.mix is not None else sc.mix]
             for p in sc.phases], dtype=_F32),
        mix_varies=any(p.mix is not None and p.mix != sc.mix
                       for p in sc.phases),
    )


def build_dynamics(sc: Scenario, n_ticks: int, dt_ms: float,
                   n_requests: int, k: int, arrival_scale: float = 1.0
                   ) -> ProviderDynamics | None:
    """The (T,)-shaped provider schedules; None when the scenario
    configures no dynamics."""
    if not sc.has_dynamics:
        return None
    span = arrival_span_ms(sc, n_requests, arrival_scale)
    comfort = (brownout_schedule(n_ticks, dt_ms, sc.brownouts, span)
               if sc.brownouts else None)
    refill = capacity = retry = None
    if sc.tb_rate_rps is not None:
        rate = sc.tb_rate_rps
        rate_k = (tuple([float(rate)] * k) if isinstance(rate, (int, float))
                  else tuple(float(r) for r in rate))
        if len(rate_k) != k:
            raise ValueError(
                f"scenario {sc.name!r}: tb_rate_rps has {len(rate_k)} "
                f"classes but the run carries {k}")
        if sc.tb_windows:
            refill, capacity = token_bucket_windows(
                n_ticks, dt_ms, rate_k, sc.tb_burst, sc.tb_windows, span)
        else:
            refill, capacity = token_bucket_schedule(
                n_ticks, dt_ms, rate_k, sc.tb_burst)
        retry = torch.tensor(sc.retry_after_ms, dtype=_F32)
    return ProviderDynamics(comfort_scale=comfort, tb_refill=refill,
                            tb_capacity=capacity, retry_after_ms=retry)


def build_fleet(sc: Scenario, phys: ProviderPhysics, n_ticks: int,
                dt_ms: float, n_requests: int, k: int,
                arrival_scale: float = 1.0) -> Fleet | None:
    """The (T, P)-shaped fleet schedules of a fleet scenario; None for a
    single-provider one.  `phys` is the base physics the fleet skews
    from (the reference physics of the tail EMA)."""
    fs = sc.fleet
    if fs is None:
        return None
    span = arrival_span_ms(sc, n_requests, arrival_scale)
    fphys = uniform_fleet_physics(phys, fs.p, fs.speed_mult, fs.comfort_mult)
    avail = (availability_schedule(n_ticks, dt_ms, fs.fail_windows, span,
                                   fs.p) if fs.fail_windows else None)
    comfort = (fleet_brownout_schedule(n_ticks, dt_ms, fs.brownouts, span,
                                       fs.p) if fs.brownouts else None)
    refill = capacity = None
    if fs.tb_rate_rps is not None:
        refill1, cap1 = token_bucket_schedule(
            n_ticks, dt_ms, (float(fs.tb_rate_rps),) * k, fs.tb_burst)
        # every endpoint gets its own copy of the per-class budget
        refill = refill1[:, None, :].expand(n_ticks, fs.p, k)
        capacity = cap1[None, :].expand(fs.p, k)
    return Fleet(phys=fphys, dyn=FleetDynamics(
        avail=avail, comfort_scale=comfort, tb_refill=refill,
        tb_capacity=capacity,
        retry_after_ms=torch.tensor(fs.retry_after_ms, dtype=_F32)))


def build(sc: Scenario, n_requests: int, n_ticks: int, dt_ms: float,
          class_map: str = "paper2", information: str = "coarse",
          limiter_classes: int | None = None, arrival_scale: float = 1.0
          ) -> tuple[WorkloadConfig, ArrivalSchedule,
                     ProviderDynamics | None, torch.Tensor]:
    """(workload config, arrival schedule, provider dynamics, metric
    phase edges) for one scenario.  `limiter_classes` sizes the token
    buckets (pass the policy's K; default the lane scheme's);
    `arrival_scale` offers the same population at a higher rate, so the
    span, phase edges and schedules all compress together.  A fleet
    scenario has no provider dynamics here: its schedules come from
    `build_fleet`."""
    wl_cfg = WorkloadConfig(
        n_requests=n_requests,
        mix=sc.mix,
        congestion=sc.congestion,
        information=information,
        class_map=class_map,
        arrival_scale=arrival_scale,
    )
    sched = build_arrival_schedule(sc, n_requests, arrival_scale)
    k = (limiter_classes if limiter_classes is not None
         else n_classes_of(class_map))
    dynamics = build_dynamics(sc, n_ticks, dt_ms, n_requests, k,
                              arrival_scale)
    return wl_cfg, sched, dynamics, phase_edges_ms(sc, n_requests,
                                                   arrival_scale)


# ---------------------------------------------------------------------------
# The registry (the reference's, scenario for scenario).  The mean rate
# multiplier is 1.0 in every scenario; burstiness lives in the ratios.
# ---------------------------------------------------------------------------

_QUIET, _BURST = 0.4, 1.6  # burst train: 4x rate swing, mean 1.0

SCENARIOS: dict[str, Scenario] = {
    # stationary anchors
    "balanced": Scenario("balanced"),
    "high_congestion": Scenario("high_congestion", congestion="high"),
    # alternating quiet/burst epochs
    "burst_train": Scenario(
        "burst_train",
        phases=tuple(Phase(0.125, m) for m in (_QUIET, _BURST) * 4),
    ),
    # diurnal ramp: trough -> peak -> trough, peak 5x the trough
    "diurnal": Scenario(
        "diurnal",
        phases=tuple(Phase(1.0 / 7.0, m)
                     for m in (0.4, 0.8, 1.3, 2.0, 1.3, 0.8, 0.4)),
    ),
    # heavy-dominated phase shift: the token mix flips mid-run
    "heavy_shift": Scenario(
        "heavy_shift",
        phases=(Phase(0.4, 1.0), Phase(0.3, 1.0, mix="heavy"),
                Phase(0.3, 1.0)),
    ),
    # flash crowd: a short 4.3x spike over a calm baseline
    "flash_crowd": Scenario(
        "flash_crowd",
        phases=(Phase(0.45, 0.75), Phase(0.1, 3.25), Phase(0.45, 0.75)),
    ),
    # the provider loses 60% of its comfort capacity mid-run
    "brownout": Scenario(
        "brownout",
        congestion="high",
        phases=(Phase(1 / 3), Phase(1 / 3), Phase(1 / 3)),
        brownouts=((1 / 3, 2 / 3, 0.4),),
    ),
    # a sustained per-class grant budget well under the offered rate
    "rate_limited": Scenario(
        "rate_limited",
        congestion="high",
        phases=(Phase(0.25, _QUIET), Phase(0.25, _BURST),
                Phase(0.25, _QUIET), Phase(0.25, _BURST)),
        tb_rate_rps=0.5,
        tb_burst=6.0,
    ),
    # the limiter's sustained rate collapses to 10% for the middle third
    "rate_crunch": Scenario(
        "rate_crunch",
        congestion="high",
        phases=(Phase(1 / 3), Phase(1 / 3), Phase(1 / 3)),
        tb_rate_rps=1.2,
        tb_burst=6.0,
        tb_windows=((1 / 3, 2 / 3, 0.1),),
    ),
    # a flash crowd into a browned-out, rate-limited provider
    "storm": Scenario(
        "storm",
        congestion="high",
        phases=(Phase(0.3, 0.7), Phase(0.2, 2.2), Phase(0.5, 0.7)),
        brownouts=((0.3, 0.5, 0.5),),
        tb_rate_rps=0.8,
        tb_burst=8.0,
    ),
    # fleets: an endpoint failure, a skewed fleet, brownouts on two
    # endpoints in staggered windows
    "fleet_failover": Scenario(
        "fleet_failover",
        congestion="high",
        phases=(Phase(0.35), Phase(0.30), Phase(0.35)),
        fleet=FleetSpec(p=4, fail_windows=((0, 0.35, 0.65),)),
    ),
    "fleet_skew": Scenario(
        "fleet_skew",
        congestion="high",
        fleet=FleetSpec(p=4, speed_mult=(0.5, 1.0, 1.0, 2.0)),
    ),
    "fleet_brownout": Scenario(
        "fleet_brownout",
        congestion="high",
        phases=(Phase(1 / 3), Phase(1 / 3), Phase(1 / 3)),
        fleet=FleetSpec(
            p=4,
            brownouts=((0, 1 / 3, 2 / 3, 0.3), (1, 0.5, 0.85, 0.3)),
        ),
    ),
    # chaos scenarios (live path only, A6): a provider that breaks the
    # transport contract
    "silent_drop": Scenario(
        "silent_drop",
        fault_schedule=FaultSchedule(seed=11, drop_frac=0.15),
    ),
    "stuck_tail": Scenario(
        "stuck_tail",
        fault_schedule=FaultSchedule(seed=15, stuck_frac=0.12,
                                     stuck_mult=400.0),
    ),
    "dup_storm": Scenario(
        "dup_storm",
        tb_rate_rps=1.5,
        tb_burst=6.0,
        fault_schedule=FaultSchedule(seed=13, dup_frac=0.3, dup_extra=2,
                                     dup_delay_ms=120.0, dup_jitter_ms=7.0,
                                     retry_lie_mult=0.25),
    ),
}


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}"
        ) from None


def list_scenarios() -> list[str]:
    return sorted(SCENARIOS)
