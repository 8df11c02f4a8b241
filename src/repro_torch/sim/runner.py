"""Experiment runner: one (policy, workload) or (policy, scenario) cell
over several seeds.

Counterpart of `repro.sim.runner`.  The reference `vmap`s the seeds
through one jitted program; the port loops over them.  Each seed's
workload is drawn on the CPU from `torch.Generator().manual_seed(seed)`,
so a cell run on CUDA and the same cell run on the CPU see the same
requests.  `run_scenario_cell` builds the scenario's schedules (a
fleet's too) once and returns per-phase metrics beside the aggregates.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.policy import PolicyConfig, n_classes
from repro_torch.device import resolve_device
from repro_torch.sim import scenarios as scn
from repro_torch.sim.engine import SimConfig, run_sim
from repro_torch.sim.metrics import (
    PhaseMetrics,
    SimMetrics,
    compute_metrics,
    compute_phase_metrics,
)
from repro_torch.sim.provider import ProviderPhysics, default_physics
from repro_torch.sim.workload import WorkloadConfig, generate, n_classes_of


def window_for(n_requests: int, *, fraction: float = 0.25,
               floor: int = 256, cap: int = 4096) -> int:
    """Heuristic active-window capacity for a population of N: a quarter
    of it, clamped to [floor, cap]."""
    return int(min(max(floor, fraction * n_requests), cap))


def _check_lanes(class_map: str, policy: PolicyConfig) -> int:
    """The policy's K; raises when the lane scheme needs more classes."""
    wl_k = n_classes_of(class_map)
    pol_k = n_classes(policy)
    if wl_k > pol_k:
        raise ValueError(
            f"workload lane scheme {class_map!r} needs {wl_k} classes "
            f"but the policy carries {pol_k}; build it with kclass_policy({wl_k})"
        )
    return pol_k


def _stack(rows):
    """A list of per-seed NamedTuples -> one with a leading seed axis."""
    return type(rows[0])(*(torch.stack(f) for f in zip(*rows)))


def run_cell(
    policy: PolicyConfig,
    wl_cfg: WorkloadConfig,
    *,
    seeds: int = 5,
    seed0: int = 0,
    phys: ProviderPhysics | None = None,
    sim_cfg: SimConfig = SimConfig(),
    device="cuda",
    collect_decisions: bool = False,
):
    """Metrics stacked over `seeds` runs (leading axis = seed).  With
    `collect_decisions=True` also returns, per seed, the final SimState
    and the decision trace: `(metrics, [(final, trace), ...])`."""
    dev = resolve_device(device)
    phys = phys if phys is not None else default_physics()
    pol_k = _check_lanes(wl_cfg.class_map, policy)
    per_seed, runs = [], []
    for seed in range(seed0, seed0 + seeds):
        gen = torch.Generator().manual_seed(seed)
        batch, jitter = generate(wl_cfg, gen, device=dev)
        out = run_sim(policy, batch, jitter, phys, sim_cfg,
                      collect_decisions=collect_decisions, device=dev)
        final = out[0] if collect_decisions else out
        if collect_decisions:
            runs.append(out)
        per_seed.append(compute_metrics(batch, final, pol_k))
    metrics = _stack(per_seed)
    return (metrics, runs) if collect_decisions else metrics


def run_scenario_cell(
    policy: PolicyConfig,
    scenario: scn.Scenario | str,
    *,
    seeds: int = 5,
    seed0: int = 0,
    n_requests: int = 160,
    class_map: str = "paper2",
    information: str = "coarse",
    phys: ProviderPhysics | None = None,
    sim_cfg: SimConfig = SimConfig(),
    arrival_scale: float = 1.0,
    device="cuda",
    collect_decisions: bool = False,
) -> tuple[SimMetrics, PhaseMetrics]:
    """One (policy, scenario) cell over `seeds` runs: (aggregate metrics,
    per-phase metrics), both stacked over a leading seed axis.  The
    token buckets are sized by the policy's K.  `arrival_scale`
    compresses the scenario's span by offering the same population at a
    higher rate (`scenarios.build`).  With `collect_decisions=True` also
    returns, per seed, the final SimState and the decision trace."""
    if isinstance(scenario, str):
        scenario = scn.get_scenario(scenario)
    dev = resolve_device(device)
    phys = phys if phys is not None else default_physics()
    k = _check_lanes(class_map, policy)
    wl_cfg, sched, dynamics, edges = scn.build(
        scenario, n_requests, sim_cfg.n_ticks, sim_cfg.dt_ms,
        class_map=class_map, information=information, limiter_classes=k,
        arrival_scale=arrival_scale)
    # a fleet scenario gives (T, P) schedules here and no dynamics above
    fleet = scn.build_fleet(scenario, phys, sim_cfg.n_ticks, sim_cfg.dt_ms,
                            n_requests, k, arrival_scale)
    per_seed, per_phase, runs = [], [], []
    for seed in range(seed0, seed0 + seeds):
        gen = torch.Generator().manual_seed(seed)
        batch, jitter = generate(wl_cfg, gen, device=dev, sched=sched)
        out = run_sim(policy, batch, jitter, phys, sim_cfg, dynamics,
                      collect_decisions=collect_decisions, fleet=fleet,
                      device=dev)
        final = out[0] if collect_decisions else out
        if collect_decisions:
            runs.append(out)
        per_seed.append(compute_metrics(batch, final, k))
        per_phase.append(compute_phase_metrics(batch, final, edges, k))
    res = (_stack(per_seed), _stack(per_phase))
    return (*res, runs) if collect_decisions else res


def summarize(m: SimMetrics) -> Mapping[str, tuple[float, float]]:
    """mean ± std over the seed axis, NaN-safe."""
    out = {}
    for name, v in m._asdict().items():
        arr = v.detach().cpu().numpy().astype(np.float64)
        out[name] = (float(np.nanmean(arr)), float(np.nanstd(arr)))
    return out


def fmt_cell(summary: Mapping[str, tuple[float, float]], keys=None) -> str:
    keys = keys or list(summary)
    return " ".join(f"{k}={summary[k][0]:.1f}±{summary[k][1]:.1f}"
                    for k in keys)
