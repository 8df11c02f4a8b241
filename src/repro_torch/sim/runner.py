"""Experiment runner: one (policy, workload) cell over several seeds.

Counterpart of the stationary part of `repro.sim.runner`.  The
reference `vmap`s the seeds through one jitted program; the port loops
over them.  Each seed's workload is drawn on the CPU from
`torch.Generator().manual_seed(seed)`, so a cell run on CUDA and the
same cell run on the CPU see the same requests.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.policy import PolicyConfig, n_classes
from repro_torch.device import resolve_device
from repro_torch.sim.engine import SimConfig, run_sim
from repro_torch.sim.metrics import SimMetrics, compute_metrics
from repro_torch.sim.provider import ProviderPhysics, default_physics
from repro_torch.sim.workload import WorkloadConfig, generate, n_classes_of


def window_for(n_requests: int, *, fraction: float = 0.25,
               floor: int = 256, cap: int = 4096) -> int:
    """Heuristic active-window capacity for a population of N: a quarter
    of it, clamped to [floor, cap]."""
    return int(min(max(floor, fraction * n_requests), cap))


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
    wl_k = n_classes_of(wl_cfg.class_map)
    pol_k = n_classes(policy)
    if wl_k > pol_k:
        raise ValueError(
            f"workload lane scheme {wl_cfg.class_map!r} needs {wl_k} classes "
            f"but the policy carries {pol_k}; build it with kclass_policy({wl_k})"
        )
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
    metrics = SimMetrics(*(torch.stack(f) for f in zip(*per_seed)))
    return (metrics, runs) if collect_decisions else metrics


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
