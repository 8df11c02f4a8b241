"""Workload generation (paper §4.2, §4.4, §4.10), stationary path.

Counterpart of `repro.sim.workload`: one `RequestBatch` per seed with
Poisson arrivals whose rate encodes the congestion level, the bucket
mix of the regime, log-uniform output tokens within each bucket, a
service class per request (`paper2`, `bucket4` or `tenant<K>`), priors
at one of the information-ladder levels, and optional predictor noise.

The port draws its own numbers from a `torch.Generator` (on the
generator's device, by default the CPU, so a run on the CPU and a run
on CUDA see the same batch), then moves the batch to `device`.  The
draws differ from `jax.random`'s, so this generator matches the
reference only in distribution; parity tests feed the reference's
`(batch, jitter)` through `repro_torch.bridge` instead.

Nonstationary arrivals: `generate` optionally takes an
`ArrivalSchedule`, a piecewise-constant rate multiplier and bucket mix
over phases.  Arrivals are the stationary Poisson stream time-warped
through the inverse of the cumulative-work function, so the trivial
schedule (one phase, unit multiplier) gives a batch bit-identical to
the stationary one: the warp is `0 + (u - 0) / 1.0`.  Per-phase bucket
mixes draw buckets by inverse CDF only when the mix varies, so a
schedule that only shapes the rate keeps the bucket stream.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.types import CLS_HEAVY, CLS_INTERACTIVE, SHORT, RequestBatch
from repro_torch.device import resolve_device, to_device

# bucket -> (token_low, token_high)
BUCKET_TOKENS = torch.tensor(
    [[16.0, 64.0], [65.0, 256.0], [257.0, 1024.0], [1025.0, 4096.0]],
    dtype=torch.float32)

# per-bucket deadline budgets (ms)
DEADLINE_BUDGET_MS = torch.tensor([3600.0, 11000.0, 35000.0, 100000.0],
                                  dtype=torch.float32)

# Exact per-bucket p90/p50 quantile ratio of the realized token
# distribution: tokens are log-uniform within [lo, hi], whose quantile
# function is lo * (hi/lo)^q, so p90/p50 = (hi/lo)^0.4 (float32, the
# reference's bits).  The live client's `default_p90` uses it.
P90_OVER_P50 = (BUCKET_TOKENS[:, 1] / BUCKET_TOKENS[:, 0]) ** 0.4
P90_OVER_P50_NP = P90_OVER_P50.numpy()

MIXES = {
    "balanced": (0.50, 0.25, 0.15, 0.10),
    "heavy": (0.20, 0.20, 0.30, 0.30),
    "heavy70": (0.20, 0.10, 0.40, 0.30),
    "sharegpt": (0.12, 0.42, 0.455, 0.005),
}

# offered load as a multiple of the provider's comfortable capacity
CONGESTION_MULT = {"medium": 0.85, "high": 1.2}

# mean tokens per mix (log-uniform within buckets)
_MEAN_TOKENS = {
    "balanced": 357.0,
    "heavy": 866.0,
    "heavy70": 908.0,
    "sharegpt": 326.0,
}

REGIMES = [
    ("balanced", "medium"),
    ("balanced", "high"),
    ("heavy", "medium"),
    ("heavy", "high"),
]

NEUTRAL_P50 = 300.0  # neutral prior for no_info / class_only conditions
NEUTRAL_P90 = 700.0


def arrival_rate(mix: str, congestion: str,
                 base_ms: float = 90.0, ms_per_token: float = 6.5,
                 comfort: float = 4.0) -> float:
    mean_service_s = (base_ms + ms_per_token * _MEAN_TOKENS[mix]) / 1000.0
    return CONGESTION_MULT[congestion] * comfort / mean_service_s


class WorkloadConfig(NamedTuple):
    n_requests: int = 192
    mix: str = "balanced"
    congestion: str = "medium"
    information: str = "coarse"   # no_info | class_only | coarse | oracle
    predictor_noise: float = 0.0  # L in paper §4.10
    coarse_rel_err: float = 0.25  # intrinsic coarseness of the predictor
    arrival_scale: float = 1.0    # multiplies the arrival rate
    class_map: str = "paper2"     # lane scheme: paper2 | bucket4 | tenant<K>


class ArrivalSchedule(NamedTuple):
    """Piecewise-constant arrival shaping over P phases: phase p covers
    `[t0_ms[p], t0_ms[p+1])` (the last extends to +inf) at rate
    multiplier `rate_mult[p]` with bucket mix `mix_w[p]`; `cum_work_ms[p]`
    is the stationary-equivalent work before phase p.  `mix_varies` is a
    Python bool: whether any phase deviates from the base mix."""

    t0_ms: torch.Tensor        # (P,) float32 phase start times
    cum_work_ms: torch.Tensor  # (P,) float32 warped work at each start
    rate_mult: torch.Tensor    # (P,) float32 arrival-rate multiplier
    mix_w: torch.Tensor        # (P, 4) float32 bucket mix per phase
    mix_varies: bool


def _bisect_right(edges: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Index of the interval of `edges` holding each x, clipped into
    [0, len(edges))."""
    p = torch.searchsorted(edges, x, right=True) - 1
    return torch.clamp(p, 0, edges.shape[0] - 1)


def phase_index(sched: ArrivalSchedule, t_ms: torch.Tensor) -> torch.Tensor:
    """Phase id of each time point (clipped into [0, P))."""
    return _bisect_right(sched.t0_ms, t_ms).to(torch.int32)


def warp_arrivals(work_ms: torch.Tensor, sched: ArrivalSchedule
                  ) -> torch.Tensor:
    """Map stationary-equivalent work onto wall-clock arrival times: a
    phase with multiplier m compresses its arrivals by 1/m; work past the
    last boundary goes on at the last phase's multiplier."""
    p = _bisect_right(sched.cum_work_ms, work_ms)
    return sched.t0_ms[p] + (work_ms - sched.cum_work_ms[p]) / \
        sched.rate_mult[p]


def _sample_bucket_per_request(p: torch.Tensor, g: torch.Generator
                               ) -> torch.Tensor:
    """Inverse-CDF draw of one bucket a request from its (N, 4) mix."""
    cdf = torch.cumsum(p, dim=-1)
    cdf = cdf / cdf[..., -1:]
    r = torch.rand((p.shape[0], 1), generator=g, device=g.device)
    return (r >= cdf[..., :-1]).sum(dim=-1).to(torch.int32)


def n_classes_of(class_map: str) -> int:
    """Static class count implied by a lane scheme."""
    if class_map == "paper2":
        return 2
    if class_map == "bucket4":
        return 4
    if class_map.startswith("tenant"):
        suffix = class_map[len("tenant"):]
        if not suffix.isdigit() or int(suffix) < 1:
            raise ValueError(
                f"tenant scheme must be 'tenant<K>' with K >= 1 "
                f"(e.g. 'tenant8'), got {class_map!r}")
        return int(suffix)
    raise ValueError(f"unknown class_map: {class_map!r}")


def _uniform(n, lo, hi, g):
    return lo + (hi - lo) * torch.rand((n,), generator=g, device=g.device)


def generate(cfg: WorkloadConfig, generator: torch.Generator | None = None,
             *, device="cuda", sched: ArrivalSchedule | None = None
             ) -> tuple[RequestBatch, torch.Tensor]:
    """Returns (batch, jitter) on `device`; jitter is the provider-side
    noise vector.  Arrivals come out sorted (the windowed engine relies
    on it).  `sched` shapes the arrivals (and the bucket mix, where it
    varies) over phases; None is the stationary path."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(0) if generator is None else generator
    gdev = g.device
    n = cfg.n_requests
    rate = arrival_rate(cfg.mix, cfg.congestion) * cfg.arrival_scale
    gaps = torch.empty((n,), device=gdev).exponential_(generator=g)
    arrival = torch.cumsum(gaps * (1000.0 / rate), 0)
    if sched is not None:
        sched = to_device(sched, gdev)
        arrival = warp_arrivals(arrival, sched)

    if sched is not None and sched.mix_varies:
        bucket = _sample_bucket_per_request(
            sched.mix_w[phase_index(sched, arrival).long()], g)
    else:
        mix = torch.tensor(MIXES[cfg.mix], dtype=torch.float32, device=gdev)
        bucket = torch.multinomial(mix, n, replacement=True,
                                   generator=g).to(torch.int32)
    bt = BUCKET_TOKENS.to(gdev)
    lo = bt[bucket.long(), 0]
    hi = bt[bucket.long(), 1]
    u = torch.rand((n,), generator=g, device=gdev)
    true_tokens = torch.exp(torch.log(lo) + u * (torch.log(hi) - torch.log(lo)))

    if cfg.information == "oracle":
        p50 = p90 = true_tokens
    elif cfg.information == "coarse":
        rel = cfg.coarse_rel_err
        p50 = true_tokens * _uniform(n, 1.0 - rel, 1.0 + rel, g)
        p90 = p50 * 1.8
    elif cfg.information in ("class_only", "no_info"):
        p50 = torch.full((n,), NEUTRAL_P50, device=gdev)
        p90 = torch.full((n,), NEUTRAL_P90, device=gdev)
    else:
        raise ValueError(f"unknown information level {cfg.information}")

    if cfg.predictor_noise > 0:
        f = _uniform(n, 1.0 - cfg.predictor_noise, 1.0 + cfg.predictor_noise,
                     g)
        p50, p90 = p50 * f, p90 * f

    if cfg.class_map == "paper2":
        cls = torch.where(bucket == SHORT, CLS_INTERACTIVE, CLS_HEAVY)
    elif cfg.class_map == "bucket4":
        cls = bucket
    else:
        cls = torch.randint(0, n_classes_of(cfg.class_map), (n,),
                            generator=g, device=gdev)
    jitter = _uniform(n, 0.95, 1.05, g)

    batch = RequestBatch(
        arrival_ms=arrival.float(),
        bucket=bucket,
        cls=cls.to(torch.int32),
        true_tokens=true_tokens.float(),
        p50=p50.float(),
        p90=p90.float(),
        deadline_budget_ms=DEADLINE_BUDGET_MS.to(gdev)[bucket.long()],
        valid=torch.ones((n,), dtype=torch.bool, device=gdev),
    )
    return to_device(batch, dev), jitter.to(dev)

