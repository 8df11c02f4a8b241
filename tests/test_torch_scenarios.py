"""The port's scenarios and provider dynamics against the JAX reference.

1. `scenarios.build` gives the reference's tensors bit for bit for every
   single-provider scenario of the registry (arrival schedule, brownout
   comfort scale, token-bucket refill, capacity and Retry-After, phase
   edges), as do `token_bucket_windows` and `brownout_schedule` on their
   own; `warp_arrivals` and `phase_index` equal the reference's on the
   same inputs.
2. The port's own generator keeps the reference's invariants: the
   trivial schedule gives the stationary batch bit for bit, a schedule
   that only shapes the rate keeps the bucket stream, a mix shift moves
   the bucket shares of its phase.
3. `run_sim` with dynamics on the reference's batch (N = 160, 4x the
   rate, 1,600 ticks: the arrival span and 800 ticks of drain): the
   decisions, statuses and throttle counts equal the reference's,
   finish times and severity within `FLOAT_TOL`, phase metrics within
   `METRIC_TOL` with NaN as NaN.  `storm` (phased arrivals, a brownout
   and a limiter) and `rate_crunch` (a refill that varies over time)
   run here, dense and windowed; the other eight single-provider
   scenarios without faults run dense in `test_torch_scenarios_dense.py`.
4. The port's dense and windowed engines agree bit for bit under
   dynamics; fleet scenarios build as the reference's (their engine
   parity is `test_torch_fleet.py`).

`FLOAT_TOL` is a few float32 ulps (atol for values near 0): the port
rounds some of the reference's contracted multiply-adds in two steps
and sums in float64 (ROADMAP queue C, C1 and C3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import strategy as ref_strategy
from repro.sim import scenarios as rscn
from repro.sim.engine import SimConfig as RefSimConfig
from repro.sim.engine import run_sim as ref_run_sim
from repro.sim.metrics import compute_phase_metrics as ref_phase_metrics
from repro.sim.provider import brownout_schedule as ref_brownout
from repro.sim.provider import default_physics as ref_physics
from repro.sim.provider import token_bucket_windows as ref_tb_windows
from repro.sim.workload import generate as ref_generate
from repro.sim.workload import phase_index as ref_phase_index
from repro.sim.workload import warp_arrivals as ref_warp
from repro_torch.bridge import from_numpy, to_numpy
from repro_torch.core.policy import kclass_policy, strategy
from repro_torch.core.types import COMPLETED, INFLIGHT, PENDING
from repro_torch.sim import (
    SimConfig,
    WorkloadConfig,
    compute_phase_metrics,
    default_physics,
    generate,
    run_scenario_cell,
    run_sim,
)
from repro_torch.sim import scenarios as scn
from repro_torch.sim.provider import (
    ProviderDynamics,
    brownout_schedule,
    load_multiplier,
    no_dynamics,
    service_time_ms,
    token_bucket_windows,
)
from repro_torch.sim.workload import phase_index, warp_arrivals

torch.set_num_threads(1)

FLOAT_TOL = dict(rtol=5e-7, atol=1e-6)
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
N, SCALE, T, B, W, DT = 160, 4.0, 1600, 4, 256, 25.0
SINGLE = [n for n in rscn.list_scenarios() if rscn.get_scenario(n).fleet
          is None]
ENGINE = [n for n in SINGLE if rscn.get_scenario(n).faults is None]
HERE = ["storm", "rate_crunch"]
FLEET = [n for n in rscn.list_scenarios() if n not in SINGLE]


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def bits_equal(got: torch.Tensor, want) -> bool:
    want = np.asarray(want).reshape(-1)
    got = got.numpy().reshape(-1)
    return (got.shape == want.shape and got.dtype == want.dtype
            and np.array_equal(got.view(np.uint8), want.view(np.uint8)))


# ---------------------------------------------------------------------------
# 1. the schedules, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,ticks,scale", [(N, T, SCALE),
                                           (100_000, 2000, 625.0),
                                           (48, 1000, 1.0)])
@pytest.mark.parametrize("name", SINGLE)
def test_build_is_bit_equal(name, n, ticks, scale):
    k = 4 if name == "rate_limited" else 2
    want = rscn.build(rscn.get_scenario(name), n, ticks, DT,
                      limiter_classes=k, arrival_scale=scale)
    got = scn.build(scn.get_scenario(name), n, ticks, DT,
                    limiter_classes=k, arrival_scale=scale)
    assert got[0]._asdict() == want[0]._asdict()
    for f in want[1]._fields:
        if f == "mix_varies":
            assert got[1].mix_varies is want[1].mix_varies
        else:
            assert bits_equal(getattr(got[1], f), getattr(want[1], f)), f
    if want[2] is None:
        assert got[2] is None
    else:
        for f in want[2]._fields:
            w, g = getattr(want[2], f), getattr(got[2], f)
            assert (g is None) == (w is None), f
            if w is not None:
                assert bits_equal(g.contiguous(), w), f
    assert bits_equal(got[3], want[3])


def test_registry_matches_reference():
    assert scn.list_scenarios() == rscn.list_scenarios()
    for name in rscn.list_scenarios():
        r, p = rscn.get_scenario(name), scn.get_scenario(name)
        assert tuple(p.phases) == tuple(r.phases)
        assert (p.brownouts, p.tb_rate_rps, p.tb_burst, p.retry_after_ms,
                p.tb_windows, p.has_dynamics, p.mix, p.congestion) == (
            r.brownouts, r.tb_rate_rps, r.tb_burst, r.retry_after_ms,
            r.tb_windows, r.has_dynamics, r.mix, r.congestion)
        assert (p.fleet is None) == (r.fleet is None)
        if r.fleet is not None:
            assert tuple(p.fleet) == tuple(r.fleet)
        assert (p.faults is None) == (r.faults is None)
        if r.fault_schedule is not None:
            assert tuple(p.fault_schedule) == tuple(r.fault_schedule)
    with pytest.raises(KeyError, match="unknown scenario"):
        scn.get_scenario("nope")


@pytest.mark.parametrize("windows", [((0.2, 0.5, 0.1),),
                                     ((0.1, 0.6, 0.5), (0.3, 0.4, 0.0)),
                                     ((1 / 3, 2 / 3, 0.1), (0.5, 0.9, 0.7))])
def test_token_bucket_windows_bit_equal(windows):
    args = (1700, 25.0, (1.2, 0.8, 3.0), 6.0)
    want = ref_tb_windows(*args, windows, 21333.7)
    got = token_bucket_windows(*args, windows, 21333.7)
    assert bits_equal(got[0], want[0]) and bits_equal(got[1], want[1])
    sched = tuple((a, b, s) for a, b, s in windows)
    assert bits_equal(brownout_schedule(1700, 25.0, sched, 21333.7),
                      ref_brownout(1700, 25.0, sched, 21333.7))


def test_negative_rate_mult_raises():
    for fn in (token_bucket_windows, ref_tb_windows):
        with pytest.raises(ValueError, match="rate_mult"):
            fn(10, 25.0, (1.0,), 6.0, ((0.1, 0.2, -0.5),), 100.0)


@pytest.mark.parametrize("name", ["burst_train", "diurnal", "storm",
                                  "flash_crowd", "balanced"])
def test_warp_and_phase_index_match_reference(name):
    want_sched = rscn.build_arrival_schedule(rscn.get_scenario(name), N,
                                             SCALE)
    got_sched = scn.build_arrival_schedule(scn.get_scenario(name), N, SCALE)
    rng = np.random.default_rng(5)
    span = float(want_sched.cum_work_ms[-1]) * 2.0 + 1.0
    work = np.sort(rng.uniform(0, span, 4000)).astype(np.float32)
    work[:3] = (0.0, float(want_sched.cum_work_ms[-1]), 1e7)
    want = ref_warp(jnp.asarray(work), want_sched)
    got = warp_arrivals(torch.from_numpy(work), got_sched)
    assert bits_equal(got, want)
    assert bits_equal(phase_index(got_sched, got),
                      ref_phase_index(want_sched, want))


def test_trivial_schedule_is_the_identity():
    sched = scn.build_arrival_schedule(scn.Scenario("x"), 48)
    work = torch.tensor([0.0, 17.3, 999.9, 1e6])
    assert torch.equal(warp_arrivals(work, sched), work)
    assert not sched.mix_varies


# ---------------------------------------------------------------------------
# 2. the port's generator under a schedule
# ---------------------------------------------------------------------------

def _gen(wl, sched=None, seed=3):
    return generate(wl, torch.Generator().manual_seed(seed), device="cpu",
                    sched=sched)


def test_trivial_schedule_gives_the_stationary_batch():
    wl_cfg, sched, dynamics, _ = scn.build(scn.get_scenario("balanced"), 48,
                                           T, DT)
    assert dynamics is None
    plain, j0 = _gen(WorkloadConfig(n_requests=48))
    shaped, j1 = _gen(wl_cfg, sched)
    for f in plain._fields:
        assert torch.equal(getattr(plain, f), getattr(shaped, f)), f
    assert torch.equal(j0, j1)


def test_rate_only_schedule_keeps_the_bucket_stream():
    wl = WorkloadConfig(n_requests=96)
    sc = scn.Scenario("r", phases=(scn.Phase(0.5, 0.5), scn.Phase(0.5, 1.5)))
    plain, _ = _gen(wl)
    shaped, _ = _gen(wl, scn.build_arrival_schedule(sc, 96))
    assert torch.equal(plain.bucket, shaped.bucket)
    assert torch.equal(plain.true_tokens, shaped.true_tokens)
    assert not torch.equal(plain.arrival_ms, shaped.arrival_ms)
    assert bool((shaped.arrival_ms[1:] >= shaped.arrival_ms[:-1]).all())


def test_mix_shift_moves_the_phase_buckets():
    sc = scn.get_scenario("heavy_shift")
    sched = scn.build_arrival_schedule(sc, 2048)
    b, _ = _gen(WorkloadConfig(n_requests=2048), sched, seed=1)
    edges = scn.phase_edges_ms(sc, 2048)
    a, bkt = b.arrival_ms, b.bucket
    mid = (a >= edges[1]) & (a < edges[2])
    out = (a < edges[1]) | ((a >= edges[2]) & (a < edges[3]))
    # heavy mix: 60% long/xlong against 25% under balanced
    assert float((bkt[mid] >= 2).float().mean()) > 0.45
    assert float((bkt[out] >= 2).float().mean()) < 0.35


# ---------------------------------------------------------------------------
# 3. the engine under dynamics, on the reference's batch
# ---------------------------------------------------------------------------

# one program for every scenario whose dynamics have the same structure
_ref_run = jax.jit(ref_run_sim, static_argnames=("sim_cfg",
                                                 "collect_decisions"))


@functools.lru_cache(maxsize=None)
def ref_scenario_run(name, window):
    wl_cfg, sched, dynamics, edges = rscn.build(
        rscn.get_scenario(name), N, T, DT, limiter_classes=2,
        arrival_scale=SCALE)
    batch, jitter = ref_generate(jax.random.PRNGKey(0), wl_cfg, sched)
    final, trace = _ref_run(
        ref_strategy("final_adrr_olc"), batch, jitter, ref_physics(),
        sim_cfg=RefSimConfig(n_ticks=T, k_slots=B, window=window),
        dynamics=dynamics, collect_decisions=True)
    pm = ref_phase_metrics(batch, final, edges, 2)
    return (np_tree(batch), np.asarray(jitter),
            None if dynamics is None else np_tree(dynamics),
            np.asarray(edges), np_tree(final), np_tree(trace), np_tree(pm))


@functools.lru_cache(maxsize=None)
def port_scenario_run(name, window):
    batch, jitter, dynamics, edges, _, _, _ = ref_scenario_run(name, window)
    pb = from_numpy(batch, "cpu")
    final, trace = run_sim(
        from_numpy(np_tree(ref_strategy("final_adrr_olc")), "cpu"), pb,
        from_numpy(jitter, "cpu"), from_numpy(np_tree(ref_physics()), "cpu"),
        SimConfig(n_ticks=T, k_slots=B, window=window,
                  ordering_backend="torch"),
        None if dynamics is None else from_numpy(dynamics, "cpu"),
        collect_decisions=True, device="cpu")
    pm = compute_phase_metrics(pb, final, torch.from_numpy(edges), 2)
    return to_numpy(final), to_numpy(trace), to_numpy(pm)


def check_against_reference(name, window):
    *_, rfin, (ra, ri, rs), rpm = ref_scenario_run(name, window)
    pfin, (pa, pi, ps), ppm = port_scenario_run(name, window)
    np.testing.assert_array_equal(pa, ra)
    live = ra >= 0
    assert live.sum() > N // 4
    np.testing.assert_array_equal(pi[live], ri[live])
    np.testing.assert_allclose(ps, rs, **FLOAT_TOL)
    for f in ("status", "n_defers", "n_throttles", "submit_ms"):
        np.testing.assert_array_equal(getattr(pfin.req, f),
                                      getattr(rfin.req, f), err_msg=f)
    np.testing.assert_allclose(pfin.req.finish_ms, rfin.req.finish_ms,
                               **FLOAT_TOL)
    np.testing.assert_allclose(pfin.req.defer_until, rfin.req.defer_until,
                               **FLOAT_TOL)
    assert int(pfin.provider.n_throttled) == int(rfin.provider.n_throttled)
    np.testing.assert_allclose(pfin.provider.tb_tokens,
                               rfin.provider.tb_tokens, **FLOAT_TOL)
    np.testing.assert_allclose(pfin.sched.deficit, rfin.sched.deficit,
                               **FLOAT_TOL)
    for f in rpm._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(ppm, f), np.float64),
            np.asarray(getattr(rpm, f), np.float64),
            err_msg=f, equal_nan=True, **METRIC_TOL)
    status = pfin.req.status
    assert not ((status == PENDING) | (status == INFLIGHT)).any()
    return rfin


@pytest.mark.parametrize("window", [None, W])
@pytest.mark.parametrize("name", HERE)
def test_dynamics_match_reference(name, window):
    rfin = check_against_reference(name, window)
    assert int(rfin.provider.n_throttled) > 0  # the limiter bit


@pytest.mark.parametrize("name", HERE)
def test_windowed_equals_dense_bit_for_bit(name):
    dfin, dtr, dpm = port_scenario_run(name, None)
    wfin, wtr, wpm = port_scenario_run(name, W)
    np.testing.assert_array_equal(dtr[0], wtr[0])
    np.testing.assert_array_equal(dtr[2], wtr[2])
    live = dtr[0] >= 0
    np.testing.assert_array_equal(dtr[1][live], wtr[1][live])
    for part in ("req", "sched"):
        for f, a, b in zip(getattr(dfin, part)._fields, getattr(dfin, part),
                           getattr(wfin, part)):
            np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("tb_tokens", "n_throttled", "inflight"):
        np.testing.assert_array_equal(getattr(dfin.provider, f),
                                      getattr(wfin.provider, f), err_msg=f)
    for f in dpm._fields:
        np.testing.assert_array_equal(getattr(dpm, f), getattr(wpm, f),
                                      err_msg=f)


# ---------------------------------------------------------------------------
# 4. the rest of the surface
# ---------------------------------------------------------------------------

def test_brownout_slows_service_and_none_keeps_bits():
    phys = default_physics()
    infl = torch.arange(0, 12, dtype=torch.int32)
    tok = torch.full((12,), 300.0)
    jit = torch.ones(12)
    base = service_time_ms(phys, tok, infl, jit)
    assert torch.equal(load_multiplier(phys, infl, None),
                       load_multiplier(phys, infl))
    assert torch.equal(service_time_ms(phys, tok, infl, jit, None), base)
    assert torch.equal(service_time_ms(phys, tok, infl, jit,
                                       torch.tensor(1.0)), base)
    slow = service_time_ms(phys, tok, infl, jit, torch.tensor(0.4))
    assert bool((slow >= base).all()) and bool((slow[3:] > base[3:]).all())


def test_empty_phase_gives_nan():
    wl = WorkloadConfig(n_requests=24, congestion="high")
    batch, jitter = _gen(wl)
    final = run_sim(strategy("final_adrr_olc"), batch, jitter,
                    default_physics(), SimConfig(n_ticks=200), device="cpu")
    last = float(batch.arrival_ms.max())
    edges = torch.tensor([0.0, last + 1.0, last + 2.0, last + 3.0])
    pm = compute_phase_metrics(batch, final, edges, 2)
    assert pm.n_arrived.tolist()[1:] == [0, 0]
    assert torch.isnan(pm.p95_ms[1:]).all()
    assert torch.isnan(pm.class_p95_ms[1:]).all()
    assert torch.equal(pm.satisfaction[1:], torch.zeros(2))
    assert int(pm.n_arrived[0]) == 24


def test_run_scenario_cell_on_the_cpu():
    m, pm = run_scenario_cell(strategy("final_adrr_olc"), "storm", seeds=2,
                              n_requests=48, arrival_scale=SCALE,
                              sim_cfg=SimConfig(n_ticks=450, window=64),
                              device="cpu")
    assert m.completion_rate.shape == (2,)
    assert pm.n_arrived.shape == (2, 3)
    assert pm.n_arrived.sum(dim=1).tolist() == [48, 48]
    assert pm.class_p95_ms.shape == (2, 3, 2)
    assert int(pm.n_throttled.sum()) > 0
    # same seeds, same cell: the dense engine gives the same metrics
    md, pmd = run_scenario_cell(strategy("final_adrr_olc"), "storm",
                                seeds=2, n_requests=48, arrival_scale=SCALE,
                                sim_cfg=SimConfig(n_ticks=450),
                                device="cpu")
    for a, b in zip((*m, *pm), (*md, *pmd)):
        assert torch.equal(torch.nan_to_num(a, nan=-1.0),
                           torch.nan_to_num(b, nan=-1.0))


def test_run_scenario_cell_sizes_buckets_by_policy_and_refuses_lanes():
    with pytest.raises(ValueError, match="kclass_policy"):
        run_scenario_cell(strategy("final_adrr_olc"), "rate_limited",
                          seeds=1, n_requests=8, class_map="bucket4",
                          sim_cfg=SimConfig(n_ticks=5), device="cpu")
    m, pm = run_scenario_cell(kclass_policy(4), "rate_limited", seeds=1,
                              n_requests=16, arrival_scale=SCALE,
                              sim_cfg=SimConfig(n_ticks=300), device="cpu")
    assert pm.class_satisfaction.shape == (1, 4, 4)


@pytest.mark.parametrize("name", FLEET)
def test_fleet_scenarios_raise(name):
    """A fleet scenario builds as in the reference (it raised before the
    fleet axis was ported; the name is kept): `build` gives no provider
    dynamics and the reference's arrival schedule and phase edges bit
    for bit, `build_fleet` the reference's fleet bit for bit, and
    `run_scenario_cell` runs it."""
    sc, rsc = scn.get_scenario(name), rscn.get_scenario(name)
    got = scn.build(sc, N, T, DT, limiter_classes=2, arrival_scale=SCALE)
    want = rscn.build(rsc, N, T, DT, limiter_classes=2, arrival_scale=SCALE)
    assert got[2] is None and want[2] is None
    assert got[0]._asdict() == want[0]._asdict()
    for f in want[1]._fields:
        if f != "mix_varies":
            assert bits_equal(getattr(got[1], f), getattr(want[1], f)), f
    assert bits_equal(got[3], want[3])
    gf = scn.build_fleet(sc, default_physics(), T, DT, N, 2, SCALE)
    wf = rscn.build_fleet(rsc, ref_physics(), T, DT, N, 2, SCALE)
    for part in ("phys", "dyn"):
        for f in getattr(wf, part)._fields:
            w, g = getattr(getattr(wf, part), f), getattr(getattr(gf, part),
                                                          f)
            assert (g is None) == (w is None), f
            if w is not None:
                assert bits_equal(g.contiguous(), w), f
    m, pm = run_scenario_cell(strategy("final_adrr_olc"), name, seeds=1,
                              n_requests=24, arrival_scale=SCALE,
                              sim_cfg=SimConfig(n_ticks=300, window=32),
                              device="cpu")
    assert pm.n_arrived.sum().item() == 24
    assert float(m.completion_rate[0]) > 0.3
    assert scn.build_fleet(scn.get_scenario("storm"), default_physics(), T,
                           DT, N, 2) is None


def test_no_dynamics_runs_the_stationary_engine():
    wl = WorkloadConfig(n_requests=32, congestion="high")
    batch, jitter = _gen(wl)
    cfg = SimConfig(n_ticks=300)
    a = run_sim(strategy("final_adrr_olc"), batch, jitter, default_physics(),
                cfg, device="cpu")
    b = run_sim(strategy("final_adrr_olc"), batch, jitter, default_physics(),
                cfg, no_dynamics(), device="cpu")
    for x, y in zip(a.req, b.req):
        # the fleet's `endpoint` field is None on both single-provider runs
        assert (x is None and y is None) or torch.equal(x, y)
    assert isinstance(no_dynamics(), ProviderDynamics)
    assert int((a.req.status == COMPLETED).sum()) > 0
