"""The port's fleet routing layer against the JAX reference.

1. `core/routing.route_requests` alone, on the same numpy inputs as the
   reference's jitted function: load balance, a down endpoint, the whole
   fleet down (the finite `UNAVAIL_MS`), the 429 pressure, a brownout
   row, P = 1, ties, and the wide case (P = 4, N = 4096, skewed speeds,
   uneven inflight, the limiter's pressure on).  Endpoints are equal,
   and so are the route's bits: the port rounds the cost's two
   multiply-adds once each (`numerics.fma32`), as the reference's
   compiled program contracts them.
2. The same inside the reference's `run_sim` scan, dense and windowed:
   every tick's (endpoint, route) that the reference's routing pass
   produced, read out of its scan, equals the port's `route_requests`
   on that tick's inputs, bit for bit.
3. The route term in the ordering layer: `order_scores` within
   `FLOAT_TOL`, and `select_top_b` and `schedule_batch` (with
   `provider_idx`) equal to the reference's on both backends.
4. The fleet schedules: `availability_schedule`,
   `fleet_brownout_schedule`, `uniform_fleet_physics` and `build_fleet`
   on the three registry fleet scenarios, bit for bit at three sizes.
5. A skewed fleet prefers its fast endpoint, with the reference's
   endpoints; `run_scenario_cell` on `fleet_skew` gives the reference's
   metrics on the reference's draws.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ordering as rordering
from repro.core import policy as rpolicy
from repro.core import routing as rrouting
from repro.core.scheduler import schedule_batch as ref_schedule_batch
from repro.core.types import init_fleet_state as ref_init_fleet_state
from repro.sim import engine as rengine
from repro.sim import runner as rrunner
from repro.sim import scenarios as rscn
from repro.sim.engine import SimConfig as RefSimConfig
from repro.sim.engine import run_sim as ref_run_sim
from repro.sim.provider import Fleet as RefFleet
from repro.sim.provider import FleetDynamics as RefFleetDynamics
from repro.sim.provider import availability_schedule as ref_avail
from repro.sim.provider import default_physics as ref_physics
from repro.sim.provider import fleet_brownout_schedule as ref_fleet_brownout
from repro.sim.provider import uniform_fleet_physics as ref_uniform
from repro.sim.workload import WorkloadConfig as RefWorkloadConfig
from repro.sim.workload import generate as ref_generate
from repro_torch.bridge import from_numpy, to_numpy
from repro_torch.core import ordering
from repro_torch.core.routing import UNAVAIL_MS, route_requests
from repro_torch.core.scheduler import IDLE, schedule_batch
from repro_torch.core.types import COMPLETED, init_fleet_state
from repro_torch.sim import (
    SimConfig,
    availability_schedule,
    default_physics,
    fleet_brownout_schedule,
    run_scenario_cell,
    run_sim,
    uniform_fleet_physics,
)
from repro_torch.sim import runner
from repro_torch.sim import scenarios as scn
from test_torch_core import jnp_tree, mk_batch, mk_state, np_tree, port

torch.set_num_threads(1)

FLOAT_TOL = dict(rtol=5e-7, atol=1e-6)
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
CPU = torch.device("cpu")
FLEET = ["fleet_brownout", "fleet_failover", "fleet_skew"]


def bits(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.uint8)


def bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(bits(a), bits(b)))


# ---------------------------------------------------------------------------
# 1. route_requests alone
# ---------------------------------------------------------------------------

_ref_route = jax.jit(rrouting.route_requests)


def route_case(name):
    """(p, speed_mult, comfort_mult, inflight, tb_tokens, n, comfort_t,
    avail_t, retry) of one case; numpy leaves from a seed."""
    rng = np.random.default_rng(sum(map(ord, name)))
    p50 = lambda n: rng.uniform(1.0, 2500.0, n).astype(np.float32)  # noqa
    tb = lambda p: np.full((p, 2), 4.0, np.float32)                 # noqa
    if name == "load_balance":
        return 3, None, None, [8, 0, 0], tb(3), np.full(5, 200.0,
                                                           np.float32), \
            None, None, None
    if name == "down":
        return 3, None, None, [8, 0, 0], tb(3), np.full(5, 200.0,
                                                           np.float32), \
            None, [1.0, 0.0, 1.0], None
    if name == "all_down":
        return 4, (0.5, 1.0, 1.0, 2.0), None, [3, 7, 1, 12], tb(4), \
            p50(64), None, [0.0] * 4, 1500.0
    if name == "pressure":
        dry = np.asarray([[0.2, 5.0], [0.0, 0.9], [3.0, 3.0], [1.0, 0.99]],
                         np.float32)
        return 4, None, None, [2, 1, 4, 0], dry, p50(256), None, None, \
            1500.0
    if name == "brownout":
        return 4, None, (1.0, 0.5, 2.0, 1.0), [5, 5, 5, 5], tb(4), \
            p50(256), [1.0, 0.3, 1.0, 0.4], None, None
    if name == "p1":
        return 1, None, None, [6], tb(1), p50(128), [0.5], [1.0], 1500.0
    if name == "ties":
        return 4, None, None, [0, 0, 0, 0], tb(4), p50(32), None, None, None
    # the wide case: skewed speeds, uneven load, pressure on
    assert name == "wide"
    return 4, (0.5, 1.0, 1.0, 2.0), None, [3, 7, 1, 12], \
        rng.uniform(0.0, 3.0, (4, 2)).astype(np.float32), p50(4096), \
        [1.0, 0.3, 1.0, 1.0], [1.0, 1.0, 0.0, 1.0], 1500.0


def both_routes(name):
    p, speed, comfort, infl, tb, p50, comfort_t, avail_t, retry = \
        route_case(name)
    infl = np.asarray(infl, np.int32)
    f32 = (lambda x: None if x is None else np.asarray(x, np.float32))
    comfort_t, avail_t, retry = f32(comfort_t), f32(avail_t), f32(retry)
    rphys = ref_uniform(ref_physics(), p, speed, comfort)
    rstate = ref_init_fleet_state(p, 2)._replace(
        inflight=jnp.asarray(infl), tb_tokens=jnp.asarray(tb))
    opt = (lambda x: None if x is None else jnp.asarray(x))
    want = np_tree(_ref_route(rphys, rstate, jnp.asarray(p50),
                              opt(comfort_t), opt(avail_t), opt(retry)))
    pphys = uniform_fleet_physics(default_physics(), p, speed, comfort)
    pstate = init_fleet_state(p, 2, CPU)._replace(
        inflight=torch.from_numpy(infl), tb_tokens=torch.from_numpy(tb))
    tt = (lambda x: None if x is None else torch.from_numpy(x))
    got = to_numpy(route_requests(pphys, pstate, torch.from_numpy(p50),
                                  tt(comfort_t), tt(avail_t), tt(retry)))
    return got, want


@pytest.mark.parametrize("name", ["load_balance", "down", "all_down",
                                  "pressure", "brownout", "p1", "ties",
                                  "wide"])
def test_route_requests_matches_reference(name):
    (pe, pr), (re_, rr) = both_routes(name)
    assert pe.dtype == np.int32 and pr.dtype == np.float32
    np.testing.assert_array_equal(pe, re_)
    assert bits_equal(pr, rr), np.abs(pr - rr).max()
    if name == "load_balance":
        # the loaded endpoint 0 loses; the two idle ones tie, low wins
        assert (pe == 1).all() and (pr > 0).all()
        assert (pr < UNAVAIL_MS * 1e-3).all()
    elif name == "down":
        assert (pe == 2).all()
    elif name == "all_down":
        # every cost is the finite penalty: endpoint 0, a finite route
        assert (pe == 0).all() and np.isfinite(pr).all()
        assert np.all(pr == np.float32(UNAVAIL_MS) * np.float32(1e-3))
    elif name in ("p1", "ties"):
        assert (pe == 0).all()
    elif name == "wide":
        assert set(np.unique(pe)) <= {0, 1, 3} and (pe != 2).all()
        assert len(np.unique(pe)) >= 2


def test_route_requests_is_the_reference_formula():
    """The wide case's route against the formula in float64 with the two
    multiply-adds rounded once each: the port's rounding is a model of
    the reference's, not a coincidence of one input."""
    p, speed, _, infl, tb, p50, comfort_t, avail_t, retry = \
        route_case("wide")
    (pe, pr), _ = both_routes("wide")
    phys = uniform_fleet_physics(default_physics(), p, speed)
    comfort = (phys.comfort_concurrency.numpy()
               * np.asarray(comfort_t, np.float32))
    load = (np.asarray(infl, np.float32) / np.maximum(comfort, 1.0)).astype(
        np.float32)
    pen = np.float32(retry) * (tb < 1.0).mean(axis=1).astype(np.float32)
    f64 = np.float64
    unl = (phys.ms_per_token.numpy()[:, None].astype(f64) * p50[None, :]
           + phys.base_ms.numpy()[:, None]).astype(np.float32)
    cost = (unl.astype(f64) * (np.float32(1.0) + load)[:, None]
            + pen[:, None]).astype(np.float32)
    cost[np.asarray(avail_t) < 0.5] = np.float32(UNAVAIL_MS)
    np.testing.assert_array_equal(pe, np.argmin(cost, axis=0))
    assert bits_equal(pr, cost.min(axis=0) * np.float32(1e-3))


# ---------------------------------------------------------------------------
# 2. the routes the reference's run_sim scan produced
# ---------------------------------------------------------------------------

def all_on_fleet(t, p=4, k=2, span_ticks=800):
    """A fleet with every mechanism on, as numpy: skewed speeds, endpoint
    0 down over 0.35-0.65 of an arrival span of `span_ticks`, a 0.3
    brownout on endpoint 1 over 0.5-0.85, and a per-endpoint bucket of
    0.4 grant/s, burst 6."""
    span = span_ticks * 25.0
    avail = np.asarray(ref_avail(t, 25.0, ((0, 0.35, 0.65),), span, p))
    comfort = np.asarray(ref_fleet_brownout(t, 25.0, ((1, 0.5, 0.85, 0.3),),
                                            span, p))
    refill = np.full((t, p, k), np.float32(0.4 * 25.0 / 1000.0), np.float32)
    cap = np.full((p, k), 6.0, np.float32)
    phys = np_tree(ref_uniform(ref_physics(), p, (0.5, 1.0, 1.0, 2.0)))
    return RefFleet(phys, RefFleetDynamics(
        avail=avail, comfort_scale=comfort, tb_refill=refill,
        tb_capacity=cap, retry_after_ms=np.float32(1500.0)))


SCAN_N, SCAN_T, SCAN_SCALE = 160, 1000, 4.0


@functools.lru_cache(maxsize=None)
def scanned_routes(window):
    """Every tick's routing inputs and outputs, read out of the
    reference's jitted run_sim through a debug callback."""
    rows = []

    def record(*xs):
        rows.append(tuple(np.array(x) for x in xs))

    orig = rrouting.route_requests

    def spy(fphys, fleet, p50, comfort_t=None, avail_t=None,
            retry_after_ms=None):
        ep, route = orig(fphys, fleet, p50, comfort_t, avail_t,
                         retry_after_ms)
        jax.debug.callback(record, fleet.inflight, fleet.tb_tokens, p50,
                           comfort_t, avail_t, ep, route, ordered=True)
        return ep, route

    wl = RefWorkloadConfig(n_requests=SCAN_N, congestion="high",
                           arrival_scale=SCAN_SCALE)
    batch, jitter = ref_generate(jax.random.PRNGKey(0), wl)
    fleet = all_on_fleet(SCAN_T)
    mp = pytest.MonkeyPatch()
    mp.setattr(rengine, "route_requests", spy)
    try:
        final = jax.jit(lambda: ref_run_sim(
            rpolicy.strategy("final_adrr_olc"), batch, jitter,
            ref_physics(), RefSimConfig(n_ticks=SCAN_T, k_slots=4,
                                        window=window),
            fleet=jax.tree.map(jnp.asarray, fleet)))()
        jax.block_until_ready(final)
    finally:
        mp.undo()
    return rows, fleet


@pytest.mark.parametrize("window", [None, 256])
def test_routes_inside_the_reference_scan(window):
    rows, fleet = scanned_routes(window)
    assert len(rows) == SCAN_T
    pphys = from_numpy(fleet.phys, "cpu")
    retry = torch.tensor(1500.0)
    n_routed = 0
    for t, (infl, tb, p50, comfort_t, avail_t, ep, route) in enumerate(rows):
        state = init_fleet_state(4, 2, CPU)._replace(
            inflight=torch.from_numpy(infl), tb_tokens=torch.from_numpy(tb))
        pe, pr = route_requests(pphys, state, torch.from_numpy(p50),
                                torch.from_numpy(comfort_t),
                                torch.from_numpy(avail_t), retry)
        np.testing.assert_array_equal(pe.numpy(), ep, err_msg=f"tick {t}")
        assert bits_equal(pr.numpy(), route), f"tick {t}"
        n_routed += int((infl > 0).any())
    # the routes were made under load, across the fail window
    assert n_routed > SCAN_T // 4
    assert (np.asarray(fleet.dyn.avail)[:, 0] == 0).any()


# ---------------------------------------------------------------------------
# 3. the route term in ordering and dispatch
# ---------------------------------------------------------------------------

def _route(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.05, 40.0, n).astype(np.float32)


def test_order_scores_with_route():
    rcfg = rpolicy.base_policy()._replace(ord_w_route=jnp.float32(0.7))
    batch, route = mk_batch(300, seed=21), _route(300, 22)
    want = rordering.order_scores(jnp_tree(batch), jnp.float32(3e3), rcfg,
                                  jnp.asarray(route))
    got = ordering.order_scores(from_numpy(batch, "cpu"), torch.tensor(3e3),
                                port(rcfg), torch.from_numpy(route))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLOAT_TOL)
    plain = ordering.order_scores(from_numpy(batch, "cpu"),
                                  torch.tensor(3e3), port(rcfg))
    assert (got < plain).all()


@pytest.mark.parametrize("backends", [("jnp", "torch"), ("pallas", "kernel")])
@pytest.mark.parametrize("b", [1, 8])
def test_select_top_b_with_route(backends, b):
    rb, pb = backends
    rcfg = rpolicy.base_policy()
    batch, route = mk_batch(200, seed=31), _route(200, 32)
    rng = np.random.default_rng(33)
    elig = rng.uniform(size=200) < 0.7
    kn = (batch.cls[None, :] == np.arange(2)[:, None]) & elig[None, :]
    ri, rn = rordering.select_top_b(jnp_tree(batch), jnp.asarray(kn),
                                    jnp.float32(4e3), rcfg, b, backend=rb,
                                    route=jnp.asarray(route))
    pi, pn = ordering.select_top_b(
        from_numpy(batch, "cpu"), torch.from_numpy(kn), torch.tensor(4e3),
        port(rcfg), b, backend=pb, route=torch.from_numpy(route))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(rn))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    # the route moves the scored class's ranking, and FIFO's not at all
    plain, _ = ordering.select_top_b(
        from_numpy(batch, "cpu"), torch.from_numpy(kn), torch.tensor(4e3),
        port(rcfg), 8, backend=pb)
    routed, _ = ordering.select_top_b(
        from_numpy(batch, "cpu"), torch.from_numpy(kn), torch.tensor(4e3),
        port(rcfg), 8, backend=pb, route=torch.from_numpy(route))
    assert torch.equal(plain[0], routed[0])
    assert not torch.equal(plain[1], routed[1])


_ref_batch = jax.jit(ref_schedule_batch,
                     static_argnames=("max_grants", "backend"))


@pytest.mark.parametrize("backends", [("jnp", "torch"), ("pallas", "kernel")])
def test_schedule_batch_with_route_and_endpoint(backends):
    rb, pb = backends
    rcfg = rpolicy.strategy("final_adrr_olc")
    batch, state = mk_batch(48, seed=41), mk_state(48, 2, 42)
    route = _route(48, 43)
    endpoint = np.random.default_rng(44).integers(0, 4, 48).astype(np.int32)
    r = np_tree(_ref_batch(rcfg, jnp_tree(batch), jnp_tree(state),
                           max_grants=4, backend=rb,
                           route=jnp.asarray(route),
                           endpoint=jnp.asarray(endpoint)))
    p = to_numpy(schedule_batch(
        port(rcfg), from_numpy(batch, "cpu"), from_numpy(state, "cpu"),
        max_grants=4, backend=pb, route=torch.from_numpy(route),
        endpoint=torch.from_numpy(endpoint)))
    np.testing.assert_array_equal(p.actions, r.actions)
    live = r.actions != IDLE
    assert live.any()
    np.testing.assert_array_equal(p.req_idx[live], r.req_idx[live])
    np.testing.assert_array_equal(p.provider_idx[live], r.provider_idx[live])
    np.testing.assert_array_equal(p.provider_idx[live],
                                  endpoint[p.req_idx[live]])
    plain = schedule_batch(port(rcfg), from_numpy(batch, "cpu"),
                           from_numpy(state, "cpu"), max_grants=4,
                           backend=pb)
    assert plain.provider_idx is None


# ---------------------------------------------------------------------------
# 4. the fleet schedules, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("windows", [((0, 0.35, 0.65),),
                                     ((0, 0.1, 0.5), (2, 0.3, 0.9),
                                      (0, 0.4, 0.6))])
def test_availability_and_brownout_schedules(windows):
    args = (1700, 25.0)
    want = ref_avail(*args, windows, 21333.7, 3)
    got = availability_schedule(*args, windows, 21333.7, 3)
    assert bits_equal(got.numpy(), want)
    bw = tuple((ep, a, b, 0.3 + 0.2 * i)
               for i, (ep, a, b) in enumerate(windows))
    assert bits_equal(fleet_brownout_schedule(*args, bw, 21333.7, 3).numpy(),
                      ref_fleet_brownout(*args, bw, 21333.7, 3))


def fleet_bits_equal(got, want):
    for part in ("phys", "dyn"):
        for f in getattr(want, part)._fields:
            w, g = getattr(getattr(want, part), f), getattr(
                getattr(got, part), f)
            assert (g is None) == (w is None), f
            if w is not None:
                assert bits_equal(g.contiguous().numpy(), w), f


@pytest.mark.parametrize("n,ticks,scale", [(160, 1604, 4.0),
                                           (100_000, 2000, 625.0),
                                           (96, 3000, 1.0)])
@pytest.mark.parametrize("name", FLEET)
def test_build_fleet_is_bit_equal(name, n, ticks, scale):
    rsc, sc = rscn.get_scenario(name), scn.get_scenario(name)
    for k in (2, 4):
        want = rscn.build_fleet(rsc, ref_physics(), ticks, 25.0, n, k, scale)
        got = scn.build_fleet(sc, default_physics(), ticks, 25.0, n, k,
                              scale)
        fleet_bits_equal(got, want)
    wide = rsc._replace(fleet=rsc.fleet._replace(tb_rate_rps=0.4))
    fleet_bits_equal(
        scn.build_fleet(sc._replace(fleet=sc.fleet._replace(
            tb_rate_rps=0.4)), default_physics(), ticks, 25.0, n, 2, scale),
        rscn.build_fleet(wide, ref_physics(), ticks, 25.0, n, 2, scale))


# ---------------------------------------------------------------------------
# 5. routing on whole runs
# ---------------------------------------------------------------------------

def test_skew_prefers_fast_endpoints():
    """speed_mult (0.5, 1, 1, 2): the fast endpoint completes the most,
    the 2x-slow one the least, with the reference's endpoints."""
    wl = RefWorkloadConfig(n_requests=160, mix="heavy", congestion="high",
                           arrival_scale=8.0)
    batch, jitter = ref_generate(jax.random.PRNGKey(6), wl)
    rfleet = RefFleet(ref_uniform(ref_physics(), 4, (0.5, 1.0, 1.0, 2.0)),
                      RefFleetDynamics(None, None, None, None,
                                       jnp.float32(1500.0)))
    pol = rpolicy.strategy("final_adrr_olc")
    t = 1000
    rfin = np_tree(jax.jit(lambda: ref_run_sim(
        pol, batch, jitter, ref_physics(),
        RefSimConfig(n_ticks=t, k_slots=4), fleet=rfleet))())
    pfin = to_numpy(run_sim(
        port(pol), port(batch), port(jitter), port(ref_physics()),
        SimConfig(n_ticks=t, k_slots=4, ordering_backend="torch"),
        fleet=port(rfleet), device="cpu"))
    np.testing.assert_array_equal(pfin.req.status, rfin.req.status)
    np.testing.assert_array_equal(pfin.req.endpoint, rfin.req.endpoint)
    done = pfin.req.status == COMPLETED
    counts = np.bincount(pfin.req.endpoint[done], minlength=4)
    assert counts.sum() > 50
    assert counts[0] > counts[3] and counts[0] == counts.max()


def test_run_scenario_cell_fleet_skew_matches_reference(monkeypatch):
    """`fleet_skew` through both packages' `run_scenario_cell`, the port
    fed the reference's draws of each seed."""
    n, scale, seeds = 96, 4.0, 2
    rcfg = RefSimConfig(n_ticks=900, k_slots=4)
    rm, rpm = np_tree(rrunner.run_scenario_cell(
        rpolicy.base_policy(), "fleet_skew", seeds=seeds, n_requests=n,
        sim_cfg=rcfg, arrival_scale=scale))
    wl_cfg, sched, _, _ = rscn.build(rscn.get_scenario("fleet_skew"), n,
                                     rcfg.n_ticks, rcfg.dt_ms,
                                     arrival_scale=scale)
    draws = [np_tree(ref_generate(jax.random.PRNGKey(s), wl_cfg, sched))
             for s in range(seeds)]

    def ref_draw(wl, gen, device, sched=None):
        batch, jitter = draws.pop(0)
        return from_numpy(batch, device), from_numpy(jitter, device)

    monkeypatch.setattr(runner, "generate", ref_draw)
    pm, ppm = to_numpy(run_scenario_cell(
        port(rpolicy.base_policy()), "fleet_skew", seeds=seeds,
        n_requests=n, arrival_scale=scale,
        sim_cfg=SimConfig(n_ticks=900, k_slots=4, ordering_backend="torch"),
        device="cpu"))
    assert not draws
    for got, want in ((pm, rm), (ppm, rpm)):
        for f in want._fields:
            np.testing.assert_allclose(
                np.asarray(getattr(got, f), np.float64),
                np.asarray(getattr(want, f), np.float64), err_msg=f,
                equal_nan=True, **METRIC_TOL)
    assert float(np.nanmean(pm.completion_rate)) > 0.3
