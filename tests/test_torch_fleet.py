"""The port's fleet engine against the JAX reference.

The cases of the reference's `tests/test_fleet.py`, on the reference's
draws (numpy through `repro_torch.bridge`), offered at a higher rate so
that their traffic lands inside short horizons:

1. P = 1 transparency: a one-endpoint fleet is the single-provider run
   bit for bit on the port (decisions, severity, every request field,
   the scheduler's floats), dense at seeds 0 and 1 and windowed, and it
   equals the reference's one-endpoint fleet.
2. P = 4: a uniform fleet, endpoint 0 failing with its in-flight work
   requeued, a starved per-endpoint bucket, and a fleet with every
   mechanism on (skewed speeds, a failure, a brownout, the bucket grid).
   The port's dense engine equals the reference's: actions, request
   indices, statuses, defers, throttles, submit times, endpoints and the
   integer `FleetState` (inflight, requeues, bounces) exactly; severity,
   finish times, defers' ends, bucket levels and deficits within
   `FLOAT_TOL`.  The port's windowed engine equals its dense one bit for
   bit.

`FLOAT_TOL` is a few float32 ulps (atol for values near 0): the port
rounds some of the reference's contracted multiply-adds in two steps and
sums in float64 (ROADMAP queue C, C1 and C3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as rpolicy
from repro.sim.engine import SimConfig as RefSimConfig
from repro.sim.engine import run_sim as ref_run_sim
from repro.sim.provider import Fleet as RefFleet
from repro.sim.provider import FleetDynamics as RefFleetDynamics
from repro.sim.provider import default_physics as ref_physics
from repro.sim.provider import uniform_fleet_physics as ref_uniform
from repro.sim.workload import WorkloadConfig as RefWorkloadConfig
from repro.sim.workload import generate as ref_generate
from repro_torch.core.types import (
    ABANDONED,
    COMPLETED,
    INFLIGHT,
    PENDING,
    REJECTED,
)
from repro_torch.bridge import from_numpy, to_numpy
from repro_torch.sim import SimConfig, run_sim
from test_torch_routing import all_on_fleet

torch.set_num_threads(1)

FLOAT_TOL = dict(rtol=5e-7, atol=1e-6)
REQ_FIELDS = ("status", "submit_ms", "finish_ms", "defer_until",
              "n_defers", "n_throttles")
EXACT = ("status", "n_defers", "n_throttles", "submit_ms", "endpoint")
B = 4


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def mk_fleet(p, speed_mult=None, avail=None, tb_refill=None,
             tb_capacity=None):
    """The reference test's fleet helper, as numpy."""
    return np_tree(RefFleet(
        ref_uniform(ref_physics(), p, speed_mult=speed_mult),
        RefFleetDynamics(avail=avail, comfort_scale=None,
                         tb_refill=tb_refill, tb_capacity=tb_capacity,
                         retry_after_ms=jnp.float32(1500.0))))


def _fleet(case, t):
    if case == "p1":
        return mk_fleet(1)
    if case == "uniform":
        return mk_fleet(4)
    if case == "failover":
        avail = np.ones((t, 4), np.float32)
        avail[DOWN[0]:DOWN[1], 0] = 0.0
        return mk_fleet(4, avail=avail)
    if case == "bucket":
        return mk_fleet(4, tb_refill=np.full((t, 4, 2), 0.001, np.float32),
                        tb_capacity=np.full((4, 2), 1.0, np.float32))
    assert case == "all_on"
    return all_on_fleet(t, span_ticks=400)


# case -> (seed, workload overrides, ticks).  Offered at a higher rate
# so the arrivals land in 400-570 ticks: heavy/high at 8x, the P = 4
# cases' balanced/high at 6x (1.8x the four endpoints' comfort, as the
# rate is one provider's); endpoint 0 is down over ticks DOWN.
HEAVY = dict(n_requests=96, mix="heavy", congestion="high",
             arrival_scale=8.0)
FLEET4 = dict(n_requests=120, mix="balanced", congestion="high",
              arrival_scale=6.0)
DOWN = (100, 300)
CASES = {
    "p1": (None, HEAVY, 700),
    "uniform": (3, FLEET4, 600),
    "failover": (4, FLEET4, 600),
    "bucket": (5, FLEET4, 600),
    "all_on": (0, FLEET4, 600),
}


@functools.lru_cache(maxsize=None)
def draws(seed, wl_items):
    batch, jitter = ref_generate(jax.random.PRNGKey(seed),
                                 RefWorkloadConfig(**dict(wl_items)))
    return np_tree(batch), np.asarray(jitter)


_ref_run = jax.jit(ref_run_sim, static_argnames=("sim_cfg",
                                                 "collect_decisions"))
POLICY = np_tree(rpolicy.strategy("final_adrr_olc"))


def ref_run(batch, jitter, t, window, fleet):
    return np_tree(_ref_run(
        POLICY, batch, jitter, ref_physics(),
        sim_cfg=RefSimConfig(n_ticks=t, k_slots=B, window=window),
        collect_decisions=True, fleet=fleet))


def port_run(batch, jitter, t, window, fleet):
    out = run_sim(
        from_numpy(POLICY, "cpu"), from_numpy(batch, "cpu"),
        from_numpy(jitter, "cpu"), from_numpy(np_tree(ref_physics()), "cpu"),
        SimConfig(n_ticks=t, k_slots=B, window=window,
                  ordering_backend="torch"),
        fleet=None if fleet is None else from_numpy(fleet, "cpu"),
        collect_decisions=True, device="cpu")
    return to_numpy(out)


def assert_bit_equal(a, b, *, endpoint=True):
    """Two (final, trace) port runs agree bit for bit."""
    (fa, ta), (fb, tb) = a, b
    np.testing.assert_array_equal(ta[0], tb[0])
    live = ta[0] >= 0
    np.testing.assert_array_equal(ta[1][live], tb[1][live])
    assert ta[2].tobytes() == tb[2].tobytes()
    fields = REQ_FIELDS + (("endpoint",) if endpoint else ())
    for f in fields:
        assert getattr(fa.req, f).tobytes() == getattr(fb.req, f).tobytes(), f
    for f in fa.sched._fields:
        assert getattr(fa.sched, f).tobytes() == \
            getattr(fb.sched, f).tobytes(), f
    if fa.fleet is not None and fb.fleet is not None:
        for f in ("inflight", "tb_tokens", "n_throttled", "n_requeued"):
            assert getattr(fa.fleet, f).tobytes() == \
                getattr(fb.fleet, f).tobytes(), f


def assert_matches_reference(port_out, ref_out):
    (pf, (pa, pi, ps)), (rf, (ra, ri, rs)) = port_out, ref_out
    np.testing.assert_array_equal(pa, ra)
    live = ra >= 0
    np.testing.assert_array_equal(pi[live], ri[live])
    np.testing.assert_allclose(ps, rs, **FLOAT_TOL)
    for f in EXACT:
        np.testing.assert_array_equal(getattr(pf.req, f),
                                      getattr(rf.req, f), err_msg=f)
    for f in ("finish_ms", "defer_until"):
        np.testing.assert_allclose(getattr(pf.req, f), getattr(rf.req, f),
                                   err_msg=f, **FLOAT_TOL)
    for f in ("inflight", "n_throttled", "n_requeued"):
        np.testing.assert_array_equal(getattr(pf.fleet, f),
                                      getattr(rf.fleet, f), err_msg=f)
    np.testing.assert_allclose(pf.fleet.tb_tokens, rf.fleet.tb_tokens,
                               **FLOAT_TOL)
    np.testing.assert_allclose(pf.fleet.inflight_tokens,
                               rf.fleet.inflight_tokens, **FLOAT_TOL)
    assert int(pf.provider.n_throttled) == int(rf.provider.n_throttled)
    np.testing.assert_allclose(pf.sched.deficit, rf.sched.deficit,
                               **FLOAT_TOL)
    np.testing.assert_allclose(pf.sched.ema_latency_ratio,
                               rf.sched.ema_latency_ratio, **FLOAT_TOL)
    return live.sum()


def assert_drained(final):
    st = final.req.status
    assert ((st == COMPLETED) | (st == REJECTED) | (st == ABANDONED)).all()
    assert not ((st == PENDING) | (st == INFLIGHT)).any()
    assert (final.fleet.inflight == 0).all()


# ---------------------------------------------------------------------------
# 1. P = 1 transparency
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,window,wl", [
    (0, None, HEAVY), (1, None, HEAVY),
    (2, 64, dict(n_requests=96, mix="balanced", congestion="medium",
                 arrival_scale=6.0))])
def test_p1_is_the_plain_engine(seed, window, wl):
    t = CASES["p1"][2]
    batch, jitter = draws(seed, tuple(sorted(wl.items())))
    fleet = _fleet("p1", t)
    plain = port_run(batch, jitter, t, window, None)
    one = port_run(batch, jitter, t, window, fleet)
    assert_bit_equal(plain, one, endpoint=False)
    assert plain[0].fleet is None and plain[0].req.endpoint is None
    assert (one[0].req.endpoint == 0).all()
    assert int(one[0].fleet.n_requeued.sum()) == 0
    assert int((one[0].req.status == COMPLETED).sum()) > 10
    live = assert_matches_reference(
        one, ref_run(batch, jitter, t, window, fleet))
    assert live > wl["n_requests"] // 4


# ---------------------------------------------------------------------------
# 2. P = 4
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def p4_runs(case):
    seed, wl, t = CASES[case]
    batch, jitter = draws(seed, tuple(sorted(wl.items())))
    fleet = _fleet(case, t)
    return (port_run(batch, jitter, t, None, fleet),
            ref_run(batch, jitter, t, None, fleet),
            port_run(batch, jitter, t, 256, fleet), wl["n_requests"])


@pytest.mark.parametrize("case", ["uniform", "failover", "bucket", "all_on"])
def test_p4_dense_matches_reference(case):
    dense, ref, _, n = p4_runs(case)
    live = assert_matches_reference(dense, ref)
    assert live > n // 4
    final = dense[0]
    assert_drained(final)
    used = np.bincount(final.req.endpoint[np.isfinite(final.req.submit_ms)],
                       minlength=4)
    assert (used > 0).sum() >= 2
    requeued, throttled = final.fleet.n_requeued, final.fleet.n_throttled
    if case in ("failover", "all_on"):
        # the failover bit, only on the dead endpoint, and each requeue
        # carries its throttle bump
        assert requeued[0] > 0 and requeued[1:].sum() == 0
        assert final.req.n_throttles.sum() >= requeued.sum()
    else:
        assert requeued.sum() == 0
    if case in ("bucket", "all_on"):
        assert throttled.sum() > 0
        assert int(final.provider.n_throttled) == throttled.sum()
    else:
        assert throttled.sum() == 0


@pytest.mark.parametrize("case", ["uniform", "failover", "bucket", "all_on"])
def test_p4_windowed_equals_dense(case):
    dense, _, windowed, _ = p4_runs(case)
    assert_bit_equal(dense, windowed)


def test_failover_recovers():
    """Endpoint 0 is down over ticks DOWN: nothing is admitted to it
    then, the fleet keeps completing on the others, and endpoint 0 takes
    work again after the window."""
    (final, (actions, req_idx, _)), *_ = p4_runs("failover")
    submit_tick = np.round(final.req.submit_ms / 25.0) - 1
    ep = final.req.endpoint
    sent = np.isfinite(final.req.submit_ms)
    down = sent & (submit_tick >= DOWN[0]) & (submit_tick < DOWN[1])
    assert down.sum() > 0 and (ep[down] != 0).all()
    assert (sent & (submit_tick >= DOWN[1]) & (ep == 0)).any()
    assert int((final.req.status == COMPLETED).sum()) > 60
