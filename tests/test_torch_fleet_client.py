"""The port's live fleet adapter, `FleetProvider`, against the reference's.

1. Both adapters are host numpy behind their imports, so the same seeded
   submit/poll script goes through the reference's `FleetProvider` over
   the reference's `MockProvider`s and through the port's over the
   port's, in one process, and must give the same verdicts, Retry-After
   bits, fleet tickets, endpoint loads, delivery order, finish bits and
   counters: a uniform and a skewed fleet, an endpoint's fail window,
   per-endpoint buckets that bounce (the dry penalty), a single
   endpoint fed the session's inflight hints, and `fleet_failover` with
   `silent_drop`'s fault schedule on every child.  The reference's five
   cases (`tests/test_fleet.py` `TestFleetProviderLive`) run on both
   sides with their own assertions; `from_fleet_scenario`'s schedules
   are the reference's bits; a NaN or negative Retry-After leaves the
   dry penalty finite on both sides.
2. Sessions over the port's fleet (no reference `ClientSession` is
   built): one endpoint equals the bare child and the windowed
   `run_sim` bit for bit; `fleet_failover` at the chip check's size
   (N = 160 at 4x the rate, W = 256, B = 4, 1,604 polls) gives the same
   trace twice, routes nothing to endpoint 0 inside its fail window and
   drains what it held there; `fleet_skew` routes most to the fast
   endpoint; and with `silent_drop`'s faults on every endpoint the
   watchdog's session drains to the reference's gates
   (`benchmarks/fault_sweep.py`: completion >= 0.99, nothing left, no
   double retire).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.client as rclient
from repro.sim import scenarios as rscn
from repro.sim.provider import FleetPhysics as RefFleetPhysics
from repro.sim.provider import ProviderPhysics as RefProviderPhysics
from repro.sim.provider import default_physics as ref_physics
from repro.sim.provider import uniform_fleet_physics as ref_uniform
from repro_torch.client import (
    ClientSession,
    FleetProvider,
    MockProvider,
    Request,
    ResilienceConfig,
    SessionConfig,
    SubmitResult,
)
from repro_torch.core.policy import strategy
from repro_torch.core.routing import UNAVAIL_MS
from repro_torch.sim import (
    FleetPhysics,
    ProviderPhysics,
    SimConfig,
    WorkloadConfig,
    default_physics,
    generate,
    run_sim,
    uniform_fleet_physics,
)
from repro_torch.sim import scenarios as scn

torch.set_num_threads(1)

DT = 25.0
REF = SimpleNamespace(
    name="reference", Fleet=rclient.FleetProvider, Mock=rclient.MockProvider,
    Request=rclient.Request, SubmitResult=rclient.SubmitResult,
    physics=ref_physics, uniform=ref_uniform, Phys=RefProviderPhysics,
    FleetPhys=RefFleetPhysics, scn=rscn)
PORT = SimpleNamespace(
    name="port", Fleet=FleetProvider, Mock=MockProvider, Request=Request,
    SubmitResult=SubmitResult, physics=default_physics,
    uniform=uniform_fleet_physics, Phys=ProviderPhysics,
    FleetPhys=FleetPhysics, scn=scn)
SIDES = (REF, PORT)


def np_leaves(fphys):
    return type(fphys)(*(np.asarray(a, np.float32) for a in fphys))


def make_fleet(side, p=4, speed_mult=None, avail=None):
    """P children of the default physics skewed by `speed_mult`, as the
    reference's `TestFleetProviderLive._mk` builds them."""
    fphys = np_leaves(side.uniform(side.physics(), p, speed_mult=speed_mult))
    children = [side.Mock(side.Phys(*(float(a[i]) for a in fphys)),
                          dt_ms=DT) for i in range(p)]
    return side.Fleet(children, fphys, dt_ms=DT, avail=avail)


def with_faults(side, name, fault_from):
    """Fleet scenario `name` carrying scenario `fault_from`'s faults."""
    sc = side.scn.get_scenario(name)
    return sc._replace(
        fault_schedule=side.scn.get_scenario(fault_from).fault_schedule)


def all_on(side):
    """`fleet_failover`'s traffic on a fleet with every mechanism on,
    as `chip_smoke.py` builds its `fleet_all_on` cell."""
    base = side.scn.get_scenario("fleet_failover")
    return base._replace(name="fleet_all_on", fleet=side.scn.FleetSpec(
        p=4, speed_mult=(0.5, 1.0, 1.0, 2.0), fail_windows=((0, 0.35, 0.65),),
        brownouts=((1, 0.5, 0.85, 0.3),), tb_rate_rps=0.4, tb_burst=6.0))


def _f32_now(t: int) -> float:
    return float(np.float32(np.float32(t) * np.float32(DT)))


def make_script(seed: int, ticks: int = 160, hints: bool = False):
    """Per tick 0-4 submits (tokens log-uniform in 16..4096, p50 within
    20% of them, float32 jitter in [0.95, 1.05], a random bucket and
    class, with `hints` an inflight hint or none), then a poll; a last
    poll far in the future drains everything."""
    rng = np.random.default_rng(seed)
    ops = []
    for t in range(1, ticks + 1):
        now = _f32_now(t)
        for _ in range(int(rng.integers(0, 5))):
            tok = float(np.float32(np.exp(rng.uniform(np.log(16.0),
                                                      np.log(4096.0)))))
            req = dict(max_new=tok,
                       p50=float(np.float32(tok * rng.uniform(0.8, 1.2))),
                       bucket=int(rng.integers(0, 4)),
                       cls=int(rng.integers(0, 2)),
                       jitter=float(np.float32(rng.uniform(0.95, 1.05))))
            hint = (int(rng.integers(0, 12))
                    if hints and rng.random() < 0.7 else None)
            ops.append(("submit", now, req, hint))
        ops.append(("poll", now))
    ops.append(("poll", 1e9))
    return ops


def run_script(fleet, side, ops):
    """Replay `ops` against `fleet`: every verdict and delivery (float
    values as their bits), the endpoint loads after each op, and the
    fleet's and each child's counters at the end."""
    out = []
    for i, op in enumerate(ops):
        if op[0] == "submit":
            _, now, kw, hint = op
            res = fleet.submit(side.Request(rid=i, prompt=None, **kw), now,
                               inflight_hint=hint)
            out.append(("submit", bool(res.accepted),
                        np.float64(res.retry_after_ms).tobytes(),
                        int(res.ticket)))
        else:
            comps = fleet.poll(op[1])
            nxt = fleet.next_event_ms(op[1])
            out.append(("poll", [(c.ticket, np.float64(c.finish_ms).tobytes())
                                 for c in comps],
                        None if nxt is None else np.float64(nxt).tobytes()))
        out.append(tuple(fleet.inflight_by_endpoint().tolist()))
    counters = (fleet.n_routed.tolist(), fleet.n_refused, [
        tuple(getattr(c, f) for f in ("n_accepted", "n_throttled",
                                      "n_dropped", "n_stuck", "n_duped"))
        for c in fleet.providers])
    return out, counters


def assert_same_script(make, ops):
    """`make(side)` builds a fleet; both sides replay `ops` alike."""
    (r_out, r_cnt), (p_out, p_cnt) = (run_script(make(s), s, ops)
                                      for s in SIDES)
    assert len(r_out) == len(p_out)
    for i, (a, b) in enumerate(zip(r_out, p_out)):
        assert a == b, f"op {i}: reference {a} vs port {b}"
    assert r_cnt == p_cnt
    return p_cnt


# ---------------------------------------------------------------------------
# 1. the adapter against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("speed_mult", [None, (0.5, 1.0, 1.0, 2.0)],
                         ids=["uniform", "skewed"])
@pytest.mark.parametrize("seed", [0, 1])
def test_script_matches_reference(speed_mult, seed):
    routed, refused, _ = assert_same_script(
        lambda s: make_fleet(s, 4, speed_mult), make_script(seed))
    assert refused == 0 and min(routed) > 0


def test_fail_window_matches_reference():
    avail = np.ones((400, 4), np.float32)
    avail[40:90, 0] = 0.0
    avail[60:70, 1:] = 0.0   # the whole fleet down for ten ticks
    routed, refused, _ = assert_same_script(
        lambda s: make_fleet(s, 4, avail=avail), make_script(2))
    assert refused > 0 and routed[0] > 0


def test_single_endpoint_with_hints_matches_reference():
    assert_same_script(lambda s: make_fleet(s, 1), make_script(3, hints=True))


@pytest.mark.parametrize("name", ["fleet_failover", "fleet_skew",
                                  "fleet_brownout", "fleet_all_on"])
def test_from_fleet_scenario_script_matches_reference(name):
    def make(side):
        sc = (all_on(side) if name == "fleet_all_on"
              else side.scn.get_scenario(name))
        return side.Fleet.from_fleet_scenario(sc, 8, 400, DT, 2)

    _, _, children = assert_same_script(make, make_script(4))
    if name == "fleet_all_on":
        # the per-endpoint buckets bounced: the dry-penalty path ran
        assert sum(c[1] for c in children) > 0


def test_silent_drop_on_every_endpoint_matches_reference():
    """`fleet_failover` with `silent_drop`'s schedule: each child draws
    its drops on its own stream (`fault_salt=ep`), the reference's."""
    _, _, children = assert_same_script(
        lambda s: s.Fleet.from_fleet_scenario(
            with_faults(s, "fleet_failover", "silent_drop"), 8, 400, DT, 2),
        make_script(5))
    drops = [c[2] for c in children]
    assert sum(drops) > 0 and len(set(drops)) > 1


def _req(side, i, p50=100.0):
    return side.Request(rid=i, prompt=None, max_new=p50, p50=p50, bucket=1)


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_routing_balances_and_skews(side):
    fp = make_fleet(side, 4, speed_mult=(0.5, 1.0, 1.0, 2.0))
    for i in range(16):
        assert fp.submit(_req(side, i), now_ms=50.0).accepted
    by_ep = fp.inflight_by_endpoint()
    assert fp.inflight() == 16
    assert by_ep[0] > by_ep[3]      # the fast endpoint loads first
    assert (by_ep > 0).sum() >= 2   # comfort pressure spreads the load


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_poll_merges_in_ticket_order(side):
    fp = make_fleet(side, 4)
    for i in range(10):
        assert fp.submit(_req(side, i), now_ms=50.0).accepted
    comps = fp.poll(1e9)
    assert [c.ticket for c in comps] == sorted(c.ticket for c in comps)
    assert len(comps) == 10 and fp.inflight() == 0


def test_the_five_cases_agree():
    """The reference's five cases, each side's record equal."""
    def cases(side):
        rec = []
        fp = make_fleet(side, 4, speed_mult=(0.5, 1.0, 1.0, 2.0))
        for i in range(16):
            fp.submit(_req(side, i), now_ms=50.0)
        rec.append(fp.inflight_by_endpoint().tolist())
        rec.append([(c.ticket, c.finish_ms) for c in fp.poll(1e9)])
        avail = np.ones((400, 2), np.float32)
        avail[4:, 0] = 0.0
        fp = make_fleet(side, 2, avail=avail)
        rec.append(fp.submit(_req(side, 0), now_ms=50.0).ticket)
        rec.extend(fp.submit(_req(side, i), now_ms=500.0).ticket
                   for i in range(1, 7))
        rec.append((fp.n_routed.tolist(), fp.inflight_by_endpoint().tolist()))
        rec.append([(c.ticket, c.finish_ms) for c in fp.poll(1e9)])
        fp = make_fleet(side, 2, avail=np.zeros((10, 2), np.float32))
        res = fp.submit(_req(side, 0), now_ms=50.0)
        rec.append((res.accepted, res.retry_after_ms, fp.n_refused))
        fp = make_fleet(side, 1)
        for i in range(6):
            fp.submit(_req(side, i), now_ms=50.0, inflight_hint=i)
        rec.append([(c.ticket, c.finish_ms) for c in fp.poll(1e9)])
        return rec

    assert cases(REF) == cases(PORT)


def test_down_endpoint_drains_gracefully():
    """An endpoint that goes down takes nothing new but completes what it
    holds: the live path's failure model."""
    avail = np.ones((400, 2), np.float32)
    avail[4:, 0] = 0.0  # endpoint 0 dies after ~100 ms
    fp = make_fleet(PORT, 2, avail=avail)
    r = fp.submit(_req(PORT, 0), now_ms=50.0)
    assert r.accepted and fp.n_routed[0] == 1
    for i in range(1, 7):
        assert fp.submit(_req(PORT, i), now_ms=500.0).accepted
    assert fp.n_routed[0] == 1
    assert fp.inflight_by_endpoint()[0] == 1
    assert len(fp.poll(1e9)) == 7


def test_whole_fleet_down_bounces_with_retry_after():
    fp = make_fleet(PORT, 2, avail=np.zeros((10, 2), np.float32))
    res = fp.submit(_req(PORT, 0), now_ms=50.0)
    assert not res.accepted and res.retry_after_ms == 1500.0
    assert fp.n_refused == 1
    _, cost = fp.route(100.0, 50.0)
    assert cost * 1e3 >= UNAVAIL_MS


def test_p1_passthrough_matches_bare_child():
    """A one-endpoint fleet forwards `inflight_hint` and prices service
    as the bare `MockProvider` does, bit for bit."""
    bare = MockProvider(default_physics(), dt_ms=DT)
    fp = make_fleet(PORT, 1)
    for i in range(6):
        rb = bare.submit(_req(PORT, i), now_ms=50.0, inflight_hint=i)
        rf = fp.submit(_req(PORT, i), now_ms=50.0, inflight_hint=i)
        assert rb.accepted and rf.accepted
    fb = np.asarray([c.finish_ms for c in bare.poll(1e9)], np.float32)
    ff = np.asarray([c.finish_ms for c in fp.poll(1e9)], np.float32)
    np.testing.assert_array_equal(fb.view(np.int32), ff.view(np.int32))


@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_from_fleet_scenario_schedules_match_reference(scale):
    """`from_fleet_scenario`: the adapter's availability rows and every
    child's physics and schedules are the reference's `build_fleet`
    bits; inside the fail window routing avoids endpoint 0; a scenario
    without a fleet raises."""
    sc = scn.get_scenario("fleet_failover")
    fp = FleetProvider.from_fleet_scenario(sc, 120, 6000, DT, 4,
                                           arrival_scale=scale)
    ref = rscn.build_fleet(rscn.get_scenario("fleet_failover"),
                           ref_physics(), 6000, DT, 120, 4, scale)
    want = np.asarray(ref.dyn.avail)
    assert fp.p == 4 and fp._avail_rows.shape == (6000, 4)
    np.testing.assert_array_equal(fp._avail_rows.view(np.int32),
                                  want.view(np.int32))
    for mine, theirs in (("_base", "base_ms"),
                         ("_ms_per_token", "ms_per_token"),
                         ("_comfort", "comfort_concurrency")):
        np.testing.assert_array_equal(getattr(fp, mine),
                                      np.asarray(getattr(ref.phys, theirs)))
    if scale == 1.0:
        rfp = rclient.FleetProvider.from_fleet_scenario(
            rscn.get_scenario("fleet_failover"), 120, 6000, DT, 4)
        np.testing.assert_array_equal(fp._avail_rows, rfp._avail_rows)
        assert fp.retry_after_ms == rfp.retry_after_ms
    t_down = int(np.argmin(fp._avail_rows[:, 0]))
    assert fp._avail_rows[t_down, 0] == 0.0
    ep, _ = fp.route(100.0, (t_down + 1) * DT)
    assert ep != 0
    with pytest.raises(ValueError):
        FleetProvider.from_fleet_scenario(scn.get_scenario("flash_crowd"),
                                          120, 3000, DT, 4)


class Bouncer:
    """A transport that refuses everything with a hostile Retry-After."""

    def __init__(self, side, hint):
        self.side, self.hint = side, hint

    def submit(self, req, now_ms, inflight_hint=None):
        return self.side.SubmitResult(False, self.hint)

    def poll(self, now_ms):
        return []

    def inflight(self):
        return 0

    def next_event_ms(self, now_ms):
        return None


@pytest.mark.parametrize("hint", [float("nan"), -1500.0, float("-inf")])
def test_dry_penalty_stays_finite(hint):
    """A NaN or negative Retry-After is sanitized before it becomes a
    routing penalty (the raw hint still reaches the caller); both sides
    keep the same finite state."""
    rec = []
    for side in SIDES:
        phys = side.physics()
        fphys = side.FleetPhys(*(np.asarray(a, np.float32)[None]
                                 for a in phys))
        fleet = side.Fleet([Bouncer(side, hint)], fphys)
        res = fleet.submit(_req(side, 0), 100.0)
        assert not res.accepted
        assert np.isfinite(fleet._dry_penalty).all()
        assert np.isfinite(fleet._dry_until).all()
        ep, cost = fleet.route(100.0, 200.0)
        assert np.isfinite(cost)
        rec.append((fleet._dry_penalty.tolist(), fleet._dry_until.tolist(),
                    ep, cost, np.float64(res.retry_after_ms).tobytes()))
    assert rec[0] == rec[1]


# ---------------------------------------------------------------------------
# 2. sessions over the port's fleet
# ---------------------------------------------------------------------------

_STATUS = {"pending": 0, "inflight": 1, "completed": 2, "rejected": 3,
           "abandoned": 4}


def arrivals(name, seed, n, n_ticks, scale):
    """(batch, jitter, requests): `balanced`/medium stationary or a
    registry scenario's arrivals, from the port's generator."""
    sched = None
    if name == "balanced":
        wl = WorkloadConfig(n_requests=n, mix="balanced", congestion="medium")
    else:
        wl, sched, _, _ = scn.build(scn.get_scenario(name), n, n_ticks, DT,
                                    limiter_classes=2, arrival_scale=scale)
    batch, jitter = generate(wl, torch.Generator().manual_seed(seed),
                             device="cpu", sched=sched)
    a = [x.numpy() for x in batch]
    j = jitter.numpy()
    reqs = [Request(rid=i, prompt=None, max_new=float(a[3][i]),
                    p50=float(a[4][i]), bucket=int(a[1][i]),
                    p90=float(a[5][i]), cls=int(a[2][i]),
                    arrival_s=float(a[0][i]) / 1e3, jitter=float(j[i]))
            for i in range(batch.n)]
    return batch, jitter, reqs


def run_session(provider, reqs, polls, window, on_poll=None):
    """`polls` virtual polls of a session over `provider`: the decision
    trace and each request's status, bounces and finish bits."""
    sess = ClientSession(provider, strategy("final_adrr_olc"),
                         SessionConfig(window=window, max_grants=4,
                                       dt_ms=DT),
                         clock="virtual", device="cpu")
    for r in reqs:
        sess.submit(r)
    acts, rids, sevs = [], [], []
    for _ in range(polls):
        r = sess.poll()
        acts.append(r.actions)
        rids.append(r.req_rids)
        sevs.append(r.severity)
        if on_poll is not None:
            on_poll(r)
    out = sess.requests()
    return dict(
        actions=np.stack(acts), rids=np.stack(rids),
        severity=np.asarray(sevs, np.float32),
        status=np.asarray([_STATUS[r.status] for r in out], np.int32),
        n_throttles=np.asarray([r.n_throttles for r in out], np.int32),
        finish=np.asarray([np.float32(r.finish_s * 1e3) for r in out],
                          np.float32))


def assert_same_trace(a, b, live):
    np.testing.assert_array_equal(a["actions"], b["actions"])
    np.testing.assert_array_equal(a["rids"][live], b["rids"][live])
    np.testing.assert_array_equal(a["severity"].view(np.int32),
                                  b["severity"].view(np.int32))
    np.testing.assert_array_equal(a["status"], b["status"])
    np.testing.assert_array_equal(a["n_throttles"], b["n_throttles"])
    done = a["status"] == 2
    np.testing.assert_array_equal(a["finish"][done].view(np.int32),
                                  b["finish"][done].view(np.int32))


def test_one_endpoint_session_equals_bare_child_and_run_sim():
    """`balanced`/medium, N = 48, W = 64, B = 4, 900 polls (the chip
    check's P = 1 case): the session over a one-endpoint fleet, over the
    bare `MockProvider`, and the windowed `run_sim` on the same batch."""
    n, polls, window = 48, 900, 64
    batch, jitter, reqs = arrivals("balanced", 0, n, polls, 1.0)
    phys = default_physics()
    fphys = FleetPhysics(*(a[None] for a in phys))
    fleet = run_session(FleetProvider([MockProvider(phys, dt_ms=DT)], fphys),
                        reqs, polls, window)
    _, _, reqs = arrivals("balanced", 0, n, polls, 1.0)
    bare = run_session(MockProvider(phys, dt_ms=DT), reqs, polls, window)
    last = {}

    def on_tick(t, state, win):
        if t == polls - 1:
            last["status"] = state.req.status.clone()
            last["n_throttles"] = state.req.n_throttles.clone()

    final, (actions, req_idx, severity) = run_sim(
        strategy("final_adrr_olc"), batch, jitter, phys,
        SimConfig(n_ticks=polls, k_slots=4, window=window),
        collect_decisions=True, device="cpu", on_tick=on_tick)
    engine = dict(actions=actions.numpy(), rids=req_idx.numpy(),
                  severity=severity.numpy(), status=last["status"].numpy(),
                  n_throttles=last["n_throttles"].numpy(),
                  finish=final.req.finish_ms.numpy())
    live = engine["actions"] != -1
    assert live.sum() > 10
    assert_same_trace(fleet, bare, live)
    assert_same_trace(fleet, engine, live)
    assert (fleet["status"] == 2).sum() > 10


# the chip check's fleet sessions: N = 160 at 4x the rate, W = 256, B = 4
FLEET_N, FLEET_SCALE, FLEET_POLLS, FLEET_W = 160, 4.0, 1604, 256


def fleet_session(name):
    """One session over `from_fleet_scenario(name)`: its trace, the
    adapter, and per poll `n_routed`, endpoint 0's load and whether
    endpoint 0 was down."""
    _, _, reqs = arrivals(name, 0, FLEET_N, FLEET_POLLS, FLEET_SCALE)
    fp = FleetProvider.from_fleet_scenario(
        scn.get_scenario(name), FLEET_N, FLEET_POLLS, DT, 2,
        arrival_scale=FLEET_SCALE)
    per_poll = []

    def on_poll(r):
        row = fp._avail_row(r.now_ms)
        per_poll.append((fp.n_routed.copy(), fp.inflight_by_endpoint()[0],
                         row is not None and row[0] < 0.5))
    trace = run_session(fp, reqs, FLEET_POLLS, FLEET_W, on_poll)
    return trace, fp, per_poll


def test_fleet_failover_session_is_deterministic_and_fails_over():
    a, fa, per_poll = fleet_session("fleet_failover")
    b, fb, _ = fleet_session("fleet_failover")
    live = a["actions"] != -1
    assert live.sum() > 10
    assert_same_trace(a, b, live)
    np.testing.assert_array_equal(fa.n_routed, fb.n_routed)
    assert fa.n_refused == fb.n_refused
    down = np.nonzero([d for _, _, d in per_poll])[0]
    assert down.size > 0
    first, last = down[0], down[-1]
    routed0 = [int(r[0]) for r, _, _ in per_poll]
    # nothing new lands on endpoint 0 while it is down ...
    assert routed0[last] == routed0[first - 1] > 0
    # ... but what it held still completes
    assert per_poll[first - 1][1] > 0 and per_poll[last][1] == 0
    assert routed0[-1] > routed0[last]


def test_fleet_skew_session_routes_most_to_the_fast_endpoint():
    trace, fp, _ = fleet_session("fleet_skew")
    assert int(np.argmax(fp.n_routed)) == 0   # speed 0.5
    assert (trace["status"] == 2).sum() > 100


def test_watchdog_drains_silent_drop_on_every_endpoint():
    """`fleet_failover` with `silent_drop`'s faults on each child at the
    chip check's recovery configuration (N = 32, schedules over 1,600
    ticks, timeout_mult 3, three resubmits), polled to drain."""
    n, horizon, cap = 32, 1600, 9000
    sc = with_faults(PORT, "fleet_failover", "silent_drop")
    _, _, reqs = arrivals("fleet_failover", 0, n, horizon, 1.0)
    fp = FleetProvider.from_fleet_scenario(sc, n, horizon, DT, 2)
    sess = ClientSession(fp, strategy("final_adrr_olc"), SessionConfig(),
                         clock="virtual",
                         resilience=ResilienceConfig(timeout_mult=3.0,
                                                     max_resubmits=3),
                         device="cpu")
    for r in reqs:
        sess.submit(r)
    polls = 0
    while sess.unfinished and polls < cap:
        sess.poll()
        polls += 1
    out = sess.requests()
    st = sess.stats
    dropped = sum(c.n_dropped for c in fp.providers)
    terminal = sum(r.status in ("completed", "abandoned", "rejected")
                   for r in out)
    assert dropped > 0 and st.n_resubmitted > 0
    assert sess.unfinished == 0
    assert sum(r.status == "completed" for r in out) / n >= 0.99
    assert st.n_completed + st.n_abandoned + st.n_rejected == terminal
