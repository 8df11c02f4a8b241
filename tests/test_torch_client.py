"""The port's client boundary: `MockProvider`, `Watchdog`, `Request`, the
Retry-After helpers, and the session's lifecycle, 429 path and clocks.

1. Provider, watchdog and request against the reference, in one
   process: both sides are pure numpy, so no reference `ClientSession`
   (and no compiled program) is built.  The same seeded submit/poll
   script goes through the reference's `MockProvider` and the port's and
   must give the same finish bits, tickets, 429 verdicts and hints,
   delivery order and fault counters: an honest provider, brownout rows
   with a token bucket, each of the three registry fault schedules, and
   a lying Retry-After.  `from_scenario` builds the reference's
   schedules; `sanitize_retry_after_ms` on hostile hints, `expo_retry`
   with a seed and the `Watchdog` lifecycle step for step.
2. The provider's finish time equals the port engine's
   (`sim/engine.py` `_grant_service`, then `fma32(service, jitter,
   now)`) for the same grant, bit for bit, with and without a brownout.
3. The port session's lifecycle at small sizes: open-ended submission,
   window overflow queued FIFO, inflight equal to the provider's count
   every poll, p90 defaulting, the 429 path (bounces honored, no resend
   before the Retry-After, recovery after the crunch), the retry-policy
   hook, the post-drain idle fast path, submit after drain, and the
   wall clock (with `time` replaced in the session's module by a fake
   clock, so no test sleeps or reads the real clock).
"""
import numpy as np
import pytest
import torch

import repro.client as rclient
from repro.client.resilience import ResilienceConfig as RefResilienceConfig
from repro.client.resilience import Watchdog as RefWatchdog
from repro.sim import scenarios as rscn
from repro.sim.faults import FaultSchedule as RefFaultSchedule
from repro.sim.provider import default_physics as ref_physics
from repro.sim.workload import P90_OVER_P50_NP as REF_P90_OVER_P50_NP
from repro_torch.client import (
    ClientSession,
    MockProvider,
    Request,
    ResilienceConfig,
    SessionConfig,
    Watchdog,
    default_p90,
    expo_retry,
    honor_retry_after,
    sanitize_retry_after_ms,
)
from repro_torch.client import session as session_mod
from repro_torch.core.numerics import fma32
from repro_torch.core.policy import strategy
from repro_torch.core.scheduler import BatchDecision
from repro_torch.core.types import RequestBatch, init_sim_state
from repro_torch.sim import default_physics
from repro_torch.sim.engine import _grant_service
from repro_torch.sim.faults import FaultSchedule
from repro_torch.sim.scenarios import get_scenario
from repro_torch.sim.workload import P90_OVER_P50, P90_OVER_P50_NP

DT = 25.0


# ---------------------------------------------------------------------------
# 1. provider, watchdog, request against the reference
# ---------------------------------------------------------------------------

def _f32_now(t: int) -> float:
    """Tick t's clock as the session computes it."""
    return float(np.float32(np.float32(t) * np.float32(DT)))


def make_script(seed: int, ticks: int = 160, n_classes: int = 2):
    """A seeded submit/poll script: per tick 0-4 submits (tokens
    log-uniform in 16..4096, float32 jitter in [0.95, 1.05], a random
    bucket and class, an inflight hint or none), then a poll; a final
    poll far in the future drains everything."""
    rng = np.random.default_rng(seed)
    ops = []
    for t in range(1, ticks + 1):
        now = _f32_now(t)
        for _ in range(int(rng.integers(0, 5))):
            tok = float(np.float32(np.exp(rng.uniform(np.log(16.0),
                                                      np.log(4096.0)))))
            req = dict(max_new=tok, p50=tok, bucket=int(rng.integers(0, 4)),
                       cls=int(rng.integers(0, n_classes)),
                       jitter=float(np.float32(rng.uniform(0.95, 1.05))))
            hint = int(rng.integers(0, 12)) if rng.random() < 0.7 else None
            ops.append(("submit", now, req, hint))
        ops.append(("poll", now))
    ops.append(("poll", 1e9))
    return ops


def run_script(provider, request_cls, ops):
    """Replay `ops` against `provider`; returns the record of every
    verdict and delivery, with float32 values as their bits."""
    out = []
    for i, op in enumerate(ops):
        if op[0] == "submit":
            _, now, kw, hint = op
            res = provider.submit(request_cls(rid=i, prompt=None, **kw), now,
                                  inflight_hint=hint)
            out.append(("submit", bool(res.accepted),
                        np.float64(res.retry_after_ms).tobytes(),
                        int(res.ticket)))
        else:
            comps = provider.poll(op[1])
            out.append(("poll", [(c.ticket, np.float64(c.finish_ms).tobytes())
                                 for c in comps], provider.inflight()))
    counters = tuple(getattr(provider, f) for f in (
        "n_accepted", "n_throttled", "n_dropped", "n_stuck", "n_duped"))
    return out, counters


def assert_same_provider(ref, port, ops):
    r_out, r_cnt = run_script(ref, rclient.Request, ops)
    p_out, p_cnt = run_script(port, Request, ops)
    assert len(r_out) == len(p_out)
    for i, (a, b) in enumerate(zip(r_out, p_out)):
        assert a == b, f"op {i}: reference {a} vs port {b}"
    assert r_cnt == p_cnt
    return p_out, p_cnt


def test_honest_provider_matches_reference():
    ops = make_script(0)
    out, (accepted, *_rest) = assert_same_provider(
        rclient.MockProvider(ref_physics(), dt_ms=DT),
        MockProvider(default_physics(), dt_ms=DT), ops)
    assert accepted == sum(op[0] == "submit" for op in ops)
    # service times that invert along the submit stream: delivery is
    # in (finish, ticket) order, not submit order
    delivered = [t for rec in out if rec[0] == "poll" for t, _ in rec[1]]
    assert delivered != sorted(delivered)
    assert sorted(delivered) == list(range(accepted))


def test_brownout_and_token_bucket_match_reference():
    ticks = 160
    t = np.arange(ticks)
    comfort = np.where((t >= 40) & (t < 100), 0.4, 1.0).astype(np.float32)
    refill = np.full((ticks, 2), 0.9 * DT / 1000.0, np.float32)
    refill[60:120] *= 0.1
    cap = np.asarray([3.0, 2.0], np.float32)
    kw = dict(dt_ms=DT, comfort_scale=comfort, tb_refill=refill,
              tb_capacity=cap, retry_after_ms=1200.0)
    ops = make_script(1, ticks)
    _, (_, throttled, *_rest) = assert_same_provider(
        rclient.MockProvider(ref_physics(), **kw),
        MockProvider(default_physics(), **kw), ops)
    assert throttled > 0


@pytest.mark.parametrize("name", ["silent_drop", "stuck_tail", "dup_storm"])
def test_fault_schedules_match_reference(name):
    """The registry's three fault schedules through `from_scenario` on
    both sides (dup_storm also carries a token bucket and a lying
    Retry-After)."""
    ticks = 160
    ref = rclient.MockProvider.from_scenario(rscn.get_scenario(name), 96,
                                             ticks, DT, 2)
    port = MockProvider.from_scenario(get_scenario(name), 96, ticks, DT, 2)
    assert port._faults == tuple(ref._faults)
    _, counters = assert_same_provider(ref, port, make_script(2, ticks))
    _, _, dropped, stuck, duped = counters
    fired = {"silent_drop": dropped, "stuck_tail": stuck,
             "dup_storm": duped}[name]
    assert fired > 0


@pytest.mark.parametrize("mult", [-1.0, 0.25, float("nan")])
def test_lying_retry_after_matches_reference(mult):
    ticks = 120
    refill = np.full((ticks, 2), 0.5 * DT / 1000.0, np.float32)
    cap = np.full(2, 1.5, np.float32)
    kw = dict(dt_ms=DT, tb_refill=refill, tb_capacity=cap)
    out, (_, throttled, *_rest) = assert_same_provider(
        rclient.MockProvider(ref_physics(), **kw,
                             faults=RefFaultSchedule(retry_lie_mult=mult)),
        MockProvider(default_physics(), **kw,
                     faults=FaultSchedule(retry_lie_mult=mult)),
        make_script(3, ticks))
    assert throttled > 0
    hints = {np.frombuffer(rec[2])[0] for rec in out
             if rec[0] == "submit" and not rec[1]}
    assert hints and all(not (h >= 0.0) or h == 1500.0 * mult for h in hints)


@pytest.mark.parametrize("name", ["storm", "rate_crunch", "dup_storm",
                                  "balanced"])
def test_from_scenario_matches_reference(name):
    ref = rclient.MockProvider.from_scenario(rscn.get_scenario(name), 160,
                                             1604, DT, 2)
    port = MockProvider.from_scenario(get_scenario(name), 160, 1604, DT, 2)
    for f in ("_comfort_rows", "_refill_rows", "_capacity"):
        a, b = getattr(ref, f), getattr(port, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b.view(np.int32), a.view(np.int32))
    assert port.retry_after_ms == ref.retry_after_ms


def test_from_scenario_compresses_with_the_arrivals():
    """`arrival_scale` (a port extension) lays the schedules over the
    compressed arrival span, as `scenarios.build` does."""
    sc = get_scenario("storm")
    slow = MockProvider.from_scenario(sc, 160, 1604, DT, 2)
    fast = MockProvider.from_scenario(sc, 160, 1604, DT, 2, arrival_scale=4.0)
    inside = lambda p: np.nonzero(p._comfort_rows < 1.0)[0]  # noqa: E731
    assert inside(fast)[0] < inside(slow)[0] / 3


def test_sanitize_retry_after():
    for hostile in (float("nan"), float("inf"), float("-inf"), -1500.0,
                    -0.0, 0.0):
        assert sanitize_retry_after_ms(hostile) == 0.0
        assert rclient.sanitize_retry_after_ms(hostile) == 0.0
    assert sanitize_retry_after_ms(1500.0) == 1500.0
    assert honor_retry_after(700.0, 3) == 700.0
    pol = expo_retry(jitter=0.0)
    for hostile in (float("nan"), float("-inf"), -42.0):
        d = pol(sanitize_retry_after_ms(hostile), 1)
        assert np.isfinite(d) and d >= 0.0


@pytest.mark.parametrize("kw", [dict(seed=7), dict(seed=3, jitter=0.0),
                                dict(mult=0.5, growth=3.0, cap_ms=9000.0,
                                     jitter=0.4, seed=11)])
def test_expo_retry_matches_reference(kw):
    ours, theirs = expo_retry(**kw), rclient.expo_retry(**kw)
    for i in range(60):
        hint, n = 100.0 * (i % 7), 1 + i % 9
        assert ours(hint, n) == theirs(hint, n)
    with pytest.raises(ValueError):
        expo_retry(jitter=1.0)


def _req_pair(**kw):
    return (rclient.Request(rid=0, prompt=None, **kw),
            Request(rid=0, prompt=None, **kw))


def test_watchdog_lifecycle_matches_reference():
    """The same sequence of calls, step for step: deadlines, overdue
    scans, budget, bounces, give-up and the unmapped tickets."""
    cfg = dict(timeout_mult=2.0, min_deadline_ms=50.0, max_resubmits=2)
    ref = RefWatchdog(RefResilienceConfig(**cfg), ref_physics())
    port = Watchdog(ResilienceConfig(**cfg), default_physics())
    reqs = [_req_pair(max_new=40.0 * (i + 1), p50=40.0 * (i + 1),
                      bucket=i % 4, p90=None if i % 2 else 90.0 * (i + 1))
            for i in range(5)]
    for i, (rr, pr) in enumerate(reqs):
        assert port.deadline_ms(pr) == ref.deadline_ms(rr)
        ref.note_admit(i, rr, ticket=10 + i, now_ms=25.0 * i)
        port.note_admit(i, pr, ticket=10 + i, now_ms=25.0 * i)
    ticket = 100
    for now in np.arange(0.0, 20_000.0, 250.0):
        due = ref.overdue(now)
        assert port.overdue(now) == due
        assert port.next_deadline_ms() == ref.next_deadline_ms()
        for rid in due:
            assert port.budget_left(rid) == ref.budget_left(rid)
            if ref.budget_left(rid):
                if rid % 2:
                    ref.note_bounced(rid, 300.0, now)
                    port.note_bounced(rid, 300.0, now)
                ref.note_resubmit(rid, reqs[rid][0], ticket, now)
                port.note_resubmit(rid, reqs[rid][1], ticket, now)
                ticket += 1
            else:
                ref.give_up(rid)
                port.give_up(rid)
    assert (port.n_resubmits, port.n_gave_up) == (ref.n_resubmits,
                                                  ref.n_gave_up)
    assert port.n_gave_up == 5
    for rid in range(5):
        assert port.note_terminal(rid) == ref.note_terminal(rid)
        assert port.note_terminal(rid) == []
    assert port.next_deadline_ms() == float("inf")


def test_request_and_default_p90_match_reference():
    np.testing.assert_array_equal(P90_OVER_P50_NP.view(np.int32),
                                  np.asarray(REF_P90_OVER_P50_NP).view(
                                      np.int32))
    assert P90_OVER_P50.dtype == torch.float32
    for bucket in range(4):
        for p50 in (1.0, 37.5, 300.0):
            assert default_p90(p50, bucket) == rclient.default_p90(p50,
                                                                   bucket)
    for kw in (dict(max_new=100.0, p50=100.0, bucket=2),
               dict(max_new=9.0, p50=9.0, bucket=0, p90=555.0, cls=3)):
        rr, pr = _req_pair(**kw)
        assert pr.resolved_p90() == rr.resolved_p90()
        assert pr.resolved_cls() == rr.resolved_cls()
    assert ([f.name for f in Request.__dataclass_fields__.values()]
            == [f.name for f in rclient.Request.__dataclass_fields__.values()])


# ---------------------------------------------------------------------------
# 2. the provider's finish time is the engine's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("comfort", [None, 0.4])
def test_finish_time_equals_the_engines_grant(comfort):
    """For the same grants (tokens, jitter, the inflight count each saw,
    the tick's brownout value), `MockProvider` stamps the finish time the
    engine's `_apply_batch` computes: `_grant_service`, then one
    rounding of `service * jitter + now`."""
    rng = np.random.default_rng(5)
    g, n = 64, 64
    tokens = np.exp(rng.uniform(np.log(16.0), np.log(4096.0), n)).astype(
        np.float32)
    jitter = rng.uniform(0.95, 1.05, n).astype(np.float32)
    inflight = rng.integers(0, 24, g).astype(np.int32)
    t = 41
    now = _f32_now(t)
    ticks = 80
    rows = (None if comfort is None
            else np.full(ticks, comfort, np.float32))
    phys = default_physics()
    prov = MockProvider(phys, dt_ms=DT, comfort_scale=rows)
    got = np.asarray([prov._finish_ms(float(tokens[i]), int(inflight[i]),
                                      float(jitter[i]), now)
                      for i in range(g)], np.float32)

    f = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    batch = RequestBatch(
        arrival_ms=f(np.zeros(n, np.float32)),
        bucket=f(np.zeros(n, np.int32)), cls=f(np.zeros(n, np.int32)),
        true_tokens=f(tokens), p50=f(tokens), p90=f(tokens),
        deadline_budget_ms=f(np.full(n, 1e9, np.float32)),
        valid=f(np.ones(n, bool)))
    idx = torch.arange(g, dtype=torch.int32)
    d = BatchDecision(
        actions=torch.zeros(g, dtype=torch.int32), req_idx=idx,
        inflight_at=f(inflight), severity=torch.zeros(()),
        deficit=torch.zeros(2), rr_turn=torch.zeros((), dtype=torch.int32))
    state = init_sim_state(n, 2, torch.device("cpu"))
    comfort_t = None if rows is None else torch.from_numpy(rows)[t - 1]
    service = _grant_service(phys, batch, state, d, idx, comfort_t, None,
                             None, None)
    want = fma32(service, f(jitter)[idx], torch.tensor(now)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# ---------------------------------------------------------------------------
# 3. the port session's lifecycle, 429 path and clocks
# ---------------------------------------------------------------------------

def _session(provider=None, window=16, grants=2, **kw):
    phys = default_physics()
    return ClientSession(
        provider if provider is not None else MockProvider(phys, dt_ms=DT),
        kw.pop("policy", strategy("final_adrr_olc")),
        SessionConfig(window=window, max_grants=grants, dt_ms=DT,
                      **kw.pop("cfg", {})),
        clock=kw.pop("clock", "virtual"), phys=phys, device="cpu", **kw)


def test_open_ended_submission():
    """A request submitted after polling started is admitted and
    completed: the API is a stream, not a batch."""
    sess = _session()
    sess.submit(Request(rid=0, prompt=None, max_new=30.0, p50=30.0,
                        bucket=0))
    for _ in range(40):
        sess.poll()
    sess.submit(Request(rid=1, prompt=None, max_new=30.0, p50=30.0, bucket=0,
                        arrival_s=sess.now_ms() / 1e3))
    out = sess.drain(max_polls=400)
    assert [r.status for r in out] == ["completed", "completed"]
    assert out[1].finish_s > out[0].finish_s


def test_window_overflow_queues_fifo():
    """More live work than W: the queue holds the overflow, admission is
    FIFO by submission, and every request ends."""
    sess = _session(window=4)
    for i in range(16):
        sess.submit(Request(rid=i, prompt=None, max_new=25.0, p50=25.0,
                            bucket=0))
    staged = []
    seen = set()
    for _ in range(2000):
        sess.poll()
        assert sess._n_live <= 4
        for rid in sess._slot_rid[:sess._n_live]:
            if int(rid) not in seen:
                seen.add(int(rid))
                staged.append(int(rid))
        if sess.unfinished == 0:
            break
    assert staged == list(range(16))
    out = sess.requests()
    assert all(r.status in ("completed", "rejected", "abandoned")
               for r in out)
    assert sum(r.status == "completed" for r in out) > 0


def test_inflight_tracks_provider_concurrency():
    """The session's inflight count (the flushed device state) equals the
    provider's outstanding count every poll."""
    prov = MockProvider(default_physics(), dt_ms=DT)
    sess = _session(prov, window=32, grants=4)
    for i in range(24):
        sess.submit(Request(rid=i, prompt=None, max_new=200.0, p50=200.0,
                            bucket=1))
    peak = 0
    for _ in range(600):
        sess.poll()
        assert int(sess._state.provider.inflight) == prov.inflight()
        peak = max(peak, prov.inflight())
        if sess.unfinished == 0:
            break
    assert sess.unfinished == 0 and peak > 1
    assert sess.stats.peak_inflight == peak


def test_p90_defaulting():
    r = Request(rid=0, prompt=None, max_new=100.0, p50=100.0, bucket=2)
    assert r.resolved_p90() == pytest.approx(100.0 * float(P90_OVER_P50_NP[2]))
    assert default_p90(1.0, 0) == pytest.approx((64.0 / 16.0) ** 0.4)
    assert Request(rid=0, prompt=None, max_new=1.0, p50=1.0, bucket=2,
                   p90=555.0).resolved_p90() == 555.0
    # the session stages the defaulted prior
    sess = _session()
    sess.submit(r)
    sess.poll()
    assert float(sess._win_batch.p90[0]) == pytest.approx(r.resolved_p90())


def _crunch_provider(ticks=1200, retry_after=600.0):
    t = np.arange(ticks)
    refill = np.full((ticks, 2), 1.6 * DT / 1000.0, np.float32)
    refill[(t >= ticks // 4) & (t < ticks // 2)] *= 0.1
    return MockProvider(default_physics(), dt_ms=DT, tb_refill=refill,
                        tb_capacity=np.full(2, 3.0, np.float32),
                        retry_after_ms=retry_after)


def _patient_policy():
    """A timeout multiple long enough that the crunch does not abandon
    the shorts: the 429 path is what is under test."""
    return strategy("final_adrr_olc")._replace(
        timeout_mult=torch.full((4,), 30.0))


def _burst(n, gap_ms):
    return [Request(rid=i, prompt=None, max_new=40.0 + i, p50=40.0 + i,
                    bucket=0, arrival_s=i * gap_ms / 1e3) for i in range(n)]


def test_throttles_happen_and_backoff_is_honored():
    prov = _crunch_provider()
    sess = _session(prov, window=32, grants=4, policy=_patient_policy())
    for r in _burst(30, 90.0):
        sess.submit(r)
    bounced_at: dict[int, float] = {}
    early = False
    for _ in range(1200):
        r = sess.poll()
        for rid in r.admitted:
            if rid in bounced_at and r.now_ms < bounced_at[rid] + 600.0:
                early = True
        for rid in r.throttled:
            bounced_at[rid] = r.now_ms
        if sess.unfinished == 0:
            break
    assert prov.n_throttled > 0, "the crunch never produced a 429"
    assert sess.stats.n_throttled == prov.n_throttled
    assert not early, "a bounced request was resent before its Retry-After"
    assert sess.unfinished == 0 and sess.stats.n_completed == 30
    assert sum(r.n_throttles for r in sess.requests()) == prov.n_throttled
    assert int(sess._state.provider.n_throttled) == prov.n_throttled


def test_retry_policy_hook():
    """The session parks a bounced request for what its `retry_policy`
    returns, given the sanitized hint and the request's bounce count."""
    calls = []

    def policy(hint, n):
        calls.append((hint, n))
        return hint * 2.0 ** (n - 1)

    prov = _crunch_provider(retry_after=300.0)
    sess = _session(prov, window=32, grants=4, policy=_patient_policy(),
                    retry_policy=policy)
    for r in _burst(30, 60.0):
        sess.submit(r)
    bounces: dict[int, list[float]] = {}
    for _ in range(1200):
        r = sess.poll()
        for rid in r.throttled:
            bounces.setdefault(rid, []).append(r.now_ms)
        if sess.unfinished == 0:
            break
    assert calls and all(h == 300.0 for h, _ in calls)
    multi = {rid: ts for rid, ts in bounces.items() if len(ts) >= 2}
    assert multi, "no request bounced twice: the hook went unexercised"
    for ts in multi.values():
        for i in range(1, len(ts)):
            assert ts[i] - ts[i - 1] >= 300.0 * 2.0 ** (i - 1)


def test_post_drain_idle_fast_path_and_submit_after_drain():
    """A drained session's polls are host-only replays of one cached
    result (no device step: the profiler counts none); a submit after
    the drain invalidates the cache and the new request completes."""
    sess = _session()
    prof = sess.enable_profiling()
    for i in range(3):
        sess.submit(Request(rid=i, prompt=None, max_new=20.0, p50=20.0,
                            bucket=0))
    sess.drain(max_polls=400)
    assert sess._idle_cache is not None
    stepped = prof["polls"]
    for _ in range(5):
        r = sess.poll()
        assert (r.actions == -1).all() and not r.progressed
    assert prof["polls"] == stepped
    assert set(prof) == {"stage", "dispatch", "pull", "grants", "polls"}
    sess.submit(Request(rid=3, prompt=None, max_new=20.0, p50=20.0, bucket=0,
                        arrival_s=sess.now_ms() / 1e3))
    assert sess._idle_cache is None
    out = sess.drain(max_polls=400)
    assert [r.status for r in out] == ["completed"] * 4
    assert prof["polls"] > stepped


class FakeClock:
    """Stands in for the `time` module inside the session's module:
    `sleep` advances `monotonic`, nothing reads the real clock."""

    def __init__(self):
        self.t = 1000.0
        self.slept = []

    def monotonic(self):
        return self.t

    def perf_counter(self):
        return self.t

    def sleep(self, s):
        self.slept.append(s)
        self.t += s


def test_wall_clock_sleeps_to_the_next_event(monkeypatch):
    """Wall mode reads the (scaled) monotonic clock and, between polls
    that move nothing, sleeps until the next actionable instant: here
    the next queued arrival, then the provider's next completion."""
    clock = FakeClock()
    monkeypatch.setattr(session_mod, "time", clock)
    sess = _session(clock="wall", cfg=dict(time_scale=2.0,
                                           max_idle_sleep_ms=10_000.0))
    assert sess.now_ms() == 0.0
    clock.t += 0.5
    assert sess.now_ms() == pytest.approx(1000.0)   # 0.5 s at 2x
    sess.submit(Request(rid=0, prompt=None, max_new=30.0, p50=30.0, bucket=0,
                        arrival_s=3.0))
    out = sess.drain(max_polls=50)
    assert out[0].status == "completed"
    assert sess.stats.n_idle_sleeps >= 2
    # the first sleep lands on the arrival: 3,000 - 1,000 session ms at 2x
    assert clock.slept[0] == pytest.approx(1.0)
    assert out[0].submit_s == pytest.approx(3.0)
    assert out[0].finish_s > out[0].submit_s


def test_drain_liveness_guard_in_wall_mode(monkeypatch):
    """A provider that never answers: the wall-clock drain sleeps at its
    cap and raises its diagnostic once `max_idle_ms` passes."""
    clock = FakeClock()
    monkeypatch.setattr(session_mod, "time", clock)
    prov = MockProvider(default_physics(), dt_ms=DT,
                        faults=FaultSchedule(seed=1, drop_frac=1.0))
    sess = _session(prov, clock="wall",
                    cfg=dict(max_idle_sleep_ms=500.0))
    sess.submit(Request(rid=0, prompt=None, max_new=30.0, p50=30.0,
                        bucket=0))
    with pytest.raises(RuntimeError, match="no progress"):
        sess.drain(max_idle_ms=5_000.0)
    assert max(clock.slept) <= 0.5 + 1e-9
