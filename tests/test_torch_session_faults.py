"""The port's session against a provider that breaks its contract.

1. Ingestion is idempotent: a delivery layer that duplicates completions
   within a poll, redelivers retired tickets later with diverging
   finish stamps, and shuffles every poll's batch leaves the device
   state, the host mirrors, the statistics and every request's outcome
   bit-identical to clean exactly-once delivery (the reference's
   property, here over a handful of fixed seeds).
2. On an honest provider the armed watchdog changes nothing: the same
   decisions, outcomes and completion stream as the trusting session.
3. Liveness: `drain(max_idle_ms=...)` turns a completion that never
   comes into a diagnostic error; a healthy drain never trips it.
4. Recovery, with the chip check's configuration (`chip_smoke.py` phase
   5f, `session_recovery`): `silent_drop`, `stuck_tail` and `dup_storm`
   at N = 32, the arrivals and the provider's schedules built over
   1,600 ticks, `ResilienceConfig(timeout_mult=3.0, max_resubmits=3)`,
   the port's generator at seed 0, polled until everything is terminal,
   at most 9,000 polls (the reference's horizon for these gates).  The
   reference's gates (`tests/test_faults.py`): completion >= 0.99,
   nothing unfinished, resubmits where a fault fired, the storm of
   duplicates completed with duplicates discarded, and no request
   retired twice.  The trusting control gets the same horizon as the
   watchdog's run; it stops early once nothing can change inside that
   horizon (no queued or pending request, and the provider's next event
   past it), which leaves its outcome as it would be at the horizon.
   `stuck_tail`, whose xlong request needs ~3,800 polls, runs in
   `test_torch_session_recovery.py` to keep each file under a minute.

Everything runs on the port alone (its generator, its session); no test
reads the wall clock.
"""
import random

import numpy as np
import pytest
import torch

from repro_torch.client import (
    ClientSession,
    Completion,
    MockProvider,
    Request,
    ResilienceConfig,
    SessionConfig,
)
from repro_torch.core.policy import final_adrr_olc
from repro_torch.core.types import INFLIGHT
from repro_torch.sim import generate
from repro_torch.sim.faults import FaultSchedule
from repro_torch.sim.scenarios import build, get_scenario

DT = 25.0
# the chip check's recovery configuration (section 4)
RES = ResilienceConfig(timeout_mult=3.0, max_resubmits=3)
N, HORIZON, CAP = 32, 1600, 9000


def scenario_requests(name: str, n: int, n_ticks: int, seed: int):
    """A registry scenario's arrivals from the port's generator, as
    session submissions."""
    wl, sched, _, _ = build(get_scenario(name), n, n_ticks, DT)
    batch, jitter = generate(wl, torch.Generator().manual_seed(seed),
                             device="cpu", sched=sched)
    a = [x.numpy() for x in batch]
    j = jitter.numpy()
    return [Request(rid=i, prompt=None, max_new=float(a[3][i]),
                    p50=float(a[4][i]), bucket=int(a[1][i]),
                    p90=float(a[5][i]), cls=int(a[2][i]),
                    arrival_s=float(a[0][i]) / 1e3, jitter=float(j[i]))
            for i in range(batch.n)]


def _session(provider, resilience=None):
    return ClientSession(provider, final_adrr_olc(), SessionConfig(),
                         clock="virtual", resilience=resilience,
                         device="cpu")


# ---------------------------------------------------------------------------
# 1. duplicate-safe ingestion
# ---------------------------------------------------------------------------

class PerturbingProvider:
    """Wraps an honest provider and breaks delivery only: completions may
    be duplicated in the same poll (identical payload), redelivered in
    later polls with a diverging finish stamp (the dead-ticket path, up
    to long after retirement), and every poll's batch is shuffled.  The
    first delivery of each ticket is never delayed, so the stream holds
    the same information, and the session's state must not change."""

    def __init__(self, inner, rng, dup_p: float, late_p: float):
        self.inner = inner
        self._rng = rng
        self._dup_p = dup_p
        self._late_p = late_p
        self._poll_no = 0
        self._late: list[tuple[int, Completion]] = []

    def submit(self, req, now_ms, inflight_hint=None):
        return self.inner.submit(req, now_ms, inflight_hint=inflight_hint)

    def poll(self, now_ms):
        self._poll_no += 1
        fresh = list(self.inner.poll(now_ms))
        out = list(fresh)
        for c in fresh:
            if self._rng.random() < self._dup_p:
                out.append(c)
            if self._rng.random() < self._late_p:
                at = self._poll_no + self._rng.randint(1, 400)
                self._late.append((at, Completion(
                    c.ticket, c.finish_ms + self._rng.uniform(1.0, 1e4),
                    None)))
        due = [c for at, c in self._late if at <= self._poll_no]
        if due:
            self._late = [(at, c) for at, c in self._late
                          if at > self._poll_no]
            out.extend(due)
        self._rng.shuffle(out)
        return out

    def inflight(self):
        return self.inner.inflight()

    def next_event_ms(self, now_ms):
        return self.inner.next_event_ms(now_ms)


IDEM_N, IDEM_POLLS = 16, 400


def _run_fixed(provider, reqs):
    sess = _session(provider)
    for r in reqs:
        sess.submit(r)
    for _ in range(IDEM_POLLS):
        sess.poll()
    return sess


_CLEAN = {}


def _clean_run():
    if "sess" not in _CLEAN:
        _CLEAN["sess"] = _run_fixed(
            MockProvider(dt_ms=DT),
            scenario_requests("balanced", IDEM_N, IDEM_POLLS, 0))
    return _CLEAN["sess"]


@pytest.mark.parametrize("perturb_seed,dup_p,late_p", [
    (0, 0.5, 0.5), (1, 1.0, 0.0), (2, 0.0, 1.0), (3, 0.9, 0.9)])
def test_duplicate_reorder_late_deliveries_are_invisible(perturb_seed, dup_p,
                                                         late_p):
    clean = _clean_run()
    perturbed = _run_fixed(
        PerturbingProvider(MockProvider(dt_ms=DT),
                           random.Random(perturb_seed), dup_p, late_p),
        scenario_requests("balanced", IDEM_N, IDEM_POLLS, 0))
    assert clean.stats.n_dup_discarded == 0
    assert clean.stats.n_late_discarded == 0
    assert clean.stats.n_completed > 5
    assert (perturbed.stats.n_dup_discarded
            + perturbed.stats.n_late_discarded) > 0
    # the device state and the window pool, leaf for leaf, bit for bit
    for tree in ("_state", "_win_batch"):
        a_leaves, b_leaves = getattr(clean, tree), getattr(perturbed, tree)
        for a, b in zip(torch.utils._pytree.tree_leaves(a_leaves),
                        torch.utils._pytree.tree_leaves(b_leaves)):
            assert (a is None and b is None) or torch.equal(a, b)
    for name in ("_slot_rid", "_slot_status", "_slot_arrival",
                 "_slot_thresh", "_slot_finish"):
        np.testing.assert_array_equal(getattr(clean, name),
                                      getattr(perturbed, name))
    assert clean._n_live == perturbed._n_live
    for f in ("n_polls", "n_admitted", "n_completed", "n_abandoned",
              "n_rejected", "n_deferred", "n_throttled"):
        assert getattr(clean.stats, f) == getattr(perturbed.stats, f)
    for rc, rp in zip(clean.requests(), perturbed.requests()):
        assert (rc.status, rc.finish_s) == (rp.status, rp.finish_s)


# ---------------------------------------------------------------------------
# 2. an honest provider: the watchdog is invisible
# ---------------------------------------------------------------------------

def test_clean_workload_resilience_is_invisible():
    """On an honest provider the armed watchdog is a no-op: the same
    decisions, outcomes and completion stream as the trusting session."""
    n, polls = 12, 500
    out = []
    for res in (None, ResilienceConfig()):
        sess = _session(MockProvider(dt_ms=DT), res)
        for r in scenario_requests("balanced", n, polls, 1):
            sess.submit(r)
        acts = [sess.poll().actions for _ in range(polls)]
        out.append((sess, np.stack(acts)))
    (off, a_off), (on, a_on) = out
    assert off.stats.n_completed > 5
    assert on.stats.n_resubmitted == 0 and on.stats.n_gave_up == 0
    np.testing.assert_array_equal(a_off, a_on)
    for ro, rn in zip(off.requests(), on.requests()):
        assert (ro.status, ro.finish_s) == (rn.status, rn.finish_s)


# ---------------------------------------------------------------------------
# 3. the drain's liveness guard
# ---------------------------------------------------------------------------

def test_max_idle_raises_diagnostic():
    """Every completion silently dropped and no watchdog: the drain fails
    fast with a diagnostic naming the wedged state."""
    prov = MockProvider(dt_ms=DT, faults=FaultSchedule(seed=1, drop_frac=1.0))
    sess = _session(prov)
    for i in range(4):
        sess.submit(Request(rid=i, prompt=None, max_new=40.0, p50=40.0,
                            bucket=0, arrival_s=0.1 * i))
    with pytest.raises(RuntimeError) as ei:
        sess.drain(max_idle_ms=2_000.0)
    msg = str(ei.value)
    for part in ("no progress", "live slots", "inflight", "rid="):
        assert part in msg


def test_max_idle_not_triggered_on_healthy_drain():
    sess = _session(MockProvider(dt_ms=DT))
    for r in scenario_requests("balanced", 6, 2000, 0):
        sess.submit(r)
    out = sess.drain(max_polls=4000, max_idle_ms=60_000.0)
    assert all(r.status == "completed" for r in out)


# ---------------------------------------------------------------------------
# 4. recovery from the registry's fault schedules
# ---------------------------------------------------------------------------

def terminal_excess(sess) -> int:
    """Terminal counters over per-request terminal statuses: a request
    retired twice shows as a positive excess."""
    n_status = sum(1 for r in sess.requests()
                   if r.status in ("completed", "abandoned", "rejected"))
    return (sess.stats.n_completed + sess.stats.n_abandoned
            + sess.stats.n_rejected) - n_status


def _settled(sess, horizon_ms: float) -> bool:
    """Nothing can move before `horizon_ms`: no request queued or
    pending, and the provider's next event (a completion, a delayed
    duplicate, a refill) after it."""
    live = sess._slot_status[:sess._n_live]
    if sess._queue or (live != INFLIGHT).any():
        return False
    nxt = sess.provider.next_event_ms(sess.now_ms())
    return nxt is None or nxt > horizon_ms


def recovery_run(name, resilience, n=N, cap=CAP, seed=0,
                 settle_ms=None):
    prov = MockProvider.from_scenario(get_scenario(name), n, HORIZON, DT, 2)
    sess = _session(prov, resilience)
    for r in scenario_requests(name, n, HORIZON, seed):
        sess.submit(r)
    polls = 0
    while sess.unfinished and polls < cap:
        sess.poll()
        polls += 1
        if settle_ms is not None and _settled(sess, settle_ms):
            break
    return sess, prov, polls


def completion(sess) -> float:
    reqs = sess.requests()
    return sum(r.status == "completed" for r in reqs) / len(reqs)


def check_recovery(name):
    """The watchdog's run holds the reference's gates; the trusting
    control over the same horizon loses the faulted work."""
    on, prov_on, polls = recovery_run(name, RES)
    assert prov_on.n_dropped + prov_on.n_stuck > 0   # the fault fired
    assert on.stats.n_resubmitted > 0                # the watchdog worked
    assert completion(on) >= 0.99
    assert on.unfinished == 0 and polls < CAP
    assert terminal_excess(on) == 0
    # the trusting control over the same horizon keeps its wedged
    # INFLIGHT slots and loses their work
    off, _, _ = recovery_run(name, None, cap=polls,
                             settle_ms=polls * DT)
    assert off.unfinished > 0
    assert completion(off) <= completion(on) - 0.05
    assert terminal_excess(off) == 0


def test_watchdog_recovers_what_the_control_loses_silent_drop():
    check_recovery("silent_drop")


def test_dup_storm_completes_without_double_retire():
    on, prov, polls = recovery_run("dup_storm", RES)
    assert prov.n_duped > 0 and polls < CAP
    assert all(r.status == "completed" for r in on.requests())
    assert on.stats.n_dup_discarded > 0
    assert terminal_excess(on) == 0
    # duplicate-safe ingestion is not gated on the watchdog
    off, _, _ = recovery_run("dup_storm", None, n=12)
    assert all(r.status == "completed" for r in off.requests())
    assert off.stats.n_dup_discarded > 0
    assert terminal_excess(off) == 0
