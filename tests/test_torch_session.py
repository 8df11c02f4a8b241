"""The port's live `ClientSession` against the windowed engines.

Driven in virtual time over the port's `MockProvider`, the session must
reproduce the windowed simulator's decision stream: the same action on
the same request, poll for tick, grant for grant.  Each case replays
the reference's generated batch (carried across through
`repro_torch.bridge`, as `tests/test_torch_sim.py` does) three ways:

  * the port's session (`backend="kernel"`, its plain version on the
    CPU);
  * the port's windowed `run_sim` (`collect_decisions=True`, the same
    backend), with every request's status and throttle count read at
    the last tick through `on_tick`;
  * the reference's windowed `run_sim`, jitted, as the reference's own
    session pin builds it.

Against the port's engine everything is exact: actions, the request of
every live grant, severity bits, each request's status and 429 bounces
at the horizon, and the finish time of every completion (the provider
rounds `service * jitter + now` once, as the engine's `fma32`).
Against the reference, actions, live requests, terminal statuses and
bounces are exact; finish times are held to `FLOAT_TOL` (~4 float32
ulps) and severity to `SEV_TOL`, the same rtol with an absolute floor
of one float32 ulp at 1.0 for severity near 0 (the port rounds two of
the reference's contracted multiply-adds in two steps and sums the tail
EMA's sample in float64: ROADMAP queue C, C1 and C3).

The cases are the reference pin's: `balanced`/medium at N = 48, W = 64,
B = 4, 900 polls, seeds 0 and 1; `heavy`/high at 3x the arrival rate,
N = 96, W = 128, 1,200 polls (defers and rejects flow).  The
nonstationary ones (`flash_crowd`, `storm`) are in
`test_torch_session_scenarios.py`, which imports this file's harness.
No reference `ClientSession` is built here.
"""
import functools

import jax
import numpy as np
import torch

from repro.core.policy import strategy as ref_strategy
from repro.sim import scenarios as rscn
from repro.sim.engine import SimConfig as RefSimConfig
from repro.sim.engine import run_sim as ref_run_sim
from repro.sim.provider import default_physics as ref_physics
from repro.sim.workload import WorkloadConfig as RefWorkloadConfig
from repro.sim.workload import generate as ref_generate
from repro_torch.bridge import from_numpy
from repro_torch.client import ClientSession, MockProvider, Request, SessionConfig
from repro_torch.core.policy import strategy
from repro_torch.core.scheduler import IDLE
from repro_torch.core.types import (
    ABANDONED,
    COMPLETED,
    INFLIGHT,
    PENDING,
    REJECTED,
)
from repro_torch.sim import SimConfig, default_physics, run_sim
from repro_torch.sim import scenarios as scn

FLOAT_TOL = dict(rtol=5e-7, atol=0)   # ~4 float32 ulps, as test_torch_sim
# severity near 0 (a near-idle provider) carries the tail EMA's absolute
# error, which lives at the EMA's scale of 1.0: one float32 ulp there
# (ROADMAP queue C, C3: at most 1.19e-7 against the reference)
SEV_TOL = dict(rtol=5e-7, atol=2.0 ** -23)
DT, B = 25.0, 4
POLICY = "final_adrr_olc"
CODES = {"pending": PENDING, "inflight": INFLIGHT, "completed": COMPLETED,
         "rejected": REJECTED, "abandoned": ABANDONED}

# (workload or scenario, seed, polls, window, arrival scale)
CASES = {
    "balanced_s0": (dict(n_requests=48, mix="balanced", congestion="medium"),
                    0, 900, 64, 1.0),
    "balanced_s1": (dict(n_requests=48, mix="balanced", congestion="medium"),
                    1, 900, 64, 1.0),
    "heavy_high": (dict(n_requests=96, mix="heavy", congestion="high",
                        arrival_scale=3.0), 2, 1200, 128, 1.0),
    "flash_crowd": ("flash_crowd", 3, 1200, 128, 1.0),
    "storm": ("storm", 0, 1604, 256, 4.0),
}
SCENARIO_N = {"flash_crowd": 96, "storm": 160}

_ref_run = jax.jit(ref_run_sim, static_argnames=("sim_cfg",
                                                 "collect_decisions"))


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def batch_to_requests(batch, jitter) -> list[Request]:
    """A generated batch (numpy leaves) as session submissions; arrival
    order is request-id order, the generator's native sort."""
    arr, bucket, cls = batch.arrival_ms, batch.bucket, batch.cls
    tok, p50, p90 = batch.true_tokens, batch.p50, batch.p90
    return [
        Request(rid=i, prompt=None, max_new=float(tok[i]), p50=float(p50[i]),
                bucket=int(bucket[i]), p90=float(p90[i]), cls=int(cls[i]),
                arrival_s=float(arr[i]) / 1e3, jitter=float(jitter[i]))
        for i in range(arr.shape[0])
    ]


@functools.lru_cache(maxsize=None)
def ref_case(name):
    """The reference's batch, dynamics (or None) and windowed run."""
    spec, seed, polls, window, scale = CASES[name]
    dynamics = None
    if isinstance(spec, str):
        wl, sched, dynamics, _ = rscn.build(
            rscn.get_scenario(spec), SCENARIO_N[spec], polls, DT,
            limiter_classes=2, arrival_scale=scale)
        batch, jitter = ref_generate(jax.random.PRNGKey(seed), wl, sched)
    else:
        batch, jitter = ref_generate(jax.random.PRNGKey(seed),
                                     RefWorkloadConfig(**spec))
    final, trace = _ref_run(
        ref_strategy(POLICY), batch, jitter, ref_physics(),
        sim_cfg=RefSimConfig(n_ticks=polls, k_slots=B, window=window),
        dynamics=dynamics, collect_decisions=True)
    return (np_tree(batch), np.asarray(jitter),
            None if dynamics is None else np_tree(dynamics),
            np_tree(final), np_tree(trace))


def provider_for(name) -> MockProvider:
    """The case's provider: the stationary physics, or the scenario's
    schedules through `MockProvider.from_scenario`."""
    spec, _, polls, _, scale = CASES[name]
    if isinstance(spec, str):
        return MockProvider.from_scenario(
            scn.get_scenario(spec), SCENARIO_N[spec], polls, DT, 2,
            arrival_scale=scale)
    return MockProvider(default_physics(), dt_ms=DT)


@functools.lru_cache(maxsize=None)
def port_engine_case(name):
    """The port's windowed run_sim on the reference's batch: the trace,
    and each request's status and throttle count at the last tick."""
    batch, jitter, dynamics, _, _ = ref_case(name)
    _, _, polls, window, _ = CASES[name]
    last = {}

    def on_tick(t, state, win):
        if t == polls - 1:
            last["status"] = state.req.status.clone()
            last["n_throttles"] = state.req.n_throttles.clone()
            last["n_throttled"] = int(state.provider.n_throttled)

    final, trace = run_sim(
        strategy(POLICY), from_numpy(batch, "cpu"), from_numpy(jitter, "cpu"),
        default_physics(),
        SimConfig(n_ticks=polls, k_slots=B, window=window),
        None if dynamics is None else from_numpy(dynamics, "cpu"),
        collect_decisions=True, device="cpu", on_tick=on_tick)
    return ([t.numpy() for t in trace], last["status"].numpy(),
            last["n_throttles"].numpy(), last["n_throttled"],
            final.req.finish_ms.numpy())


@functools.lru_cache(maxsize=None)
def session_case(name):
    """The port's session over the same batch, `polls` virtual polls."""
    batch, jitter, _, _, _ = ref_case(name)
    _, _, polls, window, _ = CASES[name]
    phys = default_physics()
    sess = ClientSession(
        provider_for(name), strategy(POLICY),
        SessionConfig(window=window, max_grants=B, dt_ms=DT),
        clock="virtual", phys=phys, device="cpu")
    for r in batch_to_requests(batch, jitter):
        sess.submit(r)
    acts, rids, sevs = [], [], []
    for _ in range(polls):
        r = sess.poll()
        acts.append(r.actions)
        rids.append(r.req_rids)
        sevs.append(r.severity)
    return sess, np.stack(acts), np.stack(rids), np.asarray(sevs, np.float32)


def check_case(name):
    """Session = port engine exactly; session = reference within the
    stated tolerances.  Returns the session for case-specific checks."""
    _, _, _, rfin, (ra, ri, rs) = ref_case(name)
    (pa, pi, ps), p_status, p_thr, p_n_thr, p_finish = port_engine_case(name)
    sess, sa, si, ss = session_case(name)
    live = pa != IDLE
    assert live.sum() > 10, "an idle trace pins nothing"

    # decisions: the port's engine and the reference's
    np.testing.assert_array_equal(sa, pa)
    np.testing.assert_array_equal(si[live], pi[live])
    assert (si[~live] == -1).all()
    np.testing.assert_array_equal(sa, ra)
    np.testing.assert_array_equal(si[live], ri[live])
    # severity: bit-equal to the port's engine, FLOAT_TOL to the reference
    np.testing.assert_array_equal(ss.view(np.int32), ps.view(np.int32))
    np.testing.assert_allclose(ss, rs, **SEV_TOL)

    # each request's status and bounces at the horizon
    reqs = sess.requests()
    s_status = np.asarray([CODES[r.status] for r in reqs], np.int32)
    s_thr = np.asarray([r.n_throttles for r in reqs], np.int32)
    np.testing.assert_array_equal(s_status, p_status)
    np.testing.assert_array_equal(s_thr, p_thr)
    assert sess.stats.n_throttled == p_n_thr == sess.provider.n_throttled
    term = s_status >= COMPLETED
    np.testing.assert_array_equal(s_status[term], rfin.req.status[term])
    np.testing.assert_array_equal(s_thr, rfin.req.n_throttles)
    assert p_n_thr == int(rfin.provider.n_throttled)

    # finish times of the completions: the provider's bits are the
    # engine's; the reference's within FLOAT_TOL
    done = s_status == COMPLETED
    assert done.sum() > 10
    s_fin = np.asarray([np.float32(r.finish_s * 1e3) for r in reqs],
                       np.float32)
    np.testing.assert_array_equal(s_fin[done].view(np.int32),
                                  p_finish[done].view(np.int32))
    np.testing.assert_allclose(s_fin[done], rfin.req.finish_ms[done],
                               **FLOAT_TOL)
    return sess


def test_balanced_pinned():
    sess = check_case("balanced_s0")
    assert sess.stats.n_admitted > 10 and sess.stats.n_completed > 10


def test_balanced_seed1():
    check_case("balanced_s1")


def test_heavy_high_overload_path():
    """Overload (arrivals at 3x): the cost ladder fires, and defers and
    rejects flow through the same parity."""
    sess = check_case("heavy_high")
    assert sess.stats.n_rejected + sess.stats.n_deferred > 0


def test_session_runs_the_kernel_backend_by_default():
    """`SessionConfig.backend` takes the port's names; "kernel" (the
    ordering layer's `sched_score_topb`, here its plain version) is the
    default, and an unknown name raises before anything runs."""
    assert SessionConfig().backend == "kernel"
    sess = ClientSession(MockProvider(), strategy(POLICY),
                         SessionConfig(window=8, max_grants=2),
                         clock="virtual", device="cpu")
    assert sess.device == torch.device("cpu")
    try:
        ClientSession(MockProvider(), strategy(POLICY),
                      SessionConfig(backend="pallas"), clock="virtual",
                      device="cpu")
    except ValueError as e:
        assert "pallas" in str(e)
    else:
        raise AssertionError("an unknown backend was accepted")
