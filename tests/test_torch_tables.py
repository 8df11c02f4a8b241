"""The paper's policy variants on the port, against the JAX reference.

1. Every field of each variant's `PolicyConfig` (the information ladder,
   the overload shapes, the 4-lane and K-tenant policies) and of
   `physics_for_arch` equals the reference's, with the same errors on
   unknown names.
2. `schedule_slot` on states taken from a reference run at several
   ticks: action, request index and FQ pointer exact, severity and
   deficit within `FLOAT_TOL`; the port's `schedule_batch(max_grants=1)`
   makes its own `schedule_slot`'s decision bit for bit.
3. `charge_resubmit`: a zero charge (also on a -0.0 entry) and a mode
   other than ADRR leave the deficits' bits unchanged, a debit that is
   not finite is refused.
4. The paper tables' cells at smoke size (N = 160, 1,000 ticks, W =
   192): the reference's draws go through `repro_torch.bridge` into the
   port's `run_sim`; decisions and statuses must be equal and metrics
   within `METRIC_TOL`.

`FLOAT_TOL` is a few float32 ulps (atol for values near 0): XLA:CPU
contracts some of the reference's multiply-adds into FMAs and the port
sums the class axis in float64 (ROADMAP queue C, C1 and C3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as rpolicy
from repro.core import scheduler as rscheduler
from repro.core.types import init_sim_state as ref_init_state
from repro.sim import provider as rprovider
from repro.sim.engine import SimConfig as RefSimConfig
from repro.sim.engine import _complete_and_timeout as ref_complete_and_timeout
from repro.sim.engine import run_sim as ref_run_sim
from repro.sim.engine import sim_tick as ref_sim_tick
from repro.sim.metrics import compute_metrics as ref_compute_metrics
from repro.sim.workload import WorkloadConfig as RefWorkloadConfig
from repro.sim.workload import generate as ref_generate
from repro_torch.bridge import from_numpy, to_numpy
from repro_torch.core import policy
from repro_torch.core.scheduler import (
    IDLE,
    charge_resubmit,
    schedule_batch,
    schedule_slot,
)
from repro_torch.sim import SimConfig, compute_metrics, run_sim
from repro_torch.sim.provider import physics_for_arch

torch.set_num_threads(1)

FLOAT_TOL = dict(rtol=5e-7, atol=1e-6)
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
N, T, B, W = 160, 1000, 4, 192
LEVELS = ["no_info", "class_only", "coarse", "oracle"]
SHAPES = ["ladder", "uniform_mild", "uniform_harsh", "reverse"]
SLOT_TICKS = 700


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def port(x):
    return from_numpy(np_tree(x), "cpu")


def assert_fields_equal(p, r):
    r = np_tree(r)
    assert p._fields == r._fields
    for f in r._fields:
        want, got = getattr(r, f), getattr(p, f)
        if not isinstance(got, torch.Tensor):  # alloc_mode, a Python int
            assert got == int(want), f
            continue
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
        assert got.numpy().dtype == want.dtype, f


class TestVariants:
    @pytest.mark.parametrize("level", LEVELS)
    @pytest.mark.parametrize("base", ["final_adrr_olc", "quota_tiered"])
    def test_with_information(self, level, base):
        assert_fields_equal(
            policy.with_information(policy.strategy(base), level),
            rpolicy.with_information(rpolicy.strategy(base), level))

    @pytest.mark.parametrize("shape", SHAPES)
    def test_with_bucket_policy(self, shape):
        assert_fields_equal(
            policy.with_bucket_policy(policy.final_adrr_olc(), shape),
            rpolicy.with_bucket_policy(rpolicy.final_adrr_olc(), shape))

    @pytest.mark.parametrize("k", [1, 2, 4, 8])
    def test_multi_tenant_policy(self, k):
        assert_fields_equal(policy.multi_tenant_policy(k),
                            rpolicy.multi_tenant_policy(k))

    def test_per_bucket_policy(self):
        assert_fields_equal(policy.per_bucket_policy(),
                            rpolicy.per_bucket_policy())
        assert_fields_equal(policy.per_bucket_policy(max_inflight=12.0),
                            rpolicy.per_bucket_policy(max_inflight=12.0))

    @pytest.mark.parametrize("ms,base", [(6.5, 90.0), (13.0, 90.0),
                                         (2.25, 40.0)])
    def test_physics_for_arch(self, ms, base):
        assert_fields_equal(physics_for_arch(ms, base_ms=base),
                            rprovider.physics_for_arch(ms, base_ms=base))

    def test_unknown_names_raise_as_in_the_reference(self):
        for mod in (policy, rpolicy):
            with pytest.raises(ValueError, match="unknown information"):
                mod.with_information(mod.final_adrr_olc(), "psychic")
            with pytest.raises(KeyError):
                mod.with_bucket_policy(mod.final_adrr_olc(), "zigzag")
            with pytest.raises(ValueError):
                mod.multi_tenant_policy(0)


@jax.jit
def _ref_tick_states(cfg, batch, jitter):
    """The SimState each tick of a dense reference run hands to its
    dispatch (after the completion and timeout pass), stacked over
    `SLOT_TICKS` ticks."""
    phys = rprovider.default_physics()

    def body(s, i):
        now = (i + 1).astype(jnp.float32) * 25.0
        seen = ref_complete_and_timeout(cfg, phys, batch,
                                        s._replace(now_ms=now))
        s, _, _ = ref_sim_tick(cfg, phys, batch, jitter, s, None,
                               (i, None, None, None), dt_ms=25.0,
                               k_slots=B, backend="jnp")
        return s, seen

    return jax.lax.scan(body, ref_init_state(N, rpolicy.n_classes(cfg)),
                        jnp.arange(SLOT_TICKS))[1]


def _ref_states(name, ticks):
    """The reference's policy, batch (heavy/high at 8x the rate, so that
    the overload layer defers and rejects too; N = 160, seed 2) and the
    states its dispatch saw at `ticks`."""
    batch, jitter = ref_generate(jax.random.PRNGKey(2), RefWorkloadConfig(
        n_requests=N, mix="heavy", congestion="high", arrival_scale=8.0))
    cfg = rpolicy.strategy(name)
    seen = _ref_tick_states(cfg, batch, jitter)
    return cfg, batch, [jax.tree.map(lambda x, t=t: x[t], seen)
                        for t in ticks]


_ref_slot = jax.jit(rscheduler.schedule_slot)


class TestScheduleSlot:
    @pytest.mark.parametrize("name", ["final_adrr_olc", "fair_queuing",
                                      "direct_naive", "quota_tiered",
                                      "short_priority"])
    def test_matches_reference_and_batch_of_one(self, name):
        cfg, batch, states = _ref_states(name, range(0, SLOT_TICKS, 7))
        pcfg, pbatch = port(cfg), port(batch)
        live = 0
        for state in states:
            r = np_tree(_ref_slot(cfg, batch, state))
            pstate = port(state)
            p = schedule_slot(pcfg, pbatch, pstate)
            assert int(p.action) == int(r.action)
            if int(r.action) != IDLE:
                live += 1
                assert int(p.req_idx) == int(r.req_idx)
            assert int(p.rr_turn) == int(r.rr_turn)
            np.testing.assert_allclose(p.severity.numpy(), r.severity,
                                       **FLOAT_TOL)
            np.testing.assert_allclose(p.deficit.numpy(), r.deficit,
                                       **FLOAT_TOL)
            # the port's batch of one is its slot, bit for bit
            d = schedule_batch(pcfg, pbatch, pstate, max_grants=1)
            assert int(d.actions[0]) == int(p.action)
            if int(p.action) != IDLE:
                assert int(d.req_idx[0]) == int(p.req_idx)
            assert int(d.rr_turn) == int(p.rr_turn)
            for a, b in ((d.severity, p.severity), (d.deficit, p.deficit)):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert live >= 5  # the states hold real decisions


class TestChargeResubmit:
    def test_zero_charge_keeps_bits(self):
        cfg = policy.final_adrr_olc()
        deficit = torch.tensor([-0.0, 37.5])
        out = charge_resubmit(cfg, deficit, torch.zeros(2))
        assert torch.equal(out.view(torch.int32), deficit.view(torch.int32))
        assert torch.signbit(out[0])

    def test_other_modes_keep_deficit(self):
        deficit = torch.tensor([120.0, 9.25])
        for name in ("fair_queuing", "quota_tiered", "direct_naive",
                     "short_priority"):
            out = charge_resubmit(policy.strategy(name), deficit,
                                  torch.tensor([50.0, 0.0]))
            assert torch.equal(out, deficit), name

    def test_non_finite_debit_refused(self):
        cfg = policy.final_adrr_olc()
        deficit = torch.tensor([120.0, 9.25])
        out = charge_resubmit(cfg, deficit, torch.tensor([float("inf"), 1.0]))
        assert torch.equal(out, deficit)

    @pytest.mark.parametrize("name", ["final_adrr_olc", "fair_queuing"])
    def test_matches_reference(self, name):
        rng = np.random.default_rng(4)
        for _ in range(10):
            deficit = rng.uniform(-50, 3000, 3).astype(np.float32)
            charge = np.where(rng.uniform(size=3) < 0.5, 0.0,
                              rng.uniform(0, 900, 3)).astype(np.float32)
            r = np.asarray(rscheduler.charge_resubmit(
                rpolicy.strategy(name), jnp.asarray(deficit),
                jnp.asarray(charge)))
            p = charge_resubmit(policy.strategy(name),
                                torch.from_numpy(deficit),
                                torch.from_numpy(charge)).numpy()
            np.testing.assert_array_equal(p.view(np.int32), r.view(np.int32))


# the tables' cells at smoke size: (policy function, workload overrides)
CELLS = {
    **{f"info_{lv}": (lambda m, lv=lv: m.with_information(
        m.final_adrr_olc(), lv), dict(information=lv)) for lv in LEVELS},
    # heavy/high at twice the others' rate, so its 160 requests arrive
    # inside the horizon as the balanced ones do
    **{f"shape_{sh}": (lambda m, sh=sh: m.with_bucket_policy(
        m.final_adrr_olc(), sh), dict(mix="heavy", arrival_scale=8.0))
       for sh in SHAPES},
    "noise_0.6": (lambda m: m.final_adrr_olc(), dict(predictor_noise=0.6)),
    "sharegpt": (lambda m: m.final_adrr_olc(), dict(mix="sharegpt")),
    "per_bucket": (lambda m: m.per_bucket_policy(),
                   dict(class_map="bucket4")),
    "tenant4": (lambda m: m.multi_tenant_policy(4),
                dict(class_map="tenant4")),
}

_ref_cell_run = jax.jit(
    lambda p, b, j, ph: ref_run_sim(
        p, b, j, ph, RefSimConfig(n_ticks=T, k_slots=B, window=W),
        collect_decisions=True))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_table_cell_matches_reference(cell):
    build, wl = CELLS[cell]
    wl = dict(dict(n_requests=N, mix="balanced", congestion="high",
                   arrival_scale=4.0), **wl)
    rcfg = build(rpolicy)
    k = int(rpolicy.n_classes(rcfg))
    batch, jitter = ref_generate(jax.random.PRNGKey(0),
                                 RefWorkloadConfig(**wl))
    phys = rprovider.default_physics()
    rfin, (ra, ri, rs) = np_tree(_ref_cell_run(rcfg, batch, jitter, phys))
    rm = np_tree(ref_compute_metrics(batch, rfin, k))

    pcfg = build(policy)
    assert_fields_equal(pcfg, rcfg)
    pb = port(batch)
    pfin, (pa, pi, ps) = run_sim(
        pcfg, pb, port(jitter), port(phys),
        SimConfig(n_ticks=T, k_slots=B, window=W, ordering_backend="torch"),
        collect_decisions=True, device="cpu")
    pm = to_numpy(compute_metrics(pb, pfin, k))
    pfin = to_numpy(pfin)

    np.testing.assert_array_equal(pa.numpy(), ra)
    live = ra >= 0
    # real grants, not an idle trace (under heavy overload many requests
    # time out in the queue without a decision)
    assert live.sum() > N // 4
    np.testing.assert_array_equal(pi.numpy()[live], ri[live])
    np.testing.assert_allclose(ps.numpy(), rs, **FLOAT_TOL)
    np.testing.assert_array_equal(pfin.req.status, rfin.req.status)
    np.testing.assert_array_equal(pfin.req.n_defers, rfin.req.n_defers)
    for f in rm._fields:
        np.testing.assert_allclose(np.asarray(getattr(pm, f), np.float64),
                                   np.asarray(getattr(rm, f), np.float64),
                                   err_msg=f, **METRIC_TOL)
