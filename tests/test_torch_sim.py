"""The port's simulator against the JAX reference, and against itself.

1. The reference's `generate` output is carried into the port through
   `repro_torch.bridge` and both packages run the same horizon, dense
   and windowed.  Backends are paired: the port's "torch" against the
   reference's "jnp", and the port's "kernel" path (its plain version,
   on the CPU) against the reference's "pallas" (interpret mode).
   Actions, request indices of every grant that is not IDLE, and
   terminal statuses must be equal; float results are held to
   `FLOAT_TOL`.  The floats may differ by an ulp: under jax 0.9 XLA:CPU
   contracts the reference's `base_ms + ms_per_token * tokens`
   (`sim/provider.py:99`) into an FMA despite its pinned product, which
   the port rounds in two steps (ROADMAP queue C).
2. The port's windowed engine against its dense engine, bit for bit
   (the reference's own contract, `tests/test_window_engine.py`).
3. The port's generator against the reference's, by distribution: the
   two draw different numbers from a seed.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core.policy import strategy as ref_strategy
from repro.sim.engine import SimConfig as RefSimConfig
from repro.sim.engine import run_sim as ref_run_sim
from repro.sim.metrics import compute_metrics as ref_compute_metrics
from repro.sim.provider import default_physics as ref_physics
from repro.sim.workload import WorkloadConfig as RefWorkloadConfig
from repro.sim.workload import generate as ref_generate
from repro_torch.bridge import from_numpy, to_numpy
from repro_torch.core.policy import strategy
from repro_torch.core.types import COMPLETED, INFLIGHT, PENDING
from repro_torch.sim.provider import (
    Fleet,
    FleetDynamics,
    no_dynamics,
    uniform_fleet_physics,
)
from repro_torch.sim import (
    SimConfig,
    WorkloadConfig,
    compute_metrics,
    default_physics,
    generate,
    run_cell,
    run_sim,
    window_for,
)

torch.set_num_threads(1)

FLOAT_TOL = dict(rtol=5e-7, atol=0)   # ~4 float32 ulps
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
N, T, B, W = 160, 1000, 4, 192
WL = dict(n_requests=N, mix="balanced", congestion="high", arrival_scale=4.0)


def np_tree(x):
    return jax.tree.map(np.asarray, x)


@functools.lru_cache(maxsize=None)
def ref_run(seed, window, backend, name="final_adrr_olc", n_ticks=T):
    batch, jitter = ref_generate(jax.random.PRNGKey(seed),
                                 RefWorkloadConfig(**WL))
    cfg = RefSimConfig(n_ticks=n_ticks, k_slots=B, window=window,
                       ordering_backend=backend)
    final, trace = jax.jit(
        lambda p, b, j, ph: ref_run_sim(p, b, j, ph, cfg,
                                        collect_decisions=True))(
        ref_strategy(name), batch, jitter, ref_physics())
    metrics = ref_compute_metrics(batch, final, 2)
    return np_tree(batch), np.asarray(jitter), np_tree(final), \
        np_tree(trace), np_tree(metrics)


@functools.lru_cache(maxsize=None)
def port_run(seed, window, backend, name="final_adrr_olc", n_ticks=T):
    batch, jitter, _, _, _ = ref_run(seed, window,
                                     "jnp" if backend == "torch" else "pallas",
                                     name, n_ticks)
    pb, pj = from_numpy(batch, "cpu"), from_numpy(jitter, "cpu")
    final, trace = run_sim(
        from_numpy(np_tree(ref_strategy(name)), "cpu"), pb, pj,
        from_numpy(np_tree(ref_physics()), "cpu"),
        SimConfig(n_ticks=n_ticks, k_slots=B, window=window,
                  ordering_backend=backend),
        collect_decisions=True, device="cpu")
    return to_numpy(final), to_numpy(trace), to_numpy(
        compute_metrics(pb, final, 2))


PAIRS = [("torch", "jnp"), ("kernel", "pallas")]


class TestAgainstReference:
    @pytest.mark.parametrize("window,backend,ref_backend", [
        (None, "torch", "jnp"), (W, "torch", "jnp"), (W, "kernel", "pallas")])
    def test_decisions_and_statuses(self, window, backend, ref_backend):
        _, _, rfin, (ra, ri, rs), _ = ref_run(0, window, ref_backend)
        pfin, (pa, pi, ps), _ = port_run(0, window, backend)
        np.testing.assert_array_equal(pa, ra)
        live = ra >= 0
        assert live.sum() > N // 2  # real grants, not an idle trace
        np.testing.assert_array_equal(pi[live], ri[live])
        np.testing.assert_allclose(ps, rs, **FLOAT_TOL)
        np.testing.assert_array_equal(pfin.req.status, rfin.req.status)
        np.testing.assert_array_equal(pfin.req.n_defers, rfin.req.n_defers)
        np.testing.assert_array_equal(pfin.req.submit_ms, rfin.req.submit_ms)
        np.testing.assert_allclose(pfin.req.finish_ms, rfin.req.finish_ms,
                                   **FLOAT_TOL)
        np.testing.assert_allclose(pfin.sched.ema_latency_ratio,
                                   rfin.sched.ema_latency_ratio, **FLOAT_TOL)

    @pytest.mark.parametrize("backend,ref_backend", PAIRS)
    def test_metrics(self, backend, ref_backend):
        rm = ref_run(0, W, ref_backend)[4]
        pm = port_run(0, W, backend)[2]
        assert pm._fields == rm._fields
        for f in rm._fields:
            np.testing.assert_allclose(np.asarray(getattr(pm, f), np.float64),
                                       np.asarray(getattr(rm, f), np.float64),
                                       err_msg=f, **METRIC_TOL)

    @pytest.mark.parametrize("name", ["fair_queuing", "direct_naive"])
    def test_other_allocation_modes(self, name):
        _, _, rfin, (ra, ri, _), _ = ref_run(1, W, "jnp", name, 600)
        pfin, (pa, pi, _), _ = port_run(1, W, "torch", name, 600)
        np.testing.assert_array_equal(pa, ra)
        np.testing.assert_array_equal(pi[ra >= 0], ri[ra >= 0])
        np.testing.assert_array_equal(pfin.req.status, rfin.req.status)


class TestWindowedMatchesDense:
    def test_bit_exact(self):
        dfin, (da, di, ds), _ = port_run(0, None, "torch")
        wfin, (wa, wi, ws), _ = port_run(0, W, "torch")
        np.testing.assert_array_equal(da, wa)
        np.testing.assert_array_equal(ds, ws)
        # IDLE rows carry no request (the window maps them to its sentinel)
        np.testing.assert_array_equal(di[da >= 0], wi[wa >= 0])
        for part in ("req", "sched"):
            for a, b in zip(getattr(dfin, part), getattr(wfin, part)):
                np.testing.assert_array_equal(a, b)
        assert int(dfin.provider.inflight) == int(wfin.provider.inflight)

    def test_backends_agree(self):
        """The port's kernel path and torch path make the same decisions,
        IDLE rows included."""
        for a, b in zip(port_run(0, W, "torch")[1], port_run(0, W, "kernel")[1]):
            np.testing.assert_array_equal(a, b)

    def test_undersized_window_loses_nothing(self):
        """A window below the peak live queue admits FIFO and stays
        correct: every request ends terminal exactly once."""
        batch, jitter = generate(WorkloadConfig(n_requests=96, mix="heavy",
                                                congestion="high",
                                                arrival_scale=4.0),
                                 torch.Generator().manual_seed(3),
                                 device="cpu")
        seen = []
        final = run_sim(strategy("final_adrr_olc"), batch, jitter,
                        default_physics(),
                        SimConfig(n_ticks=800, k_slots=4, window=16),
                        device="cpu",
                        on_tick=lambda t, s, w: seen.append(int(w.n_live)))
        assert max(seen) == 16
        status = final.req.status
        assert not ((status == PENDING) | (status == INFLIGHT)).any()
        assert int((status == COMPLETED).sum()) > 0


class TestGenerator:
    @pytest.mark.parametrize("mix,congestion", [("balanced", "high"),
                                                ("heavy", "medium")])
    def test_distribution_matches_reference(self, mix, congestion):
        n = 20000
        rb, rj = ref_generate(jax.random.PRNGKey(0), RefWorkloadConfig(
            n_requests=n, mix=mix, congestion=congestion))
        rb, rj = np_tree(rb), np.asarray(rj)
        pb, pj = generate(WorkloadConfig(n_requests=n, mix=mix,
                                         congestion=congestion),
                          torch.Generator().manual_seed(0), device="cpu")
        pb, pj = to_numpy(pb), to_numpy(pj)
        for f in pb._fields:
            assert getattr(pb, f).dtype == getattr(rb, f).dtype, f
        # bucket shares: binomial sd at n=2e4 is <= 0.0036
        np.testing.assert_allclose(np.bincount(pb.bucket, minlength=4) / n,
                                   np.bincount(rb.bucket, minlength=4) / n,
                                   atol=0.02)
        # mean inter-arrival gap (sd of the mean ~0.7%)
        pg, rg = np.diff(pb.arrival_ms).mean(), np.diff(rb.arrival_ms).mean()
        assert abs(pg / rg - 1) < 0.04
        assert np.all(np.diff(pb.arrival_ms) >= 0)
        # coarse prior: p50/true ~ U[0.75, 1.25], p90 = 1.8 p50
        pe, re_ = pb.p50 / pb.true_tokens, rb.p50 / rb.true_tokens
        assert abs(pe.mean() - re_.mean()) < 0.01
        assert abs(pe.std() - re_.std()) < 0.01
        np.testing.assert_allclose(pb.p90, pb.p50 * np.float32(1.8),
                                   rtol=1e-6)
        # log-uniform tokens within each bucket
        for k in range(4):
            m_p = np.log(pb.true_tokens[pb.bucket == k]).mean()
            m_r = np.log(rb.true_tokens[rb.bucket == k]).mean()
            assert abs(m_p - m_r) < 0.05, k
        np.testing.assert_array_equal(pb.cls, (pb.bucket != 0).astype(np.int32))
        budgets = np.float32([3600, 11000, 35000, 100000])
        np.testing.assert_array_equal(pb.deadline_budget_ms,
                                      budgets[pb.bucket])
        np.testing.assert_array_equal(rb.deadline_budget_ms,
                                      budgets[rb.bucket])
        assert 0.95 <= pj.min() and pj.max() <= 1.05
        assert abs(pj.mean() - rj.mean()) < 0.002

    def test_same_seed_same_batch_on_any_device(self):
        cfg = WorkloadConfig(n_requests=64)
        a = generate(cfg, torch.Generator().manual_seed(5), device="cpu")
        b = generate(cfg, torch.Generator().manual_seed(5), device="cpu")
        for x, y in zip(a[0], b[0]):
            assert torch.equal(x, y)


class TestRunner:
    def test_run_cell_windowed_matches_dense(self):
        wl = WorkloadConfig(n_requests=64, mix="balanced", congestion="high",
                            arrival_scale=6.0)
        w = window_for(wl.n_requests)
        assert w >= wl.n_requests
        kw = dict(seeds=2, device="cpu")
        dense = run_cell(strategy("final_adrr_olc"), wl,
                         sim_cfg=SimConfig(n_ticks=400, k_slots=4), **kw)
        win = run_cell(strategy("final_adrr_olc"), wl,
                       sim_cfg=SimConfig(n_ticks=400, k_slots=4, window=w),
                       **kw)
        for a, b in zip(dense, win):
            assert a.shape[0] == 2
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert np.isfinite(dense.completion_rate.numpy()).all()

    def test_run_cell_rejects_too_few_policy_classes(self):
        with pytest.raises(ValueError):
            run_cell(strategy("final_adrr_olc"),
                     WorkloadConfig(n_requests=8, class_map="bucket4"),
                     seeds=1, device="cpu")

    def test_dynamics_and_fleet_are_not_ported_yet(self):
        """Both the dynamics and the fleet axis are ported (the name is
        kept from when the fleet raised; their parity is
        `test_torch_scenarios.py` and `test_torch_fleet.py`): a
        one-endpoint fleet makes the plain run's decisions and request
        arrays bit for bit, a run with `no_dynamics()` is the stationary
        one, and dynamics with a fleet are refused as in the
        reference."""
        batch, jitter = generate(
            WorkloadConfig(n_requests=24, congestion="high",
                           arrival_scale=4.0), device="cpu")
        run = functools.partial(run_sim, strategy("final_adrr_olc"), batch,
                                jitter, default_physics(),
                                SimConfig(n_ticks=200), device="cpu",
                                collect_decisions=True)
        fleet = Fleet(uniform_fleet_physics(default_physics(), 1),
                      FleetDynamics(None, None, None, None,
                                    torch.tensor(1500.0)))
        plain, one = run(), run(fleet=fleet)
        stationary = run(dynamics=no_dynamics())
        for other in (one, stationary):
            for a, b in zip(plain[1], other[1]):
                assert torch.equal(a, b)
            for f in plain[0].req._fields[:6]:
                assert torch.equal(getattr(plain[0].req, f),
                                   getattr(other[0].req, f)), f
        assert int((plain[0].req.status == COMPLETED).sum()) > 0
        assert plain[0].fleet is None and one[0].fleet.inflight.shape == (1,)
        assert torch.equal(one[0].req.endpoint, torch.zeros(24,
                                                            dtype=torch.int32))
        with pytest.raises(ValueError, match="mutually exclusive"):
            run(dynamics=no_dynamics(), fleet=fleet)
