"""The port's three decision layers and dispatcher against the JAX reference.

Random inputs are made from a seed with numpy and handed to both
packages (the reference through jnp, the port through
`repro_torch.bridge.from_numpy`).  Integer outputs must be equal:
classes, send decisions, actions, round-robin pointers, inflight counts
and, on every grant that is not IDLE, request indices.  Floats that the
reference may round differently — XLA:CPU contracts some multiply-adds
into FMAs, and the port sums the class axis in float64 — are held to
`FLOAT_TOL`, a few float32 ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import drr as rdrr
from repro.core import ordering as rordering
from repro.core import overload as roverload
from repro.core import policy as rpolicy
from repro.core.scheduler import schedule_batch as ref_schedule_batch
from repro.core.types import (
    ProviderState as RProviderState,
    RequestBatch as RRequestBatch,
    RequestState as RRequestState,
    SchedState as RSchedState,
    SimState as RSimState,
)
from repro_torch.bridge import from_numpy, to_numpy
from repro_torch.core import drr, ordering, overload, policy
from repro_torch.core.scheduler import IDLE, effective_class, schedule_batch

torch.set_num_threads(1)

FLOAT_TOL = dict(rtol=4e-7, atol=1e-6)
MODES = [rpolicy.ALLOC_NAIVE, rpolicy.ALLOC_QUOTA, rpolicy.ALLOC_ADRR,
         rpolicy.ALLOC_FQ, rpolicy.ALLOC_SP]


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def port(x):
    return from_numpy(np_tree(x), device="cpu")


def ref_policy(k, mode):
    cfg = rpolicy.base_policy() if k == 2 else rpolicy.kclass_policy(k)
    return cfg._replace(alloc_mode=jnp.asarray(mode, jnp.int32))


class TestPolicy:
    @pytest.mark.parametrize("name", sorted(rpolicy.STRATEGIES))
    def test_strategy_fields_equal(self, name):
        r, p = np_tree(rpolicy.strategy(name)), policy.strategy(name)
        assert r._fields == p._fields
        assert int(r.alloc_mode) == p.alloc_mode
        for f in r._fields[1:]:
            np.testing.assert_array_equal(getattr(p, f).numpy(),
                                          getattr(r, f), err_msg=f)

    @pytest.mark.parametrize("k", [1, 4, 8])
    def test_kclass_policy_fields_equal(self, k):
        r, p = np_tree(rpolicy.kclass_policy(k)), policy.kclass_policy(k)
        for f in r._fields[1:]:
            np.testing.assert_array_equal(getattr(p, f).numpy(),
                                          getattr(r, f), err_msg=f)
        assert policy.n_classes(p) == k

    def test_bridge_round_trip_keeps_dtypes(self):
        cfg = port(rpolicy.strategy("fair_queuing"))
        assert cfg.alloc_mode == rpolicy.ALLOC_FQ
        assert cfg.drr_weights.dtype == torch.float32
        back = to_numpy(cfg)
        assert back.class_cap.dtype == np.float32


_ref_allocate = jax.jit(
    lambda cfg, **kw: rdrr.allocate(cfg, **kw))


class TestAllocate:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("k", [2, 4, 8])
    def test_matches_reference(self, mode, k):
        rcfg = ref_policy(k, mode)
        pcfg = port(rcfg)
        rng = np.random.default_rng(100 * k + mode)
        for _ in range(12):
            ins = dict(
                backlog=rng.integers(0, 4, k).astype(np.int32),
                head_cost=np.where(rng.uniform(size=k) < 0.8,
                                   rng.uniform(10, 3000, k),
                                   np.inf).astype(np.float32),
                inflight_cls=rng.integers(0, 6, k).astype(np.int32),
                inflight_total=np.int32(rng.integers(0, 24)),
                severity=np.float32(rng.uniform(0, 1.5)),
                deficit=rng.uniform(0, 4000, k).astype(np.float32),
                rr_turn=np.int32(rng.integers(0, k)),
            )
            ins["head_cost"] = np.where(ins["backlog"] > 0, ins["head_cost"],
                                        np.inf).astype(np.float32)
            r = np_tree(_ref_allocate(rcfg, **{
                key: jnp.asarray(v) for key, v in ins.items()}))
            p = drr.allocate(pcfg, **{key: torch.from_numpy(np.array(v))
                                      for key, v in ins.items()})
            assert bool(r.send_ok) == bool(p.send_ok)
            assert bool(r.ignore_class) == p.ignore_class
            if bool(r.send_ok):
                assert int(r.cls_id) == int(p.cls_id)
            assert int(r.rr_turn) == int(p.rr_turn)
            np.testing.assert_allclose(p.deficit.numpy(), r.deficit,
                                       **FLOAT_TOL)

    @pytest.mark.parametrize("k", [2, 4])
    def test_effective_weights(self, k):
        rcfg = ref_policy(k, rpolicy.ALLOC_ADRR)
        for sev in (0.0, 0.3, 1.4):
            np.testing.assert_allclose(
                drr.effective_weights(port(rcfg), torch.tensor(sev)).numpy(),
                np.asarray(rdrr.effective_weights(rcfg, jnp.float32(sev))),
                **FLOAT_TOL)


class TestOverload:
    @pytest.mark.parametrize("name", ["final_adrr_olc", "quota_tiered"])
    def test_severity_action_backoff(self, name):
        rcfg = rpolicy.strategy(name)
        pcfg = port(rcfg)
        rng = np.random.default_rng(7)
        infl = rng.integers(0, 30, 40).astype(np.int32)
        pend = rng.integers(0, 200, 40).astype(np.int32)
        ema = rng.uniform(0.5, 9.0, 40).astype(np.float32)
        for i in range(40):
            rs = roverload.severity_score(
                rcfg, inflight_total=jnp.int32(infl[i]),
                n_pending=jnp.int32(pend[i]),
                ema_latency_ratio=jnp.float32(ema[i]))
            ps = overload.severity_score(
                pcfg, inflight_total=torch.tensor(infl[i]),
                n_pending=torch.tensor(pend[i]),
                ema_latency_ratio=torch.tensor(ema[i]))
            np.testing.assert_allclose(float(ps), float(rs), **FLOAT_TOL)
            bucket = rng.integers(0, 4, 8).astype(np.int32)
            n_def = rng.integers(0, 4, 8).astype(np.int32)
            ra = roverload.admission_action(
                rcfg, severity=rs, bucket=jnp.asarray(bucket),
                n_defers=jnp.asarray(n_def))
            pa = overload.admission_action(
                pcfg, severity=torch.tensor(float(rs)),
                bucket=torch.from_numpy(bucket), n_defers=torch.from_numpy(n_def))
            np.testing.assert_array_equal(pa.numpy(), np.asarray(ra))
            np.testing.assert_allclose(
                overload.defer_backoff(pcfg, torch.tensor(float(rs)),
                                       torch.from_numpy(n_def)).numpy(),
                np.asarray(roverload.defer_backoff(rcfg, rs, jnp.asarray(n_def))),
                **FLOAT_TOL)


def mk_batch(n=48, seed=0, k=2):
    rng = np.random.default_rng(seed)
    bucket = rng.integers(0, 4, n).astype(np.int32)
    p50 = (np.float32([60, 150, 600, 2000])[bucket]
           * rng.uniform(0.7, 1.3, n).astype(np.float32))
    cls = ((bucket != 0).astype(np.int32) if k == 2
           else rng.integers(0, k, n).astype(np.int32))
    return RRequestBatch(
        arrival_ms=np.sort(rng.uniform(0, 400.0, n)).astype(np.float32),
        bucket=bucket, cls=cls, true_tokens=p50, p50=p50,
        p90=(p50 * 1.8).astype(np.float32),
        deadline_budget_ms=np.full((n,), 5000.0, np.float32),
        valid=np.ones((n,), bool),
    )


def mk_state(n, k, seed):
    rng = np.random.default_rng(seed)
    status = rng.choice([0, 0, 0, 1, 2], n).astype(np.int32)
    req = RRequestState(
        status=status,
        submit_ms=np.full((n,), np.inf, np.float32),
        finish_ms=np.full((n,), np.inf, np.float32),
        defer_until=np.where(rng.uniform(size=n) < 0.2, 9e5, 0).astype(
            np.float32),
        n_defers=rng.integers(0, 3, n).astype(np.int32),
        n_throttles=np.zeros((n,), np.int32),
    )
    sched = RSchedState(
        deficit=rng.uniform(0, 3000, k).astype(np.float32),
        rr_turn=np.int32(rng.integers(0, k)),
        ema_latency_ratio=np.float32(rng.uniform(1.0, 4.0)),
        n_completed_obs=np.int32(0),
    )
    prov = RProviderState(
        inflight=np.int32((status == 1).sum()),
        inflight_tokens=np.float32(0),
        tb_tokens=np.zeros((k,), np.float32),
        n_throttled=np.int32(0),
    )
    return RSimState(now_ms=np.float32(1e5), req=req, sched=sched,
                     provider=prov)


def jnp_tree(x):
    return jax.tree.map(jnp.asarray, x)


_ref_batch = jax.jit(ref_schedule_batch,
                     static_argnames=("max_grants", "backend"))


def check_schedule_batch(k, mode, b, seed, ref_backend="jnp",
                         port_backend="torch"):
    rcfg = ref_policy(k, mode)
    batch, state = mk_batch(seed=seed, k=k), mk_state(48, k, seed + 1)
    r = np_tree(_ref_batch(rcfg, jnp_tree(batch), jnp_tree(state),
                           max_grants=b, backend=ref_backend))
    p = to_numpy(schedule_batch(port(rcfg), from_numpy(batch, "cpu"),
                                from_numpy(state, "cpu"), max_grants=b,
                                backend=port_backend))
    np.testing.assert_array_equal(p.actions, r.actions)
    live = r.actions != IDLE
    np.testing.assert_array_equal(p.req_idx[live], r.req_idx[live])
    np.testing.assert_array_equal(p.inflight_at, r.inflight_at)
    assert int(p.rr_turn) == int(r.rr_turn)
    np.testing.assert_allclose(p.deficit, r.deficit, **FLOAT_TOL)
    np.testing.assert_allclose(p.severity, r.severity, **FLOAT_TOL)
    return live.sum()


class TestScheduleBatch:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("k", [2, 4, 8])
    @pytest.mark.parametrize("b", [1, 4, 16])
    def test_matches_reference(self, mode, k, b):
        live = sum(check_schedule_batch(k, mode, b, seed)
                   for seed in range(3))
        assert live > 0  # the states exercise real grants

    @pytest.mark.parametrize("mode", [rpolicy.ALLOC_NAIVE, rpolicy.ALLOC_ADRR,
                                      rpolicy.ALLOC_FQ])
    def test_kernel_backend_matches_pallas(self, mode):
        check_schedule_batch(2, mode, 4, seed=5, ref_backend="pallas",
                             port_backend="kernel")

    def test_effective_class(self):
        rcfg = rpolicy.strategy("direct_naive")
        batch = mk_batch(seed=3)
        from repro.core.scheduler import effective_class as ref_eff
        np.testing.assert_array_equal(
            effective_class(port(rcfg), from_numpy(batch, "cpu")).numpy(),
            np.asarray(ref_eff(rcfg, jnp_tree(batch))))


class TestOrdering:
    def _masks(self, batch, k, seed):
        rng = np.random.default_rng(seed)
        elig = rng.uniform(size=batch.arrival_ms.shape[0]) < 0.6
        cls = batch.cls
        kn = (cls[None, :] == np.arange(k)[:, None]) & elig[None, :]
        return elig, kn

    @pytest.mark.parametrize("backends", [("jnp", "torch"),
                                          ("pallas", "kernel")])
    @pytest.mark.parametrize("b", [1, 8])
    def test_select_top_b_and_rank_fifo(self, backends, b):
        rb, pb = backends
        rcfg = rpolicy.base_policy()
        batch = mk_batch(96, seed=2)
        elig, kn = self._masks(batch, 2, seed=4)
        now = np.float32(5e3)
        ri, rn = rordering.select_top_b(jnp_tree(batch), jnp.asarray(kn),
                                        jnp.float32(now), rcfg, b, backend=rb)
        pi, pn = ordering.select_top_b(
            from_numpy(batch, "cpu"), torch.from_numpy(kn),
            torch.tensor(now), port(rcfg), b, backend=pb)
        np.testing.assert_array_equal(pn.numpy(), np.asarray(rn))
        for c in range(2):
            v = min(int(rn[c]), b)
            np.testing.assert_array_equal(pi.numpy()[c, :v],
                                          np.asarray(ri)[c, :v])
        rg, rgn = rordering.rank_fifo(jnp_tree(batch), jnp.asarray(elig), b,
                                      backend=rb)
        pg, pgn = ordering.rank_fifo(from_numpy(batch, "cpu"),
                                     torch.from_numpy(elig), b, backend=pb)
        assert int(pgn) == int(rgn)
        np.testing.assert_array_equal(pg.numpy(), np.asarray(rg))

    @pytest.mark.parametrize("backends", [("jnp", "torch"),
                                          ("pallas", "kernel")])
    def test_select_per_class(self, backends):
        rb, pb = backends
        rcfg = rpolicy.kclass_policy(4)
        batch = mk_batch(64, seed=9, k=4)
        _, kn = self._masks(batch, 4, seed=10)
        ri, rok = rordering.select_per_class(
            jnp_tree(batch), jnp.asarray(kn), jnp.float32(900.0), rcfg,
            backend=rb)
        pi, pok = ordering.select_per_class(
            from_numpy(batch, "cpu"), torch.from_numpy(kn),
            torch.tensor(900.0), port(rcfg), backend=pb)
        np.testing.assert_array_equal(pok.numpy(), np.asarray(rok))
        ok = np.asarray(rok)
        np.testing.assert_array_equal(pi.numpy()[ok], np.asarray(ri)[ok])

    def test_backends_agree_on_every_row(self):
        """The port's kernel path (plain version on the CPU) and torch
        path give the same ranking, masked rows included."""
        pcfg = policy.base_policy()
        batch = from_numpy(mk_batch(130, seed=6), "cpu")
        elig, kn = self._masks(to_numpy(batch), 2, seed=7)
        now = torch.tensor(2e3)
        a, _ = ordering.select_top_b(batch, torch.from_numpy(kn), now, pcfg,
                                     16, backend="torch")
        b, _ = ordering.select_top_b(batch, torch.from_numpy(kn), now, pcfg,
                                     16, backend="kernel")
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    def test_order_scores_match_reference(self):
        rcfg = rpolicy.base_policy()
        batch = mk_batch(200, seed=8)
        r = rordering.order_scores(jnp_tree(batch), jnp.float32(3e3), rcfg)
        p = ordering.order_scores(from_numpy(batch, "cpu"),
                                  torch.tensor(3e3), port(rcfg))
        np.testing.assert_allclose(p.numpy(), np.asarray(r), **FLOAT_TOL)

    def test_unknown_backend_raises(self):
        batch = from_numpy(mk_batch(8, seed=1), "cpu")
        with pytest.raises(ValueError):
            ordering.rank_fifo(batch, torch.ones(8, dtype=torch.bool), 2,
                               backend="pallas")
