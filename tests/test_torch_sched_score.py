"""The port's scheduler scoring kernels against the JAX reference.

Inputs are made from a seed with numpy and handed to both packages:
the reference's `repro.kernels.sched_score.ref` oracles (jitted, as the
reference's own kernel tests use them) and the port's wrappers in
`repro_torch.kernels.sched_score.ops`, which on CPU tensors run the
plain PyTorch versions in `ref.py`.  One case also goes through the
reference's Pallas kernel in interpret mode.  `TestTilePartition` holds
the plain emulation of the CUDA kernel's partition (each 4096-lane CTA
tile ranks its own lanes, then the tiles' lists are merged) against the
reference's oracle and its interpret-mode Pallas kernel, at the tile's
edges, across tiles and on masked tails.

Tolerance: indices must match exactly.  Scores must match exactly
without the route term.  With it they may differ by the rounding of the
route product: under jit the reference oracle contracts the trailing
`score - w_route * route` into one FMA, while the port rounds the
product first (as its CUDA kernel does).  So the bound is one ulp of
`w_route * route` plus one ulp of the score; measured on these inputs,
that difference reaches 2 ulps of the score when the subtraction
cancels.
The CUDA kernels themselves are held against these plain versions, bit
for bit, on the card by `chip_smoke.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sched_score.ops import (
    sched_score_argmax as ref_argmax_kernel,
)
from repro.kernels.sched_score.ops import sched_score_topb as ref_topb_kernel
from repro.kernels.sched_score.ref import (
    sched_compact_topb_ref,
    sched_score_argmax_ref,
    sched_score_topb_ref,
)
from repro_torch.kernels.sched_score import ops
from repro_torch.kernels.sched_score import ref as port_ref

torch.set_num_threads(1)

W4 = np.asarray([1.0, 0.8, 0.5, 650.0], np.float32)
W5 = np.asarray([1.0, 0.8, 0.5, 650.0, 400.0], np.float32)
W_FIFO = np.asarray([1.0, 0.0, 0.0, 1.0], np.float32)


def features(n, seed, density=0.7, route=False):
    rng = np.random.default_rng(seed)
    wait = (rng.uniform(size=n) * 5e3).astype(np.float32)
    cost = (rng.uniform(size=n) * 3000 + 0.5).astype(np.float32)
    urg = (rng.uniform(size=n) * 2).astype(np.float32)
    mask = rng.uniform(size=n) < density
    r = (rng.uniform(size=n) * 3.0).astype(np.float32) if route else None
    return wait, cost, urg, mask, r


def t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def assert_scores(port, ref, route_term=None):
    """Exact equality, or, with the route term (`route_term` = the
    ranked lanes' route values times w_route), agreement within the
    rounding of that product."""
    port, ref = np.asarray(port), np.asarray(ref)
    if route_term is None:
        np.testing.assert_array_equal(port, ref)
        return
    bound = np.spacing(np.abs(route_term)) + np.spacing(np.abs(ref))
    assert np.all(np.abs(port - ref) <= bound), (port, ref, bound)


def route_term(r, idx, live):
    """w_route * route of the ranked lanes (0 where the lane is masked:
    a NEG score carries no route term)."""
    if r is None:
        return None
    return np.where(live, W5[4] * r[np.asarray(idx)], 0).astype(np.float32)


def check_topb(n, b, seed=0, density=0.7, route=False, feats=None):
    wait, cost, urg, mask, r = feats or features(n, seed, density, route)
    w = W5 if route else W4
    ip, sp = ops.sched_score_topb(t(wait), t(cost), t(urg), t(mask), t(w), b,
                                  t(r))
    ir, sr = sched_score_topb_ref(
        jnp.asarray(wait), jnp.asarray(cost), jnp.asarray(urg),
        jnp.asarray(mask), jnp.asarray(w), min(b, n),
        None if r is None else jnp.asarray(r))
    assert ip.dtype == torch.int32 and sp.dtype == torch.float32
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ir))
    assert_scores(sp.numpy(), sr,
                  route_term(r, ir, np.asarray(sr) > port_ref.NEG))


class TestSchedScoreTopB:
    @pytest.mark.parametrize("n", [7, 96, 130, 1000, 4096, 5000])
    @pytest.mark.parametrize("b", [1, 16])
    @pytest.mark.parametrize("route", [False, True])
    def test_matches_reference_oracle(self, n, b, route):
        check_topb(n, b, seed=n + b, route=route)

    @pytest.mark.parametrize("density", [0.0, 0.05, 0.5, 1.0])
    def test_mask_densities(self, density):
        check_topb(512, 8, seed=3, density=density)

    def test_tie_breaking_first_occurrence(self):
        n, half = 512, 256
        wait, cost, urg, _, _ = features(n, seed=9, density=1.0)
        for a in (wait, cost, urg):
            a[half:] = a[:half]
        check_topb(n, 32, feats=(wait, cost, urg, np.ones(n, bool), None))

    def test_all_tie(self):
        n = 300
        ones = np.ones(n, np.float32)
        check_topb(n, 16, feats=(ones * 7, ones * 3, ones, np.ones(n, bool),
                                 None))

    @pytest.mark.parametrize("route", [False, True])
    def test_b_exceeds_eligible(self, route):
        check_topb(64, 32, seed=5, density=0.05, route=route)
        check_topb(100, 16, seed=6, density=0.0, route=route)

    def test_b_equals_n(self):
        check_topb(16, 16, seed=7)

    def test_b_larger_than_n_is_cut(self):
        wait, cost, urg, mask, _ = features(10, seed=2)
        ip, sp = ops.sched_score_topb(t(wait), t(cost), t(urg), t(mask),
                                      t(W4), 64)
        assert ip.shape == (10,) and sp.shape == (10,)

    def test_fifo_weight_row_ranks_by_arrival(self):
        """weights [1,0,0,1] with -arrival in the wait slot: the rank_fifo
        kernel path, held against a stable sort of the arrivals."""
        n, b = 300, 8
        rng = np.random.default_rng(8)
        arrival = (rng.uniform(size=n) * 1e5).astype(np.float32)
        mask = rng.uniform(size=n) < 0.5
        ip, sp = ops.sched_score_topb(
            t(-arrival), t(np.ones(n, np.float32)), t(np.zeros(n, np.float32)),
            t(mask), t(W_FIFO), b)
        key = np.where(mask, arrival, np.inf)
        want = np.argsort(key, kind="stable")[:b]
        np.testing.assert_array_equal(ip.numpy(), want)
        np.testing.assert_array_equal(sp.numpy(), -arrival[want])

    def test_matches_reference_pallas_kernel_interpret(self):
        """One case through the reference's Pallas kernel itself (its ops
        wrapper runs it in interpret mode on the CPU)."""
        wait, cost, urg, mask, _ = features(700, seed=11)
        ik, sk = ref_topb_kernel(jnp.asarray(wait), jnp.asarray(cost),
                                 jnp.asarray(urg), jnp.asarray(mask),
                                 jnp.asarray(W4), 16, blk=256)
        ip, sp = ops.sched_score_topb(t(wait), t(cost), t(urg), t(mask),
                                      t(W4), 16)
        np.testing.assert_array_equal(ip.numpy(), np.asarray(ik))
        np.testing.assert_array_equal(sp.numpy(), np.asarray(sk))


class TestSchedScoreArgmax:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("density", [0.01, 0.5, 1.0])
    @pytest.mark.parametrize("route", [False, True])
    def test_matches_reference_oracle(self, seed, density, route):
        wait, cost, urg, mask, r = features(1024, seed, density, route)
        w = W5 if route else W4
        ip, sp = ops.sched_score_argmax(t(wait), t(cost), t(urg), t(mask),
                                        t(w), t(r))
        ir, sr = sched_score_argmax_ref(
            jnp.asarray(wait), jnp.asarray(cost), jnp.asarray(urg),
            jnp.asarray(mask), jnp.asarray(w),
            None if r is None else jnp.asarray(r))
        assert ip.shape == () and ip.dtype == torch.int32
        assert int(ip) == int(ir)
        assert_scores(sp.numpy(), sr,
                      route_term(r, ir, np.asarray(sr) > port_ref.NEG))

    def test_all_masked_returns_sentinel(self):
        z = np.zeros(512, np.float32)
        ip, sp = ops.sched_score_argmax(t(z), t(z + 100), t(z),
                                        t(np.zeros(512, bool)), t(W4))
        assert int(ip) == 0 and float(sp) == np.float32(port_ref.NEG)


TILE = ops.TILE
EDGES = (TILE - 1, TILE, TILE + 1, 2 * TILE + 1, 100_000)


def split(feats, b, route=None):
    wait, cost, urg, mask, r = feats
    w = W5 if r is not None else W4
    return port_ref.sched_score_topb_split_ref(
        t(wait), t(cost), t(urg), t(mask), t(w), b, t(r), tile=TILE)


def tie_across(feats, lanes):
    """`feats` with the lanes `lanes` given one equal score above every
    other lane's."""
    wait, cost, urg, mask, r = (None if a is None else a.copy()
                                for a in feats)
    for i in lanes:
        wait[i], cost[i], urg[i], mask[i] = 1e4, 1.0, 0.0, True
        if r is not None:
            r[i] = 0.0
    return wait, cost, urg, mask, r


def check_split(feats, b, pallas=True):
    """The partition's emulation equal to the oracle, the interpret-mode
    Pallas kernel and the port's plain version, bit for bit (no route
    term)."""
    wait, cost, urg, mask, _ = feats
    ip, sp = split(feats, b)
    jx = [jnp.asarray(a) for a in (wait, cost, urg, mask, W4)]
    wants = [sched_score_topb_ref(*jx, b)]
    if pallas:
        wants.append(ref_topb_kernel(*jx, b))
    wants.append(ops.sched_score_topb(t(wait), t(cost), t(urg), t(mask),
                                      t(W4), b))
    assert ip.dtype == torch.int32 and ip.shape == (b,)
    for iw, sw in wants:
        np.testing.assert_array_equal(ip.numpy(), np.asarray(iw))
        assert_scores(sp.numpy(), sw)
    return ip, sp


class TestTilePartition:
    @pytest.mark.parametrize("n", EDGES)
    @pytest.mark.parametrize("b", [1, 16, 128])
    def test_tile_edges(self, n, b):
        check_split(features(n, seed=n % 97 + b), b)

    @pytest.mark.parametrize("n,lanes", [
        (TILE + 1, (TILE - 1, TILE)),
        (2 * TILE + 1, (TILE - 1, 2 * TILE)),
        (100_000, (3 * TILE - 1, 3 * TILE, 5 * TILE + 7))])
    @pytest.mark.parametrize("b", [1, 16])
    def test_tie_across_tiles_goes_to_lower_index(self, n, lanes, b):
        ip, _ = check_split(tie_across(features(n, seed=b), lanes), b)
        np.testing.assert_array_equal(ip.numpy()[:len(lanes)],
                                      np.asarray(lanes[:b]))

    @pytest.mark.parametrize("n", EDGES[2:])
    @pytest.mark.parametrize("density", [0.0, 0.0005])
    def test_masked_tail_in_index_order(self, n, density):
        """All masked, and fewer eligible lanes than b: NEG lanes fill
        the tail in index order, across tiles."""
        feats = features(n, seed=4, density=density)
        ip, sp = check_split(feats, 16)
        live = min(int(feats[3].sum()), 16)
        assert np.all(sp.numpy()[live:] == np.float32(port_ref.NEG))
        tail = np.flatnonzero(~feats[3])[:16 - live]
        np.testing.assert_array_equal(ip.numpy()[live:], tail)

    @pytest.mark.parametrize("n", EDGES)
    def test_argmax_is_the_first_of_the_split(self, n):
        wait, cost, urg, mask, _ = feats = features(n, seed=n % 89)
        ip, sp = split(feats, 1)
        jx = [jnp.asarray(a) for a in (wait, cost, urg, mask, W4)]
        for iw, sw in (sched_score_argmax_ref(*jx), ref_argmax_kernel(*jx),
                       ops.sched_score_argmax(t(wait), t(cost), t(urg),
                                              t(mask), t(W4))):
            assert int(ip[0]) == int(iw)
            assert_scores(sp.numpy()[:1], np.asarray(sw).reshape(1))

    @pytest.mark.parametrize("n", EDGES)
    def test_route_term(self, n):
        """With the route row: equal to the port's plain version bit for
        bit, and to the oracle within the route product's rounding."""
        feats = features(n, seed=n % 83, route=True)
        wait, cost, urg, mask, r = feats
        ip, sp = split(feats, 16)
        iq, sq = ops.sched_score_topb(t(wait), t(cost), t(urg), t(mask),
                                      t(W5), 16, t(r))
        np.testing.assert_array_equal(ip.numpy(), iq.numpy())
        np.testing.assert_array_equal(sp.numpy().view(np.int32),
                                      sq.numpy().view(np.int32))
        check_topb(n, 16, route=True, feats=feats)


def pool(w, seed, density=0.7, route=False):
    rng = np.random.default_rng(seed)
    req = rng.permutation(w * 3)[:w].astype(np.int32)
    wait, cost, urg, _, r = features(w, seed + 1, density, route)
    alive = rng.uniform(size=w) < density
    return req, alive, wait, cost, urg, r


# pools past one CTA's tile of 4096 slots: at its edge, ragged, two
# whole tiles, and three tiles and one slot
PAST_TILE = (4097, 5000, 8192, 12_289)
W_BELOW = np.asarray([1.0, 1.0, 1.0, 100.0], np.float32)


def below_neg_pool(w):
    """Slots 0, 2, w/2 and w-1 dead (the sentinel lanes are the last
    four); live slots score -3e30, except slot 1 (an ordinary score),
    slot w/2 + 1 (one that rounds to NEG exactly) and slot w - 2 (-inf),
    with weights W_BELOW."""
    alive = np.ones(w, bool)
    alive[[0, 2, w // 2, w - 1]] = False
    urg = np.full(w, -3e30, np.float32)
    urg[[1, w // 2 + 1, w - 2]] = [0.0, -1e30, -np.inf]
    ones = np.ones(w, np.float32)
    return np.arange(w, dtype=np.int32), alive, ones, ones, urg, None


def check_compact(w, b, seed=0, density=0.7, route=False, p=None,
                  weights=None):
    req, alive, wait, cost, urg, r = p or pool(w, seed, density, route)
    wt = (W5 if route else W4) if weights is None else weights
    cp, np_, ip, sp = ops.sched_compact_topb(
        t(req), t(alive), t(wait), t(cost), t(urg), t(wt), b, t(r))
    cr, nr, ir, sr = sched_compact_topb_ref(
        jnp.asarray(req), jnp.asarray(alive), jnp.asarray(wait),
        jnp.asarray(cost), jnp.asarray(urg), jnp.asarray(wt), min(b, w),
        None if r is None else jnp.asarray(r))
    assert int(np_) == int(nr)
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cr))
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ir))
    # ranked compacted positions -> slots, to look up their route values
    live = np.asarray(sr) > port_ref.NEG
    slot_of = np.append(np.flatnonzero(alive), 0)
    ranked = slot_of[np.where(live, np.asarray(ir), -1)]
    assert_scores(sp.numpy(), sr, route_term(r, ranked, live))


def check_compact_split(p, b, tile, weights=W4):
    req, alive, wait, cost, urg, _ = p
    tp = [t(a) for a in (req, alive, wait, cost, urg)]
    got = port_ref.sched_compact_topb_split_ref(*tp, t(weights), b,
                                                tile=tile)
    plain = port_ref.sched_compact_topb_ref(*tp, t(weights), b)
    oracle = sched_compact_topb_ref(*[jnp.asarray(a) for a in
                                      (req, alive, wait, cost, urg, weights)],
                                    b)
    for x, y, z in zip(got, plain, oracle):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.numpy().view(np.int32),
                                      y.numpy().view(np.int32))
        np.testing.assert_array_equal(x.numpy(), np.asarray(z))


class TestCompactTopB:
    @pytest.mark.parametrize("w", [7, 100, 256, 1024, 4096])
    @pytest.mark.parametrize("b", [1, 16, 64])
    def test_matches_two_pass_oracle(self, w, b):
        check_compact(w, b, seed=w + b, density=0.6)

    @pytest.mark.parametrize("b", [1, 8, 32])
    def test_route_matches_oracle(self, b):
        check_compact(256, b, seed=b, density=0.5, route=True)

    def test_tie_breaking_first_occurrence(self):
        w, half = 256, 128
        req, alive, wait, cost, urg, _ = pool(w, seed=9, density=1.0)
        for a in (wait, cost, urg):
            a[half:] = a[:half]
        alive = np.ones(w, bool)
        alive[::7] = False
        check_compact(w, 32, p=(req, alive, wait, cost, urg, None))

    def test_exhausted_region(self):
        check_compact(128, 32, seed=5, density=0.05)
        check_compact(128, 16, seed=6, density=0.0)

    def test_fully_live_pool(self):
        check_compact(256, 16, seed=7, density=1.0)

    @pytest.mark.parametrize("w", PAST_TILE)
    @pytest.mark.parametrize("b", [1, 16, 128])
    def test_pools_past_one_tile(self, w, b):
        check_compact(w, b, seed=w % 101 + b, density=0.6)

    def test_live_score_below_neg(self):
        """Slots 1 and 5 alive, urgency[5] = -3e30: the oracle ranks the
        compacted pool, whose NEG tail lanes come before a live -3e30."""
        w = 8
        alive = np.zeros(w, bool)
        alive[[1, 5]] = True
        urg = np.zeros(w, np.float32)
        urg[5] = -3e30
        ones = np.ones(w, np.float32)
        p = (np.arange(w, dtype=np.int32), alive, ones, ones, urg, None)
        check_compact(w, 4, p=p, weights=W_BELOW)
        _, _, ip, sp = ops.sched_compact_topb(*map(t, p[:5]), t(W_BELOW), 4)
        np.testing.assert_array_equal(ip.numpy(), [0, 2, 3, 4])
        assert np.all(sp.numpy()[1:] == np.float32(port_ref.NEG))

    @pytest.mark.parametrize("w", [8, 2 * TILE + 8])
    @pytest.mark.parametrize("b", [4, 8])
    def test_scores_at_below_neg_and_minus_inf(self, w, b):
        """A live score equal to NEG ranks before the sentinel lanes (its
        index is lower); -3e30 and -inf rank after them, at W = 8 and past
        a tile."""
        p = below_neg_pool(w)
        check_compact(w, b, p=p, weights=W_BELOW)
        _, _, ip, _ = ops.sched_compact_topb(*map(t, p[:5]), t(W_BELOW), b)
        half = w // 2 - 2   # compacted position of slot w/2 + 1
        want = [0, half, w - 4, w - 3, w - 2, w - 1, 1, 2 if w > 8 else 3]
        np.testing.assert_array_equal(ip.numpy(), want[:b])


class TestCompactTilePartition:
    """`sched_compact_topb_split_ref`, the emulation of the kernel's
    partition, equal bit for bit to the plain version and exactly to the
    oracle (ids, n_live, idx and, without the route term, scores)."""

    @pytest.mark.parametrize("w", PAST_TILE)
    @pytest.mark.parametrize("b", [1, 16, 128])
    @pytest.mark.parametrize("tile", [64, TILE])
    def test_split_equals_plain(self, w, b, tile):
        check_compact_split(pool(w, seed=w % 89 + b, density=0.6), b, tile)

    @pytest.mark.parametrize("w", [8, 2 * TILE + 8])
    @pytest.mark.parametrize("tile", [4, 64, TILE])
    def test_split_below_neg(self, w, tile):
        check_compact_split(below_neg_pool(w), 8, tile, weights=W_BELOW)

    @pytest.mark.parametrize("density", [0.0, 1.0])
    def test_split_empty_and_full(self, density):
        check_compact_split(pool(5000, seed=3, density=density), 16, 64)


class TestWrapperDispatch:
    def test_cpu_path_counts_no_launch(self):
        ops.reset_launches()
        check_topb(64, 4, seed=1)
        check_compact(64, 4, seed=1)
        assert all(v == 0 for v in ops.LAUNCHES.values())

    def test_rejects_bad_dtype_shape_and_layout(self):
        wait, cost, urg, mask, _ = features(32, seed=0)
        good = [t(wait), t(cost), t(urg), t(mask), t(W4)]
        with pytest.raises(TypeError):
            ops.sched_score_topb(t(wait).double(), *good[1:], 4)
        with pytest.raises(ValueError):
            ops.sched_score_topb(t(wait)[:16], *good[1:], 4)
        with pytest.raises(ValueError):
            ops.sched_score_topb(torch.stack([t(wait)] * 2, 1)[:, 0],
                                 *good[1:], 4)
        with pytest.raises(ValueError):  # route given with 4 weights
            ops.sched_score_topb(*good, 4, t(wait))
        wide = [t(a) for a in features(300, seed=0)[:4]]
        with pytest.raises(ValueError):  # b above the kernel's 128
            ops.sched_score_topb(*wide, t(W4), 129)

    def test_rejects_other_devices(self):
        wait, cost, urg, mask, _ = features(32, seed=0)
        meta = [t(a).to("meta") for a in (wait, cost, urg, mask, W4)]
        with pytest.raises(ValueError):
            ops.sched_score_topb(*meta, 4)

    def test_compact_accepts_pools_over_one_tile(self):
        check_compact(4100, 16, seed=0)

    def test_compact_rejects_b_over_128(self):
        req, alive, wait, cost, urg, _ = pool(300, seed=0)
        with pytest.raises(ValueError):
            ops.sched_compact_topb(t(req), t(alive), t(wait), t(cost), t(urg),
                                   t(W4), 129)
