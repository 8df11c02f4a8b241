"""The port's mixture-of-experts layer against the JAX reference, on the CPU.

`repro_torch.models.moe.MoE` is held against `repro.models.moe.moe_apply`
at both MoE smoke configs (`arctic-smoke`, 4 experts top-2 with the dense
residual MLP; `phi35-moe-smoke`, 4 experts top-2), in float32 and
bfloat16, with the reference's `moe_init` parameters copied into the
module and the same numpy inputs on both sides (bfloat16 cases round
the same float32 values on both sides, with equal bits).

The routing must be the reference's exactly: expert indices, keep masks
and drop counts, ties included.  The reference's `moe_apply` returns
only (y, aux), so `reference_routing` replays its routing lines
(`moe.py:78-104`) with the same JAX operations (`dense_apply`,
`jax.nn.softmax`, `lax.top_k`, a stable `argsort`, `bincount`).  Cases:

* a decode-sized batch (T * k <= 4 E: dropless);
* a prefill whose router is biased towards expert 0, so that it
  overflows its capacity and slots are dropped;
* an all-zero router: every probability equal, every token's top-2 the
  lowest two indices (the tie order of `lax.top_k`), and drops;
* the `sq_relu` and `gelu` activations through `dataclasses.replace`.

Tolerances on y and aux: float32 2e-5 absolute and relative (the two
packages sum the expert products in different orders); bfloat16 3e-2
absolute and relative, the reference's own bfloat16 kernel tolerance
(both round each product's output to bfloat16 after float32 sums taken
in different orders, and the combine rounds again: 1-2 bf16 ulps).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.models.common import dense_apply
from repro.models.moe import moe_apply, moe_init
from repro_torch.configs import get_smoke
from repro_torch.models.moe import MoE, capacity

torch.set_num_threads(2)

ARCHS = ["arctic-480b", "phi3.5-moe-42b-a6.6b"]
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def configs(arch, dtype, **changes):
    return (dataclasses.replace(ref_get_smoke(arch), dtype=dtype, **changes),
            dataclasses.replace(get_smoke(arch), dtype=dtype, **changes))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def build(arch, dtype, router=None, **changes):
    """(reference params, reference cfg, port MoE) with the reference's
    `moe_init` float32 draws, cast to `dtype` on both sides; `router`
    replaces the router weight (float32 numpy)."""
    rcfg, pcfg = configs(arch, "float32", **changes)
    params = moe_init(jax.random.PRNGKey(0), rcfg, jnp.float32)[0]
    if router is not None:
        params["router"]["w"] = jnp.asarray(router)
    arrays = {k: np.array(v) for k, v in flat(params).items()}
    rcfg, pcfg = configs(arch, dtype, **changes)
    mod = MoE(pcfg, TORCH[dtype], "cpu")
    named = dict(mod.named_parameters())
    assert set(named) == set(arrays)
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(torch.from_numpy(arrays[name]).to(TORCH[dtype]))
    rparams = jax.tree.map(lambda a: jnp.asarray(a).astype(JNP[dtype]),
                           params)
    return rparams, rcfg, mod


def reference_routing(p, cfg, x):
    """The reference's routing lines of `moe_apply`, step for step:
    (expert_idx (T, k), keep (T * k,) in slot order sorted by expert,
    the sorted experts, drops)."""
    m = cfg.moe
    B, S, d = x.shape
    T, k, E = B * S, m.top_k, m.n_experts
    logits = dense_apply(p["router"], x.reshape(T, d)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_idx = jax.lax.top_k(probs, k)
    if m.capacity_factor <= 0 or T * k <= 4 * E:
        cap = T * k
    else:
        cap = int(max(1, round(m.capacity_factor * T * k / E)))
    flat_expert = expert_idx.reshape(-1)
    order = jnp.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    counts = jnp.bincount(flat_expert, length=E)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(T * k) - starts[sorted_expert]
    keep = np.asarray(rank < cap)
    return (np.asarray(expert_idx), keep, np.asarray(sorted_expert),
            int((~keep).sum()), cap)


def inputs(seed, shape, dtype, shift=0.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x += np.float32(shift)
    return (jnp.asarray(x).astype(JNP[dtype]),
            torch.from_numpy(x).to(TORCH[dtype]))


def check(arch, dtype, shape, seed=0, shift=0.0, router=None, **changes):
    """Run both; assert routing exactly and y, aux within TOL.  Returns
    the reference's drop count."""
    rparams, rcfg, mod = build(arch, dtype, router, **changes)
    jx, tx = inputs(seed, shape, dtype, shift)
    want_y, want_aux = moe_apply(rparams, rcfg, jx)
    with torch.no_grad():
        got_y, got_aux = mod(tx)
        r, _ = mod.route(tx.reshape(-1, shape[-1]))
    idx, keep, sorted_expert, drops, cap = reference_routing(rparams, rcfg,
                                                             jx)
    np.testing.assert_array_equal(r.expert_idx.numpy(), idx)
    np.testing.assert_array_equal(r.sorted_expert.numpy(), sorted_expert)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert int((~r.keep).sum()) == drops and r.capacity == cap
    assert got_y.dtype == TORCH[dtype] and got_y.shape == shape
    np.testing.assert_allclose(got_y.float().numpy(),
                               np.asarray(want_y.astype(jnp.float32)),
                               **TOL[dtype])
    np.testing.assert_allclose(float(got_aux), float(want_aux),
                               **TOL["float32"])
    return drops


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_batch_is_dropless(arch, dtype):
    # B = 2 tokens: T * k = 4 <= 4 E = 16
    assert check(arch, dtype, (2, 1, 256)) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_with_an_overflowing_expert_drops(arch, dtype):
    # T = 48, k = 2: capacity round(1.25 * 96 / 4) = 30 slots an expert;
    # the router's column 0 follows the inputs' shared offset, so expert
    # 0 is every token's first choice and drops 18 of its 48
    d = 256
    rng = np.random.default_rng(7)
    router = (rng.standard_normal((d, 4)) / np.sqrt(d)).astype(np.float32)
    router[:, 0] += np.float32(0.5 / np.sqrt(d))
    drops = check(arch, dtype, (2, 24, d), seed=1, shift=1.0, router=router)
    assert drops >= 18


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_all_equal_router_breaks_ties_to_the_lower_index(arch, dtype):
    # every logit 0: each token picks experts 0 and 1 with gates 1/2, and
    # 48 tokens overflow their capacity of 30
    d = 256
    drops = check(arch, dtype, (2, 24, d), seed=2,
                  router=np.zeros((d, 4), np.float32))
    assert drops == 2 * (48 - 30)


@pytest.mark.parametrize("activation", ["sq_relu", "gelu"])
@pytest.mark.parametrize("arch", ARCHS)
def test_activations(arch, activation):
    rparams, _, mod = build(arch, "float32", activation=activation)
    assert mod.wg is None and "wg" not in rparams
    check(arch, "float32", (2, 24, 256), seed=3, activation=activation)


@pytest.mark.parametrize("T,want", [
    (1, 2), (8, 16),        # T * k <= 4 E: dropless, capacity T * k
    (12, 8),                # 1.25 * 24 / 4 = 7.5: Python's round gives 8
    (20, 12),               # 12.5 -> 12 (round half to even)
    (48, 30),
])
def test_capacity_rule(T, want):
    _, pcfg = configs("phi3.5-moe-42b-a6.6b", "float32")
    assert capacity(pcfg, T) == want


def test_capacity_at_published_width():
    """Phi-3.5-MoE (16 experts): a 37-token prompt already drops
    (capacity 6), a 512-token one keeps 80 slots an expert, a decode step
    of 4 is dropless; Arctic (128 experts) is dropless up to 256 tokens."""
    from repro_torch.configs import get
    phi, arctic = get("phi3.5-moe-42b-a6.6b"), get("arctic-480b")
    assert [capacity(phi, t) for t in (4, 32, 37, 512)] == [8, 64, 6, 80]
    assert [capacity(arctic, t) for t in (256, 512, 1024)] == [512, 10, 20]


def test_combine_is_deterministic():
    """Two calls on the same input give the same bits (no atomics)."""
    _, _, mod = build("arctic-480b", "bfloat16")
    _, tx = inputs(4, (3, 16, 256), "bfloat16")
    with torch.no_grad():
        a, b = mod(tx)[0], mod(tx)[0]
    assert torch.equal(a, b)
