"""The port's trainer against the JAX reference, on the CPU.

* AdamW: one `apply` on the same state and gradients as
  `repro.training.adamw.apply` (float32, rtol 1e-6 on every master
  value, moment and parameter, with an absolute floor of 1e-6 times
  the leaf's largest value, since `master - lr * u` cancels to values
  far below the operands' ulp: the two packages run the same float32
  operations, and XLA may contract a multiply-add), weight decay, the
  clip, `global_norm`, and `lr_schedule` at the reference test's steps
  and across a span (rtol 1e-6).
* The train step: 3 `train_step`s from the same parameters and the
  reference's pipeline batches against the reference's jitted
  `train_step`, in float32.  Losses and grad norms within 1e-5
  relative.  Parameters: Adam's first updates are ~lr * sign(g), so an
  element whose gradient is near zero can move the other way in one
  package; at most 1% of the elements may differ by more than 1e-6,
  and none by more than 2 lr a step.
* The reference's own microbatch and loss-falls tests, on the port.
* The kernel wrappers are forward-only: each raises when an input
  requires a gradient under grad mode, on CPU tensors too, and
  `forward_train(impl="kernel")` raises under autograd (it does not
  fall back to the plain path) but runs under `torch.no_grad()`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as RefTrainConfig
from repro.configs import get_smoke as ref_get_smoke
from repro.data import DataConfig as RefDataConfig
from repro.data import make_batches as ref_make_batches
from repro.models import init_model as ref_init_model
from repro.training import adamw as ref_adamw
from repro.training.train_step import init_train_state as ref_init_state
from repro.training.train_step import train_step as ref_train_step
from repro_torch.bridge import params_from_jax
from repro_torch.config import TrainConfig
from repro_torch.configs import get_smoke
from repro_torch.data import DataConfig, make_batches
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import forward_train, init_model
from repro_torch.training import adamw
from repro_torch.training.train_step import init_train_state, train_step

torch.set_num_threads(2)

ADAM_RTOL = 1e-6


def f32(arch):
    return (dataclasses.replace(ref_get_smoke(arch), dtype="float32"),
            dataclasses.replace(get_smoke(arch), dtype="float32"))


def carry(tree, cfg):
    """A reference tree laid out as the model's parameters -> a port
    `Model` holding it (parameters, gradients, moments alike)."""
    return params_from_jax(jax.tree.map(np.asarray, tree), cfg, device="cpu")


def named(model):
    return {k: p.detach() for k, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_apply_matches_reference_on_a_model_state():
    """Two updates (the second on nonzero moments) with weight decay and
    an active clip, on stablelm-smoke's parameters and seeded gradients."""
    rcfg, pcfg = f32("stablelm-1.6b")
    ref_params = ref_init_model(jax.random.PRNGKey(0), rcfg).params
    rtc = RefTrainConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                         weight_decay=0.1, grad_clip=0.5)
    tc = TrainConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                     weight_decay=0.1, grad_clip=0.5)
    model = carry(ref_params, pcfg)
    state = adamw.init(model)
    ref_state = ref_adamw.init(ref_params)
    rng = np.random.default_rng(0)
    for _ in range(2):
        ref_grads = jax.tree.map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape)
                                  .astype(np.float32) * 0.01), ref_params)
        grads = named(carry(ref_grads, pcfg))
        ref_params, ref_state, ref_m = ref_adamw.apply(
            ref_state, ref_grads, rtc, jnp.float32)
        params = {k: p.data for k, p in model.named_parameters()}
        state, m = adamw.apply(state, grads, tc, params)
        assert float(ref_m["grad_norm"]) > tc.grad_clip   # the clip acts
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=ADAM_RTOL)
        np.testing.assert_allclose(float(m["lr"]), float(ref_m["lr"]),
                                   rtol=ADAM_RTOL)
    assert int(state.step) == int(ref_state.step) == 2
    for got, want in [(named(model), ref_params),
                      (state.master, ref_state.master),
                      (state.m, ref_state.m), (state.v, ref_state.v)]:
        want = named(carry(want, pcfg))
        for k in want:
            w = want[k].numpy()
            np.testing.assert_allclose(
                got[k].numpy(), w, rtol=ADAM_RTOL,
                atol=ADAM_RTOL * float(np.abs(w).max()), err_msg=k)


def _one(w, g, tc):
    """One `apply` on a single leaf; returns (new w, state, metrics)."""
    p = {"w": torch.tensor(w, dtype=torch.float32)}
    state = adamw.AdamWState(torch.zeros((), dtype=torch.int32),
                             {"w": p["w"].clone()},
                             {"w": torch.zeros_like(p["w"])},
                             {"w": torch.zeros_like(p["w"])})
    state, m = adamw.apply(state, {"w": torch.tensor(g)}, tc, p)
    return p["w"], state, m


def test_single_step_is_the_reference_math():
    tc = TrainConfig(lr=1e-2, warmup_steps=0, total_steps=10**9,
                     weight_decay=0.0, grad_clip=1e9)
    g = np.asarray([0.1, -0.2], np.float32)
    w, state, _ = _one([1.0, 2.0], g, tc)
    mh = (1 - 0.9) * g / (1 - 0.9)
    vh = (1 - 0.95) * g ** 2 / (1 - 0.95)
    expect = np.asarray([1.0, 2.0]) - 1e-2 * mh / (np.sqrt(vh) + tc.eps)
    np.testing.assert_allclose(w.numpy(), expect, rtol=1e-5)
    assert int(state.step) == 1


def test_weight_decay_pulls_toward_zero():
    tc = TrainConfig(lr=1e-2, warmup_steps=0, weight_decay=0.5,
                     total_steps=10**9)
    w, _, _ = _one([10.0], [0.0], tc)
    assert float(w[0]) < 10.0


def test_grad_clip_limits_update():
    tc = TrainConfig(lr=1.0, warmup_steps=0, grad_clip=1e-3,
                     weight_decay=0.0, total_steps=10**9)
    _, state, m = _one([1.0] * 4, [100.0] * 4, tc)
    assert float(m["grad_norm"]) == pytest.approx(200.0, rel=1e-4)
    assert float(state.m["w"].abs().max()) < 1e-3


def test_global_norm_in_the_references_leaf_order():
    rcfg, pcfg = f32("phi3.5-moe-42b-a6.6b")
    rng = np.random.default_rng(1)
    tree = jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)),
        ref_init_model(jax.random.PRNGKey(0), rcfg).params)
    got = adamw.global_norm(named(carry(tree, pcfg)))
    np.testing.assert_allclose(float(got), float(ref_adamw.global_norm(tree)),
                               rtol=ADAM_RTOL)
    # the groups are the reference's leaves, in jax.tree.leaves' order
    groups = adamw.leaf_groups(n for n, _ in carry(tree, pcfg)
                               .named_parameters())
    assert len(groups) == len(jax.tree.leaves(tree))
    assert groups[0] == ["blocks.0.attn.k.w", "blocks.1.attn.k.w"]


def test_lr_schedule_matches_reference():
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    tc, rtc = TrainConfig(**kw), RefTrainConfig(**kw)
    lrs = [float(adamw.lr_schedule(tc, s)) for s in [0, 5, 10, 50, 100]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(5e-4)
    assert lrs[2] == pytest.approx(1e-3)
    assert lrs[3] < 1e-3
    assert lrs[4] == pytest.approx(1e-4, rel=1e-2)
    steps = np.arange(0, 121)
    got = [float(adamw.lr_schedule(tc, torch.tensor(s, dtype=torch.int32)))
           for s in steps]
    want = [float(ref_adamw.lr_schedule(rtc, s)) for s in steps]
    np.testing.assert_allclose(got, want, rtol=ADAM_RTOL, atol=1e-12)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["stablelm-1.6b", "phi3.5-moe-42b-a6.6b"])
def test_three_steps_match_reference(arch):
    rcfg, pcfg = f32(arch)
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=10)
    rtc, tc = RefTrainConfig(**kw), TrainConfig(**kw)
    ref_model = ref_init_model(jax.random.PRNGKey(0), rcfg)
    state = init_train_state(carry(ref_model.params, pcfg), tc, device="cpu")
    ref_state = ref_init_state(ref_model, rtc)
    ref_step = jax.jit(lambda s, b: ref_train_step(s, b, rcfg, rtc))
    data = ref_make_batches(RefDataConfig(vocab=rcfg.vocab, seq_len=32,
                                          batch=4))
    lrs = []
    for _, batch in zip(range(3), data):
        ref_state, rm = ref_step(ref_state,
                                 {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = train_step(
            state, {k: torch.from_numpy(v) for k, v in batch.items()}, tc)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(rm[key]),
                                       rtol=1e-5, err_msg=key)
        lrs.append(float(m["lr"]))
    want = named(carry(ref_state.params, pcfg))
    got = named(state.model)
    n = n_off = 0
    for k in want:
        d = (got[k] - want[k]).abs()
        n += d.numel()
        n_off += int((d > 1e-6).sum())
        assert float(d.max()) <= 2 * sum(lrs), k
    assert n_off <= 0.01 * n, (n_off, n)


def test_microbatched_grads_match_whole_batch():
    """The reference's own test: stablelm-smoke in float32, a 4 x 32
    batch whole and as 4 microbatches."""
    _, cfg = f32("stablelm-1.6b")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (4, 32), generator=g,
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    out = []
    for n in (1, 4):
        tc = TrainConfig(microbatches=n)
        model = init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
        out.append(train_step(init_train_state(model, tc, device="cpu"),
                              batch, tc))
    (s1, m1), (s4, m4) = out
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-4)
    p1, p4 = named(s1.model), named(s4.model)
    assert max(float((p1[k] - p4[k]).abs().max()) for k in p1) < 1e-4


def test_loss_decreases_on_structured_data():
    """The reference's own test: stablelm-smoke (bf16), lr 3e-3, warmup
    5, 60 steps of 8 x 64 pipeline batches; the last 10 losses' mean at
    least 0.3 below the first 10's."""
    cfg = get_smoke("stablelm-1.6b")
    tc = TrainConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = init_train_state(model, tc, device="cpu")
    data = make_batches(DataConfig(vocab=cfg.vocab, seq_len=64, batch=8))
    losses = []
    for _, b in zip(range(60), data):
        state, m = train_step(
            state, {k: torch.from_numpy(v) for k, v in b.items()}, tc)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.3, losses[::10]


def test_train_step_wants_the_batch_on_the_model_device():
    _, cfg = f32("stablelm-1.6b")
    tc = TrainConfig()
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = init_train_state(model, tc, device="cpu")
    toks = np.zeros((2, 8), np.int32)
    with pytest.raises(ValueError, match="batch"):
        train_step(state, {"tokens": toks, "labels": toks}, tc)


# ---------------------------------------------------------------------------
# the kernels are forward-only
# ---------------------------------------------------------------------------

def _wrapper_calls():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)
    q, k, v = r(1, 8, 4, 32), r(1, 8, 2, 32), r(1, 8, 2, 32)
    qd = r(1, 4, 32)
    valid = torch.ones(8, dtype=torch.bool)
    xc, Bc, Cc = r(1, 2, 8, 2, 4), r(1, 2, 8, 4), r(1, 2, 8, 4)
    dtc, cum = r(1, 2, 8, 2).abs(), -r(1, 2, 8, 2).abs().cumsum(2)
    return {
        "flash_attention": (fa_ops.flash_attention, (q, k, v)),
        "decode_attention": (da_ops.decode_attention, (qd, k, v, valid)),
        "ssd_intra": (ssd_ops.ssd_intra, (xc, Bc, Cc, dtc, cum)),
    }


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "ssd_intra"])
def test_wrapper_refuses_autograd(name):
    fn, args = _wrapper_calls()[name]
    fn(*args)   # no input needs a gradient: runs
    needs = [a.clone().requires_grad_(a.is_floating_point()) for a in args]
    with pytest.raises(RuntimeError, match="forward-only"):
        fn(*needs)
    with torch.no_grad():
        fn(*needs)


def test_forward_train_kernel_impl_is_inference_only():
    _, cfg = f32("hymba-1.5b")
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    model.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(2))
    with pytest.raises(RuntimeError, match="forward-only"):
        forward_train(model, toks, impl="kernel")
    with torch.no_grad():
        got, _ = forward_train(model, toks, impl="kernel")
        want, _ = forward_train(model, toks, impl="plain")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
