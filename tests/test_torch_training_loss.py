"""The port's `lm_loss` and its gradients against the JAX reference, on
the CPU.

The reference's `init_model` parameters for five smoke configs in
float32 are carried across with `params_from_jax`: `stablelm-smoke`
(dense), `phi35-moe-smoke` (the MoE layer and its aux loss),
`mamba2-smoke` (the SSM mixer, two chunks and a ragged tail),
`hymba-smoke` (hybrid, a global layer and a window of 32 that 48
tokens pass) and `internvl2-smoke` (a modality prefix of 16 positions
that the loss leaves out).  Both packages get the same numpy tokens
(and prefix), the reference through `jax.value_and_grad(lm_loss)` with
`impl="xla"`, the port through `lm_loss(impl="plain")` and
`backward()`.  The reference's gradient tree is carried across with
`params_from_jax` itself and held leaf by leaf against the port's
`.grad`.

Tolerances: the loss within 1e-5 relative; each gradient leaf within
1e-5 + 1e-4 * max|g_ref| absolute (the two packages sum their float32
products in different orders; the worst leaf reads ~4% of this).
`remat=True` gives the same loss and gradients as `remat=False`
(rtol 1e-6, atol 1e-9: the recomputed forward repeats the same
operations).  In bf16 the serve runs' rule holds the training forward:
the port's logits and per-token NLL lie within 2 f of the reference's
bf16 ones and within 1.5 f of float32, f being the reference's own
bf16 gap (a max over many elements; the mean loss alone is no floor:
its errors average out, and on this seed the reference's bf16 loss lies
several times closer to float32 than the port's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.models import init_model as ref_init_model
from repro.models.model import lm_loss as ref_lm_loss
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.models import forward_train, lm_loss

torch.set_num_threads(2)

FAMILIES = ["stablelm-1.6b", "phi3.5-moe-42b-a6.6b", "mamba2-780m",
            "hymba-1.5b", "internvl2-1b"]
B, S = 2, 48
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


def configs(arch, dtype="float32"):
    return (dataclasses.replace(ref_get_smoke(arch), dtype=dtype),
            dataclasses.replace(get_smoke(arch), dtype=dtype))


def inputs(cfg, seed=0):
    """Seeded (tokens, labels, prefix or None) as numpy arrays."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    pe = None
    if cfg.prefix_len:
        pe = (rng.standard_normal((B, cfg.prefix_len, cfg.d_model))
              * 0.02).astype(np.float32)
    return toks[:, :-1].copy(), toks[:, 1:].copy(), pe


def ref_value_and_grad(params, rcfg, tokens, labels, pe):
    def f(p):
        return ref_lm_loss(p, rcfg, jnp.asarray(tokens), jnp.asarray(labels),
                           None if pe is None else jnp.asarray(pe),
                           impl="xla", remat=True)
    return jax.value_and_grad(f)(params)


def port_loss_and_grads(model, tokens, labels, pe, remat=True):
    model.zero_grad(set_to_none=True)
    model.requires_grad_(True)
    loss = lm_loss(model, torch.from_numpy(tokens), torch.from_numpy(labels),
                   None if pe is None else torch.from_numpy(pe),
                   remat=remat)
    loss.backward()
    return loss.detach(), {k: p.grad.clone()
                           for k, p in model.named_parameters()}


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_reference(arch):
    rcfg, pcfg = configs(arch)
    ref_model = ref_init_model(jax.random.PRNGKey(0), rcfg)
    tokens, labels, pe = inputs(rcfg)
    ref_loss, ref_grads = ref_value_and_grad(ref_model.params, rcfg, tokens,
                                             labels, pe)
    model = params_from_jax(to_numpy_tree(ref_model.params), pcfg,
                            device="cpu")
    loss, grads = port_loss_and_grads(model, tokens, labels, pe)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    want = params_from_jax(to_numpy_tree(ref_grads), pcfg, device="cpu")
    for name, g_ref in want.named_parameters():
        tol = GRAD_ATOL + GRAD_RTOL * float(g_ref.abs().max())
        err = float((grads[name] - g_ref).abs().max())
        assert err <= tol, f"{arch} {name}: {err} > {tol}"


def test_moe_aux_loss_is_in_the_loss():
    """The aux loss summed over the layers is part of `lm_loss`, and it
    equals the reference's (forward_train's aux against its own)."""
    from repro.models.model import forward_train as ref_forward_train

    rcfg, pcfg = configs("phi3.5-moe-42b-a6.6b")
    ref_model = ref_init_model(jax.random.PRNGKey(0), rcfg)
    tokens, labels, _ = inputs(rcfg)
    _, ref_aux = ref_forward_train(ref_model.params, rcfg,
                                   jnp.asarray(tokens), impl="xla")
    model = params_from_jax(to_numpy_tree(ref_model.params), pcfg,
                            device="cpu")
    with torch.no_grad():
        logits, aux = forward_train(model, torch.from_numpy(tokens))
        loss = lm_loss(model, torch.from_numpy(tokens),
                       torch.from_numpy(labels))
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)
    logp = torch.log_softmax(logits, -1)
    nll = -logp.gather(-1, torch.from_numpy(labels)[..., None].long()).mean()
    np.testing.assert_allclose(float(loss), float(nll + aux), rtol=1e-6)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "hymba-1.5b"])
def test_remat_changes_nothing(arch):
    _, pcfg = configs(arch)
    from repro_torch.models import init_model

    model = init_model(pcfg, torch.Generator().manual_seed(0), device="cpu")
    tokens, labels, pe = inputs(pcfg)
    l1, g1 = port_loss_and_grads(model, tokens, labels, pe, remat=True)
    l0, g0 = port_loss_and_grads(model, tokens, labels, pe, remat=False)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-6, atol=1e-9)


def _nll(logits, labels):
    """Per-token next-token NLL (float64) of float32 logits."""
    x = np.asarray(logits, np.float64)
    x = x - x.max(-1, keepdims=True)
    logp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    return -np.take_along_axis(logp, labels[..., None], -1)[..., 0]


def test_bf16_loss_within_the_references_own_rounding():
    """The serve runs' bf16 rule on the training forward: the port's bf16
    logits, and the per-token NLL the loss averages, lie within 2 f of
    the reference's bf16 ones and within 1.5 f of float32 arithmetic on
    the same weights, f being the reference bf16 path's own largest gap
    to float32 (e <= 2 f, g <= 1.5 f).  The loss, their mean, then lies
    within 2 f of the reference's too."""
    from repro.models.model import forward_train as ref_forward_train

    r32, _ = configs("stablelm-1.6b", "float32")
    r16, p16 = configs("stablelm-1.6b", "bfloat16")
    ref_model = ref_init_model(jax.random.PRNGKey(0), r16)
    tokens, labels, _ = inputs(r16)
    ref16, _ = ref_forward_train(ref_model.params, r16, jnp.asarray(tokens),
                                 impl="xla")
    params32 = jax.tree.map(lambda x: x.astype(jnp.float32), ref_model.params)
    ref32, _ = ref_forward_train(params32, r32, jnp.asarray(tokens),
                                 impl="xla")
    model = params_from_jax(to_numpy_tree(ref_model.params), p16,
                            device="cpu")
    with torch.no_grad():
        port16, _ = forward_train(model, torch.from_numpy(tokens))
    port16, ref16, ref32 = port16.numpy(), np.asarray(ref16), np.asarray(ref32)
    for what, a, b, c in [
            ("logits", port16, ref16, ref32),
            ("nll", _nll(port16, labels), _nll(ref16, labels),
             _nll(ref32, labels))]:
        e, f, g = (float(np.abs(x - y).max())
                   for x, y in ((a, b), (b, c), (a, c)))
        assert f > 0
        assert e <= 2 * f, (what, e, f)
        assert g <= 1.5 * f, (what, g, f)
    loss, grads = port_loss_and_grads(model, tokens, labels, None)
    assert abs(float(loss) - float(_nll(ref16, labels).mean())) <= 2 * f
    assert all(g.dtype == torch.bfloat16 for g in grads.values())
