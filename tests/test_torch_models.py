"""The port's model substrate against the JAX reference, on the CPU.

The reference's `init_model` parameters for `stablelm-smoke`,
`starcoder2-smoke`, `mamba2-smoke` and `hymba-smoke` are carried across
with `repro_torch.bridge.params_from_jax`, and both packages get the
same numpy inputs.  Held module by module (norms, RoPE, MLP, attention;
the SSM mixer in `tests/test_torch_ssm.py`) and as a whole:

* `prefill` logits and caches against the reference's
  `prefill(impl="xla")` (its model-level Pallas prefill cannot run: the
  per-layer window reaches the kernel traced; see ROADMAP's reference
  caveats);
* `decode_step` logits against `decode_step(impl="pallas")` (the
  interpret-mode Pallas decode kernel) and `(impl="xla")` over several
  positions, through starcoder2's ring cache wrapping around its smoke
  window of 64.

The state-space and hybrid models' prefill, decode and bfloat16 cases
are in `tests/test_torch_ssm_models.py`; the configs and cache layouts
of all four archs are held here.

Tolerance in float32: 1e-4 absolute on logits (of order 1; the two
packages sum their float32 products in different orders) and 2e-5 on
the modules.  In bfloat16 the packages round at different places (XLA's
CPU dot against torch's), so the bfloat16 case is held to 0.15 absolute
on logits, still far below their spread.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as RefServeConfig
from repro.configs import get as ref_get
from repro.configs import get_smoke as ref_get_smoke
from repro.models import decode_step as ref_decode_step
from repro.models import init_caches as ref_init_caches
from repro.models import init_model as ref_init_model
from repro.models import prefill as ref_prefill
from repro.models.attention import KVCache as RefKVCache
from repro.models.attention import attn_decode, attn_prefill
from repro.models.mlp import mlp_apply
from repro.models.norms import norm_apply
from repro.models.rope import apply_rope as ref_apply_rope
from repro_torch.bridge import params_from_jax
from repro_torch.config import ServeConfig
from repro_torch.configs import get, get_smoke
from repro_torch.models import (
    KVCache,
    LayerCache,
    SSMState,
    decode_step,
    init_caches,
    prefill,
)
from repro_torch.models.blocks import layer_window
from repro_torch.models.mlp import MLP
from repro_torch.models.norms import Norm
from repro_torch.models.rope import apply_rope

torch.set_num_threads(2)

ARCHS = ["stablelm-1.6b", "starcoder2-3b"]
SSM_ARCHS = ["mamba2-780m", "hymba-1.5b"]
LOGIT_TOL = 1e-4
MODULE_TOL = 2e-5
BF16_LOGIT_TOL = 0.15


def configs(arch, dtype="float32"):
    return (dataclasses.replace(ref_get_smoke(arch), dtype=dtype),
            dataclasses.replace(get_smoke(arch), dtype=dtype))


_MODELS = {}


def models(arch, dtype="float32"):
    """(reference params, reference cfg, port model, port cfg), cached."""
    key = (arch, dtype)
    if key not in _MODELS:
        rcfg, pcfg = configs(arch, dtype)
        params = ref_init_model(jax.random.PRNGKey(0), rcfg).params
        _MODELS[key] = (params, rcfg,
                        params_from_jax(params, pcfg, device="cpu"), pcfg)
    return _MODELS[key]


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape,
                                                dtype=np.int32)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("arch", ARCHS + SSM_ARCHS + ["arctic-480b"])
def test_config_fields_equal_the_reference(arch):
    if arch == "arctic-480b":   # not ported: MoE blocks
        with pytest.raises(KeyError, match="ROADMAP"):
            get(arch)
        return
    for mine, ref in ((get(arch), ref_get(arch)),
                      (get_smoke(arch), ref_get_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.head_dim == ref.head_dim
        assert mine.padded_vocab == ref.padded_vocab
        assert mine.d_inner == ref.d_inner
        assert mine.n_ssm_heads == ref.n_ssm_heads


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norm(kind):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    p = {"scale": jnp.asarray(scale)}
    norm = Norm(64, kind, torch.float32, "cpu")
    norm.scale.copy_(torch.from_numpy(scale))
    if kind == "layernorm":
        p["bias"] = jnp.asarray(bias)
        norm.bias.copy_(torch.from_numpy(bias))
    want = norm_apply(p, jnp.asarray(x), kind)
    got = norm(torch.from_numpy(x))
    np.testing.assert_allclose(np32(got), np32(want), atol=MODULE_TOL)


@pytest.mark.parametrize("fraction", [0.25, 1.0])
def test_rope(fraction):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 3000, size=(2, 7)).astype(np.int32)
    want = ref_apply_rope(jnp.asarray(x), jnp.asarray(pos), fraction)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), fraction)
    # angles up to 3000 rad: float32 sin/cos of the two libraries differ
    # in the last ulp of the angle's reduction
    np.testing.assert_allclose(np32(got), np32(want), atol=1e-5)
    np.testing.assert_array_equal(np32(got)[..., int(64 * fraction):],
                                  x[..., int(64 * fraction):])


@pytest.mark.parametrize("activation", ["silu_gated", "gelu", "sq_relu"])
def test_mlp(activation):
    rng = np.random.default_rng(2)
    d, ff = 32, 48
    mlp = MLP(d, ff, activation, torch.float32, "cpu", bias=True)
    p = {}
    for name in ("wi", "wg", "wo"):
        layer = getattr(mlp, name)
        if layer is None:
            continue
        w = (rng.standard_normal(tuple(layer.w.shape)) * 0.2).astype(np.float32)
        b = rng.standard_normal(tuple(layer.b.shape)).astype(np.float32)
        layer.w.copy_(torch.from_numpy(w))
        layer.b.copy_(torch.from_numpy(b))
        p[name] = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    x = rng.standard_normal((3, 4, d)).astype(np.float32)
    want = mlp_apply(p, jnp.asarray(x), activation)
    got = mlp(torch.from_numpy(x))
    np.testing.assert_allclose(np32(got), np32(want), atol=MODULE_TOL,
                               rtol=MODULE_TOL)


def _layer0(params):
    return jax.tree.map(lambda a: a[0], params["blocks"])


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_prefill_and_decode(arch):
    params, rcfg, model, pcfg = models(arch)
    p_attn = _layer0(params)["attn"]
    attn = model.blocks[0].attn
    window = layer_window(pcfg, 0)
    B, S = 2, 40
    x = np.random.default_rng(3).standard_normal(
        (B, S, pcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want, (wk, wv) = attn_prefill(p_attn, rcfg, jnp.asarray(x),
                                  jnp.asarray(pos), window)
    got, (gk, gv) = attn.prefill(torch.from_numpy(x),
                                 torch.from_numpy(pos.copy()), window)
    np.testing.assert_allclose(np32(got), np32(want), atol=MODULE_TOL)
    np.testing.assert_allclose(np32(gk), np32(wk), atol=MODULE_TOL)
    np.testing.assert_allclose(np32(gv), np32(wv), atol=MODULE_TOL)

    # one decode token at position S against a linear cache of 48
    # holding the prompt's K/V
    S_c = 48
    kc = np.zeros((B, S_c, pcfg.n_kv, pcfg.head_dim), np.float32)
    vc = kc.copy()
    kc[:, :S], vc[:, :S] = np32(wk), np32(wv)
    xd = np.random.default_rng(4).standard_normal(
        (B, 1, pcfg.d_model)).astype(np.float32)
    for impl in ("xla", "pallas"):
        want, wc = attn_decode(p_attn, rcfg, jnp.asarray(xd), jnp.int32(S),
                               RefKVCache(jnp.asarray(kc), jnp.asarray(vc)),
                               window, impl)
        cache = KVCache(torch.from_numpy(kc.copy()),
                        torch.from_numpy(vc.copy()))
        got, gc = attn.decode(torch.from_numpy(xd), S, cache, window)
        np.testing.assert_allclose(np32(got), np32(want), atol=MODULE_TOL)
        np.testing.assert_allclose(np32(gc.k), np32(wc.k), atol=MODULE_TOL)


def _layer(tree, i):
    return torch.from_numpy(np.asarray(tree)[i].copy())


def ref_caches_as_port(caches, n_layers):
    """The reference's stacked caches as the port's per-layer list."""
    out = []
    for i in range(n_layers):
        kv = st = None
        if "kv" in caches:
            kv = KVCache(_layer(caches["kv"].k, i), _layer(caches["kv"].v, i))
        if "ssm" in caches:
            st = SSMState(_layer(caches["ssm"]["ssd"], i),
                          _layer(caches["ssm"]["conv"], i))
        out.append(LayerCache(kv, st))
    return out


def assert_caches_equal(got, want, n_layers, tol):
    """The port's per-layer caches against the reference's stacked ones
    (as `ref_caches_as_port` lays them out); `tests/test_torch_ssm_models.py`
    holds the SSM and hybrid caches with it."""
    want = ref_caches_as_port(want, n_layers)
    assert len(got) == n_layers
    for g, w in zip(got, want):
        for part in ("kv", "ssm"):
            gp, wp = getattr(g, part), getattr(w, part)
            assert (gp is None) == (wp is None), part
            if gp is None:
                continue
            for gt, wt in zip(gp, wp):
                assert gt.shape == wt.shape and gt.dtype == wt.dtype
                np.testing.assert_allclose(np32(gt), np32(wt), atol=tol,
                                           rtol=tol, err_msg=part)


@pytest.mark.parametrize("arch,S,max_seq", [
    ("stablelm-1.6b", 24, 96),
    ("starcoder2-3b", 24, 96),     # ring of 64, not yet wrapped
    ("starcoder2-3b", 90, 96),     # prompt longer than the window
])
def test_prefill_matches_reference(arch, S, max_seq):
    params, rcfg, model, pcfg = models(arch)
    toks = tokens(5, (2, S), pcfg.vocab)
    want_logits, want_caches = ref_prefill(params, rcfg, jnp.asarray(toks),
                                           max_seq, impl="xla")
    got_logits, got_caches = prefill(model, torch.from_numpy(toks), max_seq)
    assert got_logits.dtype == torch.float32
    assert got_logits.shape == (2, 1, pcfg.padded_vocab)
    np.testing.assert_allclose(np32(got_logits), np32(want_logits),
                               atol=LOGIT_TOL)
    wk = np.asarray(want_caches["kv"].k)
    wv = np.asarray(want_caches["kv"].v)
    assert len(got_caches) == pcfg.n_layers
    for i, c in enumerate(got_caches):
        assert c.ssm is None and c.kv.k.shape == wk[i].shape
        np.testing.assert_allclose(np32(c.kv.k), wk[i], atol=LOGIT_TOL)
        np.testing.assert_allclose(np32(c.kv.v), wv[i], atol=LOGIT_TOL)


@pytest.mark.parametrize("arch,S,steps", [
    ("stablelm-1.6b", 20, 6),
    ("starcoder2-3b", 58, 9),      # positions 58..66 wrap the ring of 64
])
def test_decode_matches_reference(arch, S, steps):
    params, rcfg, model, pcfg = models(arch)
    max_seq = 96
    toks = tokens(6, (2, S + steps), pcfg.vocab)
    _, ref_caches = ref_prefill(params, rcfg, jnp.asarray(toks[:, :S]),
                                max_seq, impl="xla")
    caches = {impl: ref_caches for impl in ("xla", "pallas")}
    port_caches = ref_caches_as_port(ref_caches, pcfg.n_layers)
    for i in range(S, S + steps):
        tok = toks[:, i:i + 1]
        got, port_caches = decode_step(model, torch.from_numpy(tok), i,
                                       port_caches)
        for impl in ("xla", "pallas"):
            want, caches[impl] = ref_decode_step(
                params, rcfg, jnp.asarray(tok), jnp.int32(i), caches[impl],
                impl=impl)
            np.testing.assert_allclose(np32(got), np32(want), atol=LOGIT_TOL,
                                       err_msg=f"{impl} position {i}")


@pytest.mark.parametrize("arch", ARCHS + SSM_ARCHS)
def test_init_caches_match_reference_layout(arch):
    _, rcfg, _, pcfg = models(arch)
    want = ref_caches_as_port(ref_init_caches(rcfg, 3, 96), pcfg.n_layers)
    got = init_caches(pcfg, 3, 96, device="cpu")
    assert len(got) == pcfg.n_layers
    for g, w in zip(got, want):
        for part in ("kv", "ssm"):
            gp, wp = getattr(g, part), getattr(w, part)
            assert (gp is None) == (wp is None), part
            for gt, wt in zip(gp or (), wp or ()):
                assert gt.shape == wt.shape and gt.dtype == wt.dtype
                assert not gt.any()


def test_unported_blocks_raise_naming_the_roadmap():
    _, _, _, pcfg = models("stablelm-1.6b")
    from repro_torch.models.model import Model
    for kind in ("vlm", "moe"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Model(dataclasses.replace(pcfg, arch_type=kind), device="cpu")


def test_bfloat16_logits_within_the_stated_bound():
    params, rcfg, model, pcfg = models("stablelm-1.6b", "bfloat16")
    toks = tokens(7, (1, 30), pcfg.vocab)
    want, ref_caches = ref_prefill(params, rcfg, jnp.asarray(toks[:, :28]),
                                   64, impl="xla")
    got, caches = prefill(model, torch.from_numpy(toks[:, :28].copy()), 64)
    assert got.dtype == torch.float32
    assert np.abs(np32(got) - np32(want)).max() < BF16_LOGIT_TOL
    for i in (28, 29):
        tok = toks[:, i:i + 1]
        want, ref_caches = ref_decode_step(params, rcfg, jnp.asarray(tok),
                                           jnp.int32(i), ref_caches,
                                           impl="pallas")
        got, caches = decode_step(model, torch.from_numpy(tok.copy()), i,
                                  caches)
        assert np.abs(np32(got) - np32(want)).max() < BF16_LOGIT_TOL


def test_params_from_jax_rejects_mismatched_trees():
    params, rcfg, _, pcfg = models("stablelm-1.6b")
    wrong = dataclasses.replace(pcfg, d_ff=pcfg.d_ff + 8)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(params, wrong, device="cpu")
    fewer = dataclasses.replace(pcfg, n_layers=1)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(params, fewer, device="cpu")
    biased = dataclasses.replace(pcfg, qkv_bias=True)
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(params, biased, device="cpu")
    with pytest.raises(TypeError):
        params_from_jax(params, dataclasses.replace(pcfg, dtype="bfloat16"),
                        device="cpu")


def test_serve_config_defaults_equal_the_reference():
    assert dataclasses.asdict(ServeConfig()) == dataclasses.asdict(
        RefServeConfig())
