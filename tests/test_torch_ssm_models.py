"""The port's state-space and hybrid models against the JAX reference,
on the CPU.

The reference's `init_model` parameters for `mamba2-smoke` (48-layer
Mamba2-780M cut to 2 layers, d_model 256, state 32, chunk 32) and
`hymba-smoke` (2 layers, d_model 320, 5 heads, window 32, global layer
0, state 16, chunk 32) are carried across with
`repro_torch.bridge.params_from_jax`, and both packages get the same
numpy tokens:

* `prefill` logits and caches (KV cache and SSM state of every layer)
  against the reference's `prefill(impl="xla")`, and for
  `mamba2-smoke` also against `prefill(impl="pallas")`, whose
  interpret-mode `ssd_intra` runs (Hymba's cannot: its attention
  windows reach the flash kernel traced, ROADMAP's reference caveat);
  prompts within one chunk, across a padded chunk boundary, and for
  Hymba past its window;
* `decode_step` logits against `decode_step(impl="xla")` and
  `(impl="pallas")`, starting from the reference's prefill caches, over
  positions that cross a chunk boundary (Mamba2) and the window
  (Hymba);
* bfloat16 logits, and `params_from_jax` on the SSM leaves.

Tolerances are those of `tests/test_torch_models.py`: 1e-4 absolute on
float32 logits and caches (of order 1; the packages sum in different
orders), 0.15 absolute on bfloat16 logits (the packages round at
different places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import (
    BF16_LOGIT_TOL,
    LOGIT_TOL,
    SSM_ARCHS,
    assert_caches_equal,
    models,
    np32,
    ref_caches_as_port,
    tokens,
)

from repro.models import decode_step as ref_decode_step
from repro.models import prefill as ref_prefill
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.models import decode_step, prefill


@pytest.mark.parametrize("arch,S,impl", [
    ("mamba2-780m", 8, "xla"),       # one chunk of 8
    ("mamba2-780m", 8, "pallas"),
    ("mamba2-780m", 40, "xla"),      # two chunks of 32, the second padded
    ("mamba2-780m", 40, "pallas"),
    ("mamba2-780m", 64, "pallas"),   # two full chunks
    ("hymba-1.5b", 20, "xla"),
    ("hymba-1.5b", 45, "xla"),       # past the smoke window of 32
])
def test_ssm_prefill_matches_reference(arch, S, impl):
    params, rcfg, model, pcfg = models(arch)
    toks = tokens(8, (2, S), pcfg.vocab)
    want_logits, want_caches = ref_prefill(params, rcfg, jnp.asarray(toks),
                                           64, impl=impl)
    got_logits, got_caches = prefill(model, torch.from_numpy(toks), 64)
    assert got_logits.shape == (2, 1, pcfg.padded_vocab)
    np.testing.assert_allclose(np32(got_logits), np32(want_logits),
                               atol=LOGIT_TOL)
    assert_caches_equal(got_caches, want_caches, pcfg.n_layers, LOGIT_TOL)


@pytest.mark.parametrize("arch,S,steps", [
    ("mamba2-780m", 29, 6),        # positions 29..34 cross the chunk of 32
    ("hymba-1.5b", 29, 5),         # 29..33 pass the window of 32
])
def test_ssm_decode_matches_reference(arch, S, steps):
    params, rcfg, model, pcfg = models(arch)
    max_seq = 64
    toks = tokens(10, (2, S + steps), pcfg.vocab)
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
    assert_caches_equal(port_caches, caches["xla"], pcfg.n_layers, LOGIT_TOL)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_bfloat16_logits_within_the_stated_bound(arch):
    params, rcfg, model, pcfg = models(arch, "bfloat16")
    toks = tokens(9, (1, 38), pcfg.vocab)
    want, ref_caches = ref_prefill(params, rcfg, jnp.asarray(toks[:, :36]),
                                   64, impl="xla")
    got, caches = prefill(model, torch.from_numpy(toks[:, :36].copy()), 64)
    assert got.dtype == torch.float32
    assert caches[0].ssm.ssd.dtype == torch.float32
    assert caches[0].ssm.conv.dtype == torch.bfloat16
    assert np.abs(np32(got) - np32(want)).max() < BF16_LOGIT_TOL
    for i in (36, 37):
        tok = toks[:, i:i + 1]
        want, ref_caches = ref_decode_step(params, rcfg, jnp.asarray(tok),
                                           jnp.int32(i), ref_caches,
                                           impl="pallas")
        got, caches = decode_step(model, torch.from_numpy(tok.copy()), i,
                                  caches)
        assert np.abs(np32(got) - np32(want)).max() < BF16_LOGIT_TOL


def test_params_from_jax_carries_the_ssm_leaves():
    for arch in SSM_ARCHS:
        params, _, model, pcfg = models(arch)
        ssm = model.blocks[1].ssm
        ref = jax.tree.map(lambda a: a[1], params["blocks"])["ssm"]
        for name in ("conv_w", "conv_b", "A_log", "D", "dt_bias"):
            np.testing.assert_array_equal(np32(getattr(ssm, name)),
                                          np32(ref[name]))
        np.testing.assert_array_equal(np32(ssm.in_proj.w),
                                      np32(ref["in_proj"]["w"]))
        np.testing.assert_array_equal(np32(ssm.norm.scale),
                                      np32(ref["norm"]["scale"]))
    params, _, _, pcfg = models("mamba2-780m")
    wider = dataclasses.replace(pcfg, ssm=dataclasses.replace(
        pcfg.ssm, d_state=pcfg.ssm.d_state * 2))
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(params, wider, device="cpu")
    params, _, _, pcfg = models("hymba-1.5b")
    with pytest.raises(ValueError, match="unexpected"):
        params_from_jax(params, dataclasses.replace(pcfg, arch_type="ssm"),
                        device="cpu")
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(models("mamba2-780m")[0], dataclasses.replace(
            get_smoke("mamba2-780m"), dtype="float32", arch_type="hybrid",
            n_heads=8, n_kv=8, d_ff=64), device="cpu")
