"""The port's serving engine against the JAX reference, on the CPU.

Greedy `generate` of the port must equal the reference's `generate`
token for token on the smoke configs in float32 (the dense
`stablelm-smoke` and `starcoder2-smoke`, the state-space `mamba2-smoke`
and the hybrid `hymba-smoke`), with the reference's
`init_model` parameters carried across by `params_from_jax`
(`ServeConfig(max_seq=96)`, 12 new tokens, as `tests/test_substrates.py`
runs the reference engine).  Where a greedy token differs, the test
accepts it only if the port's two best logits at that step lie within
`TIE_TOL` of each other (a float32 near-tie that the packages' summation
orders may break differently) and such a case is recorded in ROADMAP
queue C; none occurs on these inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as RefServeConfig
from repro.configs import get_smoke as ref_get_smoke
from repro.models import init_model as ref_init_model
from repro.serving.blackbox import BlackBoxProvider as RefBlackBoxProvider
from repro.serving.engine import generate as ref_generate
from repro_torch.bridge import params_from_jax
from repro_torch.config import ServeConfig
from repro_torch.configs import get_smoke
from repro_torch.models import decode_step, prefill
from repro_torch.serving import BlackBoxProvider, generate

torch.set_num_threads(2)

TIE_TOL = 1e-4   # the logit tolerance of tests/test_torch_models.py

_MODELS = {}


def models(arch):
    if arch not in _MODELS:
        rcfg = dataclasses.replace(ref_get_smoke(arch), dtype="float32")
        pcfg = dataclasses.replace(get_smoke(arch), dtype="float32")
        params = ref_init_model(jax.random.PRNGKey(0), rcfg).params
        _MODELS[arch] = (params, rcfg,
                         params_from_jax(params, pcfg, device="cpu"), pcfg)
    return _MODELS[arch]


def prompt(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape,
                                                dtype=np.int32)


def top2_gap(model, prompt_row, generated, step, max_seq):
    """The gap between the port's two best logits when it chose
    `generated[step]`, teacher-forced on the tokens before it."""
    logits, caches = prefill(model, torch.from_numpy(prompt_row[None]),
                             max_seq)
    pos = prompt_row.shape[0]
    for i in range(step):
        tok = torch.tensor([[int(generated[i])]], dtype=torch.int32)
        logits, caches = decode_step(model, tok, pos + i, caches)
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1])


def assert_same_tokens(port, ref, model, prompts, max_seq):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    for b in range(port.shape[0]):
        diff = np.nonzero(port[b] != ref[b])[0]
        if diff.size:
            step = int(diff[0])
            gap = top2_gap(model, prompts[b], port[b], step, max_seq)
            assert gap < TIE_TOL, (
                f"row {b} differs at step {step} with a top-2 logit gap of "
                f"{gap}: not a near-tie")


@pytest.mark.parametrize("arch,S_p", [
    ("stablelm-1.6b", 8),
    ("starcoder2-3b", 8),
    ("starcoder2-3b", 60),    # prompt + 12 tokens wraps the ring of 64
    ("mamba2-780m", 8),       # one short chunk
    ("mamba2-780m", 40),      # a padded second chunk
    ("hymba-1.5b", 8),
    ("hymba-1.5b", 26),       # prompt + 12 tokens passes the window of 32
])
def test_greedy_generate_matches_reference(arch, S_p):
    params, rcfg, model, pcfg = models(arch)
    p = prompt(2, (2, S_p), pcfg.vocab)
    want = ref_generate(params, rcfg, RefServeConfig(max_seq=96), 
                        jnp.asarray(p), 12)
    got = generate(model, ServeConfig(max_seq=96), p, 12, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, 12)
    assert_same_tokens(got, want, model, p, 96)


def test_blackbox_submit_matches_reference():
    params, rcfg, model, pcfg = models("stablelm-1.6b")
    p = prompt(3, (10,), pcfg.vocab)
    want = RefBlackBoxProvider(params, rcfg, RefServeConfig(max_seq=96)
                               ).submit(p, 9)
    provider = BlackBoxProvider(model, ServeConfig(max_seq=96), device="cpu")
    got = provider.submit(p, 9)
    assert isinstance(got, np.ndarray) and got.shape == (9,)
    assert_same_tokens(got[None], np.asarray(want)[None], model, p[None], 96)


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_blackbox_serves_ssm_and_hybrid_models(arch):
    """`BlackBoxProvider` works unchanged over a state-space or hybrid
    model: the same answers as the reference's provider, and a second
    request starts from fresh state (no SSM state leaks between
    requests)."""
    params, rcfg, model, pcfg = models(arch)
    p = prompt(8, (33,), pcfg.vocab)
    want = RefBlackBoxProvider(params, rcfg, RefServeConfig(max_seq=96)
                               ).submit(p, 7)
    provider = BlackBoxProvider(model, ServeConfig(max_seq=96), device="cpu")
    got = provider.submit(p, 7)
    assert got.shape == (7,) and got.dtype == np.int32
    assert_same_tokens(got[None], np.asarray(want)[None], model, p[None], 96)
    provider.submit(prompt(9, (5,), pcfg.vocab), 3)
    np.testing.assert_array_equal(provider.submit(p, 7), got)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "starcoder2-3b",
                                  "mamba2-780m"])
def test_tokens_after_eos_are_eos(arch):
    params, rcfg, model, pcfg = models(arch)
    p = prompt(4, (2, 8), pcfg.vocab)
    free = np.asarray(generate(model, ServeConfig(max_seq=96), p, 12,
                               device="cpu"))
    eos = int(free[0, 3])   # row 0 emits it at step 3 (or earlier)
    sc = ServeConfig(max_seq=96, eos_id=eos)
    got = np.asarray(generate(model, sc, p, 12, device="cpu"))
    want = np.asarray(ref_generate(params, rcfg,
                                   RefServeConfig(max_seq=96, eos_id=eos),
                                   jnp.asarray(p), 12))
    np.testing.assert_array_equal(got, want)
    for row in got:
        hits = np.nonzero(row == eos)[0]
        if hits.size:
            assert (row[hits[0]:] == eos).all()
    first = int(np.nonzero(got[0] == eos)[0][0])
    assert first <= 3 and (got[0, first:] == eos).all()


def test_sampling_is_seeded_and_in_vocab():
    _, _, model, pcfg = models("stablelm-1.6b")
    p = prompt(5, (2, 6), pcfg.vocab)
    sc = ServeConfig(max_seq=64, temperature=0.8)
    a = generate(model, sc, p, 10, seed=7, device="cpu")
    b = generate(model, sc, p, 10, seed=7, device="cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(a.min()) >= 0 and int(a.max()) < pcfg.vocab


def test_generate_rejects_a_model_on_another_device():
    _, _, model, _ = models("stablelm-1.6b")
    with pytest.raises(ValueError):
        generate(model, ServeConfig(max_seq=64), prompt(6, (1, 4), 512), 2,
                 device="meta")
