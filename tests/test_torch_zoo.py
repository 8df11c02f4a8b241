"""The rest of the model zoo against the JAX reference, on the CPU.

The six architectures the port gained last (the MoE `arctic-480b` and
`phi3.5-moe-42b-a6.6b`, the dense `nemotron-4-340b` (squared ReLU,
LayerNorm) and `qwen1.5-32b` (QKV bias), and the prefixed
`internvl2-1b` (256 patch embeddings, QKV bias) and `musicgen-large` (64
frame embeddings, no RoPE: sinusoidal positions)) run at their smoke
sizes with the reference's `init_model` parameters carried across by
`params_from_jax` (the MoE leaves as (L, E, d, ff) stacks), on the same
numpy inputs and prefix embeddings:

* `prefill` logits and caches against the reference's
  `prefill(impl="xla")`, prefix included (the reference's own pattern,
  `tests/test_models.py:119-127`), over a batch of two 24-token prompts,
  where the MoE smoke configs' capacity drops slots;
* `decode_step` logits against the reference's `decode_step(impl="xla")`
  over several positions past the prompt (and the prefix), from the
  reference's prefill caches;
* greedy `generate` tokens equal to the reference's `generate`, with
  `prefix_embeds` for the prefixed two (decode starting at S_p +
  prefix_len), as `tests/test_torch_serving.py` holds the others.

Tolerance: 1e-4 absolute on float32 logits (`tests/test_torch_models.py`'s
LOGIT_TOL; the packages sum in different orders), and greedy tokens
equal up to a near-tie of the port's two best logits (TIE_TOL, as
`tests/test_torch_serving.py`; none occurs on these inputs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as RefServeConfig
from repro.models import decode_step as ref_decode_step
from repro.models import prefill as ref_prefill
from repro.serving.engine import generate as ref_generate
from repro_torch.config import ServeConfig
from repro_torch.models import decode_step, prefill
from repro_torch.models.moe import MoE
from repro_torch.serving import generate
from test_torch_models import (
    LOGIT_TOL,
    assert_caches_equal,
    models,
    np32,
    ref_caches_as_port,
    tokens,
)
from test_torch_serving import assert_same_tokens

torch.set_num_threads(2)

ZOO = ["arctic-480b", "phi3.5-moe-42b-a6.6b", "nemotron-4-340b",
       "qwen1.5-32b", "internvl2-1b", "musicgen-large"]
PREFIXED = ["internvl2-1b", "musicgen-large"]
MAX_SEQ = 96


def prefix(seed, batch, cfg):
    """Seeded prefix embeddings (B, prefix_len, d_model), scaled as the
    reference's model tests scale theirs; None for an arch without one."""
    if not cfg.prefix_len:
        return None
    return (np.random.default_rng(seed).standard_normal(
        (batch, cfg.prefix_len, cfg.d_model)) * 0.02).astype(np.float32)


def as_jax(pe):
    return None if pe is None else jnp.asarray(pe)


def as_torch(pe):
    return None if pe is None else torch.from_numpy(pe)


@pytest.mark.parametrize("arch", ZOO)
def test_params_from_jax_carries_every_leaf(arch):
    params, _, model, pcfg = models(arch)
    n_ref = sum(np.asarray(a).size for a in jax.tree.leaves(params))
    assert n_ref == sum(p.numel() for p in model.parameters())
    moe = [m for m in model.modules() if isinstance(m, MoE)]
    assert len(moe) == (pcfg.n_layers if pcfg.moe else 0)
    if moe:
        wi = np.asarray(params["blocks"]["moe"]["wi"])
        assert wi.shape == (pcfg.n_layers, pcfg.moe.n_experts,
                            pcfg.d_model, pcfg.d_ff)
        np.testing.assert_array_equal(moe[-1].wi.numpy(), wi[-1])
        assert (moe[0].residual is not None) == pcfg.moe.dense_residual
    if pcfg.qkv_bias:
        b = np.asarray(params["blocks"]["attn"]["q"]["b"])
        np.testing.assert_array_equal(model.blocks[1].attn.q.b.numpy(), b[1])


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_matches_reference(arch):
    params, rcfg, model, pcfg = models(arch)
    toks = tokens(11, (2, 24), pcfg.vocab)
    pe = prefix(12, 2, pcfg)
    want_logits, want_caches = ref_prefill(
        params, rcfg, jnp.asarray(toks), MAX_SEQ, prefix_embeds=as_jax(pe),
        impl="xla")
    got_logits, got_caches = prefill(model, torch.from_numpy(toks), MAX_SEQ,
                                     prefix_embeds=as_torch(pe))
    assert got_logits.shape == (2, 1, pcfg.padded_vocab)
    np.testing.assert_allclose(np32(got_logits), np32(want_logits),
                               atol=LOGIT_TOL)
    assert_caches_equal(got_caches, want_caches, pcfg.n_layers, LOGIT_TOL)


@pytest.mark.parametrize("arch", ZOO)
def test_decode_matches_reference(arch):
    params, rcfg, model, pcfg = models(arch)
    S, steps = 20, 6
    toks = tokens(13, (2, S + steps), pcfg.vocab)
    pe = prefix(14, 2, pcfg)
    P = pcfg.prefix_len
    _, caches = ref_prefill(params, rcfg, jnp.asarray(toks[:, :S]), MAX_SEQ,
                            prefix_embeds=as_jax(pe), impl="xla")
    port_caches = ref_caches_as_port(caches, pcfg.n_layers)
    for i in range(S, S + steps):
        tok = toks[:, i:i + 1]
        got, port_caches = decode_step(model, torch.from_numpy(tok), P + i,
                                       port_caches)
        want, caches = ref_decode_step(params, rcfg, jnp.asarray(tok),
                                       jnp.int32(P + i), caches, impl="xla")
        np.testing.assert_allclose(np32(got), np32(want), atol=LOGIT_TOL,
                                   err_msg=f"position {P + i}")


@pytest.mark.parametrize("arch", ZOO)
def test_generate_matches_reference(arch):
    params, rcfg, model, pcfg = models(arch)
    prompts = tokens(15, (2, 10), pcfg.vocab)
    pe = prefix(16, 2, pcfg)
    want = ref_generate(params, rcfg, RefServeConfig(max_seq=MAX_SEQ),
                        jnp.asarray(prompts), 12, prefix_embeds=as_jax(pe))
    got = generate(model, ServeConfig(max_seq=MAX_SEQ), prompts, 12,
                   device="cpu", prefix_embeds=pe)
    assert got.dtype == torch.int32
    if pe is None:
        assert_same_tokens(got.numpy(), want, model, prompts, MAX_SEQ)
    else:   # a tie would need the prefix in the replay: none may occur
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", PREFIXED)
def test_prefix_shape_is_checked(arch):
    _, _, model, pcfg = models(arch)
    toks = torch.from_numpy(tokens(17, (2, 8), pcfg.vocab))
    short = torch.zeros(2, pcfg.prefix_len - 1, pcfg.d_model)
    with pytest.raises(ValueError, match="prefix_embeds"):
        prefill(model, toks, MAX_SEQ, prefix_embeds=short)


# ---------------------------------------------------------------------------
# The launcher refuses a configuration whose weights do not fit the card
# ---------------------------------------------------------------------------

def reference_param_bytes(arch):
    """Bytes of the reference's full-width parameter tree for `arch`, by
    `jax.eval_shape` of its `init_model` (nothing is allocated)."""
    from repro.configs import get as ref_get
    from repro.models import init_model as ref_init_model

    cfg = ref_get(arch)
    tree = jax.eval_shape(lambda key: ref_init_model(key, cfg).params,
                          jax.random.PRNGKey(0))
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize
               for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch", ["arctic-480b", "nemotron-4-340b",
                                  "qwen1.5-32b", "phi3.5-moe-42b-a6.6b",
                                  "internvl2-1b", "musicgen-large"])
def test_param_bytes_equal_the_references(arch):
    from repro_torch.configs import get
    from repro_torch.launch.serve import param_bytes
    assert param_bytes(get(arch)) == reference_param_bytes(arch)


def test_check_fits_arithmetic():
    from repro_torch.configs import get
    from repro_torch.launch.serve import check_fits, param_bytes
    card = 79_000_000_000   # about what an 80 GB card has free
    arctic = get("arctic-480b")
    need = param_bytes(arctic)
    assert need == 953_700_550_656    # 476.9 G bf16 parameters
    with pytest.raises(ValueError, match=f"{need:,} bytes.*{card:,} free"):
        check_fits(arctic, card)
    with pytest.raises(ValueError, match="nemotron-4-340b"):
        check_fits(get("nemotron-4-340b"), card)
    with pytest.raises(ValueError, match="phi3.5-moe"):
        check_fits(get("phi3.5-moe-42b-a6.6b"), card)
    # Qwen1.5-32B's weights (70.4 GB) fit such a card; 64 GB does not
    qwen = get("qwen1.5-32b")
    assert check_fits(qwen, card) == param_bytes(qwen)
    with pytest.raises(ValueError, match="qwen1.5-32b"):
        check_fits(qwen, 64_000_000_000)
    assert check_fits(get("internvl2-1b"), card) < 2_000_000_000
    assert check_fits(arctic, need) == need


def test_build_model_refuses_before_allocating(monkeypatch):
    """On the card, `build_model` checks the free memory before it
    allocates: a configuration that does not fit raises `ValueError`
    and `init_model` is never called."""
    from repro_torch.launch import serve as serve_mod
    monkeypatch.setattr(serve_mod, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (79_000_000_000, 81_000_000_000))

    def no_init(*a, **k):
        raise AssertionError("init_model was called")
    monkeypatch.setattr(serve_mod, "init_model", no_init)
    for arch in ("arctic-480b", "nemotron-4-340b"):
        with pytest.raises(ValueError, match="free"):
            serve_mod.build_model(arch)
