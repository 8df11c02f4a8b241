"""Each plain reference against the port on the CPU at small sizes, in
float32 on the same drawn weights: the port's prefill logits and K/V
cache, and (Arctic) decode steps through the cache, equal to the
reference's full forward pass to float32 rounding.  The test imports
the port; the references do not."""
import pytest
import torch

from portbench.harness import judge
from portbench.harness.model import build
from portbench.reference import arctic, stablelm
from portbench.tests import small

TOL = 2e-4   # float32 rounding over two layers, relative to the largest


def tokens(B, S, V, seed=5):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, V, (B, S), generator=g)


@pytest.mark.parametrize("S", [37, 64])
def test_stablelm_prefill_matches_port(S):
    from repro_torch.models.model import prefill

    c = small.config("stablelm-1.6b", dtype="float32")
    b = build(c, 11, torch.device("cpu"))
    x = tokens(2, S, c["vocab_size"])
    logits, caches = prefill(b.model, x, 96, impl="plain")
    pos = torch.arange(S)
    want, kv = stablelm.forward(b.weights, c, x, logits_at=[S - 1],
                                kv_at=((0, 1), pos))
    assert judge.rel_err(logits, want) < TOL
    for l in (0, 1):
        assert judge.rel_err(caches[l].kv.k[:, :S], kv[l][0]) < TOL
        assert judge.rel_err(caches[l].kv.v[:, :S], kv[l][1]) < TOL


def test_arctic_prefill_and_decode_match_port():
    """A prompt under the capacity rule (B 2 x 24 tokens, k 2 over 8
    experts keeps 15 choices an expert), then 5 dropless decode steps
    fed the greedy tokens back."""
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.models.moe import capacity

    c = small.config("arctic-480b-l2", dtype="float32")
    b = build(c, 12, torch.device("cpu"))
    B, S, n = 2, 24, 5
    assert capacity(b.cfg, B * S) < B * S * 2
    x = tokens(B, S, c["vocab_size"])
    logits, caches = prefill(b.model, x, 64, impl="plain")
    got, seq = [logits[:, -1]], x
    for i in range(n):
        tok = got[-1].argmax(-1, keepdim=True)
        seq = torch.cat([seq, tok], 1)
        logits, caches = decode_step(b.model, tok, S + i, caches,
                                     impl="plain")
        got.append(logits[:, -1])
    want, _ = arctic.forward(b.weights, c, seq,
                             logits_at=list(range(S - 1, S + n)),
                             prompt_len=S)
    assert judge.rel_err(torch.stack(got, 1), want) < TOL


def test_arctic_capacity_drops_change_the_output():
    """The reference's capacity rule matters at this size: without it
    (every choice kept) the prompt's last logits differ."""
    c = small.config("arctic-480b-l2", dtype="float32")
    b = build(c, 12, torch.device("cpu"))
    x = tokens(2, 24, c["vocab_size"])
    capped, _ = arctic.forward(b.weights, c, x, logits_at=[23],
                               prompt_len=24)
    free, _ = arctic.forward(b.weights, c, x, logits_at=[23], prompt_len=0)
    assert judge.rel_err(free, capped) > 1e-3

