"""A run with the timed path broken underneath must come out not
correct: each cell, driven as the benchmark drives it (the look for a
card skipped, the CPU at small sizes, the cell's own limits), once
sound and once with each fault the cell can have planted in the port:

* `state`: a step that leaves its state unchanged (prefill: the K/V
  cache not written; decode: the steps' K/V never stored);
* `half_batch`: half of the batch left out, the other half's answers
  served in its place;
* `token`: the served token altered where it is produced (the logits
  turned over, so the worst token is the greedy one).

The exchange between chips is no fault of a one-chip cell."""
import pytest
import torch

from portbench.harness import main
from portbench.tests import small

CELLS = ("stablelm-prefill", "arctic-decode")
FAULTS = ("state", "half_batch", "token")


def plant(monkeypatch, cell: str, fault: str) -> None:
    from repro_torch.models.attention import KVCache
    from repro_torch.models.blocks import LayerCache
    from repro_torch.serving import engine

    if cell == "stablelm-prefill":
        real = engine.prefill_step

        def broken(model, tokens, max_seq, **kw):
            if fault == "half_batch":
                h = tokens.shape[0] // 2
                logits, caches = real(model, tokens[:h], max_seq, **kw)
                twice = lambda t: torch.cat([t, t])  # noqa: E731
                return twice(logits), [LayerCache(KVCache(
                    twice(c.kv.k), twice(c.kv.v)), None) for c in caches]
            logits, caches = real(model, tokens, max_seq, **kw)
            if fault == "state":
                caches = [LayerCache(KVCache(torch.zeros_like(c.kv.k),
                                             torch.zeros_like(c.kv.v)),
                                     None) for c in caches]
            elif fault == "token":
                logits = -logits
            return logits, caches

        monkeypatch.setattr(engine, "prefill_step", broken)
        return
    if fault == "state":
        real_step = engine.decode_step

        def unchanged(model, token, pos, caches, impl="kernel"):
            copies = [LayerCache(KVCache(c.kv.k.clone(), c.kv.v.clone()),
                                 None) for c in caches]
            logits, _ = real_step(model, token, pos, copies, impl)
            return logits, caches

        monkeypatch.setattr(engine, "decode_step", unchanged)
    elif fault == "half_batch":
        real_gen = engine.generate

        def half(model, sc, prompt, n_new, **kw):
            h = prompt.shape[0] // 2
            out = real_gen(model, sc, prompt[:h], n_new, **kw)
            return torch.cat([out, out])

        monkeypatch.setattr(engine, "generate", half)
    elif fault == "token":
        real_sample = engine._sample
        monkeypatch.setattr(engine, "_sample",
                            lambda logits, t, g: real_sample(-logits, t, g))


def run_small(cell: str, seed: int = 2**31 + 7, traced: bool = False):
    c, params = small.cell(cell)
    return main.execute(cell, seed, 1.0, traced, device="cpu", config=c,
                        params=params)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, err = run_small(cell)
    assert result["correct"], err


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(monkeypatch, cell, fault):
    plant(monkeypatch, cell, fault)
    result, err = run_small(cell)
    assert not result["correct"], err
