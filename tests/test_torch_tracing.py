"""`repro_torch.tracing`: the serving path's spans and counters.

With no profiler nothing is kept and `generate` gives the same bits as
under one.  Under a CPU `torch.profiler` session: one `model.prefill`
and `n_new - 1` `model.decode_step` spans a `generate` among the
profile's host events, each block's `block.attention` and `block.mlp` /
`block.moe` inside its step, and the MoE's counters equal to what the
router's logits say (the benchmark's `distinct_experts` among them).
"""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import tracing
from repro_torch.config import ServeConfig
from repro_torch.configs import get_smoke
from repro_torch.models import init_model, prefill
from repro_torch.models.moe import MoE, top_k_lower_index
from repro_torch.serving import generate

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.traffic.generate import distinct_experts  # noqa: E402

ARCHS = {"dense": "stablelm-1.6b", "moe": "arctic-480b"}
B, S, N_NEW = 2, 12, 4


@pytest.fixture(autouse=True)
def clean():
    tracing.reset()
    yield
    tracing.reset()


def model_of(kind, **moe):
    cfg = get_smoke(ARCHS[kind])
    if moe:
        cfg = dataclasses.replace(cfg,
                                  moe=dataclasses.replace(cfg.moe, **moe))
    return init_model(cfg, torch.Generator().manual_seed(7), device="cpu")


def prompt(model, seed=3, shape=(B, S)):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, model.cfg.vocab, shape, generator=g,
                         dtype=torch.int32)


def run(model, tokens):
    sc = ServeConfig(max_seq=32, max_batch=B, temperature=0.0, eos_id=-1)
    return generate(model, sc, tokens, N_NEW, device="cpu")


def profiled(fn):
    """fn() under a CPU profiler: (its result, the profile's host events
    as (start ns, end ns, name), sorted)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    events = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events())
    return out, events


@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_off_keeps_nothing_and_changes_no_bit(kind):
    model = model_of(kind)
    tokens = prompt(model)
    plain = run(model, tokens)
    assert tracing.counters() == {}
    traced, events = profiled(lambda: run(model, tokens))
    assert torch.equal(plain, traced)
    assert any(n in tracing.STEPS for _, _, n in events)
    assert bool(tracing.counters()) == (kind == "moe")


SPANS = set(tracing.STEPS) | {"block.attention", "block.mlp", "block.moe"}


@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_steps_and_blocks_under_a_profiler(kind):
    model = model_of(kind)
    _, events = profiled(lambda: run(model, prompt(model)))
    spans = [e for e in events if e[2] in SPANS]
    steps = [e for e in spans if e[2] in tracing.STEPS]
    assert [n for _, _, n in steps] == (["model.prefill"]
                                        + ["model.decode_step"] * (N_NEW - 1))
    mix = "block.moe" if kind == "moe" else "block.mlp"
    L = model.cfg.n_layers
    for a, b, _ in steps:
        inside = [n for s, e, n in spans if a < s and e <= b]
        assert inside == ["block.attention", mix] * L
    blocks = [e for e in spans if e[2] not in tracing.STEPS]
    assert len(blocks) == 2 * L * len(steps)   # none outside a step
    assert {n for _, _, n in spans} == set(tracing.STEPS) | {
        "block.attention", mix}


def routers(model, out):
    """Forward hooks keeping each MoE layer's router logits in `out`."""
    return [blk.moe.router.register_forward_hook(
        lambda mod, args, y: out.append(y)) for blk in model.blocks]


def distinct(logits, k: int) -> int:
    """The distinct experts of router logits (T, E), by the port's rule:
    float32 softmax, top k."""
    probs = torch.softmax(logits.float(), -1)
    return top_k_lower_index(probs, k)[1].unique().numel()


def test_moe_counters_match_the_routers_logits():
    model = model_of("moe")
    E, k = model.cfg.moe.n_experts, model.cfg.moe.top_k
    L = model.cfg.n_layers
    logits = []
    handles = routers(model, logits)
    try:
        profiled(lambda: run(model, prompt(model)))
    finally:
        for h in handles:
            h.remove()
    assert len(logits) == L * N_NEW
    prefill, decode = logits[:L], logits[L:]
    assert prefill[0].shape[0] == B * S
    assert all(lg.shape[0] == B for lg in decode)
    counts = tracing.counters()
    assert set(counts) == set(tracing.STEPS)
    for step, lgs in (("model.prefill", prefill),
                      ("model.decode_step", decode)):
        got = counts[step]
        assert got["moe.experts_run"] == len(lgs) * E
        want = sum(distinct(lg, k) for lg in lgs)
        assert got["moe.experts_chosen"] == want
        assert want == sum(distinct_experts(torch.stack(lgs), k))
        assert set(got) == {"moe.experts_run", "moe.experts_chosen"}


def test_experts_chosen_in_a_capacity_prefill():
    """Slots past their expert's capacity are dropped; each chosen
    expert keeps its first slot, so every one of them counts."""
    model = model_of("moe", capacity_factor=0.5)
    tokens = prompt(model, shape=(B, 16))
    moe = model.blocks[0].moe
    assert isinstance(moe, MoE)
    T, k = B * 16, moe.cfg.moe.top_k
    inputs = []
    handle = moe.register_forward_pre_hook(
        lambda mod, args: inputs.append(args[0]))
    try:
        profiled(lambda: prefill(model, tokens, 32))
    finally:
        handle.remove()
    r, probs = moe.route(inputs[0].reshape(T, -1))
    assert r.capacity < T * k and int(r.keep.sum()) < T * k
    every_layer = tracing.counters()["model.prefill"]
    assert every_layer["moe.experts_run"] == model.cfg.n_layers * (
        moe.cfg.moe.n_experts)
    # layer 0 alone, counted again under a profiler outside any step
    tracing.reset()
    profiled(lambda: moe(inputs[0]))
    chosen = r.expert_idx.unique().numel()
    assert chosen == r.sorted_expert[r.keep].unique().numel()
    assert tracing.counters() == {None: {
        "moe.experts_run": moe.cfg.moe.n_experts,
        "moe.experts_chosen": chosen}}
    assert chosen == top_k_lower_index(probs, k)[1].unique().numel()


def test_reset_clears_spans_and_counts():
    """What `tracing` keeps is the counts (a span lives in the profile
    alone): `reset` clears them."""
    model = model_of("moe")
    profiled(lambda: run(model, prompt(model)))
    assert tracing.counters()
    tracing.reset()
    assert tracing.counters() == {}


def test_counters_keep_one_sum_a_step_and_name():
    """However long a profiler records, a counter is one running sum."""
    def body():
        with tracing.span("model.decode_step"):
            for i in range(100):
                tracing.count("n", torch.tensor(i))
                tracing.count("m", 2)

    profiled(body)
    assert len(tracing._counts) == 2
    assert tracing.counters() == {"model.decode_step": {
        "n": sum(range(100)), "m": 200}}


def test_without_a_profiler_spans_are_one_shared_no_op():
    assert tracing.span("a") is tracing.span("b")
    with tracing.span("a"):
        tracing.count("c", 1)
        tracing.count("c", torch.tensor(2))
    assert not tracing.enabled()
    assert tracing.counters() == {}


def test_counts_go_to_the_innermost_step():
    def body():
        with tracing.span("outer"):
            tracing.count("n", 1)
            with tracing.span("model.prefill"):
                with tracing.span("inner"):
                    tracing.count("n", torch.tensor(2))
                    tracing.count("n", 3)
            with tracing.span("model.decode_step"):
                tracing.count("m", torch.tensor(4))
            tracing.count("n", 5)

    _, events = profiled(body)
    names = [n for _, _, n in events]
    for n in ("outer", "model.prefill", "inner", "model.decode_step"):
        assert names.count(n) == 1
    assert tracing.counters() == {None: {"n": 6},
                                  "model.prefill": {"n": 5},
                                  "model.decode_step": {"m": 4}}
