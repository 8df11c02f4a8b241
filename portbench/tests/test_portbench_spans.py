"""The readers of the port's own spans and counters
(`repro_torch.tracing`): `decode_step_ms.decode`, `expert_use.decode`,
`attention_ms.prefill`, `mlp_ms.prefill` and `enqueue_ms.prefill`, on
synthetic traces and counters; on a checkout whose port keeps none;
traced at small sizes on the CPU; and both cells traced on the card."""
import bisect
import sys
from types import SimpleNamespace

import pytest
import torch

import repro_torch
from portbench.harness import main, spans, spec
from portbench.harness.device import Trace, union_ns
from portbench.harness.spans import by_call, device_ms, paired, step_counters
from portbench.tests import small
from repro_torch import tracing

NEW = ("decode_step_ms.decode", "expert_use.decode", "attention_ms.prefill",
       "mlp_ms.prefill", "enqueue_ms.prefill")
US = 1_000          # ns
S = 1_000_000_000   # ns


def read(name, run):
    return spec.module("metrics", name).read(run)


class Window:
    """A synthetic traced window: calls, spans and their launches, in ns
    on the profile's clock."""

    def __init__(self):
        self.host, self.dev, self.calls = [], [], []

    def span(self, name, t0, ops, end=None):
        """A span from `t0` launching `ops` [(launch, op start, op end)],
        each launch 1 µs long; the span ends 1 µs after its last launch
        (or at `end`)."""
        for launch, a, b in ops:
            self.host.append((launch, launch + US, "cudaLaunchKernel"))
            self.dev.append((a, b, "kernel"))
        t1 = end if end is not None else max(l for l, _, _ in ops) + 2 * US
        self.host.append((t0, t1, name))

    def run(self, traffic, extra, *, cycle=2, layers=2, device="cuda"):
        recs = [{"t0": a / S, "t1": b / S, "batch": 1, **x}
                for (a, b), x in zip(self.calls, extra)]
        trace = Trace(sorted(self.dev), sorted(self.host), (0, 100 * S),
                      sorted(self.calls))
        return SimpleNamespace(trace=trace, calls=recs,
                               wl={"traffic": traffic},
                               c={"num_hidden_layers": layers},
                               params={"cycle": cycle},
                               device=torch.device(device))


@pytest.fixture
def kept(monkeypatch):
    """Replace the port's counters: kept(counters)."""
    def put(counts):
        monkeypatch.setattr(tracing, "counters", lambda: dict(counts))
    return put


def decode_window(step_us=((10, 40), (20, 30))):
    """Two `generate` calls of two decode steps each; step j of call c
    launches two ops, at c s + 100 µs j, of `step_us[c]` µs each, the
    second 5 µs after the first ends."""
    w = Window()
    for c, (u0, u1) in enumerate(step_us):
        c0 = (c + 1) * S
        w.calls.append((c0, c0 + S // 2))
        for j, u in enumerate((u0, u1)):
            t = c0 + (j + 1) * 100 * US
            w.span("model.decode_step", t,
                   [(t + US, t + 3 * US, t + 3 * US + u * US),
                    (t + 2 * US, t + 8 * US + u * US, t + 8 * US + 2 * u * US)])
    return w


def test_decode_steps_by_call(kept):
    w = decode_window()
    w.span("model.decode_step", 3 * S, [(3 * S + US, 3 * S + 2 * US,
                                         3 * S + 900 * US)])   # between calls
    run = w.run("generate", [{"n_new": 3}] * 2)
    assert [len(c) for c in by_call(run, "model.decode_step")] == [2, 2]
    # each step: its two ops, the 5 µs between them left out
    assert device_ms(run, by_call(run, "model.decode_step")) == [
        [0.02, 0.08], [0.04, 0.06]]
    assert read("decode_step_ms.decode", run) == pytest.approx(0.05)
    kept({"model.decode_step": {"moe.experts_run": 32,
                                "moe.experts_chosen": 16},
          "model.prefill": {"moe.experts_run": 8, "moe.experts_chosen": 8}})
    assert step_counters("model.decode_step") == {
        "moe.experts_run": 32, "moe.experts_chosen": 16}
    assert read("expert_use.decode", run) == 50.0


def test_device_ms_pairs_launches_with_operations_by_kind_from_the_end():
    """The launches of one kind pair with the operations of that kind in
    order, the last with the last, whatever the times (an op launched
    before the call, for its inputs, is not the call's, though it starts
    inside it); overlapping ops count once."""
    w = Window()
    c0 = S
    w.calls.append((c0, c0 + S // 2))
    # launched as the profiler started; its op's record was lost
    w.host.append((c0 - 20 * US, c0 - 19 * US, "cudaLaunchKernel"))
    w.host.append((c0 - 10 * US, c0 - 9 * US, "cudaMemcpyAsync"))
    w.dev.append((c0 + 1 * US, c0 + 4 * US, "Memcpy HtoD"))
    t = c0 + 50 * US
    w.span("block.attention", t, [(t + US, t + 10 * US, t + 30 * US),
                                  (t + 2 * US, t + 20 * US, t + 40 * US)])
    # the device's clock behind the host's: an op reads as starting
    # before its launch; and a memset whose time reads among earlier ops
    w.span("block.mlp", t + 100 * US,
           [(t + 101 * US, t + 99 * US, t + 120 * US)])
    w.host.append((t + 102 * US, t + 103 * US, "cudaMemsetAsync"))
    w.dev.append((t + 15 * US, t + 16 * US, "Memset (Device)"))
    w.host.append((t + 200 * US, t + 201 * US, "cudaStreamSynchronize"))
    run = w.run("prefill", [{"ttft_s": 0.5}])
    held = [[(a, b) for a, b, n in sorted(w.host)
             if n.startswith("block.")]]
    pairs = paired(run.trace)
    assert pairs[0] == (c0 - 20 * US, None)
    assert [op[2] for _, op in pairs[1:]] == [
        "Memcpy HtoD", "kernel", "kernel", "kernel", "Memset (Device)"]
    assert device_ms(run, held) == [[0.03, 0.022]]
    run.device = torch.device("cpu")
    assert device_ms(run, held) is None


@pytest.mark.parametrize("fault", ["unlaunched", "lost"])
def test_device_ms_pairs_nothing_past_a_few_lost_records(fault):
    """An op no launch made, or more lost records than the profiler
    loses as it starts, pairs nothing."""
    w = decode_window()
    if fault == "unlaunched":
        w.dev.append((2 * S + 400 * US, 2 * S + 401 * US, "kernel"))
    else:
        w.host += [(i * US, i * US + 100, "cudaLaunchKernel")
                   for i in range(1, spans.LOST + 2)]
    run = w.run("generate", [{"n_new": 3}] * 2)
    assert paired(run.trace) is None
    w.host = w.host[:-1] if fault == "lost" else w.host
    w.dev = w.dev[:-1] if fault == "unlaunched" else w.dev
    assert paired(w.run("generate", [{"n_new": 3}] * 2).trace) is not None


@pytest.mark.parametrize("fault", ["count", "launch"])
def test_decode_step_ms_reads_nothing_it_cannot_match(kept, fault):
    w = decode_window()
    if fault == "count":   # the second call's second step unmarked
        w.host = [h for h in w.host if h[:1] != (2 * S + 200 * US,)
                  or h[2] != "model.decode_step"]
    else:   # an op no launch made
        w.dev.append((2 * S + 400 * US, 2 * S + 401 * US, "kernel"))
    run = w.run("generate", [{"n_new": 3}] * 2)
    kept({"model.decode_step": {"moe.experts_run": 32,
                                "moe.experts_chosen": 2}})
    assert read("decode_step_ms.decode", run) is None
    assert (read("expert_use.decode", run) is None) == (fault == "count")


def test_expert_use_without_moe_counters(kept):
    run = decode_window().run("generate", [{"n_new": 3}] * 2)
    kept({})
    assert read("expert_use.decode", run) is None
    kept({"model.prefill": {"moe.experts_run": 8}})
    assert read("expert_use.decode", run) is None


@pytest.mark.parametrize("name", ["attention_ms.prefill", "mlp_ms.prefill"])
def test_module_ms_over_whole_cycles(name):
    span = "block.attention" if name.startswith("attention") else "block.mlp"
    other = "block.mlp" if span == "block.attention" else "block.attention"
    w = Window()
    for c in range(5):   # the fifth call is past the whole cycles
        c0 = (c + 1) * S
        w.calls.append((c0, c0 + S // 2))
        for j in range(2):   # a layer: `span` then `other`
            t = c0 + (j + 1) * 1000 * US
            u = 100 if c == 4 else 2 * c + j + 1   # µs
            w.span(span, t, [(t + US, t + 5 * US, t + 5 * US + u * US)])
            w.span(other, t + 500 * US,
                   [(t + 501 * US, t + 505 * US, t + 900 * US)])
    run = w.run("prefill", [{"ttft_s": 0.5}] * 5)
    assert read(name, run) == pytest.approx(
        (1 + 2 + 3 + 4 + 5 + 6 + 7 + 8) / 4 / 1000)
    run.c["num_hidden_layers"] = 3   # a layer missing from every call
    assert read(name, run) is None
    run.c["num_hidden_layers"] = 2
    run.calls, run.trace.calls = run.calls[:1], run.trace.calls[:1]
    assert read(name, run) is None   # no whole cycle
    run.wl["traffic"] = "generate"
    assert read(name, run) is None


def test_enqueue_ms_reads_the_profiles_host_events():
    ms = 1_000_000
    w = Window()
    w.calls = [(1 * S, 2 * S), (3 * S, 4 * S), (5 * S, 6 * S)]
    w.host = [(1000 * ms + 5 * ms, 1000 * ms + 25 * ms, "model.prefill"),
              (3000 * ms + 5 * ms, 3000 * ms + 45 * ms, "model.prefill"),
              (5000 * ms + 5 * ms, 5000 * ms + 35 * ms, "model.prefill"),
              (5000 * ms + 6 * ms, 5000 * ms + 7 * ms, "aten::mm")]
    run = w.run("prefill", [{"ttft_s": 1.0}] * 3)
    assert read("enqueue_ms.prefill", run) == 30.0
    run.trace.host = w.host[:2] + w.host[3:]
    assert read("enqueue_ms.prefill", run) is None   # a call without one
    run.trace.host = w.host
    run.device = torch.device("cpu")   # no enqueue off the card
    assert read("enqueue_ms.prefill", run) is None


def test_a_port_without_tracing_reads_nothing(monkeypatch):
    """The parent's port has no `repro_torch.tracing`, and its profile
    no spans: every new reader returns None and none raises."""
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert step_counters("model.decode_step") is None
    bare = Window()
    bare.calls = [(1 * S, 2 * S), (3 * S, 4 * S)]
    bare.dev = [(1 * S + 5 * US, 1 * S + 9 * US, "kernel")]
    bare.host = [(1 * S + US, 1 * S + 2 * US, "cudaLaunchKernel")]
    runs = [bare.run("generate", [{"n_new": 3}] * 2),
            bare.run("prefill", [{"ttft_s": 1.0}] * 2)]
    for run in runs:
        for name in NEW:
            assert read(name, run) is None


def keep_run(monkeypatch) -> list:
    """`main.execute`'s Run, kept as the window closes."""
    runs = []
    window = main.window

    def keep(run, drv, torch):
        runs.append(run)
        return window(run, drv, torch)

    monkeypatch.setattr(main, "window", keep)
    return runs


def test_moe_counters_equal_the_drivers_router_hooks(monkeypatch):
    """Traced at small sizes on the CPU: the decode steps' distinct
    experts by the port's counter equal those the `generate` driver
    counts from its router hooks."""
    runs = keep_run(monkeypatch)
    tracing.reset()
    c, params = small.cell("arctic-decode")
    result, _ = main.execute("arctic-decode", 5, 0.5, True, device="cpu",
                             config=c, params=params)
    run, = runs
    steps = by_call(run, "model.decode_step")
    assert [len(s) for s in steps] == [r["n_new"] - 1 for r in run.calls]
    hooks = [u for r in run.calls for used in r["experts_used"] for u in used]
    E = c["num_local_experts"]
    assert len(hooks) == sum(map(len, steps)) * c["num_hidden_layers"] > 0
    assert step_counters("model.decode_step") == {
        "moe.experts_run": E * len(hooks),
        "moe.experts_chosen": sum(hooks)}
    assert result["metrics"]["expert_use.decode"]["value"] == (
        100.0 * sum(hooks) / (E * len(hooks)))
    assert "decode_step_ms.decode" not in result["metrics"]   # CPU
    tracing.reset()


def launched_ms(run, c0, c1) -> tuple:
    """(busy ms, first start to last end ms) of the device operations
    launched inside [c0, c1)."""
    pairs = paired(run.trace)
    starts = [a for a, _ in pairs]
    ops = sorted(op for _, op in pairs[bisect.bisect_left(starts, c0):
                                        bisect.bisect_left(starts, c1)]
                 if op is not None)
    return (union_ns(ops) / 1e6,
            (max(op[1] for op in ops) - ops[0][0]) / 1e6)


@pytest.mark.card
def test_both_cells_traced_on_the_card(card, monkeypatch):
    """Full size, a few seconds each: the five readers report positive
    numbers; the profile's launches pair with its operations; Σ experts
    chosen equals the hooks'; a call's prefill and decode steps cover
    97-100% of its device time; no span's name is among the device's
    operations."""
    runs = keep_run(monkeypatch)
    got = {}
    for cell, seconds in (("stablelm-prefill", 4.0), ("arctic-decode", 3.0)):
        tracing.reset()
        result, _ = main.execute(cell, 3700000001, seconds, True)
        assert result["correct"]
        got.update({k: v["value"] for k, v in result["metrics"].items()})
        print(cell, result["metrics"], result["breakdown"]["idle_gaps"])
        ops = " ".join(n for n, _ in result["breakdown"]["device_ops"])
        assert not any(s in ops for s in ("model.", "block."))
        run = runs[-1]
        assert paired(run.trace) is not None
        if cell != "arctic-decode":
            continue
        chosen = step_counters("model.decode_step")["moe.experts_chosen"]
        assert chosen == sum(sum(u) for r in run.calls
                             for u in r["experts_used"])
        prefill = device_ms(run, by_call(run, "model.prefill"))
        steps = device_ms(run, by_call(run, "model.decode_step"))
        for pre, call, (c0, c1) in zip(prefill, steps, run.trace.calls):
            busy, span = launched_ms(run, c0, c1)
            ms = sum(pre + call)
            print(f"steps cover {ms / busy!r} of the call's device busy "
                  f"time, {ms / span!r} of its device span")
            assert 0.97 <= ms / busy <= 1.0
    for name in NEW:
        assert got[name] > 0, name
    tracing.reset()
