#!/usr/bin/env python3
"""Chip check of the PyTorch port (`src/repro_torch/`) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit.  It builds the hand kernels from the checkout's sources,
holds each against its plain PyTorch version on the card, drives the
port's main path — the windowed scheduler simulator, whose ordering
layer ranks every class through `sched_score_topb` — and checks what
comes out.  Each phase prints one JSON line; any failure raises and the
script exits non-zero.  The last lines are the card (as nvidia-smi
reports it), one JSON line of kernel measurements, and the result line

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Phases:
  1. device: the card's name and power limit;
  2. build: nvcc of every kernel source;
  3. kernels: each kernel against its plain version on the card, exact
     equality of indices and score bits, over the main path's shapes
     and edge cases; times (CUDA events, median of 60 calls after
     warm-up) of the kernel, its plain version and the nearest single
     PyTorch call;
  4. paper cell: `run_cell` on the card and on the CPU with the same
     inputs — equal decision traces, equal terminal statuses, metrics
     within the tests' tolerance;
  5. scale: the windowed run at N = 100,000, W = 4096, B = 16 on the
     card — `sched_score_topb` launched (K+1) times a tick, every request
     accounted for on every tick and after the drain, `sched_compact_topb`
     held against its plain version on the run's own slot pool at
     mid-run, and a window of ticks traced with `torch.profiler` for the
     device's busy time and idle share.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12   # H100 SXM float32, outside the tensor cores
REPS = 60


def emit(**kw):
    print(json.dumps(kw), flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def main() -> None:
    check((ROOT / "src" / "repro_torch").is_dir(),
          "src/repro_torch not found: run from the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    check(torch.cuda.is_available(), "CUDA is not available")
    dev = torch.device("cuda")

    # --- 1. device -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit(phase="device", kind=kind, nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # --- 2. build --------------------------------------------------------
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = {name: _build.build(name) for name in _build.SOURCES}
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries=[str(p.relative_to(ROOT)) for p in libs.values()])

    kernels = phase_kernels(torch, dev)
    cell_launches = phase_paper_cell(torch, dev)
    scale = phase_scale(torch, dev, kernels)

    print(smi, flush=True)
    emit(kernels=[kernels[k] for k in
                  ("sched_score_topb", "sched_score_argmax",
                   "sched_compact_topb")])
    check(cell_launches > 0 and scale > 0, "main path launched no kernel")
    emit(ok=True, device={"platform": "gpu", "kind": kind,
                          "count": torch.cuda.device_count()})


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def device_ms(torch, fn, reps=REPS):
    """Median device time of one call: each call sits between two CUDA
    events, queued behind a spin kernel so the events bracket device
    work, not the host's enqueue."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, dev):
    from repro_torch.kernels.sched_score import ops, ref

    gen = torch.Generator().manual_seed(1234)

    def feats(n, density, route=False, ties=False):
        if ties:
            one = torch.ones(n)
            x = [one * 7, one * 3, one]
        else:
            x = [torch.rand(n, generator=gen) * 5e3,
                 torch.rand(n, generator=gen) * 3000 + 0.5,
                 torch.rand(n, generator=gen) * 2]
        mask = torch.rand(n, generator=gen) < density
        w = torch.tensor([1.0, 0.8, 0.5, 650.0] + ([400.0] if route else []))
        r = torch.rand(n, generator=gen) * 3 if route else None
        return [t.to(dev) if t is not None else None
                for t in (*x, mask, w, r)]

    def same(a, b):
        if a.dtype == torch.float32:
            return torch.equal(a.view(torch.int32), b.view(torch.int32))
        return torch.equal(a, b)

    err = {"sched_score_topb": 0.0, "sched_score_argmax": 0.0,
           "sched_compact_topb": 0.0}

    def note_err(name, got_score, want_score):
        err[name] = max(err[name],
                        float((got_score - want_score).abs().max()))
    cases = 0
    # n = 256 and 2048 take the single-block path (one block ranks all
    # n lanes and writes idx and score itself); 256 with b = 4 is the
    # paper cell's shape, 4096 and 100,000 the scale run's and the dense
    # path's
    for n in (256, 2048, 4096, 100_000):
        for b in (1, 4, 16, 128):
            for density in (0.1, 0.9):
                for route in (False, True):
                    wait, cost, urg, mask, w, r = feats(n, density, route)
                    got = ops.sched_score_topb(wait, cost, urg, mask, w, b, r)
                    want = ref.sched_score_topb_ref(wait, cost, urg, mask, w,
                                                    b, r)
                    check(all(map(same, got, want)),
                          f"sched_score_topb n={n} b={b} density={density} "
                          f"route={route}")
                    note_err("sched_score_topb", got[1], want[1])
                    cases += 1
        for kw in (dict(density=1.0, ties=True), dict(density=0.0005)):
            wait, cost, urg, mask, w, r = feats(n, **kw)   # ties; b > eligible
            got = ops.sched_score_topb(wait, cost, urg, mask, w, 64)
            want = ref.sched_score_topb_ref(wait, cost, urg, mask, w, 64)
            check(all(map(same, got, want)), f"sched_score_topb n={n} {kw}")
            cases += 1
        for route in (False, True):
            wait, cost, urg, mask, w, r = feats(n, 0.5, route)
            got = ops.sched_score_argmax(wait, cost, urg, mask, w, r)
            want = ref.sched_score_argmax_ref(wait, cost, urg, mask, w, r)
            check(all(map(same, got, want)), f"sched_score_argmax n={n}")
            note_err("sched_score_argmax", got[1], want[1])
            cases += 1
    for density in (0.0, 0.05, 0.6, 1.0):
        for b in (1, 16, 128):
            wait, cost, urg, alive, w, _ = feats(4096, density)
            req = torch.randperm(3 * 4096, generator=gen)[:4096].to(
                torch.int32).to(dev)
            got = ops.sched_compact_topb(req, alive, wait, cost, urg, w, b)
            want = ref.sched_compact_topb_ref(req, alive, wait, cost, urg, w,
                                              b)
            check(all(map(same, got, want)),
                  f"sched_compact_topb W=4096 b={b} density={density}")
            note_err("sched_compact_topb", got[3], want[3])
            cases += 1
    torch.cuda.synchronize()
    emit(phase="kernels_vs_plain", cases=cases, exact=True)

    # times at the main path's shapes: the windowed tick ranks a (4096,)
    # pool with b = 16 (K+1 times a tick); n = 100,000 is the dense path
    out = {}
    rows = []
    for n in (4096, 100_000):
        wait, cost, urg, mask, w, _ = feats(n, 0.5)
        scores = ref.scores_ref(wait, cost, urg, mask, w)
        in_bytes = n * (3 * 4 + 1) + w.numel() * 4
        t_b, by = bound(in_bytes + 16 * 8, n * 9)
        row = dict(
            name="sched_score_topb", n=n, b=16,
            ms=device_ms(torch, lambda: ops.sched_score_topb(
                wait, cost, urg, mask, w, 16)),
            plain_ms=device_ms(torch, lambda: ref.sched_score_topb_ref(
                wait, cost, urg, mask, w, 16)),
            library_ms=device_ms(torch, lambda: torch.topk(scores, 16)),
            bound_ms=t_b, bound_by=by)
        rows.append(row)
        t_b, by = bound(in_bytes + 8, n * 9)
        rows.append(dict(
            name="sched_score_argmax", n=n, b=1,
            ms=device_ms(torch, lambda: ops.sched_score_argmax(
                wait, cost, urg, mask, w)),
            plain_ms=device_ms(torch, lambda: ref.sched_score_argmax_ref(
                wait, cost, urg, mask, w)),
            library_ms=device_ms(torch, lambda: torch.argmax(scores)),
            bound_ms=t_b, bound_by=by))
    wait, cost, urg, alive, w, _ = feats(4096, 0.6)
    req = torch.arange(4096, dtype=torch.int32, device=dev)
    t_b, by = bound(4096 * (4 + 1 + 3 * 4) + 16 + 4096 * 4 + 4 + 16 * 8,
                    4096 * 9)
    rows.append(dict(
        name="sched_compact_topb", n=4096, b=16,
        ms=device_ms(torch, lambda: ops.sched_compact_topb(
            req, alive, wait, cost, urg, w, 16)),
        plain_ms=device_ms(torch, lambda: ref.sched_compact_topb_ref(
            req, alive, wait, cost, urg, w, 16)),
        library_ms=None, bound_ms=t_b, bound_by=by))
    for row in rows:
        emit(phase="kernel_time", **row)
    src = "src/repro_torch/kernels/sched_score/sched_score.cu"
    ref_py = "src/repro/kernels/sched_score/sched_score.py"
    replaces = {"sched_score_topb": f"{ref_py}:382",
                "sched_score_argmax": f"{ref_py}:116",
                "sched_compact_topb": f"{ref_py}:318"}
    for row in rows:
        if row["n"] != 4096:
            continue  # the line carries the windowed main path's shape
        name = row["name"]
        out[name] = dict(
            name=name, route="cuda", source=src, replaces=replaces[name],
            launches=0, max_abs_err=err[name], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"])
    return out


# ---------------------------------------------------------------------------
# 4. the paper cell, card against CPU
# ---------------------------------------------------------------------------

def phase_paper_cell(torch, dev):
    import numpy as np

    from repro_torch.core.policy import strategy
    from repro_torch.kernels.sched_score import ops
    from repro_torch.sim import SimConfig, WorkloadConfig, run_cell

    wl = WorkloadConfig(n_requests=160, mix="balanced", congestion="high")
    cfg = SimConfig(n_ticks=14000, k_slots=4, window=256)
    res = {}
    for d in ("cuda", "cpu"):
        ops.reset_launches()
        t0 = time.perf_counter()
        metrics, runs = run_cell(strategy("final_adrr_olc"), wl, seeds=1,
                                 sim_cfg=cfg, device=d,
                                 collect_decisions=True)
        if d == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = ops.LAUNCHES["sched_score_topb"]
        final, trace = runs[0]
        res[d] = (metrics, final.req.status.cpu(),
                  [x.cpu() for x in trace], secs, launches)
    (mg, sg, tg, secs_g, launches), (mc, sc, tc, secs_c, _) = (
        res["cuda"], res["cpu"])
    k = 2
    check(launches == (k + 1) * cfg.n_ticks,
          f"paper cell: {launches} sched_score_topb launches, want "
          f"{(k + 1) * cfg.n_ticks}")
    check(torch.equal(tg[0], tc[0]) and torch.equal(tg[1], tc[1]),
          "paper cell: decision traces differ between card and CPU")
    check(torch.equal(tg[2].view(torch.int32), tc[2].view(torch.int32)),
          "paper cell: severity traces differ between card and CPU")
    check(torch.equal(sg, sc), "paper cell: terminal statuses differ")
    for f in mg._fields:
        a = getattr(mg, f).cpu().double().numpy()
        b = getattr(mc, f).double().numpy()
        check(np.allclose(a, b, rtol=1e-5, atol=1e-6, equal_nan=True),
              f"paper cell: metric {f} {a} vs {b}")
    emit(phase="paper_cell", n_requests=160, n_ticks=cfg.n_ticks, window=256,
         k_slots=4, decisions_equal=True, statuses_equal=True,
         sched_score_topb_launches=launches,
         short_p95_ms=float(mg.short_p95_ms[0]),
         completion_rate=float(mg.completion_rate[0]),
         satisfaction=float(mg.satisfaction[0]),
         goodput_rps=float(mg.goodput_rps[0]),
         card_seconds=secs_g, cpu_seconds=secs_c,
         card_ticks_per_s=cfg.n_ticks / secs_g)
    return launches


# ---------------------------------------------------------------------------
# 5. the scale run on the card
# ---------------------------------------------------------------------------

TRACE_FROM, TRACE_TICKS = 200, 40   # the scale run's traced window


def phase_scale(torch, dev, kernels):
    from repro_torch.core.ordering import _wait_and_urgency
    from repro_torch.core.overload import ADMIT
    from repro_torch.core.policy import strategy
    from repro_torch.core.types import COMPLETED, INFLIGHT, PENDING
    from repro_torch.device import to_device
    from repro_torch.kernels.sched_score import ops, ref
    from repro_torch.sim import (SimConfig, WorkloadConfig, default_physics,
                                 generate, run_sim)
    from repro_torch.sim.engine import _retire_window, _window_view

    n, w, b, k = 100_000, 4096, 16, 2
    cfg = SimConfig(n_ticks=2000, k_slots=b, window=w)
    wl = WorkloadConfig(n_requests=n, mix="balanced", congestion="high",
                        arrival_scale=n / 160, class_map="paper2")
    batch, jitter = generate(wl, torch.Generator().manual_seed(0),
                             device=dev)
    policy = strategy("final_adrr_olc")
    occupancy = torch.zeros(cfg.n_ticks, dtype=torch.int32, device=dev)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    slots = torch.arange(w, dtype=torch.int32, device=dev)
    broken = torch.zeros((), dtype=torch.bool, device=dev)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    clock, snap = {}, {}

    def on_tick(t, state, win):
        occupancy[t] = win.n_live
        # on the device, no host sync: the live prefix holds admitted ids,
        # strictly increasing (none twice), the tail the sentinel n; every
        # admitted request outside the window is terminal (none lost); and
        # no request past the admission pointer has been touched
        req, status = win.slot_req, state.req.status
        live = slots < win.n_live
        in_order = (req[1:] > req[:-1]) | ~live[1:]
        in_range = torch.where(live, (req >= 0) & (req < win.arr_ptr),
                               req == n)
        in_win = torch.zeros(n + 1, dtype=torch.bool, device=dev).index_fill_(
            0, req.long(), True)[:n]
        admitted = ids < win.arr_ptr
        open_ = (status == PENDING) | (status == INFLIGHT)
        lost = admitted & ~in_win & open_
        early = ~admitted & ((status != PENDING)
                             | torch.isfinite(state.req.submit_ms))
        broken.logical_or_(~(in_order.all() & in_range.all())
                           | lost.any() | early.any())
        if t == cfg.n_ticks // 2:
            snap["state"], snap["win"] = state, win
        if t == TRACE_FROM - 1:
            torch.cuda.synchronize()
            clock["enter"] = time.perf_counter()
            prof.start()
            clock["t0"] = time.perf_counter()
        elif t == TRACE_FROM + TRACE_TICKS - 1:
            torch.cuda.synchronize()
            clock["t1"] = time.perf_counter()
            prof.stop()
            clock["exit"] = time.perf_counter()

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, (actions, _, _) = run_sim(
        policy, batch, jitter, default_physics(), cfg, device=dev,
        on_tick=on_tick, collect_decisions=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    check(launches["sched_score_topb"] == (k + 1) * cfg.n_ticks,
          f"scale: {launches['sched_score_topb']} sched_score_topb "
          f"launches, want {(k + 1) * cfg.n_ticks}")
    for name, count in launches.items():
        kernels[name]["launches"] = count

    check(not bool(broken), "scale: on some tick the window held a request "
          "twice, out of order or not yet admitted, lost an open request, "
          "or a request past the admission pointer was touched")
    status = final.req.status
    counts = torch.bincount(status.long(), minlength=5).tolist()
    check(counts[PENDING] == 0 and counts[INFLIGHT] == 0,
          f"scale: requests left live after the drain: {counts}")
    check(int(final.provider.inflight) == 0,
          "scale: the provider holds requests after the drain")
    n_admits = int((actions == ADMIT).sum())
    n_submitted = int(torch.isfinite(final.req.submit_ms).sum())
    check(n_admits == n_submitted,
          f"scale: {n_admits} ADMIT decisions but {n_submitted} requests "
          "handed to the provider")
    check(int(final.sched.n_completed_obs) == counts[COMPLETED],
          "scale: completions observed != requests completed")

    # the slot pool the next tick would compact, held against the plain
    # version: slot ids, survivors of the retire pass, score features
    win = snap["win"]
    policy_d, phys_d = to_device((policy, default_physics()), dev)
    now = torch.tensor((cfg.n_ticks // 2 + 2) * cfg.dt_ms,
                       dtype=torch.float32, device=dev)
    state = snap["state"]._replace(now_ms=now)
    _, alive = _retire_window(policy_d, phys_d, batch, state, win)
    view, _, _ = _window_view(batch, state.req, win.slot_req)
    wait, urg = _wait_and_urgency(view, now)
    wts = torch.stack([policy_d.ord_w_wait, policy_d.ord_w_size,
                       policy_d.ord_w_urg, policy_d.ord_ref_tokens])
    args = (win.slot_req, alive, wait, view.p50, urg, wts, b)
    got = ops.sched_compact_topb(*args)
    want = ref.sched_compact_topb_ref(*args)
    check(all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32
                          else x, y.view(torch.int32)
                          if y.dtype == torch.float32 else y)
              for x, y in zip(got, want)),
          "scale: sched_compact_topb differs from its plain version on the "
          "run's slot pool")

    # the traced window: device-side events only (kernels, memcpy,
    # memset); the CPU ops that launched them carry the same time again
    busy_us, n_device_ops, per_name = 0.0, 0, {}
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0.0))
        if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            busy_us += us
            n_device_ops += e.count
            per_name[e.key] = per_name.get(e.key, 0.0) + us
    check(n_device_ops > 0, "scale: the trace shows no device work")
    wall_ms = (clock["t1"] - clock["t0"]) * 1e3 / TRACE_TICKS
    untraced_s = secs - (clock["exit"] - clock["enter"])
    busy_ms = busy_us / 1e3 / TRACE_TICKS
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
    occ = occupancy.float()
    emit(phase="scale", n_requests=n, window=w, k_slots=b, classes=k,
         n_ticks=cfg.n_ticks, seconds=secs,
         ticks_per_s_untraced=(cfg.n_ticks - TRACE_TICKS) / untraced_s,
         occupancy_mean=float(occ.mean()), occupancy_max=int(occ.max()),
         status_counts=counts, admits=n_admits,
         sched_score_topb_launches=launches["sched_score_topb"],
         compact_snapshot_live=int(alive.sum()), compact_snapshot_exact=True,
         traced_ticks=TRACE_TICKS, traced_from=TRACE_FROM,
         traced_wall_ms_per_tick=wall_ms,
         traced_device_busy_ms_per_tick=busy_ms,
         traced_device_idle_share=1.0 - busy_ms / wall_ms,
         traced_device_ops_per_tick=n_device_ops / TRACE_TICKS,
         traced_top_device_us_per_tick=[
             [name[:60], us / TRACE_TICKS] for name, us in top])
    return launches["sched_score_topb"]


if __name__ == "__main__":
    main()
