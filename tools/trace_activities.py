#!/usr/bin/env python3
"""How `chip_smoke.py` records and reads its traced windows, and what
each way costs.

    python3 tools/trace_activities.py [--ticks 240] [--start 200]

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit.  It runs `chip_smoke.py`'s scale run (N = 100,000, W =
4096, B = 16, seed 0) for `--ticks` ticks twice on the card, tracing
the same window of 40 ticks from `--start` with `chip_smoke.TickTrace`:
first recording host and device activity (`cpu=True`, what
`chip_smoke.py` records), then device activity only (`cpu=False`).  The
runs make the same decisions, so the window holds the same device work
in both.  Each trace is read twice: by `key_averages` (how
`chip_smoke.py` read a trace up to PR 20) and by
`chip_smoke.device_activity` (the trace's events directly, how it reads
them since).  It prints the card's name and power limit, one JSON line
a mode (device ops, device-busy ms, wall ms and idle share a tick by
each reading, and the seconds that stopping the profiler and each
reading took), and a last line with the readings side by side.  It
exits non-zero when the two readings of one trace differ in device ops
a tick or by more than 0.1% in busy time a tick; whether the
device-only trace holds the same device ops as the full one is
printed, not gated.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def run_traced(torch, dev, ticks, start, cpu):
    import chip_smoke
    from repro_torch.core.policy import strategy
    from repro_torch.sim import (SimConfig, WorkloadConfig, default_physics,
                                 generate, run_sim)

    n, w, b = 100_000, 4096, 16
    cfg = SimConfig(n_ticks=ticks, k_slots=b, window=w)
    wl = WorkloadConfig(n_requests=n, mix="balanced", congestion="high",
                        arrival_scale=n / 160, class_map="paper2")
    batch, jitter = generate(wl, torch.Generator().manual_seed(0),
                             device=dev)
    trace = chip_smoke.TickTrace(torch, start, cpu=cpu)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_sim(strategy("final_adrr_olc"), batch, jitter, default_physics(),
            cfg, device=dev, on_tick=lambda t, s, win: trace.tick(t))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    fields = trace.fields(f"trace cpu={cpu}", secs, ticks)
    t_read = time.perf_counter()
    busy_us, n_ops = key_averages_reading(trace.prof)
    fields.update(
        key_averages_read_seconds=time.perf_counter() - t_read,
        key_averages_device_ops_per_tick=n_ops / trace.ticks,
        key_averages_device_busy_ms_per_tick=busy_us / 1e3 / trace.ticks)
    return fields, secs


def key_averages_reading(prof):
    """(busy µs, device ops) the way `chip_smoke.py` read a trace up to
    PR 20: device events of `key_averages`."""
    busy_us, n_ops = 0.0, 0
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0.0))
        if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            busy_us += us
            n_ops += e.count
    return busy_us, n_ops


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=240)
    ap.add_argument("--start", type=int, default=200)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("trace_activities: CUDA is not available")
    from repro_torch.kernels import _build

    _build.build_all()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rows = {}
    for cpu in (True, False):
        fields, secs = run_traced(torch, dev, args.ticks, args.start, cpu)
        fields.pop("traced_top_device_us_per_tick")
        rows[fields["traced_activities"]] = fields
        print(json.dumps(dict(run_seconds=secs, **fields)), flush=True)
    readings, bad = {}, []
    for mode, f in rows.items():
        a = (f["traced_device_ops_per_tick"],
             f["traced_device_busy_ms_per_tick"])
        b = (f["key_averages_device_ops_per_tick"],
             f["key_averages_device_busy_ms_per_tick"])
        readings[f"{mode} device_activity"] = a
        readings[f"{mode} key_averages"] = b
        if a[0] != b[0] or abs(a[1] / b[1] - 1.0) > 1e-3:
            bad.append(mode)
    full, dev_only = rows["cpu+cuda"], rows["cuda"]
    print(json.dumps(dict(
        readings=readings, readers_agree=not bad,
        device_only_ops_equal=(full["traced_device_ops_per_tick"]
                               == dev_only["traced_device_ops_per_tick"]))),
        flush=True)
    if bad:
        raise SystemExit(f"trace_activities: the two readings of the "
                         f"{bad} trace differ")


if __name__ == "__main__":
    main()
