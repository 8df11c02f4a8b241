"""One run of one cell: set-up, the measured window, the comparison
with the reference, the metrics, and the result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's file names its configuration and traffic kind; the traffic
kind's driver (`portbench/traffic/<kind>.py`) makes the inputs from the
seed, warms up the shapes they use, makes one timed call at a time and
judges what the calls served.  The window runs whole calls, closed
loop, until `--seconds` have passed since the first call started.  With
`--trace 1` the window runs under `torch.profiler`, and the cell's
per-layer metrics are read from the trace; otherwise its end-to-end
metrics are printed.  The last line of standard output is the result
(one JSON object); the numbers compared with the reference, each beside
its limit, are the last lines of standard error and the result's last
key, `checks`.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

from portbench.harness import spec

# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What a driver, a judge and a metric reader see of one run."""
    cell: str
    wl: dict                  # the cell's file
    c: dict                   # the configuration's file
    seed: int
    seconds: float
    traced: bool
    device: object            # torch.device
    built: object = None      # harness.model.Built
    calls: list = dataclasses.field(default_factory=list)
    setup_s: float = 0.0
    trace: object = None      # harness.device.Trace of a traced window
    memory_peak_bytes: int = 0
    notes: list = dataclasses.field(default_factory=list)

    @property
    def params(self) -> dict:
        return self.wl["params"]

    @property
    def count(self):
        """The configuration family's FLOP and byte counts."""
        return spec.module("count", self.c["family"])


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def window(run: Run, drv, torch) -> None:
    """Whole calls, one at a time, until `run.seconds` have passed since
    the first one started; each call's timed part inside a
    `portbench.call` annotation, the whole inside `portbench.window`."""
    from portbench.harness.device import CALL, WINDOW

    rf = torch.profiler.record_function
    with rf(WINDOW):
        i, w0 = 0, None
        while True:
            inputs = drv.prepare(i)
            with rf(CALL):
                t0 = time.perf_counter()
                out = drv.timed(inputs)
                t1 = time.perf_counter()
            if w0 is None:
                w0 = t0
            run.calls.append(drv.record(i, inputs, out, t0, t1))
            del inputs, out  # free this call's state before the next
            i += 1
            if t1 - w0 >= run.seconds:
                break


def execute(cell: str, seed: int, seconds: float, traced: bool, *,
            device: str = "cuda", t_start: float | None = None,
            config: dict | None = None, params: dict | None = None,
            control: bool = False):
    """Run the cell; returns (result dict, lines for standard error).
    `config` replaces the configuration's file and `params` update the
    cell's parameters (the CPU tests' small sizes); `control` adds the
    lower-precision control's readings to the result."""
    import torch

    from portbench.harness import device as dv
    from portbench.harness import judge
    from portbench.harness.model import build

    t_start = time.perf_counter() if t_start is None else t_start
    bench = spec.benchmark()
    wl = spec.workload(cell)
    if params:
        wl["params"] = {**wl["params"], **params}
    c = config if config is not None else spec.config(wl["config"])
    dev = torch.device(device)
    run = Run(cell, wl, c, int(seed), float(seconds), traced, dev)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    traffic = spec.module("traffic", wl["traffic"])
    with torch.no_grad():
        t_built = time.perf_counter()
        run.built = build(c, run.seed, dev)
        drv = traffic.Driver(run)
        if cuda:
            torch.cuda.synchronize()
        t_warm = time.perf_counter()
        drv.warmup()
        if cuda:
            torch.cuda.synchronize()
        run.notes.append(
            f"setup: to the weights {t_built - t_start:.3f} s, weights "
            f"{t_warm - t_built:.3f} s, warm-up (kernels built on a "
            f"checkout's first run) {time.perf_counter() - t_warm:.3f} s")
        prof = None
        if traced:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        hooks = drv.hooks() if traced else contextlib.nullcontext()
        run.setup_s = time.perf_counter() - t_start
        with hooks:
            window(run, drv, torch)
        if cuda:
            torch.cuda.synchronize()
        if prof is not None:
            prof.stop()
            run.trace = dv.collect(torch, prof)
            del prof
        if cuda:
            run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
            torch.cuda.empty_cache()
        readings = drv.judge(control=control)
    checks = {k: {"value": readings[k], "limit": float(v)}
              for k, v in wl["limits"].items()}
    failed = 0   # a call that raises ends the run, with no result
    attempted = sum(r["batch"] for r in run.calls)
    metrics = {}
    for m in spec.cell_metrics(bench, cell, traced):
        value = spec.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else dev.type,
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": judge.verdict(checks, failed),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev_info}
    if run.trace is not None:
        dev_info["busy_s"] = dv.busy_s(run.trace)
        dev_info["window_s"] = dv.window_s(run.trace)
        ops = sorted(dv.time_by_name(run.trace).items(),
                     key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {
            "device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n[:120], s] for n, s in dv.idle_gaps(run.trace)]}
    if control:
        result["readings"] = readings
    result["checks"] = checks
    err = list(run.notes) + judge.report(checks)
    return result, err


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cli(argv, t_start: float) -> int:
    args = parse(argv)
    import torch

    wl = spec.workload(args.workload)
    chips = int(wl["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result, err = execute(args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    for line in err:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


def prepare_environment(root) -> None:
    """The port from the checkout's `src/`, and every cache a run makes
    inside the checkout at a fixed path."""
    sys.path.insert(0, str(root / "src"))
    os.environ.setdefault("CUDA_CACHE_PATH",
                          str(root / "build" / "portbench_cuda_cache"))
