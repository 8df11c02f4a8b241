"""Where the benchmark's files are, and how a cell finds them by name.

Every configuration, cell, traffic kind, metric and reference is a file
of its own, found by the name `BENCHMARK.json` or a cell's file gives:

    portbench/configs/<config>.json      sizes, reductions, dtype
    portbench/workloads/<cell>.json      config, traffic kind, parameters,
                                         the comparison's limits
    portbench/traffic/<kind>.py          the driver of a traffic kind
    portbench/metrics/<metric>.py        the reader of one metric
    portbench/reference/<family>.py      a plain float32 reference
    portbench/count/<family>.py          FLOP and byte counts

so a later change adds a file and an entry, and edits none.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not NAME.match(name) or ".." in name:
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def benchmark() -> dict:
    """The checkout's `BENCHMARK.json`."""
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(name: str) -> dict:
    return json.loads((BENCH / "workloads" / f"{_checked(name)}.json")
                      .read_text())


def config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{_checked(name)}.json")
                      .read_text())


def module(kind: str, name: str):
    """`portbench/<kind>/<name>.py` as a module (metric names hold dots,
    so the file is loaded by its path)."""
    path = BENCH / kind / f"{_checked(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.name}")
    key = f"portbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics the cell reports: its `per_layer` ones in a traced
    run, else its `end_to_end` ones; a metric without `workloads` counts
    for every cell."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell in m["workloads"]]


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one purpose (`tags`) of a run's `--seed`: the
    same seed and tags give the same number."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1
