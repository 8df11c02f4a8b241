"""The result line, the refusal without a card, and the discovery of a
cell's files by name."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import main, spec
from portbench.tests import small

ROOT = Path(__file__).resolve().parents[2]
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", ["stablelm-prefill", "arctic-decode"])
def test_last_line_keys(cell, traced):
    c, params = small.cell(cell)
    result, err = main.execute(cell, 3, 0.5, traced, device="cpu",
                               config=c, params=params)
    assert set(result) == KEYS | ({"breakdown"} if traced else set())
    assert list(result)[-1] == "checks"
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    if traced:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    bench = spec.benchmark()
    names = {m["name"] for m in spec.cell_metrics(bench, cell, traced)}
    assert set(result["metrics"]) <= names
    if not traced:   # the end-to-end metrics need no trace
        assert set(result["metrics"]) == names
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    for k, v in result["checks"].items():
        assert set(v) == {"value", "limit"}
        assert any(line.startswith(f"check {k}:") for line in err[-2:])
    json.dumps(result)


def test_no_card_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "stablelm-prefill", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.card
def test_checkout_without_the_port_exits_nonzero(card, tmp_path):
    """Only BENCHMARK.json and portbench/: the run fails, no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "stablelm-prefill",
         "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_new_files_are_found_without_edits(tmp_path, monkeypatch):
    """A new configuration, cell and per-layer metric, each a file of its
    own beside copies of the others, are found by name: the run reports
    the new metric in the new cell, and no other file was edited."""
    bench = tmp_path / "portbench"
    for sub in ("configs", "workloads", "traffic", "metrics", "reference",
                "count"):
        shutil.copytree(ROOT / "portbench" / sub, bench / sub)
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    c = small.config("stablelm-1.6b", name="stablelm-twin")
    (bench / "configs" / "stablelm-twin.json").write_text(json.dumps(c))
    wl = spec.workload("stablelm-prefill")
    wl.update(name="twin-prefill", config="stablelm-twin",
              params=small.PARAMS["prefill"])
    (bench / "workloads" / "twin-prefill.json").write_text(json.dumps(wl))
    (bench / "metrics" / "calls.twin.py").write_text(
        "def read(run):\n    return float(len(run.calls))\n")
    doc = spec.benchmark()
    doc["per_layer"].append({"name": "calls.twin", "unit": "calls",
                             "better": "higher", "source": "host_clock",
                             "layer": "harness", "moves": "ttft_p95_ms",
                             "workloads": ["twin-prefill"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    monkeypatch.setattr(spec, "BENCH", bench)
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    result, _ = main.execute("twin-prefill", 4, 0.5, True, device="cpu")
    assert result["metrics"]["calls.twin"]["value"] >= 1
    assert {p: p.read_bytes() for p in before} == before


def test_call_spans_read_the_device():
    """A call's span runs from its first device operation to the end of
    its last (launched inside the call), or from the first that `opens`
    names; the host's time around them is left out."""
    from portbench.harness.device import Trace, call_spans

    ns = 1_000_000
    dev = [(11 * ns, 13 * ns, "gemm"), (14 * ns, 16 * ns, "decode_partial"),
           (16 * ns, 19 * ns, "gemm"), (31 * ns, 32 * ns, "gemm")]
    trace = Trace(dev, [], (0, 40 * ns), [(10 * ns, 20 * ns),
                                          (30 * ns, 35 * ns)])
    assert call_spans(trace) == [0.008, 0.001]
    assert call_spans(trace, "decode_partial") == [0.005]
