"""`BENCHMARK.json` against the benchmark's own files: every entry has
the keys and names the format allows, every cell's file agrees with its
entry, and every configuration, traffic kind, metric and reference it
names is a file of its own."""
import json
import re
from pathlib import Path

import pytest

from portbench.harness import spec

ROOT = Path(__file__).resolve().parents[2]
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = DOC["end_to_end"] + DOC["per_layer"]


def test_top_level_keys():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert DOC["paths"] == ["portbench"]
    assert 1 <= DOC["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in DOC["command"])


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in DOC[group]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in METRICS)
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())


@pytest.mark.parametrize("cell", DOC["workloads"], ids=lambda w: w["name"])
def test_cell_file_agrees(cell):
    wl = spec.workload(cell["name"])
    for k in ("config", "traffic", "chips", "why"):
        assert wl[k] == cell[k]
    assert len(cell["why"]) <= 200
    c = spec.config(cell["config"])
    assert (spec.BENCH / "traffic" / f"{cell['traffic']}.py").is_file()
    assert (spec.BENCH / "reference" / f"{c['reference']}.py").is_file()
    assert (spec.BENCH / "count" / f"{c['family']}.py").is_file()
    reported = [m for m in METRICS
                if "workloads" not in m or cell["name"] in m["workloads"]]
    assert {"setup_s"} < {m["name"] for m in reported
                          if m in DOC["end_to_end"]}
    assert any(m in DOC["per_layer"] for m in reported)


@pytest.mark.parametrize("entry", DOC["configs"], ids=lambda c: c["name"])
def test_config_file_agrees(entry):
    c = spec.config(entry["name"])
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    assert c["name"] == entry["name"] and c["source"] == entry["source"]
    assert c["reduced"] == entry["reduced"]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_exists(metric):
    assert hasattr(spec.module("metrics", metric["name"]), "read")


def test_layers_named_in_perf_md():
    perf = (ROOT / "PERF.md").read_text()
    for m in DOC["per_layer"]:
        assert f"| {m['layer']} |" in perf
        assert m["moves"] in {e["name"] for e in DOC["end_to_end"]}
