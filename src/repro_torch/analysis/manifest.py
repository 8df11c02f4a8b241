"""Load the port's lint manifest, `src/repro_torch/analysis/manifest.toml`.

Counterpart of `repro.analysis.manifest`, which reads
``[tool.reprolint]`` from pyproject.toml; that table belongs to the
reference, so the port keeps a file of its own.  The manifest declares
which modules are bit-exactness-critical (RPL001 only fires there) and
the names the pinned discipline accepts; where the CUDA kernel packages
and their tests live (RPL005); the functions that must run without a
host sync and those on A12's CUDA-graph path that still do (RPL003); the
callables that write an argument in place where the rule cannot see it
(RPL002); and the wrappers whose named parameters become launch
constants (RPL004).

Parsing prefers tomllib (3.11+), falls back to tomli, and finally to a
minimal line-oriented parser good enough for the subset the manifest
uses.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any

try:  # Python 3.11+
    import tomllib as _toml
except ImportError:  # pragma: no cover - depends on interpreter
    try:
        import tomli as _toml  # type: ignore[no-redef]
    except ImportError:
        _toml = None  # type: ignore[assignment]

MANIFEST = "src/repro_torch/analysis/manifest.toml"

DEFAULTS: dict[str, Any] = {
    "critical-modules": [],
    "pinned-names": ["pinned"],
    "sensitive-names": [],
    "kernels-root": "src/repro_torch/kernels",
    "kernel-test-glob": "tests/test_torch_*.py",
    "sync-free": [],
    "capture-candidates": [],
    "mutating-callables": {},
    "static-callables": {},
}


@dataclasses.dataclass(frozen=True)
class Manifest:
    critical_modules: tuple[str, ...]
    pinned_names: tuple[str, ...]
    sensitive_names: tuple[str, ...]
    kernels_root: str
    kernel_test_glob: str
    # qualified function names (`repro_torch.sim.engine.sim_tick`,
    # `pkg.mod.Class.method`) whose card path must not sync with the host
    sync_free: tuple[str, ...]
    # the same, for functions that still sync: reported, not errors
    capture_candidates: tuple[str, ...]
    # qualified (or dotted call) name -> positions written in place
    mutating_callables: dict[str, tuple[int, ...]]
    # qualified name -> parameters that become launch constants
    static_callables: dict[str, tuple[str, ...]]

    def is_critical(self, rel: str) -> bool:
        return any(rel.endswith(m) for m in self.critical_modules)


def _fallback_parse(text: str) -> dict[str, Any]:
    """Minimal TOML subset: [section] headers, key = value with string /
    int / flat array-of-{string,int} values."""
    data: dict[str, Any] = {}
    section: dict[str, Any] = data
    buf = ""
    key = ""
    for raw in text.splitlines():
        line = raw.strip()
        if buf:  # continuation of a multi-line array
            buf += " " + line
            if _balanced(buf):
                section[key] = _parse_value(buf)
                buf = ""
            continue
        if not line or line.startswith("#"):
            continue
        m = re.match(r"\[([^\]]+)\]$", line)
        if m:
            section = data
            for part in m.group(1).split("."):
                section = section.setdefault(part.strip().strip('"'), {})
            continue
        if "=" in line:
            key, _, val = line.partition("=")
            key = key.strip().strip('"')
            val = val.strip()
            if val.startswith("[") and not _balanced(val):
                buf = val
            else:
                section[key] = _parse_value(val)
    return data


def _balanced(s: str) -> bool:
    return s.count("[") == s.count("]")


def _parse_value(val: str) -> Any:
    val = val.split("#", 1)[0].strip() if not val.startswith('"') else val
    if val.startswith("["):
        inner = val.strip()[1:-1]
        items = [s.strip() for s in inner.split(",") if s.strip()]
        return [_parse_value(s) for s in items]
    if val.startswith('"') or val.startswith("'"):
        return val[1:-1]
    if val in ("true", "false"):
        return val == "true"
    try:
        return int(val)
    except ValueError:
        return val


def _build(cfg: dict[str, Any]) -> Manifest:
    return Manifest(
        critical_modules=tuple(cfg["critical-modules"]),
        pinned_names=tuple(cfg["pinned-names"]),
        sensitive_names=tuple(cfg["sensitive-names"]),
        kernels_root=str(cfg["kernels-root"]),
        kernel_test_glob=str(cfg["kernel-test-glob"]),
        sync_free=tuple(cfg["sync-free"]),
        capture_candidates=tuple(cfg["capture-candidates"]),
        mutating_callables={n: tuple(int(p) for p in v) for n, v in
                            dict(cfg["mutating-callables"]).items()},
        static_callables={n: tuple(str(p) for p in v) for n, v in
                          dict(cfg["static-callables"]).items()},
    )


def load_manifest(root: Path) -> Manifest:
    """Read <root>/src/repro_torch/analysis/manifest.toml (defaults if
    absent)."""
    path = root / MANIFEST
    cfg = dict(DEFAULTS)
    if path.is_file():
        text = path.read_text(encoding="utf-8")
        cfg.update(_toml.loads(text) if _toml is not None
                   else _fallback_parse(text))
    return _build(cfg)


def manifest_for_tests(**overrides: Any) -> Manifest:
    """Construct a Manifest from keyword overrides (fixture tests)."""
    cfg = dict(DEFAULTS)
    for k, v in overrides.items():
        cfg[k.replace("_", "-")] = v
    return _build(cfg)
