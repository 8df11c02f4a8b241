"""The port's lint CLI: ``python -m repro_torch.analysis.lint
src/repro_torch tests chip_smoke.py tools``.

Counterpart of `repro.analysis.lint`.  Exit status 0 when no
unsuppressed findings, 1 otherwise, 2 on a usage error (a path that
does not exist).

Options:
  --root DIR          repo root holding src/repro_torch/analysis/
                      manifest.toml (default: cwd, walking up until one
                      is found)
  --select RPL00x,..  run only these rules
  --report            also list suppressed findings: those silenced by
                      `# reprolint-torch:` comments and RPL003's sites
                      on capture candidates (informational; never
                      affects the exit code)
  --list-rules        print the registered rules and exit
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import repro_torch.analysis.rules  # noqa: F401  (registers the rules)
from repro_torch.analysis.manifest import MANIFEST, load_manifest
from repro_torch.analysis.registry import Project, all_rules
from repro_torch.analysis.walker import Finding, SourceFile, iter_source_files

DEFAULT_PATHS = ["src/repro_torch", "tests", "chip_smoke.py", "tools"]


def find_root(start: Path) -> Path:
    p = start.resolve()
    for cand in (p, *p.parents):
        if (cand / MANIFEST).is_file():
            return cand
    return p


def build_project(root: Path, paths: list[Path]) -> Project:
    files = []
    for fp in iter_source_files(paths):
        try:
            rel = fp.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = fp.as_posix()
        files.append(SourceFile(fp, rel))
    return Project(root=root, files=files, manifest=load_manifest(root))


def run(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.lint",
        description="static invariant checks for the PyTorch port")
    ap.add_argument("paths", nargs="*", default=DEFAULT_PATHS)
    ap.add_argument("--root", default=None)
    ap.add_argument("--select", default=None)
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--list-rules", action="store_true")
    ns = ap.parse_args(argv)

    if ns.list_rules:
        for rid, (summary, _fn) in sorted(all_rules().items()):
            print(f"{rid}  {summary}")
        return 0

    root = Path(ns.root) if ns.root else find_root(Path.cwd())
    paths = [Path(p) if Path(p).is_absolute() else root / p
             for p in ns.paths]
    missing = [p for p in paths if not p.exists()]
    if missing:
        print(f"reprolint-torch: path not found: "
              f"{', '.join(str(m) for m in missing)}", file=sys.stderr)
        return 2

    project = build_project(root, paths)
    only = ({s.strip() for s in ns.select.split(",") if s.strip()}
            if ns.select else None)
    findings = project.run(only=only)

    # files that failed to parse are findings in their own right
    for sf in project.files:
        if sf.parse_error is not None:
            findings.append(Finding(
                "RPL000", sf.rel, sf.parse_error.lineno or 1, 0,
                f"syntax error: {sf.parse_error.msg}"))

    active = [f for f in findings if not f.suppressed]
    shown = findings if ns.report else active
    for f in shown:
        print(f.render())
    n_sup = sum(1 for f in findings if f.suppressed)
    tail = f" ({n_sup} suppressed)" if n_sup else ""
    print(f"reprolint-torch: {len(active)} finding(s) in "
          f"{len(project.files)} file(s){tail}")
    return 1 if active else 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
