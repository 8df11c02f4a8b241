"""Docs-freshness gate for the port: its docs' claims must match the repo.

Counterpart of `repro.analysis.docs_check`, which holds README.md's
make targets and paths.  This one reads the README's port section (from
``## The PyTorch + CUDA port`` to the next ``## `` heading) and
`.claude/skills/verify/SKILL.md`, and fails when:

* a backticked ``repro_torch.*`` module does not exist (a dotted name
  may also end in a name its module defines or imports:
  ``repro_torch.configs.get``);
* a backticked ``src/repro_torch/...``, ``tools/...`` or
  ``tests/test_torch_*.py`` path does not exist (a glob must match at
  least one file);
* a ``chip_smoke.py --only=<phase>[,<phase>]`` names a phase that is
  not a key of `chip_smoke.py`'s `SELECTABLE`.

Stdlib only.  ``python -m repro_torch.analysis.docs_check``: exit 0
when fresh, 1 with a per-claim report when stale.
"""
from __future__ import annotations

import ast
import re
import sys
from pathlib import Path

_REPO = Path(__file__).resolve().parents[3]

DOCS = ("README.md", ".claude/skills/verify/SKILL.md")
_SECTION = "## The PyTorch + CUDA port"
_PATH_RE = re.compile(
    r"`((?:src/repro_torch|tools)/[A-Za-z0-9_./*-]*"
    r"|tests/test_torch_[A-Za-z0-9_*]*\.py)`")
_MODULE_RE = re.compile(r"`(repro_torch(?:\.[A-Za-z0-9_]+)*)`")
_ONLY_RE = re.compile(r"--only=([A-Za-z0-9_,]+)")


def _port_text(name: str, text: str) -> str:
    """README.md: its port section only; other docs whole."""
    if name != "README.md":
        return text
    start = text.find(_SECTION)
    if start < 0:
        return ""
    end = text.find("\n## ", start + len(_SECTION))
    return text[start:] if end < 0 else text[start:end]


def _module_file(root: Path, dotted: str) -> Path | None:
    stem = root / "src" / Path(*dotted.split("."))
    if stem.with_suffix(".py").is_file():
        return stem.with_suffix(".py")
    if (stem / "__init__.py").is_file():
        return stem / "__init__.py"
    return None


def _top_level_names(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(encoding="utf-8"))
    out: set[str] = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).partition(".")[0]
                       for a in node.names)
    return out


def module_exists(root: Path, dotted: str) -> bool:
    """A module or package of `src/`, or a name one of them defines."""
    if _module_file(root, dotted) is not None:
        return True
    mod, _, name = dotted.rpartition(".")
    path = _module_file(root, mod) if mod else None
    return path is not None and name in _top_level_names(path)


def path_exists(root: Path, rel: str) -> bool:
    if "*" in rel:
        return any(root.glob(rel))
    return (root / rel).exists()


def selectable(root: Path) -> set[str]:
    """The keys of `chip_smoke.py`'s `SELECTABLE`."""
    path = root / "chip_smoke.py"
    if not path.is_file():
        return set()
    for node in ast.parse(path.read_text(encoding="utf-8")).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "SELECTABLE"
                for t in node.targets) and isinstance(node.value, ast.Dict):
            return {k.value for k in node.value.keys
                    if isinstance(k, ast.Constant)}
    return set()


def check_text(root: Path, name: str, text: str) -> list[str]:
    """The stale claims of one document's text."""
    text = _port_text(name, text)
    stale = []
    for p in _PATH_RE.findall(text):
        if not path_exists(root, p):
            stale.append(f"{name}: path `{p}` does not exist")
    for m in _MODULE_RE.findall(text):
        if not module_exists(root, m):
            stale.append(f"{name}: module `{m}` does not exist")
    phases = selectable(root)
    for group in _ONLY_RE.findall(text):
        for phase in group.split(","):
            if phase and phase not in phases:
                stale.append(f"{name}: `--only={phase}` is no phase of "
                             f"chip_smoke.py's SELECTABLE")
    return stale


def check(root: Path = _REPO) -> list[str]:
    """Returns the list of stale claims (empty means fresh)."""
    stale = []
    for name in DOCS:
        path = root / name
        if not path.is_file():
            stale.append(f"{name} does not exist")
            continue
        stale += check_text(root, name, path.read_text(encoding="utf-8"))
    return stale


def main() -> int:
    stale = check()
    if stale:
        print("docs_check: stale documentation claims:")
        for s in stale:
            print(f"  {s}")
        return 1
    print("docs_check: the port's documented paths, modules and phases "
          "match the repo")
    return 0


if __name__ == "__main__":
    sys.exit(main())
