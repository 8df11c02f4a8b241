"""RPL006 — import hygiene.

Counterpart of `repro.analysis.rules.rpl006_imports`, with the same
meaning: module-level imports that are never used, and same-name
re-imports.  `# noqa` / `# noqa: F401` on the import line is honored,
matching the ruff convention, so one marker satisfies both tools.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.registry import Project, rule
from repro_torch.analysis.walker import Finding


def _used_names(tree: ast.Module) -> set[str]:
    used: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
    # string entries in __all__ count as uses (re-export modules)
    for node in tree.body:
        if isinstance(node, ast.Assign) \
                and any(isinstance(t, ast.Name) and t.id == "__all__"
                        for t in node.targets) \
                and isinstance(node.value, (ast.List, ast.Tuple)):
            for e in node.value.elts:
                if isinstance(e, ast.Constant) and isinstance(e.value, str):
                    used.add(e.value)
    return used


@rule("RPL006", "unused or duplicate module-level import")
def check(project: Project) -> Iterator[Finding]:
    for sf in project.files:
        if sf.tree is None:
            continue
        is_init = sf.rel.endswith("__init__.py")
        has_all = any(
            isinstance(n, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id == "__all__"
                    for t in n.targets)
            for n in sf.tree.body)
        if is_init and not has_all:
            # __init__.py without __all__: imports are the public API
            continue
        used = _used_names(sf.tree)
        bound: dict[str, int] = {}
        for node in sf.tree.body:  # module level only
            if isinstance(node, ast.Import):
                names = [(a.asname or a.name.partition(".")[0], a)
                         for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__" \
                        or any(a.name == "*" for a in node.names):
                    continue
                names = [(a.asname or a.name, a) for a in node.names]
            else:
                continue
            if sf.has_noqa(node.lineno, "F401"):
                continue
            for local, alias in names:
                # multi-line imports: the noqa rides the name's own line
                line = getattr(alias, "lineno", node.lineno)
                if sf.has_noqa(line, "F401"):
                    continue
                if local in bound:
                    yield Finding(
                        "RPL006", sf.rel, line, node.col_offset,
                        f"`{local}` re-imported (first bound at line "
                        f"{bound[local]})")
                bound[local] = line
                if local not in used:
                    yield Finding(
                        "RPL006", sf.rel, line, node.col_offset,
                        f"`{local}` imported but unused")
