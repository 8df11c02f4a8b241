"""RPL001 — pinned-float discipline in bit-exactness-critical modules.

Counterpart of `repro.analysis.rules.rpl001_pinned`, with the same
meaning.  Card = CPU = reference parity (windowed vs dense engine, live
session vs simulator) depends on severity/score/EMA arithmetic keeping
one rounding: a bare `torch.sum` reduces in the device's order, and a
mul-add the compiler may contract changes the last bit.  In modules the
manifest marks critical, any reduction (`torch.sum`/`torch.mean`/
`np.sum`/`.sum()`/`.mean()`) or mul-add whose operands touch a
sensitive name must sit inside a call of a pinned name: `pinned`,
`fma32` (one rounding of `a*b + c`) or `sum32` (a float64 sum rounded
once), all from `core/numerics.py`.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.registry import Project, rule
from repro_torch.analysis.walker import Finding, SourceFile, dotted

_REDUCTION_FUNCS = {
    "torch.sum", "torch.mean", "numpy.sum", "numpy.mean",
}
_REDUCTION_METHODS = {"sum", "mean"}


def _mentions_sensitive(node: ast.AST, sensitive: tuple[str, ...]) -> bool:
    """Does any Name/Attribute segment in the subtree match a sensitive
    name? Matching is per-segment so `self.ema_latency_ratio` and
    `carry.scores` both count."""
    for sub in ast.walk(node):
        segs: tuple[str, ...] = ()
        if isinstance(sub, ast.Name):
            segs = (sub.id,)
        elif isinstance(sub, ast.Attribute):
            segs = (sub.attr,)
        for seg in segs:
            if seg in sensitive:
                return True
    return False


def _pinned_spans(sf: SourceFile, tree: ast.AST,
                  pinned_names: tuple[str, ...]) -> list[ast.Call]:
    """All pinned-name call nodes (matched on the final name segment,
    so `numerics.sum32(x)` and `sum32(x)` both count)."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            d = dotted(node.func)
            if d is not None and d.rpartition(".")[2] in pinned_names:
                out.append(node)
    return out


def _inside_any(node: ast.AST, containers: list[ast.Call]) -> bool:
    """Is `node` lexically inside one of the container calls' argument
    subtrees? (Position-based: AST nodes don't carry parent links.)"""
    n0 = (node.lineno, node.col_offset)            # type: ignore[attr-defined]
    n1 = (node.end_lineno, node.end_col_offset)    # type: ignore[attr-defined]
    for c in containers:
        c0 = (c.lineno, c.col_offset)
        c1 = (c.end_lineno, c.end_col_offset)
        if c0 <= n0 and n1 <= c1 and node is not c:
            return True
    return False


def _sensitive_target(stmt_targets: dict[int, bool], node: ast.AST) -> bool:
    return stmt_targets.get(getattr(node, "lineno", -1), False)


@rule("RPL001", "bare float reduction / mul-add outside a pinned name "
      "in a bit-exactness-critical module")
def check(project: Project) -> Iterator[Finding]:
    man = project.manifest
    sensitive = man.sensitive_names
    if not sensitive:
        return
    for sf in project.files:
        if sf.tree is None or not man.is_critical(sf.rel):
            continue
        pins = _pinned_spans(sf, sf.tree, man.pinned_names)
        # assignment lines whose *target* is sensitive: `score = a*b + c`
        # is a violation even if the RHS names aren't sensitive
        tgt_lines: dict[int, bool] = {}
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assign):
                names = [n for t in node.targets
                         for n in _iter_target_segs(t)]
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                names = list(_iter_target_segs(node.target))
            else:
                continue
            if any(n in sensitive for n in names):
                tgt_lines[node.lineno] = True

        for node in ast.walk(sf.tree):
            hit = None
            if isinstance(node, ast.Call):
                q = sf.qualified(node.func)
                if q in _REDUCTION_FUNCS:
                    hit = f"bare {q.rpartition('.')[2]}()"
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _REDUCTION_METHODS \
                        and not node.args and not node.keywords:
                    # zero-arg .sum()/.mean() method — axis= reductions on
                    # bool masks (counting) are not float-sensitive
                    hit = f"bare .{node.func.attr}()"
            elif isinstance(node, ast.BinOp) \
                    and isinstance(node.op, (ast.Add, ast.Sub)) \
                    and (isinstance(node.left, ast.BinOp)
                         and isinstance(node.left.op, ast.Mult)
                         or isinstance(node.right, ast.BinOp)
                         and isinstance(node.right.op, ast.Mult)):
                hit = "FMA-contractible a*b + c"
            if hit is None:
                continue
            if not (_mentions_sensitive(node, sensitive)
                    or _sensitive_target(tgt_lines, node)):
                continue
            if _inside_any(node, pins):
                continue
            yield Finding(
                "RPL001", sf.rel, node.lineno, node.col_offset,
                f"{hit} on sensitive value bypasses the pinned names "
                f"({', '.join(man.pinned_names)}) — wrap it in one or "
                f"suppress with a justification")


def _iter_target_segs(target: ast.expr) -> Iterator[str]:
    if isinstance(target, (ast.Tuple, ast.List)):
        for e in target.elts:
            yield from _iter_target_segs(e)
    elif isinstance(target, ast.Starred):
        yield from _iter_target_segs(target.value)
    elif isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, ast.Attribute):
        yield target.attr
