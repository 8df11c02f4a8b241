"""RPL002 — use after an in-place hand-off.

Counterpart of `repro.analysis.rules.rpl002_donation`.  The reference
tracks a binding passed at a donated position of a jitted call and read
before it is rebound: XLA deleted its buffer.  Eager PyTorch donates
nothing, but a callable that writes its argument in place hands that
buffer off just the same: after the call the old binding holds what the
callee wrote, and the caller must rebind it from the call's result
before reading it (`pool = step(pool)`).  A12's CUDA graphs make this
the rule for their static buffers, which every replay overwrites.

The dataflow is the reference's: per function body in statement order,
the bindings passed at a writing position are tainted, and a later load
of one (or of an attribute through it) is a finding until the name is
rebound.  Writing callables come from two sources:

* the manifest's `mutating-callables` (qualified or dotted call name ->
  positions), for callables another module defines or that are built
  at run time;
* functions of the same module that write a parameter's tensors in
  place: call a trailing-underscore method on it (`p.copy_(...)`,
  `p.state.add_(...)`), pass it as `out=`, or assign through it where
  the target is a tensor (`p[...] = v`, `cache.k[:, slot] = v`).  A dict
  or list a function fills for its caller is no device buffer and does
  not count.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis.registry import Project, rule
from repro_torch.analysis.walker import (
    Finding, SourceFile, assigned_names, dotted, positional_params,
    root_name,
)

# trailing-underscore methods that set a flag, not a tensor's data
_FLAG_METHODS = {"requires_grad_", "share_memory_"}


def _written_params(fn: ast.FunctionDef, types) -> set[str]:
    """The parameters whose tensors `fn` writes in place (`types()`
    gives the function's `TensorTypes`, made only when needed)."""
    params = set(positional_params(fn)) - {"self", "cls"}
    out: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr.endswith("_") \
                    and not f.attr.startswith("_") \
                    and f.attr not in _FLAG_METHODS:
                r = root_name(f.value)
                if r in params:
                    out.add(r)
            for kw in node.keywords:
                if kw.arg == "out" and isinstance(kw.value, ast.Name) \
                        and kw.value.id in params:
                    out.add(kw.value.id)
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Subscript) \
                        and root_name(t.value) in params \
                        and types().is_tensor(t.value):
                    out.add(root_name(t.value))
    return out


def _module_writers(sf: SourceFile, project: Project
                    ) -> dict[str, tuple[int, ...]]:
    """dotted call name -> written positions: the manifest's, and the
    module's own functions (by name; methods as `self.<name>`)."""
    out: dict[str, tuple[int, ...]] = {}
    for name, pos in project.manifest.mutating_callables.items():
        out[name] = pos
    if sf.tree is None:
        return out
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for st in node.body:
            if isinstance(st, ast.FunctionDef):
                written = _written_params(
                    st, lambda: project.types(sf, st, node.name))
                params = positional_params(st)[1:]
                pos = tuple(i for i, p in enumerate(params) if p in written)
                if pos:
                    out[f"self.{st.name}"] = pos
    for node in sf.tree.body:
        if isinstance(node, ast.FunctionDef):
            written = _written_params(node,
                                      lambda: project.types(sf, node))
            params = positional_params(node)
            pos = tuple(i for i, p in enumerate(params) if p in written)
            if pos:
                out[node.name] = pos
    return out


def _writer_positions(project: Project, sf: SourceFile, call: ast.Call,
                      writers: dict[str, tuple[int, ...]]
                      ) -> Optional[tuple[int, ...]]:
    """Written positions if `call` reaches a writing callable: by its
    dotted name, or by the qualified name of the function it resolves
    to (`from repro_torch.models import decode_step` reaches
    `repro_torch.models.model.decode_step`)."""
    d = dotted(call.func)
    if d is None:
        return None
    if d in writers:
        return writers[d]
    if d.rpartition(".")[2] not in {w.rpartition(".")[2] for w in writers}:
        return None
    fn = project.resolve_call(sf, call)
    if fn is not None and fn.qualname in writers:
        return writers[fn.qualname]
    return None


def _written_args(call: ast.Call, positions: tuple[int, ...]
                  ) -> Iterator[str]:
    for i in positions:
        if i < len(call.args):
            d = dotted(call.args[i])
            if d is not None:
                yield d


class _BodyScan:
    """Statement-order walk of one function body with a taint set of
    handed-off dotted names, control flow handled as the reference's:
    branches scanned in order against one taint set, loop bodies twice
    (a hand-off at the bottom taints a read at the top of the next
    iteration)."""

    def __init__(self, project: Project, sf: SourceFile,
                 writers: dict[str, tuple[int, ...]]):
        self.project = project
        self.sf = sf
        self.writers = writers
        self.taint: dict[str, int] = {}  # dotted name -> hand-off line
        self.findings: list[Finding] = []
        self._seen: set[tuple[int, int]] = set()

    def scan_body(self, body: list[ast.stmt]) -> None:
        for stmt in body:
            self.scan_stmt(stmt)

    def scan_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs get their own scan
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            for _ in range(2):
                self.scan_body(stmt.body)
            self.scan_body(stmt.orelse)
            return
        if isinstance(stmt, ast.If):
            self.scan_expr_reads(stmt.test)
            self.scan_body(stmt.body)
            self.scan_body(stmt.orelse)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self.scan_expr_reads(item.context_expr)
            self.scan_body(stmt.body)
            return
        if isinstance(stmt, ast.Try):
            self.scan_body(stmt.body)
            for h in stmt.handlers:
                self.scan_body(h.body)
            self.scan_body(stmt.orelse)
            self.scan_body(stmt.finalbody)
            return
        if isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                self._clear(t)
            return
        if isinstance(stmt, ast.Assign):
            self.scan_expr_reads(stmt.value)
            self.scan_value_for_handoff(stmt.value)
            for t in stmt.targets:
                self._clear(t)
            return
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self.scan_expr_reads(stmt.value)
                self.scan_value_for_handoff(stmt.value)
            self._clear(stmt.target)
            return
        if isinstance(stmt, ast.AugAssign):
            self.scan_expr_reads(stmt.target)
            self.scan_expr_reads(stmt.value)
            self.scan_value_for_handoff(stmt.value)
            self._clear(stmt.target)
            return
        self.scan_expr_reads(stmt)
        self.scan_value_for_handoff(stmt)

    def scan_value_for_handoff(self, node: ast.AST) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                pos = _writer_positions(self.project, self.sf, sub,
                                        self.writers)
                if pos is not None:
                    for name in _written_args(sub, pos):
                        self.taint[name] = sub.lineno

    def scan_expr_reads(self, node: ast.AST) -> None:
        if not self.taint:
            return
        for sub in ast.walk(node):
            d = dotted(sub) if isinstance(sub, (ast.Name, ast.Attribute)) \
                else None
            if d is None:
                continue
            hit = self._tainted(d)
            if hit is None:
                continue
            # one finding a chain (`a.b` and its `a` start together), and
            # loop bodies are scanned twice
            key = (sub.lineno, sub.col_offset)
            if key in self._seen:
                continue
            self._seen.add(key)
            self.findings.append(Finding(
                "RPL002", self.sf.rel, sub.lineno, sub.col_offset,
                f"read of `{d}` after a callable wrote it in place at line "
                f"{hit} (use after hand-off); rebind it from the call's "
                f"result before reading"))

    def _tainted(self, name: str) -> Optional[int]:
        if name in self.taint:
            return self.taint[name]
        for t, line in self.taint.items():
            if name.startswith(t + "."):
                return line
        return None

    def _clear(self, target: ast.expr) -> None:
        for name in assigned_names(target):
            self.taint.pop(name, None)
            for t in list(self.taint):
                if t.startswith(name + "."):
                    del self.taint[t]


@rule("RPL002", "read of a binding after it was handed to a callable that "
      "writes it in place, before it is rebound")
def check(project: Project) -> Iterator[Finding]:
    for sf in project.files:
        if sf.tree is None:
            continue
        writers = _module_writers(sf, project)
        if not writers:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan = _BodyScan(project, sf, writers)
                scan.scan_body(node.body)
                yield from scan.findings
