"""Rule registry for the port's lint.

Counterpart of `repro.analysis.registry`.  A rule is a callable
``(project: Project) -> Iterable[Finding]`` registered under its ID
with the `rule` decorator.  Project-scope rules see every file at once:
RPL003 follows calls across the port's modules, so `Project` also
resolves a call to the function it reaches (`resolve_call`), through
`from repro_torch.x import f` and package re-exports.
"""
from __future__ import annotations

import ast
import dataclasses
import functools
from pathlib import Path
from typing import Callable, Iterable, Optional

from repro_torch.analysis.manifest import Manifest
from repro_torch.analysis.walker import (
    ClassTable, Finding, SourceFile, TensorTypes, dotted,
)

RuleFn = Callable[["Project"], Iterable[Finding]]

_RULES: dict[str, tuple[str, RuleFn]] = {}


def rule(rule_id: str, summary: str) -> Callable[[RuleFn], RuleFn]:
    def deco(fn: RuleFn) -> RuleFn:
        if rule_id in _RULES:
            raise ValueError(f"duplicate rule id {rule_id}")
        _RULES[rule_id] = (summary, fn)
        return fn
    return deco


def all_rules() -> dict[str, tuple[str, RuleFn]]:
    return dict(_RULES)


@dataclasses.dataclass(frozen=True)
class Function:
    """A function of the project: where it is and what it is called."""

    sf: SourceFile
    node: ast.FunctionDef
    qualname: str                 # `pkg.mod.f` or `pkg.mod.Class.m`
    cls: Optional[str] = None     # the enclosing class, for `self.m()`


@dataclasses.dataclass(eq=False)
class Project:
    """Everything one lint invocation sees: parsed files + manifest."""

    root: Path
    files: list[SourceFile]
    manifest: Manifest
    _types: dict = dataclasses.field(default_factory=dict, repr=False)

    def file(self, rel: str) -> Optional[SourceFile]:
        for sf in self.files:
            if sf.rel == rel:
                return sf
        return None

    @functools.cached_property
    def modules(self) -> dict[str, SourceFile]:
        return {sf.module: sf for sf in self.files if sf.tree is not None}

    @functools.cached_property
    def classes(self) -> ClassTable:
        return ClassTable(self.files)

    def types(self, sf: SourceFile, fn: ast.AST,
              cls: Optional[str] = None) -> TensorTypes:
        key = (id(fn), cls)
        if key not in self._types:
            self._types[key] = TensorTypes(sf, fn, self.classes,
                                           self._return_annotation, cls)
        return self._types[key]

    def resolve(self, qualified: str, _depth: int = 0) -> Optional[Function]:
        """The function a canonical dotted name names, following
        re-exports (`from repro_torch.x import f` in a package)."""
        parts = qualified.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            sf = self.modules.get(".".join(parts[:cut]))
            if sf is None:
                continue
            rest = parts[cut:]
            for node in sf.tree.body:  # type: ignore[union-attr]
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and len(rest) == 1 and node.name == rest[0]:
                    return Function(sf, node, qualified)
                if isinstance(node, ast.ClassDef) and len(rest) == 2 \
                        and node.name == rest[0]:
                    for st in node.body:
                        if isinstance(st, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)) \
                                and st.name == rest[1]:
                            return Function(sf, st, qualified, node.name)
            target = sf.aliases.get(rest[0])
            if target is not None and _depth < 8:
                return self.resolve(".".join([target, *rest[1:]]),
                                    _depth + 1)
            return None
        return None

    def resolve_call(self, sf: SourceFile, call: ast.Call,
                     cls: Optional[str] = None,
                     types: Optional[TensorTypes] = None
                     ) -> Optional[Function]:
        """The project function `call` reaches: a function of `sf`, an
        imported one, a method of `cls` called on `self`, or, with
        `types`, a method of a receiver whose class they know (calling
        an `nn.Module` instance reaches its `forward`)."""
        d = dotted(call.func)
        if d is None:
            return None
        if types is not None:
            found = None
            if isinstance(call.func, ast.Attribute):
                recv = types.kind(call.func.value)
                if recv in self.classes.classes:
                    found = self._method(recv, call.func.attr)
            recv = types.kind(call.func)
            if found is None and recv in self.classes.classes:
                found = (self._method(recv, "forward")
                         or self._method(recv, "__call__"))
            if found is not None:
                return found
        if cls is not None and d.startswith("self.") and d.count(".") == 1:
            return self._method(cls, d[5:])
        if "." not in d and d not in sf.aliases:
            return self.resolve(f"{sf.module}.{d}")
        q = sf.qualified(call.func)
        return self.resolve(q) if q is not None else None

    def _method(self, cls: str, name: str) -> Optional[Function]:
        found = self.classes.method(cls, name)
        if found is None:
            return None
        info, node = found
        sf = self.modules.get(info.module)
        if sf is None:
            return None
        return Function(sf, node, f"{info.module}.{info.name}.{name}",
                        info.name)

    def _return_annotation(self, sf: SourceFile, call: ast.Call,
                           types: Optional[TensorTypes] = None
                           ) -> Optional[str]:
        fn = self.resolve_call(sf, call, types=types)
        if fn is None or fn.node.returns is None:
            return None
        return ast.unparse(fn.node.returns).strip("'\"")

    def run(self, only: Optional[set[str]] = None) -> list[Finding]:
        """Run every registered rule; suppression is applied here so
        rules never have to think about it.  Suppressed findings are
        kept (marked) so --report can list them."""
        out: list[Finding] = []
        for rule_id, (_summary, fn) in sorted(_RULES.items()):
            if only is not None and rule_id not in only:
                continue
            for f in fn(self):
                sf = self.file(f.path)
                if sf is not None and sf.is_suppressed(f.rule, f.line):
                    f = dataclasses.replace(f, suppressed=True)
                out.append(f)
        out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
        return out
