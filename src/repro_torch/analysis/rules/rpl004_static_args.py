"""RPL004 — values that must be static, hashable host values.

Counterpart of `repro.analysis.rules.rpl004_static_args`, which flags
an unhashable value in a jit's `static_argnums`/`static_argnames` slot
(it is hashed into the cache key).  The port has two such slots:

* the arguments of a `functools.cache` / `lru_cache` function: a list,
  dict or set there raises `TypeError: unhashable type`, and a tensor
  hashes by identity, so every call misses and the cache grows;
* the manifest's `static-callables`: a kernel wrapper's named
  parameters that become launch constants (the top-b count `b`, the
  window, a head dim, a split plan's sizes).  A tensor there is read
  back to the host (a sync) on every launch; a list, dict or set is no
  launch constant at all.

The rule flags call sites passing, and parameter defaults that are, a
value unhashable by construction (display literals, comprehensions,
`list`/`dict`/`set`/`np.array`-like calls) or a tensor (a `torch.*`
factory or a value `walker.TensorTypes` types as one).
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis.registry import Function, Project, rule
from repro_torch.analysis.walker import (
    Finding, SourceFile, TensorTypes, calls_by_scope, dotted,
    positional_params,
)

_CACHES = {"functools.cache", "functools.lru_cache", "cache", "lru_cache"}
_UNHASHABLE_FACTORIES = {
    "list", "dict", "set", "bytearray",
    "numpy.array", "numpy.asarray", "numpy.zeros", "numpy.ones",
}


def _bad_value(sf: SourceFile, node: ast.expr,
               types: Optional[TensorTypes]) -> Optional[str]:
    if isinstance(node, (ast.List, ast.ListComp)):
        return "an unhashable list"
    if isinstance(node, (ast.Dict, ast.DictComp)):
        return "an unhashable dict"
    if isinstance(node, (ast.Set, ast.SetComp)):
        return "an unhashable set"
    if isinstance(node, ast.Call):
        q = sf.qualified(node.func)
        if q in _UNHASHABLE_FACTORIES:
            return f"an unhashable {q.rpartition('.')[2]}"
    if types is not None and types.is_tensor(node):
        return "a tensor"
    return None


def _cached(sf: SourceFile, fn: ast.FunctionDef) -> bool:
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if sf.qualified(target) in _CACHES:
            return True
    return False


def _static_params(project: Project, fn: Function) -> Optional[set[str]]:
    """The static parameters of `fn`: all of a cached function's, or the
    manifest's names for a static callable; None if neither."""
    if _cached(fn.sf, fn.node):
        a = fn.node.args
        return {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
    names = project.manifest.static_callables.get(fn.qualname)
    return set(names) if names is not None else None


def _static_targets(project: Project) -> dict[str, tuple[Function, set[str]]]:
    out = {}
    for sf in project.files:
        # a cached function's decorator names `cache` or `lru_cache`
        if sf.tree is None or "cache" not in sf.text:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.FunctionDef) and _cached(sf, node):
                fn = project.resolve(f"{sf.module}.{node.name}")
                if fn is not None:
                    out[fn.qualname] = (fn, _static_params(project, fn))
    for name in project.manifest.static_callables:
        fn = project.resolve(name)
        if fn is not None:
            out[fn.qualname] = (fn, _static_params(project, fn))
    return out


def _static_values(fn: ast.FunctionDef, static: set[str], call: ast.Call
                   ) -> Iterator[tuple[str, ast.expr]]:
    params = positional_params(fn)
    for i, a in enumerate(call.args):
        if i < len(params) and params[i] in static:
            yield params[i], a
    for kw in call.keywords:
        if kw.arg in static:
            yield kw.arg, kw.value


def _defaults(fn: ast.FunctionDef) -> Iterator[tuple[str, ast.expr]]:
    a = fn.args
    pos = a.posonlyargs + a.args
    for arg, d in zip(pos[len(pos) - len(a.defaults):], a.defaults):
        yield arg.arg, d
    for arg, d in zip(a.kwonlyargs, a.kw_defaults):
        if d is not None:
            yield arg.arg, d


@rule("RPL004", "unhashable value or tensor passed/defaulted where a "
      "static host value is needed (cache key, launch constant)")
def check(project: Project) -> Iterator[Finding]:
    targets = _static_targets(project)
    if not targets:
        return
    for fn, static in targets.values():
        for pname, default in _defaults(fn.node):
            if pname not in static:
                continue
            reason = _bad_value(fn.sf, default, None)
            if reason is not None:
                yield Finding(
                    "RPL004", fn.sf.rel, default.lineno, default.col_offset,
                    f"default for static parameter `{pname}` of "
                    f"`{fn.node.name}` is {reason}; use a tuple / frozen "
                    f"value")
    # every call of a static target, typed by its enclosing function
    seen: set[tuple[str, int, int]] = set()
    names = {fn.node.name for fn, _ in targets.values()}
    for sf in project.files:
        if sf.tree is None:
            continue
        for scope, node in calls_by_scope(sf.tree):
            if (dotted(node.func) or "").rpartition(".")[2] not in names:
                continue
            callee = project.resolve_call(sf, node)
            if callee is None or callee.qualname not in targets:
                continue
            static = targets[callee.qualname][1]
            for pname, val in _static_values(callee.node, static, node):
                key = (sf.rel, val.lineno, val.col_offset)
                reason = _bad_value(sf, val, project.types(sf, scope))
                if reason is None or key in seen:
                    continue
                seen.add(key)
                yield Finding(
                    "RPL004", sf.rel, val.lineno, val.col_offset,
                    f"{reason} passed to static parameter `{pname}` of "
                    f"`{callee.node.name}` — pass a host int / tuple")
