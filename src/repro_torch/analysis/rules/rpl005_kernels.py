"""RPL005 — the port's CUDA kernel contract.

Counterpart of `repro.analysis.rules.rpl005_kernels` (the Pallas kernel
contract).  Every kernel package under the manifest's `kernels-root`
must ship:

* its CUDA source, a `.cu` file that `_build.SOURCES` lists (so
  `_build.build_all` compiles it);
* a `ref.py` with at least one `*_ref` plain version (defined or
  re-exported);
* an `ops.py` that calls `_build.refuse_autograd` (the kernels are
  forward-only) and passes every launch's return code through
  `check_rc`: a call on the library handle (`lib = _lib()`) whose result
  is dropped, or bound to a name no `check_rc(...)` reads, is a launch
  whose error goes unseen;
* a test: a file matching the manifest's `kernel-test-glob` that
  imports the package.

Inside the `.cu` sources, read with regular expressions, the
counterparts of the reference's lane and half-precision checks:

* a `__launch_bounds__` thread count given as a literal, or as a
  `constexpr int` / `#define` of one, is a multiple of the warp (32);
* no `+=` or `fma` accumulates into a `__half` or `__nv_bfloat16`
  variable (accumulate in float32 and round once on the way out).
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterator, Optional

from repro_torch.analysis.registry import Project, rule
from repro_torch.analysis.walker import Finding, dotted

_BOUNDS_RE = re.compile(r"__launch_bounds__\s*\(\s*([A-Za-z_]\w*|\d+)")
_CONST_RE = re.compile(
    r"(?:constexpr\s+(?:unsigned\s+)?int\s+|#\s*define\s+)([A-Za-z_]\w*)"
    r"\s*=?\s*(\d+)\b")
_HALF_DECL_RE = re.compile(
    r"\b(?:__half|__nv_bfloat16|half|nv_bfloat16)\s+([A-Za-z_]\w*)\s*[=;,\[]")
_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.DOTALL)
WARP = 32


def _strip_comments(text: str) -> str:
    """Comments blanked, newlines kept (so line numbers hold)."""
    return _COMMENT_RE.sub(lambda m: re.sub(r"[^\n]", " ", m.group(0)), text)


def _line(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


def check_cu(rel: str, text: str) -> Iterator[Finding]:
    """The `.cu` half of the contract, on one source's text."""
    code = _strip_comments(text)
    consts = {m.group(1): int(m.group(2)) for m in _CONST_RE.finditer(code)}
    for m in _BOUNDS_RE.finditer(code):
        tok = m.group(1)
        n: Optional[int] = int(tok) if tok.isdigit() else consts.get(tok)
        if n is not None and n % WARP:
            yield Finding(
                "RPL005", rel, _line(code, m.start()), 0,
                f"__launch_bounds__ of {n} threads ({tok}) is not a "
                f"multiple of the warp ({WARP}); the last warp runs "
                f"partly empty")
    for name in {m.group(1) for m in _HALF_DECL_RE.finditer(code)}:
        acc = re.compile(
            rf"\b{name}\s*\+=|\b{name}\s*=\s*(?:__h?fma\w*|fmaf?)\s*\("
            rf"[^;]*\b{name}\b")
        for m in acc.finditer(code):
            yield Finding(
                "RPL005", rel, _line(code, m.start()), 0,
                f"`{name}` is half precision and accumulates (+= / fma): "
                f"accumulate in float32 and round once on the way out")


def _sources(build_py: Path) -> set[str]:
    """The `.cu` paths, relative to the kernels root, that `_build.py`'s
    `SOURCES` lists (each value a `/` chain of string literals)."""
    if not build_py.is_file():
        return set()
    tree = ast.parse(build_py.read_text(encoding="utf-8"))
    out: set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "SOURCES"
                for t in node.targets) and isinstance(node.value, ast.Dict):
            for v in node.value.values:
                parts = []
                while isinstance(v, ast.BinOp) and isinstance(v.op, ast.Div):
                    if isinstance(v.right, ast.Constant):
                        parts.insert(0, str(v.right.value))
                    v = v.left
                out.add("/".join(parts))
    return out


def _ref_names(ref: Path) -> set[str]:
    try:
        rtree = ast.parse(ref.read_text(encoding="utf-8"))
    except SyntaxError:
        return set()
    names = {n.name for n in ast.walk(rtree)
             if isinstance(n, ast.FunctionDef) and n.name.endswith("_ref")}
    for n in ast.walk(rtree):
        if isinstance(n, ast.ImportFrom):
            names.update((a.asname or a.name) for a in n.names
                         if (a.asname or a.name).endswith("_ref"))
    return names


def _unchecked_launches(tree: ast.Module) -> Iterator[ast.AST]:
    """Calls on a library handle whose return code no `check_rc` reads."""
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        libs = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                callee = (dotted(node.value.func) or "").rpartition(".")[2]
                if callee in ("_lib", "load"):
                    libs.update(t.id for t in node.targets
                                if isinstance(t, ast.Name))
        if not libs:
            continue
        checked = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and (
                    dotted(node.func) or "").rpartition(".")[2] == "check_rc":
                checked.update(n.id for a in node.args for n in ast.walk(a)
                               if isinstance(n, ast.Name))

        def is_launch(call) -> bool:
            return isinstance(call, ast.Call) \
                and isinstance(call.func, ast.Attribute) \
                and isinstance(call.func.value, ast.Name) \
                and call.func.value.id in libs

        for node in ast.walk(fn):
            if isinstance(node, ast.Expr) and is_launch(node.value):
                yield node
            elif isinstance(node, ast.Assign) and is_launch(node.value) \
                    and not any(isinstance(t, ast.Name) and t.id in checked
                                for t in node.targets):
                yield node


def _imports(tree: ast.Module) -> Iterator[str]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@rule("RPL005", "CUDA kernel package missing its built source, plain "
      "version, guarded wrapper or test, or a .cu launch bound / half "
      "accumulator off the contract")
def check(project: Project) -> Iterator[Finding]:
    man = project.manifest
    kroot = project.root / man.kernels_root
    if not kroot.is_dir():
        return
    built = _sources(kroot / "_build.py")
    pkg_prefix = ".".join(Path(man.kernels_root).parts[1:]
                          if man.kernels_root.startswith("src/")
                          else Path(man.kernels_root).parts)
    tests = []
    for p in sorted(project.root.glob(man.kernel_test_glob)):
        sf = project.file(p.relative_to(project.root).as_posix())
        tree = sf.tree if sf is not None else None
        if tree is None:
            try:
                tree = ast.parse(p.read_text(encoding="utf-8"))
            except SyntaxError:
                continue
        tests.append(set(_imports(tree)))
    for pkg in sorted(p for p in kroot.iterdir() if p.is_dir()):
        if not (pkg / "__init__.py").is_file():
            continue
        pkg_rel = f"{man.kernels_root}/{pkg.name}"
        init_rel = f"{pkg_rel}/__init__.py"
        cus = sorted(pkg.glob("*.cu"))
        if not cus:
            yield Finding("RPL005", init_rel, 1, 0,
                          f"kernel package `{pkg.name}` has no CUDA source "
                          f"(.cu)")
        for cu in cus:
            cu_rel = f"{pkg_rel}/{cu.name}"
            if f"{pkg.name}/{cu.name}" not in built:
                yield Finding("RPL005", cu_rel, 1, 0,
                              f"`{cu.name}` is not in `_build.SOURCES`, so "
                              f"`build_all` never compiles it")
            yield from check_cu(cu_rel, cu.read_text(encoding="utf-8"))
        ref = pkg / "ref.py"
        if not ref.is_file():
            yield Finding("RPL005", init_rel, 1, 0,
                          f"kernel package `{pkg.name}` has no ref.py plain "
                          f"version")
        elif not _ref_names(ref):
            yield Finding("RPL005", f"{pkg_rel}/ref.py", 1, 0,
                          f"ref.py in `{pkg.name}` defines no `*_ref` "
                          f"plain version")
        ops = pkg / "ops.py"
        if not ops.is_file():
            yield Finding("RPL005", init_rel, 1, 0,
                          f"kernel package `{pkg.name}` has no ops.py "
                          f"wrapper")
        else:
            ops_rel = f"{pkg_rel}/ops.py"
            tree = ast.parse(ops.read_text(encoding="utf-8"))
            if not any(isinstance(n, (ast.Attribute, ast.Name))
                       and (getattr(n, "attr", None) or getattr(n, "id", None))
                       == "refuse_autograd" for n in ast.walk(tree)):
                yield Finding("RPL005", ops_rel, 1, 0,
                              f"ops.py of `{pkg.name}` never calls "
                              f"`_build.refuse_autograd` (the kernel is "
                              f"forward-only)")
            for node in _unchecked_launches(tree):
                yield Finding("RPL005", ops_rel, node.lineno, node.col_offset,
                              "launch whose return code no `check_rc` "
                              "reads: a failed launch would go unseen")
        mod = f"{pkg_prefix}.{pkg.name}"
        if not any(m == mod or m.startswith(mod + ".")
                   for names in tests for m in names):
            yield Finding("RPL005", init_rel, 1, 0,
                          f"no {man.kernel_test_glob} imports `{mod}`: the "
                          f"kernel's plain version has no test")
