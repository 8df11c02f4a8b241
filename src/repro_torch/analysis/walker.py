"""Source-file model and AST utilities for the port's lint.

Counterpart of `repro.analysis.walker`.  A `SourceFile` owns one parsed
module: its text, AST, the per-line suppression table (`#
reprolint-torch: disable=RPL00x[,RPL00y]` and the file-wide `#
reprolint-torch: disable-file=RPL00x`), the `# noqa` lines the
import-hygiene rule honors, and an import-alias map that resolves local
names back to canonical dotted paths (`F` -> `torch.nn.functional`, `np`
-> `numpy`), so every rule matches on canonical names.

The port's marker is its own: the reference's lint walks the port too,
and its `# reprolint: disable=` would silence the reference's rule of
the same number, whose meaning differs.

`TensorTypes` is what the port's rules know of a value's type without
running it: a tensor, a host scalar, an instance of one of the project's
NamedTuple classes, or unknown.  It reads annotations (parameters,
NamedTuple fields, properties, return types) and follows assignments,
so `state.req.status` in a function taking `state: SimState` is a
tensor and `policy.alloc_mode` an int.

Stdlib only: the linter never imports torch or numpy.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterable, Iterator, Optional

_SUPPRESS_RE = re.compile(r"#\s*reprolint-torch:\s*disable=([A-Z0-9_,\s]+)")
_SUPPRESS_FILE_RE = re.compile(
    r"#\s*reprolint-torch:\s*disable-file=([A-Z0-9_,\s]+)")
_NOQA_RE = re.compile(r"#\s*noqa(?::\s*([A-Z0-9, ]+))?", re.IGNORECASE)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str          # "RPL001"
    path: str          # repo-relative posix path
    line: int          # 1-based
    col: int           # 0-based
    message: str
    suppressed: bool = False

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col + 1}: {self.rule} {self.message}{tag}"


class SourceFile:
    """A parsed module plus the lint bookkeeping rules share."""

    def __init__(self, path: Path, rel: str):
        self.path = path
        self.rel = rel
        self.module = module_name(rel)
        self.text = path.read_text(encoding="utf-8")
        self.lines = self.text.splitlines()
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree: Optional[ast.Module] = ast.parse(self.text)
        except SyntaxError as e:  # surfaced as an RPL000 finding by the CLI
            self.tree = None
            self.parse_error = e
        self._suppress: dict[int, set[str]] = {}
        self._suppress_file: set[str] = set()
        self._noqa: dict[int, Optional[set[str]]] = {}  # None = bare noqa
        for i, line in enumerate(self.lines, start=1):
            if "#" not in line:
                continue
            m = _SUPPRESS_RE.search(line)
            if m:
                ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
                self._suppress.setdefault(i, set()).update(ids)
            m = _SUPPRESS_FILE_RE.search(line)
            if m:
                self._suppress_file.update(
                    s.strip() for s in m.group(1).split(",") if s.strip())
            m = _NOQA_RE.search(line)
            if m:
                codes = m.group(1)
                self._noqa[i] = (
                    None if codes is None
                    else {s.strip().upper() for s in codes.split(",")})
        self.aliases = (
            import_aliases(self.tree) if self.tree is not None else {})

    def is_suppressed(self, rule: str, line: int) -> bool:
        if rule in self._suppress_file:
            return True
        return rule in self._suppress.get(line, set())

    def has_noqa(self, line: int, code: str) -> bool:
        """True if the line carries a bare `# noqa` or one naming `code`."""
        if line not in self._noqa:
            return False
        codes = self._noqa[line]
        return codes is None or code.upper() in codes

    def qualified(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted name of a Name/Attribute chain, with the
        module's import aliases expanded at the root."""
        d = dotted(node)
        if d is None:
            return None
        root, _, rest = d.partition(".")
        full = self.aliases.get(root, root)
        return f"{full}.{rest}" if rest else full


def module_name(rel: str) -> str:
    """`src/repro_torch/sim/engine.py` -> `repro_torch.sim.engine`
    (a package's `__init__.py` names the package)."""
    parts = list(Path(rel).with_suffix("").parts)
    if parts and parts[0] == "src":
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def dotted(node: ast.AST) -> Optional[str]:
    """`a.b.c` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def root_name(node: ast.AST) -> Optional[str]:
    """The Name at the bottom of an Attribute/Subscript/Call chain."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def import_aliases(tree: ast.Module) -> dict[str, str]:
    """local name -> canonical dotted path, from every import statement
    in the module (any scope: wrappers import inside functions)."""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.partition(".")[0]] = (
                    a.name if a.asname else a.name.partition(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def call_kwarg(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def positional_params(fn: ast.FunctionDef) -> list[str]:
    return [a.arg for a in fn.args.posonlyargs + fn.args.args]


def assigned_names(target: ast.expr) -> Iterator[str]:
    """Dotted names bound by an assignment target (tuples flattened)."""
    if isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from assigned_names(elt)
    elif isinstance(target, ast.Starred):
        yield from assigned_names(target.value)
    else:
        d = dotted(target)
        if d is not None:
            yield d


def calls_by_scope(tree: ast.AST) -> Iterator[tuple[ast.AST, ast.Call]]:
    """Every call with its innermost enclosing function (or `tree`)."""
    todo: list[tuple[ast.AST, ast.AST]] = [(tree, tree)]
    while todo:
        node, scope = todo.pop()
        if isinstance(node, ast.Call):
            yield scope, node
        inner = node if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef)) else scope
        todo.extend((c, inner) for c in ast.iter_child_nodes(node))


SKIP_DIRS = {"__pycache__", ".git", ".jax_cache", ".venv", "node_modules"}


def iter_source_files(paths: Iterable[Path]) -> Iterator[Path]:
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            for sub in sorted(p.rglob("*.py")):
                if not any(part in SKIP_DIRS
                           for part in sub.relative_to(p).parts):
                    yield sub


# ---------------------------------------------------------------------------
# What a value is, from annotations and assignments
# ---------------------------------------------------------------------------

TENSOR = "tensor"
SCALAR = "scalar"   # a host value: int, float, bool, str, a shape, ...
# a class of the project is its name; a list of its instances "list:<name>"

_TENSOR_TYPES = {"torch.Tensor", "Tensor", "torch.nn.Parameter"}
_SCALAR_TYPES = {"int", "float", "bool", "str", "complex", "bytes",
                 "torch.Size", "torch.dtype", "torch.device"}
# tensor attributes and methods that read metadata the host already
# holds: no sync, and the result is not a tensor
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                "requires_grad", "nbytes", "itemsize", "is_leaf", "names"}
STATIC_METHODS = {"size", "dim", "numel", "element_size", "stride",
                  "is_contiguous", "data_ptr", "storage_offset",
                  "is_floating_point", "is_complex", "get_device",
                  "nelement", "ndimension", "untyped_storage"}
# the host syncs themselves: their results are host values
HOST_METHODS = {"item", "tolist", "numpy"}
_TENSOR_ATTRS = {"T", "mT", "H", "mH", "real", "imag", "grad", "data"}
# torch callables that return no tensor
_TORCH_NON_TENSOR = {
    "torch.is_grad_enabled", "torch.is_tensor", "torch.is_floating_point",
    "torch.is_complex", "torch.is_nonzero", "torch.numel", "torch.device",
    "torch.dtype", "torch.finfo", "torch.iinfo", "torch.Size",
    "torch.Generator", "torch.get_default_dtype", "torch.no_grad",
    "torch.enable_grad", "torch.inference_mode", "torch.set_grad_enabled",
    "torch.manual_seed", "torch.broadcast_shapes", "torch.result_type",
    "torch.promote_types", "torch.can_cast",
}
_TORCH_NON_TENSOR_PREFIXES = (
    "torch.cuda.", "torch.backends.", "torch.distributed.", "torch.profiler.",
    "torch.utils.", "torch.autograd.", "torch.jit.", "torch.testing.",
    "torch.compiler.", "torch.library.", "torch.ops.", "torch.nn.",
)
_MODULE_LISTS = {"torch.nn.ModuleList", "torch.nn.Sequential", "list", "tuple"}


def _annotation_text(node: Optional[ast.expr]) -> Optional[str]:
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return None
    return ast.unparse(node)


def _split_optional(text: str) -> list[str]:
    """`Optional[X]`, `X | None` -> [X]; anything else -> [text]."""
    text = text.strip()
    for pre in ("Optional[", "typing.Optional["):
        if text.startswith(pre) and text.endswith("]"):
            return _split_optional(text[len(pre):-1])
    if "|" in text and "[" not in text:
        return [p.strip() for p in text.split("|") if p.strip() != "None"]
    return [text]


@dataclasses.dataclass
class ClassInfo:
    name: str
    module: str
    bases: list[str]
    node: ast.ClassDef
    fields: dict[str, str]        # field / property / attribute -> kind text


class ClassTable:
    """The project's classes by name: their NamedTuple / dataclass
    fields, properties and `self.x = C(...)` attributes, as annotation
    text or kinds, and where each class is defined.  Two classes of one
    name: the first wins."""

    def __init__(self, files: Iterable["SourceFile"]):
        self.classes: dict[str, ClassInfo] = {}
        found = []
        for sf in files:
            if sf.tree is None:
                continue
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.ClassDef) \
                        and node.name not in self.classes:
                    self.classes[node.name] = ClassInfo(
                        node.name, sf.module,
                        [b for b in (dotted(x) for x in node.bases) if b],
                        node, {})
                    found.append((sf, self.classes[node.name]))
        for sf, info in found:
            self._fields(sf, info)

    def _fields(self, sf: "SourceFile", info: ClassInfo) -> None:
        table = info.fields
        for st in info.node.body:
            if isinstance(st, ast.AnnAssign) and isinstance(st.target, ast.Name):
                t = _annotation_text(st.annotation)
                if t is not None:
                    table.setdefault(st.target.id, t)
            elif isinstance(st, ast.FunctionDef) and st.returns \
                    and any(dotted(d) == "property" for d in st.decorator_list):
                t = _annotation_text(st.returns)
                if t is not None:
                    table.setdefault(st.name, t)
        for st in info.node.body:
            if not isinstance(st, ast.FunctionDef):
                continue
            for node in ast.walk(st):
                if not isinstance(node, ast.Assign):
                    continue
                k = self._constructed(sf, node.value)
                if k is None:
                    continue
                for t in node.targets:
                    d = dotted(t)
                    if d is not None and d.startswith("self.") \
                            and d.count(".") == 1:
                        table.setdefault(d[5:], k)

    def _constructed(self, sf: "SourceFile", node: ast.expr) -> Optional[str]:
        """`C(...)` -> "C"; `nn.ModuleList(C(...) for ...)` -> "list:C"."""
        if isinstance(node, ast.IfExp):
            return (self._constructed(sf, node.body)
                    or self._constructed(sf, node.orelse))
        if not isinstance(node, ast.Call):
            return None
        name = dotted(node.func)
        if name is not None and name.rpartition(".")[2] in self.classes:
            return name.rpartition(".")[2]
        if sf.qualified(node.func) in _MODULE_LISTS and node.args:
            inner = node.args[0]
            if isinstance(inner, (ast.GeneratorExp, ast.ListComp)):
                inner = inner.elt
            elif isinstance(inner, (ast.List, ast.Tuple)) and inner.elts:
                inner = inner.elts[0]
            k = self._constructed(sf, inner)
            if k is not None and not k.startswith("list:"):
                return f"list:{k}"
        return None

    def field(self, cls: str, name: str) -> Optional[str]:
        """A field's kind text, looked up through the project's bases."""
        seen = set()
        while cls in self.classes and cls not in seen:
            seen.add(cls)
            info = self.classes[cls]
            if name in info.fields:
                return info.fields[name]
            cls = next((b.rpartition(".")[2] for b in info.bases
                        if b.rpartition(".")[2] in self.classes), "")
        return None

    def method(self, cls: str, name: str) -> Optional[tuple[ClassInfo,
                                                            ast.FunctionDef]]:
        seen = set()
        while cls in self.classes and cls not in seen:
            seen.add(cls)
            info = self.classes[cls]
            for st in info.node.body:
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and st.name == name:
                    return info, st
            cls = next((b.rpartition(".")[2] for b in info.bases
                        if b.rpartition(".")[2] in self.classes), "")
        return None

    def kind(self, annotation: Optional[str], sf: "SourceFile"
             ) -> Optional[str]:
        """TENSOR, SCALAR, a class name, "list:<class>", or None."""
        if annotation is None:
            return None
        if annotation.startswith("list:") or annotation in self.classes:
            return annotation
        for t in _split_optional(annotation):
            head, _, rest = t.partition(".")
            full = sf.aliases.get(head, head) + (f".{rest}" if rest else "")
            if t in _TENSOR_TYPES or full in _TENSOR_TYPES:
                return TENSOR
            if t in _SCALAR_TYPES or full in _SCALAR_TYPES \
                    or t.startswith(("tuple[int", "tuple[float")):
                return SCALAR
            for pre in ("list[", "List[", "Sequence[", "tuple["):
                if t.startswith(pre) and t.endswith("]"):
                    inner = t[len(pre):-1].rstrip(", .")
                    if inner.rpartition(".")[2] in self.classes:
                        return f"list:{inner.rpartition('.')[2]}"
            name = t.rpartition(".")[2]
            if name in self.classes:
                return name
        return None


class TensorTypes:
    """What each name of one function holds, by a flow-insensitive pass
    over its parameters' annotations, its assignments and its loops (a
    name bound to a tensor anywhere in the function counts as a
    tensor).  `self` holds the enclosing class."""

    def __init__(self, sf: SourceFile, fn: ast.AST, classes: ClassTable,
                 resolve_return=None, cls: Optional[str] = None):
        self.sf = sf
        self.classes = classes
        self.resolve_return = resolve_return  # (sf, call) -> annotation
        self.names: dict[str, set[str]] = {}
        if cls is not None:
            self.names["self"] = {cls}
        for sub in ast.walk(fn):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                args = sub.args
                for a in (args.posonlyargs + args.args + args.kwonlyargs):
                    k = classes.kind(_annotation_text(a.annotation), sf)
                    if k is not None:
                        self.names.setdefault(a.arg, set()).add(k)
        binders = [n for n in ast.walk(fn)
                   if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign,
                                     ast.NamedExpr, ast.For,
                                     ast.comprehension))]
        for _ in range(4):   # to a fixed point (chains of assignments)
            before = {k: set(v) for k, v in self.names.items()}
            for node in binders:
                self._bind(node)
            if before == self.names:
                break

    def _add(self, name: str, k: Optional[str]) -> None:
        if k is not None:
            self.names.setdefault(name, set()).add(k)

    def _bind(self, node: ast.AST) -> None:
        if isinstance(node, ast.AnnAssign):
            if isinstance(node.target, ast.Name):
                k = self.classes.kind(_annotation_text(node.annotation),
                                      self.sf)
                if k is None and node.value is not None:
                    k = self.kind(node.value)
                self._add(node.target.id, k)
            return
        if isinstance(node, ast.AugAssign):
            if isinstance(node.target, ast.Name) and self.is_tensor(node.value):
                self._add(node.target.id, TENSOR)
            return
        if isinstance(node, (ast.For, ast.comprehension)):
            self._bind_target(node.target, self._iter_kind(node.iter))
            return
        targets = [node.target] if isinstance(node, ast.NamedExpr) \
            else node.targets
        for t in targets:
            if isinstance(t, ast.Name):
                self._add(t.id, self.kind(node.value))
            elif isinstance(t, (ast.Tuple, ast.List)):
                if isinstance(node.value, (ast.Tuple, ast.List)) \
                        and len(node.value.elts) == len(t.elts):
                    for tt, vv in zip(t.elts, node.value.elts):
                        self._bind_target(tt, self.kind(vv))
                else:
                    self._bind_target(t, ("tuple", self._tuple_kinds(
                        node.value, len(t.elts))))

    def _bind_target(self, target: ast.expr, k) -> None:
        if isinstance(target, ast.Name):
            if isinstance(k, str):
                self._add(target.id, k)
        elif isinstance(target, (ast.Tuple, ast.List)) \
                and isinstance(k, tuple) and len(k[1]) == len(target.elts):
            for tt, kk in zip(target.elts, k[1]):
                self._bind_target(tt, kk)

    def _iter_kind(self, node: ast.expr):
        """The kind of one item of an iteration over `node`."""
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            if node.func.id == "enumerate" and node.args:
                return ("tuple", [SCALAR, self._iter_kind(node.args[0])])
            if node.func.id == "zip":
                return ("tuple", [self._iter_kind(a) for a in node.args])
            if node.func.id == "range":
                return SCALAR
        k = self.kind(node)
        if k == TENSOR:
            return TENSOR
        if isinstance(k, str) and k.startswith("list:"):
            return k[5:]
        return None

    def _tuple_kinds(self, value: ast.expr, n: int) -> list[Optional[str]]:
        """Kinds of the items of a call returning `tuple[A, B, ...]`."""
        ann = self._call_return(value) if isinstance(value, ast.Call) else None
        if ann is None or not ann.startswith(("tuple[", "Tuple[")):
            return [None] * n
        inner = ann[ann.index("[") + 1:-1]
        parts, depth, cur = [], 0, ""
        for ch in inner:
            if ch == "," and depth == 0:
                parts.append(cur)
                cur = ""
                continue
            depth += ch == "["
            depth -= ch == "]"
            cur += ch
        parts.append(cur)
        if len(parts) != n:
            return [None] * n
        return [self.classes.kind(p.strip(), self.sf) for p in parts]

    def _call_return(self, call: ast.Call) -> Optional[str]:
        if self.resolve_return is None:
            return None
        return self.resolve_return(self.sf, call, self)

    def kind(self, node: ast.AST) -> Optional[str]:
        """TENSOR, SCALAR, a class name, "list:<class>", or None."""
        if isinstance(node, ast.Constant):
            return SCALAR
        if isinstance(node, ast.Name):
            ks = self.names.get(node.id, set())
            if TENSOR in ks:
                return TENSOR
            return next(iter(ks)) if len(ks) == 1 else None
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                return SCALAR
            base = self.kind(node.value)
            if base == TENSOR:
                return TENSOR if node.attr in _TENSOR_ATTRS else None
            if base is not None and base in self.classes.classes:
                return self.classes.kind(
                    self.classes.field(base, node.attr), self.sf)
            return None
        if isinstance(node, ast.Call):
            return self._call_kind(node)
        if isinstance(node, ast.BinOp):
            kinds = (self.kind(node.left), self.kind(node.right))
            if TENSOR in kinds:
                return TENSOR
            return SCALAR if kinds == (SCALAR, SCALAR) else None
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.Not):
                return SCALAR
            return self.kind(node.operand)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return SCALAR
            kinds = [self.kind(o) for o in (node.left, *node.comparators)]
            if TENSOR in kinds:
                return TENSOR
            return SCALAR if all(k == SCALAR for k in kinds) else None
        if isinstance(node, ast.BoolOp):
            kinds = [self.kind(v) for v in node.values]
            return TENSOR if TENSOR in kinds else None
        if isinstance(node, ast.Subscript):
            base = self.kind(node.value)
            if base == TENSOR or base == SCALAR:
                return base
            if isinstance(base, str) and base.startswith("list:"):
                return base[5:]
            return None
        if isinstance(node, ast.IfExp):
            kinds = (self.kind(node.body), self.kind(node.orelse))
            if TENSOR in kinds:
                return TENSOR
            return kinds[0] if kinds[0] == kinds[1] else None
        return None

    def _call_kind(self, node: ast.Call) -> Optional[str]:
        f = node.func
        if isinstance(f, ast.Name):
            if f.id in ("int", "float", "bool", "len", "str", "round"):
                return SCALAR
            if f.id in ("min", "max") and node.args:
                kinds = [self.kind(a) for a in node.args]
                return SCALAR if all(k == SCALAR for k in kinds) else None
        if isinstance(f, ast.Attribute):
            recv = self.kind(f.value)
            if recv == TENSOR:
                if f.attr in STATIC_METHODS or f.attr in HOST_METHODS:
                    return SCALAR
                return TENSOR
            if f.attr == "_replace" and recv in self.classes.classes:
                return recv
        q = self.sf.qualified(f)
        if q is not None and q.startswith("torch."):
            if q in _TORCH_NON_TENSOR \
                    or q.startswith(_TORCH_NON_TENSOR_PREFIXES):
                return None
            return TENSOR
        d = dotted(f)
        if d is not None and d.rpartition(".")[2] in self.classes.classes:
            return d.rpartition(".")[2]
        ann = self._call_return(node)
        if ann is not None:
            return self.classes.kind(ann, self.sf)
        return None

    def is_tensor(self, node: ast.AST) -> bool:
        return self.kind(node) == TENSOR
