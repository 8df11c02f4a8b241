"""RPL003 — host syncs in functions the port declares free of them.

Counterpart of `repro.analysis.rules.rpl003_hostsync`.  The reference
flags host transfers inside jitted and scan-body functions; eager
PyTorch has no such marker, so the functions come from the manifest:
`sync-free` ones, whose card path must never wait for the device, and
`capture-candidates`, the ones on the path ROADMAP A12 captures in CUDA
graphs that still sync (a graph cannot capture a host sync, so their
syncs must stay outside it).  From each, the rule
follows its callees across the port's modules (`from repro_torch.x
import f`, re-exports, `self.m()`, methods of receivers whose class the
annotations give, an `nn.Module` called for its `forward`), as the
reference follows a traced function's helpers.

A host sync is:

* `.item()`, `.tolist()`, `.cpu()`, `.numpy()`, `.to("cpu")`, and
  `np.asarray`/`np.array` of a tensor;
* `float()`, `int()`, `bool()`, `range()`, `min()`/`max()`/`any()`/
  `all()` of a tensor, a tensor's truth value (`if`, `while`, `assert`,
  `and`/`or`/`not`, a conditional expression), `torch.is_nonzero`;
* `torch.nonzero`/`argwhere` and one-argument `torch.where`,
  `torch.unique`, `masked_select` and indexing by a boolean mask (the
  output's size depends on the data);
* `repeat_interleave` with tensor repeats and no `output_size`;
* `torch.cuda.synchronize()` and `Event`/`Stream.synchronize()`;
* a copy from pageable host memory to the card, `torch.tensor(...,
  device=...)`, `torch.as_tensor(..., device=...)`, `.cuda()`: CUDA
  syncs the stream before such a copy returns (a push from pinned
  memory with `non_blocking=True` does not).

Shape, dtype and device reads (`x.shape[0]`, `x.numel()`) are static
and exempt, as in the reference.  What is a tensor comes from
annotations and assignments (`walker.TensorTypes`); a value the rule
cannot type is not flagged, which is why the card check
(`chip_smoke.py --only=sync_free`) counts each function's syncs too.
The branch a wrapper takes for CPU tensors (`if dev.type == "cpu":`)
is not on the card's path and is skipped, as is a `raise` statement.

A finding reached from a `sync-free` function is an error.  One reached
only from a capture candidate is kept suppressed: `--report` lists it,
and it is A12's inventory.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Iterator, Optional

from repro_torch.analysis.registry import Function, Project, rule
from repro_torch.analysis.walker import (
    SCALAR, Finding, TensorTypes, call_kwarg,
)

_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_CASTS = {"float", "int", "bool", "complex", "range", "min", "max", "any",
          "all"}
_DATA_SIZED = {"torch.nonzero", "torch.argwhere", "torch.unique",
               "torch.unique_consecutive", "torch.masked_select"}
_DATA_SIZED_METHODS = {"nonzero", "argwhere", "unique", "unique_consecutive",
                       "masked_select"}
_BOOL_FUNCS = {"isfinite", "isnan", "isinf", "isneginf", "isposinf",
               "logical_and", "logical_or", "logical_not", "logical_xor",
               "eq", "ne", "lt", "le", "gt", "ge", "isin", "isclose", "bool"}
_NUMPY_COPIES = {"numpy.asarray", "numpy.array"}
_HOST_TO_DEVICE = {"torch.tensor", "torch.as_tensor", "torch.asarray"}


def _cpu_only(test: ast.expr) -> Optional[str]:
    """Which arm of `if test:` only CPU tensors take: "body", "orelse"
    or None.  Reads `<x>.type == "cpu"` / `!= "cuda"` and the
    reverse."""
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.left, ast.Attribute)
            and test.left.attr == "type"
            and isinstance(test.comparators[0], ast.Constant)):
        return None
    dev, op = test.comparators[0].value, test.ops[0]
    if (dev, type(op)) in (("cpu", ast.Eq), ("cuda", ast.NotEq)):
        return "body"
    if (dev, type(op)) in (("cpu", ast.NotEq), ("cuda", ast.Eq)):
        return "orelse"
    return None


def card_nodes(node: ast.AST) -> Iterator[ast.AST]:
    """`ast.walk` minus what the card never runs: the CPU arm of a
    device test and `raise` statements."""
    todo = [node]
    while todo:
        n = todo.pop()
        if isinstance(n, ast.Raise):
            continue
        yield n
        if isinstance(n, ast.If):
            skip = _cpu_only(n.test)
            todo.append(n.test)
            if skip != "body":
                todo.extend(reversed(n.body))
            if skip != "orelse":
                todo.extend(reversed(n.orelse))
            continue
        todo.extend(reversed(list(ast.iter_child_nodes(n))))


class _Scan:
    """The sync sites of one function's card path."""

    def __init__(self, fn: Function, types: TensorTypes):
        self.fn = fn
        self.sf = fn.sf
        self.types = types
        self.bools: set[str] = set()
        nodes = list(card_nodes(fn.node))
        for _ in range(3):
            for n in nodes:
                if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                        and isinstance(n.targets[0], ast.Name) \
                        and self._is_mask(n.value):
                    self.bools.add(n.targets[0].id)
        self.nodes = nodes

    def _is_mask(self, node: ast.expr) -> bool:
        """A boolean tensor: a comparison of tensors, `~`/`&`/`|` of
        masks, a predicate such as `torch.isfinite`."""
        if isinstance(node, ast.Name):
            return node.id in self.bools
        if isinstance(node, ast.Compare):
            return self.types.is_tensor(node)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self._is_mask(node.operand)
        if isinstance(node, ast.BinOp) \
                and isinstance(node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self._is_mask(node.left) or self._is_mask(node.right)
        if isinstance(node, ast.Call):
            q = self.sf.qualified(node.func) or ""
            if q.startswith("torch.") and q.rpartition(".")[2] in _BOOL_FUNCS:
                return True
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _BOOL_FUNCS \
                    and self.types.is_tensor(node.func.value):
                return True
        return False

    def sites(self) -> Iterator[tuple[ast.AST, str]]:
        t = self.types
        for n in self.nodes:
            if isinstance(n, (ast.If, ast.While, ast.Assert)):
                yield from self._truth(n.test)
            elif isinstance(n, ast.IfExp):
                yield from self._truth(n.test)
            elif isinstance(n, ast.comprehension):
                for cond in n.ifs:
                    yield from self._truth(cond)
            elif isinstance(n, ast.BoolOp):
                for v in n.values[:-1]:
                    if not isinstance(v, (ast.BoolOp, ast.UnaryOp)) \
                            and t.is_tensor(v):
                        yield v, "truth value of a tensor (and/or)"
            elif isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.Not):
                if t.is_tensor(n.operand):
                    yield n, "truth value of a tensor (not)"
            elif isinstance(n, ast.Subscript):
                idx = n.slice.elts if isinstance(n.slice, ast.Tuple) \
                    else [n.slice]
                if t.is_tensor(n.value) and any(self._is_mask(i) for i in idx):
                    yield n, "boolean-mask indexing"
            elif isinstance(n, ast.Call):
                hit = self._call(n)
                if hit is not None:
                    yield n, hit

    def _truth(self, test: ast.expr) -> Iterator[tuple[ast.AST, str]]:
        if isinstance(test, ast.BoolOp):
            for v in test.values:
                yield from self._truth(v)
        elif isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            yield from self._truth(test.operand)
        elif self.types.is_tensor(test):
            yield test, "truth value of a tensor"

    def _call(self, n: ast.Call) -> Optional[str]:
        t = self.types
        f = n.func
        q = self.sf.qualified(f) or ""
        if isinstance(f, ast.Name) and f.id in _CASTS:
            if any(t.is_tensor(a) for a in n.args):
                return f"{f.id}() of a tensor"
            return None
        if q == "torch.is_nonzero":
            return "torch.is_nonzero()"
        if q == "torch.cuda.synchronize" or (
                isinstance(f, ast.Attribute) and f.attr == "synchronize"):
            return ".synchronize()"
        if q in _DATA_SIZED:
            return f"{q}() (data-dependent size)"
        if q == "torch.where" and len(n.args) == 1 and not n.keywords:
            return "one-argument torch.where() (data-dependent size)"
        if q in _HOST_TO_DEVICE:
            dev = call_kwarg(n, "device")
            if dev is not None and not _names_cpu(self.sf, dev):
                return f"{q}(..., device=) (a copy from pageable host memory)"
            return None
        if q in _NUMPY_COPIES and n.args and t.is_tensor(n.args[0]):
            return f"{q.replace('numpy', 'np')}() of a tensor"
        if q == "torch.repeat_interleave":
            reps = n.args[1] if len(n.args) > 1 else (
                n.args[0] if len(n.args) == 1 else call_kwarg(n, "repeats"))
            if reps is not None and call_kwarg(n, "output_size") is None \
                    and t.kind(reps) != SCALAR:
                return "repeat_interleave() without output_size"
            return None
        if not isinstance(f, ast.Attribute):
            return None
        if f.attr in _SYNC_METHODS and t.kind(f.value) != SCALAR \
                and not (f.attr == "cpu" and t.kind(f.value) is not None
                         and t.kind(f.value) in t.classes.classes):
            return f".{f.attr}()"
        if f.attr == "cuda" and t.kind(f.value) != SCALAR:
            return ".cuda() (a copy from pageable host memory)"
        if f.attr == "to" and any(_names_cpu(self.sf, a) for a in
                                  [*n.args, *(k.value for k in n.keywords)]):
            return '.to("cpu")'
        if not t.is_tensor(f.value):
            return None
        if f.attr in _DATA_SIZED_METHODS:
            return f".{f.attr}() (data-dependent size)"
        if f.attr == "repeat_interleave" and call_kwarg(n, "output_size") \
                is None:
            reps = n.args[0] if n.args else call_kwarg(n, "repeats")
            if reps is not None and t.kind(reps) != SCALAR:
                return "repeat_interleave() without output_size"
        return None


def _names_cpu(sf, node: ast.expr) -> bool:
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return isinstance(node, ast.Call) and sf.qualified(node.func) \
        == "torch.device" and bool(node.args) \
        and isinstance(node.args[0], ast.Constant) \
        and node.args[0].value == "cpu"


def closure(project: Project, root: Function) -> list[Function]:
    """`root` and every project function its card path calls, in the
    order found."""
    seen = {root.qualname: root}
    order = [root]
    i = 0
    while i < len(order):
        fn = order[i]
        i += 1
        types = project.types(fn.sf, fn.node, fn.cls)
        for n in card_nodes(fn.node):
            if not isinstance(n, ast.Call):
                continue
            callee = project.resolve_call(fn.sf, n, fn.cls, types)
            if callee is not None and callee.qualname not in seen:
                seen[callee.qualname] = callee
                order.append(callee)
    return order


def sites_of(project: Project, name: str, kind: str = "") -> list[Finding]:
    """The sync sites on `name`'s card path, as unsuppressed findings
    (empty when `name` resolves to no function of the project); `kind`
    names the manifest list in the message."""
    root = project.resolve(name)
    if root is None:
        return []
    out: list[Finding] = []
    seen: set[tuple[str, int, int]] = set()
    for fn in closure(project, root):
        scan = _Scan(fn, project.types(fn.sf, fn.node, fn.cls))
        for node, hit in scan.sites():
            key = (fn.sf.rel, node.lineno, node.col_offset)
            if key in seen:
                continue
            seen.add(key)
            out.append(Finding(
                "RPL003", fn.sf.rel, node.lineno, node.col_offset,
                f"{hit} in `{fn.qualname.rpartition('.')[2]}` waits for the "
                f"device; reached from {kind + ' ' if kind else ''}`{name}`"))
    return out


@rule("RPL003", "host sync on the card path of a function the manifest "
      "declares sync-free (capture candidates: reported by --report)")
def check(project: Project) -> Iterator[Finding]:
    man = project.manifest
    found: dict[tuple[str, int, int], Finding] = {}
    for kind, names in (("sync-free", man.sync_free),
                        ("capture candidate", man.capture_candidates)):
        for name in names:
            if project.resolve(name) is None:
                mod = name.rpartition(".")[0]
                sf = project.modules.get(mod) or project.modules.get(
                    mod.rpartition(".")[0])
                if sf is not None:   # the module is here, the function not
                    yield Finding(
                        "RPL003", sf.rel, 1, 0,
                        f"manifest {kind} `{name}` names no function")
                continue
            for f in sites_of(project, name, kind):
                key = (f.path, f.line, f.col)
                if key not in found:
                    found[key] = dataclasses.replace(
                        f, suppressed=kind != "sync-free")
    yield from found.values()
