"""The port's lint (`repro_torch.analysis`) against the reference's.

* Parity: where a rule's meaning is unchanged (RPL001 pinned floats,
  RPL006 imports), both packages read the same fixture trees and must
  give the same findings (rule, path, line, suppressed); so must each
  package's own suppression marker, the manifest's fallback TOML parser
  (and tomllib) on the same text, the CLI's exit codes 0/1/2 and the
  docs gate's path and module checks.  Where the port's meaning differs
  by design (a torch reduction, its extra pinned names), the difference
  is asserted as such.
* Torch fixtures for RPL002-RPL005, whose meaning is the port's own: a
  catch and a clean pass each, at least as many cases as the
  reference's classes have.
* The real tree: the port's lint over `src/repro_torch tests
  chip_smoke.py tools` finds nothing, `--list-rules` names all six
  rules, the docs gate passes, and the manifest's functions resolve.
"""
import os
import subprocess
import sys
import textwrap
import tomllib
from pathlib import Path

import pytest

import repro.analysis.rules  # noqa: F401  (registers the reference's rules)
import repro_torch.analysis.rules  # noqa: F401  (registers the port's rules)
from repro.analysis import docs_check as ref_docs
from repro.analysis import lint as ref_lint
from repro.analysis import manifest as ref_manifest
from repro.analysis.registry import Project as RefProject
from repro.analysis.walker import SourceFile as RefSourceFile
from repro_torch.analysis import docs_check, lint, manifest
from repro_torch.analysis.registry import Project
from repro_torch.analysis.rules import rpl003_hostsync, rpl005_kernels
from repro_torch.analysis.walker import SourceFile

ROOT = Path(__file__).resolve().parents[1]


def _write(tmp_path, files):
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text), encoding="utf-8")


def _port(tmp_path, files, **overrides):
    _write(tmp_path, files)
    sfs = [SourceFile(tmp_path / rel, rel) for rel in files
           if rel.endswith(".py")]
    return Project(root=tmp_path, files=sfs,
                   manifest=manifest.manifest_for_tests(**overrides))


def _ref(tmp_path, files, **overrides):
    _write(tmp_path, files)
    sfs = [RefSourceFile(tmp_path / rel, rel) for rel in files
           if rel.endswith(".py")]
    return RefProject(root=tmp_path, files=sfs,
                      manifest=ref_manifest.manifest_for_tests(**overrides))


def _keys(findings):
    return [(f.rule, f.path, f.line, f.suppressed) for f in findings]


def _active(project, rule_id):
    return [f for f in project.run(only={rule_id}) if not f.suppressed]


def _both(tmp_path, files, rule_id, **overrides):
    """The two packages' findings of `rule_id` on one fixture tree."""
    ref = _ref(tmp_path / "ref", files, **overrides).run(only={rule_id})
    port = _port(tmp_path / "port", files, **overrides).run(only={rule_id})
    return _keys(ref), _keys(port)


# ---------------------------------------------------------------------------
# Parity: RPL001, RPL006, suppression
# ---------------------------------------------------------------------------

_CRITICAL = dict(critical_modules=["core/engine.py"],
                 sensitive_names=["sev", "scores", "score", "ema"])

RPL001_CASES = {
    "numpy_reduction": ("core/engine.py", """\
        import numpy as np

        def overload(scores):
            sev = np.sum(scores)
            return sev
        """, [4]),
    "method_reduction_and_fma": ("core/engine.py", """\
        def update(ema, x, alpha):
            ema = ema.mean()
            score = alpha * x + ema
            return score
        """, [2, 3]),
    "inside_pinned": ("core/engine.py", """\
        import numpy as np
        from core.numerics import pinned

        def overload(scores, alpha, x, ema):
            sev = pinned(np.mean(scores))
            score = pinned(alpha * x + ema)
            return sev + score
        """, []),
    "outside_critical_module": ("sim/other.py", """\
        import numpy as np

        def overload(scores):
            return np.sum(scores)
        """, []),
    "counting_sum": ("core/engine.py", """\
        def count(elig):
            n = elig.sum()
            return n
        """, []),
    "sensitive_target": ("core/engine.py", """\
        def mix(a, b, c):
            sev = a * b - c
            return sev
        """, [2]),
}


@pytest.mark.parametrize("case", sorted(RPL001_CASES))
def test_rpl001_same_findings_as_reference(tmp_path, case):
    rel, text, lines = RPL001_CASES[case]
    ref, port = _both(tmp_path, {rel: text}, "RPL001", **_CRITICAL)
    assert port == ref
    assert [k[2] for k in port] == lines


def test_rpl001_torch_reduction_is_the_ports_own(tmp_path):
    """`torch.sum` is a reduction to the port, an unknown call to the
    reference (queue C lists this difference)."""
    files = {"core/engine.py": """\
        import torch

        def overload(scores):
            sev = torch.sum(scores)
            return sev
        """}
    ref, port = _both(tmp_path, files, "RPL001", **_CRITICAL)
    assert ref == [] and [k[2] for k in port] == [4]


def test_rpl001_port_pinned_names(tmp_path):
    """The port's manifest pins through `fma32` and `sum32` too."""
    files = {"core/engine.py": """\
        from core.numerics import fma32, sum32

        def tail(scores, alpha, x, ema):
            sev = sum32(scores.sum())
            score = fma32(alpha * x + ema, 1.0, 0.0)
            return sev, score
        """}
    p = _port(tmp_path, files, pinned_names=["pinned", "fma32", "sum32"],
              **_CRITICAL)
    assert _active(p, "RPL001") == []
    real = manifest.load_manifest(ROOT)
    assert set(real.pinned_names) == {"pinned", "fma32", "sum32"}


RPL006_CASES = {
    "unused_and_duplicate": ("m.py", """\
        import os
        import sys
        import os

        print(sys.argv)
        """, [1, 3, 3]),
    "noqa_on_name_line": ("m.py", """\
        from os import (  # noqa: F401
            path,
        )
        from sys import (
            argv,  # noqa: F401
        )
        """, []),
    "init_without_all": ("pkg/__init__.py", "from os import path\n", []),
    "all_counts_as_use": ("pkg/mod.py", """\
        from os import sep

        __all__ = ["sep"]
        """, []),
    "torch_alias_unused": ("m.py", """\
        import torch
        import torch.nn.functional as F

        def f(x):
            return torch.relu(x)
        """, [2]),
}


@pytest.mark.parametrize("case", sorted(RPL006_CASES))
def test_rpl006_same_findings_as_reference(tmp_path, case):
    rel, text, lines = RPL006_CASES[case]
    ref, port = _both(tmp_path, {rel: text}, "RPL006")
    assert port == ref
    assert [k[2] for k in port] == lines


_SUPPRESS_CASE = """\
    import numpy as np

    def overload(scores):
        sev = np.sum(scores)  # {marker}: disable={rule}
        return sev
    """
_SUPPRESS_FILE_CASE = """\
    # {marker}: disable-file={rule}
    import numpy as np

    def overload(scores):
        sev = np.sum(scores)
        return sev
    """


@pytest.mark.parametrize("template", [_SUPPRESS_CASE, _SUPPRESS_FILE_CASE],
                         ids=["line", "file"])
@pytest.mark.parametrize("rule_id, suppressed",
                         [("RPL001", True), ("RPL002", False)])
def test_suppression_by_each_packages_own_marker(tmp_path, template,
                                                 rule_id, suppressed):
    ref = _ref(tmp_path / "ref", {"core/engine.py": template.format(
        marker="reprolint", rule=rule_id)}, **_CRITICAL)
    port = _port(tmp_path / "port", {"core/engine.py": template.format(
        marker="reprolint-torch", rule=rule_id)}, **_CRITICAL)
    assert _keys(port.run(only={"RPL001"})) == \
        _keys(ref.run(only={"RPL001"})) == \
        [("RPL001", "core/engine.py", 5 if template is _SUPPRESS_FILE_CASE
          else 4, suppressed)]


@pytest.mark.parametrize("marker, port_silenced", [
    ("reprolint", False), ("reprolint-torch", True)])
def test_markers_do_not_cross(tmp_path, marker, port_silenced):
    """The reference's marker leaves the port's rule of the same number
    on, and the port's leaves the reference's on."""
    text = _SUPPRESS_CASE.format(marker=marker, rule="RPL001")
    ref = _ref(tmp_path / "ref", {"core/engine.py": text}, **_CRITICAL)
    port = _port(tmp_path / "port", {"core/engine.py": text}, **_CRITICAL)
    assert (_active(port, "RPL001") == []) is port_silenced
    assert (_active(ref, "RPL001") == []) is not port_silenced


# ---------------------------------------------------------------------------
# Parity: the manifest's parsers, the CLI, the docs gate
# ---------------------------------------------------------------------------

def _pyproject_table():
    text = (ROOT / "pyproject.toml").read_text(encoding="utf-8")
    start = text.index("[tool.reprolint]")
    end = text.find("\n[", text.index("[tool.reprolint.donating"))
    return text[start:] if end < 0 else text[start:end]


MANIFEST_TEXTS = {
    "port_manifest": lambda: (ROOT / manifest.MANIFEST).read_text("utf-8"),
    "reference_table": _pyproject_table,
}


@pytest.mark.parametrize("name", sorted(MANIFEST_TEXTS))
def test_fallback_parser_matches_reference_and_tomllib(name):
    text = MANIFEST_TEXTS[name]()
    got = manifest._fallback_parse(text)
    assert got == ref_manifest._fallback_parse(text) == tomllib.loads(text)


def test_port_manifest_loads():
    man = manifest.load_manifest(ROOT)
    assert man.kernels_root == "src/repro_torch/kernels"
    assert man.kernel_test_glob == "tests/test_torch_*.py"
    assert "src/repro_torch/sim/engine.py" in man.critical_modules
    assert man.sensitive_names == ref_manifest.load_manifest(
        ROOT).sensitive_names
    assert "repro_torch.sim.engine.sim_tick" in man.sync_free
    assert man.static_callables[
        "repro_torch.kernels.sched_score.ops.sched_score_topb"] == ("b",)


def test_defaults_without_manifest(tmp_path):
    man = manifest.load_manifest(tmp_path)
    assert man.critical_modules == () and man.sync_free == ()
    assert man.pinned_names == ("pinned",)


_CLI_TREES = {
    "clean": ({"m.py": "import os\n\nprint(os.sep)\n"}, ["m.py"], 0),
    "violation": ({"m.py": "import os\nimport sys\n\nprint(os.sep)\n"},
                  ["m.py"], 1),
    "missing_path": ({"m.py": "print(1)\n"}, ["nope"], 2),
}


@pytest.mark.parametrize("tree", sorted(_CLI_TREES))
def test_cli_exit_codes_match_reference(tmp_path, tree, capsys):
    files, paths, want = _CLI_TREES[tree]
    _write(tmp_path, {**files, "pyproject.toml": "[tool.reprolint]\n"})
    args = ["--root", str(tmp_path), *paths]
    assert ref_lint.run(args) == lint.run(args) == want
    out = capsys.readouterr().out
    if want == 1:
        assert out.count("RPL006") == 2   # one line from each CLI


DOC_TEXT = """\
## The PyTorch + CUDA port

`src/repro_torch/sim/engine.py`, `src/repro_torch/sim/nope.py`,
`src/repro_torch/kernels/`, `tools/train_100m.py`, `tools/nope.py`,
`tests/test_torch_core.py`, `tests/test_torch_nope.py`,
`tests/test_torch_*.py`, `repro_torch.sim.engine`, `repro_torch.nope`,
`repro_torch.configs.get`, `repro_torch.configs.nope`, `repro.sim.engine`,
`python3 chip_smoke.py --only=sync_free,session`, `--only=nope`.

## Another section

`src/repro_torch/other_nope.py`
"""


def test_docs_paths_agree_with_reference_regex():
    """Where both gates read a path (`src/...`), they agree on which
    exist; each reads its own package's modules."""
    ref_paths = set(ref_docs._PATH_RE.findall(DOC_TEXT))
    port_paths = set(docs_check._PATH_RE.findall(DOC_TEXT))
    shared = {p for p in ref_paths & port_paths if p.startswith("src/")}
    assert shared == {"src/repro_torch/sim/engine.py",
                      "src/repro_torch/sim/nope.py",
                      "src/repro_torch/kernels/",
                      "src/repro_torch/other_nope.py"}
    for p in shared:
        assert (ROOT / p).exists() == docs_check.path_exists(ROOT, p)
    ref_mods = set(ref_docs._MODULE_RE.findall(DOC_TEXT))
    port_mods = set(docs_check._MODULE_RE.findall(DOC_TEXT))
    assert ref_mods == {"repro.sim.engine"}
    assert "repro.sim.engine" not in port_mods
    assert ref_docs._module_exists("repro.sim.engine")
    assert docs_check.module_exists(ROOT, "repro_torch.sim.engine")


def test_docs_stale_claims():
    stale = docs_check.check_text(ROOT, "README.md", DOC_TEXT)
    assert sorted(stale) == sorted([
        "README.md: path `src/repro_torch/sim/nope.py` does not exist",
        "README.md: path `tools/nope.py` does not exist",
        "README.md: path `tests/test_torch_nope.py` does not exist",
        "README.md: module `repro_torch.nope` does not exist",
        "README.md: module `repro_torch.configs.nope` does not exist",
        "README.md: `--only=nope` is no phase of chip_smoke.py's "
        "SELECTABLE",
    ])


def test_docs_gate_passes_on_the_repo():
    assert docs_check.check() == []
    assert "sync_free" in docs_check.selectable(ROOT)


# ---------------------------------------------------------------------------
# RPL002 — use after an in-place hand-off
# ---------------------------------------------------------------------------

RPL002_CASES = {
    "read_after_copy_into": ("""\
        import torch

        def fill(buf, x):
            buf.copy_(x)
            return buf

        def step(buf, x):
            out = fill(buf, x)
            return out, buf.sum()
        """, {}, [9]),
    "rebound_from_result": ("""\
        import torch

        def fill(buf, x):
            buf.copy_(x)
            return buf

        def step(buf, x):
            buf = fill(buf, x)
            return buf.sum()
        """, {}, []),
    "loop_without_rebind": ("""\
        def bump(acc, x):
            acc.add_(x)
            return acc

        def run(acc, xs):
            for x in xs:
                total = acc.sum()
                out = bump(acc, x)
            return out, total
        """, {}, [7, 8]),
    "loop_with_rebind": ("""\
        def bump(acc, x):
            acc.add_(x)
            return acc

        def run(acc, xs):
            for x in xs:
                acc = bump(acc, x)
            return acc
        """, {}, []),
    "manifest_callable": ("""\
        class Session:
            def poll(self):
                out = self._replay(self._pool)
                return out, self._pool.shape
        """, {"self._replay": [0]}, [4]),
    "tuple_rebind": ("""\
        def fill(buf, x):
            buf[0] = x
            return x, buf

        def step(buf: "torch.Tensor", x):
            out, buf = fill(buf, x)
            return out, buf
        """, {}, []),
    "out_argument": ("""\
        import torch

        def add_into(a, b, dst):
            torch.add(a, b, out=dst)
            return dst

        def step(a, b, dst):
            add_into(a, b, dst)
            return dst
        """, {}, [9]),
    "cache_field_write": ("""\
        from typing import NamedTuple

        import torch

        class KV(NamedTuple):
            k: torch.Tensor
            v: torch.Tensor

        def write(cache: KV, slot: int, k):
            cache.k[:, slot] = k
            return cache

        def step(cache: KV, k):
            write(cache, 3, k)
            return cache.v
        """, {}, [15]),
    "dict_filled_for_caller": ("""\
        def collect(out, items):
            for i in items:
                out[i] = i
            return len(out)

        def run(items):
            seen = {}
            collect(seen, items)
            return seen
        """, {}, []),
}


@pytest.mark.parametrize("case", sorted(RPL002_CASES))
def test_rpl002(tmp_path, case):
    text, mutating, lines = RPL002_CASES[case]
    p = _port(tmp_path, {"m.py": text}, mutating_callables=mutating)
    assert [f.line for f in _active(p, "RPL002")] == lines


def test_rpl002_manifest_resolves_across_modules(tmp_path):
    """A writing callable named by its definition's qualified name is
    found through a package re-export."""
    p = _port(tmp_path, {
        "src/pkg/__init__.py": "from pkg.model import decode  # noqa: F401\n",
        "src/pkg/model.py": """\
            def decode(tok, caches):
                return tok, caches
            """,
        "src/pkg/serve.py": """\
            from pkg import decode

            def loop(toks, caches):
                for t in toks:
                    decode(t, caches)
                return caches
            """,
    }, mutating_callables={"pkg.model.decode": [1]})
    assert [(f.path, f.line) for f in _active(p, "RPL002")] == [
        ("src/pkg/serve.py", 5), ("src/pkg/serve.py", 6)]


# ---------------------------------------------------------------------------
# RPL003 — host syncs in sync-free functions
# ---------------------------------------------------------------------------

_RPL003_TREE = {
    "src/pkg/__init__.py": "",
    "src/pkg/helpers.py": """\
        import torch

        def live(mask: torch.Tensor):
            return torch.nonzero(mask)

        def clean(x: torch.Tensor, n: int):
            return x[:n] * x.shape[0]
        """,
    "src/pkg/tick.py": """\
        from typing import NamedTuple, Optional

        import torch
        from torch import nn

        from pkg.helpers import clean, live


        class State(NamedTuple):
            now: torch.Tensor
            k: int


        class Head(nn.Module):
            def forward(self, x):
                return x.cpu()


        class Model(nn.Module):
            def __init__(self):
                super().__init__()
                self.head = Head()

            def step(self, x):
                return self.head(x)


        def item_read(x: torch.Tensor):
            return x.sum().item()

        def branchy(state: State, x: torch.Tensor):
            if state.k > 1 and state.now > 0:
                x = x + 1
            return float(x.max())

        def cross_module(x: torch.Tensor):
            return live(x > 0)

        def static_only(x: torch.Tensor, state: State, n: int,
                        win: Optional[torch.Tensor] = None):
            if win is not None and x.shape[0] > n and state.k:
                x = clean(x, int(n))
            if x.device.type == "cpu":
                return x.tolist()
            if x.numel() == 0:
                raise ValueError(f"empty: {x.sum().item()}")
            return x[: len(x)]

        def data_sized(x: torch.Tensor, r: torch.Tensor):
            m = x > 0
            a = x[m]
            b = torch.where(m)
            c = x.repeat_interleave(r)
            d = x.repeat_interleave(r, output_size=8)
            e = torch.tensor([1.0], device=x.device)
            torch.cuda.synchronize()
            return a, b, c, d, e

        def module_call(model: Model, x: torch.Tensor):
            return model.step(x)
        """,
}

RPL003_CASES = {
    "item": ("pkg.tick.item_read", [("src/pkg/tick.py", 29)]),
    "truth_value_and_cast": ("pkg.tick.branchy", [
        ("src/pkg/tick.py", 32), ("src/pkg/tick.py", 34)]),
    "cross_module_callee": ("pkg.tick.cross_module",
                            [("src/pkg/helpers.py", 4)]),
    "static_reads_cpu_branch_raise": ("pkg.tick.static_only", []),
    "data_sized_and_copies": ("pkg.tick.data_sized", [
        ("src/pkg/tick.py", 51), ("src/pkg/tick.py", 52),
        ("src/pkg/tick.py", 53), ("src/pkg/tick.py", 55),
        ("src/pkg/tick.py", 56)]),
    "module_forward": ("pkg.tick.module_call", [("src/pkg/tick.py", 16)]),
}


@pytest.mark.parametrize("case", sorted(RPL003_CASES))
def test_rpl003_sync_free(tmp_path, case):
    name, sites = RPL003_CASES[case]
    p = _port(tmp_path, _RPL003_TREE, sync_free=[name])
    got = [(f.path, f.line) for f in _active(p, "RPL003")]
    assert sorted(got) == sorted(sites)
    assert [(f.path, f.line) for f in rpl003_hostsync.sites_of(p, name)] \
        == got


def test_rpl003_capture_candidate_is_reported_not_an_error(tmp_path):
    p = _port(tmp_path, _RPL003_TREE,
              capture_candidates=["pkg.tick.cross_module"])
    fs = p.run(only={"RPL003"})
    assert [(f.line, f.suppressed) for f in fs] == [(4, True)]
    assert "capture candidate" in fs[0].message


def test_rpl003_sync_free_wins_over_capture_candidate(tmp_path):
    p = _port(tmp_path, _RPL003_TREE, sync_free=["pkg.tick.cross_module"],
              capture_candidates=["pkg.tick.cross_module"])
    assert [f.suppressed for f in p.run(only={"RPL003"})] == [False]


def test_rpl003_manifest_names_no_function(tmp_path):
    p = _port(tmp_path, _RPL003_TREE, sync_free=["pkg.tick.gone"])
    fs = _active(p, "RPL003")
    assert len(fs) == 1 and "names no function" in fs[0].message


def test_rpl003_reports_through_cli(tmp_path, capsys):
    _write(tmp_path, _RPL003_TREE)
    (tmp_path / manifest.MANIFEST).parent.mkdir(parents=True)
    (tmp_path / manifest.MANIFEST).write_text(
        'capture-candidates = ["pkg.tick.item_read"]\n')
    args = ["--root", str(tmp_path), "--select", "RPL003", "src"]
    assert lint.run(args) == 0
    assert "RPL003" not in capsys.readouterr().out
    assert lint.run([*args, "--report"]) == 0
    assert "src/pkg/tick.py:29" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# RPL004 — static host values
# ---------------------------------------------------------------------------

_RPL004_OPS = """\
    import functools

    import torch

    def topb(scores, b: int, window=[0]):
        return scores[:b]

    @functools.lru_cache(maxsize=None)
    def plan(B: int, S: int):
        return B * S
    """

RPL004_CASES = {
    "list_to_static_name": ("""\
        from pkg.ops import topb

        def f(x):
            return topb(x, b=[4])
        """, [("src/pkg/use.py", 4)]),
    "tensor_positional": ("""\
        import torch
        from pkg import ops

        def f(x: torch.Tensor, k: torch.Tensor):
            return ops.topb(x, k.sum()), ops.topb(x, torch.tensor(3))
        """, [("src/pkg/use.py", 5), ("src/pkg/use.py", 5)]),
    "cached_function": ("""\
        import torch
        from pkg.ops import plan

        def f(x: torch.Tensor):
            return plan({"B": 1}, x.sum())
        """, [("src/pkg/use.py", 5), ("src/pkg/use.py", 5)]),
    "ints_and_tuples": ("""\
        import torch
        from pkg.ops import plan, topb

        def f(x: torch.Tensor, n: int):
            return topb(x, int(n)), topb(x, x.shape[0]), plan(2, (3, 4))
        """, []),
}


@pytest.mark.parametrize("case", sorted(RPL004_CASES))
def test_rpl004(tmp_path, case):
    text, sites = RPL004_CASES[case]
    p = _port(tmp_path, {"src/pkg/__init__.py": "",
                         "src/pkg/ops.py": _RPL004_OPS,
                         "src/pkg/use.py": text},
              static_callables={"pkg.ops.topb": ["b"]})
    got = [(f.path, f.line) for f in _active(p, "RPL004")
           if f.path != "src/pkg/ops.py"]
    assert got == sites


def test_rpl004_unhashable_default(tmp_path):
    p = _port(tmp_path, {"src/pkg/__init__.py": "",
                         "src/pkg/ops.py": _RPL004_OPS},
              static_callables={"pkg.ops.topb": ["b", "window"]})
    fs = _active(p, "RPL004")
    assert [(f.path, f.line) for f in fs] == [("src/pkg/ops.py", 5)]
    assert "window" in fs[0].message


# ---------------------------------------------------------------------------
# RPL005 — the CUDA kernel contract
# ---------------------------------------------------------------------------

_KERNELS = dict(kernels_root="src/kp/kernels",
                kernel_test_glob="tests/test_torch_*.py")
_BUILD = """\
    from pathlib import Path

    KERNELS_DIR = Path(__file__).parent
    SOURCES = {
        "foo": KERNELS_DIR / "foo" / "foo.cu",
    }
    """
_OPS = """\
    from kp.kernels import _build

    def _lib():
        return _build.load("foo", {})

    def foo(x):
        _build.refuse_autograd("foo", x)
        lib = _lib()
        rc = lib.foo_fwd(x)
        _build.check_rc(lib, rc, "foo")
        return x
    """
_CU = """\
    constexpr int NT = 128;
    __global__ void __launch_bounds__(NT) foo_kernel(float* x) {
      float acc = 0.f;  // accumulates in float32
      acc += x[threadIdx.x];
      __nv_bfloat16 out = __float2bfloat16(acc);
      x[0] = __bfloat162float(out);
    }
    """
_TEST = "from kp.kernels.foo.ref import foo_ref  # noqa: F401\n"


def _kernel_tree(**over):
    files = {"src/kp/kernels/_build.py": _BUILD,
             "src/kp/kernels/foo/__init__.py": "",
             "src/kp/kernels/foo/foo.cu": _CU,
             "src/kp/kernels/foo/ref.py": "def foo_ref(x):\n    return x\n",
             "src/kp/kernels/foo/ops.py": _OPS,
             "tests/test_torch_foo.py": _TEST}
    files.update(over)
    return {k: v for k, v in files.items() if v is not None}


RPL005_CASES = {
    "full_contract": ({}, []),
    "reexported_ref": ({"src/kp/kernels/foo/ref.py":
                        "from kp.models import foo_ref  # noqa: F401\n"}, []),
    "missing_ref": ({"src/kp/kernels/foo/ref.py": None}, ["no ref.py"]),
    "ref_without_plain_version": (
        {"src/kp/kernels/foo/ref.py": "def foo(x):\n    return x\n"},
        ["defines no `*_ref`"]),
    "no_test": ({"tests/test_torch_foo.py": "import math\n"},
                ["no tests/test_torch_*.py imports `kp.kernels.foo`"]),
    "source_not_built": ({"src/kp/kernels/_build.py":
                          _BUILD.replace('"foo" / "foo.cu"', '"foo" / "x.cu"')},
                         ["not in `_build.SOURCES`"]),
    "no_source": ({"src/kp/kernels/foo/foo.cu": None}, ["no CUDA source"]),
    "wrapper_unguarded_and_unchecked": (
        {"src/kp/kernels/foo/ops.py": _OPS.replace(
            '_build.refuse_autograd("foo", x)', "pass").replace(
            '_build.check_rc(lib, rc, "foo")', "lib.foo_fwd(x)")},
        ["never calls `_build.refuse_autograd`", "no `check_rc` reads",
         "no `check_rc` reads"]),
    "launch_bounds_and_half_accumulator": (
        {"src/kp/kernels/foo/foo.cu": _CU.replace("NT = 128", "NT = 100")
         + "__device__ void g(__half* p) {\n  __half h = p[0];\n"
           "  h += p[1];\n  __nv_bfloat16 s = p[2];\n"
           "  s = __hfma(p[3], p[4], s);\n  p[0] = h;\n}\n"},
        ["100 threads", "`h` is half precision", "`s` is half precision"]),
}


@pytest.mark.parametrize("case", sorted(RPL005_CASES))
def test_rpl005(tmp_path, case):
    over, wants = RPL005_CASES[case]
    files = _kernel_tree(**over)
    p = _port(tmp_path, files, **_KERNELS)
    msgs = sorted(f.message for f in _active(p, "RPL005"))
    assert len(msgs) == len(wants), msgs
    for want in wants:
        assert any(want in m for m in msgs), (want, msgs)


def test_rpl005_holds_the_real_kernels():
    """Every kernel package of the port keeps the contract, and the rule
    reads every `.cu` there (a seeded bound of 96 passes, 100 fails)."""
    for cu in (ROOT / "src/repro_torch/kernels").glob("*/*.cu"):
        text = cu.read_text(encoding="utf-8")
        assert list(rpl005_kernels.check_cu(cu.name, text)) == []
        assert "__launch_bounds__" in text
    assert list(rpl005_kernels.check_cu(
        "x.cu", "__launch_bounds__(96) void k();")) == []
    assert len(list(rpl005_kernels.check_cu(
        "x.cu", "#define T 100\n__launch_bounds__(T) void k();"))) == 1


# ---------------------------------------------------------------------------
# The real tree
# ---------------------------------------------------------------------------

def _run_cli(args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)


def test_zero_on_real_tree():
    r = _run_cli(["src/repro_torch", "tests", "chip_smoke.py", "tools"])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "reprolint-torch: 0 finding(s)" in r.stdout


def test_list_rules_names_all_six(capsys):
    assert lint.run(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in ("RPL001", "RPL002", "RPL003", "RPL004", "RPL005",
                "RPL006"):
        assert rid in out


def test_manifest_functions_resolve_on_the_real_tree():
    """Every function the manifest names is one of the port's, and the
    sync-free ones reach the kernel wrappers they launch."""
    p = lint.build_project(ROOT, [ROOT / "src" / "repro_torch"])
    man = p.manifest
    for name in (*man.sync_free, *man.capture_candidates,
                 *man.static_callables):
        assert p.resolve(name) is not None, name
    for name in man.mutating_callables:
        assert p.resolve(name) is not None, name
    reach = {n: {f.qualname for f in rpl003_hostsync.closure(
        p, p.resolve(n))} for n in man.sync_free}
    topb = "repro_torch.kernels.sched_score.ops.sched_score_topb"
    assert topb in reach["repro_torch.sim.engine.sim_tick"]
    assert topb in reach["repro_torch.client.session._fused_tick"]
    assert "repro_torch.kernels.decode_attention.ops.decode_attention" \
        in reach["repro_torch.models.model.decode_step"]
    # the capture candidate's designed pull: a site the rule must see
    poll = "repro_torch.client.session.ClientSession.poll"
    assert poll in man.capture_candidates
    assert any(".numpy()" in f.message
               for f in rpl003_hostsync.sites_of(p, poll))
