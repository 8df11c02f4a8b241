"""Boundaries of the PyTorch port.

* No module of `src/repro_torch/`, and not `chip_smoke.py`, imports
  `jax` or anything of the reference package `repro` (an AST walk, so
  imports inside functions count too).
* Entry points default to CUDA and raise when no card is present,
  unless the caller asks for the CPU.
* Every kernel package of the port ships its CUDA source, a plain
  `ref.py` with `*_ref` functions, and a test that imports them (the
  port's counterpart of the reference's RPL005 kernel contract).
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge, device
from repro_torch.core.policy import strategy
from repro_torch.sim import SimConfig, WorkloadConfig, generate, run_cell, run_sim
from repro_torch.sim.provider import default_physics

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_files():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 15
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_neither_jax_nor_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_run_cell_without_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_cell(strategy("final_adrr_olc"), WorkloadConfig(n_requests=8),
                 seeds=1, sim_cfg=SimConfig(n_ticks=2))


def test_other_entry_points_raise_without_cuda(no_cuda):
    with pytest.raises(RuntimeError):
        generate(WorkloadConfig(n_requests=8))
    with pytest.raises(RuntimeError):
        bridge.from_numpy(np.zeros(3, np.float32))
    batch, jitter = generate(WorkloadConfig(n_requests=8), device="cpu")
    with pytest.raises(RuntimeError):
        run_sim(strategy("final_adrr_olc"), batch, jitter, default_physics(),
                SimConfig(n_ticks=2))


def test_cpu_is_allowed_explicitly(no_cuda):
    assert device.resolve_device("cpu") == torch.device("cpu")
    m = run_cell(strategy("final_adrr_olc"), WorkloadConfig(n_requests=8),
                 seeds=1, sim_cfg=SimConfig(n_ticks=4), device="cpu")
    assert m.completion_rate.shape == (1,)


def test_bridge_rejects_inexact_dtypes():
    with pytest.raises(TypeError):
        bridge.from_numpy(np.zeros(3, np.float64), device="cpu")


@pytest.mark.parametrize("pkg", sorted(
    p.name for p in (PORT / "kernels").iterdir()
    if p.is_dir() and (p / "__init__.py").is_file()))
def test_kernel_package_contract(pkg):
    d = PORT / "kernels" / pkg
    assert list(d.glob("*.cu")), f"{pkg} has no CUDA source"
    ref = ast.parse((d / "ref.py").read_text(encoding="utf-8"))
    refs = {n.name for n in ast.walk(ref)
            if isinstance(n, ast.FunctionDef) and n.name.endswith("_ref")}
    assert refs, f"{pkg}/ref.py defines no *_ref function"
    mod = f"repro_torch.kernels.{pkg}"
    tested = False
    for test in (ROOT / "tests").glob("test_torch_*.py"):
        for name in _imported_modules(test):
            tested |= name == mod or name.startswith(mod + ".")
    assert tested, f"no test_torch_*.py imports {mod}"
