"""Boundaries of the PyTorch port.

* No module of `src/repro_torch/`, and not `chip_smoke.py`, imports
  `jax` or anything of the reference package `repro` (an AST walk, so
  imports inside functions count too).
* Entry points default to CUDA and raise when no card is present,
  unless the caller asks for the CPU: the simulator's, the serving
  path's (`init_model`, `generate`, `BlackBoxProvider`), the live
  client's (`ClientSession`, `ScheduledClient.run`) and the serving
  launcher's `main`.
* The fleet axis is exported under the reference's names
  (`repro_torch.core.routing`, the fleet types and schedules in
  `repro_torch.sim`), and its entry points run on CUDA by default too.
* `params_from_jax` refuses a parameter tree that does not fit the
  config.
* Every kernel package of the port ships its CUDA source, a plain
  `ref.py` with `*_ref` functions, and a test that imports them (the
  port's counterpart of the reference's RPL005 kernel contract).
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge, device
from repro_torch.client import (
    ClientSession,
    MockProvider,
    Request,
    SessionConfig,
)
from repro_torch.config import ServeConfig
from repro_torch.configs import get_smoke
from repro_torch.core.policy import strategy
from repro_torch.models import Model, init_model
from repro_torch.launch import serve as serve_launcher
from repro_torch.serving import BlackBoxProvider, ScheduledClient
from repro_torch.serving import generate as serve_generate
from repro_torch.sim import (
    SimConfig,
    WorkloadConfig,
    generate,
    run_cell,
    run_scenario_cell,
    run_sim,
)
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


@pytest.mark.parametrize("rel", ["client/fleet.py", "client/blackbox.py",
                                 "serving/blackbox.py", "launch/serve.py"])
def test_client_and_launcher_modules_are_checked(rel):
    assert PORT / rel in _port_files()


ZOO_MODULES = ["models/moe.py", "configs/arctic_480b.py",
               "configs/phi35_moe_42b.py", "configs/nemotron_4_340b.py",
               "configs/qwen15_32b.py", "configs/internvl2_1b.py",
               "configs/musicgen_large.py"]


@pytest.mark.parametrize("rel", ZOO_MODULES)
def test_zoo_modules_are_checked(rel):
    assert PORT / rel in _port_files()


def test_registry_is_the_references():
    from repro.configs import ARCHS as REF_ARCHS

    from repro_torch.configs import ARCHS
    assert ARCHS == REF_ARCHS


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
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_scenario_cell(strategy("final_adrr_olc"), "storm", seeds=1,
                          n_requests=8, sim_cfg=SimConfig(n_ticks=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_scenario_cell(strategy("final_adrr_olc"), "fleet_failover",
                          seeds=1, n_requests=8, sim_cfg=SimConfig(n_ticks=2))
    # the live session: CUDA by default, the CPU only when asked
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClientSession(MockProvider(), strategy("final_adrr_olc"),
                      SessionConfig(window=8), clock="virtual")
    sess = ClientSession(MockProvider(), strategy("final_adrr_olc"),
                         SessionConfig(window=8), clock="virtual",
                         device="cpu")
    assert sess.device == torch.device("cpu")
    # the deprecated shim's session and the serving launcher
    with pytest.warns(DeprecationWarning):
        client = ScheduledClient(object(), strategy("final_adrr_olc"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        client.run([Request(rid=0, prompt=None, max_new=2, p50=2.0,
                            bucket=0)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_launcher.main(["--requests", "1"])


def test_fleet_names_match_the_reference():
    import repro.core.routing as rrouting
    import repro.sim as rsim
    from repro.core import types as rtypes

    import repro_torch.sim as psim
    from repro_torch.core import routing, types

    assert routing.UNAVAIL_MS == rrouting.UNAVAIL_MS
    assert callable(routing.route_requests)
    for name in ("Fleet", "FleetDynamics", "FleetPhysics",
                 "uniform_fleet_physics", "build_fleet", "FleetSpec"):
        assert hasattr(psim, name) and hasattr(rsim, name), name
    for name in ("Fleet", "FleetDynamics", "FleetPhysics"):
        assert getattr(psim, name)._fields == getattr(rsim, name)._fields
    for name in ("FleetState", "RequestState", "SimState"):
        assert getattr(types, name)._fields == getattr(rtypes, name)._fields
    assert (types.init_fleet_state(3, 2, torch.device("cpu")).tb_tokens.shape
            == (3, 2))


def test_serving_entry_points_raise_without_cuda(no_cuda):
    cfg = get_smoke("stablelm-1.6b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_model(cfg)
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    sc = ServeConfig(max_seq=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_generate(model, sc, np.zeros((1, 4), np.int32), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BlackBoxProvider(model, sc)
    out = BlackBoxProvider(model, sc, device="cpu").submit(
        np.zeros(4, np.int32), 3)
    assert out.shape == (3,) and out.dtype == np.int32
    # a prefixed model's generate too
    vlm = init_model(get_smoke("internvl2-1b"), torch.Generator(),
                     device="cpu")
    pe = torch.zeros(1, vlm.cfg.prefix_len, vlm.cfg.d_model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_generate(vlm, sc, np.zeros((1, 4), np.int32), 2,
                       prefix_embeds=pe)
    out = serve_generate(vlm, sc, np.zeros((1, 4), np.int32), 2,
                         device="cpu", prefix_embeds=pe)
    assert out.shape == (1, 2)


def _numpy_tree(model):
    """`model`'s parameters as the reference lays them out: nested dicts
    of numpy arrays, the blocks stacked on a leading layer axis."""
    tree = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        arr = p.detach().numpy()
        if parts[0] == "blocks":
            if parts[1] != "0":
                continue
            parts = ["blocks"] + parts[2:]
            arr = np.stack([arr] * len(model.blocks))
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = arr
    return tree


def test_params_from_jax_rejects_a_tree_of_other_shapes():
    cfg = dataclasses.replace(get_smoke("starcoder2-3b"), dtype="float32")
    tree = _numpy_tree(init_model(cfg, torch.Generator().manual_seed(1),
                                  device="cpu"))
    model = bridge.params_from_jax(tree, cfg, device="cpu")
    assert isinstance(model, Model)
    tree["blocks"]["mlp"]["wi"]["w"] = tree["blocks"]["mlp"]["wi"]["w"][:, 1:]
    with pytest.raises(ValueError, match="mlp/wi/w"):
        bridge.params_from_jax(tree, cfg, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        bridge.params_from_jax(
            _numpy_tree(model), dataclasses.replace(cfg, n_layers=3),
            device="cpu")


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
