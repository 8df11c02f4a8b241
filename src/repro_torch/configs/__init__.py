"""Architecture registry of the port: `get(name)` -> the exact
`ModelConfig`, `get_smoke(name)` -> the reduced same-family variant the
CPU tests run.

Counterpart of `repro.configs`.  The port carries the dense, state-space
and hybrid architectures its serving path runs; every other name of the
reference's registry raises `KeyError` naming the ROADMAP item that
ports it.
"""
from __future__ import annotations

import importlib

ARCHS = ["stablelm-1.6b", "starcoder2-3b", "mamba2-780m", "hymba-1.5b"]

_MODULES = {
    "stablelm-1.6b": "stablelm_1_6b",
    "starcoder2-3b": "starcoder2_3b",
    "mamba2-780m": "mamba2_780m",
    "hymba-1.5b": "hymba_1_5b",
}

# the reference's other architectures and the queue-A item of ROADMAP.md
# that brings each into the port
NOT_PORTED = {
    "arctic-480b": "A8c (MoE blocks)",
    "phi3.5-moe-42b-a6.6b": "A8c (MoE blocks)",
    "nemotron-4-340b": "A8d (further dense archs and modality prefixes)",
    "qwen1.5-32b": "A8d (further dense archs and modality prefixes)",
    "internvl2-1b": "A8d (further dense archs and modality prefixes)",
    "musicgen-large": "A8d (further dense archs and modality prefixes)",
}


def _mod(name: str):
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet: ROADMAP queue "
                       f"{NOT_PORTED[name]}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str):
    return _mod(name).CONFIG


def get_smoke(name: str):
    return _mod(name).smoke()
