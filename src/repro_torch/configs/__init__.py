"""Architecture registry of the port: `get(name)` -> the exact
`ModelConfig`, `get_smoke(name)` -> the reduced same-family variant the
CPU tests run.

Counterpart of `repro.configs`: the same ten architectures, in the same
order, each module a field-for-field copy of the reference's.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "nemotron-4-340b",
    "internvl2-1b",
    "starcoder2-3b",
    "mamba2-780m",
    "arctic-480b",
    "phi3.5-moe-42b-a6.6b",
    "hymba-1.5b",
    "qwen1.5-32b",
    "stablelm-1.6b",
    "musicgen-large",
]

_MODULES = {
    "nemotron-4-340b": "nemotron_4_340b",
    "internvl2-1b": "internvl2_1b",
    "starcoder2-3b": "starcoder2_3b",
    "mamba2-780m": "mamba2_780m",
    "arctic-480b": "arctic_480b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "hymba-1.5b": "hymba_1_5b",
    "qwen1.5-32b": "qwen15_32b",
    "stablelm-1.6b": "stablelm_1_6b",
    "musicgen-large": "musicgen_large",
}


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str):
    return _mod(name).CONFIG


def get_smoke(name: str):
    return _mod(name).smoke()
