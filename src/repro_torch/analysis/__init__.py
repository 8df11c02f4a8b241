"""The port's lint: the reference's six rules with their PyTorch/CUDA
meaning, and the docs gate.

Counterpart of `repro.analysis`.  Entry point: ``python -m
repro_torch.analysis.lint src/repro_torch tests chip_smoke.py tools``.
Rules live in `repro_torch.analysis.rules`; configuration in
`manifest.toml` beside this file.  The lint itself imports only the
standard library (importing the package runs `repro_torch/__init__.py`,
which imports torch).
"""
from repro_torch.analysis.walker import Finding, SourceFile

__all__ = ["Finding", "SourceFile"]
