"""Serving on the port's models: the engine and the black-box provider
(counterpart of `repro.serving`)."""
from repro_torch.serving.blackbox import BlackBoxProvider  # noqa: F401
from repro_torch.serving.engine import GenState, generate  # noqa: F401
