"""The black-box boundary: a real model behind `submit(prompt, max_new)`.

Counterpart of `repro.serving.blackbox.BlackBoxProvider`: the API the
paper assumes its client sees, submit a request and get the completion,
nothing of the internals.  The port's client package
(`repro_torch.client`: `ClientSession` over `MockProvider`) exists; the
reference's `ScheduledClient` shim over this provider, its async adapter
and the launcher are still to port (ROADMAP queue A6(b)).
"""
from __future__ import annotations

import numpy as np

from repro_torch.config import ModelConfig, ServeConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.model import Model
from repro_torch.serving.engine import generate


class BlackBoxProvider:
    """A port model behind an opaque submit() API."""

    def __init__(self, model: Model, sc: ServeConfig, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"BlackBoxProvider: model on {model.device}, "
                             f"asked to run on {self.device}")
        self.model, self.sc = model, sc

    @property
    def cfg(self) -> ModelConfig:
        return self.model.cfg

    def submit(self, prompt: np.ndarray, max_new: int) -> np.ndarray:
        """prompt: (S,) token ids -> (max_new,) int32 generated ids."""
        out = generate(self.model, self.sc, np.asarray(prompt)[None],
                       max_new, device=self.device)
        return out[0].cpu().numpy()
