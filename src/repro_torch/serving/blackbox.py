"""The black-box boundary: a real model behind `submit(prompt, max_new)`.

Counterpart of `repro.serving.blackbox`.  `BlackBoxProvider` is the API
the paper assumes its client sees: submit a request and get the
completion, nothing of the internals.

The scheduling client lives in `repro_torch.client`: `ClientSession` is
the streaming submit/poll/drain API over an `AsyncProvider`, and
`repro_torch.client.blackbox.AsyncBlackBoxProvider` adapts this
provider behind that protocol.

`ScheduledClient` remains as a thin compatibility shim over
`ClientSession` for the old closed-list `run(requests)` call shape.  It
is DEPRECATED: new code drives a `ClientSession` directly.
"""
from __future__ import annotations

import warnings

import numpy as np

from repro_torch.client import (
    AsyncBlackBoxProvider,
    ClientSession,
    Request,
    SessionConfig,
)
from repro_torch.config import ModelConfig, ServeConfig
from repro_torch.core.policy import PolicyConfig
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


class ScheduledClient:
    """DEPRECATED closed-list shim over `ClientSession`.

    Runs the same three-layer stack (one batched `schedule_batch`
    decision a poll, up to `max_grants` releases) through the streaming
    session: the provider is adapted to the async boundary, so several
    requests ride in flight and idle waits sleep to the next actionable
    instant.  `device` is where the session's pool and tick live (CUDA
    unless the caller names another; the session raises without a
    card).
    """

    def __init__(self, provider, policy: PolicyConfig,
                 max_grants: int = 4, max_workers: int = 4,
                 device=DEFAULT_DEVICE):
        warnings.warn(
            "ScheduledClient is deprecated: drive repro_torch.client."
            "ClientSession over an AsyncProvider instead",
            DeprecationWarning, stacklevel=2)
        self.provider = provider
        self.policy = policy
        self.max_grants = max_grants
        self.max_workers = max_workers
        self.device = device

    def run(self, requests: list[Request],
            time_scale: float = 1.0) -> list[Request]:
        """Executes the whole request list, arrival times honored on the
        scaled wall clock.  The window is sized to the list, so the shim
        never queues behind its own slot pool; the requests are mutated
        in place."""
        async_provider = AsyncBlackBoxProvider(
            self.provider, max_workers=self.max_workers)
        try:
            session = ClientSession(
                async_provider,
                self.policy,
                SessionConfig(
                    window=max(32, len(requests)),
                    max_grants=self.max_grants,
                    time_scale=time_scale,
                ),
                clock="wall",
                device=self.device,
            )
            for r in requests:
                session.submit(r)
            session.drain()
        finally:
            async_provider.shutdown()
        return requests
