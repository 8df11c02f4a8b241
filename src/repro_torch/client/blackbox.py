"""A real model behind the `AsyncProvider` protocol.

Counterpart of `repro.client.blackbox`.  `AsyncBlackBoxProvider` adapts
any object with the blocking `submit(prompt, max_new) -> output` surface
(`repro_torch.serving.BlackBoxProvider` over a port model, or any
stand-in) into the session's non-blocking boundary: submissions run on
a small thread pool, `poll` harvests finished futures, and `inflight()`
is the true outstanding count, so a `ClientSession` keeps several
requests in flight against the model instead of bracketing one
blocking call at a time.

An optional `max_inflight` turns the adapter into a 429-emitting
boundary: a submit that would exceed it bounces with `retry_after_ms`,
the same Retry-After path the mock's token bucket drives.

On the card every worker thread launches on the device's default
stream (PyTorch's current stream of a new thread), so the workers'
generations and the session's device step are ordered on one stream.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import TYPE_CHECKING, Optional

import numpy as np

from repro_torch.client.provider import Completion, SubmitResult

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.client.request import Request


class AsyncBlackBoxProvider:
    """Thread-pool async facade over a blocking `submit(prompt, max_new)`
    provider.  A completion's `finish_ms` is the session clock at the
    poll that observes the finished future (poll-cadence granularity:
    the client cannot see inside the black box).  A generation that
    raised re-raises from that poll."""

    def __init__(self, provider, *, max_workers: int = 4,
                 max_inflight: Optional[int] = None,
                 retry_after_ms: float = 500.0):
        self._provider = provider
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self._lock = threading.Lock()
        self._futures: dict[int, Future] = {}
        self._next_ticket = 0
        self.max_inflight = max_inflight
        self.retry_after_ms = float(retry_after_ms)
        self.n_throttled = 0
        self.n_accepted = 0

    def submit(self, req: "Request", now_ms: float,
               inflight_hint: int | None = None) -> SubmitResult:
        with self._lock:
            if self.max_inflight is not None \
                    and len(self._futures) >= self.max_inflight:
                self.n_throttled += 1
                return SubmitResult(False, self.retry_after_ms)
            ticket = self._next_ticket
            self._next_ticket += 1
            prompt = req.prompt if req.prompt is not None \
                else np.zeros((8,), np.int32)
            fut = self._pool.submit(
                self._provider.submit, prompt, int(req.max_new))
            self._futures[ticket] = fut
            self.n_accepted += 1
        return SubmitResult(True, 0.0, ticket=ticket)

    def poll(self, now_ms: float) -> list[Completion]:
        out = []
        with self._lock:
            done = sorted(t for t, f in self._futures.items() if f.done())
            for t in done:
                fut = self._futures.pop(t)
                out.append(Completion(t, float(now_ms), fut.result()))
        return out

    def inflight(self) -> int:
        with self._lock:
            return len(self._futures)

    def next_event_ms(self, now_ms: float) -> Optional[float]:
        return None  # an opaque transport cannot predict completions

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True)
