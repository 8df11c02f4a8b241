"""The async provider boundary: what the client sees of the black box.

Counterpart of `repro.client.provider`.  `AsyncProvider` is the
transport contract `ClientSession` schedules against:

  * `submit(req, now_ms, ...)` is non-blocking: it either accepts the
    request (work proceeds out of band; completion arrives via `poll`)
    or bounces it 429-style with a client-visible `retry_after_ms`.
    Nothing about service time is revealed at submission.
  * `poll(now_ms)` drains completions that have landed by `now_ms`.
  * `inflight()` is the provider's actual outstanding count.
  * `next_event_ms(now_ms)` is an optional scheduling hint (earliest
    time anything can change) so an idle session can sleep instead of
    spinning; transports that cannot know return None.

`MockProvider` puts the simulator's provider physics and nonstationary
dynamics (`sim/provider.py`) behind that API: load-dependent service
times, brownout comfort windows, and the per-class token-bucket rate
limiter with 429 bounces.  It is host-side numpy in strict per-op
float32, in the engine's operation order, so a `ClientSession` replaying
a generated trace in virtual time reproduces the windowed engine's
decision sequence.
"""
from __future__ import annotations

from typing import (
    TYPE_CHECKING,
    Callable,
    NamedTuple,
    Optional,
    Protocol,
    runtime_checkable,
)

import numpy as np

from repro_torch.sim.faults import FaultSchedule, fault_draw
from repro_torch.sim.provider import ProviderPhysics, default_physics

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.client.request import Request


class SubmitResult(NamedTuple):
    """Outcome of a non-blocking submit."""

    accepted: bool
    retry_after_ms: float = 0.0   # 429 Retry-After hint when not accepted
    ticket: int = -1              # provider-scoped handle when accepted


class Completion(NamedTuple):
    """One landed request, reported by `poll`."""

    ticket: int
    finish_ms: float              # session-clock completion time
    output: Optional[np.ndarray] = None


@runtime_checkable
class AsyncProvider(Protocol):
    """Transport contract the session schedules against (see module
    docstring).  `inflight_hint` is the client's own concurrency view at
    decision time; transports may ignore it."""

    def submit(self, req: "Request", now_ms: float,
               inflight_hint: int | None = None) -> SubmitResult: ...

    def poll(self, now_ms: float) -> list[Completion]: ...

    def inflight(self) -> int: ...

    def next_event_ms(self, now_ms: float) -> Optional[float]: ...


# --- Retry-After policies (the 429 backoff hook) ---------------------------

RetryPolicy = Callable[[float, int], float]


def sanitize_retry_after_ms(retry_after_ms: float) -> float:
    """Clamp a hostile Retry-After hint before any retry policy sees it:
    a non-finite or negative hint (clock skew, serialization bugs, plain
    lies, `FaultSchedule.retry_lie_mult`) becomes 0.0 ("retry whenever
    you like"), which the session's own backoff then shapes; honest
    hints pass through unchanged."""
    r = float(retry_after_ms)
    if not np.isfinite(r) or r < 0.0:
        return 0.0
    return r


def honor_retry_after(retry_after_ms: float, n_throttles: int) -> float:
    """Default: wait exactly what the provider asked."""
    return retry_after_ms


def expo_retry(mult: float = 1.0, growth: float = 2.0,
               cap_ms: float = 60_000.0, jitter: float = 0.2,
               seed: int = 0) -> RetryPolicy:
    """Retry-After-seeded exponential backoff with decorrelation jitter.

    The provider's hint is the base, repeated bounces of the same
    request grow it geometrically (capped at `cap_ms`), and each delay
    is smeared uniformly over ±`jitter`, so a cohort bounced together
    does not retry in lockstep.  Seeded, so replays are deterministic;
    `jitter=0.0` gives the exact geometric schedule."""
    if not 0.0 <= jitter < 1.0:
        raise ValueError(f"jitter must be in [0, 1), got {jitter}")
    rng = np.random.default_rng(seed)

    def policy(retry_after_ms: float, n_throttles: int) -> float:
        base = min(retry_after_ms * mult * growth ** max(n_throttles - 1, 0),
                   cap_ms)
        if jitter:
            base *= 1.0 + jitter * (2.0 * rng.random() - 1.0)
        return base
    return policy


def _f32(x) -> np.float32:
    """A scalar (a python number, a numpy value or a 0-d tensor on the
    CPU) as a numpy float32."""
    return np.float32(float(x))


class MockProvider:
    """Sim-dynamics provider behind the async boundary.

    Service physics, brownout schedule and token-bucket limiter are
    `sim/provider.py`'s, evaluated in strict per-op float32, so results
    are bit-identical to the engine's tensor evaluation (the same IEEE
    float32 operations in the same order; the trailing `* jitter + now`
    rounds once, as `core.numerics.fma32` in the engine).

    Tick alignment: schedules are (T,)/(T, K) per-tick rows, as the
    engine reads them.  A poll/submit at `now_ms` first applies every
    refill row r with (r + 1) * dt_ms <= now_ms (the engine applies row
    t before dispatching at now = (t + 1) dt), and the brownout row of
    the current tick scales the comfort knee of admissions inside it.

    Token-bucket semantics match the engine's `_apply_batch`: grants of
    one decision epoch (one distinct `now_ms`) are ranked per class
    against the bucket level at epoch start, an accepted grant consumes
    one token, a bounce consumes nothing and carries `retry_after_ms`.

    `faults` breaks the contract on purpose (`sim/faults.py`): per-ticket
    draws decide which accepted submits get stuck (service x
    stuck_mult), which landed completions are silently dropped or
    redelivered `dup_extra` more times with divergent payload stamps,
    and 429 hints are scaled by `retry_lie_mult`.  `faults=None` (or a
    schedule that injects nothing) is the honest path.  `fault_salt`
    decorrelates the fault streams of several endpoints.
    """

    def __init__(
        self,
        phys: ProviderPhysics | None = None,
        *,
        dt_ms: float = 25.0,
        comfort_scale: Optional[np.ndarray] = None,   # (T,) brownout rows
        tb_refill: Optional[np.ndarray] = None,       # (T, K) grants/tick
        tb_capacity: Optional[np.ndarray] = None,     # (K,) burst size
        retry_after_ms: float = 1500.0,
        faults: FaultSchedule | None = None,
        fault_salt: int = 0,
    ):
        phys = phys if phys is not None else default_physics()
        self.phys = phys
        self._base = _f32(phys.base_ms)
        self._ms_per_token = _f32(phys.ms_per_token)
        self._comfort = _f32(phys.comfort_concurrency)
        self._slope = _f32(phys.slowdown_slope)
        self._quad = _f32(phys.slowdown_quad)
        self.dt_ms = float(dt_ms)
        self._comfort_rows = (
            None if comfort_scale is None
            else np.asarray(comfort_scale, np.float32))
        self._refill_rows = (
            None if tb_refill is None else np.asarray(tb_refill, np.float32))
        if (self._refill_rows is None) != (tb_capacity is None):
            raise ValueError("tb_refill and tb_capacity go together")
        self._capacity = (
            None if tb_capacity is None
            else np.asarray(tb_capacity, np.float32))
        self.retry_after_ms = float(retry_after_ms)
        # the bucket starts full, as the engine seeds it in run_sim
        self._tb = None if self._capacity is None else self._capacity.copy()
        self._rows_applied = 0
        self._epoch_now = -np.inf   # decision epoch = one distinct now_ms
        self._epoch_tokens0 = (
            None if self._tb is None else self._tb.copy())
        self._epoch_rank = (
            None if self._tb is None
            else np.zeros(self._capacity.shape[0], np.int64))
        self._outstanding: dict[int, tuple[np.float32, "Request"]] = {}
        self._next_ticket = 0
        self.n_throttled = 0
        self.n_accepted = 0
        self._faults = (faults if faults is not None and faults.injects
                        else None)
        self._fault_salt = int(fault_salt)
        # dup redeliveries waiting their delay: (deliver_at_ms, Completion)
        self._pending_dups: list[tuple[float, Completion]] = []
        self.n_dropped = 0     # completions computed but never delivered
        self.n_stuck = 0       # submits whose service time was inflated
        self.n_duped = 0       # completions scheduled for redelivery
        # loaded-latency memo: the slowdown chain is pure in (tokens,
        # inflight, brownout row), so caching its float32 result keeps
        # the per-submit host cost flat without changing a bit
        self._svc_cache: dict[tuple, np.float32] = {}

    @classmethod
    def from_scenario(cls, scenario, n_requests: int, n_ticks: int,
                      dt_ms: float, k: int,
                      phys: ProviderPhysics | None = None,
                      arrival_scale: float = 1.0) -> "MockProvider":
        """The provider side of a registry `Scenario`: the schedules
        `run_sim` reads tick by tick (`sim/scenarios.py`
        `build_dynamics`), so nonstationary regimes replay against the
        live path.  `arrival_scale` compresses the schedules with the
        arrivals, as `build(..., arrival_scale=)` does."""
        from repro_torch.sim.scenarios import build_dynamics

        dyn = build_dynamics(scenario, n_ticks, dt_ms, n_requests, k,
                             arrival_scale)
        faults = scenario.faults
        if dyn is None:
            return cls(phys, dt_ms=dt_ms, faults=faults)

        def rows(x):
            return None if x is None else x.cpu().numpy()

        retry = (float(dyn.retry_after_ms)
                 if dyn.retry_after_ms is not None else 1500.0)
        return cls(
            phys,
            dt_ms=dt_ms,
            comfort_scale=rows(dyn.comfort_scale),
            tb_refill=rows(dyn.tb_refill),
            tb_capacity=rows(dyn.tb_capacity),
            retry_after_ms=retry,
            faults=faults,
        )

    # --- time ---------------------------------------------------------
    def _advance(self, now_ms: float) -> None:
        """Apply refill rows due by `now_ms`; open a new decision epoch
        when the clock moved."""
        if self._refill_rows is not None:
            target = int(np.floor(now_ms / self.dt_ms + 1e-6))
            target = min(target, self._refill_rows.shape[0])
            while self._rows_applied < target:
                self._tb = np.minimum(
                    self._tb + self._refill_rows[self._rows_applied],
                    self._capacity)
                self._rows_applied += 1
        if now_ms != self._epoch_now:
            self._epoch_now = now_ms
            if self._tb is not None:
                self._epoch_tokens0 = self._tb.copy()
                self._epoch_rank[:] = 0

    def _tick_index(self, now_ms: float, n_rows: int) -> int:
        t = int(np.floor(now_ms / self.dt_ms + 1e-6)) - 1
        return min(max(t, 0), n_rows - 1)

    # --- physics ------------------------------------------------------
    def _finish_ms(self, tokens: float, inflight: int, jitter: float,
                   now_ms: float) -> np.float32:
        """`now + service_time_ms(...)` with the engine's rounding:
        strict per-op float32 through the slowdown chain, then the
        trailing `* jitter + now` rounded once (`core.numerics.fma32`:
        the float32 product is exact in float64, the float64 sum is
        rounded to float32 once)."""
        row = -1
        if self._comfort_rows is not None:
            row = self._tick_index(now_ms, self._comfort_rows.shape[0])
        key = (tokens, inflight, row)
        loaded = self._svc_cache.get(key)
        if loaded is None:
            comfort = self._comfort
            if row >= 0:
                comfort = comfort * self._comfort_rows[row]
            unloaded = self._base + self._ms_per_token * _f32(tokens)
            excess = np.maximum(_f32(inflight) - comfort, _f32(0.0)) \
                / np.maximum(comfort, _f32(1.0))
            mult = _f32(1.0) + self._slope * excess \
                + self._quad * (excess * excess)
            loaded = unloaded * mult
            if len(self._svc_cache) > 4096:
                self._svc_cache.clear()
            self._svc_cache[key] = loaded
        return np.float32(
            float(loaded) * float(np.float32(jitter))
            + float(np.float32(now_ms)))

    # --- AsyncProvider ------------------------------------------------
    def submit(self, req: "Request", now_ms: float,
               inflight_hint: int | None = None) -> SubmitResult:
        self._advance(now_ms)
        if self._tb is not None:
            k = self._capacity.shape[0]
            c = min(max(req.resolved_cls(), 0), k - 1)
            self._epoch_rank[c] += 1
            allowed = (np.float32(self._epoch_rank[c])
                       <= self._epoch_tokens0[c] + np.float32(1e-6))
            if not allowed:
                self.n_throttled += 1
                retry = self.retry_after_ms
                if self._faults is not None \
                        and self._faults.retry_lie_mult != 1.0:
                    # lying Retry-After: the hint no longer reflects the
                    # real refill (it may go negative or non-finite; the
                    # client must sanitize, not trust)
                    retry = retry * float(self._faults.retry_lie_mult)
                return SubmitResult(False, retry)
            self._tb[c] = self._tb[c] - np.float32(1.0)
        # service at the client's optimistic concurrency view when given:
        # the engine prices grant g at the inflight count the decision saw
        # (every earlier ADMIT of the epoch, bounced ones too).  Without
        # a hint, the true outstanding count.
        inflight = (inflight_hint if inflight_hint is not None
                    else len(self._outstanding))
        finish = self._finish_ms(req.max_new, inflight, req.jitter, now_ms)
        ticket = self._next_ticket
        self._next_ticket += 1
        if self._faults is not None \
                and fault_draw(self._faults, self._fault_salt, ticket).stuck:
            # stuck request: the realized service (finish - now) inflates
            # by stuck_mult; a resubmit draws a fresh ticket and so a
            # fresh verdict
            now32 = float(np.float32(now_ms))
            finish = np.float32(
                now32 + (float(finish) - now32) * self._faults.stuck_mult)
            self.n_stuck += 1
        self._outstanding[ticket] = (finish, req)
        self.n_accepted += 1
        return SubmitResult(True, 0.0, ticket=ticket)

    def poll(self, now_ms: float) -> list[Completion]:
        self._advance(now_ms)
        # deliver in (finish_ms, ticket) order, not submit order: stuck
        # and dup faults and uneven service invert the two
        done = sorted(
            (float(f), t) for t, (f, _) in self._outstanding.items()
            if f <= now_ms)
        out = []
        for finish, t in done:
            self._outstanding.pop(t)
            if self._faults is not None:
                d = fault_draw(self._faults, self._fault_salt, t)
                if d.drop:
                    # silent drop: computed, never delivered
                    self.n_dropped += 1
                    continue
                if d.dup:
                    fs = self._faults
                    for i in range(1, fs.dup_extra + 1):
                        self._pending_dups.append((
                            finish + i * fs.dup_delay_ms,
                            # divergent payload: the copies disagree
                            # about when the work finished
                            Completion(t, finish + i * fs.dup_jitter_ms,
                                       None)))
                    self.n_duped += 1
            out.append(Completion(t, float(finish), None))
        if self._pending_dups:
            due = [(at, c) for at, c in self._pending_dups if at <= now_ms]
            if due:
                self._pending_dups = [
                    x for x in self._pending_dups if x[0] > now_ms]
                due.sort(key=lambda x: (x[0], x[1].ticket))
                out.extend(c for _, c in due)
        return out

    def inflight(self) -> int:
        return len(self._outstanding)

    def next_event_ms(self, now_ms: float) -> Optional[float]:
        cands = [float(f) for f, _ in self._outstanding.values()]
        cands.extend(at for at, _ in self._pending_dups)
        if self._refill_rows is not None \
                and self._rows_applied < self._refill_rows.shape[0]:
            # the next refill row lands at (rows_applied + 1) * dt
            cands.append((self._rows_applied + 1) * self.dt_ms)
        return min(cands) if cands else None
