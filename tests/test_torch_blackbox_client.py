"""The port's black-box adapter, `ScheduledClient` and the launcher.

1. `AsyncBlackBoxProvider` against the reference's, both over the same
   blocking stand-in whose every generation waits on a
   `threading.Event` of its own: tickets, polls in ticket order that
   see exactly the futures released and waited for before them, finish
   stamps at the poll's clock, the `max_inflight` 429 with its
   Retry-After and counters, the `None` prompt, a generation that
   raises re-raising from the poll, and `shutdown`.  No assertion waits
   on a thread's timing: every future a poll must see is waited for
   before that poll.
2. `ScheduledClient` (the deprecated shim) warns and completes a closed
   list with `time` replaced in the session's module by a settling
   clock: a sleep first waits for every generation the pool was given,
   then advances the session's clock, so what a poll sees does not
   depend on how fast the worker threads run.
3. `make_requests` draws the reference's requests, bit for bit.
4. The launcher, `python -m repro_torch.launch.serve --device cpu`, end
   to end on `stablelm-1.6b`'s smoke config: the model it serves is the
   reference's `init_model` parameters carried over by
   `params_from_jax` (float32), and every completed output equals the
   reference's `BlackBoxProvider.submit` on those parameters, token for
   token.  The reference's `ClientSession` is never built.
"""
import dataclasses
import threading
import warnings
from concurrent import futures

import jax
import numpy as np
import pytest
import torch

import repro.client as rclient
from repro.config import ServeConfig as RefServeConfig
from repro.configs import get_smoke as ref_get_smoke
from repro.launch.serve import make_requests as ref_make_requests
from repro.models import init_model as ref_init_model
from repro.serving.blackbox import BlackBoxProvider as RefBlackBoxProvider
from repro_torch.bridge import params_from_jax
from repro_torch.client import AsyncBlackBoxProvider, Request
from repro_torch.client import blackbox as blackbox_mod
from repro_torch.client import session as session_mod
from repro_torch.configs import get_smoke
from repro_torch.core.policy import strategy
from repro_torch.launch import serve as serve_mod
from repro_torch.serving import ScheduledClient

torch.set_num_threads(2)


class Gated:
    """A blocking `submit(prompt, max_new)` whose call for a prompt that
    starts with token i waits for `release(i)`; it answers `prompt[0] +
    arange(max_new)`, or raises for a prompt starting with -1."""

    def __init__(self):
        self.events = {}
        self.prompts = []
        self.lock = threading.Lock()

    def _event(self, i):
        with self.lock:
            return self.events.setdefault(i, threading.Event())

    def release(self, i):
        self._event(i).set()

    def submit(self, prompt, max_new):
        prompt = np.asarray(prompt)
        with self.lock:
            self.prompts.append(prompt.copy())
        first = int(prompt[0])
        assert self._event(first).wait(30.0)
        if first == -1:
            raise RuntimeError("generation failed")
        return (first + np.arange(max_new)).astype(np.int32)


def _req(request_cls, i, first, max_new=3):
    prompt = None if first is None else np.full(4, first, np.int32)
    return request_cls(rid=i, prompt=prompt, max_new=max_new, p50=max_new,
                       bucket=0)


def wait_for(prov, tickets):
    """Block until the futures of `tickets` are done (the poll that must
    see them comes after)."""
    futures.wait([prov._futures[t] for t in tickets], timeout=30.0)


def drive(prov_cls, request_cls):
    """One script against an adapter of `prov_cls` over `Gated`; returns
    its record."""
    stand_in = Gated()
    prov = prov_cls(stand_in, max_workers=4, max_inflight=3,
                    retry_after_ms=250.0)
    rec = []
    try:
        for i, first in enumerate((7, 9, None)):
            res = prov.submit(_req(request_cls, i, first, max_new=2 + i),
                              now_ms=10.0 * i)
            rec.append(("submit", res.accepted, res.retry_after_ms,
                        res.ticket))
        res = prov.submit(_req(request_cls, 3, 11), now_ms=40.0)
        rec.append(("throttled", res.accepted, res.retry_after_ms,
                    res.ticket, prov.n_throttled, prov.n_accepted))
        rec.append(("poll", prov.poll(50.0), prov.inflight()))
        stand_in.release(9)
        stand_in.release(0)          # the None prompt: zeros(8)
        wait_for(prov, [1, 2])
        comps = prov.poll(60.5)
        rec.append(("poll", [(c.ticket, c.finish_ms, c.output.tolist())
                             for c in comps], prov.inflight()))
        res = prov.submit(_req(request_cls, 4, -1), now_ms=70.0)
        rec.append(("submit", res.accepted, res.ticket))
        stand_in.release(7)
        stand_in.release(-1)
        wait_for(prov, [0, 3])
        with pytest.raises(RuntimeError, match="generation failed"):
            prov.poll(80.0)
        rec.append(("after_error", prov.inflight(), prov.next_event_ms(80.0),
                    prov.n_throttled, prov.n_accepted))
        rec.append(("prompts", sorted(p.tolist() for p in stand_in.prompts)))
    finally:
        for i in (7, 9, 0, -1, 11):
            stand_in.release(i)
        prov.shutdown()
    return rec


def test_async_blackbox_provider_matches_reference():
    ref = drive(rclient.AsyncBlackBoxProvider, rclient.Request)
    port = drive(AsyncBlackBoxProvider, Request)
    assert port == ref
    # what the record holds, stated on the port's side
    assert [r[3] for r in port[:3]] == [0, 1, 2]
    assert port[3] == ("throttled", False, 250.0, -1, 1, 3)
    assert port[4] == ("poll", [], 3)
    assert port[5] == ("poll", [(1, 60.5, [9, 10, 11]),
                                (2, 60.5, [0, 1, 2, 3])], 1)
    assert [0] * 8 in port[-1][1]


def test_poll_returns_completions_in_ticket_order():
    stand_in = Gated()
    prov = AsyncBlackBoxProvider(stand_in, max_workers=4)
    try:
        for i in range(4):
            assert prov.submit(_req(Request, i, 20 + i), 0.0).accepted
        for i in (23, 21, 20, 22):
            stand_in.release(i)
        wait_for(prov, range(4))
        comps = prov.poll(5.0)
        assert [c.ticket for c in comps] == [0, 1, 2, 3]
        assert all(c.finish_ms == 5.0 for c in comps)
        assert prov.inflight() == 0 and prov.n_accepted == 4
    finally:
        prov.shutdown()


class TrackingPool(futures.ThreadPoolExecutor):
    """The adapter's pool, recording every future it hands out."""

    given: list = []

    def submit(self, *args, **kwargs):
        fut = super().submit(*args, **kwargs)
        TrackingPool.given.append(fut)
        return fut


class SettlingClock:
    """Stands in for `time` in the session's module: `monotonic` is a
    fake clock that moves only in `sleep`, and `sleep` first waits for
    every generation handed to a `TrackingPool`.  A sleep moves the clock
    by at least a microsecond: the session sleeps until an instant it
    computed, and a clock that landed an ulp short of it must still
    move on."""

    def __init__(self):
        self.t = 0.0
        self.slept = []

    def monotonic(self):
        return self.t

    def perf_counter(self):
        return self.t

    def sleep(self, s):
        futures.wait(list(TrackingPool.given), timeout=60.0)
        self.slept.append(s)
        self.t += max(s, 1e-6)


@pytest.fixture
def settled(monkeypatch):
    TrackingPool.given = []
    monkeypatch.setattr(blackbox_mod, "ThreadPoolExecutor", TrackingPool)
    clock = SettlingClock()
    monkeypatch.setattr(session_mod, "time", clock)
    return clock


class Echo:
    """An immediate blocking provider: `prompt[0] + arange(max_new)`."""

    def submit(self, prompt, max_new):
        return (int(prompt[0]) + np.arange(max_new)).astype(np.int32)


def test_scheduled_client_warns_and_completes(settled):
    with pytest.warns(DeprecationWarning, match="ClientSession"):
        client = ScheduledClient(Echo(), strategy("final_adrr_olc"),
                                 device="cpu")
    reqs = [Request(rid=i, prompt=np.full(8, 3 * i, np.int32), max_new=2 + i,
                    p50=float(2 + i), bucket=i % 4, arrival_s=0.4 * i)
            for i in range(6)]
    done = client.run(reqs, time_scale=2.0)
    assert done is reqs                      # mutated in place
    assert [r.status for r in done] == ["completed"] * 6
    for i, r in enumerate(done):
        np.testing.assert_array_equal(r.output, 3 * i + np.arange(2 + i))
        # the session stores arrivals in float32 milliseconds
        assert r.finish_s >= r.submit_s > r.arrival_s - 1e-6
    assert settled.slept                     # it slept to the arrivals
    assert all(f.done() for f in TrackingPool.given)
    assert len(TrackingPool.given) == 6


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_make_requests_matches_reference(seed):
    ref = ref_make_requests(12, seed)
    port = serve_mod.make_requests(12, seed)
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, np.ndarray):
                assert va.dtype == vb.dtype
                np.testing.assert_array_equal(va, vb)
            else:
                assert type(va) is type(vb) and va == vb, f.name


def test_launcher_serves_the_references_tokens(settled, monkeypatch, capsys):
    arch = "stablelm-1.6b"
    rcfg = dataclasses.replace(ref_get_smoke(arch), dtype="float32")
    pcfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    params = ref_init_model(jax.random.PRNGKey(0), rcfg).params
    model = params_from_jax(params, pcfg, device="cpu")
    built = []

    def build_model(a, device):
        built.append((a, str(device)))
        return model

    monkeypatch.setattr(serve_mod, "build_model", build_model)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        done = serve_mod.main(["--device", "cpu", "--requests", "4",
                               "--arch", arch])
    assert built == [(arch, "cpu")]
    assert "completed=" in capsys.readouterr().out
    assert len(done) == 4
    assert all(r.status in ("completed", "rejected", "abandoned")
               for r in done)
    completed = [r for r in done if r.status == "completed"]
    assert completed
    ref = RefBlackBoxProvider(params, rcfg,
                              RefServeConfig(max_seq=128, temperature=0.0))
    for r in completed:
        assert r.output.shape == (r.max_new,)
        np.testing.assert_array_equal(r.output,
                                      ref.submit(r.prompt, r.max_new))
