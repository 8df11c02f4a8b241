"""The port's live session against the windowed engines under
nonstationary traffic and a changing provider.

The harness and its checks are `test_torch_session.py`'s (`check_case`):
exact against the port's windowed `run_sim`, and against the
reference's within `FLOAT_TOL` for severity and finish times.

  * `flash_crowd` (phased arrivals, no provider dynamics): N = 96,
    W = 128, B = 4, 1,200 polls, the reference pin's case;
  * `storm` (a flash crowd into a browned-out, rate-limited provider)
    through `MockProvider.from_scenario`: N = 160 at 4x the rate, W =
    256, B = 4, 1,604 polls (the arrival span and 800 ticks of drain),
    the chip check's `session_parity` case.  The provider's token bucket
    bounces grants 429-style and its brownout rows price the admits
    inside the window; every bounce and status equals the engine's.
"""
from tests.test_torch_session import check_case


def test_flash_crowd_nonstationary():
    sess = check_case("flash_crowd")
    assert sess.stats.n_admitted > 20


def test_storm_brownout_and_token_bucket():
    sess = check_case("storm")
    assert sess.stats.n_throttled > 0, "the limiter never bounced"
    assert sess.provider._comfort_rows is not None
    assert (sess.provider._comfort_rows < 1.0).any()
