"""The registry's other single-provider scenarios on the port's dense
engine, against the JAX reference, with the fixtures and checks of
`test_torch_scenarios.py` (which runs `storm` and `rate_crunch`, dense
and windowed).  Each runs the reference's batch under the scenario's
arrival schedule and provider dynamics for 1,600 ticks: decisions,
statuses and throttle counts equal, floats within `FLOAT_TOL`, phase
metrics within `METRIC_TOL`."""
import pytest

from repro.sim import scenarios as rscn
from test_torch_scenarios import ENGINE, HERE, check_against_reference


@pytest.mark.parametrize("name", [n for n in ENGINE if n not in HERE])
def test_dense_matches_reference(name):
    rfin = check_against_reference(name, None)
    if rscn.get_scenario(name).tb_rate_rps is not None:
        assert int(rfin.provider.n_throttled) > 0  # the limiter bit
