"""Recovery of the port's session from `stuck_tail` (12% of accepted
submits stuck at 400x their service), with the chip check's
configuration and the reference's gates: `check_recovery` of
`test_torch_session_faults.py`, whose docstring states both.  This
case is alone in its file for its length: seed 0's xlong request waits
out a ~70 s client deadline before its resubmit lands, ~3,800 polls.
"""
from tests.test_torch_session_faults import check_recovery


def test_watchdog_recovers_what_the_control_loses_stuck_tail():
    check_recovery("stuck_tail")
