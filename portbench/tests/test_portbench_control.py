"""The lower-precision control: the reference computed in fp8 in the
program's place must read worse than the program.  On the CPU at small
sizes its reading of each cell's telling number is at least three times
the program's; on the card at the cell's own size (one seed, a short
window at the cell's load) it fails the cell's limit, as it did on the
seeds the limits were set from (PERF.md)."""
import pytest

from portbench.harness import main
from portbench.tests import small

# the number each cell's control fails
TELLING = {"stablelm-prefill": "kv_rel_err", "arctic-decode": "mean_gap"}


@pytest.mark.parametrize("cell", sorted(TELLING))
def test_control_reads_worse_at_small_size(cell):
    c, params = small.cell(cell)
    result, _ = main.execute(cell, 2**31 + 9, 1.0, False, device="cpu",
                             config=c, params=params, control=True)
    r, k = result["readings"], TELLING[cell]
    assert r["control_" + k] >= 3 * r[k]


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(TELLING))
def test_control_fails_the_limit_on_the_card(card, cell):
    result, _ = main.execute(cell, 2**31 + 11, 8.0, False, control=True)
    r = result["readings"]
    assert result["correct"]
    assert any(r["control_" + k] > c["limit"]
               for k, c in result["checks"].items())
