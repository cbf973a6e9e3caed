"""On the card, at each cell's own size: the lower-precision control comes
out not correct on three seeds.  Skips without a card."""

import pytest

from perfbench import calibrate
from perfbench.tests.test_perfbench_correct import CELLS


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_size(card, workload):
    rows = calibrate.main(["--workload", workload, "--seconds", "5",
                           "--seeds", "11,12,13", "--control"],
                          device=str(card))
    assert len(rows) == 3 and not any(r.get("correct") for r in rows)
