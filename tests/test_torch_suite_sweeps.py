"""The port's solves of the MGH benchmark's 39 dimension sweeps (the
variable-dimension families at n = 4-40) against the JAX package's;
tests/torch_suite_parity.py states the contract.
"""

import pytest
import torch

from torch_suite_parity import SWEEPS, check_full_solve, check_short_budget

torch.set_num_threads(1)


@pytest.mark.parametrize("name", SWEEPS)
def test_short_budget_matches_jax(name):
    check_short_budget(name)


# Brown almost linear (a second stationary point at f = 1) and Chebyquad
# (f* = 0, 3.5e-3 and none) at every dimension the benchmark has, and two
# problems whose lanes stop on other rungs in the two packages.
@pytest.mark.parametrize("name", [
    "brown_almost_linear10", "brown_almost_linear20", "brown_almost_linear40",
    "chebyquad7", "chebyquad8", "chebyquad10", "watson9",
    "extended_rosenbrock20"])
def test_full_solve_matches_jax(name):
    check_full_solve(name)
