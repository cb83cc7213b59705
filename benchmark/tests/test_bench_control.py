"""On the card, at each cell's own size: a sound run is correct, and the
control (the reference in float8 in the program's place) fails at least
one of the cell's limits.  ``benchmark/limits.py`` reads the same numbers
over many seeds; this keeps one seed of them as a test."""

import pytest
import torch

from benchmark import harness, limits
from benchmark.tests.cells import require_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ct3d_train", "ct3d_serve"])
def test_control_fails_at_the_cells_size(name):
    require_cuda()
    row = limits.readings(name, 2 ** 31 + 101, 1.0, True, torch.device("cuda", 0))
    cell, _, _ = harness.load_cell(name)
    assert row["correct"], row["program"]
    control = row["control_fp8"]
    assert any(control[n] > lim for n, lim in cell["limits"].items() if n in control), control
