"""On the card, at each cell's own size: a short run is correct and its
control, the reference in the next lower precision in the program's place,
fails the cell's limits, as does a step that returns its state unchanged;
and the LCP cell's program with its solver tolerance loosened 100 times
is not correct.
Run on the card with `python -m pytest portbench/tests -m cuda`."""

import pytest

from portbench import harness

from .conftest import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_cell_and_its_control_at_full_size(card, name):
    cell = harness.Cell(name)
    out = harness.run(cell, 2 ** 31 + 2 ** 20 + 3, 1.0, False, card, control=True)
    assert out["correct"], out["compared"]
    for label in ("start_gap", "end_gap"):
        limit = out["compared"][label]["limit"]
        assert out["control"][label] > limit
        assert out["control"][label + ".unchanged"] > limit


@pytest.mark.cuda
def test_the_lcp_cell_with_a_loosened_tolerance_is_not_correct(card):
    cell = harness.Cell("lcp_4m.steady", fault={"max_allowable_overlap": 1e-3})
    out = harness.run(cell, 2 ** 31 + 2 ** 20 + 5, 1.0, False, card)
    assert out["compared"]["overlap"]["value"] > out["compared"]["overlap"]["limit"]
    assert not out["correct"]
