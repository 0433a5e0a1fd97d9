"""On the card, at each cell's own size: the lower-precision control
comes out not correct on three seeds, and the program correct on two.
Run on a machine with a card: ``python -m pytest portbench/tests -m
card``."""

import pytest

from portbench.harness import registry

CELLS = ["ml20m-explicit.train", "ml20m-implicit.train",
         "ml20m-explicit.score-all"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(card, name):
    from portbench.readings import readings

    cell = registry.Cell(registry.load_benchmark(), name)
    out = readings(cell, [2**31 + 1, 2**31 + 2],
                   [2**31 + 3, 2**31 + 4, 2**31 + 5], 2.0)
    assert all(r["correct"] for r in out["sound"]), out["sound"]
    assert not any(r["correct"] for r in out["control"]), out["control"]
