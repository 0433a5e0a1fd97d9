"""A run with the timed path broken underneath (``portbench/faults.py``)
comes out not correct: the look for a card skipped, on the CPU at the
tiny sizes."""

import pytest

from portbench.faults import FAULTS


@pytest.mark.parametrize("fault", sorted(FAULTS["train"]))
@pytest.mark.parametrize("name", ["ml20m-explicit.train",
                                  "ml20m-implicit.train"])
def test_train_fault_is_caught(run_module, tiny_cell, monkeypatch, name,
                               fault):
    FAULTS["train"][fault](monkeypatch.setattr)
    run = run_module.execute(tiny_cell(name), 7, 0.3, False, "cpu")
    assert not run.correct, run.checks


@pytest.mark.parametrize("fault", sorted(FAULTS["score"]))
def test_score_fault_is_caught(run_module, tiny_cell, monkeypatch, fault):
    FAULTS["score"][fault](monkeypatch.setattr)
    cell = tiny_cell("ml20m-explicit.score-all")
    cell.mix = dict(cell.mix, flush_users=100)
    run = run_module.execute(cell, 7, 0.3, False, "cpu")
    assert not run.correct, run.checks
