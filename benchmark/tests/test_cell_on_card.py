"""On the card (skipped without one): a cell's run comes out correct at its
own size, and the control at that size fails a number that the port passes.
``python -m pytest benchmark/tests/test_cell_on_card.py`` runs them there."""

import pytest

from benchmark import control, run, spec

pytestmark = pytest.mark.gpu
CELL = "deepfm-criteo.train-b1024"


def test_a_cell_is_correct_on_the_card(card):
    result = run.run_cell(spec.load_cell(CELL), 2 ** 31 + 901, 1.0, False,
                          card)
    assert result["correct"], result["checks"]


def test_the_control_fails_on_the_card(card):
    cell = spec.load_cell(CELL)
    r = control.readings(cell, 2 ** 31 + 902, card)
    names = [k for k in cell["limits"] if not k.startswith("_")]
    assert all(r["program"][k] <= cell["limits"][k]["limit"] for k in names)
    assert any(r["control"][k] > cell["limits"][k]["limit"] for k in names)
