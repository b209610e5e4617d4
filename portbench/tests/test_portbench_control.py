"""On the card: each cell's control (the program in the next lower
precision: TF32 products where the cell states float32 with TF32 off, the
mixed path where it states float64) comes out as not correct, at the cell's
own size.  Skips without a card."""

import pytest
import torch

from portbench import harness

CELLS = ["sphere2500.gn_mixed", "venice871.lm", "sphere2500.gn_f64"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    res = harness.run_cell(cell, 987654321, 1.0, False, device=card, control=True)
    assert not res["correct"], res["checks"]
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(card, cell):
    res = harness.run_cell(cell, 987654322, 1.0, False, device=card)
    assert res["correct"], res["checks"]
