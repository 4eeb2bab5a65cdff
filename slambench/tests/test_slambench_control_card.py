"""The controls on the card at a size a test run can hold: each has to
come out not correct. TF32 exists only on the card, so these skip on a
machine without one (the fixture decides)."""

import pytest
import torch

from slambench import control
from slambench.tests.tiny_cells import make_root


@pytest.fixture
def card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32, the controls' precision, "
                    "exists only there")
    return make_root(tmp_path)


def test_reference_in_tf32_fails(card):
    out = control.reference_in_place(card, "tiny-odometry", 4242640688, 24)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell, seconds", [("tiny-odometry", 3.0),
                                           ("tiny-slam", 20.0)])
def test_program_in_tf32_fails(card, cell, seconds):
    out = control.program_in_tf32(card, cell, 4582575695, seconds)
    assert not out["correct"], out["checks"]


def test_graph_in_bf16_fails(card):
    out = control.graph_in_bf16(card, "tiny-slam", 4123105625, 20.0)
    assert out["info"]["solves"] > 0
    assert not out["correct"], out["checks"]
