"""On a card, at each cell's own size: the lower-precision control (the
program's bf16 path) comes out not correct, and the program as the
configuration states comes out correct, on the same seed."""

import pytest
import torch

from mvsbench import harness

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.mark.parametrize("workload", ["dtu_infer", "dtu_train", "tnt_infer"])
def test_control_fails_and_program_passes(card, workload):
    seed = 2**31 + 909
    control = harness.run(workload, seed, 3.0, False, card, program_dtype="bfloat16")
    assert not control["correct"], control["checks"]
    program = harness.run(workload, seed, 3.0, False, card)
    assert program["correct"], program["checks"]
