"""The profiling tool's pieces that run without a card."""

import pytest
import torch

from transmvsnet_tpu_torch.tools import profile


def test_busy_time_is_the_union_of_kernel_intervals():
    # Overlapping, nested, touching and disjoint intervals, unsorted.
    assert profile.busy_us([(5.0, 9.0), (0.0, 2.0), (1.0, 3.0), (6.0, 7.0), (9.0, 10.0)]) == 8.0
    assert profile.busy_us([]) == 0.0


def test_profile_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        profile.main([])
