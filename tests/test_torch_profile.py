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


def test_shape_flags_default_to_the_fixed_shapes():
    assert profile.pass_shape(profile.parse_args([])) == (1, 864, 1152)
    assert profile.pass_shape(profile.parse_args(["--train"])) == (2, 512, 640)
    args = profile.parse_args(["--train", "--height", "256", "--width", "320", "--batch_size", "1"])
    assert profile.pass_shape(args) == (1, 256, 320)
    assert profile.pass_shape(profile.parse_args(["--batch_size", "3"])) == (3, 864, 1152)


def test_train_cli_profile_mode_delegates(monkeypatch, tmp_path):
    """``tools/train.py --mode profile`` traces train steps at the run's
    per-process batch, views, hypotheses and dtype under <logdir>/traces."""
    from transmvsnet_tpu_torch.tools import train

    calls = []
    monkeypatch.setattr(profile, "main", lambda argv: calls.append(argv) or "traced")
    assert train.main(["--mode", "profile", "--logdir", str(tmp_path), "--batch_size", "1", "--nviews", "4",
                       "--ndepths", "32,16,8", "--dtype", "bfloat16"]) == "traced"
    (argv,) = calls
    args = profile.parse_args(argv)
    assert args.train and args.logdir == str(tmp_path / "traces")
    assert (args.batch_size, args.nviews, args.ndepths, args.dtype) == (1, 4, "32,16,8", "bfloat16")
    assert profile.pass_shape(args) == (1, 512, 640)
    assert not any(tmp_path.iterdir())
