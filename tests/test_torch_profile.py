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


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "3d"])
def test_split_cost_reg_puts_each_launch_in_its_innermost_part(monkeypatch, dense):
    """``--split_cost_reg``'s ranges on a CPU trace, the leaf operators
    standing in for kernels: each stage's time is the sum of its parts, the
    dense form's weight einsums are a part of their own, and the patches
    and hooks are gone afterwards."""
    from torch.nn import functional as F
    from torch.profiler import ProfilerActivity

    from transmvsnet_tpu_torch.config import ModelConfig
    from transmvsnet_tpu_torch.data.example import example_train_batch
    from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    model = TransMVSNet(ModelConfig(ndepths=(8, 8, 8), dense_cost_reg=dense), device="cpu",
                        generator=torch.Generator().manual_seed(0)).eval()
    batch = example_train_batch(B=1, V=2, H=32, W=32, num_hyp=48)
    args = [torch.as_tensor(batch["imgs"]), {k: torch.as_tensor(v) for k, v in batch["proj_matrices"].items()},
            torch.as_tensor(batch["depth_values"])]
    conv2d, einsum = F.conv2d, torch.einsum
    with profile.split_cost_reg(model), torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            model(*args)
    assert (F.conv2d, torch.einsum) == (conv2d, einsum)
    assert all(not m._forward_hooks and not m._forward_pre_hooks for m in model.cost_regularization.modules())
    events = prof.events()
    leaves = [e for e in events if not e.cpu_children and e.name.startswith("aten::")]
    split = profile.split_totals(events, leaves, passes=1)
    assert sorted(split) == ["cost_reg_stage1", "cost_reg_stage2", "cost_reg_stage3"]
    for stage in split.values():
        parts = {k: v for k, v in stage.items() if isinstance(v, dict)}
        assert set(parts) == {"conv", "batchnorm", "rest"} | ({"weights"} if dense else set())
        assert sum(p["launches_per_pass"] for p in parts.values()) == stage["launches_per_pass"]
        assert sum(p["ms_per_pass"] for p in parts.values()) == pytest.approx(stage["ms_per_pass"])
