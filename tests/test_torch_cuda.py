"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes that the main path does not give them (widths
that are no multiple of a block, every supported channel count, offsets
and projections that leave the image).

Needs a CUDA card and nvcc; skips elsewhere. On the GPU machine, which has
no JAX, run it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def assert_close_bf16(got, want):
    """Both sides round one float32 result to bfloat16: one bf16 step
    (2^-7 relative) apart at most, plus float32 summation-order noise."""
    got, want = got.float(), want.float()
    tol = 2.0**-7 * want.abs() + 1e-3 * want.abs().max()
    bad = (got - want).abs() > tol
    assert not bad.any(), f"{int(bad.sum())} of {bad.numel()} outside; max {(got - want).abs().max()}"


@pytest.mark.parametrize("C,C_out", [(8, 8), (16, 32), (32, 16), (32, 8)])
@pytest.mark.parametrize("H,W", [(7, 13), (33, 70)])
def test_dcn_fused_matches_plain(dev, C, C_out, H, W):
    from transmvsnet_tpu_torch.ops.cuda.dcn_fused import dcn_fused, dcn_fused_plain

    gen = torch.Generator().manual_seed(C * 100 + H)
    x = torch.randn(2, C, H, W, generator=gen).to(dev, torch.bfloat16)
    # Offsets of several pixels: many taps leave a 7x13 image entirely.
    k_off = (torch.randn(27, C, 3, 3, generator=gen) * 0.25).to(dev)
    b_off = (torch.randn(27, generator=gen) * 1.5).to(dev)
    weight = (torch.randn(9, C, C_out, generator=gen) * 0.1).to(dev)
    bias = (torch.randn(C_out, generator=gen) * 0.1).to(dev)
    before = dcn_fused.launches
    got = dcn_fused(x, k_off, b_off, weight, bias)
    torch.cuda.synchronize()
    assert dcn_fused.launches == before + 1
    assert got.shape == (2, C_out, H, W) and got.dtype == torch.bfloat16
    assert_close_bf16(got, dcn_fused_plain(x, k_off, b_off, weight, bias))


@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("H,W", [(5, 9), (31, 47)])
def test_warp_correlate_matches_plain(dev, C, H, W):
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import (
        warp_correlate,
        warp_correlate_plain,
    )

    gen = torch.Generator().manual_seed(C + H)
    B, S, D = 2, 3, 5
    src = torch.randn(B, S, C, H, W, generator=gen).to(dev, torch.bfloat16)
    ref = torch.randn(B, C, H, W, generator=gen).to(dev, torch.bfloat16)
    proj = torch.eye(4).repeat(B, S + 1, 1, 1)
    proj[..., :3, :3] += 0.02 * torch.randn(B, S + 1, 3, 3, generator=gen)
    proj[..., 0, 0] = proj[..., 1, 1] = 0.8 * W
    proj[..., 0, 2], proj[..., 1, 2] = W / 2, H / 2
    proj[..., 0, 3] = 0.3 * W * torch.arange(S + 1)  # baselines: samples leave the frame
    depth = (2.0 + 3.0 * torch.rand(B, D, H, W, generator=gen))
    depth[:, 0, : H // 2] = -1.0  # behind the cameras: sampled as zero
    proj, depth = proj.to(dev), depth.to(dev)
    args = (src, ref, proj[:, 1:].contiguous(), proj[:, 0].contiguous(), depth)
    before = warp_correlate.launches
    got = warp_correlate(*args)
    torch.cuda.synchronize()
    assert warp_correlate.launches == before + 1
    want = warp_correlate_plain(*args)
    assert got.shape == (B, S, D, H, W) and got.dtype == torch.float32
    assert (want == 0).float().mean() > 0.05
    # Same float32 arithmetic up to summation order and fused multiply-adds.
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3 * want.abs().max().item())


def test_wrappers_raise_on_what_the_kernels_refuse(dev):
    from transmvsnet_tpu_torch.ops.cuda.dcn_fused import dcn_fused
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import warp_correlate

    x = torch.randn(1, 32, 4, 4, device=dev)  # float32: the kernel takes bf16
    with pytest.raises(TypeError, match="bfloat16"):
        dcn_fused(x, torch.zeros(27, 32, 3, 3, device=dev), torch.zeros(27, device=dev),
                  torch.zeros(9, 32, 8, device=dev), torch.zeros(8, device=dev))
    f = torch.zeros(1, 1, 12, 4, 4, device=dev, dtype=torch.bfloat16)  # C = 12
    with pytest.raises(ValueError, match="C in"):
        warp_correlate(f, f[:, 0], torch.eye(4, device=dev).expand(1, 1, 4, 4),
                       torch.eye(4, device=dev).expand(1, 4, 4), torch.ones(1, 2, 4, 4, device=dev))
