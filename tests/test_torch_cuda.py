"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes that the main path does not give them (widths
that are no multiple of a block, every supported channel count, offsets
and projections that leave the image, zero offsets), each instantiation
(bf16: K1-K4, K5's row-4 instantiation, the fused view sum K7/K8;
float32: K5, K6, K3 and K4), and the autograd Functions that pair them
against autograd of the plain forwards, in both activation types; the
nvJPEG codec, the device fuser, the native fuser's kernel (depth maps of
unequal sizes, a reference that sees no source), and the compiled PNG
unfilter (host code built with the kernels) against numpy's, byte for
byte.

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
    from transmvsnet_tpu_torch.ops.cuda.dcn import deform_conv2d
    from transmvsnet_tpu_torch.ops.cuda.dcn_fused import dcn_fused
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import warp_correlate

    x = torch.randn(1, 32, 4, 4, device=dev)  # float32: K1 takes bf16 only
    with pytest.raises(TypeError, match="bfloat16"):
        dcn_fused(x, torch.zeros(27, 32, 3, 3, device=dev), torch.zeros(27, device=dev),
                  torch.zeros(9, 32, 8, device=dev), torch.zeros(8, device=dev))
    off = torch.zeros(1, 9, 4, 4, device=dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):  # K5 has no float16 instantiation
        deform_conv2d(x.half(), off, off, off, torch.zeros(9, 32, 8, device=dev), torch.zeros(8, device=dev))
    eye = torch.eye(4, device=dev)
    f = torch.zeros(1, 1, 12, 4, 4, device=dev, dtype=torch.bfloat16)  # C = 12
    with pytest.raises(ValueError, match="C in"):
        warp_correlate(f, f[:, 0], eye.expand(1, 1, 4, 4), eye.expand(1, 4, 4),
                       torch.ones(1, 2, 4, 4, device=dev))
    f = torch.zeros(1, 1, 8, 4, 4, device=dev)  # float32 source, bf16 reference
    with pytest.raises(TypeError, match="of one dtype"):
        warp_correlate(f, f[:, 0].to(torch.bfloat16), eye.expand(1, 1, 4, 4), eye.expand(1, 4, 4),
                       torch.ones(1, 2, 4, 4, device=dev))


def assert_close_f32(got, want, name):
    """Both sides compute in float32 from the same bf16 inputs; they differ
    by summation order (atomics land in any order): 1e-4 relative to each
    value plus 1e-4 of the largest value."""
    got, want = got.float(), want.float()
    tol = 1e-4 * want.abs() + 1e-4 * want.abs().max()
    bad = (got - want).abs() > tol
    assert not bad.any(), f"{name}: {int(bad.sum())} of {bad.numel()} outside; max {(got - want).abs().max()}"


@pytest.mark.parametrize("C,C_out", [(8, 8), (16, 32), (32, 16), (32, 8)])
@pytest.mark.parametrize("H,W,offsets", [(7, 13, 6.0), (33, 70, 0.0), (33, 70, 1.5)])
def test_dcn_bwd_matches_plain(dev, C, C_out, H, W, offsets):
    from transmvsnet_tpu_torch.ops.cuda.dcn_bwd import dcn_bwd, dcn_bwd_plain

    gen = torch.Generator().manual_seed(C * 10 + C_out + H)
    N = 3
    x = torch.randn(N, C, H, W, generator=gen).to(dev, torch.bfloat16)
    # Offsets of 6 px leave a 7x13 image for most taps; 0 puts every tap on
    # an integer, where the two-tap rule must still give offset gradients.
    dy = (torch.randn(N, 9, H, W, generator=gen) * offsets).to(dev)
    dx = (torch.randn(N, 9, H, W, generator=gen) * offsets).to(dev)
    mask = torch.rand(N, 9, H, W, generator=gen).to(dev)
    weight = (torch.randn(9, C, C_out, generator=gen) * 0.1).to(dev)
    g = torch.randn(N, C_out, H, W, generator=gen).to(dev)
    before = dcn_bwd.launches
    got = dcn_bwd(x, dy, dx, mask, weight, g)
    torch.cuda.synchronize()
    assert dcn_bwd.launches == before + 1
    want = dcn_bwd_plain(x, dy, dx, mask, weight, g)
    for a, b, name in zip(got, want, ("dx", "d_offset_y", "d_offset_x", "d_mask", "d_weight")):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        assert_close_f32(a, b, name)
    assert got[1].abs().max() > 0 and got[2].abs().max() > 0


@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("H,W", [(5, 9), (31, 47)])
def test_warp_correlate_bwd_matches_plain(dev, C, H, W):
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate_bwd import (
        warp_correlate_bwd,
        warp_correlate_bwd_plain,
    )

    gen = torch.Generator().manual_seed(C + H + 7)
    B, S, D = 2, 3, 5
    src = torch.randn(B, S, C, H, W, generator=gen).to(dev, torch.bfloat16)
    ref = torch.randn(B, C, H, W, generator=gen).to(dev, torch.bfloat16)
    proj = torch.eye(4).repeat(B, S + 1, 1, 1)
    proj[..., :3, :3] += 0.02 * torch.randn(B, S + 1, 3, 3, generator=gen)
    proj[..., 0, 0] = proj[..., 1, 1] = 0.8 * W
    proj[..., 0, 2], proj[..., 1, 2] = W / 2, H / 2
    proj[..., 0, 3] = 0.3 * W * torch.arange(S + 1)  # baselines: samples leave the frame
    depth = 2.0 + 3.0 * torch.rand(B, D, H, W, generator=gen)
    depth[:, 0, : H // 2] = -1.0  # behind the cameras: no gradient
    g = torch.randn(B, S, D, H, W, generator=gen)
    proj, depth, g = proj.to(dev), depth.to(dev), g.to(dev)
    args = (src, ref, proj[:, 1:].contiguous(), proj[:, 0].contiguous(), depth, g)
    before = warp_correlate_bwd.launches
    got = warp_correlate_bwd(*args)
    torch.cuda.synchronize()
    assert warp_correlate_bwd.launches == before + 1
    want = warp_correlate_bwd_plain(*args)
    for a, b, name in zip(got, want, ("dsrc", "dref")):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        assert_close_f32(a, b, name)


def test_autograd_functions_match_plain_autograd(dev):
    """K1+K3 and K2+K4 behind their autograd Functions against autograd of
    the plain forwards, on the same bf16 inputs."""
    from transmvsnet_tpu_torch.ops.cuda.dcn_fused import dcn_fused_plain
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import warp_correlate_plain
    from transmvsnet_tpu_torch.ops.vjp import dcn_fused_with_vjp, warp_correlate_with_vjp

    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 16, 19, 23, generator=gen).to(dev, torch.bfloat16)
    params = [(torch.randn(*s, generator=gen) * sc).to(dev)
              for s, sc in (((27, 16, 3, 3), 0.1), ((27,), 0.5), ((9, 16, 8), 0.1), ((8,), 0.1))]
    g = torch.randn(2, 8, 19, 23, generator=gen).to(dev)
    grads = []
    for fn in (dcn_fused_with_vjp, dcn_fused_plain):
        leaves = [x.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
        (fn(*leaves).float() * g).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b, name in zip(*grads, ("x", "k_off", "b_off", "weight", "bias")):
        # bf16 forward outputs one step apart at most, float32 backward.
        torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2 * b.abs().max().item(),
                                   msg=name)

    B, S, C, D, H, W = 1, 2, 8, 3, 9, 11
    src = torch.randn(B, S, C, H, W, generator=gen).to(dev, torch.bfloat16)
    ref = torch.randn(B, C, H, W, generator=gen).to(dev, torch.bfloat16)
    proj = torch.eye(4).repeat(B, S + 1, 1, 1)
    proj[..., 0, 0] = proj[..., 1, 1] = 8.0
    proj[..., 0, 3] = torch.arange(S + 1) * 2.0
    depth = (2.0 + torch.rand(B, D, H, W, generator=gen)).to(dev)
    proj = proj.to(dev)
    g = torch.randn(B, S, D, H, W, generator=gen).to(dev)
    grads = []
    for fn in (warp_correlate_with_vjp, warp_correlate_plain):
        s, r = src.clone().requires_grad_(), ref.clone().requires_grad_()
        (fn(s, r, proj[:, 1:], proj[:, 0], depth) * g).sum().backward()
        grads.append((s.grad, r.grad))
    for a, b, name in zip(*grads, ("src", "ref")):
        # Gradients rounded to the features' bf16.
        torch.testing.assert_close(a.float(), b.float(), rtol=2**-7, atol=1e-3 * b.abs().max().item(),
                                   msg=name)


def test_raw_launchers_refuse_inputs_that_need_a_gradient(dev):
    """The raw K1/K2 calls return tensors without a gradient: with grad mode
    on they refuse inputs that require one instead of detaching quietly."""
    from transmvsnet_tpu_torch.ops.cuda.dcn_fused import dcn_fused
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import warp_correlate

    x = torch.zeros(1, 8, 4, 4, device=dev, dtype=torch.bfloat16, requires_grad=True)
    args = (torch.zeros(27, 8, 3, 3, device=dev), torch.zeros(27, device=dev),
            torch.zeros(9, 8, 8, device=dev), torch.zeros(8, device=dev))
    with pytest.raises(RuntimeError, match="no gradient"):
        dcn_fused(x, *args)
    with torch.no_grad():
        assert dcn_fused(x, *args).shape == (1, 8, 4, 4)
    f = torch.zeros(1, 1, 8, 4, 4, device=dev, dtype=torch.bfloat16, requires_grad=True)
    eye = torch.eye(4, device=dev)
    with pytest.raises(RuntimeError, match="no gradient"):
        warp_correlate(f, f[:, 0].detach(), eye.expand(1, 1, 4, 4), eye.expand(1, 4, 4),
                       torch.ones(1, 2, 4, 4, device=dev))


def warp_scene(gen, dev, dtype, C, H, W, B=2, S=3, D=5):
    """Features in ``dtype``, projections whose baselines take samples out
    of the frame, hypotheses behind the cameras in the first plane."""
    src = torch.randn(B, S, C, H, W, generator=gen).to(dev, dtype)
    ref = torch.randn(B, C, H, W, generator=gen).to(dev, dtype)
    proj = torch.eye(4).repeat(B, S + 1, 1, 1)
    proj[..., :3, :3] += 0.02 * torch.randn(B, S + 1, 3, 3, generator=gen)
    proj[..., 0, 0] = proj[..., 1, 1] = 0.8 * W
    proj[..., 0, 2], proj[..., 1, 2] = W / 2, H / 2
    proj[..., 0, 3] = 0.3 * W * torch.arange(S + 1)
    depth = 2.0 + 3.0 * torch.rand(B, D, H, W, generator=gen)
    depth[:, 0, : H // 2] = -1.0
    proj, depth = proj.to(dev), depth.to(dev)
    return src, ref, proj[:, 1:].contiguous(), proj[:, 0].contiguous(), depth


def dcn_given_inputs(gen, dev, dtype, C, C_out, H, W, offsets, N=2):
    x = torch.randn(N, C, H, W, generator=gen).to(dev, dtype)
    dy = (torch.randn(N, 9, H, W, generator=gen) * offsets).to(dev)
    dx = (torch.randn(N, 9, H, W, generator=gen) * offsets).to(dev)
    mask = torch.rand(N, 9, H, W, generator=gen).to(dev)
    weight = (torch.randn(9, C, C_out, generator=gen) * 0.1).to(dev)
    bias = (torch.randn(C_out, generator=gen) * 0.1).to(dev)
    return x, dy, dx, mask, weight, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("C,C_out", [(8, 8), (16, 32), (32, 16), (32, 8)])
@pytest.mark.parametrize("H,W,offsets", [(7, 13, 4.0), (33, 70, 1.5)])
def test_dcn_matches_plain(dev, dtype, C, C_out, H, W, offsets):
    """K5 with given offsets and mask, each instantiation; offsets of 4 px
    leave a 7x13 image for most taps."""
    from transmvsnet_tpu_torch.ops.cuda.dcn import deform_conv2d, deform_conv2d_plain

    gen = torch.Generator().manual_seed(C * 100 + C_out + H)
    args = dcn_given_inputs(gen, dev, dtype, C, C_out, H, W, offsets)
    attr = "launches_f32" if dtype == torch.float32 else "launches"
    before = getattr(deform_conv2d, attr)
    got = deform_conv2d(*args)
    torch.cuda.synchronize()
    assert getattr(deform_conv2d, attr) == before + 1
    assert got.shape == (2, C_out, H, W) and got.dtype == dtype
    want = deform_conv2d_plain(*args)
    if dtype == torch.bfloat16:
        assert_close_bf16(got, want)
    else:
        assert_close_f32(got, want, "out")


@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("H,W", [(5, 9), (31, 47)])
def test_warp_correlate_f32_matches_plain(dev, C, H, W):
    """K6: the float32 instantiation of the warp-correlation forward."""
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import (
        warp_correlate,
        warp_correlate_plain,
    )

    args = warp_scene(torch.Generator().manual_seed(C + H + 3), dev, torch.float32, C, H, W)
    before = warp_correlate.launches_f32
    got = warp_correlate(*args)
    torch.cuda.synchronize()
    assert warp_correlate.launches_f32 == before + 1
    want = warp_correlate_plain(*args)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert (want == 0).float().mean() > 0.05
    # Same float32 arithmetic up to summation order and fused multiply-adds.
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3 * want.abs().max().item())


@pytest.mark.parametrize("C,C_out", [(8, 8), (16, 32), (32, 8)])
@pytest.mark.parametrize("H,W,offsets", [(7, 13, 6.0), (33, 70, 0.0), (33, 70, 1.5)])
def test_dcn_bwd_f32_matches_plain(dev, C, C_out, H, W, offsets):
    """K3's float32 instantiation, including zero offsets (two-tap rule)."""
    from transmvsnet_tpu_torch.ops.cuda.dcn_bwd import dcn_bwd, dcn_bwd_plain

    gen = torch.Generator().manual_seed(C * 10 + C_out + H + 1)
    x, dy, dx, mask, weight, _ = dcn_given_inputs(gen, dev, torch.float32, C, C_out, H, W, offsets, N=3)
    g = torch.randn(3, C_out, H, W, generator=gen).to(dev)
    before = dcn_bwd.launches_f32
    got = dcn_bwd(x, dy, dx, mask, weight, g)
    torch.cuda.synchronize()
    assert dcn_bwd.launches_f32 == before + 1
    want = dcn_bwd_plain(x, dy, dx, mask, weight, g)
    for a, b, name in zip(got, want, ("dx", "d_offset_y", "d_offset_x", "d_mask", "d_weight")):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        assert_close_f32(a, b, name)
    assert got[1].abs().max() > 0 and got[2].abs().max() > 0



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("C,C_out", [(32, 32), (32, 16), (32, 8)])
@pytest.mark.parametrize("H,W,offsets", [(5, 7, 6.0), (37, 100, 0.0), (37, 100, 6.0), (21, 70, 20.0)])
def test_dcn_bwd_tiles_and_halo_match_plain(dev, dtype, C, C_out, H, W, offsets):
    """K3 at the (C, C_out) the model uses, in both instantiations, where
    its tiles of 8 x 32 pixels and their dx windows (a halo of 2 px) are
    cut: an image smaller than one tile (5 x 7), ragged images that span
    many tiles (37 x 100: 5 x 4 tiles per image), and offsets of 6 and 20
    px, whose corners leave the window and go to dx directly."""
    from transmvsnet_tpu_torch.ops.cuda.dcn_bwd import dcn_bwd, dcn_bwd_plain

    gen = torch.Generator().manual_seed(C_out * 7 + H + int(offsets))
    x, dy, dx, mask, weight, _ = dcn_given_inputs(gen, dev, dtype, C, C_out, H, W, offsets, N=3)
    g = torch.randn(3, C_out, H, W, generator=gen).to(dev)
    attr = "launches_f32" if dtype == torch.float32 else "launches"
    before = getattr(dcn_bwd, attr)
    got = dcn_bwd(x, dy, dx, mask, weight, g)
    torch.cuda.synchronize()
    assert getattr(dcn_bwd, attr) == before + 1
    want = dcn_bwd_plain(x, dy, dx, mask, weight, g)
    for a, b, name in zip(got, want, ("dx", "d_offset_y", "d_offset_x", "d_mask", "d_weight")):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        assert_close_f32(a, b, name)
    assert got[1].abs().max() > 0 and got[2].abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dcn_bwd_repeats_within_tolerance(dev, dtype):
    """Two calls on the same inputs: the atomics into dx and dw land in
    another order each time, so the results may differ, but only by
    float32 summation order."""
    from transmvsnet_tpu_torch.ops.cuda.dcn_bwd import dcn_bwd

    gen = torch.Generator().manual_seed(31)
    x, dy, dx, mask, weight, _ = dcn_given_inputs(gen, dev, dtype, 32, 32, 64, 96, 2.0, N=4)
    g = torch.randn(4, 32, 64, 96, generator=gen).to(dev)
    first = dcn_bwd(x, dy, dx, mask, weight, g)
    second = dcn_bwd(x, dy, dx, mask, weight, g)
    for a, b, name in zip(second, first, ("dx", "d_offset_y", "d_offset_x", "d_mask", "d_weight")):
        assert_close_f32(a, b, name)


# The forward kernels' tiled body (csrc/dcn_fwd.cuh): K1, and K5 in each
# activation type. Offsets of about 0, 1.5 and 20 px: at 20 px the corners
# of a tile span more of a 33 x 70 image than the staged box holds, so the
# box is cut and the corners outside it are gathered from device memory.
FWD_KERNELS = ["k1", "k5_f32", "k5_bf16"]
FWD_OFFSETS = [0.0, 1.5, 20.0]


def dcn_fwd_call(kernel, gen, dev, C, C_out, H, W, offsets, N=2):
    """(kernel wrapper, plain version, args, launch counter attribute) for
    one forward kernel at offsets of about ``offsets`` px; K1's come from
    its offset conv (weights and biases scaled so), K5's are given."""
    from transmvsnet_tpu_torch.ops.cuda.dcn import deform_conv2d, deform_conv2d_plain
    from transmvsnet_tpu_torch.ops.cuda.dcn_fused import dcn_fused, dcn_fused_plain

    if kernel == "k1":
        x = torch.randn(N, C, H, W, generator=gen).to(dev, torch.bfloat16)
        k_off = (torch.randn(27, C, 3, 3, generator=gen) * offsets / (9 * C) ** 0.5).to(dev)
        b_off = (torch.randn(27, generator=gen) * offsets / 2).to(dev)
        weight = (torch.randn(9, C, C_out, generator=gen) * 0.1).to(dev)
        bias = (torch.randn(C_out, generator=gen) * 0.1).to(dev)
        return dcn_fused, dcn_fused_plain, (x, k_off, b_off, weight, bias), "launches"
    dtype = torch.float32 if kernel == "k5_f32" else torch.bfloat16
    args = dcn_given_inputs(gen, dev, dtype, C, C_out, H, W, offsets, N=N)
    return deform_conv2d, deform_conv2d_plain, args, "launches_f32" if dtype == torch.float32 else "launches"


@pytest.mark.parametrize("offsets", FWD_OFFSETS)
@pytest.mark.parametrize("H,W", [(7, 13), (33, 70), (9, 65)])
@pytest.mark.parametrize("C_out", [8, 16, 32])
@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("kernel", FWD_KERNELS)
def test_dcn_fwd_tiles_and_box_match_plain(dev, kernel, C, C_out, H, W, offsets):
    """Every (C, C_out), ragged tiles (no size is a multiple of 8 x 32),
    batch 2, at the existing tolerances."""
    gen = torch.Generator().manual_seed(C * 1000 + C_out * 10 + H + int(offsets))
    fn, plain, args, attr = dcn_fwd_call(kernel, gen, dev, C, C_out, H, W, offsets)
    before = getattr(fn, attr)
    got = fn(*args)
    torch.cuda.synchronize()
    assert getattr(fn, attr) == before + 1
    assert got.shape == (2, C_out, H, W) and got.dtype == args[0].dtype
    want = plain(*args)
    if got.dtype == torch.bfloat16:
        assert_close_bf16(got, want)
    else:
        assert_close_f32(got, want, "out")


# Offsets of hundreds of pixels, all downwards and spread along x over
# +-1000 px: a tile's corners lie far below it and span more than the box
# holds, so the box is cut to the tile widened on each side. For most
# tiles the cut box then holds none of the corners (K5 float32's, the
# smallest, at 500 px; every kernel's at 820 px), and every corner is
# gathered from device memory.
@pytest.mark.parametrize("far", [500.0, 820.0])
@pytest.mark.parametrize("kernel", FWD_KERNELS)
def test_dcn_fwd_far_offsets_match_plain(dev, kernel, far):
    from transmvsnet_tpu_torch.ops.cuda.dcn import deform_conv2d, deform_conv2d_plain
    from transmvsnet_tpu_torch.ops.cuda.dcn_fused import dcn_fused, dcn_fused_plain

    H, W, C, spread = 864, 2048, 32, 1000.0
    gen = torch.Generator().manual_seed(int(far))
    dtype = torch.float32 if kernel == "k5_f32" else torch.bfloat16
    x = torch.randn(1, C, H, W, generator=gen).to(dev, dtype)
    weight = (torch.randn(9, C, C, generator=gen) * 0.1).to(dev)
    bias = (torch.randn(C, generator=gen) * 0.1).to(dev)
    if kernel == "k1":
        # Per tap, dy = far and dx from -spread to +spread, plus the conv's
        # ~0.3 px per pixel.
        k_off = (torch.randn(27, C, 3, 3, generator=gen) * 0.02).to(dev)
        b_off = torch.randn(27, generator=gen)
        b_off[0:18:2] = far
        b_off[1:18:2] = spread * (torch.arange(9.0) - 4) / 4
        fn, plain, args = dcn_fused, dcn_fused_plain, (x, k_off, b_off.to(dev), weight, bias)
    else:
        dy = (far + torch.randn(1, 9, H, W, generator=gen) * 0.5).to(dev)
        dx = ((torch.rand(1, 9, H, W, generator=gen) * 2 - 1) * spread).to(dev)
        mask = torch.rand(1, 9, H, W, generator=gen).to(dev)
        fn, plain, args = deform_conv2d, deform_conv2d_plain, (x, dy, dx, mask, weight, bias)
    got = fn(*args)
    want = plain(*args)
    if dtype == torch.bfloat16:
        assert_close_bf16(got, want)
    else:
        assert_close_f32(got, want, "out")
    # The rows whose corners reach the image are not just the bias.
    assert (want[:, :, :40].float() - bias.view(1, -1, 1, 1)).abs().amax() > 0.5


@pytest.mark.parametrize("kernel", FWD_KERNELS)
def test_dcn_fwd_is_bitwise_repeatable(dev, kernel):
    """No atomics in the forward body: two launches give the same bits."""
    gen = torch.Generator().manual_seed(41)
    fn, _, args, _ = dcn_fwd_call(kernel, gen, dev, 32, 32, 64, 96, 2.0, N=4)
    first = fn(*args)
    second = fn(*args)
    assert torch.equal(first, second)


@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("H,W", [(5, 9), (31, 47)])
def test_warp_correlate_bwd_f32_matches_plain(dev, C, H, W):
    """K4's float32 instantiation."""
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate_bwd import (
        warp_correlate_bwd,
        warp_correlate_bwd_plain,
    )

    gen = torch.Generator().manual_seed(C + H + 11)
    fwd = warp_scene(gen, dev, torch.float32, C, H, W)
    g = torch.randn(*fwd[0].shape[:2], fwd[4].shape[1], H, W, generator=gen).to(dev)
    before = warp_correlate_bwd.launches_f32
    got = warp_correlate_bwd(*fwd, g)
    torch.cuda.synchronize()
    assert warp_correlate_bwd.launches_f32 == before + 1
    want = warp_correlate_bwd_plain(*fwd, g)
    for a, b, name in zip(got, want, ("dsrc", "dref")):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        assert_close_f32(a, b, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dcn_function_matches_plain_autograd(dev, dtype):
    """dcn_with_vjp (K5 + K3 in x's dtype) against autograd of K5's plain
    version: gradients to x, the offsets, the mask, the weight and bias."""
    from transmvsnet_tpu_torch.ops.cuda.dcn import deform_conv2d_plain
    from transmvsnet_tpu_torch.ops.vjp import dcn_with_vjp

    gen = torch.Generator().manual_seed(9)
    args = dcn_given_inputs(gen, dev, dtype, 16, 8, 19, 23, 1.5)
    g = torch.randn(2, 8, 19, 23, generator=gen).to(dev)
    grads = []
    for fn in (dcn_with_vjp, deform_conv2d_plain):
        leaves = [t.clone().requires_grad_() for t in args]
        (fn(*leaves).float() * g).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b, name in zip(*grads, ("x", "offset_y", "offset_x", "mask", "weight", "bias")):
        if dtype == torch.bfloat16:
            # bf16 forward outputs one step apart at most, float32 backward;
            # the x gradient rounded to bf16.
            torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2 * b.abs().max().item(),
                                       msg=name)
        else:
            assert_close_f32(a, b, name)


def test_warp_function_f32_matches_plain_autograd(dev):
    """warp_correlate_with_vjp on float32 features (K6 + K4's float32
    instantiation) against autograd of the plain forward."""
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import warp_correlate_plain
    from transmvsnet_tpu_torch.ops.vjp import warp_correlate_with_vjp

    gen = torch.Generator().manual_seed(13)
    src, ref, sp, rp, depth = warp_scene(gen, dev, torch.float32, 8, 9, 11, B=1, S=2, D=3)
    g = torch.randn(1, 2, 3, 9, 11, generator=gen).to(dev)
    grads = []
    for fn in (warp_correlate_with_vjp, warp_correlate_plain):
        s, r = src.clone().requires_grad_(), ref.clone().requires_grad_()
        (fn(s, r, sp, rp, depth) * g).sum().backward()
        grads.append((s.grad, r.grad))
    for a, b, name in zip(*grads, ("src", "ref")):
        assert a.dtype == torch.float32, name
        assert_close_f32(a, b, name)


@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("H,W", [(5, 9), (31, 47), (40, 300)])
def test_warp_correlate_wsum_matches_plain(dev, C, H, W):
    """K7: the view-weighted sum over the source views, with zero weights
    at some pixels; 40x300 spans more than one block per batch."""
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import (
        warp_correlate_wsum,
        warp_correlate_wsum_plain,
    )

    gen = torch.Generator().manual_seed(C + H + 17)
    args = warp_scene(gen, dev, torch.bfloat16, C, H, W)
    vw = torch.rand(2, 3, H, W, generator=gen)
    vw[:, 1, : H // 3] = 0.0
    vw = vw.to(dev)
    before = warp_correlate_wsum.launches
    got = warp_correlate_wsum(*args, vw)
    torch.cuda.synchronize()
    assert warp_correlate_wsum.launches == before + 1
    want = warp_correlate_wsum_plain(*args, vw)
    assert got.shape == (2, 5, H, W) and got.dtype == torch.float32
    # Same float32 arithmetic up to summation order and fused multiply-adds.
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3 * want.abs().max().item())


@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("H,W", [(5, 9), (31, 47)])
def test_warp_correlate_wsum_bwd_matches_plain(dev, C, H, W):
    """K8: dsrc, dref and dvw, with zero weights at some pixels (dvw is
    still owed there)."""
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate_bwd import (
        warp_correlate_wsum_bwd,
        warp_correlate_wsum_bwd_plain,
    )

    gen = torch.Generator().manual_seed(C + H + 19)
    fwd = warp_scene(gen, dev, torch.bfloat16, C, H, W)
    vw = torch.rand(2, 3, H, W, generator=gen)
    vw[:, 1, : H // 3] = 0.0
    g = torch.randn(2, 5, H, W, generator=gen)
    vw, g = vw.to(dev), g.to(dev)
    before = warp_correlate_wsum_bwd.launches
    got = warp_correlate_wsum_bwd(*fwd, vw, g)
    torch.cuda.synchronize()
    assert warp_correlate_wsum_bwd.launches == before + 1
    want = warp_correlate_wsum_bwd_plain(*fwd, vw, g)
    for a, b, name in zip(got, want, ("dsrc", "dref", "dvw")):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        assert_close_f32(a, b, name)
    assert got[2][:, 1, : H // 3].abs().max() > 0


def test_wsum_function_matches_plain_autograd(dev):
    """warp_correlate_wsum_with_vjp (K7 + K8) against autograd of K7's plain
    version: gradients to the source and reference features and the view
    weights; none to the projections and hypotheses."""
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import warp_correlate_wsum_plain
    from transmvsnet_tpu_torch.ops.vjp import warp_correlate_wsum_with_vjp

    gen = torch.Generator().manual_seed(23)
    src, ref, sp, rp, depth = warp_scene(gen, dev, torch.bfloat16, 16, 9, 11, B=1, S=2, D=3)
    vw = torch.rand(1, 2, 9, 11, generator=gen).to(dev)
    g = torch.randn(1, 3, 9, 11, generator=gen).to(dev)
    grads = []
    for fn in (warp_correlate_wsum_with_vjp, warp_correlate_wsum_plain):
        leaves = [t.clone().requires_grad_() for t in (src, ref, sp, rp, depth, vw)]
        (fn(*leaves) * g).sum().backward()
        grads.append([t.grad for t in leaves])
    assert all(t is None for t in grads[0][2:5])
    for i, name in ((0, "src"), (1, "ref"), (5, "vw")):
        a, b = grads[0][i], grads[1][i]
        assert a.dtype == b.dtype, name
        # Gradients of the features rounded to their bf16; the weights'
        # float32 up to summation order.
        torch.testing.assert_close(a.float(), b.float(), rtol=2**-7, atol=1e-3 * b.abs().max().item(),
                                   msg=name)


def test_wsum_wrappers_refuse_float32_features_and_gradients(dev):
    """K7 and K8 have bf16 instantiations only; the raw K7 call has no
    gradient, so with grad mode on it refuses inputs that require one."""
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import warp_correlate_wsum
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate_bwd import warp_correlate_wsum_bwd

    gen = torch.Generator().manual_seed(29)
    src, ref, sp, rp, depth = warp_scene(gen, dev, torch.float32, 8, 5, 9)
    vw = torch.rand(2, 3, 5, 9, generator=gen).to(dev)
    with pytest.raises(TypeError, match="bfloat16 features"):
        warp_correlate_wsum(src, ref, sp, rp, depth, vw)
    with pytest.raises(TypeError, match="bfloat16 features"):
        warp_correlate_wsum_bwd(src, ref, sp, rp, depth, vw, torch.zeros(2, 5, 5, 9, device=dev))
    w = vw.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        warp_correlate_wsum(src.to(torch.bfloat16), ref.to(torch.bfloat16), sp, rp, depth, w)


def warp_bwd_scene(gen, dev, dtype, C, H, W, kind, D=5, S=3):
    """``warp_scene`` with S source views and D hypotheses (baselines take
    samples out of the frame) or, with kind "squeezed", source cameras of 1/20 the reference's
    focal length, which put blocks of reference pixels onto a few source
    cells (their corners coincide), or, with kind "outside", baselines that
    take every sample out of the frame, or, with kind "behind", every
    hypothesis behind every camera."""
    src, ref, sp, rp, depth = warp_scene(gen, dev, dtype, C, H, W, S=S, D=D)
    if kind == "behind":
        depth = -depth.abs()
    elif kind == "squeezed":
        sp = sp.clone()
        sp[..., 0, 0] *= 0.05
        sp[..., 1, 1] *= 0.05
    elif kind == "outside":
        sp = sp.clone()
        sp[..., 0, 3] += 20.0 * W
    return src, ref, sp, rp, depth


# K4 in both dtypes and K8 in both instantiations: (features, need_dvw).
WARP_BWD_KERNELS = {"k4_bf16": (torch.bfloat16, None), "k4_f32": (torch.float32, None),
                    "k8_dvw": (torch.bfloat16, True), "k8_no_dvw": (torch.bfloat16, False)}


def warp_bwd_call(kernel, gen, dev, C, H, W, kind):
    """(kernel call, its plain version, launch counter (wrapper, attribute))
    of one of WARP_BWD_KERNELS on a scene; K8's view weights are zero over
    a band of one view."""
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate_bwd import (
        warp_correlate_bwd,
        warp_correlate_bwd_plain,
        warp_correlate_wsum_bwd,
        warp_correlate_wsum_bwd_plain,
    )

    dtype, need_dvw = WARP_BWD_KERNELS[kernel]
    fwd = warp_bwd_scene(gen, dev, dtype, C, H, W, kind)
    B, S, D = fwd[0].shape[0], fwd[0].shape[1], fwd[4].shape[1]
    if need_dvw is None:
        g = torch.randn(B, S, D, H, W, generator=gen).to(dev)
        counter = (warp_correlate_bwd, "launches_f32" if dtype == torch.float32 else "launches")
        return (lambda: warp_correlate_bwd(*fwd, g)), (lambda: warp_correlate_bwd_plain(*fwd, g)), counter
    vw = torch.rand(B, S, H, W, generator=gen)
    vw[:, 1, : H // 3] = 0.0
    vw = vw.to(dev)
    g = torch.randn(B, D, H, W, generator=gen).to(dev)
    return ((lambda: warp_correlate_wsum_bwd(*fwd, vw, g, need_dvw=need_dvw)),
            (lambda: warp_correlate_wsum_bwd_plain(*fwd, vw, g, need_dvw=need_dvw)),
            (warp_correlate_wsum_bwd, "launches"))


@pytest.mark.parametrize("kernel", list(WARP_BWD_KERNELS))
@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("H,W,kind", [(5, 9, "frame"), (40, 300, "frame"), (31, 47, "squeezed"),
                                      (64, 129, "squeezed"), (23, 130, "outside")])
def test_warp_bwd_kernels_match_plain(dev, kernel, C, H, W, kind):
    """K4 (bf16, float32) and K8 (with and without dvw) at ragged shapes
    (no width a multiple of a tile; 40x300 and 64x129 span many tiles),
    with coinciding corners (squeezed) and with every sample off the
    frame (outside: all gradients zero)."""
    gen = torch.Generator().manual_seed(C * 1000 + H * 7 + W)
    call, plain, (counter, attr) = warp_bwd_call(kernel, gen, dev, C, H, W, kind)
    before = getattr(counter, attr)
    got = call()
    torch.cuda.synchronize()
    assert getattr(counter, attr) == before + 1
    want = plain()
    assert (got[-1] is None) == (want[-1] is None)
    for a, b, name in zip(got, want, ("dsrc", "dref", "dvw")):
        if b is None:
            continue
        assert a.shape == b.shape and a.dtype == torch.float32 and a.is_contiguous(), name
        assert_close_f32(a, b, name)
    if kind == "outside":
        assert not any(t.any() for t in got if t is not None)
    else:
        assert got[0].abs().max() > 0 and got[1].abs().max() > 0


@pytest.mark.parametrize("kernel", list(WARP_BWD_KERNELS))
def test_warp_bwd_two_launches_agree(dev, kernel):
    """The reductions add in no fixed order: two launches on the same
    inputs agree within the tolerance, not bitwise."""
    gen = torch.Generator().manual_seed(43)
    call, _, _ = warp_bwd_call(kernel, gen, dev, 32, 48, 130, "squeezed")
    first, second = call(), call()
    torch.cuda.synchronize()
    for a, b, name in zip(first, second, ("dsrc", "dref", "dvw")):
        if a is not None:
            assert_close_f32(a, b, name)


# K2, K6 and K7: (features, wrapper, launch counter attribute).
WARP_FWD_KERNELS = {"k2_bf16": (torch.bfloat16, "warp_correlate", "launches"),
                    "k6_f32": (torch.float32, "warp_correlate", "launches_f32"),
                    "k7_wsum": (torch.bfloat16, "warp_correlate_wsum", "launches")}


def assert_within_warp_gate(got, want):
    """The forward kernels' gate: float32 arithmetic up to summation order
    and fused multiply-adds in the projection (~1e-5 px of position)."""
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3 * want.abs().max().item())


def warp_fwd_call(kernel, gen, dev, C, H, W, kind, D, S=3):
    """(kernel call, its plain version, launch counter (wrapper, attribute),
    output shape) of one of WARP_FWD_KERNELS on a scene of batch 2; K7's
    view weights are zero over a band of rows of one view."""
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import (
        warp_correlate,
        warp_correlate_plain,
        warp_correlate_wsum,
        warp_correlate_wsum_plain,
    )

    dtype, wrapper, attr = WARP_FWD_KERNELS[kernel]
    args = warp_bwd_scene(gen, dev, dtype, C, H, W, kind, D=D, S=S)
    if wrapper == "warp_correlate":
        return ((lambda: warp_correlate(*args)), (lambda: warp_correlate_plain(*args)), (warp_correlate, attr),
                (2, S, D, H, W))
    vw = torch.rand(2, S, H, W, generator=gen)
    vw[:, S // 2, : H // 3] = 0.0
    vw = vw.to(dev)
    return ((lambda: warp_correlate_wsum(*args, vw)), (lambda: warp_correlate_wsum_plain(*args, vw)),
            (warp_correlate_wsum, attr), (2, D, H, W))


@pytest.mark.parametrize("kernel", list(WARP_FWD_KERNELS))
@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("H,W,kind,D", [(5, 9, "frame", 5), (40, 300, "frame", 7), (31, 47, "squeezed", 8),
                                        (23, 130, "behind", 6), (24, 70, "frame", 19)])
@pytest.mark.parametrize("S", [1, 3, 4, 6])
def test_warp_fwd_kernels_match_plain(dev, kernel, C, H, W, kind, D, S):
    """K2, K6 and K7 at ragged shapes (no width a multiple of a block's
    pixels, hypotheses no multiple of a group's round or of K7's chunk;
    with D = 19 each of the two batches spans three of K7's chunks of 8,
    the last one partly full), at one source view, the model's four and
    counts no power of two (3, 6), with coinciding corners (squeezed), and
    with every hypothesis behind the cameras (behind: the output is
    exactly zero)."""
    gen = torch.Generator().manual_seed(C * 1000 + H * 7 + W + D)
    call, plain, (counter, attr), shape = warp_fwd_call(kernel, gen, dev, C, H, W, kind, D, S)
    before = getattr(counter, attr)
    got = call()
    torch.cuda.synchronize()
    assert getattr(counter, attr) == before + 1
    want = plain()
    assert got.shape == want.shape == shape and got.dtype == torch.float32 and got.is_contiguous()
    if kind == "behind":
        assert not got.any()
    else:
        assert (want == 0).any() and (want != 0).float().mean() > 0.05
        assert_within_warp_gate(got, want)


@pytest.mark.parametrize("C", [8, 16, 32])
def test_wsum_keeps_the_nan_of_a_view_of_weight_zero(dev, C):
    """K7 gives NaN wherever a view of weight zero samples NaN features
    with a corner on the plane, as its plain version does (0 * NaN; the
    plain version is NaN at every output, for it also multiplies the
    corners off the plane by zero). Its other outputs are the other views'
    sum."""
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import (
        warp_correlate_plain,
        warp_correlate_wsum,
        warp_correlate_wsum_plain,
    )

    gen = torch.Generator().manual_seed(61 + C)
    src, ref, sp, rp, depth = warp_bwd_scene(gen, dev, torch.bfloat16, C, 24, 70, "frame", D=11)
    vw = torch.rand(2, 3, 24, 70, generator=gen)
    vw[:, 1] = 0.0
    vw = vw.to(dev)
    # Where view 1's samples have a corner of positive weight on the plane.
    ones = torch.ones_like(src)
    on_plane = warp_correlate_plain(ones, torch.ones_like(ref), sp, rp, depth)[:, 1] > 0
    src[:, 1] = 0.0
    others = warp_correlate_wsum_plain(src, ref, sp, rp, depth, vw)
    src[:, 1] = float("nan")
    got = warp_correlate_wsum(src, ref, sp, rp, depth, vw)
    torch.cuda.synchronize()
    assert warp_correlate_wsum_plain(src, ref, sp, rp, depth, vw).isnan().all()
    assert 0.05 < on_plane.float().mean() < 0.95
    assert got[on_plane].isnan().all()
    finite = ~got.isnan()
    assert finite.any()
    assert_within_warp_gate(got[finite], others[finite])


@pytest.mark.parametrize("kernel", list(WARP_FWD_KERNELS))
@pytest.mark.parametrize("C", [8, 16, 32])
def test_warp_fwd_is_bitwise_repeatable(dev, kernel, C):
    """No atomics and sums in a fixed order: two launches on the same
    inputs agree bit for bit."""
    gen = torch.Generator().manual_seed(47 + C)
    call, _, _, _ = warp_fwd_call(kernel, gen, dev, C, 48, 130, "squeezed", 9)
    first, second = call(), call()
    torch.cuda.synchronize()
    assert first.abs().max() > 0 and torch.equal(first, second)


# --- The evaluation pipeline on the card: nvJPEG and the device fuser ----

CODEC_FIXTURES = ("synthetic_420", "synthetic_444")


def _fixture(name):
    import pathlib

    return pathlib.Path(__file__).resolve().parent / "data" / "torch_codec" / name


def _levels(img):
    return (img * 255).round().to(torch.uint8).cpu().numpy().astype(int)


@pytest.mark.parametrize("name", CODEC_FIXTURES)
def test_nvjpeg_decode_matches_libjpeg(dev, name):
    """nvJPEG's decode against the stored libjpeg decode: its IDCT and
    chroma interpolation differ, by at most 1 level on average and 16 at
    worst."""
    import numpy as np

    from transmvsnet_tpu_torch.data import image_io

    before = image_io.jpeg_decode.launches
    img = image_io.read_image(str(_fixture(f"{name}.jpg")), dev)
    assert image_io.jpeg_decode.launches == before + 1
    assert img.device.type == "cuda" and img.dtype == torch.float32 and img.shape == (64, 96, 3)
    d = np.abs(_levels(img) - np.load(_fixture(f"{name}.npy")))
    assert d.mean() <= 1.0 and d.max() <= 16, (d.mean(), d.max())


@pytest.mark.parametrize("h,w", [(240, 320), (97, 131)])
def test_nvjpeg_encode_round_trip(dev, tmp_path, h, w):
    """write_jpeg on the card writes a baseline 4:2:0 JPEG that reads back
    within the decode gate. The scene is smooth at pixel scale, as the
    pipeline's 1600x1200 images are (a texture period of tens of pixels;
    libjpeg's own round trip of such an image is about half a level)."""
    import numpy as np

    from transmvsnet_tpu_torch.data import image_io
    from transmvsnet_tpu_torch.data.synthetic import FOCAL, SyntheticScene

    img, _ = SyntheticScene(1, h, w, seed=0, focal=FOCAL * w / 24).render(0)
    u8 = torch.from_numpy((img * 255).astype(np.uint8)).to(dev)
    before = image_io.jpeg_encode.launches
    image_io.write_jpeg(str(tmp_path / "a.jpg"), u8)
    assert image_io.jpeg_encode.launches == before + 1
    data = (tmp_path / "a.jpg").read_bytes()
    sof = data.index(b"\xff\xc0")
    assert data[sof + 11] == 0x22  # luma sampled 2x2: 4:2:0
    d = np.abs(_levels(image_io.read_image(str(tmp_path / "a.jpg"), dev)) - u8.cpu().numpy().astype(int))
    assert d.mean() <= 1.0 and d.max() <= 16, (d.mean(), d.max())


def test_nvjpeg_raises_and_decodes_from_threads(dev, tmp_path):
    import concurrent.futures

    from transmvsnet_tpu_torch.data import image_io

    (tmp_path / "bad.jpg").write_bytes(b"\xff\xd8\xff\xe0not a jpeg")
    with pytest.raises(RuntimeError, match="nvJPEG"):
        image_io.read_image(str(tmp_path / "bad.jpg"), dev)
    data = _fixture("synthetic_420.jpg").read_bytes()
    one = image_io.jpeg_decode(data, dev)
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        outs = list(pool.map(lambda _: image_io.jpeg_decode(data, dev), range(32)))
    torch.cuda.synchronize()
    assert all(torch.equal(o, one) for o in outs)


@pytest.mark.parametrize("src,dst", [((1200, 1600), (864, 1152)), ((1080, 1920), (1056, 1920)),
                                     ((37, 53), (64, 80))])
def test_resize_on_the_card_matches_the_taps_on_cpu(dev, src, dst):
    from transmvsnet_tpu_torch.data.image_io import resize_bilinear, resize_taps

    img = torch.rand(*src, 3, generator=torch.Generator().manual_seed(0))
    got = resize_bilinear(img.to(dev), dst)
    assert got.device.type == "cuda" and got.shape == (*dst, 3)
    torch.testing.assert_close(got.cpu(), resize_taps(img, dst), rtol=0, atol=1e-6)


def _write_fusion_scan(root, dev):
    """A 4-view 64x96 synthetic scan: depths with 0.4% noise and a block of
    zero depth per view, random confidences (tests/test_torch_fusion.py's
    noisy scan, written without cv2)."""
    import os

    import numpy as np

    from transmvsnet_tpu_torch.data.cams import write_cam_file
    from transmvsnet_tpu_torch.data.image_io import write_jpeg
    from transmvsnet_tpu_torch.data.pfm import save_pfm
    from transmvsnet_tpu_torch.data.synthetic import SyntheticScene

    scene = SyntheticScene(num_views=4, height=64, width=96)
    rng = np.random.RandomState(5)
    for sub in ("depth_est", "confidence", "cams", "images"):
        os.makedirs(root / sub)
    for v in range(scene.V):
        img, depth = scene.render(v)
        depth = (depth * (1 + 0.004 * rng.randn(*depth.shape))).astype(np.float32)
        depth[20:30, 10 + 5 * v : 40 + 5 * v] = 0.0
        save_pfm(str(root / f"depth_est/{v:0>8}.pfm"), depth)
        save_pfm(str(root / f"confidence/{v:0>8}.pfm"), rng.rand(*depth.shape).astype(np.float32))
        pair = np.zeros((2, 4, 4), dtype=np.float32)
        pair[0] = scene.extrinsics[v]
        pair[1, :3, :3] = scene.K
        write_cam_file(str(root / f"cams/{v:0>8}_cam.txt"), pair, "1.0 0.01")
        write_jpeg(str(root / f"images/{v:0>8}.jpg"), torch.from_numpy((img * 255).astype(np.uint8)).to(dev))
    with open(root / "pair.txt", "w") as f:
        f.write(f"{scene.V}\n")
        for v in range(scene.V):
            others = [o for o in range(scene.V) if o != v]
            f.write(f"{v}\n{len(others)} " + " ".join(f"{o} 10.0" for o in others) + "\n")


@pytest.mark.parametrize("mode", ["dynamic", "normal"])
def test_device_fuser_matches_its_cpu_run(dev, tmp_path, mode):
    """The fuser on the card against the same code on CPU tensors: kept
    pixels equal, points equal to float64 rounding (the CPU run reads the
    reference image with PIL; colours within the decoders' levels)."""
    from transmvsnet_tpu_torch.data.cams import read_pair_file
    from transmvsnet_tpu_torch.fusion.dynamic import FusionParams, fuse_view

    _write_fusion_scan(tmp_path, dev)
    params = FusionParams(photo_threshold=0.3, thres_view=2, mode=mode)
    for ref, srcs in read_pair_file(str(tmp_path / "pair.txt")):
        xyz, rgb, mask = fuse_view(str(tmp_path), ref, srcs, params, dev)
        assert xyz.device.type == "cuda" and xyz.dtype == torch.float64
        cxyz, crgb, cmask = fuse_view(str(tmp_path), ref, srcs, params, torch.device("cpu"))
        assert torch.equal(mask.cpu(), cmask) and 0.2 < cmask.float().mean() < 1.0
        torch.testing.assert_close(xyz.cpu(), cxyz, rtol=1e-9, atol=1e-9)
        assert (rgb.cpu().int() - crgb.int()).abs().max() <= 16


def _write_native_scan(root):
    """A native-fuser scan of 5 views: the synthetic scene's 4 views at
    64x96 with 0.4% depth noise and a block of zero depth, view 3 at 48x72
    (sources of unequal sizes), and view 4, view 0's depths behind a camera
    turned round: as a reference it sees no source, as a source nothing."""
    import os

    import numpy as np

    from transmvsnet_tpu_torch.data.cams import write_cam_file
    from transmvsnet_tpu_torch.data.pfm import save_pfm
    from transmvsnet_tpu_torch.data.synthetic import SyntheticScene

    big = SyntheticScene(num_views=4, height=64, width=96)
    small = SyntheticScene(num_views=4, height=48, width=72, focal=90.0)
    rng = np.random.RandomState(7)
    for sub in ("depth_est", "cams"):
        os.makedirs(root / sub)
    turned = big.extrinsics[0].copy()
    turned[:3, :3] = np.diag([-1.0, 1.0, -1.0]) @ turned[:3, :3]
    for v in range(5):
        scene = small if v == 3 else big
        depth = scene.render(v % 4)[1]
        depth = (depth * (1 + 0.004 * rng.randn(*depth.shape))).astype(np.float32)
        depth[20:30, 10 + 5 * v : 40 + 5 * v] = 0.0
        save_pfm(str(root / f"depth_est/{v:0>8}.pfm"), depth)
        pair = np.zeros((2, 4, 4), dtype=np.float32)
        pair[0] = turned if v == 4 else scene.extrinsics[v]
        pair[1, :3, :3] = scene.K
        write_cam_file(str(root / f"cams/{v:0>8}_cam.txt"), pair, "1.0 0.01")
    entries = [(0, [1, 2, 3, 4]), (1, [0, 2, 3]), (2, [3, 1, 0, 4]), (3, [2, 1, 0]), (4, [0, 1, 2, 3])]
    with open(root / "pair.txt", "w") as f:
        f.write(f"{len(entries)}\n")
        for ref, srcs in entries:
            f.write(f"{ref}\n{len(srcs)} " + " ".join(f"{o} 10.0" for o in srcs) + "\n")


def test_native_fuse_matches_plain(dev, tmp_path):
    """The native fuser's kernel against its plain version on CPU tensors:
    every operation is rounded alike in both, so counts and points are
    equal bit for bit."""
    from transmvsnet_tpu_torch.fusion import native
    from transmvsnet_tpu_torch.ops.cuda.native_fuse import native_fuse

    _write_native_scan(tmp_path)
    on_card, on_cpu = native.load_scan(str(tmp_path), dev), native.load_scan(str(tmp_path), "cpu")
    assert on_card.hw[3] == (48, 72) and on_card.hw[0] == (64, 96)
    for (ref, srcs, fbs), (_, csrcs, cfbs) in zip(on_card.entries, on_cpu.entries):
        before = native_fuse.launches
        count, xyz = native_fuse(on_card.depths, on_card.offsets, on_card.sizes, on_card.cams, ref,
                                 on_card.hw[ref], srcs, fbs, 0.0, 1e9, 0.25)
        torch.cuda.synchronize()
        assert native_fuse.launches == before + 1
        want_count, want_xyz = native_fuse(on_cpu.depths, on_cpu.offsets, on_cpu.sizes, on_cpu.cams, ref,
                                           on_cpu.hw[ref], csrcs, cfbs, 0.0, 1e9, 0.25)
        assert torch.equal(count.cpu(), want_count) and torch.equal(xyz.cpu(), want_xyz)
        valid = want_count > 0
        if ref == 4:  # sees no source
            assert (want_count[valid] == 1).all()
        else:
            assert (want_count >= 3).sum() > 0.3 * valid.sum()


def filtered_png(img, types) -> bytes:
    """A PNG of uint8 ``img`` ([H, W] grey, [H, W, 3] RGB or [H, W, 4]
    RGBA) whose row y uses filter ``types[y]`` (0-4), encoded with numpy
    and zlib."""
    import struct
    import zlib

    import numpy as np

    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(h, w * bpp).astype(np.int16)
    a, b, c = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    a[:, bpp:], b[1:], c[1:, bpp:] = x[:, :-bpp], x[:-1], x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    rows = ((x - preds[np.asarray(types), np.arange(h)]) & 255).astype(np.uint8)
    raw = np.concatenate([np.asarray(types, np.uint8)[:, None], rows], axis=1).tobytes()

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[bpp], 0, 0, 0)
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


@pytest.mark.parametrize("types", ["0", "1", "2", "3", "4", "mixed"])
@pytest.mark.parametrize("w", [1, 7, 1601])
@pytest.mark.parametrize("channels", [1, 3, 4], ids=["grey", "rgb", "rgba"])
def test_compiled_png_unfilter_equals_numpy(dev, channels, w, types):
    """The compiled unfilter (host code from csrc/png_unfilter.cu) against
    the numpy ``_unfilter``, byte for byte, on noise, which every filter
    leaves noisy."""
    import numpy as np

    from transmvsnet_tpu_torch.data import image_io

    rng = np.random.RandomState(channels * 10 + w)
    h = 11
    img = rng.randint(0, 256, (h, w) if channels == 1 else (h, w, channels)).astype(np.uint8)
    row_types = rng.randint(0, 5, h) if types == "mixed" else [int(types)] * h
    png = filtered_png(img, row_types)
    before = image_io.png_unfilter.launches
    got = image_io.decode_png(png, dev)
    assert image_io.png_unfilter.launches == before + 1
    np.testing.assert_array_equal(got, image_io.decode_png(png, "cpu"))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("types", ["4", "mixed"])
def test_compiled_png_unfilter_at_dtu_size_and_from_threads(dev, types):
    """A 1600x1200 RGB image (DTU's training images), decoded by eight
    threads at once, as the data loader's threads decode."""
    import concurrent.futures

    import numpy as np

    from transmvsnet_tpu_torch.data import image_io

    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (1200, 1600, 3)).astype(np.uint8)
    png = filtered_png(img, rng.randint(0, 5, 1200) if types == "mixed" else [4] * 1200)
    want = image_io.decode_png(png, "cpu")
    np.testing.assert_array_equal(want, img)
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        for got in pool.map(lambda _: image_io.decode_png(png, dev), range(8)):
            np.testing.assert_array_equal(got, want)


COST_REG_STAGE_SHAPES = [(2, 48, 128, 160), (2, 32, 256, 320), (2, 8, 512, 640)]


def _cost_reg_errors(dev, dtype, B, D, h, w):
    """CostRegNet and CostRegNetDense on the same weights and input in train
    mode, each output and weight gradient's error (norm relative to the
    float64 3-D form's) by form, and the float32 dense backward's cuDNN
    weight-gradient kernels by name."""
    from torch.profiler import ProfilerActivity, profile

    from transmvsnet_tpu_torch.models.blocks import init_parameters
    from transmvsnet_tpu_torch.models.cost_reg import CostRegNet, CostRegNetDense

    gen = torch.Generator().manual_seed(D)
    conv3d = CostRegNet(1, 8)
    init_parameters(conv3d, gen)
    x = torch.randn(B, 1, D, h, w, generator=gen).to(dev)
    r = torch.randn(B, 1, D, h, w, generator=gen).to(dev, torch.float64)

    def run(cls, dt):
        m = cls(1, 8)
        m.load_state_dict(conv3d.state_dict())
        m.to(dev, torch.float64 if dt == torch.float64 else torch.float32).train()
        y = m(x.to(dt))
        (y.double() * r).sum().backward()
        return {"output": y.detach(), **{n: p.grad for n, p in m.named_parameters()}}

    ref = run(CostRegNet, torch.float64)
    errs = {form: {n: _rel_err(t.double(), ref[n]) for n, t in run(cls, dtype).items()}
            for form, cls in (("3d", CostRegNet), ("dense", CostRegNetDense))}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(CostRegNetDense, dtype)
        torch.cuda.synchronize()
    wgrad = sorted({e.name.split("<")[0].split("(")[0] for e in prof.events()
                    if any(k in e.name for k in ("wgrad", "Wgrad", "fft"))})
    return errs, wgrad


def _rel_err(got, want):
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,D,h,w", COST_REG_STAGE_SHAPES)
def test_dense_cost_reg_matches_3d(dev, dtype, B, D, h, w):
    """CostRegNetDense against CostRegNet on the same weights and input at
    the DTU recipe's three stage shapes, train mode, each held to the 3-D
    form in float64 (float32 in full float32, TF32 off): the dense form's
    worst error over its output and every weight gradient at most twice
    the 3-D form's worst, and each one at most five times the 3-D form's
    in the same dtype, plus a floor of the dtype's rounding for tensors
    both forms get right. A train-mode BatchNorm after each conv makes its
    weight's gradient a difference of near-equal sums, so neither form's
    float32 gradients sit nearer float64 than ~1e-3 of their norm, though
    each conv's own gradient, from exact inputs, is within ~1e-6. Per
    parameter, cuDNN's 2-D weight-gradient algorithms put the dense form
    up to ~4x the 3-D form's error at a few parameters (the next test);
    a wrong depth band is off by O(1)."""
    errs, _ = _cost_reg_errors(dev, dtype, B, D, h, w)
    floor = 1e-6 if dtype == torch.float32 else 1e-2
    worst = {form: max(e.values()) for form, e in errs.items()}
    assert worst["dense"] <= 2 * worst["3d"] + floor, worst
    worse = {n: (e, errs["3d"][n]) for n, e in errs["dense"].items() if e > 5 * errs["3d"][n] + floor}
    assert not worse, worse


@pytest.mark.parametrize("B,D,h,w", COST_REG_STAGE_SHAPES)
def test_dense_cost_reg_f32_gradient_error_is_cudnns(dev, B, D, h, w, capsys):
    """Where the float32 dense form's weight gradients sit further from
    float64 than the 3-D form's, cuDNN's algorithms for its 2-D weight
    gradients (Winograd, FFT, ALGO_0 by their kernels' names) put them
    there. Without cuDNN (PyTorch's own convs: im2col and GEMM) the two
    forms' errors per parameter are within 3 times each other's (1.05x,
    2.09x and 1.73x read at the three shapes: the BatchNorm cancellation
    moves single parameters either way), where with cuDNN ``prob``'s weight
    gradient reached 4.25x at the stage-3 shape (3.2e-5 against 6.6e-6;
    without cuDNN 1.2e-6 against 0.9e-6; 1.45x and 1.86x at the other
    shapes), and the dense form's worst over all parameters stayed near
    or below the 3-D form's (on an NVIDIA H100 80GB HBM3 at 700 W). The
    readings and the dense backward's cuDNN weight-gradient kernels are
    printed."""
    readings = {}
    for name, flags in (("cudnn", dict(enabled=True)), ("no_cudnn", dict(enabled=False))):
        with torch.backends.cudnn.flags(**flags, allow_tf32=False):
            errs, wgrad = _cost_reg_errors(dev, torch.float32, B, D, h, w)
        ratio = {n: e / (errs["3d"][n] + 1e-6) for n, e in errs["dense"].items()}
        top = max(ratio, key=ratio.get)
        readings[name] = {"largest_ratio": (top, ratio[top], errs["dense"][top], errs["3d"][top]),
                          "prob_weight": (errs["dense"]["prob.weight"], errs["3d"]["prob.weight"]),
                          "worst": {form: max(e.values()) for form, e in errs.items()},
                          "dense_wgrad_kernels": wgrad}
    with capsys.disabled():
        print(f"\ndense cost_reg float32 gradient error, {(B, D, h, w)}: {readings}")
    assert readings["no_cudnn"]["largest_ratio"][1] <= 3.0, readings


def test_remat_step_matches_the_plain_step(dev):
    """A float32 train step with ``remat`` against the same step without it
    on the kernels: loss, gradients and running statistics within float32
    noise (cuDNN may take other algorithms with other memory free: the
    losses read 1 float32 step apart), the statistics moved once; K5
    launched again by the recompute for each of the 9 DCN layers, K3, K6
    and K4 as without remat."""
    from transmvsnet_tpu_torch.config import ModelConfig
    from transmvsnet_tpu_torch.data.example import example_train_batch
    from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
    from transmvsnet_tpu_torch.ops.cuda.dcn import deform_conv2d
    from transmvsnet_tpu_torch.ops.cuda.dcn_bwd import dcn_bwd
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import warp_correlate
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate_bwd import warp_correlate_bwd
    from transmvsnet_tpu_torch.train.loop import to_device_batch
    from transmvsnet_tpu_torch.train.schedule import make_optimizer, warmup_multistep
    from transmvsnet_tpu_torch.train.step import TrainState, make_train_step

    counters = [(deform_conv2d, "launches_f32"), (dcn_bwd, "launches_f32"), (warp_correlate, "launches_f32"),
                (warp_correlate_bwd, "launches_f32")]
    batch = to_device_batch(example_train_batch(B=2, V=3, H=128, W=160, num_hyp=48), dev)
    runs = {}
    for remat in (False, True):
        model = TransMVSNet(ModelConfig(ndepths=(16, 8, 8), remat=remat), device=dev,
                            generator=torch.Generator().manual_seed(0))
        state = TrainState(model, *make_optimizer(model.parameters(), warmup_multistep(1e-3, [100], 0.5)))
        before = [getattr(f, a) for f, a in counters]
        _, scalars = make_train_step()(state, batch)
        torch.cuda.synchronize()
        runs[remat] = {"loss": scalars["loss"].item(),
                       "launches": [getattr(f, a) - b for (f, a), b in zip(counters, before)],
                       "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
                       "buffers": {n: b.clone() for n, b in model.named_buffers()}}
    plain, remat = runs[False], runs[True]
    assert plain["launches"] == [9, 9, 3, 3] and remat["launches"] == [18, 9, 3, 3]
    assert remat["loss"] == pytest.approx(plain["loss"], rel=1e-6)
    # Each gradient's error relative to its norm, or to 1e-3 of the largest
    # one's for gradients that are zero in exact arithmetic (a DCN bias
    # before a train-mode BatchNorm reads float32 noise on both sides).
    top = max(g.norm() for g in plain["grads"].values())
    errs = {n: ((remat["grads"][n] - g).norm() / torch.maximum(g.norm(), 1e-3 * top)).item()
            for n, g in plain["grads"].items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])
    for n, b in plain["buffers"].items():
        if n.endswith("num_batches_tracked"):
            assert remat["buffers"][n].item() == b.item() == 1, n
        else:
            torch.testing.assert_close(remat["buffers"][n], b, rtol=1e-6, atol=1e-7, msg=n)
