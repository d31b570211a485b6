"""The pieces around K2/K6 and K7 (``csrc/warp_correlate.cu``'s
channels-last copy and body) that run without a card: the C entry points'
arguments and the scratch the wrappers allocate, the trace tally of
``tools/profile.py`` and the inference-forward capture and launch closures
of ``tools/compare_dcn.py --warp-fwd``. Small shapes on the CPU, nothing of
JAX.
"""

import ctypes

import pytest
import torch

from transmvsnet_tpu_torch.ops.cuda import warp_correlate as k2
from transmvsnet_tpu_torch.tools import compare_dcn, profile


class FakeEntry:
    """Stands in for a ctypes function: records its signature and call."""

    def __call__(self, *args):
        self.args = args
        return 0


class FakeLibrary:
    def __init__(self):
        self.warp_correlate_forward = FakeEntry()
        self.warp_correlate_wsum_forward = FakeEntry()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["k2_bf16", "k6_f32"])
def test_entry_point_takes_the_scratch_after_the_stream(dtype):
    """The earlier build's arguments first (a build without the scratch
    ignores what follows the stream), then src_cl in the features' dtype:
    each view's H*W records of C channels between pads of W + 1 records."""
    B, S, C, D, H, W = 2, 3, 16, 5, 7, 9
    src = torch.zeros(B, S, C, H, W, dtype=dtype)
    ref = torch.zeros(B, C, H, W, dtype=dtype)
    rel, depth = torch.zeros(B * S, 3, 4), torch.zeros(B, D, H, W)
    out = torch.empty(B, S, D, H, W)
    src_cl = k2.forward_scratch(src)
    assert src_cl.shape == (B * S * (H * W + W + 1) + W + 1, C) and src_cl.dtype == dtype
    lib = FakeLibrary()
    assert k2.launch_forward(lib, src, ref, rel, depth, out, src_cl, ctypes.c_void_p(1234)) == 0
    fn = lib.warp_correlate_forward
    assert fn.restype is ctypes.c_int
    assert fn.argtypes == [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
    ptrs = [t.data_ptr() for t in (src, ref, rel, depth, out)]
    assert list(fn.args[:5]) == ptrs
    assert fn.args[5:12] == (B * S, S, C, D, H, W, int(dtype == torch.bfloat16))
    assert fn.args[12].value == 1234 and fn.args[13] == src_cl.data_ptr()


def test_wsum_entry_point_takes_the_scratch_after_the_stream():
    """K7's C entry point: the earlier build's 13 arguments first (a build
    without the scratch ignores what follows the stream), then src_cl, the
    bf16 channels-last copy K2's wrapper makes too."""
    B, S, C, D, H, W = 2, 3, 16, 5, 7, 9
    src = torch.zeros(B, S, C, H, W, dtype=torch.bfloat16)
    ref = torch.zeros(B, C, H, W, dtype=torch.bfloat16)
    rel, depth, vw = torch.zeros(B * S, 3, 4), torch.zeros(B, D, H, W), torch.zeros(B, S, H, W)
    out = torch.empty(B, D, H, W)
    src_cl = k2.forward_scratch(src)
    lib = FakeLibrary()
    assert k2.launch_wsum_forward(lib, src, ref, rel, depth, vw, out, src_cl, ctypes.c_void_p(1234)) == 0
    fn = lib.warp_correlate_wsum_forward
    assert fn.restype is ctypes.c_int
    assert fn.argtypes == [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    assert list(fn.args[:6]) == [t.data_ptr() for t in (src, ref, rel, depth, vw, out)]
    assert fn.args[6:12] == (B, S, C, D, H, W)
    assert fn.args[12].value == 1234 and fn.args[13] == src_cl.data_ptr()


@pytest.mark.parametrize("kernel", ["warp_correlate", "warp_correlate_f32", "warp_correlate_wsum"])
def test_compare_launch_makes_the_scratch_once(monkeypatch, kernel):
    """compare_dcn's launch closure (what ``kernel_ms`` replays) calls the
    entry point with a channels-last scratch of the features' dtype, made
    once and passed on every call, for K2/K6 and K7 alike."""
    from transmvsnet_tpu_torch.ops.cuda import build

    B, S, C, D, H, W = 1, 4, 8, 3, 5, 6
    dtype = torch.float32 if kernel.endswith("f32") else torch.bfloat16
    src = torch.zeros(B, S, C, H, W, dtype=dtype)
    ref = torch.zeros(B, C, H, W, dtype=dtype)
    proj = torch.eye(4).repeat(B, S + 1, 1, 1)
    args = (src, ref, proj[:, 1:].contiguous(), proj[:, 0].contiguous(), torch.ones(B, D, H, W))
    if kernel == "warp_correlate_wsum":
        args = (*args, torch.ones(B, S, H, W))
    lib = FakeLibrary()
    monkeypatch.setattr(build, "library", lambda name: lib)
    monkeypatch.setattr(build, "stream_handle", lambda t: ctypes.c_void_p(99))
    launch = compare_dcn.warp_fwd_launch(kernel, args)
    launch()
    fn = lib.warp_correlate_wsum_forward if kernel == "warp_correlate_wsum" else lib.warp_correlate_forward
    first = fn.args
    launch()
    assert len(first) == 14 and first[12].value == 99 and fn.args[13] == first[13]
    assert first[13] not in [t.data_ptr() for t in args]


def test_wsum_keeps_the_nan_of_a_view_of_weight_zero():
    """K7's function gives NaN where a view of weight zero samples NaN
    features (0 * NaN), as the JAX kernel does: a diverged feature map is
    not hidden by its weight. On the CPU the wrapper takes the plain
    version; ``tests/test_torch_cuda.py`` holds the kernel to the same."""
    B, S, C, D, H, W = 1, 2, 8, 3, 6, 7
    gen = torch.Generator().manual_seed(5)
    src = torch.randn(B, S, C, H, W, generator=gen).to(torch.bfloat16)
    ref = torch.randn(B, C, H, W, generator=gen).to(torch.bfloat16)
    proj = torch.eye(4).repeat(B, S + 1, 1, 1)  # every sample on its own pixel
    depth = 1.0 + torch.rand(B, D, H, W, generator=gen)
    vw = torch.rand(B, S, H, W, generator=gen)
    args = (ref, proj[:, 1:].contiguous(), proj[:, 0].contiguous(), depth)
    assert k2.warp_correlate_wsum(src, *args, vw).isfinite().all()
    src[:, 1] = float("nan")
    vw[:, 1] = 0.0
    assert k2.warp_correlate_wsum(src, *args, vw).isnan().all()


@pytest.mark.parametrize("shape", [(64, 4, 32, 1024, 1024), (1, 1, 32, 1, 2**26 - 1)], ids=["views", "pads"])
def test_scratch_refuses_what_the_body_cannot_index(shape):
    """The body indexes the channels-last copy, pads included, in 32 bits."""
    with pytest.raises(ValueError, match="32 bits"):
        k2.forward_scratch(torch.empty(shape, dtype=torch.bfloat16, device="meta"))


def test_profile_tallies_the_forward_copy_and_body_under_k2_k6():
    """K2/K6's two launches (channels-last copy, body) count under
    ``warp_correlate_kernel``; K7's two (under its own names) and K4's
    three launches apart."""
    ns = "void (anonymous namespace)::"
    by_name = {
        ns + "warp_correlate_fwd_to_channels_last<unsigned short, 32>(...)": [80.0, 3],
        ns + "warp_correlate_fwd_main<__nv_bfloat16, 32>(...)": [420.0, 3],
        ns + "warp_correlate_fwd_to_channels_last<unsigned int, 8>(...)": [20.0, 1],
        ns + "warp_correlate_fwd_main<float, 8>(...)": [230.0, 1],
        ns + "warp_correlate_wsum_fwd_to_channels_last<16>(...)": [80.0, 2],
        ns + "warp_correlate_wsum_fwd_main<16, 4>(...)": [320.0, 2],
        ns + "warp_correlate_bwd_to_channels_last<unsigned short, 32>(...)": [100.0, 3],
        ns + "warp_correlate_bwd_main<__nv_bfloat16, 32>(...)": [2000.0, 3],
        ns + "warp_correlate_bwd_to_planar<32>(...)": [150.0, 3],
    }
    got = profile.port_kernel_totals(by_name, passes=2)
    assert got["warp_correlate_kernel"] == {"ms_per_pass": 0.375, "launches_per_pass": 4}
    assert got["warp_correlate_wsum_kernel"] == {"ms_per_pass": 0.2, "launches_per_pass": 2}
    assert got["warp_correlate_bwd"] == {"ms_per_pass": 1.125, "launches_per_pass": 4.5}


def test_forward_capture_records_the_three_k2_k6_calls():
    """compare_dcn's capture on a tiny float32 inference forward: K6 once
    per stage, coarsest first, with the arguments the kernel takes and no
    gradient."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # a tiny model: threads only contend with the other test workers
    try:
        calls = compare_dcn.capture_forward_calls(torch.device("cpu"), "float32", False, shape=(1, 32, 64),
                                                  ndepths=(8, 8, 8))
    finally:
        torch.set_num_threads(threads)
    assert [(name, stage) for name, stage, _ in calls] == [
        ("warp_correlate", "stage1"), ("warp_correlate", "stage2"), ("warp_correlate", "stage3")]
    for (_, _, args), (C, h, w) in zip(calls, [(32, 8, 16), (16, 16, 32), (8, 32, 64)]):
        src, ref, sp, rp, depth = args
        assert src.shape == (1, 4, C, h, w) and src.dtype == torch.float32
        assert ref.shape == (1, C, h, w) and sp.shape == (1, 4, 4, 4) and rp.shape == (1, 4, 4)
        assert depth.shape == (1, 8, h, w) and depth.dtype == torch.float32
        assert not any(t.requires_grad for t in args)
