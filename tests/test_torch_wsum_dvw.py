"""K8's view-weight gradient on demand, on the CPU (plain versions, small
shapes, nothing of JAX).

``warp_correlate_wsum_with_vjp`` asks K8 for dvw only when the view
weights need a gradient (``need_dvw``); without it K8 runs its
instantiation that neither computes nor writes dvw. The model passes
detached weights, so its fused steps never ask. Also the pieces of the
tools around K4/K8 that run without a card: the step capture of
``tools/compare_dcn.py``, the trace tally of ``tools/profile.py`` and the
fault wrapper of ``chip_smoke.py``.
"""

import pytest
import torch

import chip_smoke
from transmvsnet_tpu_torch.ops import vjp
from transmvsnet_tpu_torch.ops.cuda import warp_correlate_bwd as k8
from transmvsnet_tpu_torch.ops.cuda.warp_correlate import warp_correlate_wsum_plain
from transmvsnet_tpu_torch.tools import compare_dcn, profile


def scene(seed=0, B=1, S=2, C=8, D=3, H=9, W=11):
    """bf16 features, projections whose baselines take samples out of the
    frame, a band of hypotheses behind the cameras, weights with zeros."""
    gen = torch.Generator().manual_seed(seed)
    src = torch.randn(B, S, C, H, W, generator=gen).to(torch.bfloat16)
    ref = torch.randn(B, C, H, W, generator=gen).to(torch.bfloat16)
    proj = torch.eye(4).repeat(B, S + 1, 1, 1)
    proj[..., 0, 0] = proj[..., 1, 1] = 0.8 * W
    proj[..., 0, 2], proj[..., 1, 2] = W / 2, H / 2
    proj[..., 0, 3] = 0.3 * W * torch.arange(S + 1)
    depth = 2.0 + 3.0 * torch.rand(B, D, H, W, generator=gen)
    depth[:, 0, : H // 2] = -1.0
    vw = torch.rand(B, S, H, W, generator=gen)
    vw[:, 0, : H // 3] = 0.0
    g = torch.randn(B, D, H, W, generator=gen)
    return src, ref, proj[:, 1:].contiguous(), proj[:, 0].contiguous(), depth, vw, g


@pytest.mark.parametrize("weights_need_grad", [True, False], ids=["dvw", "no_dvw"])
def test_function_asks_for_dvw_only_when_the_weights_need_it(monkeypatch, weights_need_grad):
    """The Function passes need_dvw as the weights' requires_grad, and its
    gradients match autograd of the plain forward in both cases."""
    src, ref, sp, rp, depth, vw, g = scene()
    asked = []

    def spy(*args, need_dvw):
        asked.append(need_dvw)
        return k8.warp_correlate_wsum_bwd(*args, need_dvw=need_dvw)

    monkeypatch.setattr(vjp, "warp_correlate_wsum_bwd", spy)
    grads = []
    for fn in (vjp.warp_correlate_wsum_with_vjp, warp_correlate_wsum_plain):
        s, r = src.clone().requires_grad_(), ref.clone().requires_grad_()
        w = vw.clone().requires_grad_(weights_need_grad)
        (fn(s, r, sp, rp, depth, w) * g).sum().backward()
        grads.append((s.grad, r.grad, w.grad))
    assert asked == [weights_need_grad]
    (s_k, r_k, w_k), (s_p, r_p, w_p) = grads
    assert (w_k is None) == (w_p is None) == (not weights_need_grad)
    # Both gradients of the features are rounded to their bf16.
    for a, b in ((s_k, s_p), (r_k, r_p)):
        assert a.dtype == b.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), rtol=2**-7, atol=1e-3 * b.abs().max().item())
    if weights_need_grad:
        torch.testing.assert_close(w_k, w_p, rtol=1e-5, atol=1e-6)
        assert w_k[:, 0, :3].abs().max() > 0  # dvw is owed where vw = 0


def test_plain_backward_without_dvw_is_the_same_dsrc_and_dref():
    args = scene(seed=1, S=3, C=16)
    with_dvw = k8.warp_correlate_wsum_bwd_plain(*args)
    without = k8.warp_correlate_wsum_bwd_plain(*args, need_dvw=False)
    assert without[2] is None and with_dvw[2].shape == args[5].shape
    for a, b in zip(without[:2], with_dvw[:2]):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cpu_wrapper_takes_the_plain_version_without_dvw():
    args = scene(seed=2)
    before = k8.warp_correlate_wsum_bwd.launches
    got = k8.warp_correlate_wsum_bwd(*args, need_dvw=False)
    assert k8.warp_correlate_wsum_bwd.launches == before
    want = k8.warp_correlate_wsum_bwd_plain(*args, need_dvw=False)
    assert got[2] is None
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_step_capture_records_k4_and_k8_as_the_fused_step_calls_them():
    """compare_dcn's capture on a tiny fused bf16 step: K8 at stages 2-3
    without dvw (the model's weights are detached), K4 at stage 1, in the
    backward's order, with the arguments the kernels take."""
    calls = compare_dcn.capture_step_calls(torch.device("cpu"), "bfloat16", True, warm_steps=0,
                                           shape=(1, 64, 128), ndepths=(8, 8, 8))
    assert [(name, stage, need_dvw) for name, stage, _, need_dvw in calls] == [
        ("warp_correlate_wsum_bwd", "stage3", False),
        ("warp_correlate_wsum_bwd", "stage2", False),
        ("warp_correlate_bwd", "stage1", None),
    ]
    name, stage, args, _ = calls[0]
    src, ref, sp, rp, depth, vw, g = args
    assert src.shape == (1, 4, 8, 64, 128) and src.dtype == torch.bfloat16
    assert vw.shape == (1, 4, 64, 128) and g.shape == (1, 8, 64, 128)
    assert not any(t.requires_grad for t in args)
    assert calls[2][2][0].shape == (1, 4, 32, 16, 32)


def test_profile_tallies_k4_and_k8_apart_with_their_copies():
    """Each kernel's three launches (channels-last copy, body, planar
    write) count under its own name; the forward kernels apart."""
    ns = "void (anonymous namespace)::"
    by_name = {
        ns + "warp_correlate_bwd_to_channels_last<unsigned short, 32>(...)": [100.0, 3],
        ns + "warp_correlate_bwd_main<__nv_bfloat16, 32>(...)": [2000.0, 3],
        ns + "warp_correlate_bwd_to_planar<32>(...)": [150.0, 3],
        ns + "warp_correlate_wsum_bwd_to_channels_last<16>(...)": [60.0, 2],
        ns + "warp_correlate_wsum_bwd_main<16, false>(...)": [900.0, 2],
        ns + "warp_correlate_wsum_bwd_to_planar<16>(...)": [90.0, 2],
        ns + "warp_correlate_fwd_main<__nv_bfloat16, 32>(...)": [500.0, 1],
        ns + "warp_correlate_wsum_fwd_to_channels_last<16>(...)": [60.0, 2],
        ns + "warp_correlate_wsum_fwd_main<16, 4>(...)": [340.0, 2],
    }
    got = profile.port_kernel_totals(by_name, passes=1)
    assert got["warp_correlate_bwd"] == {"ms_per_pass": 2.25, "launches_per_pass": 9}
    assert got["warp_correlate_wsum_bwd"] == {"ms_per_pass": 1.05, "launches_per_pass": 6}
    assert got["warp_correlate_kernel"] == {"ms_per_pass": 0.5, "launches_per_pass": 1}
    assert got["warp_correlate_wsum_kernel"] == {"ms_per_pass": 0.4, "launches_per_pass": 4}


def test_planted_fault_wrapper_passes_the_dvw_flag_through():
    """chip_smoke's zero_outputs keeps working on K8's new keyword: the
    outputs it names are zero, dvw stays None when not asked."""
    args = scene(seed=3)
    faulty = chip_smoke.zero_outputs(0)(k8.warp_correlate_wsum_bwd)
    dsrc, dref, dvw = faulty(*args, need_dvw=False)
    assert dvw is None and not dsrc.any() and dref.abs().max() > 0
