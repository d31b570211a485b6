"""The port's DCNv2 and warp-correlation gradients against the JAX package.

- The plain backwards (kernels K3 and K4's plain versions, which the CPU
  path takes) against ``jax.vjp`` of the JAX XLA ops at float32, including
  zero offsets, where the floor two-tap rule must give offset gradients,
  and against the TPU backward kernels ``deform_conv2d_bwd`` and
  ``warp_correlate_bwd`` in interpret mode at bfloat16 (W = 128, smooth
  offsets: the TPU kernels' window contract).
- The autograd Functions of ``ops/vjp.py`` (K1 + K3, K2 + K4 on the card;
  the plain versions here) against ``jax.grad`` through the JAX package's
  f32 XLA composition and through ``deform_conv2d_fused_with_vjp`` with
  the TPU kernels in interpret mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmvsnet_tpu.ops.dcn import deform_conv2d as jax_deform_conv2d
from transmvsnet_tpu.ops.pallas.dcn_bwd import deform_conv2d_bwd
from transmvsnet_tpu.ops.pallas.dcn_onehot import deform_conv2d_onehot_fused
from transmvsnet_tpu.ops.pallas.vjp import (
    _offset_conv,
    deform_conv2d_fused_with_vjp,
    split_offsets,
)
from transmvsnet_tpu.ops.pallas.warp_bwd import warp_correlate_bwd as jax_warp_correlate_bwd
from transmvsnet_tpu.ops.warp import warp_correlate as jax_warp_correlate
from transmvsnet_tpu_torch.ops.cuda import dcn_bwd as k3
from transmvsnet_tpu_torch.ops.cuda import warp_correlate_bwd as k4
from transmvsnet_tpu_torch.ops.vjp import dcn_fused_with_vjp, warp_correlate_with_vjp

from test_pallas_bwd import _assert_close
from test_pallas_dcn_rowsweep import smooth_offsets
from test_torch_dcn import make_inputs as make_dcn_inputs
from test_torch_dcn import to_port
from test_torch_warp import cf, make_scene


def nchw(a):
    """[B, H, W, C] numpy -> [B, C, H, W] torch."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a, np.float32), -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def dcn_case(B=2, H=9, W=11, C=8, C_out=16, off=2.0, seed=0):
    """JAX layouts: x [B, H, W, C], offsets and mask [B, H, W, 9], weight
    [9, C, C_out], cotangent [B, H, W, C_out]."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, C).astype(np.float32)
    dy, dx = ((rng.randn(B, H, W, 9) * off).astype(np.float32) for _ in range(2))
    mask = rng.rand(B, H, W, 9).astype(np.float32)
    w = (rng.randn(9, C, C_out) * 0.1).astype(np.float32)
    g = rng.randn(B, H, W, C_out).astype(np.float32)
    return x, dy, dx, mask, w, g


def jax_dcn_vjp(x, dy, dx, mask, w, g):
    _, vjp = jax.vjp(lambda *a: jax_deform_conv2d(*a), *(jnp.asarray(a) for a in (x, dy, dx, mask, w)))
    return vjp(jnp.asarray(g))


def port_dcn_bwd(x, dy, dx, mask, w, g, dtype=torch.float32):
    got = k3.dcn_bwd(nchw(x).to(dtype), nchw(dy), nchw(dx), nchw(mask), torch.from_numpy(w), nchw(g))
    return [nhwc(t) for t in got[:4]] + [got[4].numpy()]


DCN_NAMES = ("dx", "d_offset_y", "d_offset_x", "d_mask", "d_weight")


@pytest.mark.parametrize(
    "C,C_out,off,H,W",
    [
        pytest.param(8, 16, 2.0, 9, 11, id="8-16-2.0"),
        pytest.param(32, 8, 2.0, 9, 11, id="32-8-2.0"),
        pytest.param(16, 32, 0.0, 9, 11, id="16-32-0.0"),
        pytest.param(32, 16, 6.0, 13, 37, id="32-16-6.0-13x37"),
    ],
)
def test_dcn_bwd_plain_matches_jax_xla_f32(C, C_out, off, H, W):
    """Offsets of ~2 px (some taps off the 9x11 image), and zero offsets:
    every tap on an integer, where the floor rule (v_hi - v_lo) still gives
    offset gradients, as the zero-initialised offset convs need. And offsets
    of ~6 px on a ragged 13x37 image: the regime whose corners leave the
    CUDA kernel's tiles and their dx windows, where the card's checks hold
    the kernel to this plain version."""
    args = dcn_case(H=H, W=W, C=C, C_out=C_out, off=off)
    want = jax_dcn_vjp(*args)
    got = port_dcn_bwd(*args)
    for a, b, name in zip(got, want, DCN_NAMES):
        b = np.asarray(b)
        # Same float32 arithmetic, other summation order.
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * np.abs(b).max(), err_msg=name)
    if off == 0.0:
        assert np.abs(got[1]).max() > 0.1 and np.abs(got[2]).max() > 0.1


def test_dcn_bwd_plain_matches_tpu_kernel_interpret_bf16():
    """At bf16, against the TPU backward kernel, with
    tests/test_pallas_bwd.py's inputs and tolerances: W = 128 (no lane
    truncation), smooth offsets in multiples of 1/8 (bf16-exact)."""
    B, H, W, C, C_out = 1, 16, 128, 8, 8
    rng = np.random.RandomState(7)
    x = rng.randn(B, H, W, C).astype(np.float32)
    dy = np.asarray(jnp.round(smooth_offsets(B, H, W, 9, 1.5, seed=1) * 8) / 8)
    dx = np.asarray(jnp.round(smooth_offsets(B, H, W, 9, 1.5, seed=2) * 8) / 8)
    mask = rng.rand(B, H, W, 9).astype(np.float32)
    w = (rng.randn(9, C, C_out) * 0.1).astype(np.float32)
    g = rng.randn(B, H, W, C_out).astype(np.float32)
    want = deform_conv2d_bwd(*(jnp.asarray(a) for a in (x, dy, dx, mask, w, g)), interpret=True)
    got = port_dcn_bwd(x, dy, dx, mask, w, g, dtype=torch.bfloat16)
    for a, b, name in zip(got, want, DCN_NAMES):
        _assert_close(a, b, name)


def test_dcn_bwd_wrapper_on_cpu_is_the_plain_version():
    x, dy, dx, mask, w, g = (nchw(a) if a.ndim == 4 else torch.from_numpy(a) for a in dcn_case())
    before = k3.dcn_bwd.launches
    for a, b in zip(k3.dcn_bwd(x, dy, dx, mask, w, g), k3.dcn_bwd_plain(x, dy, dx, mask, w, g)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert k3.dcn_bwd.launches == before  # no kernel ran


def test_dcn_bwd_checks_refuse_what_the_kernel_does_not_take():
    x, dy, dx, mask, w, g = (nchw(a) if a.ndim == 4 else torch.from_numpy(a) for a in dcn_case())
    # Two instantiations, float32 and bf16; float16 has none.
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k3._check(x.half(), dy, dx, mask, w, g)
    assert k3._check(x, dy, dx, mask, w, g) == (2, 8, 9, 11, 16)
    xb = x.to(torch.bfloat16)
    assert k3._check(xb, dy, dx, mask, w, g) == (2, 8, 9, 11, 16)
    with pytest.raises(ValueError, match="offset_y"):
        k3._check(xb, dy[:, :4], dx, mask, w, g)
    with pytest.raises(ValueError, match="g must be"):
        k3._check(xb, dy, dx, mask, w, g[:, :8])
    with pytest.raises(ValueError, match="C_out"):
        k3._check(xb, dy, dx, mask, w[..., :12], g[:, :12])


def warp_case(C=8, S=1, seed=0):
    """make_scene (hypotheses behind the source camera, samples out of
    frame) plus a cotangent [B, S, D, H, W]."""
    src, ref, sp, rp, depth = make_scene(B=2, S=S, C=C, seed=seed)
    g = np.random.RandomState(seed + 1).randn(2, S, *depth.shape[1:]).astype(np.float32)
    return src, ref, sp, rp, depth, g


def port_warp_bwd(src, ref, sp, rp, depth, g, dtype=torch.float32):
    return k4.warp_correlate_bwd(cf(src).to(dtype), cf(ref).to(dtype), torch.from_numpy(sp),
                                 torch.from_numpy(rp), torch.from_numpy(depth), torch.from_numpy(g))


@pytest.mark.parametrize("C", [8, 32])
def test_warp_bwd_plain_matches_jax_xla_f32(C):
    """All S = 3 source views in one call; dref sums over them. Each view
    against jax.vjp of the JAX XLA op."""
    src, ref, sp, rp, depth, g = warp_case(C=C, S=3)
    dsrc, dref = port_warp_bwd(src, ref, sp, rp, depth, g)
    want_dref = 0.0
    for s in range(3):
        _, vjp = jax.vjp(lambda a, b: jax_warp_correlate(a, b, jnp.asarray(sp[:, s]), jnp.asarray(rp),
                                                         jnp.asarray(depth)),
                         jnp.asarray(src[:, s]), jnp.asarray(ref))
        ws, wr = vjp(jnp.asarray(g[:, s]))
        # Same float32 arithmetic, other summation order; values O(0.1).
        np.testing.assert_allclose(np.moveaxis(dsrc[:, s].numpy(), 1, -1), np.asarray(ws),
                                   rtol=1e-4, atol=1e-6)
        want_dref = want_dref + np.asarray(wr)
    np.testing.assert_allclose(nhwc(dref), want_dref, rtol=1e-4, atol=1e-6)
    assert np.abs(dsrc.numpy()).max() > 0


def test_warp_bwd_plain_matches_tpu_kernel_interpret_bf16():
    """At bf16, against the TPU backward kernel on its own test scene (DTU
    depths, small baseline, H = 16, W = 128), with tests/test_pallas_bwd.py's
    tolerances."""
    from transmvsnet_tpu.ops.geometry import fuse_projection

    from test_geometry import make_cameras

    rng = np.random.RandomState(0)
    H, W, C, D = 16, 128, 16, 4
    cams = make_cameras(rng, n=2)
    cams[:, 1, :3, :3] *= 2.0
    src = rng.randn(1, H, W, C).astype(np.float32)
    ref = rng.randn(1, H, W, C).astype(np.float32)
    depth = (np.linspace(420.0, 900.0, D, dtype=np.float32)[None, :, None, None]
             + 5.0 * rng.rand(1, D, H, W)).astype(np.float32)
    rp = np.array(fuse_projection(jnp.asarray(cams[0:1])))
    sp = np.array(fuse_projection(jnp.asarray(cams[1:2])))
    g = rng.randn(1, D, H, W).astype(np.float32)
    want = jax_warp_correlate_bwd(*(jnp.asarray(a) for a in (src, ref, sp, rp, depth, g)), interpret=True)
    dsrc, dref = port_warp_bwd(src[:, None], ref, sp[:, None], rp, depth, g[:, None], dtype=torch.bfloat16)
    _assert_close(nhwc(dsrc[:, 0]), want[0], "dsrc")
    _assert_close(nhwc(dref), want[1], "dref")


def test_warp_bwd_wrapper_on_cpu_is_the_plain_version():
    args = [cf(a) if i < 2 else torch.from_numpy(a) for i, a in enumerate(warp_case(S=2))]
    before = k4.warp_correlate_bwd.launches
    for a, b in zip(k4.warp_correlate_bwd(*args), k4.warp_correlate_bwd_plain(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert k4.warp_correlate_bwd.launches == before


def test_warp_function_gradients_and_none_for_geometry():
    """warp_correlate_with_vjp: source and reference gradients as
    jax.grad of the XLA op; projections and hypotheses get none, even when
    they require one."""
    src, ref, sp, rp, depth, g = warp_case(C=16, S=1, seed=3)
    s, r = cf(src).requires_grad_(), cf(ref).requires_grad_()
    tsp, trp, tdepth = (torch.from_numpy(a).requires_grad_() for a in (sp, rp, depth))
    out = warp_correlate_with_vjp(s, r, tsp, trp, tdepth)
    (out * torch.from_numpy(g)).sum().backward()
    assert tsp.grad is None and trp.grad is None and tdepth.grad is None
    ws, wr = jax.grad(
        lambda a, b: jnp.sum(jax_warp_correlate(a, b, jnp.asarray(sp[:, 0]), jnp.asarray(rp),
                                                jnp.asarray(depth)) * jnp.asarray(g[:, 0])),
        argnums=(0, 1),
    )(jnp.asarray(src[:, 0]), jnp.asarray(ref))
    np.testing.assert_allclose(np.moveaxis(s.grad[:, 0].numpy(), 1, -1), np.asarray(ws), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(nhwc(r.grad), np.asarray(wr), rtol=1e-4, atol=1e-6)


def _dcn_function_grads(args, g, dtype):
    """Gradients of sum(dcn_fused_with_vjp(...) * g) for (x, k_off, b_off,
    weight, bias), in JAX layouts."""
    leaves = [t.requires_grad_() for t in to_port(*args, dtype=dtype)]
    out = dcn_fused_with_vjp(*leaves)
    assert out.dtype == dtype
    (out.float() * nchw(g)).sum().backward()
    x, k_off, b_off, w, b = (t.grad for t in leaves)
    assert x.dtype == dtype
    return [nhwc(x), k_off.numpy().transpose(2, 3, 1, 0), b_off.numpy(), w.numpy(), b.numpy()]


FUSED_NAMES = ("dx", "dk_off", "db_off", "dw", "db")


def test_dcn_function_matches_jax_xla_composition_f32():
    """The whole DCN layer at float32: offset conv, interleaved split,
    sigmoid mask, sampling, contraction, and the glue that routes the
    sampling gradients back through the offset conv."""
    args = make_dcn_inputs(B=2, H=10, W=12, C=16, C_out=8, seed=4)
    g = np.random.RandomState(5).randn(2, 10, 12, 8).astype(np.float32)

    def xla(x, k_off, b_off, w, b):
        dy, dx, mask = split_offsets(_offset_conv(x, k_off, b_off))
        return jnp.sum(jax_deform_conv2d(x, dy, dx, mask, w, b) * jnp.asarray(g))

    want = jax.grad(xla, argnums=tuple(range(5)))(*(jnp.asarray(a) for a in args))
    got = _dcn_function_grads(args, g, torch.float32)
    for a, b, name in zip(got, want, FUSED_NAMES):
        b = np.asarray(b)
        # Float32 on both sides, other summation order.
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * np.abs(b).max(), err_msg=name)


def test_dcn_function_matches_tpu_fused_vjp_interpret_bf16():
    """At bf16, against jax.grad through deform_conv2d_fused_with_vjp with
    the TPU forward and backward kernels in interpret mode, on
    tests/test_pallas_bwd.py's fused-DCN inputs (a smooth x, 1/8-quantised
    offset-conv weights) and tolerances."""
    rng = np.random.RandomState(11)
    B, H, W, C, C_out = 1, 16, 128, 8, 8
    x = np.asarray(smooth_offsets(B, H, W, C, amplitude=1.0, seed=12))
    k_off = np.round(rng.randn(3, 3, C, 27).astype(np.float32) * 8) / 128
    b_off = np.round(rng.randn(27).astype(np.float32) * 8) / 16
    w = (rng.randn(9, C, C_out) * 0.1).astype(np.float32)
    b = (rng.randn(C_out) * 0.1).astype(np.float32)
    g = rng.randn(B, H, W, C_out).astype(np.float32)
    f = deform_conv2d_fused_with_vjp(
        functools.partial(deform_conv2d_onehot_fused, interpret=True),
        pallas_bwd=functools.partial(deform_conv2d_bwd, interpret=True),
    )
    want = jax.grad(
        lambda *a: jnp.sum(f(*a).astype(jnp.float32) * jnp.asarray(g)), argnums=tuple(range(5))
    )(*(jnp.asarray(a) for a in (x, k_off, b_off, w, b)))
    got = _dcn_function_grads((x, k_off, b_off, w, b), g, torch.bfloat16)
    for a, wnt, name in zip(got, want, FUSED_NAMES):
        if name == "dx":
            # As that test: the offset recompute rounds differently (bf16
            # there, float32 here), so where an offset sits on an integer
            # the floor flips and isolated pixels take other taps.
            a, wnt = np.asarray(a, np.float32), np.asarray(wnt, np.float32)
            scale = np.abs(wnt).max()
            assert np.isclose(a / scale, wnt / scale, rtol=0, atol=4e-2).mean() > 0.995
            assert np.median(np.abs(a - wnt)) < 1e-2 * scale
        else:
            _assert_close(a, wnt, name, atol_frac=4e-2, med_frac=1e-2)
