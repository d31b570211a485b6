"""The port's plane-sweep warp-correlation (kernel K2's plain version, which
the CPU path takes) against the JAX package.

float32: against the JAX XLA ``warp_correlate``, including hypotheses
behind the source camera (z < 1e-6, sampled as zero) and samples out of
frame. bfloat16: against the TPU kernel ``warp_correlate_onehot`` in
interpret mode at H = 16, W = 128.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmvsnet_tpu.ops.geometry import fuse_projection
from transmvsnet_tpu.ops.pallas.warp_onehot import warp_correlate_onehot
from transmvsnet_tpu.ops.warp import warp_correlate as jax_warp_correlate
from transmvsnet_tpu_torch.ops import warp
from transmvsnet_tpu_torch.ops.cuda import warp_correlate as k2

from test_geometry import make_cameras


def make_scene(B=1, S=1, H=12, W=16, C=8, D=6, seed=0, behind=True):
    """JAX layouts: src [B, S, H, W, C], ref [B, H, W, C], fused projections
    src [B, S, 4, 4] and ref [B, 4, 4], depth [B, D, H, W]."""
    rng = np.random.RandomState(seed)
    cams = make_cameras(rng, n=S + 1)
    cams[:, 1, :3, :3] *= 2.0  # longer focal: samples leave the frame too
    fused = np.array(fuse_projection(jnp.asarray(cams)))
    src = rng.randn(B, S, H, W, C).astype(np.float32)
    ref = rng.randn(B, H, W, C).astype(np.float32)
    base = np.linspace(2.0, 9.0, D, dtype=np.float32)[None, :, None, None]
    depth = (base + 0.3 * rng.rand(B, D, H, W)).astype(np.float32)
    if behind:
        depth[:, :2, : H // 3] *= -1.0
    src_proj = np.broadcast_to(fused[1:][None], (B, S, 4, 4)).copy()
    ref_proj = np.broadcast_to(fused[0][None], (B, 4, 4)).copy()
    return src, ref, src_proj, ref_proj, depth


def cf(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


@pytest.mark.parametrize("C", [8, 16, 32])
def test_plain_matches_jax_xla_f32(C):
    src, ref, sp, rp, depth = make_scene(B=2, C=C)
    want = np.asarray(jax_warp_correlate(
        jnp.asarray(src[:, 0]), jnp.asarray(ref), jnp.asarray(sp[:, 0]), jnp.asarray(rp),
        jnp.asarray(depth),
    ))
    got = warp.warp_correlate(cf(src[:, 0]), cf(ref), torch.from_numpy(sp[:, 0]),
                              torch.from_numpy(rp), torch.from_numpy(depth))
    assert got.dtype == torch.float32 and got.shape == depth.shape
    # Same float32 arithmetic in another order; the C-mean of products of
    # unit normals is O(1).
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    zero = got.numpy() == 0
    assert zero[:, :2, :4].all()  # behind the source camera
    assert 0.02 < zero.mean() < 0.9  # and some out of frame, most not


def test_wrapper_batches_source_views():
    """All S source views in one call, [B, S, D, H, W], equals the JAX op
    view by view; on the CPU it takes the plain version and launches
    nothing."""
    src, ref, sp, rp, depth = make_scene(B=2, S=3, C=16, seed=1)
    before = k2.warp_correlate.launches
    got = k2.warp_correlate(cf(src), cf(ref), torch.from_numpy(sp), torch.from_numpy(rp),
                            torch.from_numpy(depth))
    assert k2.warp_correlate.launches == before
    assert got.shape == (2, 3, 6, 12, 16)
    for s in range(3):
        want = np.asarray(jax_warp_correlate(
            jnp.asarray(src[:, s]), jnp.asarray(ref), jnp.asarray(sp[:, s]), jnp.asarray(rp),
            jnp.asarray(depth),
        ))
        np.testing.assert_allclose(got[:, s].numpy(), want, rtol=1e-5, atol=1e-5)


def test_bf16_matches_tpu_kernel_interpret():
    # The TPU kernel's own test scene (tests/test_pallas_rowsweep.py): DTU
    # depths and a small baseline, so sample rows vary smoothly, which the
    # kernel's candidate-row window needs.
    rng = np.random.RandomState(0)
    H, W, C, D = 16, 128, 16, 4
    cams = make_cameras(rng, n=2)
    cams[:, 1, :3, :3] *= 2.0
    src = rng.randn(1, H, W, C).astype(np.float32)
    ref = rng.randn(1, H, W, C).astype(np.float32)
    base = np.linspace(420.0, 900.0, D, dtype=np.float32)[None, :, None, None]
    depth = (base + 5.0 * rng.rand(1, D, H, W)).astype(np.float32)
    rp = np.array(fuse_projection(jnp.asarray(cams[0:1])))
    sp = np.array(fuse_projection(jnp.asarray(cams[1:2])))
    want = np.asarray(warp_correlate_onehot(
        jnp.asarray(src), jnp.asarray(ref), jnp.asarray(sp), jnp.asarray(rp), jnp.asarray(depth),
        interpret=True,
    ))
    bf = torch.bfloat16
    got = k2.warp_correlate(cf(src)[:, None].to(bf), cf(ref).to(bf), torch.from_numpy(sp)[:, None],
                            torch.from_numpy(rp), torch.from_numpy(depth))[:, 0].numpy()
    # tests/test_pallas_onehot.py's tolerance for this kernel: both read
    # bf16 features, the TPU kernel also rounds its bilinear weights to
    # bf16 for the MXU (~2^-8 relative), the plain version keeps them in
    # float32. 99.5% within 3e-2, median error below 5e-3.
    close = np.isclose(got, want, rtol=3e-2, atol=3e-2)
    assert close.mean() > 0.995, close.mean()
    assert np.median(np.abs(got - want)) < 5e-3


class TestKernelChecks:
    """The checks the wrapper runs before a launch, on tensors it refuses."""

    def args(self, C=16):
        src, ref, sp, rp, depth = make_scene(B=1, S=2, C=C)
        bf = torch.bfloat16
        return [cf(src).to(bf), cf(ref).to(bf), torch.from_numpy(sp), torch.from_numpy(rp),
                torch.from_numpy(depth)]

    def test_accepts_main_path_shapes(self):
        for C in (8, 16, 32):
            assert k2._check(*self.args(C)) == (1, 2, C, 6, 12, 16)

    def test_refuses_float32_features(self):
        a = self.args()
        a[0] = a[0].float()
        with pytest.raises(TypeError, match="bfloat16"):
            k2._check(*a)

    def test_refuses_bf16_depth(self):
        a = self.args()
        a[4] = a[4].to(torch.bfloat16)
        with pytest.raises(TypeError, match="float32 depth"):
            k2._check(*a)

    def test_refuses_unsupported_channels(self):
        with pytest.raises(ValueError, match="C in"):
            k2._check(*self.args(C=4))

    def test_refuses_mismatched_views(self):
        a = self.args()
        a[2] = a[2][:, :1]
        with pytest.raises(ValueError, match="projections"):
            k2._check(*a)

    def test_refuses_non_contiguous(self):
        a = self.args()
        a[1] = a[1].transpose(2, 3).contiguous().transpose(2, 3)
        with pytest.raises(ValueError, match="contiguous"):
            k2._check(*a)
