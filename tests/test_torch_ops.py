"""The port's geometry, sampling and attention primitives against the JAX
package's, on the CPU in float32.

Inputs are made with numpy from a seed and handed to both; JAX is
channel-last, the port NCHW, so the comparisons transpose. Tolerances are
float32 rounding of the same arithmetic in another order (1e-5 relative,
looser where a 3x3 inverse or a division by depth amplifies it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmvsnet_tpu.models import fmt as jfmt
from transmvsnet_tpu.ops import geometry as jgeo
from transmvsnet_tpu.ops import sampling as jsam
from transmvsnet_tpu_torch.models import fmt as tfmt
from transmvsnet_tpu_torch.ops import geometry as tgeo
from transmvsnet_tpu_torch.ops import sampling as tsam

from test_geometry import make_cameras


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.numpy(), 1, -1)


class TestGeometry:
    def test_projection_algebra(self):
        cams = make_cameras(np.random.RandomState(0), n=3)
        fused = np.array(jgeo.fuse_projection(jnp.asarray(cams)))
        np.testing.assert_allclose(
            tgeo.fuse_projection(torch.from_numpy(cams)).numpy(), fused, rtol=1e-6
        )
        t_fused = torch.from_numpy(fused)
        # The closed-form adjugate inverse divides by det(K R): ~1e-6 relative.
        np.testing.assert_allclose(
            tgeo.invert_fused_projection(t_fused).numpy(),
            np.asarray(jgeo.invert_fused_projection(jnp.asarray(fused))),
            rtol=1e-5, atol=1e-7,
        )
        np.testing.assert_allclose(
            tgeo.relative_projection(t_fused[1:], t_fused[:1].expand(2, 4, 4)).numpy(),
            np.asarray(jgeo.relative_projection(jnp.asarray(fused[1:]), jnp.asarray(fused[:1]))),
            rtol=1e-5, atol=1e-5,
        )

    def test_warp_coords_with_invalid_depth(self):
        """Includes hypotheses behind the source camera (z < 1e-6), which
        both sides send to the same far out-of-range coordinate."""
        rng = np.random.RandomState(1)
        H, W, D = 12, 16, 5
        cams = make_cameras(rng)
        fused = np.array(jgeo.fuse_projection(jnp.asarray(cams)))
        depth = np.broadcast_to(
            np.linspace(2.0, 8.0, D, dtype=np.float32)[None, :, None, None], (1, D, H, W)
        ).copy()
        depth[:, 0, :4] = -3.0
        jx, jy = jgeo.warp_coords(jnp.asarray(fused[1:]), jnp.asarray(fused[:1]), jnp.asarray(depth))
        tx, ty = tgeo.warp_coords(
            torch.from_numpy(fused[1:]), torch.from_numpy(fused[:1]), torch.from_numpy(depth)
        )
        assert (tx.numpy() == tgeo.INVALID_COORD).sum() == (np.asarray(jx) == tgeo.INVALID_COORD).sum() > 0
        # Pixel coordinates up to ~30: float32 division rounding ~1e-5 px.
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-4)

    def test_initial_depth_samples(self):
        hyp = np.linspace(425.0, 931.45, 192, dtype=np.float32)[None]
        ours = tgeo.initial_depth_samples(torch.from_numpy(hyp), 48, (8, 10))
        theirs = jgeo.initial_depth_samples(jnp.asarray(hyp), 48, (8, 10))
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6)

    @pytest.mark.parametrize("per_batch_interval", [False, True])
    def test_refine_depth_samples(self, per_batch_interval):
        rng = np.random.RandomState(4)
        B, hp, wp = 2, 6, 8
        prev = (500 + 50 * rng.rand(B, hp, wp)).astype(np.float32)
        interval = np.array([2.5, 1.25], np.float32) if per_batch_interval else 2.5
        ours = tgeo.refine_depth_samples(
            torch.from_numpy(prev), 8, torch.as_tensor(interval), (12, 16), (24, 32)
        )
        theirs = jgeo.refine_depth_samples(jnp.asarray(prev), 8, jnp.asarray(interval),
                                           (12, 16), (24, 32))
        # Depths ~500: float32 ulp is 3e-5 there.
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-4)


class TestSampling:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_bilinear_sample(self, seed):
        rng = np.random.RandomState(seed)
        B, H, W, C = 2, 13, 17, 5
        img = rng.randn(B, H, W, C).astype(np.float32)
        # In range, out of range on every side, and the invalid marker.
        x = rng.uniform(-3, W + 2, size=(B, 7, 11)).astype(np.float32)
        y = rng.uniform(-3, H + 2, size=(B, 7, 11)).astype(np.float32)
        x[0, 0, 0] = y[0, 0, 0] = tgeo.INVALID_COORD
        x[1, 0, :3] = [0.0, W - 1.0, W - 0.5]
        ours = tsam.bilinear_sample(_nchw(img), torch.from_numpy(x), torch.from_numpy(y))
        theirs = jsam.bilinear_sample(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
        assert ours.shape == (B, C, 7, 11)
        np.testing.assert_allclose(_nhwc(ours), np.asarray(theirs), rtol=1e-5, atol=1e-6)
        assert np.all(_nhwc(ours)[0, 0, 0] == 0)

    @pytest.mark.parametrize(
        "in_hw,out_hw",
        [((16, 24), (64, 96)), ((64, 96), (16, 24)), ((13, 17), (29, 23)), ((54, 72), (216, 288))],
    )
    def test_resize_bilinear(self, in_hw, out_hw):
        x = np.random.RandomState(0).randn(2, *in_hw, 3).astype(np.float32)
        ours = tsam.resize_bilinear(_nchw(x), out_hw)
        theirs = jsam.resize_bilinear(jnp.asarray(x), out_hw)
        # The JAX side resizes by matrix products; 1e-5 of unit-scale data.
        np.testing.assert_allclose(_nhwc(ours), np.asarray(theirs), rtol=1e-4, atol=1e-5)

    def test_upsample_nearest_2x(self):
        x = np.random.RandomState(0).randn(2, 5, 7, 3).astype(np.float32)
        ours = tsam.upsample_nearest_2x(_nchw(x))
        np.testing.assert_array_equal(_nhwc(ours), np.asarray(jsam.upsample_nearest_2x(jnp.asarray(x))))


class TestAttentionPrimitives:
    @pytest.mark.parametrize("hw", [(4, 6), (27, 36)])
    def test_sine_position_encoding(self, hw):
        np.testing.assert_array_equal(
            tfmt.sine_position_encoding(*hw, 32), jfmt.sine_position_encoding(*hw, 32)
        )

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_linear_attention(self, dtype):
        rng = np.random.RandomState(0)
        q, k, v = (rng.randn(2, 24, 8, 4).astype(np.float32) for _ in range(3))
        tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v))
        jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
        ours = tfmt.linear_attention(tq, tk, tv).float().numpy()
        theirs = np.asarray(jfmt.linear_attention(jq, jk, jv), np.float32)
        # float32: summation order only. bfloat16: both sum in float32 and
        # round the result once, but elu+1 rounds in bf16 on each side at
        # other places; outputs are O(1), one bf16 step is 2^-8.
        tol = 1e-5 if dtype == "float32" else 2e-2
        np.testing.assert_allclose(ours, theirs, rtol=tol, atol=tol)
