"""The fused DCNv2 forward of the port (kernel K1's plain version, which the
CPU path takes) against the JAX package.

float32: the plain version against the JAX XLA composition
``deform_conv2d(x, *split_offsets(_offset_conv(x, k_off, b_off)), w, b)``.
bfloat16: against the TPU kernel ``deform_conv2d_onehot_fused`` in
interpret mode, at W = 128 so the kernel's lane truncation at
x mod 128 in {126, 127} stays out of the comparison.

The offset-conv weights are non-zero (the reference initialises them to
zero) and scaled so offsets reach a few pixels, are non-integer and put
taps off the image.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmvsnet_tpu.ops.dcn import deform_conv2d as jax_deform_conv2d
from transmvsnet_tpu.ops.pallas.dcn_onehot import deform_conv2d_onehot_fused
from transmvsnet_tpu.ops.pallas.vjp import _offset_conv, split_offsets
from transmvsnet_tpu_torch.ops.cuda import dcn_fused as k1
from transmvsnet_tpu_torch.ops.dcn import deform_conv2d, offset_conv
from transmvsnet_tpu_torch.ops.dcn import split_offsets as t_split_offsets


def make_inputs(B=2, H=12, W=20, C=32, C_out=32, seed=0, off_scale=0.1, off_bias=0.5):
    """JAX layouts: x [B, H, W, C], k_off [3, 3, C, 27], weight [9, C, C_out].
    The std of an offset is about sqrt(9 C) * off_scale: ~1.7 px at C = 32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, C).astype(np.float32)
    k_off = (rng.randn(3, 3, C, 27) * off_scale).astype(np.float32)
    b_off = (rng.randn(27) * off_bias).astype(np.float32)
    w = (rng.randn(9, C, C_out) * 0.1).astype(np.float32)
    b = (rng.randn(C_out) * 0.1).astype(np.float32)
    return x, k_off, b_off, w, b


def to_port(x, k_off, b_off, w, b, dtype=torch.float32):
    """JAX layouts -> the wrapper's: x NCHW, k_off [27, C, 3, 3]."""
    return (
        torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(dtype),
        torch.from_numpy(np.ascontiguousarray(k_off.transpose(3, 2, 0, 1))),
        torch.from_numpy(b_off),
        torch.from_numpy(w),
        torch.from_numpy(b),
    )


@pytest.mark.parametrize("C_out", [32, 16, 8])
def test_plain_matches_jax_xla_f32(C_out):
    args = make_inputs(C_out=C_out)
    x, k_off, b_off, w, b = (jnp.asarray(a) for a in args)
    want = np.asarray(jax_deform_conv2d(x, *split_offsets(_offset_conv(x, k_off, b_off)), w, b))
    got = k1.dcn_fused_plain(*to_port(*args)).numpy().transpose(0, 2, 3, 1)
    # Same float32 arithmetic, other summation order: outputs are O(1).
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    dy, dx, _ = split_offsets(_offset_conv(x, k_off, b_off))
    assert 0.5 < float(jnp.abs(dy).mean()) < 4.0 and float(jnp.abs(dx).max()) > 3.0


def test_offset_layout_matches_jax():
    """Interleaved torch layout: dy_k = off[2k], dx_k = off[2k+1],
    mask_k = sigmoid(off[18 + k])."""
    args = make_inputs(B=1, H=6, W=7)
    x, k_off, b_off = (jnp.asarray(a) for a in args[:3])
    want = split_offsets(_offset_conv(x, k_off, b_off))
    tx, tk, tb = to_port(*args)[:3]
    got = t_split_offsets(offset_conv(tx, tk, tb))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), np.asarray(wnt),
                                   rtol=1e-5, atol=1e-5)


def test_deform_conv2d_with_given_offsets():
    """The sampler and contraction alone, offsets straight from numpy."""
    rng = np.random.RandomState(3)
    B, H, W, C, O = 2, 9, 11, 8, 4
    x = rng.randn(B, H, W, C).astype(np.float32)
    dy, dx = (rng.uniform(-3, 3, (B, H, W, 9)).astype(np.float32) for _ in range(2))
    m = rng.rand(B, H, W, 9).astype(np.float32)
    w = rng.randn(9, C, O).astype(np.float32)
    b = rng.randn(O).astype(np.float32)
    want = np.asarray(jax_deform_conv2d(*(jnp.asarray(a) for a in (x, dy, dx, m, w, b))))

    def cf(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))

    got = deform_conv2d(cf(x), cf(dy), cf(dx), cf(m), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=1e-4, atol=1e-4)


def test_wrapper_on_cpu_is_the_plain_version():
    args = to_port(*make_inputs(B=1, H=8, W=8, C_out=16))
    before = k1.dcn_fused.launches
    torch.testing.assert_close(k1.dcn_fused(*args), k1.dcn_fused_plain(*args), rtol=0, atol=0)
    assert k1.dcn_fused.launches == before  # no kernel ran


def test_bf16_matches_tpu_kernel_interpret():
    # Offsets inside the TPU kernel's contract: its sampler reads a few
    # candidate rows shared by neighbouring pixels (DRG in dcn_onehot.py),
    # so offsets must be smooth across a row. Mostly the bias (up to ~2.7
    # px, non-integer), plus a ~0.35 px per-pixel part from the conv.
    args = make_inputs(B=1, H=16, W=128, C=32, C_out=8, seed=5, off_scale=0.02, off_bias=1.0)
    x, k_off, b_off, w, b = (jnp.asarray(a) for a in args)
    want = np.asarray(
        deform_conv2d_onehot_fused(x.astype(jnp.bfloat16), k_off, b_off, w, b, interpret=True),
        np.float32,
    )
    got = k1.dcn_fused_plain(*to_port(*args, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy().transpose(0, 2, 3, 1)
    # tests/test_pallas_onehot.py's fused-DCN tolerance: the TPU kernel
    # runs its offset conv in bf16, the plain version in float32, so where
    # an offset sits near an integer the floor() flips and isolated pixels
    # sample other taps. 99.5% within 4e-2 of the output scale, and a
    # median error below 1e-2 of it.
    scale = np.abs(want).max()
    close = np.isclose(got / scale, want / scale, rtol=0, atol=4e-2)
    assert close.mean() > 0.995, close.mean()
    assert np.median(np.abs(got - want)) < 1e-2 * scale


class TestKernelChecks:
    """The checks the wrapper runs before a launch, on tensors it refuses."""

    def args(self, **kw):
        x, k_off, b_off, w, b = to_port(*make_inputs(B=1, H=4, W=5, **kw), dtype=torch.bfloat16)
        return [x, k_off, b_off, w, b]

    def test_accepts_main_path_shapes(self):
        for c_out in (32, 16, 8):
            assert k1._check(*self.args(C_out=c_out)) == (1, 32, 4, 5, c_out)

    def test_refuses_float32(self):
        a = self.args()
        a[0] = a[0].float()
        with pytest.raises(TypeError, match="bfloat16"):
            k1._check(*a)

    def test_refuses_non_contiguous(self):
        a = self.args()
        a[0] = a[0].transpose(2, 3)
        with pytest.raises(ValueError, match="contiguous"):
            k1._check(*a)

    def test_refuses_unsupported_channels(self):
        with pytest.raises(ValueError, match="C_out"):
            k1._check(*self.args(C_out=12))

    def test_refuses_mismatched_weight(self):
        a = self.args()
        a[3] = a[3][:, :16]
        with pytest.raises(ValueError, match="weight"):
            k1._check(*a)
