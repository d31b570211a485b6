"""The port's float32 path against the JAX package's, on the CPU.

The JAX package runs float32 activations through its row-sweep TPU kernels
(``dcn_rowsweep.py::deform_conv2d_rowsweep``, ``warp_rowsweep.py::
warp_correlate_rowsweep``) and differentiates them by recomputing through
XLA (``pallas_bwd=None``); here they run in interpret mode, as the JAX
package's own tests run them. The port runs the same functions as K5
(``ops/cuda/dcn.py``) and K6 (``ops/cuda/warp_correlate.py``) with K3/K4's
float32 instantiations behind them, which on the CPU take their plain
versions. Inputs are made with numpy from a seed.

- K5's plain version against the row-sweep DCN (float32) and against the
  one-hot DCN (``dcn_onehot.py::deform_conv2d_onehot``, bf16), on inputs
  inside the TPU kernels' row-window contract (row-smooth offsets).
- K6's plain version against the row-sweep warp on its own test scene.
- The gradients of ``ops/vjp.py``'s DCN and warp Functions against
  ``jax.vjp`` of the JAX package's ``deform_conv2d_with_vjp`` and
  ``warp_correlate_with_vjp`` around the row-sweep kernels.
- The float32 cascade against the JAX ``use_pallas=True`` cascade is in
  ``tests/test_torch_f32_cascade.py``.
- One float32 train step through the new route against autograd of the
  plain forward.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmvsnet_tpu.ops.pallas.dcn_onehot import deform_conv2d_onehot
from transmvsnet_tpu.ops.pallas.dcn_rowsweep import deform_conv2d_rowsweep
from transmvsnet_tpu.ops.pallas.vjp import deform_conv2d_with_vjp
from transmvsnet_tpu.ops.pallas.vjp import warp_correlate_with_vjp as jax_warp_correlate_with_vjp
from transmvsnet_tpu.ops.pallas.warp_rowsweep import warp_correlate_rowsweep
from transmvsnet_tpu_torch.config import ModelConfig
from transmvsnet_tpu_torch.data.example import example_train_batch
from transmvsnet_tpu_torch.models.feature_net import DCN
from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
from transmvsnet_tpu_torch.ops.cuda import dcn as k5
from transmvsnet_tpu_torch.ops.cuda import warp_correlate as k6
from transmvsnet_tpu_torch.ops.vjp import dcn_with_vjp, warp_correlate_with_vjp
from transmvsnet_tpu_torch.train.loop import to_device_batch
from transmvsnet_tpu_torch.train.schedule import make_optimizer, warmup_multistep
from transmvsnet_tpu_torch.train.step import TrainState, make_train_step

from pallas_inputs import make_inputs
from test_pallas_dcn_rowsweep import smooth_offsets
from test_pallas_rowsweep import scene


def nchw(a):
    """[B, H, W, C] -> [B, C, H, W] float32 torch."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a, np.float32), -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def dcn_case(B, H, W, C, C_out, seed=0):
    """tests/test_pallas_dcn_rowsweep.py's inputs: JAX layouts, smooth
    offsets of up to 1.5 px (the row-sweep window contract)."""
    x, _, _, mask, w, b = make_inputs(B=B, H=H, W=W, C=C, C_out=C_out, off_scale=0.0, seed=seed)
    dy = smooth_offsets(B, H, W, 9, amplitude=1.5, seed=seed + 1)
    dx = smooth_offsets(B, H, W, 9, amplitude=1.5, seed=seed + 2)
    return x, dy, dx, mask, w, b


def port_dcn_args(x, dy, dx, mask, w, b, dtype=torch.float32):
    return (nchw(x).to(dtype), nchw(dy), nchw(dx), nchw(mask), torch.from_numpy(np.array(w)),
            torch.from_numpy(np.array(b)))


@pytest.mark.parametrize(
    "C,C_out,B,H,W",
    [(8, 8, 2, 32, 128), (16, 8, 2, 32, 128), (32, 32, 2, 32, 128), (32, 16, 2, 32, 128),
     (16, 8, 1, 24, 96)],  # the last: a width the TPU kernel pads to 128
)
def test_dcn_plain_f32_matches_rowsweep_interpret(C, C_out, B, H, W):
    args = dcn_case(B, H, W, C, C_out)
    want = np.asarray(deform_conv2d_rowsweep(*args, interpret=True))
    before = k5.deform_conv2d.launches_f32
    got = k5.deform_conv2d(*port_dcn_args(*args))
    assert k5.deform_conv2d.launches_f32 == before  # the CPU takes the plain version
    assert got.dtype == torch.float32
    # tests/test_pallas_dcn_rowsweep.py's tolerance: float32 on both sides,
    # other summation order; outputs are O(1).
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-4, atol=1e-4)


def test_dcn_plain_bf16_matches_onehot_interpret():
    """Row 4: bf16 activations, float32 offsets and mask, at W = 128 (no
    lane truncation at x mod 128 in {126, 127})."""
    args = dcn_case(1, 16, 128, 32, 8, seed=5)
    want = np.asarray(deform_conv2d_onehot(*args, interpret=True), np.float32)
    got = k5.deform_conv2d(*port_dcn_args(*args, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = nhwc(got)
    # tests/test_torch_dcn.py::test_bf16_matches_tpu_kernel_interpret's
    # tolerance: the TPU kernel rounds its weights and bilinear weights to
    # bf16 for the MXU, the plain version keeps them in float32 and rounds
    # once. 99.5% within 4e-2 of the output scale, median below 1e-2 of it.
    scale = np.abs(want).max()
    close = np.isclose(got / scale, want / scale, rtol=0, atol=4e-2)
    assert close.mean() > 0.995, close.mean()
    assert np.median(np.abs(got - want)) < 1e-2 * scale


def test_dcn_plain_bf16_adds_bias_before_the_rounding():
    """Row 4's wrapper adds the bias in float32 and rounds once; so does
    K5's plain version for bf16 (ops/dcn.py::deform_conv2d adds it after
    the cast, as the JAX XLA op does)."""
    args = list(port_dcn_args(*dcn_case(1, 16, 24, 8, 8, seed=3), dtype=torch.bfloat16))
    args[5] = torch.full((8,), 0.3)
    got = k5.deform_conv2d(*args)
    args32 = [args[0].float(), *args[1:]]
    want = k5.deform_conv2d(*args32).to(torch.bfloat16)
    assert torch.equal(got, want)


def warp_port(src, ref, sp, rp, dv):
    """The port's warp on the row-sweep scene (one source view)."""
    return k6.warp_correlate(nchw(src)[:, None], nchw(ref), torch.from_numpy(np.array(sp))[:, None],
                             torch.from_numpy(np.array(rp)), torch.from_numpy(np.array(dv)))


@pytest.mark.parametrize("C", [8, 16, 32])
def test_warp_plain_f32_matches_rowsweep_interpret(C):
    src, ref, sp, rp, dv = scene(C=C)
    want = np.asarray(warp_correlate_rowsweep(src, ref, sp, rp, dv, interpret=True))
    before = k6.warp_correlate.launches_f32
    got = warp_port(src, ref, sp, rp, dv)[:, 0].numpy()
    assert k6.warp_correlate.launches_f32 == before
    # tests/test_pallas_rowsweep.py's window contract: the TPU kernel may
    # drop a small fraction of extreme taps; >= 99.5% within 1e-4 and a
    # median error below 1e-5.
    close = np.isclose(got, want, rtol=1e-4, atol=1e-4)
    assert close.mean() > 0.995, close.mean()
    assert np.median(np.abs(got - want)) < 1e-5


def test_dcn_function_gradients_match_jax_rowsweep_vjp():
    """dcn_with_vjp (K5 + K3, plain versions here) against jax.vjp of
    deform_conv2d_with_vjp around the row-sweep kernel with the XLA
    recompute backward: forward and the gradients to x, dy, dx, mask,
    weight and bias. At the first forward case's shapes, whose compiled
    interpret-mode kernel JAX reuses."""
    args = dcn_case(2, 32, 128, 8, 8, seed=7)
    g = np.random.RandomState(8).randn(2, 32, 128, 8).astype(np.float32)
    f = deform_conv2d_with_vjp(functools.partial(deform_conv2d_rowsweep, interpret=True))
    want_out, vjp = jax.vjp(f, *args)
    want = vjp(jnp.asarray(g))
    leaves = [t.requires_grad_() for t in port_dcn_args(*args)]
    out = dcn_with_vjp(*leaves)
    (out * nchw(g)).sum().backward()
    np.testing.assert_allclose(nhwc(out), np.asarray(want_out), rtol=1e-4, atol=1e-4)
    got = [nhwc(t.grad) for t in leaves[:4]] + [leaves[4].grad.numpy(), leaves[5].grad.numpy()]
    for a, b, name in zip(got, want, ("x", "offset_y", "offset_x", "mask", "weight", "bias")):
        b = np.asarray(b)
        # Float32 on both sides (autodiff of the same floor-based sampler),
        # other summation order.
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * np.abs(b).max(), err_msg=name)


def test_warp_function_gradients_match_jax_rowsweep_vjp():
    """warp_correlate_with_vjp (K6 + K4, plain versions here) against
    jax.vjp of the JAX package's warp_correlate_with_vjp around the
    row-sweep kernel: the gradients to the source and reference features."""
    src, ref, sp, rp, dv = scene(C=16, seed=2)
    g = np.random.RandomState(3).randn(*dv.shape).astype(np.float32)
    f = jax_warp_correlate_with_vjp(functools.partial(warp_correlate_rowsweep, interpret=True))
    _, vjp = jax.vjp(f, src, ref, sp, rp, dv)
    want_src, want_ref = (np.asarray(a) for a in vjp(jnp.asarray(g))[:2])
    s, r = nchw(src)[:, None].requires_grad_(), nchw(ref).requires_grad_()
    out = warp_correlate_with_vjp(s, r, torch.from_numpy(np.array(sp))[:, None],
                                  torch.from_numpy(np.array(rp)), torch.from_numpy(np.array(dv)))
    (out[:, 0] * torch.from_numpy(g)).sum().backward()
    # Float32 on both sides (autodiff of the XLA warp and of the plain
    # warp), other summation order.
    for got, want, name in ((nhwc(s.grad[:, 0]), want_src, "src"), (nhwc(r.grad), want_ref, "ref")):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max(), err_msg=name)


NDEPTHS = (8, 8, 8)  # the train step's hypotheses per stage


@pytest.mark.parametrize("dtype,route",
                         [(torch.float32, "_DCNBackward"), (torch.bfloat16, "_DCNFusedBackward")])
def test_dcn_layer_route_follows_the_dtype(dtype, route):
    """float32 runs the offset conv as a module and K5 + K3 through
    dcn_with_vjp; bf16 runs the conv-fused K1 + K3. On every device: here
    each Function takes its kernels' plain versions."""
    layer = DCN(8, 16)
    x = torch.randn(2, 8, 6, 7, generator=torch.Generator().manual_seed(0)).to(dtype)
    out = layer(x)
    assert out.dtype == dtype and out.shape == (2, 16, 6, 7)
    assert type(out.grad_fn).__name__ == route


def _train_step_grads(plain: bool, batch, cfg: ModelConfig = ModelConfig(ndepths=NDEPTHS)):
    model = TransMVSNet(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DCN):
                w, b = m.conv_offset_mask.weight, m.conv_offset_mask.bias
                w.copy_(torch.randn(w.shape, generator=gen) * 0.05)
                b.copy_(torch.randn(b.shape, generator=gen) * 1.5)
    model.use_plain_ops(plain)
    state = TrainState(model, *make_optimizer(model.parameters(), warmup_multistep(1e-3, [10**6], 0.5)))
    routes = []
    hooks = [m.register_forward_hook(lambda mod, a, out: routes.append(type(out.grad_fn).__name__))
             for m in model.modules() if isinstance(m, DCN)]
    _, scalars = make_train_step()(state, batch)
    for h in hooks:
        h.remove()
    return scalars["loss"].item(), {n: p.grad.clone() for n, p in model.named_parameters()}, routes


def test_f32_train_step_through_the_kernel_route_matches_plain_autograd():
    """One float32 step on the CPU through the Functions (K5 + K3 and
    K6 + K4, plain versions here) against the same step on the plain
    forward differentiated by autograd: loss and every gradient to 1e-5."""
    batch = to_device_batch(example_train_batch(B=1, V=3, H=32, W=64, num_hyp=48), torch.device("cpu"))
    loss, grads, routes = _train_step_grads(False, batch)
    want_loss, want, plain_routes = _train_step_grads(True, batch)
    assert routes == ["_DCNBackward"] * 9 and "_DCNBackward" not in plain_routes
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    top = max(w.abs().max() for w in want.values()).item()
    for n, w in want.items():
        # The same float32 operations on both sides, in another order where
        # the Functions recompute: 1e-5 of each value plus 1e-5 of the
        # largest gradient.
        torch.testing.assert_close(grads[n], w, rtol=1e-5, atol=1e-5 * top, msg=n)
