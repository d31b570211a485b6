"""The port's fused view sum (``fused_view_sum=True``, bf16 features) against
the JAX package's, on the CPU.

The JAX package sums the source views inside its warp kernel at stages 2-3
(``warp_onehot.py::warp_correlate_wsum_onehot``) and differentiates it with
``warp_bwd.py::warp_correlate_wsum_bwd``; here both run in interpret mode,
as the JAX package's own tests run them. The port runs the same functions
as K7 (``ops/cuda/warp_correlate.py::warp_correlate_wsum``) and K8
(``ops/cuda/warp_correlate_bwd.py::warp_correlate_wsum_bwd``), which on
the CPU take their plain versions. Inputs are made with numpy from a seed.

- K7's plain version against the JAX kernel (bf16) and against the JAX XLA
  composition (float32); K8's plain version against the JAX backward
  kernel; the autograd Function against ``jax.vjp`` of the JAX package's
  ``warp_correlate_wsum_with_vjp``.
- One cascade stage (``depth_stage``) against the JAX ``run_stage`` on the
  fused route, beside a witness of the kernels' own bf16 noise.
- The port's bf16 cascade with the fused sum against without it, and one
  bf16 train step through the fused route against autograd of the plain
  forward.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmvsnet_tpu.config import ModelConfig as JaxModelConfig
from transmvsnet_tpu.convert.torch_weights import convert_state_dict
from transmvsnet_tpu.models.transmvsnet import TransMVSNet as JaxTransMVSNet
from transmvsnet_tpu.ops.pallas.vjp import warp_correlate_wsum_with_vjp as jax_wsum_with_vjp
from transmvsnet_tpu.ops.pallas.warp_bwd import warp_correlate_wsum_bwd as jax_wsum_bwd
from transmvsnet_tpu.ops.pallas.warp_onehot import warp_correlate_wsum_onehot
from transmvsnet_tpu.ops.warp import warp_correlate as jax_warp_correlate
from transmvsnet_tpu_torch.config import ModelConfig
from transmvsnet_tpu_torch.convert.jax_weights import state_dict_from_jax
from transmvsnet_tpu_torch.data.example import example_train_batch
from transmvsnet_tpu_torch.models import transmvsnet as port_model
from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
from transmvsnet_tpu_torch.ops.cuda import warp_correlate as k7
from transmvsnet_tpu_torch.ops.cuda import warp_correlate_bwd as k8
from transmvsnet_tpu_torch.ops.vjp import warp_correlate_wsum_with_vjp
from transmvsnet_tpu_torch.train.loop import to_device_batch

from test_pallas_bwd import _assert_close
from test_pallas_wsum import _inputs as wsum_inputs
from test_parity import dtu_like_inputs
from test_torch_f32 import _train_step_grads
from test_torch_model import _perturb
from test_torch_warp import cf, make_scene

BF = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops here are small: one thread runs them in seconds,
    where a thread pool per pytest-xdist worker oversubscribes the CPUs
    and slows this file and its neighbours many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bf16_exact(a):
    """numpy float32 values rounded through bf16, so that both packages read
    the same features."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def port_args(src, ref, sp, rp, dv, vw, dtype=BF):
    """JAX layouts -> the port's: features channels-first in ``dtype``."""
    return (cf(np.asarray(src)).to(dtype), cf(np.asarray(ref)).to(dtype),
            *(torch.from_numpy(np.array(a)) for a in (sp, rp, dv, vw)))


@pytest.mark.parametrize("C", [8, 32])
def test_k7_plain_matches_tpu_kernel_interpret_bf16(C):
    """tests/test_pallas_wsum.py's inputs (S = 3, H = 16, W = 128)."""
    src, ref, sp, rp, dv, vw = wsum_inputs(C=C)
    want = np.asarray(warp_correlate_wsum_onehot(src, ref, sp, rp, dv, vw, interpret=True))
    before = k7.warp_correlate_wsum.launches
    got = k7.warp_correlate_wsum(*port_args(src, ref, sp, rp, dv, vw))
    assert k7.warp_correlate_wsum.launches == before  # the CPU takes the plain version
    assert got.dtype == torch.float32 and got.shape == want.shape
    got = got.numpy()
    # tests/test_torch_warp.py::test_bf16_matches_tpu_kernel_interpret's
    # tolerance: both read bf16 features, the TPU kernel also rounds its
    # bilinear weights to bf16 (~2^-8 relative). 99.5% within 3e-2, median
    # error below 5e-3.
    close = np.isclose(got, want, rtol=3e-2, atol=3e-2)
    assert close.mean() > 0.995, close.mean()
    assert np.median(np.abs(got - want)) < 5e-3


def test_k7_plain_matches_jax_xla_composition_f32():
    """Float32 features against sum_s vw_s * warp_correlate(src_s) of the JAX
    XLA op, with hypotheses behind the source cameras and samples out of
    frame."""
    src, ref, sp, rp, depth = make_scene(B=2, S=3, C=16, seed=4)
    vw = np.random.RandomState(5).rand(2, 3, *depth.shape[2:]).astype(np.float32)
    want = sum(
        vw[:, s, None] * np.asarray(jax_warp_correlate(
            jnp.asarray(src[:, s]), jnp.asarray(ref), jnp.asarray(sp[:, s]), jnp.asarray(rp),
            jnp.asarray(depth)))
        for s in range(3)
    )
    got = k7.warp_correlate_wsum(*port_args(src, ref, sp, rp, depth, vw, dtype=torch.float32))
    # Same float32 arithmetic in another order; values O(1).
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (got.numpy() == 0).mean() > 0.02  # some samples invalid in every view


def test_k8_plain_matches_tpu_backward_interpret_bf16():
    """dsrc, dref and dvw against the TPU backward kernel, with
    tests/test_pallas_bwd.py's tolerances."""
    src, ref, sp, rp, dv, vw = wsum_inputs(C=16)
    g = np.random.RandomState(6).randn(*dv.shape).astype(np.float32)
    want = jax_wsum_bwd(src, ref, sp, rp, dv, vw, jnp.asarray(g), interpret=True)
    before = k8.warp_correlate_wsum_bwd.launches
    dsrc, dref, dvw = k8.warp_correlate_wsum_bwd(*port_args(src, ref, sp, rp, dv, vw), torch.from_numpy(g))
    assert k8.warp_correlate_wsum_bwd.launches == before
    assert dsrc.dtype == dref.dtype == dvw.dtype == torch.float32
    _assert_close(np.moveaxis(dsrc.numpy(), 2, -1), want[0], "dsrc")
    _assert_close(np.moveaxis(dref.numpy(), 1, -1), want[1], "dref")
    _assert_close(dvw.numpy(), want[2], "dvw")


def test_function_gradients_match_jax_vjp_and_none_for_geometry():
    """warp_correlate_wsum_with_vjp against jax.vjp of the JAX package's
    warp_correlate_wsum_with_vjp around the TPU forward and backward kernels
    (interpret mode), on bf16-exact features; projections and hypotheses
    get no gradient even when they require one."""
    src, ref, sp, rp, dv, vw = wsum_inputs(C=8)
    src, ref = bf16_exact(src), bf16_exact(ref)
    g = np.random.RandomState(7).randn(*dv.shape).astype(np.float32)
    f = jax_wsum_with_vjp(functools.partial(warp_correlate_wsum_onehot, interpret=True),
                          pallas_bwd=functools.partial(jax_wsum_bwd, interpret=True))
    want_out, vjp = jax.vjp(f, jnp.asarray(src), jnp.asarray(ref), sp, rp, dv, vw)
    want = vjp(jnp.asarray(g))
    leaves = [t.requires_grad_() for t in port_args(src, ref, sp, rp, dv, vw)]
    out = warp_correlate_wsum_with_vjp(*leaves)
    (out * torch.from_numpy(g)).sum().backward()
    s, r, tsp, trp, tdv, w = leaves
    assert tsp.grad is None and trp.grad is None and tdv.grad is None
    assert s.grad.dtype == BF and w.grad.dtype == torch.float32
    # The forward as test_k7_plain_matches_tpu_kernel_interpret_bf16.
    assert np.isclose(out.detach().numpy(), np.asarray(want_out), rtol=3e-2, atol=3e-2).mean() > 0.995
    _assert_close(np.moveaxis(s.grad.float().numpy(), 2, -1), want[0], "dsrc")
    _assert_close(np.moveaxis(r.grad.float().numpy(), 1, -1), want[1], "dref")
    _assert_close(w.grad.numpy(), want[5], "dvw")


def test_function_returns_no_view_weight_gradient_unless_asked():
    src, ref, sp, rp, dv, vw = port_args(*wsum_inputs(C=8))
    s = src.requires_grad_()
    warp_correlate_wsum_with_vjp(s, ref, sp, rp, dv, vw).sum().backward()
    assert s.grad is not None and vw.grad is None


class TestKernelChecks:
    """What K7 and K8 refuse before a launch, beyond the per-view checks."""

    def args(self):
        return list(port_args(*wsum_inputs(C=8)))

    def test_accepts_bf16_features_and_float32_weights(self):
        assert k7._check_wsum(*self.args()) == (1, 3, 8, 4, 16, 128)

    def test_refuses_float32_features(self):
        a = self.args()
        a[0], a[1] = a[0].float(), a[1].float()
        with pytest.raises(TypeError, match="bfloat16 features"):
            k7._check_wsum(*a)

    def test_refuses_bf16_view_weights(self):
        a = self.args()
        a[5] = a[5].to(BF)
        with pytest.raises(TypeError, match="float32 view weights"):
            k7._check_wsum(*a)

    def test_refuses_view_weights_of_another_shape(self):
        a = self.args()
        a[5] = a[5][:, :2]
        with pytest.raises(ValueError, match="view weights must be"):
            k7._check_wsum(*a)

    def test_refuses_non_contiguous_view_weights(self):
        a = self.args()
        a[5] = a[5].transpose(2, 3).contiguous().transpose(2, 3)
        with pytest.raises(ValueError, match="contiguous view weights"):
            k7._check_wsum(*a)


# One cascade stage: stage index 1 (C = 16) and 2 (C = 8), h = 16, w = 128
# (the TPU kernel's lane width), D = 8 (CostRegNet's three halvings).
V, D, STAGE_H, STAGE_W = 3, 8, 16, 128


@pytest.fixture(scope="module")
def stage_models():
    """The JAX variables from the port's seeded, perturbed init (as
    tests/test_torch_model.py), loaded back into a bf16 port model with the
    fused sum. JAX: the fused route (bf16, TPU kernels in interpret mode)
    and, as the witness, the XLA route in bf16."""
    imgs, projs, dv = dtu_like_inputs(V=V, H=64, W=64)
    shapes = jax.eval_shape(
        lambda k: JaxTransMVSNet(JaxModelConfig(ndepths=(D,) * 3)).init(
            k, jnp.asarray(imgs), {k_: jnp.asarray(v) for k_, v in projs.items()}, jnp.asarray(dv)),
        jax.random.PRNGKey(0),
    )
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    cfg = ModelConfig(ndepths=(D,) * 3, compute_dtype="bfloat16", fused_view_sum=True)
    tmodel = TransMVSNet(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    variables = convert_state_dict(_perturb(tmodel.state_dict(), np.random.RandomState(0)), template,
                                   strict=True)
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    tmodel.eval()
    jax_cfg = dict(ndepths=(D,) * 3, compute_dtype="bfloat16", fused_view_sum=True)
    fused = JaxTransMVSNet(JaxModelConfig(**jax_cfg, use_pallas=True, pallas_interpret=True))
    xla = JaxTransMVSNet(JaxModelConfig(**jax_cfg))
    return variables, tmodel, fused, xla


def stage_inputs(stage_idx, seed):
    """bf16-exact features [1, V, h, w, C], the stage's projections from
    DTU-like cameras (small baseline), hypotheses over the DTU range and
    float32 view weights in (0, 1)."""
    C = (32, 16, 8)[stage_idx]
    rng = np.random.RandomState(seed)
    feats = bf16_exact(rng.randn(1, V, STAGE_H, STAGE_W, C).astype(np.float32))
    scale = 2 ** (2 - stage_idx)
    _, projs, _ = dtu_like_inputs(V=V, H=STAGE_H * scale, W=STAGE_W * scale)
    proj = projs[f"stage{stage_idx + 1}"]
    depth = (np.linspace(500.0, 800.0, D, dtype=np.float32)[None, :, None, None]
             + 5.0 * rng.rand(1, D, STAGE_H, STAGE_W)).astype(np.float32)
    vw = rng.uniform(0.05, 1.0, (1, V - 1, STAGE_H, STAGE_W)).astype(np.float32)
    return feats, proj, depth, vw


@pytest.mark.parametrize("stage_idx", [1, 2])
def test_stage_matches_jax_fused_stage(stage_models, stage_idx, monkeypatch):
    variables, tmodel, fused, xla = stage_models
    feats, proj, depth, vw = stage_inputs(stage_idx, seed=10 + stage_idx)

    def jax_stage(model):
        out, _ = model.apply(variables, jnp.asarray(feats, jnp.bfloat16), jnp.asarray(proj),
                             jnp.asarray(depth), stage_idx, jnp.asarray(vw)[..., None], False,
                             method=JaxTransMVSNet.run_stage)
        return np.asarray(out["prob_volume"]), np.asarray(out["depth"])

    want_prob, want_depth = jax_stage(fused)
    xla_prob, xla_depth = jax_stage(xla)
    calls = []
    monkeypatch.setattr(port_model, "warp_correlate_wsum_with_vjp",
                        lambda *a: calls.append(1) or warp_correlate_wsum_with_vjp(*a))
    with torch.no_grad():
        out, w_out = tmodel.depth_stage(
            torch.from_numpy(np.ascontiguousarray(np.moveaxis(feats, -1, 2))).to(BF),
            torch.from_numpy(proj), torch.from_numpy(depth),
            tmodel.cost_regularization[stage_idx], torch.from_numpy(vw))
    assert calls == [1]  # the fused route, through the Function
    assert torch.equal(w_out, torch.from_numpy(vw))
    got_prob, got_depth = out["prob_volume"].numpy(), out["depth"].numpy()
    err = np.abs(got_prob - want_prob)
    witness = np.abs(xla_prob - want_prob)
    print(f"stage {stage_idx}: port vs JAX fused: max |dprob| {err.max():.3g}, median {np.median(err):.3g}, "
          f"depth equal {np.mean(got_depth == want_depth):.4f}; witness JAX XLA vs JAX fused: max "
          f"{witness.max():.3g}, median {np.median(witness):.3g}, depth equal "
          f"{np.mean(xla_depth == want_depth):.4f}")
    # Set from the witness printed beside it: the JAX package's own bf16
    # XLA stage differs from its fused-kernel stage by the kernel's bf16
    # bilinear weights carried through a bf16 CostRegNet (max |dprob|
    # 1.6e-4 / 1.3e-4, median 2.0e-5 / 1.3e-5, WTA depth equal at 98.9% /
    # 99.7% of pixels at stage index 1 / 2); the port reads 1.3e-4 / 1.2e-4,
    # 1.4e-5 / 7.7e-6 and 99.4% / 99.8%. About three times the witness's
    # error, and its depth share less one point.
    assert err.max() < 5e-4
    assert np.median(err) < 6e-5
    assert np.mean(got_depth == want_depth) >= 0.98


NDEPTHS = (8, 8, 8)


def _cascade(fused_view_sum):
    imgs, projs, dv = dtu_like_inputs(V=V, H=64, W=64)
    model = TransMVSNet(ModelConfig(ndepths=NDEPTHS, compute_dtype="bfloat16", fused_view_sum=fused_view_sum),
                        device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        return model(torch.from_numpy(imgs), {k: torch.from_numpy(v) for k, v in projs.items()},
                     torch.from_numpy(dv))


def test_bf16_cascade_with_fused_view_sum_matches_without(monkeypatch):
    """The whole bf16 cascade at 64x64, 3 views: the fused sum (stages 2-3
    through the Function) against the per-view route."""
    want = _cascade(False)
    calls = []
    monkeypatch.setattr(port_model, "warp_correlate_wsum_with_vjp",
                        lambda *a: calls.append(1) or warp_correlate_wsum_with_vjp(*a))
    got = _cascade(True)
    assert len(calls) == 2
    for s in ("stage1", "stage2", "stage3"):
        # The similarity goes to CostRegNet in bf16: a float32 difference in
        # the weighted sum moves it by at most one bf16 step (2^-8).
        np.testing.assert_allclose(got[s]["prob_volume"].numpy(), want[s]["prob_volume"].numpy(),
                                   rtol=2**-8, atol=1e-6, err_msg=s)
        np.testing.assert_array_equal(got[s]["depth"].numpy(), want[s]["depth"].numpy())


def test_float32_ignores_fused_view_sum(stage_models, monkeypatch):
    """As in the JAX package, float32 features stay on the per-view route."""
    calls = []
    monkeypatch.setattr(port_model, "warp_correlate_wsum_with_vjp", lambda *a: calls.append(1))
    model = TransMVSNet(ModelConfig(ndepths=NDEPTHS, fused_view_sum=True), device="cpu")
    model.load_state_dict(stage_models[1].state_dict())
    feats, proj, depth, vw = stage_inputs(2, seed=3)
    with torch.no_grad():
        out, _ = model.eval().depth_stage(
            torch.from_numpy(np.ascontiguousarray(np.moveaxis(feats, -1, 2))), torch.from_numpy(proj),
            torch.from_numpy(depth), model.cost_regularization[2], torch.from_numpy(vw))
    assert calls == [] and torch.isfinite(out["prob_volume"]).all()


def test_bf16_train_step_through_the_fused_route_matches_plain_autograd(monkeypatch):
    """One bf16 step on the CPU through the Functions (K1 + K3, K2 + K4 at
    stage 1, K7 + K8 at stages 2-3; plain versions here) against the same
    step on the plain forward differentiated by autograd."""
    batch = to_device_batch(example_train_batch(B=1, V=V, H=32, W=64, num_hyp=48), torch.device("cpu"))
    calls = []
    monkeypatch.setattr(port_model, "warp_correlate_wsum_with_vjp",
                        lambda *a: calls.append(1) or warp_correlate_wsum_with_vjp(*a))
    # The 3-D cost regulariser, with whose bf16 gradients into the warp the
    # tolerance below was set; the dense form (the default) is the next
    # test's.
    cfg = ModelConfig(ndepths=NDEPTHS, compute_dtype="bfloat16", fused_view_sum=True, dense_cost_reg=False)
    loss, grads, routes = _train_step_grads(False, batch, cfg)
    assert len(calls) == 2 and routes == ["_DCNFusedBackward"] * 9
    want_loss, want, _ = _train_step_grads(True, batch, cfg)
    assert np.isfinite(loss)
    # The same forward on both sides (the Functions' forwards are the plain
    # versions here).
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    top = max(w.abs().max() for w in want.values()).item()
    for n, w in want.items():
        # The Functions take their backward in float32 and round once to the
        # features' bf16; autograd of the plain ops sums in another order
        # before the same rounding: 1e-4 of each value plus 5e-5 of the
        # largest gradient (the worst read 1e-5 of it).
        torch.testing.assert_close(grads[n], w, rtol=1e-4, atol=5e-5 * top, msg=n)


def _one_step_up_at_the_largest(g):
    """``g`` with its largest-magnitude element moved one step of its dtype
    towards +inf."""
    flat = g.clone().flatten()
    i = flat.abs().argmax()
    flat[i] = torch.nextafter(flat[i], torch.tensor(float("inf"), dtype=g.dtype))
    return flat.view_as(g)


def test_bf16_train_step_with_the_dense_cost_reg_through_the_fused_route_matches_plain_autograd(monkeypatch):
    """The previous test with the dense cost regulariser (the default).

    Both routes receive the same gradients into the features; inside
    FeatureNet the Functions' float32 backward and autograd's differ by
    float32 rounding, which flips a few bf16 roundings of the gradient,
    and train-mode BatchNorm spreads each flip over its whole channel on
    the way down. The witness of that noise is the plain step again with
    one bf16 step added to the largest gradient element of each DCN
    layer's output: it moves FeatureNet's first conv's gradient by 9.9e-3
    of the largest gradient (the 3-D form's by 1.0e-2, where the routes
    happen to flip no rounding), and the routes part by no more than it
    moves each parameter (worst 1.0 of it, conv0's first conv). Each
    gradient is held to twice the witness's move of it, and to the
    previous test's tolerance where that is larger."""
    from transmvsnet_tpu_torch.models.feature_net import DCN

    batch = to_device_batch(example_train_batch(B=1, V=V, H=32, W=64, num_hyp=48), torch.device("cpu"))
    calls = []
    monkeypatch.setattr(port_model, "warp_correlate_wsum_with_vjp",
                        lambda *a: calls.append(1) or warp_correlate_wsum_with_vjp(*a))
    cfg = ModelConfig(ndepths=NDEPTHS, compute_dtype="bfloat16", fused_view_sum=True)
    assert cfg.dense_cost_reg
    loss, grads, routes = _train_step_grads(False, batch, cfg)
    assert len(calls) == 2 and routes == ["_DCNFusedBackward"] * 9
    want_loss, want, _ = _train_step_grads(True, batch, cfg)
    forward = DCN.forward

    def nudged(self, *args):
        out = forward(self, *args)
        out.register_hook(_one_step_up_at_the_largest)
        return out

    with monkeypatch.context() as m:
        m.setattr(DCN, "forward", nudged)
        witness_loss, witness, _ = _train_step_grads(True, batch, cfg)
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    assert witness_loss == want_loss
    top = max(w.abs().max() for w in want.values()).item()
    moved = {n: (witness[n] - w).abs().max().item() for n, w in want.items()}
    # The witness is a one-step nudge: it moves no gradient by more than a
    # few hundredths of the largest (read 9.9e-3 at worst).
    assert max(moved.values()) <= 0.05 * top, max(moved.values()) / top
    for n, w in want.items():
        torch.testing.assert_close(grads[n], w, rtol=1e-4, atol=max(5e-5 * top, 2 * moved[n]), msg=n)

