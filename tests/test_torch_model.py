"""The port's modules and whole cascade against the JAX package, float32,
eval mode, on the CPU (where the port takes each kernel's plain version
and the JAX package its XLA ops, ``use_pallas=False``).

Both sides hold the same weights, ``ModelConfig(ndepths=(16, 8, 8))``:
the port's seeded init with non-zero DCN offset convs (the reference
initialises them to zero, which would test only integer taps) and
non-trivial BatchNorm parameters and statistics, carried into the JAX
tree by the JAX package's converter and back by the port's bridge. The
cascade runs at 64x64 with 3 views; module inputs are made with numpy
from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmvsnet_tpu.config import ModelConfig as JaxModelConfig
from transmvsnet_tpu.convert.torch_weights import convert_state_dict
from transmvsnet_tpu.models.cost_reg import CostRegNet as JaxCostRegNet
from transmvsnet_tpu.models.cost_reg import PixelwiseNet as JaxPixelwiseNet
from transmvsnet_tpu.models.feature_net import FeatureNet as JaxFeatureNet
from transmvsnet_tpu.models.fmt import FMTWithPathway as JaxFMTWithPathway
from transmvsnet_tpu.models.transmvsnet import TransMVSNet as JaxTransMVSNet
from transmvsnet_tpu_torch.config import ModelConfig
from transmvsnet_tpu_torch.convert.jax_weights import state_dict_from_jax
from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet, depth_wta

from test_parity import dtu_like_inputs

NDEPTHS = (16, 8, 8)
H = W = 64
V = 3


def _perturb(state_dict, rng):
    """Offset convs that move taps by about a pixel (up to a few) at this
    model's activations; BatchNorm scale, bias, mean and variance away
    from 1/0/0/1. Takes and returns the reference-keyed numpy state dict."""
    sd = {k: v.numpy().copy() for k, v in state_dict.items()}
    bn = {k.removesuffix("running_mean") for k in sd if k.endswith("running_mean")}
    for k, v in sd.items():
        if ".conv_offset_mask." in k:
            sd[k] = (rng.randn(*v.shape) * 0.5).astype(v.dtype)
        elif k.endswith("running_mean"):
            sd[k] = rng.uniform(-0.2, 0.2, v.shape).astype(v.dtype)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.8, 1.2, v.shape).astype(v.dtype)
        elif k.rsplit(".", 1)[0] + "." in bn and not k.endswith("num_batches_tracked"):
            sd[k] = v + rng.uniform(-0.1, 0.1, v.shape).astype(v.dtype)
    return sd


@pytest.fixture(scope="module")
def models():
    """The JAX model's variables filled from the port's seeded init (after
    ``_perturb``) by the JAX package's converter, then loaded back into the
    port through the weight bridge: both sides hold the same weights."""
    imgs, projs, dv = dtu_like_inputs(V=V, H=H, W=W)
    jmodel = JaxTransMVSNet(JaxModelConfig(ndepths=NDEPTHS))
    jprojs = {k: jnp.asarray(v) for k, v in projs.items()}
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, jnp.asarray(imgs), jprojs, jnp.asarray(dv)), jax.random.PRNGKey(0)
    )
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    tmodel = TransMVSNet(ModelConfig(ndepths=NDEPTHS), device="cpu",
                         generator=torch.Generator().manual_seed(0))
    sd = _perturb(tmodel.state_dict(), np.random.RandomState(0))
    variables = convert_state_dict(sd, template, strict=True)
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    tmodel.eval()
    return jmodel, variables, tmodel, (imgs, projs, dv)


def _sub(variables, name):
    out = {"params": variables["params"][name]}
    if name in variables.get("batch_stats", {}):
        out["batch_stats"] = variables["batch_stats"][name]
    return out


def _cl(t):
    """NCHW / NCDHW torch -> channel-last numpy."""
    return np.moveaxis(t.detach().numpy(), 1, -1)


def test_feature_net(models):
    _, variables, tmodel, (imgs, _, _) = models
    x = imgs.reshape(V, H, W, 3)
    want = jax.jit(lambda v, a: JaxFeatureNet(8).apply(v, a, False))(
        _sub(variables, "feature"), jnp.asarray(x)
    )
    with torch.no_grad():
        got = tmodel.feature(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    for s in ("stage1", "stage2", "stage3"):
        w = np.asarray(want[s])
        # Three DCN heads of float32 convs and BN: summation order only.
        np.testing.assert_allclose(_cl(got[s]), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=s)


def test_fmt_with_pathway(models):
    _, variables, tmodel, _ = models
    rng = np.random.RandomState(1)
    feats = {
        "stage1": rng.randn(1, V, 16, 16, 32),
        "stage2": rng.randn(1, V, 32, 32, 16),
        "stage3": rng.randn(1, V, 64, 64, 8),
    }
    feats = {k: v.astype(np.float32) for k, v in feats.items()}
    want = jax.jit(JaxFMTWithPathway().apply)(
        _sub(variables, "fmt"), {k: jnp.asarray(v) for k, v in feats.items()}
    )
    with torch.no_grad():
        got = tmodel.FMT_with_pathway(
            {k: torch.from_numpy(np.ascontiguousarray(np.moveaxis(v, -1, 2))) for k, v in feats.items()}
        )
    for s in feats:
        w = np.asarray(want[s])
        # Eight LayerNorm'd attention layers, float32: outputs are O(1).
        np.testing.assert_allclose(np.moveaxis(got[s].numpy(), 2, -1), w, rtol=1e-4, atol=1e-4, err_msg=s)


def test_cost_reg_net(models):
    _, variables, tmodel, _ = models
    x = np.random.RandomState(2).randn(1, 16, 16, 24, 1).astype(np.float32)  # [B, D, H, W, 1]
    want = np.asarray(JaxCostRegNet(8).apply(_sub(variables, "cost_regs_1"), jnp.asarray(x), False))
    with torch.no_grad():
        got = tmodel.cost_regularization[1](torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))))
    # Seven 3x3x3 convs and three transposed convs in float32.
    np.testing.assert_allclose(_cl(got), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_pixelwise_net(models):
    _, variables, tmodel, _ = models
    x = np.random.RandomState(3).randn(2, 8, 10, 12, 1).astype(np.float32)
    want = np.asarray(JaxPixelwiseNet().apply(_sub(variables, "pixel_wise_net"), jnp.asarray(x), False))
    with torch.no_grad():
        got = tmodel.DepthNet.pixel_wise_net(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))))
    assert got.shape == (2, 10, 12)
    # Sigmoid outputs in (0, 1) after three 1x1x1 convs.
    np.testing.assert_allclose(got.numpy(), want[..., 0], rtol=1e-5, atol=1e-6)


def test_depth_wta_takes_first_maximum():
    prob = torch.tensor([[0.2, 0.4, 0.4, 0.0]]).reshape(1, 4, 1, 1)
    depth = torch.tensor([10.0, 20.0, 30.0, 40.0]).reshape(1, 4, 1, 1)
    assert depth_wta(prob, depth).item() == 20.0


@pytest.fixture(scope="module")
def cascade(models):
    jmodel, variables, tmodel, (imgs, projs, dv) = models
    jout = jax.jit(lambda v, i, p, d: jmodel.apply(v, i, p, d, train=False))(
        variables, jnp.asarray(imgs), {k: jnp.asarray(v) for k, v in projs.items()}, jnp.asarray(dv)
    )
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(imgs), {k: torch.from_numpy(v) for k, v in projs.items()},
                      torch.from_numpy(dv))
    return jout, tout, dv


@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage3"])
def test_cascade_prob_volume(cascade, stage):
    jout, tout, _ = cascade
    want = np.asarray(jout[stage]["prob_volume"])
    got = tout[stage]["prob_volume"].numpy()
    assert got.shape == want.shape == (1, NDEPTHS[int(stage[-1]) - 1], *(
        (H // 4, W // 4), (H // 2, W // 2), (H, W))[int(stage[-1]) - 1])
    # Probabilities of ~0.1, float32 end to end on both sides (they agree
    # to ~1e-7 here). A WTA tie broken the other way at an earlier stage
    # would move this stage's hypotheses at that pixel, so up to 0.1% of
    # pixels may differ.
    close = np.isclose(got, want, rtol=1e-4, atol=1e-6).all(axis=1)
    assert close.mean() >= 0.999, close.mean()


@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage3"])
def test_cascade_depth(cascade, stage):
    jout, tout, dv = cascade
    want = np.asarray(jout[stage]["depth"])
    got = tout[stage]["depth"].numpy()
    # WTA depth is exact where the argmax agrees, up to float32 rounding
    # of the refined hypotheses (~600: ulp 6e-5); agreement share >= 99.9%.
    assert np.mean(np.abs(got - want) < 1e-3) >= 0.999
    assert np.isfinite(got).all() and (got >= dv.min() - 50).all()


def test_cascade_photo_confidence(cascade):
    jout, tout, _ = cascade
    for s in ("stage1", "stage2", "stage3"):
        want = np.asarray(jout[s]["photo_confidence"])
        got = tout[s]["photo_confidence"].numpy()
        close = np.isclose(got, want, rtol=1e-4, atol=1e-6)
        assert close.mean() >= 0.999, (s, close.mean())
    np.testing.assert_array_equal(tout["depth"].numpy(), tout["stage3"]["depth"].numpy())
