"""The port's float32 cascade against the JAX package's ``use_pallas=True``
cascade, on the CPU. The JAX side runs its row-sweep TPU kernels (rows 5
and 6: ``dcn_rowsweep.py::deform_conv2d_rowsweep``, ``warp_rowsweep.py::
warp_correlate_rowsweep``) in interpret mode, as the JAX package's own
tests run them; the port runs K5 and K6, which on the CPU take their plain
versions. In a file of its own, apart from ``tests/test_torch_f32.py``, so
that the test runner can give its slow module fixture a worker of its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmvsnet_tpu.config import ModelConfig as JaxModelConfig
from transmvsnet_tpu.convert.torch_weights import convert_state_dict
from transmvsnet_tpu.models.transmvsnet import TransMVSNet as JaxTransMVSNet
from transmvsnet_tpu_torch.config import ModelConfig
from transmvsnet_tpu_torch.convert.jax_weights import state_dict_from_jax
from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet

from test_parity import dtu_like_inputs
from test_torch_model import _perturb


# tests/test_torch_model.py's cascade with fewer hypotheses: the JAX
# interpret-mode kernels make this the slow part of the float32 tests.
NDEPTHS = (8, 8, 8)
H = W = 64
V = 3


@pytest.fixture(scope="module")
def cascade():
    """Both cascades at float32 with the same weights, eval mode. The port's
    seeded init after ``_perturb``, with the DCN offset convs given zero
    weights and non-integer biases of about a pixel: offsets constant
    across every row, inside the TPU kernels' row windows. The JAX side is
    ``use_pallas=True`` in interpret mode: rows 5 and 6."""
    imgs, projs, dv = dtu_like_inputs(V=V, H=H, W=W)
    jprojs = {k: jnp.asarray(v) for k, v in projs.items()}
    tmodel = TransMVSNet(ModelConfig(ndepths=NDEPTHS), device="cpu",
                         generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    sd = _perturb(tmodel.state_dict(), rng)
    for k, v in sd.items():
        if ".conv_offset_mask.weight" in k:
            sd[k] = np.zeros_like(v)
        elif ".conv_offset_mask.bias" in k:
            frac = rng.uniform(0.15, 0.85, v.shape) * rng.choice([-1.0, 1.0], v.shape)
            sd[k] = (frac + rng.randint(-1, 2, v.shape)).astype(v.dtype)
    # The variable tree does not depend on use_pallas; the XLA model traces
    # faster.
    shapes = jax.eval_shape(
        lambda k: JaxTransMVSNet(JaxModelConfig(ndepths=NDEPTHS)).init(
            k, jnp.asarray(imgs), jprojs, jnp.asarray(dv)),
        jax.random.PRNGKey(0),
    )
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    variables = convert_state_dict(sd, template, strict=True)
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    tmodel.eval()
    jmodel = JaxTransMVSNet(JaxModelConfig(ndepths=NDEPTHS, use_pallas=True, pallas_interpret=True))
    # Applied eagerly: each kernel shape compiles once, in less memory than
    # one jit of the whole cascade.
    jout = jmodel.apply(variables, jnp.asarray(imgs), jprojs, jnp.asarray(dv), train=False)
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(imgs), {k: torch.from_numpy(v) for k, v in projs.items()},
                      torch.from_numpy(dv))
    return jout, tout, dv


@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage3"])
def test_cascade_prob_volume_matches_jax_pallas_f32(cascade, stage):
    jout, tout, _ = cascade
    want = np.asarray(jout[stage]["prob_volume"])
    got = tout[stage]["prob_volume"].numpy()
    assert got.shape == want.shape
    # The row-sweep contract (test_warp_plain_f32_matches_rowsweep_interpret):
    # >= 99.5% of probabilities within 1e-4, median error below 1e-5.
    close = np.isclose(got, want, rtol=1e-4, atol=1e-4)
    assert close.mean() > 0.995, close.mean()
    assert np.median(np.abs(got - want)) < 1e-5


@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage3"])
def test_cascade_depth_and_confidence_match_jax_pallas_f32(cascade, stage):
    jout, tout, dv = cascade
    want, got = np.asarray(jout[stage]["depth"]), tout[stage]["depth"].numpy()
    # WTA depth is exact where the argmax agrees, up to float32 rounding of
    # the refined hypotheses (~600: ulp 6e-5); a tap the TPU kernel drops
    # may flip the argmax at a few pixels: >= 99.5% agree.
    assert np.mean(np.abs(got - want) < 1e-3) >= 0.995
    assert np.isfinite(got).all() and (got >= dv.min() - 50).all()
    want = np.asarray(jout[stage]["photo_confidence"])
    close = np.isclose(tout[stage]["photo_confidence"].numpy(), want, rtol=1e-4, atol=1e-4)
    assert close.mean() >= 0.995, close.mean()
