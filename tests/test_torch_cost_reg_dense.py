"""The port's depth-as-channels ``CostRegNetDense`` against the JAX
package's, and against the port's 3-D ``CostRegNet``, float32 on the CPU.

The JAX module's variables (non-trivial BatchNorm parameters and running
statistics) go into the port through ``convert/jax_weights.py``'s rules;
inputs are made with numpy from a seed, at every stage-shaped (D, H, W) of
``tests/test_cost_reg_dense.py``. The two port forms hold the same
submodules, so they share state dict keys, seeded initialisation and
weights, and their weight gradients agree. The cascade with
``dense_cost_reg=True`` is held against the JAX cascade's default
configuration (which runs the JAX ``CostRegNetDense``) as
``tests/test_torch_model.py`` holds the cascade.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmvsnet_tpu.config import ModelConfig as JaxModelConfig
from transmvsnet_tpu.convert.torch_weights import convert_state_dict
from transmvsnet_tpu.models.cost_reg import CostRegNetDense as JaxCostRegNetDense
from transmvsnet_tpu.models.transmvsnet import TransMVSNet as JaxTransMVSNet
from transmvsnet_tpu_torch.config import ModelConfig
from transmvsnet_tpu_torch.convert.jax_weights import _flatten, build_rules
from transmvsnet_tpu_torch.models.blocks import init_parameters
from transmvsnet_tpu_torch.models.cost_reg import CostRegNet, CostRegNetDense
from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet

from test_parity import dtu_like_inputs
from test_torch_model import _perturb

SHAPES = [(48, 32, 40), (32, 16, 24), (8, 32, 40), (16, 16, 16)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs six workers at once; torch's intra-op threads would
    wait on one another at every op (``tests/test_torch_tnt.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_module(D, H, W, seed):
    """Variables of JAX ``CostRegNetDense(8)`` made with numpy from
    ``seed`` (kernels U(+-1/sqrt(fan_in)); every 1-D leaf moved off its
    initial value, as ``tests/test_cost_reg_dense.py`` does), and an input
    [2, D, H, W, 1]."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, D, H, W, 1).astype(np.float32)
    shapes = jax.eval_shape(lambda k: JaxCostRegNetDense(8).init(k, jnp.asarray(x), False), jax.random.PRNGKey(0))

    def fill(path, a):
        if a.ndim > 1:
            bound = 1.0 / np.sqrt(np.prod(a.shape[:-1]))
            return rng.uniform(-bound, bound, a.shape).astype(np.float32)
        start = 1.0 if path[-1].key in ("scale", "var") else 0.0
        return (start + 0.05 * np.arange(a.size)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes), x


def _port_module(variables) -> CostRegNetDense:
    """The port's ``CostRegNetDense`` holding ``variables``, carried by the
    weight bridge's rules for ``cost_regularization.0``."""
    flat = _flatten({col: {"cost_regs_0": variables[col]} for col in ("params", "batch_stats")})
    sd = {}
    for key, path, fn in build_rules(1, 0):
        if key.startswith("cost_regularization.0."):
            name = key.removeprefix("cost_regularization.0.")
            sd[name] = torch.from_numpy(np.ascontiguousarray(fn(flat[path]) if fn else flat[path]))
            if name.endswith("running_mean"):
                sd[name.removesuffix("running_mean") + "num_batches_tracked"] = torch.tensor(0)
    module = CostRegNetDense(1, 8)
    module.load_state_dict(sd, strict=True)
    return module


def _ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


@pytest.mark.parametrize("D,H,W", SHAPES)
def test_dense_matches_jax_dense_eval(D, H, W):
    variables, x = _jax_module(D, H, W, seed=0)
    want = np.asarray(jax.jit(lambda v, a: JaxCostRegNetDense(8).apply(v, a, False))(variables, jnp.asarray(x)))
    module = _port_module(variables).eval()
    with torch.no_grad():
        got = module(_ncdhw(x))
    assert got.shape == (2, 1, D, H, W)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("D,H,W", SHAPES)
def test_dense_matches_jax_dense_train(D, H, W):
    """Train mode: the outputs and every running statistic the call
    updates (and ``num_batches_tracked`` advanced once)."""
    variables, x = _jax_module(D, H, W, seed=1)
    want, mutated = jax.jit(lambda v, a: JaxCostRegNetDense(8).apply(v, a, True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    module = _port_module(variables).train()
    with torch.no_grad():
        got = module(_ncdhw(x))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), np.asarray(want), rtol=1e-4, atol=1e-5)
    after = _port_module(mutated | {"params": variables["params"]}).state_dict()
    state = module.state_dict()
    for k, v in after.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
        elif k.endswith("num_batches_tracked"):
            assert state[k].item() == 1, k


@pytest.mark.parametrize("D,H,W", SHAPES)
def test_dense_weight_gradients_match_3d(D, H, W):
    """Train mode, float32 autograd: each parameter's gradient within 1e-4
    of the 3-D form's largest element, and the input's."""
    gen = torch.Generator().manual_seed(2)
    dense, conv3d = CostRegNetDense(1, 8), CostRegNet(1, 8)
    init_parameters(conv3d, gen)
    dense.load_state_dict(conv3d.state_dict())
    x = torch.randn(2, 1, D, H, W, generator=gen)
    r = torch.randn(2, 1, D, H, W, generator=gen)
    grads = []
    for m in (dense, conv3d):
        xi = x.clone().requires_grad_()
        (m.train()(xi) * r).sum().backward()
        grads.append({"input": xi.grad, **{n: p.grad for n, p in m.named_parameters()}})
    assert grads[0].keys() == grads[1].keys()
    for n, want in grads[1].items():
        scale = want.abs().max().item()
        np.testing.assert_allclose(grads[0][n].numpy(), want.numpy(), rtol=1e-4, atol=1e-4 * scale, err_msg=n)


def test_same_state_dict_and_seeded_initialisation():
    dense, conv3d = CostRegNetDense(1, 8), CostRegNet(1, 8)
    a, b = dense.state_dict(), conv3d.state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape for k in a)
    init_parameters(dense, torch.Generator().manual_seed(3))
    init_parameters(conv3d, torch.Generator().manual_seed(3))
    for k, v in conv3d.state_dict().items():
        assert torch.equal(dense.state_dict()[k], v), k
    for dense_cost_reg in (True, False):
        model = TransMVSNet(ModelConfig(ndepths=(8, 8, 8), dense_cost_reg=dense_cost_reg), device="cpu")
        assert all(type(m) is (CostRegNetDense if dense_cost_reg else CostRegNet)
                   for m in model.cost_regularization)
    sds = [TransMVSNet(ModelConfig(ndepths=(8, 8, 8), dense_cost_reg=d), device="cpu").state_dict()
           for d in (True, False)]
    assert list(sds[0]) == list(sds[1])
    assert all(torch.equal(sds[0][k], sds[1][k]) for k in sds[0])


def test_dense_input_is_a_view(monkeypatch):
    """With one input channel (the cascade's similarity) the dense layout
    is the input itself: conv0's input shares its storage."""
    seen = []
    conv2d = torch.nn.functional.conv2d
    monkeypatch.setattr(torch.nn.functional, "conv2d", lambda inp, *a, **k: seen.append(inp) or conv2d(inp, *a, **k))
    x = torch.randn(1, 1, 8, 16, 16)
    with torch.no_grad():
        CostRegNetDense(1, 8).eval()(x)
    assert seen[0].data_ptr() == x.data_ptr() and seen[0].shape == (1, 8, 16, 16)


NDEPTHS = (16, 8, 8)
H = W = 64
V = 3


def test_cascade_matches_jax_default():
    """The float32 cascade with ``dense_cost_reg=True`` against the JAX
    cascade's default configuration, eval mode, 64x64, 3 views, at
    ``tests/test_torch_model.py``'s tolerances."""
    imgs, projs, dv = dtu_like_inputs(V=V, H=H, W=W)
    jcfg = JaxModelConfig(ndepths=NDEPTHS)
    assert jcfg.dense_cost_reg
    jmodel = JaxTransMVSNet(jcfg)
    jprojs = {k: jnp.asarray(v) for k, v in projs.items()}
    shapes = jax.eval_shape(lambda k: jmodel.init(k, jnp.asarray(imgs), jprojs, jnp.asarray(dv)),
                            jax.random.PRNGKey(0))
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    tmodel = TransMVSNet(ModelConfig(ndepths=NDEPTHS, dense_cost_reg=True), device="cpu",
                         generator=torch.Generator().manual_seed(0)).eval()
    sd = _perturb(tmodel.state_dict(), np.random.RandomState(0))
    variables = convert_state_dict(sd, template, strict=True)
    tmodel.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    jout = jax.jit(lambda v, i, p, d: jmodel.apply(v, i, p, d, train=False))(
        variables, jnp.asarray(imgs), jprojs, jnp.asarray(dv))
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(imgs), {k: torch.from_numpy(v) for k, v in projs.items()},
                      torch.from_numpy(dv))
    for s in ("stage1", "stage2", "stage3"):
        want, got = np.asarray(jout[s]["prob_volume"]), tout[s]["prob_volume"].numpy()
        assert got.shape == want.shape
        close = np.isclose(got, want, rtol=1e-4, atol=1e-6).all(axis=1)
        assert close.mean() >= 0.999, (s, close.mean())
        want, got = np.asarray(jout[s]["depth"]), tout[s]["depth"].numpy()
        assert np.mean(np.abs(got - want) < 1e-3) >= 0.999, s
        want, got = np.asarray(jout[s]["photo_confidence"]), tout[s]["photo_confidence"].numpy()
        assert np.isclose(got, want, rtol=1e-4, atol=1e-6).mean() >= 0.999, s

