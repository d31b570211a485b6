"""Weight bridge between the JAX package and the PyTorch port.

JAX init -> ``state_dict_from_jax`` -> the port's strict ``load_state_dict``
-> back through the JAX package's own ``convert_state_dict``: the round
trip must return every leaf bit-identical (pure layout moves, no
arithmetic).
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


@pytest.fixture(scope="module")
def jax_variables():
    # The parameter tree does not depend on the input size: init small.
    imgs, projs, dv = dtu_like_inputs(V=2, H=32, W=32)
    model = JaxTransMVSNet(JaxModelConfig())
    init = jax.jit(lambda k: model.init(
        k, jnp.asarray(imgs), {k2: jnp.asarray(v) for k2, v in projs.items()},
        jnp.asarray(dv), train=False,
    ))
    variables = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))
    # Non-trivial BN statistics and offset convs, so no leaf is all 0 or 1.
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.1, 0.2, a.shape)).astype(a.dtype), variables
    )


@pytest.fixture(scope="module")
def port_model(jax_variables):
    model = TransMVSNet(ModelConfig(), device="cpu")
    model.load_state_dict(state_dict_from_jax(jax_variables), strict=True)
    return model


def test_round_trip_is_bit_identical(jax_variables, port_model):
    sd = {k: v.numpy() for k, v in port_model.state_dict().items()}
    back = convert_state_dict(sd, jax_variables, strict=True)
    orig = jax.tree_util.tree_leaves_with_path(jax_variables)
    new = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(orig) == len(new)
    for path, leaf in orig:
        np.testing.assert_array_equal(new[path], leaf, err_msg=jax.tree_util.keystr(path))


def test_parameter_counts_match(jax_variables, port_model):
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(jax_variables["params"]))
    n_port = sum(p.numel() for p in port_model.parameters())
    assert n_jax == n_port


def test_layouts(jax_variables, port_model):
    """Spot checks of each layout rule against the JAX tree."""
    sd = port_model.state_dict()
    p, bs = jax_variables["params"], jax_variables["batch_stats"]
    dcn = p["feature"]["out1"]["dcn0"]
    # DCN weight: tap-major [K, I, O] <-> torch [O, I, kh, kw].
    np.testing.assert_array_equal(
        sd["feature.out1.1.weight"].numpy()[:, :, 1, 2].T, dcn["weight"][1 * 3 + 2]
    )
    # Transposed conv: JAX stores the spatially flipped kernel.
    k = p["cost_regs_0"]["conv7"]["conv"]["kernel"]  # [kd, kh, kw, I, O]
    np.testing.assert_array_equal(
        sd["cost_regularization.0.conv7.conv.weight"].numpy()[:, :, 0, 0, 0], k[2, 2, 2]
    )
    np.testing.assert_array_equal(
        sd["FMT_with_pathway.FMT.layers.3.attention.query_projection.weight"].numpy(),
        p["fmt"]["FMT"]["layer3"]["attention"]["query"]["kernel"].T,
    )
    np.testing.assert_array_equal(
        sd["DepthNet.pixel_wise_net.conv0.bn.running_var"].numpy(),
        bs["pixel_wise_net"]["conv0"]["bn"]["var"],
    )


def test_bridge_is_strict(jax_variables):
    import copy

    extra = copy.deepcopy(jax_variables)
    extra["params"]["feature"]["stray"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="unconsumed"):
        state_dict_from_jax(extra)
    missing = copy.deepcopy(jax_variables)
    del missing["params"]["feature"]["inner1"]
    with pytest.raises(KeyError, match="inner1"):
        state_dict_from_jax(missing)


def test_reference_checkpoint_loads(port_model, tmp_path):
    """A reference-layout .ckpt (DataParallel prefixes, a position-encoding
    buffer the port computes in closed form) loads into the port."""
    from transmvsnet_tpu_torch.tools.infer import load_checkpoint

    sd = {f"module.{k}": v for k, v in port_model.state_dict().items()}
    sd["module.FMT_with_pathway.FMT.pos_encoding.pe"] = torch.zeros(1)
    path = tmp_path / "model.ckpt"
    torch.save({"epoch": 1, "model": sd}, path)
    fresh = TransMVSNet(ModelConfig(), device="cpu", generator=torch.Generator().manual_seed(9))
    load_checkpoint(fresh, str(path))
    for k, v in port_model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
