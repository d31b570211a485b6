"""The port's mesh on the CPU: the sequence-parallel FMT, its collective
bytes, and the mesh's layout and errors.

Four gloo processes (``tests/torch_mesh_child.py``) run the port's FMT
split over the (data, view, depth) meshes (2, 1, 2) and (1, 2, 2): tokens
over ``depth``, the source views over ``view``. Every process's outputs
equal the JAX ``FMT`` unsplit on the same weights (the JAX package's
init carried over by the bridge) within ``tests/test_seq_parallel.py``'s
tolerance. The collective counter (``parallel/collectives.py``) shows what
``tests/test_sharding_lowering.py`` pins in GSPMD's lowering: inside the
encoder layers the FMT all-reduces only the partial KV and Z, 23,040
float32 bytes per process per forward at B = 1, S = 4, 8 layers,
d_model 32, 8 heads, whatever the token count, and gathers nothing but
its outputs, once at its end. In a file of its own, so that ``--dist
loadfile`` gives it a worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_child as child
from transmvsnet_tpu.config import ModelConfig as JaxModelConfig
from transmvsnet_tpu.convert.torch_weights import convert_state_dict
from transmvsnet_tpu.models.fmt import FMT as JaxFMT
from transmvsnet_tpu.models.transmvsnet import TransMVSNet as JaxTransMVSNet
from transmvsnet_tpu_torch.config import MeshConfig, ModelConfig
from transmvsnet_tpu_torch.convert.jax_weights import state_dict_from_jax
from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
from transmvsnet_tpu_torch.parallel.mesh import coordinates, make_mesh
from transmvsnet_tpu_torch.parallel.sharding import chunk_sizes

NDEPTHS = (16, 8, 8)
# KV [N, heads, d, d] and Z [N, heads, d] per attention, d = 32 / 8: N = 1
# (the reference) and 4 (the sources) in each self layer, 4 in each cross
# layer (the sources against the reference's tokens).
FMT_KV_BYTES = 4 * (4 * 4 + 4) * 8 * (4 * (1 + 4) + 4 * 4)


def bridged_weights(perturb=None):
    """The JAX cascade's variables (ndepths (16, 8, 8)) filled from the
    port's seeded init, ``perturb``-ed (a numpy state dict to numpy state
    dict), and the port's state dict carried back through the bridge."""
    B, V, H, W = 1, 3, 32, 64
    jmodel = JaxTransMVSNet(JaxModelConfig(ndepths=NDEPTHS))
    projs = {s: jnp.zeros((B, V, 2, 4, 4)) for s in ("stage1", "stage2", "stage3")}
    shapes = jax.eval_shape(lambda k: jmodel.init(k, jnp.zeros((B, V, H, W, 3)), projs, jnp.zeros((B, 48))),
                            jax.random.PRNGKey(0))
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    sd = {k: v.numpy() for k, v in TransMVSNet(ModelConfig(ndepths=NDEPTHS), device="cpu").state_dict().items()}
    variables = convert_state_dict(perturb(sd) if perturb else sd, template, strict=True)
    return jmodel, variables, state_dict_from_jax(variables)


@pytest.fixture(scope="module")
def fmt_runs(tmp_path_factory):
    """JAX's FMT unsplit at B = 1, S = 2, 8x16 tokens, and the four
    processes' outputs on the same weights and inputs."""
    _, variables, weights = bridged_weights()
    rng = np.random.RandomState(0)
    ref = rng.randn(1, 8, 16, 32).astype(np.float32)
    src = rng.randn(1, 2, 8, 16, 32).astype(np.float32)
    d = tmp_path_factory.mktemp("mesh_fmt")
    torch.save(weights, d / "weights.pt")
    torch.save((torch.from_numpy(np.moveaxis(ref, -1, 1).copy()), torch.from_numpy(np.moveaxis(src, -1, 2).copy())),
               d / "inputs.pt")

    def jax_fmt():
        out = JaxFMT().apply({"params": variables["params"]["fmt"]["FMT"]}, jnp.asarray(ref), jnp.asarray(src))
        return [np.asarray(o) for o in out]

    outs, want = child.spawn("fmt", 4, d, meanwhile=jax_fmt)
    return want, [o["fmt"] for o in outs]


@pytest.mark.parametrize("mesh", ["2x1x2", "1x2x2"])
def test_split_fmt_is_the_jax_fmt(fmt_runs, mesh):
    (want_ref, want_src), outs = fmt_runs
    for pid, out in enumerate(outs):
        got_ref, got_src = out[mesh]
        np.testing.assert_allclose(np.moveaxis(got_ref.numpy(), 1, -1), want_ref, rtol=2e-5, atol=2e-5,
                                   err_msg=f"{mesh} process {pid}")
        np.testing.assert_allclose(np.moveaxis(got_src.numpy(), 2, -1), want_src, rtol=2e-5, atol=2e-5,
                                   err_msg=f"{mesh} process {pid}")


def test_fmt_all_reduces_only_the_partial_kv(fmt_runs):
    """At (2, 1, 2): 23,040 bytes of KV/Z partials per process and forward
    at 128 and 384 tokens; the only gathers are the outputs' (the reference
    and the sources, once each), and no KV all-reduce comes near one
    image's tokens."""
    _, outs = fmt_runs
    for pid, out in enumerate(outs):
        for tokens, counts in out["counts"].items():
            sites = counts["sites"]
            assert set(sites) == {"fmt.kv", "fmt.out"}, (pid, tokens, sites)
            assert set(sites["fmt.kv"]) == {"all_reduce"} and set(sites["fmt.out"]) == {"all_gather"}
            assert sites["fmt.kv"]["all_reduce"]["bytes"] == FMT_KV_BYTES == 23_040, (pid, tokens)
            assert sites["fmt.kv"]["all_reduce"]["calls"] == 12
            assert sites["fmt.out"]["all_gather"]["calls"] == 2
            assert sites["fmt.kv"]["all_reduce"]["largest"] < tokens * 32 * 4
            assert counts["bytes"]["all_reduce"] == FMT_KV_BYTES


def test_mesh_layout_and_errors():
    """The JAX package's row-major (data, view, depth) layout; a mesh that
    needs more processes than exist raises; chunks are contiguous, the
    first ones larger."""
    assert [coordinates(r, (2, 2, 2)) for r in (0, 1, 2, 5, 7)] == [
        (0, 0, 0), (0, 0, 1), (0, 1, 0), (1, 0, 1), (1, 1, 1)]
    assert coordinates(5, (1, 3, 2)) == (0, 2, 1)
    for config in (MeshConfig(1, 2, 1), MeshConfig(0, 1, 2), MeshConfig(2, 1, 1)):
        with pytest.raises(ValueError, match="needs"):
            make_mesh(config)
    mesh = make_mesh(MeshConfig(0, 1, 1))
    assert mesh.shape == (1, 1, 1) and mesh.coords == (0, 0, 0) and mesh.group("view", "depth") is None
    assert chunk_sizes(3, 2) == [2, 1] and chunk_sizes(8, 3) == [3, 3, 2] and chunk_sizes(16, 3) == [6, 5, 5]
    with pytest.raises(ValueError, match="cannot split"):
        chunk_sizes(1, 2)
