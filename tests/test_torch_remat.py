"""``ModelConfig.remat`` and ``ModelConfig.batch_views_jointly`` in the
port, float32 on the CPU.

Remat changes no number: a train step with it equals the same step
without it (loss, gradients, Adam's update, BatchNorm's running
statistics, which the recompute leaves alone), and the recompute did run
(K5 twice per DCN layer, BatchNorm called again in the backward).
Under ``no_grad`` it runs as without. Per-view features (FeatureNet once
per view, train-mode BatchNorm on each view's statistics) are held against
the JAX package's ``extract_features`` with ``batch_views_jointly=False``,
features and FeatureNet's running statistics. The training CLI remats
unless ``--no_remat``, as the JAX trainer does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmvsnet_tpu.config import ModelConfig as JaxModelConfig
from transmvsnet_tpu.convert.torch_weights import _build_rules, convert_state_dict
from transmvsnet_tpu.models.transmvsnet import TransMVSNet as JaxTransMVSNet
from transmvsnet_tpu_torch.config import ModelConfig
from transmvsnet_tpu_torch.data.example import example_train_batch
from transmvsnet_tpu_torch.models.blocks import BatchNorm
from transmvsnet_tpu_torch.models.feature_net import DCN
from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
from transmvsnet_tpu_torch.ops.cuda import dcn as cuda_dcn
from transmvsnet_tpu_torch.train.loop import to_device_batch
from transmvsnet_tpu_torch.train.schedule import make_optimizer, warmup_multistep
from transmvsnet_tpu_torch.train.step import TrainState, make_train_step

from test_parity import dtu_like_inputs
from test_torch_model import _perturb

NDEPTHS = (8, 8, 8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs six workers at once; torch's intra-op threads would
    wait on one another at every op (``tests/test_torch_tnt.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(**cfg):
    return TransMVSNet(ModelConfig(ndepths=NDEPTHS, **cfg), device="cpu", generator=torch.Generator().manual_seed(0))


def _step(remat: bool) -> dict:
    """One Adam step from the seeded weights on a 3-view 32x64 batch of 2,
    with the DCN layers' and BatchNorm's completed calls and K5's wrapper
    calls (its plain version here) counted, forward and backward apart."""
    model = _model(remat=remat)
    calls = {"dcn_layer": 0, "bn": 0, "k5": 0}
    for m in model.modules():
        if isinstance(m, (DCN, BatchNorm)):
            key = "dcn_layer" if isinstance(m, DCN) else "bn"
            m.register_forward_hook(lambda mod, args, out, key=key: calls.__setitem__(key, calls[key] + 1))
    k5 = cuda_dcn.deform_conv2d

    def counted(*args, **kwargs):
        calls["k5"] += 1
        return k5(*args, **kwargs)

    batch = to_device_batch(example_train_batch(B=2, V=3, H=32, W=64, num_hyp=48), torch.device("cpu"))
    state = TrainState(model, *make_optimizer(model.parameters(), warmup_multistep(1e-3, [100], 0.5)))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    forward_calls = {}

    def mark(phase):
        if phase == "forward":
            forward_calls.update(calls)

    cuda_dcn.deform_conv2d = counted
    try:
        _, scalars = make_train_step()(state, batch, mark)
    finally:
        cuda_dcn.deform_conv2d = k5
    return {
        "loss": scalars["loss"].item(),
        "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
        "updates": {n: p.detach() - before[n] for n, p in model.named_parameters()},
        "buffers": dict(model.named_buffers()),
        "forward_calls": forward_calls,
        "calls": dict(calls),
    }


@pytest.fixture(scope="module")
def steps():
    return {remat: _step(remat) for remat in (False, True)}


def test_remat_step_equals_the_plain_step(steps):
    plain, remat = steps[False], steps[True]
    assert remat["loss"] == plain["loss"]
    for what in ("grads", "updates"):
        for n, want in plain[what].items():
            scale = want.abs().max().item()
            np.testing.assert_allclose(remat[what][n].numpy(), want.numpy(), rtol=1e-6, atol=1e-6 * scale,
                                       err_msg=f"{what} {n}")
    for n, want in plain["buffers"].items():
        if n.endswith("num_batches_tracked"):
            assert remat["buffers"][n].item() == want.item() == 1, n
        else:
            np.testing.assert_allclose(remat["buffers"][n].numpy(), want.numpy(), rtol=1e-6, atol=1e-6, err_msg=n)


def test_remat_recomputes_in_the_backward(steps):
    """Without remat nothing runs again in the backward; with it K5 runs
    again for each of the 9 DCN layers (the card's 18 launches per step)
    and BatchNorm is called again, while the running statistics moved
    once (above). The recompute ends as soon as every tensor the backward
    saved is rebuilt (``torch.utils.checkpoint``'s early stop): inside the
    last DCN layer, whose Function saves its tensors after its kernel ran,
    so that layer's call does not complete a second time."""
    plain, remat = steps[False], steps[True]
    assert plain["calls"] == plain["forward_calls"] == remat["forward_calls"]
    assert plain["calls"]["k5"] == plain["calls"]["dcn_layer"] == 9
    assert remat["calls"]["k5"] == 18 and remat["calls"]["dcn_layer"] == 9 + 8
    assert remat["calls"]["bn"] > plain["calls"]["bn"]


def test_remat_under_no_grad_is_the_plain_forward():
    imgs, projs, dv = dtu_like_inputs(V=3, H=32, W=64)
    args = (torch.from_numpy(imgs), {k: torch.from_numpy(v) for k, v in projs.items()}, torch.from_numpy(dv))
    outs = []
    for remat in (False, True):
        model = _model(remat=remat).eval()
        with torch.no_grad():
            outs.append(model(*args))
    for s in ("stage1", "stage2", "stage3"):
        for k in ("depth", "prob_volume", "photo_confidence"):
            assert torch.equal(outs[0][s][k], outs[1][s][k]), (s, k)


def test_per_view_features_match_jax():
    """Train mode, ``batch_views_jointly=False``: features after the FMT and
    FeatureNet's updated running statistics against the JAX package's
    ``extract_features`` on the same weights; the port's FeatureNet
    BatchNorms count one update per view. The offset convs keep their
    reference initialisation (zero): offsets that put taps near pixel
    edges let train-mode float32 rounding flip them (2e-3 apart with the
    views batched jointly too)."""
    V = 3
    imgs = dtu_like_inputs(V=V, H=32, W=64)[0]
    jmodel = JaxTransMVSNet(JaxModelConfig(ndepths=NDEPTHS, batch_views_jointly=False))
    shapes = jax.eval_shape(lambda k: jmodel.init(k, jnp.asarray(imgs), False, method=JaxTransMVSNet.extract_features),
                            jax.random.PRNGKey(0))
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    tmodel = _model(batch_views_jointly=False).train()
    sd = _perturb(tmodel.state_dict(), np.random.RandomState(0))
    sd = {k: v * 0 if ".conv_offset_mask." in k else v for k, v in sd.items()}
    tmodel.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    # The template holds FeatureNet's and the FMT's leaves only.
    variables = convert_state_dict(sd, template, strict=False)
    want, mutated = jmodel.apply(variables, jnp.asarray(imgs), True, method=JaxTransMVSNet.extract_features,
                                 mutable=["batch_stats"])
    with torch.no_grad():
        got = tmodel.extract_features(torch.from_numpy(imgs))
    for s in ("stage1", "stage2", "stage3"):
        w = np.asarray(want[s])
        np.testing.assert_allclose(np.moveaxis(got[s].numpy(), 2, -1), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=s)
    state = tmodel.state_dict()
    feature_stats = [k for k in state if k.startswith("feature.") and k.endswith(("running_mean", "running_var"))]
    assert len(feature_stats) == 2 * sum(isinstance(m, BatchNorm) for m in tmodel.feature.modules())
    jax_path = {key: path for key, path, _ in _build_rules(len(NDEPTHS), len(ModelConfig().fmt_layers))}
    for k in feature_stats:
        want_stat = mutated
        for name in jax_path[k]:
            want_stat = want_stat[name]
        np.testing.assert_allclose(state[k].numpy(), np.asarray(want_stat), rtol=1e-4, atol=1e-5, err_msg=k)
        assert state[k.rsplit(".", 1)[0] + ".num_batches_tracked"].item() == V, k


def test_train_cli_remats_unless_no_remat(monkeypatch, tmp_path):
    """``--no_remat`` reaches ModelConfig, and ``--mode profile`` passes the
    setting on to the profiler."""
    from transmvsnet_tpu_torch.tools import profile, train

    cfg = train.model_config(train.parse_args(["--no_remat", "--dtype", "bfloat16", "--ndepths", "16,8,8"]))
    assert not cfg.remat and cfg.compute_dtype == "bfloat16" and tuple(cfg.ndepths) == (16, 8, 8)
    calls = []
    monkeypatch.setattr(profile, "main", lambda argv: calls.append(profile.parse_args(argv)))
    for flags in ([], ["--no_remat"]):
        train.main(["--mode", "profile", "--logdir", str(tmp_path), *flags])
    assert [a.remat for a in calls] == [True, False]
