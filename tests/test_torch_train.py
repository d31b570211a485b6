"""The port's training path against the JAX package's, float32, on the CPU.

One step from shared weights on tests/test_train_step.py's setup (the
synthetic scene, 3 views, 32x64, batch 2, ndepths (16, 8, 8)): the JAX
side is its model (``use_pallas=False``: the XLA ops) with ``cascade_loss``
differentiated by ``jax.value_and_grad`` as its ``train_step`` does, and
its optax optimizer applied to those gradients; the port side is
``train/step.py``. Weights are the port's seeded init with non-trivial DCN
offset convs and BatchNorm state (``test_torch_model._perturb``), carried
into the JAX tree by the JAX package's converter and back by the port's
bridge; gradient trees map through the same bridge. One jitted JAX
function serves the module.

Also: the NaN guard, the schedule and Adam against optax and checkpoints
(round trip, resume, ``tools/infer.py::load_checkpoint``). The training
CLI's epoch on the CPU is in ``tests/test_torch_train_cli.py``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from transmvsnet_tpu.config import ModelConfig as JaxModelConfig
from transmvsnet_tpu.convert.torch_weights import convert_state_dict
from transmvsnet_tpu.data.loader import ShardedLoader as JaxShardedLoader
from transmvsnet_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from transmvsnet_tpu.models.losses import cascade_loss as jax_cascade_loss
from transmvsnet_tpu.models.transmvsnet import TransMVSNet as JaxTransMVSNet
from transmvsnet_tpu.train import schedule as jschedule
from transmvsnet_tpu_torch.config import ModelConfig
from transmvsnet_tpu_torch.convert.jax_weights import state_dict_from_jax
from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
from transmvsnet_tpu_torch.train import checkpoint, schedule
from transmvsnet_tpu_torch.train.loop import to_device_batch
from transmvsnet_tpu_torch.train.step import TrainState, make_eval_step, make_train_step

from test_torch_model import _perturb

NDEPTHS = (16, 8, 8)
LR = 1e-3


def jax_schedule():
    return jschedule.warmup_multistep(LR, [1000], 0.5, warmup_iters=10)


def port_state(model):
    sched = schedule.warmup_multistep(LR, [1000], 0.5, warmup_iters=10)
    return TrainState(model, *schedule.make_optimizer(model.parameters(), sched))


def new_port_model():
    return TransMVSNet(ModelConfig(ndepths=NDEPTHS), device="cpu", generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def setup():
    ds = JaxSyntheticDataset(nviews=3, ndepths=48, num_samples=2, height=32, width=64)
    batch = next(iter(JaxShardedLoader(ds, batch_size=2, num_workers=0)))
    jbatch = jax.tree_util.tree_map(jnp.asarray, {k: batch[k] for k in
                                                  ("imgs", "proj_matrices", "depth_values", "depth", "mask")})
    jmodel = JaxTransMVSNet(JaxModelConfig(ndepths=NDEPTHS))
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, jbatch["imgs"], jbatch["proj_matrices"], jbatch["depth_values"]),
        jax.random.PRNGKey(0),
    )
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    tmodel = new_port_model()
    sd = _perturb(tmodel.state_dict(), np.random.RandomState(0))
    # Offset convs a tenth of _perturb's: offsets of about a pixel. At its
    # scale (offsets of tens of pixels) each train-mode DCN + BN pair
    # amplifies float32 rounding ~10x, so three in a row reach 1e-2.
    sd = {k: v * 0.1 if ".conv_offset_mask.weight" in k else v for k, v in sd.items()}
    variables = convert_state_dict(sd, template, strict=True)
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)

    def loss_fn(params, batch_stats, b):
        outputs, updates = jmodel.apply({"params": params, "batch_stats": batch_stats}, b["imgs"],
                                        b["proj_matrices"], b["depth_values"], train=True,
                                        mutable=["batch_stats"])
        loss, depth_loss, entropy, wta, per_stage = jax_cascade_loss(outputs, b["depth"], b["mask"])
        return loss, (updates["batch_stats"], per_stage)

    (loss, (new_bs, per_stage)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], jbatch
    )
    optimizer = jschedule.make_optimizer(jax_schedule())
    updates, _ = optimizer.update(grads, optimizer.init(variables["params"]), variables["params"])
    new_params = optax.apply_updates(variables["params"], updates)
    jax_out = {
        "loss": float(loss),
        "per_stage": {k: float(v) for k, v in per_stage.items()},
        "grads": state_dict_from_jax({"params": grads, "batch_stats": variables["batch_stats"]}),
        "after": state_dict_from_jax({"params": new_params, "batch_stats": new_bs}),
    }

    tbatch = to_device_batch(batch, torch.device("cpu"))
    before = copy.deepcopy(tmodel.state_dict())
    state, scalars = make_train_step()(port_state(tmodel), tbatch)
    return jax_out, state, scalars, before, tbatch


def test_loss_and_entropies_match_jax(setup):
    jax_out, _, scalars, _, _ = setup
    assert scalars["skipped_nan"].item() == 0.0
    # Float32 forward on both sides; the loss is a sum of three O(1)
    # cross-entropies.
    np.testing.assert_allclose(scalars["loss"].item(), jax_out["loss"], rtol=1e-5)
    for k, v in jax_out["per_stage"].items():
        np.testing.assert_allclose(scalars[k].item(), v, rtol=1e-5, atol=1e-6, err_msg=k)


def test_train_step_gradients_match_jax(setup):
    """The train step's gradients (BatchNorm on batch statistics). Its
    backward through the batch mean and variance, E[x^2] - E[x]^2 in float32
    on both sides, cancels where a channel's mean dwarfs its spread, so the
    two frameworks' rounding differs more than in eval mode: all gradients
    together within a cosine of 1 - 1e-4, and each tensor within 5e-2 of its
    norm plus 1e-4 of the largest tensor norm (the DCN biases that feed a
    train-mode BatchNorm have a true gradient of zero: rounding only).
    Measured: 1 - cosine 4e-5, per tensor median 1.3e-3, largest 2e-2."""
    jax_out, state, _, _, _ = setup
    got = {k: p.grad for k, p in state.model.named_parameters()}
    want = {k: jax_out["grads"][k] for k in got}
    assert all(g is not None for g in got.values())
    dot = sum((got[k] * want[k]).sum() for k in got)
    cos = (dot / (sum(g.square().sum() for g in got.values()).sqrt()
                  * sum(w.square().sum() for w in want.values()).sqrt())).item()
    top = max(w.norm() for w in want.values())
    errs = {k: ((got[k] - want[k]).norm() / (want[k].norm() + 1e-4 * top)).item() for k in got}
    assert cos >= 1 - 1e-4, cos
    bad = {k: v for k, v in errs.items() if v > 5e-2}
    assert not bad, bad


def test_parameters_after_one_adam_step_match_jax(setup):
    """Adam's first step moves each element by lr * g / (|g| + eps) with g
    the decayed gradient: about lr * sign(g) once |g| >> eps (1e-8). The
    two sides' g agree in sign at 99% of the elements or more; where they
    do and |g| > 1e-6 on both, the parameters agree to 1e-2 of the learning
    rate. Elsewhere (gradients near zero, whose sign the train step's
    float32 differences decide) they differ by at most 2 lr."""
    jax_out, state, _, before, _ = setup
    n_agree = n_all = 0
    for name, p in state.model.named_parameters():
        want = jax_out["after"][name]
        decayed = 1e-4 * before[name]
        g_port, g_jax = p.grad + decayed, jax_out["grads"][name] + decayed
        agree = torch.sign(g_port) == torch.sign(g_jax)
        sure = agree & (g_port.abs().minimum(g_jax.abs()) > 1e-6)
        diff = (p.detach() - want).abs()
        assert (diff[sure] <= 1e-2 * LR).all(), name
        assert diff.max() <= 2 * LR, name
        assert not torch.equal(p.detach(), before[name]), name
        n_agree, n_all = n_agree + int(agree.sum()), n_all + agree.numel()
    assert n_agree >= 0.99 * n_all, n_agree / n_all


def test_batchnorm_running_stats_match_jax(setup):
    jax_out, state, _, before, _ = setup
    buffers = dict(state.model.named_buffers())
    stats = [k for k in buffers if k.endswith(("running_mean", "running_var"))]
    assert stats
    for name in stats:
        # One momentum-0.1 update from the batch's float32 statistics.
        np.testing.assert_allclose(buffers[name].numpy(), jax_out["after"][name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
        assert not torch.equal(buffers[name], before[name]), name


def test_eval_step_scalars(setup):
    _, state, _, _, tbatch = setup
    scalars = make_eval_step()(state, tbatch)
    for key in ("loss", "abs_depth_error", "thres2mm_error", "entropy_stage3"):
        assert np.isfinite(scalars[key].item()), key
    assert not state.model.training


def test_nan_guard_keeps_parameters_buffers_optimizer_and_schedule(setup):
    """A non-finite loss applies no update: parameters, BatchNorm buffers
    (changed inside the forward, restored) and optimizer state stay, the
    schedule does not advance; the global step does."""
    _, state, _, _, tbatch = setup
    state = copy.deepcopy(state)
    model_sd = copy.deepcopy(state.model.state_dict())
    opt_sd = copy.deepcopy(state.optimizer.state_dict())
    sched_epoch, lr, step = state.scheduler.last_epoch, state.optimizer.param_groups[0]["lr"], state.step
    poisoned = dict(tbatch)
    poisoned["imgs"] = tbatch["imgs"].clone()
    poisoned["imgs"][0, 0, 0, 0, 0] = float("nan")
    state, scalars = make_train_step()(state, poisoned)
    assert scalars["skipped_nan"].item() == 1.0
    assert not np.isfinite(scalars["loss"].item())
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, model_sd[k]), k
    opt_now = state.optimizer.state_dict()
    for i, s in opt_sd["state"].items():
        for k, v in s.items():
            assert torch.equal(opt_now["state"][i][k], v), (i, k)
    assert state.scheduler.last_epoch == sched_epoch
    assert state.optimizer.param_groups[0]["lr"] == lr
    assert state.step == step + 1


@pytest.mark.parametrize("milestones,warmup", [((1000, 2000), 500), ((4, 7), 3)])
def test_schedule_matches_jax(milestones, warmup):
    ours = schedule.warmup_multistep(2e-3, milestones, 0.5, warmup_iters=warmup)
    theirs = jschedule.warmup_multistep(2e-3, milestones, 0.5, warmup_iters=warmup)
    for step in (0, 1, 2, 3, 4, 5, 6, 7, 8, 250, 499, 500, 501, 999, 1000, 1999, 2000, 5000):
        np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-6, err_msg=str(step))


def test_adam_with_l2_matches_optax_chain():
    """torch Adam(weight_decay) under the LambdaLR equals the JAX package's
    add_decayed_weights -> scale_by_adam -> scale_by_learning_rate over
    several steps of the schedule."""
    rng = np.random.RandomState(0)
    p0 = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()} for _ in range(6)]
    sched_args = (1e-2, [3, 5], 0.5)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt, sched = schedule.make_optimizer(params.values(), schedule.warmup_multistep(*sched_args, warmup_iters=2))
    jopt = jschedule.make_optimizer(jschedule.warmup_multistep(*sched_args, warmup_iters=2))
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    jstate = jopt.init(jp)
    for g in grads:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        sched.step()
        upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6)


def test_checkpoint_round_trip_resume_and_infer_load(setup, tmp_path):
    from transmvsnet_tpu_torch.tools.infer import load_checkpoint

    _, state, _, _, _ = setup
    logdir = str(tmp_path)
    checkpoint.save_checkpoint(logdir, 0, state)
    path = checkpoint.save_checkpoint(logdir, 2, state)
    assert path.endswith("model_000002.ckpt")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    assert {"epoch", "model", "optimizer"} <= set(ckpt) and ckpt["epoch"] == 2
    assert checkpoint.latest_checkpoint(logdir) == path

    fresh = port_state(new_port_model())
    assert checkpoint.restore_latest(logdir, fresh) == 2
    assert fresh.step == state.step
    assert fresh.scheduler.last_epoch == state.scheduler.last_epoch
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    saved, loaded = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    for i, s in saved["state"].items():
        for k, v in s.items():
            assert torch.equal(loaded["state"][i][k], v), (i, k)
    assert checkpoint.restore_latest(str(tmp_path / "empty"), fresh) is None

    weights_only = new_port_model()
    load_checkpoint(weights_only, path)
    for k, v in state.model.state_dict().items():
        assert torch.equal(weights_only.state_dict()[k], v), k
