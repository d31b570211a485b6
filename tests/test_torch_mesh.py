"""The port's cascade and training step split over a (data, view, depth)
mesh of four gloo processes on the CPU (``tests/torch_mesh_child.py``).

The forward, in eval mode at (1, 2, 2) with V = 5 and V = 4 (three
sources over two processes: unequal chunks) and at (1, 1, 3) with V = 4
(16 and 8 hypotheses over three processes: unequal slabs), equals the
JAX ``TransMVSNet`` forward unsplit on the same weights, by
``tests/test_seq_parallel.py``'s rule: probability volumes within rtol
1e-4 / atol 1e-5 outside the pixels an earlier stage's WTA tie-flip
reaches, depth where the top-2 gap is decisive. The training step (two
SGD steps, float32) at (1, 2, 2) with remat and at (2, 2, 1) ends at the
parameters and running statistics of the port's single-process step on
the same global batch, within ``tests/test_torch_distributed.py``'s
tolerances, with bitwise-equal parameters on every process. In a file of
its own, so that ``--dist loadfile`` gives it a worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import binary_dilation

import torch_mesh_child as child
from test_parity import dtu_like_inputs
from test_torch_distributed import STATE_RTOL, UPDATE_RTOL
from test_torch_mesh_fmt import bridged_weights
from test_torch_model import _perturb
from transmvsnet_tpu_torch.config import ModelConfig
from transmvsnet_tpu_torch.data.loader import ShardedLoader
from transmvsnet_tpu_torch.data.synthetic import SyntheticDataset
from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
from transmvsnet_tpu_torch.train.loop import to_device_batch
from transmvsnet_tpu_torch.train.step import TrainState, make_train_step

H, W = 32, 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX forwards of the V = 5 and V = 4 scenes, and the four
    processes' forwards and steps."""
    jmodel, variables, weights = bridged_weights(lambda sd: _perturb_arrays(sd))
    scenes = {v: dtu_like_inputs(V=v, H=H, W=W, num_hyp=48) for v in (5, 4)}
    d = tmp_path_factory.mktemp("mesh")
    torch.save(weights, d / "weights.pt")
    torch.save({v: (torch.from_numpy(imgs), {k: torch.from_numpy(x) for k, x in projs.items()}, torch.from_numpy(dv))
                for v, (imgs, projs, dv) in scenes.items()}, d / "inputs.pt")

    def jax_forwards():
        forward = jax.jit(lambda i, p, d: jmodel.apply(variables, i, p, d, train=False))
        return {v: forward(jnp.asarray(imgs), {k: jnp.asarray(x) for k, x in projs.items()}, jnp.asarray(dv))
                for v, (imgs, projs, dv) in scenes.items()}

    outs, want = child.spawn("cascade,step", 4, d, meanwhile=jax_forwards)
    return want, outs


def _perturb_arrays(sd):
    return _perturb({k: torch.from_numpy(v) for k, v in sd.items()}, np.random.RandomState(0))


def _assert_cascade_close(got, want, what):
    """``tests/test_seq_parallel.py``'s rule, the port's split forward
    against the JAX forward."""
    contaminated = None
    for stage in ("stage1", "stage2", "stage3"):
        p_want, p_got = np.asarray(want[stage]["prob_volume"]), got[stage]["prob_volume"].numpy()
        d_want, d_got = np.asarray(want[stage]["depth"]), got[stage]["depth"].numpy()
        if contaminated is None:
            clean = np.ones(d_want.shape, bool)
        else:
            up = contaminated.repeat(2, axis=1).repeat(2, axis=2)
            clean = ~np.stack([binary_dilation(m, iterations=2) for m in up])
        assert clean.mean() > 0.5, f"{what} {stage}: contamination exploded"
        mask = np.broadcast_to(clean[:, None], p_want.shape)
        np.testing.assert_allclose(p_got[mask], p_want[mask], rtol=1e-4, atol=1e-5, err_msg=f"{what} {stage}")
        top2 = np.sort(p_want, axis=1)[:, -2:]
        decided = ((top2[:, 1] - top2[:, 0]) > 1e-4) & clean
        np.testing.assert_allclose(d_got[decided], d_want[decided], rtol=1e-5, err_msg=f"{what} {stage}")
        contaminated = ~clean | (np.abs(d_got - d_want) > 1e-3 * d_want)


@pytest.mark.parametrize("case", ["1x2x2_V5", "1x2x2_V4", "1x1x3_V4"])
def test_split_cascade_is_the_jax_cascade(runs, case):
    want, outs = runs
    members = [o["cascade"] for o in outs if case in o["cascade"]]
    assert len(members) == (3 if case.startswith("1x1x3") else 4)
    for pid, out in enumerate(members):
        _assert_cascade_close(out[case], want[int(case[-1])], f"{case} process {pid}")
    counts = members[0][case + "_counts"]["sites"]
    # Views split: the similarity's view sums; hypotheses split: the FMT's
    # KV/Z, PixelwiseNet's maximum and the slabs' gathers; no BatchNorm
    # statistics in eval mode.
    sites = {"fmt.kv", "fmt.out", "pixelwise.max", "similarity.slabs"}
    if case.startswith("1x2x2"):
        sites.add("similarity.view_sum")
    assert set(counts) == sites, counts


def _single_process_step():
    model = TransMVSNet(ModelConfig(ndepths=child.NDEPTHS), device="cpu", generator=torch.Generator().manual_seed(0))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer = torch.optim.SGD(model.parameters(), lr=child.SGD_LR)
    state = TrainState(model, optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: 1.0))
    step = make_train_step()
    losses = []
    for raw in ShardedLoader(SyntheticDataset(**child.DATA), batch_size=2, num_workers=0):
        state, scalars = step(state, to_device_batch(raw, torch.device("cpu")))
        losses.append(scalars["loss"].item())
    return start, model.state_dict(), losses


def _flat(state: dict, keys) -> torch.Tensor:
    return torch.cat([state[k].double().flatten() for k in keys])


@pytest.mark.parametrize("mesh", list(child.STEP_MESHES))
def test_split_step_is_the_single_process_step(runs, mesh):
    _, outs = runs
    start, ref, losses = _single_process_step()
    got = outs[0]["step"][mesh]
    shape = child.STEP_MESHES[mesh][0]
    for pid, out in enumerate(outs):
        r = out["step"][mesh]
        assert r["coords"] == (pid // (shape[1] * shape[2]), pid // shape[2] % shape[1], pid % shape[2])
        # Each data group's shard; the processes of one group share it.
        assert r["indices"] == (([0, 2], [1, 3])[r["coords"][0]] if shape[0] == 2 else [0, 1, 2, 3])
        for k, v in r["after"].items():
            assert torch.equal(v, got["after"][k]), (mesh, pid, k)
        assert r["scalars"] == got["scalars"]
    params = [k for k in ref if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    for keys, what in ((params, "parameters"), (stats, "running statistics")):
        want, have, before = _flat(ref, keys), _flat(got["after"], keys), _flat(start, keys)
        err = (have - want).norm()
        assert err <= STATE_RTOL * want.norm(), (mesh, what, (err / want.norm()).item())
        assert err <= UPDATE_RTOL * (want - before).norm(), (mesh, what, (err / (want - before).norm()).item())
    for k in ref:
        if k.endswith("num_batches_tracked"):
            assert torch.equal(got["after"][k], ref[k]), k
    assert got["scalars"][0]["loss"] == pytest.approx(losses[0], rel=1e-6)
    # DDP's gradient all-reduce once per step, over every parameter.
    numel = sum(ref[k].numel() for k in params)
    assert got["counts"]["sites"]["ddp"]["all_reduce"]["bytes"] == 2 * 4 * numel
