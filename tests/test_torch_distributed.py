"""The port's data-parallel training across processes, on the CPU.

Two gloo processes (``tests/torch_ddp_child.py``, spawned as
``tests/test_multihost.py`` spawns its children) each train one sample per
step of the synthetic scene (3 views, 32x64, ndepths (8, 8, 8), float32)
from the same seeded weights: disjoint shards go in, bitwise-equal
parameters come out, and they are one process's batch-2 run on the same
two samples, whose step ``tests/test_torch_train.py`` holds against the
JAX train step (global-batch BatchNorm and gradients: the JAX package's
``data=2`` run of ``tests/multihost_child.py``). With ``remat`` the
backward's recompute issues BatchNorm's all-reduces again, in the same
order on both processes, and the run ends where the run without it does.
A NaN in one process's
sample makes both skip the step. Without a process group BatchNorm and
the step take their single-process path. In a file of its own, so that
``--dist loadfile`` gives it a worker.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

import torch_ddp_child as child
from transmvsnet_tpu_torch.config import ModelConfig
from transmvsnet_tpu_torch.data.loader import ShardedLoader
from transmvsnet_tpu_torch.data.synthetic import SyntheticDataset
from transmvsnet_tpu_torch.models.blocks import BatchNorm
from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
from transmvsnet_tpu_torch.parallel import distributed
from transmvsnet_tpu_torch.parallel.sharding import replicate, unwrap
from transmvsnet_tpu_torch.train.loop import to_device_batch
from transmvsnet_tpu_torch.train.step import TrainState, make_train_step

# Two processes at local batch 1 against one at batch 2, both float32 on
# the CPU, over two SGD steps, as norms over all parameters (or all
# running statistics) together: the states within STATE_RTOL of their
# norm, the updates (end minus start) within UPDATE_RTOL of theirs. The
# two runs sum the batch statistics in another order, and train-mode
# BatchNorm's E[x^2] - E[x]^2 amplifies float32 rounding (one step's
# gradients differ by up to 3e-3 of a tensor's norm, as they do when the
# batch-2 run's images move by one float32 step). Measured: parameters
# 1.6e-6, running statistics 4.3e-7, updates 4.1e-3; with BatchNorm left
# on each process's local batch, 5.2e-4, 3.4e-3 and 1.32.
STATE_RTOL = 1e-5
UPDATE_RTOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs six workers at once; torch's intra-op threads would
    wait on one another at every op (``tests/test_torch_tnt.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_two_processes(case: str, outdir) -> list[dict]:
    """The children of ``case``; "nan" also gets torchrun's variables."""
    port = _free_port()
    coordinator = f"localhost:{port}"
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "LOCAL_RANK", "RANK", "WORLD_SIZE")}
    torchrun = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "WORLD_SIZE": "2"}
    procs = [
        subprocess.Popen([sys.executable, child.__file__, str(pid), coordinator, str(outdir), case],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         env={**env, **torchrun, "RANK": str(pid)} if case == "nan" else env)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-4000:]}"
    return [torch.load(outdir / f"out_{pid}.pt", weights_only=False) for pid in range(2)]


@pytest.fixture(scope="module")
def sgd_runs(tmp_path_factory):
    return _run_two_processes("sgd", tmp_path_factory.mktemp("ddp_sgd"))


@pytest.fixture(scope="module")
def remat_runs(tmp_path_factory):
    return _run_two_processes("remat", tmp_path_factory.mktemp("ddp_remat"))


@pytest.fixture(scope="module")
def nan_runs(tmp_path_factory):
    return _run_two_processes("nan", tmp_path_factory.mktemp("ddp_nan"))


def _flat(state: dict, keys) -> torch.Tensor:
    return torch.cat([state[k].double().flatten() for k in keys])


def test_disjoint_shards_in_and_equal_parameters_out(sgd_runs):
    r0, r1 = sgd_runs
    assert r0["indices"] == [0, 2] and r1["indices"] == [1, 3]
    assert r0["step"] == r1["step"] == 2
    assert all(s["skipped_nan"] == 0.0 for r in sgd_runs for s in r["scalars"])
    for k, v in r0["after"].items():
        assert torch.equal(v, r1["after"][k]), k
    assert not torch.equal(_flat(r0["after"], r0["before"]), _flat(r0["before"], r0["before"]))
    # The logged scalars are averaged over the processes.
    assert r0["scalars"] == r1["scalars"]


def test_two_processes_at_batch_1_are_one_process_at_batch_2(sgd_runs):
    model = TransMVSNet(ModelConfig(ndepths=child.NDEPTHS), device="cpu", generator=torch.Generator().manual_seed(0))
    got, start = sgd_runs[0]["after"], sgd_runs[0]["before"]
    for k, v in model.state_dict().items():
        assert torch.equal(start[k], v), k
    optimizer = torch.optim.SGD(model.parameters(), lr=child.SGD_LR)
    state = TrainState(model, optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: 1.0))
    step = make_train_step()
    losses = []
    for raw in ShardedLoader(SyntheticDataset(**child.DATA), batch_size=2, num_workers=0):
        state, scalars = step(state, to_device_batch(raw, torch.device("cpu")))
        losses.append(scalars["loss"].item())
    ref = model.state_dict()
    params = [k for k, _ in model.named_parameters()]
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    for keys, what in ((params, "parameters"), (stats, "running statistics")):
        want, have, before = _flat(ref, keys), _flat(got, keys), _flat(start, keys)
        err = (have - want).norm()
        assert err <= STATE_RTOL * want.norm(), (what, (err / want.norm()).item())
        assert err <= UPDATE_RTOL * (want - before).norm(), (what, (err / (want - before).norm()).item())
    for k in ref:
        if k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], ref[k]), k
    # Step 1 sees the same weights on both sides: the loss agrees to rounding.
    assert sgd_runs[0]["scalars"][0]["loss"] == pytest.approx(losses[0], rel=1e-6)


def test_batchnorm_reduces_once_per_call(sgd_runs):
    """One all-reduce per BatchNorm call; FeatureNet's BatchNorms see all
    views as one batch, so each runs once per forward, not once per view."""
    counts = sgd_runs[0]["counts"]
    assert counts["all_reduces"] == counts["bn_calls"] > 0
    assert counts["feature_bn_calls"] == 2 * sgd_runs[0]["n_feature_batchnorms"]


def test_remat_across_processes_is_the_run_without(sgd_runs, remat_runs):
    """Equal parameters on both processes, equal to the run without remat
    (running statistics and their counts included); every BatchNorm call,
    the recompute's too, reduced once, and the recompute ran BatchNorm."""
    r0, r1 = remat_runs
    assert r0["indices"] == sgd_runs[0]["indices"] and r1["indices"] == sgd_runs[1]["indices"]
    for k, v in r0["after"].items():
        assert torch.equal(v, r1["after"][k]), k
        want = sgd_runs[0]["after"][k]
        if k.endswith("num_batches_tracked"):
            assert torch.equal(v, want), k
        else:
            torch.testing.assert_close(v, want, rtol=1e-6, atol=1e-7, msg=k)
    for r, plain in zip(remat_runs, sgd_runs):
        assert r["counts"]["all_reduces"] == r["counts"]["bn_calls"] > plain["counts"]["bn_calls"]
        assert [s["loss"] for s in r["scalars"]] == [s["loss"] for s in plain["scalars"]]


def test_nan_on_one_process_skips_the_step_on_both(nan_runs):
    """The group joined from torchrun's environment; process 1's NaN makes
    both skip, nothing hangs, and the next step trains on both."""
    for pid, r in enumerate(nan_runs):
        first, second = r["scalars"]
        assert first["skipped_nan"] == 1.0 and second["skipped_nan"] == 0.0, pid
        for k, v in r["before"].items():
            assert torch.equal(r["after_first"][k], v), (pid, k)
    for k, v in nan_runs[0]["after"].items():
        assert torch.equal(v, nan_runs[1]["after"][k]), k


def test_one_process_takes_the_single_process_path(monkeypatch):
    """No process group: every query answers for one process, replicate
    leaves the model as it is, and BatchNorm normalises with the local
    batch's statistics without reaching a collective."""
    import torch.distributed.nn.functional as dist_fn

    assert not distributed.is_initialized()
    assert (distributed.rank(), distributed.world_size(), distributed.is_main()) == (0, 1, True)
    assert distributed.process_device("cpu") == torch.device("cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("a collective without a process group")

    monkeypatch.setattr(dist_fn, "all_reduce", refuse)
    monkeypatch.setattr(torch.distributed, "all_reduce", refuse)
    bn = BatchNorm(3)
    x = torch.randn(2, 3, 4, 5, generator=torch.Generator().manual_seed(0))
    y = bn(x)
    mean, var = x.mean((0, 2, 3)), x.var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(y, (x - mean.view(1, -1, 1, 1)) / torch.sqrt(var.view(1, -1, 1, 1) + 1e-5))
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * x.var((0, 2, 3)))
    model = torch.nn.Linear(2, 2)
    assert replicate(model) is model and unwrap(model) is model
