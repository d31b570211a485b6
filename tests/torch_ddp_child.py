"""One process of the port's two-process CPU training test
(``tests/test_torch_distributed.py``).

    python torch_ddp_child.py <process_id> <host:port> <outdir> <case>

Joins a two-process gloo group through ``parallel/distributed.py``, loads
its shard of a small synthetic dataset (3 views, 32x64, one sample per
process and step), wraps the seeded model with ``parallel/sharding.py::
replicate`` and trains two steps of ``train/step.py``: with plain SGD for
``case`` "sgd" (its update is linear in the gradient, so the run can be
held to one process's batch-2 run; Adam's first steps move each element by
about lr * sign(g), which float32 rounding flips where a gradient is near
zero) and for ``case`` "remat" (the same run with ``ModelConfig.remat``:
the backward recomputes BatchNorm's all-reduces), with the CLI's Adam for
``case`` "nan", where process 1's first
sample carries a NaN pixel and the group is joined from torchrun's
environment variables instead of arguments. Writes ``<outdir>/out_<process_id>.pt``: the
shard's indices, the state before, after the first step and at the end,
the step scalars, and the counts of BatchNorm calls and of their
all-reduces (``parallel/collectives.py``'s "batchnorm" site). Imports no JAX.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

NDEPTHS = (8, 8, 8)
DATA = dict(nviews=3, ndepths=48, num_samples=4, height=32, width=64)


def main():
    pid, coordinator, outdir, case = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    from transmvsnet_tpu_torch.config import ModelConfig
    from transmvsnet_tpu_torch.data.loader import ShardedLoader
    from transmvsnet_tpu_torch.data.synthetic import SyntheticDataset
    from transmvsnet_tpu_torch.models.blocks import BatchNorm
    from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
    from transmvsnet_tpu_torch.parallel import collectives, distributed
    from transmvsnet_tpu_torch.parallel.sharding import replicate, unwrap
    from transmvsnet_tpu_torch.train.loop import to_device_batch
    from transmvsnet_tpu_torch.train.schedule import make_optimizer, warmup_multistep
    from transmvsnet_tpu_torch.train.step import TrainState, make_train_step

    if case == "nan":  # torchrun's environment, which the parent sets
        distributed.initialize(device="cpu")
    else:
        distributed.initialize(coordinator, 2, pid, device="cpu")
    distributed.initialize(coordinator, 2, pid, device="cpu")  # a second call is harmless
    assert distributed.world_size() == 2 and distributed.rank() == pid

    loader = ShardedLoader(SyntheticDataset(**DATA), batch_size=1, num_shards=2, shard_id=pid, num_workers=0)
    model = TransMVSNet(ModelConfig(ndepths=NDEPTHS, remat=case == "remat"), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    if case in ("sgd", "remat"):
        optimizer = torch.optim.SGD(model.parameters(), lr=SGD_LR)
        scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: 1.0)
    else:
        optimizer, scheduler = make_optimizer(model.parameters(), warmup_multistep(1e-3, [100], 0.5))
    state = TrainState(replicate(model), optimizer, scheduler)
    before = {k: v.clone() for k, v in model.state_dict().items()}

    counts = {"bn_calls": 0, "feature_bn_calls": 0, "all_reduces": 0}
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            key = "feature_bn_calls" if name.startswith("feature.") else None

            def hook(mod, args, out, key=key):
                counts["bn_calls"] += 1
                if key:
                    counts[key] += 1

            m.register_forward_hook(hook)
    collectives.reset()
    step = make_train_step()
    scalars, after_first = [], None
    for i, raw in enumerate(loader):
        batch = to_device_batch(raw, torch.device("cpu"))
        if case == "nan" and pid == 1 and i == 0:
            batch["imgs"][0, 0, 0, 0, 0] = float("nan")
        state, s = step(state, batch)
        scalars.append({k: v.item() for k, v in s.items() if not k.startswith("_")})
        if i == 0:
            after_first = {k: v.clone() for k, v in model.state_dict().items()}
    counts["all_reduces"] = collectives.read()["sites"]["batchnorm"]["all_reduce"]["calls"]
    torch.save({
        "indices": loader._shard_indices().tolist(),
        "before": before,
        "after": unwrap(state.model).state_dict(),
        "after_first": after_first,
        "scalars": scalars,
        "counts": counts,
        "n_batchnorms": sum(isinstance(m, BatchNorm) for m in model.modules()),
        "n_feature_batchnorms": sum(isinstance(m, BatchNorm) for m in model.feature.modules()),
        "step": state.step,
    }, os.path.join(outdir, f"out_{pid}.pt"))
    distributed.shutdown()


SGD_LR = 1e-3

if __name__ == "__main__":
    main()
