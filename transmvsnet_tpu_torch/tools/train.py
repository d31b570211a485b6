"""Training CLI: the reference train.py surface on CUDA cards, in one
process or several.

    # DTU from scratch (reference scripts/train.sh recipe: 512x640, 5 views,
    # batch 2, 48/32/8 hypotheses; float32 activations):
    python -m transmvsnet_tpu_torch.tools.train --dataset dtu \\
        --datapath /data/dtu --trainlist lists/dtu/train.txt \\
        --testlist lists/dtu/val.txt --logdir ./ckpt --epochs 16

    # BlendedMVS finetuning (reference scripts/train_bld_fintune.sh):
    python -m transmvsnet_tpu_torch.tools.train --dataset blended --loss bld \\
        --datapath /data/blendedmvs --trainlist lists/bld/training_list.txt \\
        --testlist lists/bld/validation_list.txt --lr 2e-4 --nviews 4 \\
        --batch_size 1 --loadckpt ./ckpt/model_000015.ckpt

    # One process per card, NCCL (torchrun sets the rank and the address):
    torchrun --nproc_per_node 4 -m transmvsnet_tpu_torch.tools.train \\
        --distributed --dataset dtu ...

    # Two processes on the CPU (gloo), started by hand:
    python -m transmvsnet_tpu_torch.tools.train --device cpu --distributed \\
        --coordinator localhost:29500 --num_processes 2 --process_id 0 ...  # and 1

    # Four processes on a (data 1, view 2, depth 2) mesh: one model's step
    # split over the source views and the depth hypotheses:
    torchrun --nproc_per_node 4 -m transmvsnet_tpu_torch.tools.train \
        --distributed --mesh_view 2 --mesh_depth 2 --dataset dtu ...

    # A run that needs no data on disk:
    python -m transmvsnet_tpu_torch.tools.train --dataset synthetic --epochs 1

The flags of the JAX package's ``tools/train.py`` without its TPU ones,
plus ``--device`` (CUDA unless ``--device cpu``). On CUDA the DCN and
warp-correlation layers run their forward and backward kernels in the
activation dtype, float32 by default as in the JAX package;
``--dtype bfloat16`` is the faster path. ``--distributed`` joins a process
group (``parallel/distributed.py``: NCCL on CUDA, gloo on the CPU; the
flags, or torchrun's environment where they are omitted); each process
(without a mesh, each its own data group) then trains a disjoint shard
of the data at ``--batch_size`` per data group, with gradients averaged
by DDP and BatchNorm over the global batch, and
rank 0 alone logs and writes checkpoints. ``--mesh_data/--mesh_view/
--mesh_depth`` lay the processes out as the JAX trainer's device mesh
(``parallel/mesh.py``; data 0 takes the processes the other two leave):
each group of view x depth processes computes one model's step split
over the source views and the depth hypotheses (``parallel/
sharding.py``), on the same samples, and the data groups train disjoint
shards, so the global batch is ``--batch_size`` x data. As in the JAX trainer, the
model recomputes its activations in the backward (``ModelConfig.remat``)
unless ``--no_remat``. Checkpoints are
``<logdir>/model_NNNNNN.ckpt`` in the reference's layout; ``--resume``
continues from the latest on every process, ``--loadckpt`` loads weights
only. ``--mode profile`` traces train steps at this run's batch, views
and hypotheses through ``tools/profile.py`` instead of training.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from transmvsnet_tpu_torch.config import MeshConfig, ModelConfig
from transmvsnet_tpu_torch.data.loader import ShardedLoader
from transmvsnet_tpu_torch.data.registry import TRAINING, get_dataset
from transmvsnet_tpu_torch.data.synthetic import SyntheticDataset
from transmvsnet_tpu_torch.models.blocks import resolve_device
from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
from transmvsnet_tpu_torch.parallel import distributed
from transmvsnet_tpu_torch.parallel.mesh import AXES, make_mesh
from transmvsnet_tpu_torch.parallel.sharding import replicate, sharding_rules
from transmvsnet_tpu_torch.tools.infer import load_checkpoint
from transmvsnet_tpu_torch.train.checkpoint import restore_latest, save_checkpoint
from transmvsnet_tpu_torch.train.loop import MetricsLogger, run_epoch
from transmvsnet_tpu_torch.train.schedule import make_optimizer, warmup_multistep
from transmvsnet_tpu_torch.train.step import TrainState, make_eval_step, make_train_step


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="TransMVSNet training (PyTorch/CUDA)")
    p.add_argument("--mode", default="train", choices=["train", "profile"],
                   help="profile: trace train steps at this run's batch, views and hypotheses with "
                        "tools/profile.py into <logdir>/traces (reference train.py:243-271)")
    p.add_argument("--dataset", default="dtu", choices=sorted(TRAINING))
    p.add_argument("--datapath", default="")
    p.add_argument("--trainlist", default="")
    p.add_argument("--testlist", default="")
    p.add_argument("--logdir", default="./checkpoints")
    p.add_argument("--loadckpt", default="", help="weights only, from a .ckpt state dict")
    p.add_argument("--resume", action="store_true", help="continue from <logdir>'s latest .ckpt")
    p.add_argument("--epochs", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lrepochs", default="6,8,12:2")
    p.add_argument("--wd", type=float, default=1e-4)
    p.add_argument("--batch_size", type=int, default=2, help="per data group")
    p.add_argument("--nviews", type=int, default=5)
    p.add_argument("--numdepth", type=int, default=192)
    p.add_argument("--interval_scale", type=float, default=1.06)
    p.add_argument("--ndepths", default="48,32,8")
    p.add_argument("--depth_inter_r", default="4,1,0.5")
    p.add_argument("--dlossw", default="1.0,1.0,1.0")
    p.add_argument("--loss", default="cascade", choices=["cascade", "bld"])
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--summary_freq", type=int, default=50)
    p.add_argument("--save_freq", type=int, default=1)
    p.add_argument("--eval_freq", type=int, default=1)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="activation dtype (geometry and losses stay float32): float32, "
                        "the reference's numerics, or bfloat16, the faster path")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--distributed", action="store_true",
                   help="join a process group (NCCL on CUDA, gloo on the CPU) and train a shard of the "
                        "data per process; the three flags below default to torchrun's environment")
    p.add_argument("--coordinator", default="", help="host:port of process 0")
    p.add_argument("--num_processes", type=int, default=0, help="0 = WORLD_SIZE")
    p.add_argument("--process_id", type=int, default=-1, help="-1 = RANK")
    p.add_argument("--mesh_data", type=int, default=0,
                   help="data-parallel groups; 0 = the processes --mesh_view x --mesh_depth leave")
    p.add_argument("--mesh_view", type=int, default=1, help="processes that split each step's source views")
    p.add_argument("--mesh_depth", type=int, default=1,
                   help="processes that split each stage's depth hypotheses (and the FMT's tokens)")
    p.add_argument("--no_remat", action="store_true",
                   help="keep the activations for the backward instead of recomputing them "
                        "(remat is on by default, as in the JAX trainer)")
    return p.parse_args(argv)


def model_config(args) -> ModelConfig:
    return ModelConfig(
        ndepths=tuple(int(x) for x in args.ndepths.split(",")),
        depth_interval_ratios=tuple(float(x) for x in args.depth_inter_r.split(",")),
        compute_dtype=args.dtype,
        remat=not args.no_remat,
    )


def build_dataset(args, split: str, device: torch.device):
    cls = get_dataset(args.dataset)
    kwargs = dict(
        datapath=args.datapath,
        listfile=args.trainlist if split == "train" else args.testlist,
        mode=split,
        nviews=args.nviews,
        ndepths=args.numdepth,
    )
    if cls is not SyntheticDataset:
        kwargs.update(interval_scale=args.interval_scale, device=device)
    return cls(**kwargs)


def profile(args):
    """``--mode profile``: tools/profile.py's train steps at this run's
    per-process batch, views, hypotheses, dtype and remat."""
    from transmvsnet_tpu_torch.tools import profile as profile_tool

    return profile_tool.main([
        "--logdir", os.path.join(args.logdir, "traces"), "--train", "--batch_size", str(args.batch_size),
        "--nviews", str(args.nviews), "--ndepths", args.ndepths, "--dtype", args.dtype,
        *([] if args.no_remat else ["--remat"]),
    ])


def main(argv=None) -> TrainState:
    args = parse_args(argv)
    if args.mode == "profile":
        return profile(args)
    device = resolve_device(args.device)
    if not args.distributed:
        return train(args, device)
    distributed.initialize(args.coordinator or None, args.num_processes or None,
                           None if args.process_id < 0 else args.process_id, device=device)
    try:
        return train(args, distributed.process_device(device))
    finally:
        distributed.shutdown()


def train(args, device: torch.device) -> TrainState:
    np.random.seed(args.seed)

    model = TransMVSNet(model_config(args), device=device, generator=torch.Generator().manual_seed(args.seed))
    if args.loadckpt:
        load_checkpoint(model, args.loadckpt)
        print(f"loaded weights from {args.loadckpt}")

    mesh = make_mesh(MeshConfig(args.mesh_data, args.mesh_view, args.mesh_depth))
    if mesh.size(*AXES) != distributed.world_size():
        raise ValueError(f"mesh {mesh.shape} does not use all {distributed.world_size()} processes")
    # Each data group loads a disjoint shard (the DistributedSampler
    # contract, reference train.py:377-384); steps per epoch are the shard's.
    shard = dict(num_shards=mesh.size("data"), shard_id=mesh.index("data"))
    train_ds = build_dataset(args, "train", device)
    val_ds = train_ds if args.dataset == "synthetic" else build_dataset(args, "val", device)
    train_loader = ShardedLoader(train_ds, args.batch_size, shuffle=True, seed=args.seed, drop_last=True, **shard)
    val_loader = ShardedLoader(val_ds, args.batch_size, shuffle=False, drop_last=True, **shard)

    steps_per_epoch = max(len(train_loader), 1)
    milestones, gamma = args.lrepochs.split(":")
    schedule = warmup_multistep(
        args.lr, [steps_per_epoch * int(e) for e in milestones.split(",")], 1.0 / float(gamma)
    )
    optimizer, scheduler = make_optimizer(model.parameters(), schedule, weight_decay=args.wd)
    state = TrainState(model, optimizer, scheduler)
    start_epoch = 0
    if args.resume:
        epoch = restore_latest(args.logdir, state)
        if epoch is not None:
            start_epoch = epoch + 1
            print(f"resumed from epoch {epoch} (step {state.step})")
    state.model = replicate(model)

    dlossw = tuple(float(x) for x in args.dlossw.split(","))
    logger = MetricsLogger(args.logdir)
    bld = args.loss == "bld"
    train_step = make_train_step(dlossw, with_bld_metrics=bld)
    eval_step = make_eval_step(dlossw, with_bld_metrics=bld)
    with sharding_rules(mesh):
        for epoch in range(start_epoch, args.epochs):
            train_loader.set_epoch(epoch)
            state, means = run_epoch(train_step, state, train_loader, device, train=True, logger=logger,
                                     mode="train", log_freq=args.summary_freq, epoch=epoch)
            print(f"epoch {epoch} train: {means}")
            logger.log("train_epoch", means, epoch)
            if (epoch + 1) % args.eval_freq == 0:
                _, means = run_epoch(eval_step, state, val_loader, device, train=False, logger=logger,
                                     mode="val", log_freq=args.summary_freq, epoch=epoch)
                print(f"epoch {epoch} val: {means}")
                logger.log("val_epoch", means, epoch)
            if (epoch + 1) % args.save_freq == 0:
                save_checkpoint(args.logdir, epoch, state)
    logger.close()
    return state


if __name__ == "__main__":
    main()
