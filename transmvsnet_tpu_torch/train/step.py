"""Train and eval steps with the JAX package's NaN guard.

``make_train_step`` returns ``step(state, batch) -> (state, scalars)``:
forward in train mode (BatchNorm on batch statistics), ``cascade_loss``,
backward, one Adam update and one schedule step. The guard is the JAX
package's (``train/step.py``), which replaces the reference's skip-batch
control flow (reference train.py:154-168): a non-finite loss applies no
update, so the parameters, the optimizer state and the schedule's count
stay as they were. BatchNorm updates its running statistics inside the
forward here, so the step snapshots every buffer before the forward and
restores them when it skips. The global step advances either way.

Across processes (``state.model`` wrapped by ``parallel/sharding.py::
replicate``) the guard decides on every process's loss: the finite flags
are all-reduced (MIN) before the backward, so all processes skip together
and none waits alone in DDP's gradient all-reduce, as the JAX package's
guard sees the global batch's loss. The returned scalars are averaged over
the processes (the JAX package logs global-batch scalars); the "_" image
tensors stay local. With equal local batches the loss needs no change: it
is a mean over images, so DDP's mean of the processes' gradients is the
global batch's gradient. On a mesh (``parallel/sharding.py``) the
processes of one data group compute the same loss and scalars, so the
mean over all processes is still the global batch's, and DDP's mean of
their gradients sums each group's partial gradients and averages the
groups (``parallel/sharding.py::replicate``): neither the loss nor the
guard needs a change there either.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import torch

from transmvsnet_tpu_torch.models.losses import cascade_loss, masked_mean
from transmvsnet_tpu_torch.parallel import distributed
from transmvsnet_tpu_torch.train.metrics import standard_eval_metrics


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def bld_metrics(outputs: Mapping[str, Any], batch: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """EPE / <1px / <3px finetune metrics (reference models/module.py:584-590)."""
    gt = batch["depth"]["stage3"]
    mask = batch["mask"]["stage3"] > 0.5
    scale = (batch["depth_interval"] * (192.0 / 128.0)).reshape(-1, 1, 1)
    err = (gt - outputs["stage3"]["depth"]).abs() / scale
    return {
        "epe": masked_mean(err, mask),
        "less1": masked_mean((err < 1.0).float(), mask),
        "less3": masked_mean((err < 3.0).float(), mask),
    }


def _scalars(outputs, batch, dlossw, with_bld, wta) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    loss, depth_loss, total_entropy, wta_last, per_stage = cascade_loss(
        outputs, batch["depth"], batch["mask"], dlossw
    )
    mask3 = batch["mask"]["stage3"] > 0.5
    depth_est = wta_last if wta else outputs["stage3"]["depth"]
    scalars = {
        "loss": loss,
        "depth_loss": depth_loss,
        "entropy_loss": total_entropy,
        **standard_eval_metrics(depth_est, batch["depth"]["stage3"], mask3),
        **per_stage,
        **(bld_metrics(outputs, batch) if with_bld else {}),
        # Image-sized tensors for summaries; the loop strips "_" keys.
        "_depth_est": depth_est,
        "_confidence": outputs["stage3"]["photo_confidence"],
    }
    return loss, scalars


def _all_finite(loss: torch.Tensor) -> bool:
    """Whether the loss is finite on every process."""
    flag = torch.isfinite(loss).to(torch.float32)
    if distributed.is_initialized():
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MIN)
    return bool(flag)


def _process_mean(scalars: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The scalars averaged over the processes in one all-reduce; the "_"
    image tensors as they are."""
    processes = distributed.world_size()
    keys = [k for k in scalars if not k.startswith("_")]
    if processes == 1 or not keys:
        return scalars
    stacked = torch.stack([scalars[k].float() for k in keys])
    torch.distributed.all_reduce(stacked)
    return {**scalars, **dict(zip(keys, stacked / processes))}


def _forward(model, batch):
    return model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])


def make_train_step(
    dlossw: Sequence[float] = (1.0, 1.0, 1.0),
    with_bld_metrics: bool = False,
) -> Callable[..., tuple[TrainState, dict[str, torch.Tensor]]]:
    def train_step(state: TrainState, batch: Mapping[str, Any], mark: Callable[[str], None] | None = None):
        """One step. ``mark(phase)``, if given, is called after the
        "forward" (with the loss), "backward" and "optimizer" phases."""
        model = state.model
        model.train()
        buffers = [b.detach().clone() for b in model.buffers()]
        outputs = _forward(model, batch)
        loss, scalars = _scalars(outputs, batch, dlossw, with_bld_metrics, wta=True)
        if mark:
            mark("forward")
        finite = _all_finite(loss)
        if finite:
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if mark:
                mark("backward")
            state.optimizer.step()
            state.scheduler.step()
            if mark:
                mark("optimizer")
        else:
            with torch.no_grad():
                for b, saved in zip(model.buffers(), buffers):
                    b.copy_(saved)
        state.step += 1
        scalars = {k: v.detach() for k, v in scalars.items()}
        scalars["skipped_nan"] = torch.tensor(0.0 if finite else 1.0, device=loss.device)
        return state, _process_mean(scalars)

    return train_step


def make_eval_step(
    dlossw: Sequence[float] = (1.0, 1.0, 1.0),
    with_bld_metrics: bool = False,
) -> Callable[[TrainState, Mapping[str, Any]], dict[str, torch.Tensor]]:
    @torch.no_grad()
    def eval_step(state: TrainState, batch: Mapping[str, Any]):
        state.model.eval()
        outputs = _forward(state.model, batch)
        return _process_mean(_scalars(outputs, batch, dlossw, with_bld_metrics, wta=False)[1])

    return eval_step
