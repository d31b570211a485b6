"""The training recipe in plain PyTorch: the cascade loss and Adam.

The loss (reference models/module.py:495-558, in the program's form):
per stage, the hypothesis nearest the ground truth is the true bin (first
on ties), -log(p + 1e-6) of it is averaged over each image's valid pixels,
then over the images, weighted 2.0 and summed over the stages. Adam folds
the L2 weight decay into the gradient before its moments (``torch.optim.
Adam(weight_decay=wd)``, not AdamW), with the step's learning rate given.
"""

from __future__ import annotations

import bisect

import torch


def warmup_multistep(step: int, base_lr: float, milestones, gamma: float, warmup_iters: int = 500,
                     warmup_factor: float = 1.0 / 3.0) -> float:
    """The recipe's learning rate at ``step``: linear warm-up from a third
    over 500 steps, then times ``gamma`` at each milestone passed
    (reference utils.py:224-268)."""
    alpha = min(max(step / max(warmup_iters, 1), 0.0), 1.0)
    factor = warmup_factor * (1.0 - alpha) + alpha if step < warmup_iters else 1.0
    return base_lr * factor * gamma ** bisect.bisect_right(sorted(milestones), step)


def cascade_loss(outputs, depth_gt, mask, stage_weights=(1.0, 1.0, 1.0)):
    total = 0.0
    for i, key in enumerate(sorted(k for k in outputs if k.startswith("stage"))):
        prob, planes = outputs[key]["prob_volume"], outputs[key]["depth_values"].expand_as(outputs[key]["prob_volume"])
        valid = mask[key] > 0.5
        true_bin = torch.argmin((planes - depth_gt[key][:, None]).abs(), dim=1)
        true_bin = torch.where(valid, true_bin, torch.zeros_like(true_bin))
        ce = -torch.log(torch.gather(prob, 1, true_bin[:, None])[:, 0] + 1e-6)
        m = valid.float()
        per_image = (ce * m).sum((1, 2)) / (m.sum((1, 2)) + 1e-6)
        total = total + stage_weights[i] * 2.0 * per_image.mean()
    return total


def train_steps(model, batches, lrs, weight_decay=1e-4, betas=(0.9, 0.999), eps=1e-8, given=None,
                moments=None, start=0):
    """One Adam step per batch (each a dict of device tensors: imgs,
    proj_matrices, depth_values, depth, mask) at the given learning rates,
    BatchNorm on batch statistics; ``given``, if set, each step's
    ``given_prev_depth`` for the forward. Adam starts from ``moments``
    ({"exp_avg": {name: ...}, "exp_avg_sq": {name: ...}}; zeros if None)
    after ``start`` steps. Returns {"losses": [...], "first_grads":
    {name: the first step's gradient as Adam takes it, decay included},
    "first_loss_grads": {name: the same without the decay},
    "first_outputs": {stage: {"prob_volume": the first step's, on the host}},
    "params": {name: parameters after the last step}}."""
    b1, b2 = betas
    params = dict(model.named_parameters())
    if moments is None:
        m = {k: torch.zeros_like(p) for k, p in params.items()}
        v = {k: torch.zeros_like(p) for k, p in params.items()}
    else:
        m = {k: moments["exp_avg"][k].clone() for k in params}
        v = {k: moments["exp_avg_sq"][k].clone() for k in params}
    losses, first, first_outputs = [], None, None
    model.train()
    for t, (batch, lr) in enumerate(zip(batches, lrs), start=start + 1):
        for p in params.values():
            p.grad = None
        follow = {} if given is None else {"given_prev_depth": given[t - 1 - start]}
        out = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"], **follow)
        loss = cascade_loss(out, batch["depth"], batch["mask"])
        loss.backward()
        losses.append(loss.detach().item())
        if first_outputs is None:
            first_outputs = {k: {"prob_volume": o["prob_volume"].detach().cpu()} for k, o in out.items()}
        with torch.no_grad():
            grads = {k: p.grad + weight_decay * p for k, p in params.items()}
            if first is None:
                first = {k: g.clone() for k, g in grads.items()}
                first_loss = {k: p.grad.clone() for k, p in params.items()}
            for k, p in params.items():
                m[k].mul_(b1).add_(grads[k], alpha=1 - b1)
                v[k].mul_(b2).addcmul_(grads[k], grads[k], value=1 - b2)
                m_hat = m[k] / (1 - b1 ** t)
                v_hat = v[k] / (1 - b2 ** t)
                p.sub_(lr * m_hat / (v_hat.sqrt() + eps))
        del out, loss
    return {"losses": losses, "first_grads": first, "first_loss_grads": first_loss,
            "first_outputs": first_outputs,
            "params": {k: p.detach().clone() for k, p in params.items()}}
