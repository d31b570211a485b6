"""Optimizer and LR schedule of the reference training recipe.

``warmup_multistep``: linear warmup from lr/3 over 500 iterations, then
step decay at iteration milestones (reference utils.py:224-268; milestones
are epochs times steps per epoch, reference train.py:55-56).

``make_optimizer``: ``torch.optim.Adam(weight_decay=wd)``, the additive L2
decay folded into the gradient before the Adam moments (reference
train.py:329), not AdamW. Adam holds a base rate of 1 and a ``LambdaLR``
sets each step's rate to ``schedule(step)`` exactly. This equals the JAX
package's optax chain ``add_decayed_weights -> scale_by_adam ->
scale_by_learning_rate``; the schedule's count lives in the scheduler, so
a step that applies no update (the NaN guard) does not advance it.
"""

from __future__ import annotations

import bisect
from typing import Callable, Iterable, Sequence

import torch


def warmup_multistep(
    base_lr: float,
    milestones: Sequence[int],
    gamma: float,
    warmup_iters: int = 500,
    warmup_factor: float = 1.0 / 3.0,
) -> Callable[[int], float]:
    milestones = sorted(milestones)

    def schedule(step: int) -> float:
        alpha = min(max(step / max(warmup_iters, 1), 0.0), 1.0)
        wf = warmup_factor * (1.0 - alpha) + alpha if step < warmup_iters else 1.0
        return base_lr * wf * gamma ** bisect.bisect_right(milestones, step)

    return schedule


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    schedule: Callable[[int], float],
    weight_decay: float = 1e-4,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    optimizer = torch.optim.Adam(params, lr=1.0, betas=(b1, b2), eps=eps, weight_decay=weight_decay)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)
