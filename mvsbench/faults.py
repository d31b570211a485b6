"""Faults planted under the timed path, for the checks that ``correct``
must fail on: each patches the program in this process while its context
is open.

- ``altered``: every served depth map shifted by two stage-3 planes where
  the answer is produced (``blended_confidence``);
- ``unchanged``: a train step that returns its state as it found it;
- ``half_batch``: a train step on the first half of its batch only, the
  mean taken over the rest;
- ``half_loss``: a train step whose forward runs the whole batch and
  whose loss is the mean over its first half only.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _altered():
    from transmvsnet_tpu_torch.models import transmvsnet

    blended = transmvsnet.blended_confidence

    def altered(outputs):
        depth, conf = blended(outputs)
        planes = outputs["stage3"]["depth_values"]
        return depth + 2 * (planes[:, 1] - planes[:, 0]), conf

    return _patched(transmvsnet, "blended_confidence", altered)


def _step_fault(wrap):
    from transmvsnet_tpu_torch.train import step

    make = step.make_train_step
    return _patched(step, "make_train_step", lambda *a, **k: wrap(make(*a, **k)))


def _unchanged(train_step):
    def unchanged(state, batch, mark=None):
        params = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        saved = {p: {k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
                 for p, s in state.optimizer.state.items()}
        state, scalars = train_step(state, batch, mark)
        state.model.load_state_dict(params)
        state.optimizer.state.clear()
        state.optimizer.state.update(saved)
        return state, scalars
    return unchanged


def _half_batch(train_step):
    def first_half(v):
        return {k: first_half(x) for k, x in v.items()} if isinstance(v, dict) else v[: len(v) // 2]

    def half(state, batch, mark=None):
        return train_step(state, first_half(batch), mark)
    return half


def _half_loss(train_step):
    from transmvsnet_tpu_torch.train import step

    loss_of = step.cascade_loss

    def first_half(v, n):
        if isinstance(v, dict):
            return {k: first_half(x, n) for k, x in v.items()}
        return v[: n // 2] if torch.is_tensor(v) and v.dim() and len(v) == n else v

    def half_loss(outputs, depth_gt, mask, *rest):
        n = len(outputs["stage1"]["prob_volume"])
        whole = loss_of(outputs, depth_gt, mask, *rest)
        half = loss_of(first_half(outputs, n), first_half(depth_gt, n), first_half(mask, n), *rest)
        return (half[0], *whole[1:])

    def faulty(state, batch, mark=None):
        with _patched(step, "cascade_loss", half_loss):
            return train_step(state, batch, mark)
    return faulty


FAULTS = ("altered", "unchanged", "half_batch", "half_loss")


def planted(name: str | None):
    """A context in which the fault ``name`` (or none) is in place."""
    if name is None:
        return contextlib.nullcontext()
    if name == "altered":
        return _altered()
    return _step_fault({"unchanged": _unchanged, "half_batch": _half_batch, "half_loss": _half_loss}[name])
