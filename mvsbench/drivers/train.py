"""Training traffic: steps of the program's train step over a seeded pool.

Set-up builds what ``tools/train.py::train`` builds, once: the model from
the seeded weights, ``make_optimizer`` with ``warmup_multistep``, a
``TrainState`` and ``make_train_step``. Every step, its first three in
set-up included, copies its batch from the host pool to the card with the
program's ``to_device_batch`` and runs the step on that one state. A step
that the NaN guard skips counts as failed.

Two things are judged once the window has closed, each recomputed by the
plain reference, whose hypotheses of each stage are centred on the
program's previous-stage depth of that step (a winner-take-all that
rounding can flip moves them, and with them the loss; the inference cells
check the winner-take-all and the hypotheses):
- the start: the first three steps, from the seeded weights. Set-up keeps
  Adam's first moment after the first (the first gradient, decay
  included, times 1 - beta1), the parameters after the third, the first
  step's probability volumes and each step's loss;
- one step of the window, drawn from the seed among those that surely
  run (where the window closes first, the first step after it): the
  program's state before it (parameters, buffers, Adam's moments
  and count) and its loss, first moment and parameters after it. The
  reference takes the step from that state, as the program's run reached
  it; the steps between the start and it are judged by no number.
"""

from __future__ import annotations

import importlib
import time

import torch

from mvsbench import compare, scene, weights
from mvsbench.counts import transmvsnet as work
from mvsbench.drivers import program_config
from mvsbench.reference import model as ref
from mvsbench.reference import train as ref_train


def tree_to(tree, dev):
    """Nested dicts of numpy arrays as tensors on ``dev``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return torch.from_numpy(tree).to(dev)


class Driver:
    def __init__(self, cell, seed: int, device, program_dtype: str | None = None):
        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        self.cfg, self.traffic = cell.config, cell.traffic
        shape = self.cfg["train"]
        self.B, self.V, self.H, self.W = shape["batch"], shape["views"], shape["height"], shape["width"]
        self.dtype = program_dtype or self.cfg["precision"]["activations"]
        self.marks = None
        self.step_index = 0
        self.phases: dict[str, float] = {}
        self.reference_s = 0.0

    def setup(self) -> None:
        cfg, dev, tr = self.cfg, self.dev, self.cfg["train"]
        t0 = time.perf_counter()
        layout = weights.reference_model(cfg, dev)
        self.state0 = weights.seeded_state_dict(layout, self.seed, dev, cfg["prob_gain"])
        del layout
        self.phases["weights"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.pool = scene.pool(self.seed, self.traffic["pool"], self.B, cfg["scene"], self.V, self.H, self.W,
                               with_truth=True)
        self.in_bounds = work.in_bounds_shares(
            {k: v[0] for k, v in self.pool[0]["proj_matrices"].items()}, self.pool[0]["depth_values"][0],
            cfg["model"], self.H, self.W)
        self.phases["scenes"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        program = importlib.import_module("transmvsnet_tpu_torch.models.transmvsnet")
        schedule_mod = importlib.import_module("transmvsnet_tpu_torch.train.schedule")
        self.step_mod = importlib.import_module("transmvsnet_tpu_torch.train.step")
        self.loop = importlib.import_module("transmvsnet_tpu_torch.train.loop")
        model = program.TransMVSNet(program_config(cfg, compute_dtype=self.dtype, remat=tr["remat"]), device=dev)
        model.load_state_dict(self.state0)
        self.model = model
        schedule = schedule_mod.warmup_multistep(
            tr["lr"], [tr["steps_per_epoch"] * e for e in tr["lr_epochs"]], 1.0 / tr["lr_divisor"])
        optimizer, scheduler = schedule_mod.make_optimizer(model.parameters(), schedule,
                                                           weight_decay=tr["weight_decay"])
        self.state = self.step_mod.TrainState(model, optimizer, scheduler)
        self.train_step = self.step_mod.make_train_step()
        names = {id(p): k for k, p in model.named_parameters()}
        self.beta1 = beta1 = optimizer.param_groups[0]["betas"][0]
        self.losses, self.skipped, self.stage_depths = [], torch.zeros((), device=dev), []
        # Each judged step's stage-1 and stage-2 depth, on which the
        # program centred the next stage's hypotheses.
        self.phases["program"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        def keep(module, args, out):
            if not self.stage_depths:
                self.first_probs = {s: {"prob_volume": out[s]["prob_volume"].detach().cpu()}
                                    for s in ("stage1", "stage2", "stage3")}
            self.stage_depths.append({"stage2": out["stage1"]["depth"].detach().cpu(),
                                      "stage3": out["stage2"]["depth"].detach().cpu()})

        hook = model.register_forward_hook(keep)
        for i in range(self.traffic["checked"]):
            self.losses.append(float(self.step()["loss"]))
            if i == 0:
                self.first_grads = {names[id(p)]: (s["exp_avg"] / (1 - beta1)).cpu()
                                    for p, s in optimizer.state.items()}
        hook.remove()
        self.phases["judged_steps"] = time.perf_counter() - t0
        self.params_after = {k: p.detach().cpu().clone() for k, p in model.named_parameters()}
        surely = max(1, int(0.5 * self.cell.seconds * self.traffic["checked"] / self.phases["judged_steps"]))
        self.watch = int(scene.rng_for(self.seed, "watched").integers(surely))
        self.watched = None

    def step(self) -> dict:
        raw = self.pool[self.step_index % len(self.pool)]
        self.step_index += 1
        batch = self.loop.to_device_batch(raw, self.dev)
        self.state, scalars = self.train_step(self.state, batch, self.marks)
        self.skipped += scalars["skipped_nan"]
        return scalars

    def moments(self) -> dict:
        """Adam's moments by parameter name, copied on the card (zeros
        where it holds none yet)."""
        state = self.state.optimizer.state
        return {m: {k: state[p][m].detach().clone() if p in state else torch.zeros_like(p)
                    for k, p in self.state.model.named_parameters()} for m in ("exp_avg", "exp_avg_sq")}

    def watched_step(self) -> None:
        """A window step with the program's state kept before it and its
        loss, first moment and parameters after it, all on the card."""
        model, opt = self.state.model, self.state.optimizer
        kept = {"state": {k: v.detach().clone() for k, v in model.state_dict().items()},
                "moments": self.moments(), "count": int(next(iter(opt.state.values()), {"step": 0})["step"]),
                "raw": self.pool[self.step_index % len(self.pool)], "depths": []}
        hook = model.register_forward_hook(lambda m, a, out: kept["depths"].append(
            {"stage2": out["stage1"]["depth"].detach(), "stage3": out["stage2"]["depth"].detach()}))
        try:
            kept["loss"] = self.step()["loss"]
        finally:
            hook.remove()
        kept["exp_avg_after"] = self.moments()["exp_avg"]
        kept["after"] = {k: p.detach().clone() for k, p in model.named_parameters()}
        self.watched = kept

    def window(self, seconds: float) -> dict:
        before = float(self.skipped)
        steps = []
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            t0 = time.perf_counter()
            if len(steps) == self.watch:
                self.watched_step()
            else:
                self.step()
            steps.append(time.perf_counter() - t0)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        end = time.perf_counter()
        return {"count": len(steps), "items": len(steps) * self.B, "window_s": end - start, "latencies_s": steps,
                "failed": int(round(float(self.skipped) - before))}

    def profiled(self, seconds: float, least: int) -> dict:
        n, start = 0, time.perf_counter()
        while n < least or time.perf_counter() - start < seconds:
            self.step()
            n += 1
        return {"count": n, "items": n * self.B}

    def release(self) -> None:
        """Where the window closed before the watched step, the next step
        is watched in its place (late, not wrong; outside the metrics); the
        judged readings are brought to the host."""
        if self.watched is None:
            self.watched_step()
        w = self.watched
        if w is not None:
            def host(tree):
                return {k: v.cpu() for k, v in tree.items()}

            b1 = self.beta1
            self.watched = {
                "state": host(w["state"]), "moments": {m: host(t) for m, t in w["moments"].items()},
                "count": w["count"], "raw": w["raw"], "given": host(w["depths"][0]), "loss": float(w["loss"]),
                "grads": {k: ((a - b1 * w["moments"]["exp_avg"][k]) / (1 - b1)).cpu()
                          for k, a in w["exp_avg_after"].items()},
                "after": host(w["after"])}
        del self.state, self.model
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()

    def check(self, limits: dict, explain: dict | None = None) -> dict:
        model = weights.reference_model(self.cfg, self.dev)
        model.load_state_dict(self.state0)
        k = self.traffic["checked"]
        batches = [tree_to(self.pool[i % len(self.pool)], self.dev) for i in range(k)]
        tr = self.cfg["train"]
        with ref.full_float32():
            lrs = [ref_train.warmup_multistep(i, tr["lr"], [tr["steps_per_epoch"] * e for e in tr["lr_epochs"]],
                                              1.0 / tr["lr_divisor"]) for i in range(k)]
            given = [{k: v.to(self.dev) for k, v in d.items()} for d in self.stage_depths]
            want = ref_train.train_steps(model, batches, lrs, weight_decay=tr["weight_decay"], given=given)
        want = {"losses": want["losses"], "lrs": lrs,
                "first_grads": {n: g.cpu() for n, g in want["first_grads"].items()},
                "first_loss_grads": {n: g.cpu() for n, g in want["first_loss_grads"].items()},
                "params": {n: p.cpu() for n, p in want["params"].items()}, "first_outputs": want["first_outputs"]}
        before = {n: self.state0[n].cpu() for n in self.params_after}
        window = self.recompute_watched() if self.watched is not None else None
        return compare.training(self.first_probs, self.losses, self.first_grads, self.params_after, before, want,
                                window, explain)

    def recompute_watched(self) -> dict:
        """The reference's step from the program's state before the watched
        step, beside the program's readings of it."""
        w, tr, dev = self.watched, self.cfg["train"], self.dev
        model = weights.reference_model(self.cfg, dev)
        model.load_state_dict(w["state"])
        lr = ref_train.warmup_multistep(w["count"], tr["lr"], [tr["steps_per_epoch"] * e for e in tr["lr_epochs"]],
                                        1.0 / tr["lr_divisor"])
        moments = {m: {k: v.to(dev) for k, v in t.items()} for m, t in w["moments"].items()}
        with ref.full_float32():
            want = ref_train.train_steps(model, [tree_to(w["raw"], dev)], [lr], weight_decay=tr["weight_decay"],
                                         given=[{k: v.to(dev) for k, v in w["given"].items()}], moments=moments,
                                         start=w["count"])
        want = {"losses": want["losses"], "first_grads": {n: g.cpu() for n, g in want["first_grads"].items()},
                "first_loss_grads": {n: g.cpu() for n, g in want["first_loss_grads"].items()},
                "params": {n: p.cpu() for n, p in want["params"].items()}}
        params = {k: w["state"][k] for k in w["after"]}
        return {"loss": w["loss"], "grads": w["grads"], "before": params, "after": w["after"], "want": want}
