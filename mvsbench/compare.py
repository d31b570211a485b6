"""The numbers that decide ``correct``: each a gap between what the
program produced and what the plain reference computes, read so that
larger is worse. A cell's ``limits/<workload>.json`` holds the limit of
each number it compares; a number it leaves out is printed with no limit
and decides nothing (PERF.md gives each one's readings and why).

Inference, per judged request, the largest over them (the reference
follows the program's previous-stage depth, see ``drivers/infer.py``; a
judged request that never came reads ``MISSING``):
- ``prob_gap``: the widest gap of a probability-volume entry, any stage;
- ``served_flip_share``: the share of served depth pixels half a stage-3
  plane or more from the reference's (a pixel zeroed on one side only
  counts);
- ``conf_mean_gap``: the mean gap of the served confidence;
- ``wta_flip_share``: the largest share, over the stages, of pixels whose
  depth is not the hypothesis that the program's own probability volume
  puts first (exact: the winner-take-all of stages 1 and 2, whose depth
  the reference follows, is judged here alone).

Training, over the first three steps, which set-up drives through the
window's own step from the seeded weights (the reference's hypotheses
follow the program's previous-stage depth of each step; leaves whose
reference gradient of the loss is under a thousandth of the median
leaf's are left out of the gradient and update gaps):
- ``step1_prob_gap``: the first step's widest probability-volume gap
  (a batch the program cut short reads ``MISSING``);
- ``step1_loss_gap``: the relative gap of the first step's loss;
- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: of the first gradient as Adam takes it, the median
  leaf's gap between the two norms, each leaf's over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``update_gap``: the same of each leaf's change over the three steps.
The worst leaf's gaps are noise in small leaves whose gradients cancel
(PERF.md), so the median leaf's are compared.

And one step of the window drawn from the seed, which the reference
recomputes from the program's state before it (parameters, buffers,
Adam's moments and count; a step that never ran reads ``MISSING``):
- ``window_loss_gap``: the relative gap of its loss;
- ``window_grad_gap``: its gradient as Adam takes it, read from the
  first moment before and after, as ``grad_gap``;
- ``window_update_gap``: its change of the parameters, as ``update_gap``.
"""

from __future__ import annotations

import torch

INFERENCE = ("prob_gap", "served_flip_share", "conf_mean_gap", "wta_flip_share")
# What a number reads where the answer it compares never came or came cut
# short: larger than any gap, and still a number in the JSON line.
MISSING = 1e9


def plane_spacing(cfg: dict, stage: int, depth_values) -> float:
    """Distance between neighbouring planes of ``stage`` (0-based)."""
    m, sc = cfg["model"], cfg["scene"]
    n = m["ndepths"][stage]
    span = float(depth_values[-1] - depth_values[0])
    if stage == 0:
        return span / (n - 1)
    return m["depth_interval_ratios"][stage] * span / sc["num_hyp"] * n / (n - 1)


def prob_gap(prog: dict, want: dict) -> float:
    """Widest gap of a probability-volume entry over the stages; MISSING
    where the shapes differ."""
    gap = 0.0
    for s in want:
        p, w = prog[s]["prob_volume"], want[s]["prob_volume"]
        if p.shape != w.shape:
            return MISSING
        gap = max(gap, (p - w).abs().max().item())
    return gap


def wta_flip_share(prog: dict) -> float:
    """Largest share, over the stages, of pixels whose depth is not the
    hypothesis that the stage's probability volume puts first (first on
    ties)."""
    worst = 0.0
    for o in prog.values():
        p = o["prob_volume"]
        first = torch.gather(o["depth_values"].expand_as(p), 1, p.argmax(1, keepdim=True))[:, 0]
        worst = max(worst, (o["depth"] != first).float().mean().item())
    return worst


def inference(prog: dict, depth, conf, want: dict, want_depth, want_conf, cfg: dict,
              explain: dict | None = None) -> dict:
    """prog and want {"stageN": {"depth", "photo_confidence", "prob_volume",
    "depth_values"}} on the host; depth and conf the served maps
    (numpy), want_depth and want_conf the reference's. ``explain``, if
    given, gets numbers that are not compared: the widest confidence gap,
    per stage the share of winner-take-all depths half a plane or more
    off, and the widest served-depth gap, in stage-3 planes, where this
    request's own gaps cannot flip the answer (the reference's best plane
    leads its next by more than twice the widest probability gap, and its
    confidence lies off the 0.01 cut by more than the widest confidence
    gap)."""
    depth, conf = torch.as_tensor(depth), torch.as_tensor(conf)
    dv = want["stage1"]["depth_values"][0, :, 0, 0]
    step3 = plane_spacing(cfg, 2, dv)
    widest = prob_gap(prog, want)
    conf_gaps = (conf - want_conf).abs()
    served = (depth - want_depth).abs() / step3
    if explain is not None:
        flips = [((prog[s]["depth"] - want[s]["depth"]).abs() >= 0.5 * plane_spacing(cfg, i, dv)).float().mean().item()
                 for i, s in enumerate(sorted(want))]
        top2 = want["stage3"]["prob_volume"].topk(2, dim=1).values
        sure = ((top2[:, 0] - top2[:, 1]) > 2 * widest) & ((want_conf - 0.01).abs() > conf_gaps.max())
        explain.update(conf_max_gap=conf_gaps.max().item(), flip_share=flips,
                       sure_share=sure.float().mean().item(),
                       sure_depth_gap=served[sure].max().item() if sure.any() else 0.0)
    return {
        "prob_gap": widest,
        "served_flip_share": (served >= 0.5).float().mean().item(),
        "conf_mean_gap": conf_gaps.mean().item(),
        "wta_flip_share": wta_flip_share(prog),
    }


def leaf_gaps(prog: dict, want: dict, keep: list[str]) -> dict[str, float]:
    """Each leaf's gap between the norms over the larger of the reference's
    norm of it and of the median leaf; a leaf the program has no reading
    of (no optimizer state) reads 0."""
    norms = {k: want[k].norm().item() for k in keep}
    median = sorted(norms.values())[len(norms) // 2]
    return {k: abs((prog[k].norm().item() if k in prog else 0.0) - norms[k]) / max(norms[k], median)
            for k in keep}


def _kept(loss_grads: dict) -> list[str]:
    """Leaves whose reference gradient of the loss is at least a thousandth
    of the median leaf's."""
    norms = {k: g.norm().item() for k, g in loss_grads.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return [k for k, n in norms.items() if n >= 1e-3 * median]


def _relative(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def training(first_probs: dict, losses: list[float], first_grads: dict, params_after: dict,
             params_before: dict, want: dict, window: dict | None, explain: dict | None = None) -> dict:
    """Program readings (host tensors by parameter name) against the
    reference's ``train_steps`` result for the same steps; ``window``, the
    watched step's {"loss", "grads", "before", "after"} with its
    reference result under "want", or None where it never ran.
    ``explain``, if given, gets every leaf's gaps, the losses, and a look
    at the worst leaf of the change: its first gradient's gap, the share
    of its elements whose first gradient, or change, has the other sign on
    the two sides, those elements' share of the reference change's norm,
    and its mean change over three full steps of the first rate (Adam's
    steps that cancel read under 1)."""
    ref_losses = want["losses"]
    keep = _kept(want["first_loss_grads"])
    change = {k: params_after[k] - params_before[k] for k in keep}
    want_change = {k: want["params"][k] - params_before[k] for k in keep}
    grad, update = leaf_gaps(first_grads, want["first_grads"], keep), leaf_gaps(change, want_change, keep)
    out = {
        "step1_prob_gap": prob_gap(first_probs, want["first_outputs"]),
        "step1_loss_gap": _relative(losses[0], ref_losses[0]),
        "loss_gap": max(_relative(a, b) for a, b in zip(losses, ref_losses)),
        "grad_gap": _median(grad.values()),
        "update_gap": _median(update.values()),
    }
    if window is None:
        out.update(dict.fromkeys(("window_loss_gap", "window_grad_gap", "window_update_gap"), MISSING))
    else:
        w = window["want"]
        wkeep = _kept(w["first_loss_grads"])
        before = window["before"]
        wchange = {k: window["after"][k] - before[k] for k in wkeep}
        wwant = {k: w["params"][k] - before[k] for k in wkeep}
        out.update(window_loss_gap=_relative(window["loss"], w["losses"][0]),
                   window_grad_gap=_median(leaf_gaps(window["grads"], w["first_grads"], wkeep).values()),
                   window_update_gap=_median(leaf_gaps(wchange, wwant, wkeep).values()))
    if explain is not None:
        worst = max(update, key=update.get)
        first_flips = torch.sign(first_grads[worst]) != torch.sign(want["first_grads"][worst])
        cp, cr = change[worst], want_change[worst]
        flips = torch.sign(cp) != torch.sign(cr)
        explain.update(losses=losses, ref_losses=ref_losses, grad=grad, update=update,
                       left_out=sorted(set(want["first_loss_grads"]) - set(keep)),
                       worst_update_leaf={"name": worst, "gap": update[worst], "grad_gap": grad[worst],
                                          "first_grad_flip_share": first_flips.float().mean().item(),
                                          "change_flip_share": flips.float().mean().item(),
                                          "flipped_change_share": (cr[flips].norm() / cr.norm()).item(),
                                          "change_over_3lr": (cr.abs().mean() / (3 * want["lrs"][0])).item()})
        if window is not None:
            explain.update(window_losses=[window["loss"], window["want"]["losses"][0]])
    return out


def _median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2]
