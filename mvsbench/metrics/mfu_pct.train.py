"""mfu_pct.train: a step's work per sample counted from shapes (the
forward, and the backward at twice the forward: the input and weight
gradients; remat's recompute not counted) times the window's samples per
second, over the TF32 peak (495 TFLOP/s), in %."""

from mvsbench.counts import peaks
from mvsbench.counts import transmvsnet as work


def read(rec):
    if not rec.count:
        return None
    flops = 3 * work.forward_flops(rec.config["model"], rec.B, rec.V, rec.H, rec.W, rec.in_bounds)["total"]
    return 100.0 * flops * rec.count / rec.window_s / peaks.TF32_FLOPS
