"""mfu_pct.infer: the forward's work per depth map counted from shapes
(``counts/transmvsnet.py``) times the window's depth maps per second, over
the TF32 peak (495 TFLOP/s), in %."""

from mvsbench.counts import peaks
from mvsbench.counts import transmvsnet as work


def read(rec):
    if not rec.count:
        return None
    flops = work.forward_flops(rec.config["model"], rec.B, rec.V, rec.H, rec.W, rec.in_bounds)["total"]
    return 100.0 * flops * rec.count / rec.window_s / peaks.TF32_FLOPS
