"""dcn_roofline_pct.infer: the nine deformable layers' least time over
their time on the card, in %. The least time of each layer is its work
counted from shapes (``counts/transmvsnet.py``: the offset/mask conv and
the contraction, input and output bytes once) at the TF32 peak or HBM
bandwidth, whichever is longer; their time on the card is that of every
kernel launched inside the layers' modules (``feature.outN.{1,4,7}``) in
the slice traced with host activity, found by the profiler's projection of the calls'
ranges onto the device timeline, never by kernel name."""

from mvsbench.counts import peaks
from mvsbench.counts import transmvsnet as work

SPANS = {"dcn": r"feature\.out[123]\.[147]"}


def read(rec):
    prof = rec.profile
    if not prof or "dcn" not in prof["spans"] or not prof["spans"]["dcn"]["kernel_us"]:
        return None
    act_bytes = 2 if rec.config["precision"]["activations"] == "bfloat16" else 4
    least = 0.0
    for layer in work.dcn_layers(rec.config["model"], rec.B * rec.V, rec.H, rec.W):
        w = work.dcn_work(layer, act_bytes)
        least += work.roofline_seconds(w["flops"], w["bytes"], peaks.TF32_FLOPS, peaks.HBM_BYTES_PER_S)
    return 100.0 * least * prof["spans_count"] / (prof["spans"]["dcn"]["kernel_us"] / 1e6)
