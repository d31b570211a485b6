"""plane_sweep_ms.infer: the card's milliseconds per depth map in the
forward outside FeatureNet, the FMT and the cost regularisers: the plane
sweep of ``depth_stage`` (warp and correlation, PixelwiseNet, the view
sum, softmax and winner-take-all) and the hypotheses. The forward's span
(the whole model) less the other three."""

SPANS = {"forward": r"", "feature": r"feature", "fmt": r"FMT_with_pathway",
         "cost_reg": r"cost_regularization\.\d+"}


def read(rec):
    ms = rec.spans_ms
    if not rec.items or any(k not in ms for k in SPANS):
        return None
    return (ms["forward"] - ms["feature"] - ms["fmt"] - ms["cost_reg"]) / rec.items
