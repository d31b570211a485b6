"""feature_ms.infer: the card's milliseconds per depth map in FeatureNet
(state-dict prefix ``feature``): CUDA events at the module's entry and
exit, summed over the window, over the maps in it."""

SPANS = {"feature": r"feature"}


def read(rec):
    ms = rec.spans_ms.get("feature")
    return ms / rec.items if ms is not None and rec.items else None
