"""cost_reg_ms.infer: the card's milliseconds per depth map in the three
cost regularisers (``cost_regularization.N``), as feature_ms.infer times
FeatureNet."""

SPANS = {"cost_reg": r"cost_regularization\.\d+"}


def read(rec):
    ms = rec.spans_ms.get("cost_reg")
    return ms / rec.items if ms is not None and rec.items else None
