"""fmt_ms.infer: the card's milliseconds per depth map in the Feature
Matching Transformer and its pathway (``FMT_with_pathway``), as
feature_ms.infer times FeatureNet."""

SPANS = {"fmt": r"FMT_with_pathway"}


def read(rec):
    ms = rec.spans_ms.get("fmt")
    return ms / rec.items if ms is not None and rec.items else None
