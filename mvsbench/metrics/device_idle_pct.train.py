"""device_idle_pct.train: the share of a slice of train steps, traced for
the card's activity alone (no host op recorded), in which no kernel, copy
or set ran on the card, in %."""


def read(rec):
    prof = rec.profile
    if not prof or not prof["busy_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
