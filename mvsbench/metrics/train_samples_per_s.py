"""train_samples_per_s: samples of every step completed in the window
over the window's length (to the card's end of the last step), by the
host clock."""


def read(rec):
    return rec.items / rec.window_s if rec.items else None
