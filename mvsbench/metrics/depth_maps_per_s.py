"""depth_maps_per_s: depth maps completed in the window over the window's
length, by the host clock; every request, from the window's start to the
last one's answer on the host."""


def read(rec):
    return rec.items / rec.window_s if rec.items else None
