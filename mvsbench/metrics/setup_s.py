"""setup_s: seconds from the start of the process to the end of set-up
(weights and scenes from the seed, the program's kernels built or loaded,
its model built and loaded, the cell's shapes warmed), by the host clock."""


def read(rec):
    return rec.setup_s
