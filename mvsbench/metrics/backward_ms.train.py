"""backward_ms.train: the card's milliseconds per step from the train
step's own ``mark("forward")`` to its ``mark("backward")`` (the NaN
guard's read of the loss, the backward with remat's recompute), CUDA
events summed over the window, over the steps in it."""


def read(rec):
    ms = rec.marks_ms.get("backward")
    return ms / rec.count if ms and rec.count else None
