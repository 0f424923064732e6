"""Host ms of a train_iteration: each frame's iterations, synchronised at their end, over their number; mean over frames."""

from benchmark import readers


def read(rec: dict):
    return readers.mean_ms(rec, "train")
