"""Host ms of IncrementalMapper.add_frame, synchronised after it, mean over the window's frames."""

from benchmark import readers


def read(rec: dict):
    return readers.mean_ms(rec, "ingest")
