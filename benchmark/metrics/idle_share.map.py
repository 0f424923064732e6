"""The device's idle share of the traced frames' wall time."""

from benchmark import readers


def read(rec: dict):
    return readers.idle_share(rec)
